"""Serving forwards, the multi-step decode block and the fused speculative
engines (counterpart of ``flexflow_tpu/serve/engine.py``).

The JAX package runs each token-feedback loop (decode steps, speculation
rounds, draft chains) as a jitted ``while_loop`` so the host reads back
once per block. Here each loop is a Python loop whose tokens, positions
and KV caches stay on the device: a step's argmax feeds the next step's
input tensor directly. A decode block reads back once, at its end. A
speculation round reads one small tensor first: the round's draft depth,
which is 0 when no row is live (the loop's exit test). Each block's
packed ``[R, max_rounds, depth+3]`` result is read once, at its end.
A sampled graph draws from the ``torch.Generator`` passed in (the JAX
engines' RNG key); speculation is greedy and draws nothing. CUDA graphs
for these loops are later work.

Engines:

* ``make_decode_block``: n decode steps per call (incremental decoding,
  and the controller's fallback for parked requests);
* ``make_draft_chain``: a greedy draft chain of fixed depth (the host
  tree path's draft step);
* ``SpecChainEngine``: one draft model, a greedy chain verified by a
  causal width-(depth+1) pass (K1 causal); accepted tokens are already
  contiguous in both caches;
* ``MultiSpecEngine``: B draft models, their chains verified as one token
  tree padded to a multiple of ``VERIFY_WIDTH`` (K1 with the tree bias);
  the best branch's KV is compacted into the committed region when
  B > 1. At B = 1 its verify pass has the incremental decode's width, so
  both run the same GEMM shapes and near-tie argmaxes resolve alike;
* ``BeamSpecEngine``: one draft model drafting a beam of width W; the
  beam tree's node layout is fixed, its parents and ancestor mask are
  data; the verifier checks the whole tree in one K1-bias pass and the
  accepted path's KV is compacted into the committed region.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.ffconst import torch_dtype
from flexflow_tpu_torch.ops.base import OpContext
from flexflow_tpu_torch.ops.inc_attention import commit_tree_kv
from flexflow_tpu_torch.ops.reduction_ops import stable_top_k
from flexflow_tpu_torch.serve.batch_config import BatchMeta, TreeBatchMeta
from flexflow_tpu_torch.serve.inference_manager import VERIFY_WIDTH


def build_feeds(model, meta):
    """The feeds of one serving forward, the one place they are built: the
    tokens, and for a model with learned position embeddings (OPT,
    StarCoder) ``meta.positions + model.position_offset`` clamped into the
    position table. Real tokens' positions lie inside the table whenever
    the cache does; the clamp keeps padding tokens, tree nodes past a
    row's end and inactive rows inside it too, where the JAX package's
    ``jnp.take`` fills NaN and a CUDA gather would stop the process."""
    feeds = {model.input_tensors[0].tensor_id: meta.tokens}
    pos_t = model.position_input_tensor
    if pos_t is not None:
        pos = meta.positions + model.position_offset
        rows = model._position_rows
        feeds[pos_t.tensor_id] = (pos if rows is None
                                  else pos.clamp(0, rows - 1))
    return feeds


def forward_with_meta(model, params, state, meta, compute_dtype,
                      kv_contiguous=False, kv_append_q=None, generator=None):
    """One serving forward over a BatchMeta (or TreeBatchMeta) of device
    tensors.

    ``kv_contiguous=True`` promises every active row's append region
    [start, start+Q) is in bounds (the contiguous KV append applies).
    ``kv_append_q`` declares that only the first kv_append_q tokens per
    row are real: with 1, the KV append fuses into the attention kernel.
    ``generator`` feeds a sampled graph's draws. Returns (final output,
    new_state)."""
    ctx = OpContext(compute_dtype=compute_dtype, batch_config=meta,
                    kv_contiguous=kv_contiguous, kv_append_q=kv_append_q,
                    generator=generator)
    values, new_state = model._run_graph(params, build_feeds(model, meta),
                                         ctx, state)
    return values[model._final_tensor.tensor_id], new_state


def _forward_tokens(model, params, state, tokens, positions, start_pos,
                    num_tokens, active, compute_dtype, generator=None):
    """One engine-issued forward over [R, Q] tokens; returns (out,
    new_state). Engine forwards stage contiguous, in-bounds KV runs (each
    engine's live mask reserves the whole staging window)."""
    meta = BatchMeta(tokens=tokens, positions=positions, start_pos=start_pos,
                     num_tokens=num_tokens, active=active)
    return forward_with_meta(model, params, state, meta, compute_dtype,
                             kv_contiguous=True, generator=generator)


def make_decode_block(model, compute_dtype, max_steps: int, width: int = 1):
    """The multi-step decode program for ``model``.

    Signature: (params, op_state, tok [R], pos [R], active [R], n,
    generator=None) -> (tokens [R, max_steps], new_op_state, last_tok
    [R]), all device tensors; only the first ``n <= max_steps`` columns
    are meaningful. ``pos[r]`` is the sequence index of the pending token
    ``tok[r]``; ``generator`` feeds a sampled graph's draws.

    ``width > 1`` runs each step at the speculative verify pass's token
    width with one real token per row (verify-consistent decode); only
    the real token's KV is appended (kv_append_q=1), fused into the
    attention kernel."""

    def block(params, op_state, tok, pos, active, n, generator=None):
        R = tok.shape[0]
        num = active.to(torch.int32)
        out = torch.zeros((R, max_steps), dtype=torch.int32,
                          device=tok.device)
        for i in range(int(n)):
            if width == 1:
                o, op_state = _forward_tokens(
                    model, params, op_state, tok[:, None], pos[:, None], pos,
                    num, active, compute_dtype, generator)
            else:
                toks = torch.zeros((R, width), dtype=torch.int32,
                                   device=tok.device)
                toks[:, 0] = tok
                qpos = pos[:, None] + torch.arange(
                    width, dtype=torch.int32, device=tok.device)[None, :]
                meta = BatchMeta(tokens=toks, positions=qpos, start_pos=pos,
                                 num_tokens=num, active=active)
                o, op_state = forward_with_meta(
                    model, params, op_state, meta, compute_dtype,
                    kv_append_q=1, generator=generator)
            tok = o[:, 0].to(torch.int32)
            out[:, i] = tok
            pos = pos + 1
        return out, op_state, tok

    return block


def make_draft_chain(model, compute_dtype, depth: int):
    """The greedy draft-chain program of one draft model, for the host
    tree path.

    Signature: (params, op_state, tok [R], pos [R], active [R]) ->
    (chain [R, depth], new_op_state): ``depth`` width-1 steps from the
    pending token ``tok`` at ``pos``, each feeding its argmax to the
    next, with one readback (by the caller). The drafted tokens' KV is
    tentative: later rounds overwrite it past the accepted point."""

    def chain(params, op_state, tok, pos, active):
        num = active.to(torch.int32)
        toks = torch.zeros((tok.shape[0], depth), dtype=torch.int32,
                           device=tok.device)
        for i in range(depth):
            out, op_state = _forward_tokens(
                model, params, op_state, tok[:, None], pos[:, None], pos,
                num, active, compute_dtype)
            tok = out[:, 0].to(torch.int32)
            toks[:, i] = tok
            pos = pos + 1
        return toks, op_state

    return chain


# ----------------------------------------------------------------------
# speculative engines
# ----------------------------------------------------------------------
def _adapt_depth_rule(adapt: bool, act_i, n_acc, depth_v, alive,
                      min_depth: int, max_depth: int):
    """The adaptive controller's in-block policy (a no-op for a static
    block):

    * depth adaptation between rounds: grow on a full accept, shrink on a
      zero accept, hold otherwise, bounded by [min_depth, engine depth];
      the host re-anchors from its cost model at the block boundary;
    * give-up: a row already at the floor that still accepts nothing
      leaves the block, so a collapsed draft costs at most the shrink
      path before the host parks it on incremental decoding.

    Returns (depth_v, alive)."""
    if not adapt:
        return depth_v, alive
    give_up = act_i & (n_acc == 0) & (depth_v == min_depth)
    alive = alive & ~give_up
    grown = torch.where(n_acc >= depth_v, depth_v + 1,
                        torch.where(n_acc == 0, depth_v - 1, depth_v))
    depth_v = torch.where(act_i, grown.clamp(min_depth, max_depth), depth_v)
    return depth_v, alive


def _round_depth(act_i, depth_v) -> int:
    """The host's one read per round: the deepest live row's depth bound
    (the draft steps to run), or 0 when no row is live."""
    return int(torch.where(act_i, depth_v, torch.zeros_like(depth_v)).max())


def _accepted(chain, pred, depth_r):
    """Greedy acceptance: the longest prefix where the draft ``chain``
    [R, d] equals the verifier's prediction ``pred`` [R, d], with
    positions past the row's depth bound counting as mismatches (so
    n_acc <= depth_r). int32 [R]."""
    d = chain.shape[1]
    match = ((chain == pred)
             & (torch.arange(d, device=chain.device)[None, :]
                < depth_r[:, None]))
    return match.to(torch.int32).cumprod(1).sum(1, dtype=torch.int32)


class _SpecEngineBase:
    """What the two engines share: the host-side ``run_block`` contract
    and the block loop's bookkeeping."""

    def __init__(self, llm, depth: int, max_rounds: int):
        self.llm = llm
        llm.finalize_gemm_fusion()
        self.depth = depth
        self.max_rounds = max_rounds
        self._compute_dtype = torch_dtype(llm.config.compute_dtype)
        # verify passes run so far (one per round that had a live row)
        self.rounds_run = 0

    def _block(self, tok, pos, active, n_rounds, remaining, depth_v,
               min_depth, adapt):
        raise NotImplementedError

    def run_block(self, tok: np.ndarray, pos: np.ndarray, active: np.ndarray,
                  n_rounds: int, remaining: Optional[np.ndarray] = None,
                  depth: Optional[np.ndarray] = None, min_depth: int = 1
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Run up to ``n_rounds`` (<= max_rounds) rounds; returns
        (toks, n_acc, depth_used), each ``[R, max_rounds, ...]``.

        n_acc[r, k] == -1 marks a round where slot r drafted nothing.
        ``remaining[r]`` is slot r's generation budget: a row stops once
        its budget is drafted (or its cache has no room for a round), and
        the block ends when no row is left. ``depth[r]`` (None = static:
        the engine depth, no in-block adaptation) bounds row r's draft
        depth for the first round; between rounds the engine grows or
        shrinks it and a row that accepts nothing at the floor leaves the
        block; depth_used[r, k] is the bound round k ran under. Updates
        every model's op_state."""
        n_rounds = min(int(n_rounds), self.max_rounds)
        R = tok.shape[0]
        if remaining is None:
            remaining = np.full((R,), np.iinfo(np.int32).max // 2, np.int32)
        adapt = depth is not None
        if depth is None:
            depth = np.full((R,), self.depth, np.int32)
        depth = np.clip(np.asarray(depth, np.int32), 1, self.depth)
        min_depth = max(1, min(int(min_depth), self.depth))
        dev = self.llm.device

        def t(x, dt=torch.int32):
            return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

        packed = self._block(t(tok), t(pos), t(active, torch.bool),
                             n_rounds, t(remaining), t(depth), min_depth,
                             adapt).cpu().numpy()
        return packed[:, :, :-2], packed[:, :, -2], packed[:, :, -1]

    def _packed0(self, R, dev):
        """[R, max_rounds, depth+3]: tokens ++ n_acc ++ depth used, with
        n_acc and depth -1 on rounds that never ran."""
        d = self.depth
        packed = torch.zeros((R, self.max_rounds, d + 3), dtype=torch.int32,
                             device=dev)
        packed[:, :, d + 1:] = -1
        return packed


class SpecChainEngine(_SpecEngineBase):
    """Chain speculation with one draft model: per round the draft
    decodes a greedy chain of the round's depth (one extra width-1 step
    back-fills the draft KV for the accept-all case), the verifier scores
    [pending, chain] in one causal width-(depth+1) pass, and acceptance is
    the longest matching prefix plus the verifier's bonus token. The
    committed tokens of slot r in round k are ``toks[r, k, :n_acc + 1]``.
    """

    def __init__(self, llm, ssm, depth: int = 4, max_rounds: int = 16):
        super().__init__(llm, depth, max_rounds)
        self.ssm = ssm
        ssm.finalize_gemm_fusion()

    def _round(self, tok, pos, active, depth_r, d_run):
        d, llm, ssm = self.depth, self.llm, self.ssm
        R = tok.shape[0]
        num = active.to(torch.int32)
        # draft chain: d_run + 1 width-1 steps, the last only back-fills KV
        chain = torch.zeros((R, d + 1), dtype=torch.int32, device=tok.device)
        t, p = tok, pos
        for i in range(d_run + 1):
            out, ssm.op_state = _forward_tokens(
                ssm, ssm.params, ssm.op_state, t[:, None], p[:, None], p,
                num, active, self._compute_dtype)
            t = out[:, 0].to(torch.int32)
            chain[:, i] = t
            p = p + 1
        chain = chain[:, :d]
        # verify: one causal pass over [pending, chain...] at static width
        # d+1 (undrafted tail columns hold zeros, whose staged KV later
        # rounds overwrite, like padding)
        vtokens = torch.cat([tok[:, None], chain], dim=1)
        vpos = pos[:, None] + torch.arange(d + 1, dtype=torch.int32,
                                           device=tok.device)[None, :]
        out, llm.op_state = _forward_tokens(
            llm, llm.params, llm.op_state, vtokens, vpos, pos, num * (d + 1),
            active, self._compute_dtype)
        a = out.to(torch.int32)                                  # [R, d+1]
        n_acc = _accepted(chain, a[:, :d], depth_r)
        bonus = a.gather(1, n_acc.long()[:, None])[:, 0]
        return bonus, pos + n_acc + 1, a, n_acc

    def _block(self, tok, pos, active, n_rounds, remaining, depth_v,
               min_depth, adapt):
        R, d = tok.shape[0], self.depth
        max_seq = self.llm.config.max_sequence_length
        packed = self._packed0(R, tok.device)
        alive = active.clone()
        for i in range(n_rounds):
            # a row drafts while it owes tokens and a full round of KV
            # slots (pos..pos+d) fits in its cache
            act_i = active & (remaining > 0) & (pos + d < max_seq) & alive
            d_run = _round_depth(act_i, depth_v)
            if d_run == 0:
                break
            ntok, npos, a, n_acc = self._round(tok, pos, act_i, depth_v,
                                               d_run)
            self.rounds_run += 1
            tok = torch.where(act_i, ntok, tok)
            pos = torch.where(act_i, npos, pos)
            remaining = remaining - torch.where(act_i, n_acc + 1, 0)
            packed[:, i, :d + 1] = a
            packed[:, i, d + 1] = torch.where(act_i, n_acc, -1)
            packed[:, i, d + 2] = torch.where(act_i, depth_v, -1)
            depth_v, alive = _adapt_depth_rule(adapt, act_i, n_acc, depth_v,
                                               alive, min_depth, d)
        return packed


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class MultiSpecEngine(_SpecEngineBase):
    """Tree speculation with B draft models, fused per block.

    Per round:

    * each draft model drafts a greedy chain of the round's depth; its
      first step has width depth+1 and doubles as the catch-up over last
      round's accepted block, so a draft cache whose chain lost the
      previous round gets the accepted tokens' KV before drafting;
    * the chains verify as one token tree: a root and B unmerged chains,
      padded to a multiple of ``VERIFY_WIDTH`` (``tree_width``). The
      topology, its ancestor mask and every node's cache slot are fixed
      for the engine, so they are built once;
    * greedy acceptance picks the branch with the longest matching prefix;
    * with B > 1 the accepted nodes' KV moves from branch j's slots to the
      committed region (``commit_tree_kv``, the reference's
      commit_tokens_kernel), every layer at once; its ``nonzero`` waits
      for the device, once a round. Branch 0's slots already are that
      region.

    The committed tokens of slot r in round k are ``toks[r, k, :n_acc]``
    plus the bonus token at the fixed index ``toks[r, k, depth]``.
    """

    def __init__(self, llm, ssms, depth: int = 4, max_rounds: int = 16):
        super().__init__(llm, depth, max_rounds)
        self.ssms = list(ssms)
        for s in self.ssms:
            s.finalize_gemm_fusion()
        self._consts = None

    @property
    def tree_width(self) -> int:
        """Verify width: the real nodes (1 + B * depth) rounded up to a
        multiple of VERIFY_WIDTH, so that a B = 1 tree up to depth 7 runs
        the incremental decode's width; padding nodes are masked off by
        num_nodes and their outputs unread."""
        return round_up(1 + len(self.ssms) * self.depth, VERIFY_WIDTH)

    def _tree_constants(self, R, dev):
        """(parent [R, Tp], depth_of [Tp], ancestor [R, Tp, Tp]) on
        ``dev``, built once."""
        if self._consts is None or self._consts[0].shape[0] != R:
            from flexflow_tpu_torch.serve.batch_config import \
                ancestor_mask_from_parents

            d, B, Tp = self.depth, len(self.ssms), self.tree_width
            parent = np.full((1, Tp), -1, np.int32)
            depth_of = np.zeros((Tp,), np.int32)
            for j in range(B):
                for i in range(d):
                    n = 1 + j * d + i
                    parent[0, n] = 0 if i == 0 else n - 1
                    depth_of[n] = i + 1
            anc = ancestor_mask_from_parents(parent)
            anc[0, 1 + B * d:] = False          # padding nodes see nothing
            self._consts = (
                torch.as_tensor(np.repeat(parent, R, 0), device=dev),
                torch.as_tensor(depth_of, device=dev),
                torch.as_tensor(np.repeat(anc, R, 0), device=dev))
        return self._consts

    def _draft(self, ssm, tks, nblk, base, active, d_run):
        """Catch-up + chain for one draft model. tks [R, d+1] is last
        round's accepted block (count nblk, first token at position base).
        Returns chain [R, d]; columns past d_run stay zero and acceptance
        caps them off."""
        d = self.depth
        R = tks.shape[0]
        dev = tks.device
        num = torch.where(active, nblk, 0)
        pos = base[:, None] + torch.arange(d + 1, dtype=torch.int32,
                                           device=dev)[None, :]
        out, ssm.op_state = _forward_tokens(
            ssm, ssm.params, ssm.op_state, tks, pos, base, num, active,
            self._compute_dtype)
        # next token = argmax after the block's last real token
        t = out.gather(1, (nblk - 1).clamp(min=0).long()[:, None])[:, 0]
        t = t.to(torch.int32)
        chain = torch.zeros((R, d), dtype=torch.int32, device=dev)
        chain[:, 0] = t
        p = base + nblk                                 # root position + 1
        one = active.to(torch.int32)
        for i in range(d_run - 1):
            out, ssm.op_state = _forward_tokens(
                ssm, ssm.params, ssm.op_state, t[:, None], p[:, None], p,
                one, active, self._compute_dtype)
            t = out[:, 0].to(torch.int32)
            chain[:, i + 1] = t
            p = p + 1
        return chain

    def _round(self, tks, nblk, base, active, depth_r, d_run):
        d, B, llm = self.depth, len(self.ssms), self.llm
        R = tks.shape[0]
        dev = tks.device
        T, Tp = 1 + B * d, self.tree_width
        r_pos = base + nblk - 1
        chains = [self._draft(s, tks, nblk, base, active, d_run)
                  for s in self.ssms]
        # verify: root + B chains as a fixed-topology tree
        root = tks.gather(1, (nblk - 1).clamp(min=0).long()[:, None])
        tokens = torch.zeros((R, Tp), dtype=torch.int32, device=dev)
        tokens[:, :T] = torch.cat([root] + chains, dim=1)
        parent, depth_of, anc = self._tree_constants(R, dev)
        meta = TreeBatchMeta(
            tokens=tokens, positions=r_pos[:, None] + depth_of[None, :],
            parent=parent, ancestor=anc, start_pos=r_pos,
            num_nodes=torch.where(active, T, 0).to(torch.int32),
            active=active)
        out, llm.op_state = forward_with_meta(
            llm, llm.params, llm.op_state, meta, self._compute_dtype,
            kv_contiguous=True)
        o = out.to(torch.int32)                                   # [R, Tp]
        # per-branch greedy acceptance, best branch wins (the first on ties)
        n_mat = torch.stack(
            [_accepted(chains[j],
                       torch.cat([o[:, :1], o[:, 1 + j * d: j * d + d]], 1),
                       depth_r) for j in range(B)], dim=1)        # [R, B]
        best_j = n_mat.argmax(dim=1).to(torch.int32)
        n_acc = n_mat.amax(dim=1)
        bonus_idx = torch.where(n_acc == 0, 0, 1 + best_j * d + n_acc - 1)
        bonus = o.gather(1, bonus_idx.long()[:, None])[:, 0]
        best_chain = torch.stack(chains, dim=1)[torch.arange(R, device=dev),
                                                best_j.long()]
        if B > 1:
            # cache[r, r_pos+1+i] <- cache[r, r_pos+1+best_j*d+i], i < n_acc
            commit_tree_kv(
                llm.op_state,
                best_j[:, None] * d + torch.arange(d, device=dev)[None, :],
                n_acc, r_pos + 1, active)
        # next round's accepted block: [accepted chain prefix, bonus]
        idx = torch.arange(d + 1, device=dev)[None, :]
        blk = torch.where(
            idx < n_acc[:, None],
            torch.nn.functional.pad(best_chain, (0, 1)),
            torch.where(idx == n_acc[:, None], bonus[:, None], 0))
        return blk.to(torch.int32), best_chain, n_acc, bonus

    def _block(self, tok, pos, active, n_rounds, remaining, depth_v,
               min_depth, adapt):
        R, d = tok.shape[0], self.depth
        max_seq = self.llm.config.max_sequence_length
        Tp = self.tree_width
        packed = self._packed0(R, tok.device)
        # call-boundary invariant: the accepted block is the pending root
        tks = torch.zeros((R, d + 1), dtype=torch.int32, device=tok.device)
        tks[:, 0] = tok
        nblk = torch.ones_like(tok)
        base = pos
        alive = active.clone()
        for i in range(n_rounds):
            # reserve the padded verify width: the contiguous KV append
            # writes the whole [r_pos, r_pos + Tp) staging window
            act_i = (active & (remaining > 0)
                     & (base + nblk - 1 + Tp <= max_seq - 1) & alive)
            d_run = _round_depth(act_i, depth_v)
            if d_run == 0:
                break
            blk, chain, n_acc, bonus = self._round(tks, nblk, base, act_i,
                                                   depth_v, d_run)
            self.rounds_run += 1
            tks = torch.where(act_i[:, None], blk, tks)
            base = torch.where(act_i, base + nblk, base)
            nblk = torch.where(act_i, n_acc + 1, nblk)
            remaining = remaining - torch.where(act_i, n_acc + 1, 0)
            packed[:, i, :d] = chain
            packed[:, i, d] = bonus
            packed[:, i, d + 1] = torch.where(act_i, n_acc, -1)
            packed[:, i, d + 2] = torch.where(act_i, depth_v, -1)
            depth_v, alive = _adapt_depth_rule(adapt, act_i, n_acc, depth_v,
                                               alive, min_depth, d)
        return packed


class BeamSpecEngine(_SpecEngineBase):
    """Beam speculation with one draft model of beam width W, fused per
    block (the host-stepped twin is ``RequestManager._draft_beams`` on
    the host tree path).

    The node layout is fixed: node 0 is the root, beam level t's W
    selected children are nodes [1 + t*W, 1 + (t+1)*W). Parent pointers,
    the ancestor mask and the cumulative log-probabilities are data on
    that layout, so the frontier is always the newest W nodes. Per round:

    * the draft's catch-up over last round's accepted block (one causal
      width depth+1 pass) doubles as the root's expansion: the draft's
      packed [top-W probs, top-W ids] at the block's last real token;
    * each further beam level stages the tree grown so far on the draft
      (tree attention gives every frontier node its ancestor path; no
      per-beam KV) and keeps the W best of W x W candidates by
      cumulative log-probability, ties to the lower (frontier, child)
      index, as the host path's stable sort orders them. Levels past the
      round's deepest depth bound are skipped (the one host read of the
      round decides how many run);
    * the verifier checks the whole tree in one K1-bias pass; greedy
      acceptance walks the levels (a child survives if its parent is on
      the accepted path and its token is the verifier's argmax there);
    * the accepted nodes' KV moves from their staged slots into the
      committed region (the reference's commit_tokens_kernel).

    Same packed contract as ``SpecChainEngine``: the committed tokens of
    slot r in round k are ``toks[r, k, :n_acc + 1]``.
    """

    def __init__(self, llm, ssm, depth: int = 4, width: int = 2,
                 max_rounds: int = 16):
        super().__init__(llm, depth, max_rounds)
        self.ssm = ssm
        ssm.finalize_gemm_fusion()
        self.width = width
        self.T = 1 + depth * width                  # real tree nodes
        self.tree_width = round_up(max(self.T, depth + 1), VERIFY_WIDTH)
        nd = np.zeros((self.tree_width,), np.int32)
        for t in range(depth):
            nd[1 + t * width: 1 + (t + 1) * width] = t + 1
        self._depth_of = torch.as_tensor(nd, device=llm.device)
        # beam levels staged on the draft so far (levels past the first;
        # each is one tree forward of the draft)
        self.levels_run = 0

    def _select(self, cand, ids_flat, par_flat):
        """The W best candidates: (cum [R, W], tokens [R, W], parents
        [R, W]); equal scores keep their flat index order."""
        cum, idx = stable_top_k(cand, self.width)
        tok = ids_flat.gather(1, idx).to(torch.int32)
        par = par_flat.gather(1, idx).to(torch.int32)
        return cum, tok, par

    def _place_level(self, t, tree, cand, ids_flat, par_flat):
        """Select level t's W nodes and write them into their fixed slots
        of ``tree`` = (tokens, parent, anc) in place; returns the new
        cumulative scores."""
        tokens, parent, anc = tree
        W, Tp = self.width, self.tree_width
        R = tokens.shape[0]
        cum, tok, par = self._select(cand, ids_flat, par_flat)
        lvl0 = 1 + t * W
        tokens[:, lvl0:lvl0 + W] = tok
        parent[:, lvl0:lvl0 + W] = par
        # a child's ancestor row is its parent's row plus itself
        par_rows = anc.gather(
            1, par.clamp(min=0).long()[:, :, None].expand(R, W, Tp))
        par_rows[:, :, lvl0:lvl0 + W] |= torch.eye(W, dtype=torch.bool,
                                                   device=anc.device)
        anc[:, lvl0:lvl0 + W] = par_rows
        return cum

    def _round(self, tks, nblk, base, active, depth_r, d_run):
        d, W, T, Tp = self.depth, self.width, self.T, self.tree_width
        llm, ssm = self.llm, self.ssm
        R = tks.shape[0]
        dev = tks.device
        r_pos = base + nblk - 1
        last = (nblk - 1).clamp(min=0).long()
        rows = torch.arange(R, device=dev)
        # catch-up + root expansion: one causal pass of width d + 1
        pos = base[:, None] + torch.arange(d + 1, dtype=torch.int32,
                                           device=dev)[None, :]
        out0, ssm.op_state = _forward_tokens(
            ssm, ssm.params, ssm.op_state, tks, pos, base,
            torch.where(active, nblk, 0), active, self._compute_dtype)
        root_out = out0[rows, last]                              # [R, 2W]
        tokens = torch.zeros((R, Tp), dtype=torch.int32, device=dev)
        tokens[:, 0] = tks[rows, last]
        parent = torch.full((R, Tp), -1, dtype=torch.int32, device=dev)
        anc = torch.zeros((R, Tp, Tp), dtype=torch.bool, device=dev)
        anc[:, 0, 0] = True
        tree = (tokens, parent, anc)
        positions = r_pos[:, None] + self._depth_of[None, :]
        cum = self._place_level(
            0, tree, torch.log(root_out[:, :W].float().clamp(min=1e-20)),
            root_out[:, W:2 * W], torch.zeros((R, W), dtype=torch.int32,
                                              device=dev))
        for t in range(1, min(d, d_run)):
            meta = TreeBatchMeta(
                tokens=tokens, positions=positions, parent=parent,
                ancestor=anc, start_pos=r_pos,
                num_nodes=torch.where(active, 1 + t * W, 0).to(torch.int32),
                active=active)
            out, ssm.op_state = forward_with_meta(
                ssm, ssm.params, ssm.op_state, meta, self._compute_dtype,
                kv_contiguous=True)                            # [R, Tp, 2W]
            self.levels_run += 1
            f0 = 1 + (t - 1) * W
            probs = out[:, f0:f0 + W, :W].float()
            # candidate (frontier i, child j) at flat index i * W + j
            cand = (cum[:, :, None]
                    + torch.log(probs.clamp(min=1e-20))).reshape(R, W * W)
            par_flat = (f0 + torch.arange(W, dtype=torch.int32, device=dev)
                        )[None, :, None].expand(R, W, W).reshape(R, W * W)
            cum = self._place_level(t, tree, cand,
                                    out[:, f0:f0 + W, W:2 * W].reshape(
                                        R, W * W), par_flat)
        # verify the whole tree on the LLM
        meta = TreeBatchMeta(
            tokens=tokens, positions=positions, parent=parent, ancestor=anc,
            start_pos=r_pos,
            num_nodes=torch.where(active, T, 0).to(torch.int32),
            active=active)
        out, llm.op_state = forward_with_meta(
            llm, llm.params, llm.op_state, meta, self._compute_dtype,
            kv_contiguous=True)
        o = out.to(torch.int32)                                   # [R, Tp]
        # greedy acceptance walk over the levels
        cur = torch.zeros((R,), dtype=torch.long, device=dev)
        alive = active.clone()
        n_acc = torch.zeros((R,), dtype=torch.int32, device=dev)
        path = torch.zeros((R, d), dtype=torch.long, device=dev)
        for t in range(d):
            lvl0 = 1 + t * W
            want = o.gather(1, cur[:, None])
            ok = ((parent[:, lvl0:lvl0 + W] == cur[:, None])
                  & (tokens[:, lvl0:lvl0 + W] == want)
                  & (alive & (depth_r > t))[:, None])
            has = ok.any(dim=1)
            nxt = lvl0 + ok.to(torch.int32).argmax(dim=1)
            path[:, t] = torch.where(has, nxt, 0)
            cur = torch.where(has, nxt, cur)
            n_acc = n_acc + has.to(torch.int32)
            alive = alive & has
        bonus = o.gather(1, cur[:, None])[:, 0]
        # the accepted nodes' KV: cache[r, r_pos+1+i] <- cache[r,
        # r_pos+path[r, i]] for i < n_acc
        commit_tree_kv(llm.op_state, path - 1, n_acc, r_pos + 1, active)
        chain = tokens.gather(1, path)                             # [R, d]
        idx = torch.arange(d + 1, device=dev)[None, :]
        blk = torch.where(
            idx < n_acc[:, None], torch.nn.functional.pad(chain, (0, 1)),
            torch.where(idx == n_acc[:, None], bonus[:, None], 0))
        return blk.to(torch.int32), n_acc

    def _block(self, tok, pos, active, n_rounds, remaining, depth_v,
               min_depth, adapt):
        R, d = tok.shape[0], self.depth
        max_seq = self.llm.config.max_sequence_length
        Tp = self.tree_width
        packed = self._packed0(R, tok.device)
        # call-boundary invariant: the accepted block is the pending root
        tks = torch.zeros((R, d + 1), dtype=torch.int32, device=tok.device)
        tks[:, 0] = tok
        nblk = torch.ones_like(tok)
        base = pos
        alive = active.clone()
        for i in range(n_rounds):
            # reserve the padded tree's whole staging window
            act_i = (active & (remaining > 0)
                     & (base + nblk - 1 + Tp <= max_seq - 1) & alive)
            d_run = _round_depth(act_i, depth_v)
            if d_run == 0:
                break
            blk, n_acc = self._round(tks, nblk, base, act_i, depth_v, d_run)
            self.rounds_run += 1
            tks = torch.where(act_i[:, None], blk, tks)
            base = torch.where(act_i, base + nblk, base)
            nblk = torch.where(act_i, n_acc + 1, nblk)
            remaining = remaining - torch.where(act_i, n_acc + 1, 0)
            packed[:, i, :d + 1] = blk
            packed[:, i, d + 1] = torch.where(act_i, n_acc, -1)
            packed[:, i, d + 2] = torch.where(act_i, depth_v, -1)
            depth_v, alive = _adapt_depth_rule(adapt, act_i, n_acc, depth_v,
                                               alive, min_depth, d)
        return packed
