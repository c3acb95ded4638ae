"""Serving forwards, the multi-step decode block and the fused speculative
engines (counterpart of ``flexflow_tpu/serve/engine.py``).

The JAX package runs each token-feedback loop (decode steps, speculation
rounds, draft chains) as one jitted ``while_loop`` whose trip count is a
device scalar, so one compiled program serves every block. Here each
loop is a set of programs (``serve/graphs.py``): the loop's stages,
captured once a key as CUDA graphs on the card (offloaded weights
included: their copies are graph nodes) and replayed, or called directly
on the CPU, under a mesh and under ``inference_debugging``. A stage
reads and updates the block state in place: a step writes its token at
a device step index and feeds it to the next step, a round writes its
packed row at a device round index.
Tokens, positions and KV caches stay on the device. A decode block
reads back once, at its end. A speculation round reads one scalar
first: the round's draft depth, which is 0 when no row is live (the
loop's exit test). Each block's packed ``[R, max_rounds, depth+3]``
result is read once, at its end. A sampled graph draws from the
``torch.Generator`` passed in (the JAX engines' RNG key), registered
with its program; speculation is greedy and draws nothing.

Telemetry: ``run_block`` of every speculative engine records the block
(``ServingTelemetry.record_spec_block``: its wall time up to the packed
result's readback, which is the block's one fence, and the per-round
accepted lengths and depths) in ``engine.telemetry`` or, when that is
None, the process-global telemetry (``_resolve_tel``), and then the
program builds it has not reported (``note_retrace``, as the JAX
engines report their compiles). No other host sync is added.

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

import functools
import time
from typing import Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.ffconst import torch_dtype
from flexflow_tpu_torch.ops.base import OpContext
from flexflow_tpu_torch.ops.inc_attention import commit_tree_kv
from flexflow_tpu_torch.ops.reduction_ops import stable_top_k
from flexflow_tpu_torch.serve.batch_config import BatchMeta, TreeBatchMeta
from flexflow_tpu_torch.serve.graphs import (ProgramCache, ProgramSet,
                                             captures, tensor_key)
from flexflow_tpu_torch.serve.inference_manager import VERIFY_WIDTH
from flexflow_tpu_torch.telemetry import get_telemetry


def _resolve_tel(explicit):
    """Engine-side telemetry resolution: an explicitly injected
    ServingTelemetry (the RequestManager hands its own through
    ``engine.telemetry``) wins over the process-global one."""
    return explicit if explicit is not None else get_telemetry()


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


def _i32(*shape, dev):
    return torch.zeros(shape, dtype=torch.int32, device=dev)


def _index(dev):
    """A device step or round index: int64 [1] (``index_copy_``'s index),
    so that a captured program writes at the index the replay reaches,
    not at the one it was captured with."""
    return torch.zeros(1, dtype=torch.long, device=dev)


def _graph_samples(model) -> bool:
    """Does ``model``'s serving graph draw (a top-p head)?"""
    from flexflow_tpu_torch.ffconst import OpType

    return any(layer.op_type == OpType.SAMPLING for layer in model.layers)


class _StepBlock:
    """The self-feeding step program of one model: each use runs one step
    at ``width`` tokens a row (one real), writes the argmax (or draw) at
    the device step index of ``out`` and feeds it back as the next step's
    token at the next position. ``n`` steps are ``n`` uses and one
    readback (by the caller). The decode block and the host tree path's
    draft chain are this program."""

    def __init__(self, model, compute_dtype, max_steps: int, width: int = 1):
        self.model = model
        self.compute_dtype = compute_dtype
        self.max_steps = max_steps
        self.width = width
        self._sampled = _graph_samples(model)
        self._cache = ProgramCache(model)

    @property
    def _trace_count(self) -> int:
        return self._cache.builds

    def _state(self, R, dev):
        st = {"tok": _i32(R, dev=dev), "pos": _i32(R, dev=dev),
              "active": torch.zeros(R, dtype=torch.bool, device=dev),
              "num": _i32(R, dev=dev), "i": _index(dev),
              "out": _i32(R, self.max_steps, dev=dev)}
        return st

    def _step(self, st, generator=None):
        """One step over the block state (the stage the program captures).
        ``width > 1``: the speculative verify pass's width with one real
        token a row; only its KV is appended (kv_append_q=1), fused into
        the attention kernel."""
        m, W = self.model, self.width
        tok, pos = st["tok"], st["pos"]
        if W == 1:
            o, m.op_state = _forward_tokens(
                m, m.params, m.op_state, tok[:, None], pos[:, None], pos,
                st["num"], st["active"], self.compute_dtype, generator)
        else:
            R = tok.shape[0]
            toks = torch.zeros((R, W), dtype=torch.int32, device=tok.device)
            toks[:, 0] = tok
            qpos = pos[:, None] + torch.arange(
                W, dtype=torch.int32, device=tok.device)[None, :]
            meta = BatchMeta(tokens=toks, positions=qpos, start_pos=pos,
                             num_tokens=st["num"], active=st["active"])
            o, m.op_state = forward_with_meta(
                m, m.params, m.op_state, meta, self.compute_dtype,
                kv_append_q=1, generator=generator)
        nxt = o[:, 0].to(torch.int32)
        st["out"].index_copy_(1, st["i"], nxt[:, None])
        tok.copy_(nxt)
        pos.add_(1)
        st["i"].add_(1)

    def run(self, params, op_state, tok, pos, active, n, generator=None):
        """(out [R, max_steps] with the first ``n`` columns filled, the
        last token [R]), device tensors of the caller's own."""
        m = self.model
        R, dev = tok.shape[0], tok.device
        sampled = self._sampled
        gen = generator if sampled else None
        key = (R, self.width, self.max_steps, self.compute_dtype, sampled,
               id(gen), tensor_key(params, op_state))
        capture = captures(m) and (gen is not None or not sampled)
        progs = self._cache.get(key, lambda cap: ProgramSet(
            {"step": self._step}, self._state(R, dev), cap, generator=gen,
            state_of=lambda: m.op_state), capture)
        st = progs.st
        st["tok"].copy_(tok)
        st["pos"].copy_(pos)
        st["active"].copy_(active)
        st["num"].copy_(active.to(torch.int32))
        st["i"].zero_()
        st["out"].zero_()
        for _ in range(int(n)):
            progs.run("step")
        return st["out"].clone(), st["tok"].clone()


def make_decode_block(model, compute_dtype, max_steps: int, width: int = 1):
    """The multi-step decode program for ``model``.

    Signature: (params, op_state, tok [R], pos [R], active [R], n,
    generator=None) -> (tokens [R, max_steps], new_op_state, last_tok
    [R]), all device tensors; only the first ``n <= max_steps`` columns
    are meaningful. ``pos[r]`` is the sequence index of the pending token
    ``tok[r]``; ``generator`` feeds a sampled graph's draws. One program
    (``_StepBlock``, replayed ``n`` times) serves every n; ``params`` and
    ``op_state`` are the model's own, which it reads by address.

    ``width > 1`` runs each step at the speculative verify pass's token
    width with one real token per row (verify-consistent decode); only
    the real token's KV is appended (kv_append_q=1), fused into the
    attention kernel. The returned callable's ``program`` is the
    ``_StepBlock`` (its ``_trace_count``)."""
    program = _StepBlock(model, compute_dtype, max_steps, width)

    def block(params, op_state, tok, pos, active, n, generator=None):
        out, last = program.run(params, op_state, tok, pos, active, n,
                                generator)
        return out, op_state, last

    block.program = program
    return block


def make_draft_chain(model, compute_dtype, depth: int):
    """The greedy draft-chain program of one draft model, for the host
    tree path: the width-1 step program replayed ``depth`` times.

    Signature: (params, op_state, tok [R], pos [R], active [R]) ->
    (chain [R, depth], new_op_state): ``depth`` width-1 steps from the
    pending token ``tok`` at ``pos``, each feeding its argmax to the
    next, with one readback (by the caller). The drafted tokens' KV is
    tentative: later rounds overwrite it past the accepted point."""
    program = _StepBlock(model, compute_dtype, depth, 1)

    def chain(params, op_state, tok, pos, active):
        out, _last = program.run(params, op_state, tok, pos, active, depth)
        return out, op_state

    chain.program = program
    return chain


# ----------------------------------------------------------------------
# speculative engines
# ----------------------------------------------------------------------
def _adapt_depth_rule(adapt, act_i, n_acc, depth_v, alive, min_depth,
                      max_depth: int):
    """The adaptive controller's in-block policy (a no-op for a static
    block), with ``adapt`` (bool [1]) and ``min_depth`` (int32 [1]) on
    the device, so that one program serves static and adaptive blocks
    at every floor:

    * depth adaptation between rounds: grow on a full accept, shrink on a
      zero accept, hold otherwise, bounded by [min_depth, engine depth];
      the host re-anchors from its cost model at the block boundary;
    * give-up: a row already at the floor that still accepts nothing
      leaves the block, so a collapsed draft costs at most the shrink
      path before the host parks it on incremental decoding.

    Returns (depth_v, alive)."""
    give_up = adapt & act_i & (n_acc == 0) & (depth_v == min_depth)
    alive = alive & ~give_up
    grown = torch.where(n_acc >= depth_v, depth_v + 1,
                        torch.where(n_acc == 0, depth_v - 1, depth_v))
    depth_v = torch.where(adapt & act_i,
                          torch.maximum(grown, min_depth).clamp(max=max_depth),
                          depth_v)
    return depth_v, alive


def _round_depth(st) -> int:
    """The host's one read per round: the deepest live row's depth bound
    (the draft steps to run), or 0 when no row is live. The gate stage
    leaves it in ``st["dmax"]``."""
    return int(st["dmax"])


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


def _next_block(blk_chain, n_acc, bonus):
    """Next round's accepted block [R, d+1]: the accepted chain prefix,
    the bonus token at index n_acc, zeros after."""
    d = blk_chain.shape[1]
    idx = torch.arange(d + 1, device=blk_chain.device)[None, :]
    return torch.where(
        idx < n_acc[:, None], torch.nn.functional.pad(blk_chain, (0, 1)),
        torch.where(idx == n_acc[:, None], bonus[:, None], 0)).to(torch.int32)


class _SpecEngineBase:
    """What the three engines share: the host-side ``run_block`` contract,
    the block state and the round's bookkeeping, and the programs
    (``serve/graphs.py``): a gate stage (the rows live this round and
    their deepest depth bound), the engine's draft stages and a verify
    stage that ends with the bookkeeping and the next round's gate. A
    round reads one scalar (``_round_depth``) and replays the stages."""

    def __init__(self, llm, depth: int, max_rounds: int):
        self.llm = llm
        llm.finalize_gemm_fusion()
        self.depth = depth
        self.max_rounds = max_rounds
        self._compute_dtype = torch_dtype(llm.config.compute_dtype)
        # verify passes run so far (one per round that had a live row)
        self.rounds_run = 0
        self.telemetry = None   # explicit ServingTelemetry; None -> global

    def _init_programs(self):
        self._cache = ProgramCache(*self._models())

    @property
    def _trace_count(self) -> int:
        """Program builds (the JAX engines' compile count)."""
        return self._cache.builds

    def _models(self):
        raise NotImplementedError

    def _stages(self):
        raise NotImplementedError

    def _block_state(self, R, dev):
        """The state every engine keeps: the rows' masks and budgets, the
        adaptive depths, the packed result and its round index, and the
        gate's outputs. Each engine adds its tokens (the tree engines'
        accepted block, ``_tree_state``; the chain's ``tok``/``pos``)."""
        d = self.depth
        st = {"active": torch.zeros(R, dtype=torch.bool, device=dev),
              "alive": torch.zeros(R, dtype=torch.bool, device=dev),
              "act": torch.zeros(R, dtype=torch.bool, device=dev),
              "remaining": _i32(R, dev=dev), "depth_v": _i32(R, dev=dev),
              "num": _i32(R, dev=dev), "dmax": _i32(1, dev=dev),
              "min_depth": _i32(1, dev=dev),
              "adapt": torch.zeros(1, dtype=torch.bool, device=dev),
              "ri": _index(dev),
              "packed": _i32(R, self.max_rounds, d + 3, dev=dev)}
        return st

    def _programs(self, R, dev):
        models = self._models()
        key = (R, self.depth, self.tree_width, self._compute_dtype,
               tensor_key([(m.params, m.op_state) for m in models]))
        return self._cache.get(key, lambda cap: ProgramSet(
            self._stages(), self._state(R, dev), cap,
            state_of=lambda: [m.op_state for m in models]),
            captures(*models))

    def _load(self, st, tok, pos, active, remaining, depth, min_depth,
              adapt):
        """Copy a block's inputs into the state; the packed result to its
        idle form (n_acc and depth -1)."""
        d = self.depth
        st["active"].copy_(active)
        st["alive"].copy_(active)
        st["remaining"].copy_(remaining)
        st["depth_v"].copy_(depth)
        st["min_depth"].fill_(min_depth)
        st["adapt"].fill_(adapt)
        st["ri"].zero_()
        st["packed"].zero_()
        st["packed"][:, :, d + 1:] = -1
        self._load_tokens(st, tok, pos)

    def _load_tokens(self, st, tok, pos):
        """The call-boundary invariant of the tree engines: the accepted
        block is the pending root."""
        st["tks"].zero_()
        st["tks"][:, 0] = tok
        st["nblk"].fill_(1)
        st["base"].copy_(pos)

    def _tree_state(self, st, R, dev):
        """The tree engines' accepted block: tokens [R, d+1], their count
        and the position of the first."""
        st.update(tks=_i32(R, self.depth + 1, dev=dev), nblk=_i32(R, dev=dev),
                  base=_i32(R, dev=dev))
        return st

    def _tree_gate(self, st, generator=None):
        """A row drafts while it owes tokens and the padded tree's whole
        staging window [r_pos, r_pos + tree_width) fits in its cache."""
        max_seq = self.llm.config.max_sequence_length
        self._gate(st, st["active"] & (st["remaining"] > 0)
                   & (st["base"] + st["nblk"] - 1 + self.tree_width
                      <= max_seq - 1) & st["alive"])

    def _gate(self, st, act):
        """The rows live this round, as a mask and as int32 token counts,
        and their deepest depth bound (the host's one read)."""
        st["act"].copy_(act)
        st["num"].copy_(act.to(torch.int32))
        st["dmax"].copy_(torch.where(act, st["depth_v"], 0).amax()
                         .reshape(1))

    def _book(self, st, row, n_acc):
        """The round's bookkeeping shared by every engine: the budget, the
        packed row at the device round index (``row`` [R, d+1] ++ n_acc
        ++ the depth it ran under, -1 for rows that did not draft), the
        adaptive depths."""
        act, depth_v = st["act"], st["depth_v"]
        st["remaining"].sub_(torch.where(act, n_acc + 1, 0))
        row = torch.cat([row, torch.where(act, n_acc, -1)[:, None],
                         torch.where(act, depth_v, -1)[:, None]], dim=1)
        st["packed"].index_copy_(1, st["ri"], row[:, None, :])
        st["ri"].add_(1)
        depth_v, alive = _adapt_depth_rule(st["adapt"], act, n_acc, depth_v,
                                           st["alive"], st["min_depth"],
                                           self.depth)
        st["depth_v"].copy_(depth_v)
        st["alive"].copy_(alive)

    def _tree_advance(self, st, blk, n_acc):
        """The tree engines' next round: the accepted block, its base and
        count, for the rows that drafted."""
        act, nblk, base = st["act"], st["nblk"], st["base"]
        new_base = torch.where(act, base + nblk, base)
        st["nblk"].copy_(torch.where(act, n_acc + 1, nblk))
        st["base"].copy_(new_base)
        st["tks"].copy_(torch.where(act[:, None], blk, st["tks"]))

    def _rounds(self, progs, n_rounds):
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
        every model's op_state. The first block of a key builds the
        engine's programs, and the builds not yet reported go to
        telemetry after the readback (``note_retrace``)."""
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

        tel = _resolve_tel(self.telemetry)
        t0 = time.perf_counter()
        progs = self._programs(R, dev)
        st = progs.st
        self._load(st, t(tok), t(pos), t(active, torch.bool), t(remaining),
                   t(depth), min_depth, adapt)
        progs.run("gate")
        self._rounds(progs, n_rounds)
        packed = st["packed"].cpu().numpy()
        if tel is not None:     # the readback above is the block's fence
            tel.record_spec_block(time.perf_counter() - t0,
                                  packed[:, :, -2], self.depth,
                                  self.tree_width, depths=packed[:, :, -1])
        self._cache.report(tel, type(self).__name__)
        return packed[:, :, :-2], packed[:, :, -2], packed[:, :, -1]


class SpecChainEngine(_SpecEngineBase):
    """Chain speculation with one draft model: per round the draft
    decodes a greedy chain of the round's depth (one extra width-1 step
    back-fills the draft KV for the accept-all case), the verifier scores
    [pending, chain] in one causal width-(depth+1) pass, and acceptance is
    the longest matching prefix plus the verifier's bonus token. The
    committed tokens of slot r in round k are ``toks[r, k, :n_acc + 1]``.

    Programs: ``gate``, ``draft`` (the draft's width-1 step, replayed
    d_run + 1 times a round) and ``verify`` (the verify pass, the
    acceptance and the round's bookkeeping).
    """

    def __init__(self, llm, ssm, depth: int = 4, max_rounds: int = 16):
        super().__init__(llm, depth, max_rounds)
        self.ssm = ssm
        ssm.finalize_gemm_fusion()
        self._init_programs()

    @property
    def tree_width(self) -> int:
        """The verify pass's width: the pending token and the chain."""
        return self.depth + 1

    def _models(self):
        return [self.llm, self.ssm]

    def _stages(self):
        return {"gate": self._chain_gate, "draft": self._draft_step,
                "verify": self._verify}

    def _state(self, R, dev):
        st = self._block_state(R, dev)
        st.update(tok=_i32(R, dev=dev), pos=_i32(R, dev=dev),
                  dt=_i32(R, dev=dev), dp=_i32(R, dev=dev),
                  dj=_index(dev),
                  chain=_i32(R, self.depth + 1, dev=dev))
        return st

    def _load_tokens(self, st, tok, pos):
        st["tok"].copy_(tok)
        st["pos"].copy_(pos)

    def _chain_gate(self, st, generator=None):
        """A row drafts while it owes tokens and a full round of KV slots
        (pos..pos+d) fits in its cache; the draft chain starts from the
        pending token, its columns zeroed."""
        max_seq = self.llm.config.max_sequence_length
        self._gate(st, st["active"] & (st["remaining"] > 0)
                   & (st["pos"] + self.depth < max_seq) & st["alive"])
        st["dt"].copy_(st["tok"])
        st["dp"].copy_(st["pos"])
        st["dj"].zero_()
        st["chain"].zero_()

    def _draft_step(self, st, generator=None):
        ssm = self.ssm
        out, ssm.op_state = _forward_tokens(
            ssm, ssm.params, ssm.op_state, st["dt"][:, None],
            st["dp"][:, None], st["dp"], st["num"], st["act"],
            self._compute_dtype)
        t = out[:, 0].to(torch.int32)
        st["chain"].index_copy_(1, st["dj"], t[:, None])
        st["dt"].copy_(t)
        st["dp"].add_(1)
        st["dj"].add_(1)

    def _verify(self, st, generator=None):
        """One causal pass over [pending, chain...] at static width d+1
        (undrafted tail columns hold zeros, whose staged KV later rounds
        overwrite, like padding), the acceptance and the bookkeeping."""
        d, llm = self.depth, self.llm
        tok, pos, act = st["tok"], st["pos"], st["act"]
        chain = st["chain"][:, :d]
        vtokens = torch.cat([tok[:, None], chain], dim=1)
        vpos = pos[:, None] + torch.arange(d + 1, dtype=torch.int32,
                                           device=tok.device)[None, :]
        out, llm.op_state = _forward_tokens(
            llm, llm.params, llm.op_state, vtokens, vpos, pos,
            st["num"] * (d + 1), act, self._compute_dtype)
        a = out.to(torch.int32)                                  # [R, d+1]
        n_acc = _accepted(chain, a[:, :d], st["depth_v"])
        bonus = a.gather(1, n_acc.long()[:, None])[:, 0]
        self._book(st, a, n_acc)
        tok.copy_(torch.where(act, bonus, tok))
        pos.copy_(torch.where(act, pos + n_acc + 1, pos))
        self._chain_gate(st)

    def _rounds(self, progs, n_rounds):
        for _ in range(n_rounds):
            d_run = _round_depth(progs.st)
            if d_run == 0:
                break
            for _ in range(d_run + 1):
                progs.run("draft")
            progs.run("verify")
            self.rounds_run += 1


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
      commit_tokens_kernel), every layer at once, with no host read.
      Branch 0's slots already are that region.

    Programs: ``gate``, per draft model j ``catchup{j}`` (width d+1) and
    ``step{j}`` (width 1, replayed d_run - 1 times a round), and
    ``verify`` (the tree pass, the acceptance, the commit and the
    bookkeeping).

    The committed tokens of slot r in round k are ``toks[r, k, :n_acc]``
    plus the bonus token at the fixed index ``toks[r, k, depth]``.
    """

    def __init__(self, llm, ssms, depth: int = 4, max_rounds: int = 16):
        super().__init__(llm, depth, max_rounds)
        self.ssms = list(ssms)
        for s in self.ssms:
            s.finalize_gemm_fusion()
        self._init_programs()

    @property
    def tree_width(self) -> int:
        """Verify width: the real nodes (1 + B * depth) rounded up to a
        multiple of VERIFY_WIDTH, so that a B = 1 tree up to depth 7 runs
        the incremental decode's width; padding nodes are masked off by
        num_nodes and their outputs unread."""
        return round_up(1 + len(self.ssms) * self.depth, VERIFY_WIDTH)

    def _models(self):
        return [self.llm, *self.ssms]

    def _stages(self):
        stages = {"gate": self._tree_gate}
        for j in range(len(self.ssms)):
            stages[f"catchup{j}"] = functools.partial(self._catchup, j)
            stages[f"step{j}"] = functools.partial(self._draft_step, j)
        stages["verify"] = self._verify
        return stages

    def _state(self, R, dev):
        """The block state and the tree constants (parent [R, Tp],
        depth_of [Tp], ancestor [R, Tp, Tp]), built once a key."""
        from flexflow_tpu_torch.serve.batch_config import \
            ancestor_mask_from_parents

        d, B, Tp = self.depth, len(self.ssms), self.tree_width
        st = self._tree_state(self._block_state(R, dev), R, dev)
        for j in range(B):
            st.update({f"chain{j}": _i32(R, d, dev=dev),
                       f"t{j}": _i32(R, dev=dev), f"p{j}": _i32(R, dev=dev),
                       f"i{j}": _index(dev)})
        parent = np.full((1, Tp), -1, np.int32)
        depth_of = np.zeros((Tp,), np.int32)
        for j in range(B):
            for i in range(d):
                n = 1 + j * d + i
                parent[0, n] = 0 if i == 0 else n - 1
                depth_of[n] = i + 1
        anc = ancestor_mask_from_parents(parent)
        anc[0, 1 + B * d:] = False          # padding nodes see nothing
        st.update(parent=torch.as_tensor(np.repeat(parent, R, 0), device=dev),
                  depth_of=torch.as_tensor(depth_of, device=dev),
                  anc=torch.as_tensor(np.repeat(anc, R, 0), device=dev))
        return st

    def _catchup(self, j, st, generator=None):
        """Draft j's catch-up over last round's accepted block (``tks``,
        count ``nblk``, first token at ``base``), width d+1: the chain's
        first token; columns past the round's depth stay zero and
        acceptance caps them off."""
        d, ssm = self.depth, self.ssms[j]
        tks, nblk, base, act = st["tks"], st["nblk"], st["base"], st["act"]
        pos = base[:, None] + torch.arange(d + 1, dtype=torch.int32,
                                           device=tks.device)[None, :]
        out, ssm.op_state = _forward_tokens(
            ssm, ssm.params, ssm.op_state, tks, pos, base,
            torch.where(act, nblk, 0), act, self._compute_dtype)
        # next token = argmax after the block's last real token
        t = out.gather(1, (nblk - 1).clamp(min=0).long()[:, None])[:, 0]
        t = t.to(torch.int32)
        chain = st[f"chain{j}"]
        chain.zero_()
        chain[:, 0] = t
        st[f"t{j}"].copy_(t)
        st[f"p{j}"].copy_(base + nblk)                 # root position + 1
        st[f"i{j}"].fill_(1)

    def _draft_step(self, j, st, generator=None):
        ssm = self.ssms[j]
        t, p = st[f"t{j}"], st[f"p{j}"]
        out, ssm.op_state = _forward_tokens(
            ssm, ssm.params, ssm.op_state, t[:, None], p[:, None], p,
            st["num"], st["act"], self._compute_dtype)
        nxt = out[:, 0].to(torch.int32)
        st[f"chain{j}"].index_copy_(1, st[f"i{j}"], nxt[:, None])
        t.copy_(nxt)
        p.add_(1)
        st[f"i{j}"].add_(1)

    def _verify(self, st, generator=None):
        d, B, llm = self.depth, len(self.ssms), self.llm
        tks, nblk, base, act = st["tks"], st["nblk"], st["base"], st["act"]
        R, dev = tks.shape[0], tks.device
        T, Tp = 1 + B * d, self.tree_width
        r_pos = base + nblk - 1
        chains = [st[f"chain{j}"] for j in range(B)]
        # verify: root + B chains as a fixed-topology tree
        root = tks.gather(1, (nblk - 1).clamp(min=0).long()[:, None])
        tokens = torch.zeros((R, Tp), dtype=torch.int32, device=dev)
        tokens[:, :T] = torch.cat([root] + chains, dim=1)
        meta = TreeBatchMeta(
            tokens=tokens, positions=r_pos[:, None] + st["depth_of"][None, :],
            parent=st["parent"], ancestor=st["anc"], start_pos=r_pos,
            num_nodes=torch.where(act, T, 0).to(torch.int32), active=act)
        out, llm.op_state = forward_with_meta(
            llm, llm.params, llm.op_state, meta, self._compute_dtype,
            kv_contiguous=True)
        o = out.to(torch.int32)                                   # [R, Tp]
        # per-branch greedy acceptance, best branch wins (the first on ties)
        n_mat = torch.stack(
            [_accepted(chains[j],
                       torch.cat([o[:, :1], o[:, 1 + j * d: j * d + d]], 1),
                       st["depth_v"]) for j in range(B)], dim=1)  # [R, B]
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
                n_acc, r_pos + 1, act, mesh=getattr(llm, "mesh", None),
                seq_len=llm.config.max_sequence_length)
        self._book(st, torch.cat([best_chain, bonus[:, None]], dim=1), n_acc)
        self._tree_advance(st, _next_block(best_chain, n_acc, bonus), n_acc)
        self._tree_gate(st)

    def _rounds(self, progs, n_rounds):
        for _ in range(n_rounds):
            d_run = _round_depth(progs.st)
            if d_run == 0:
                break
            for j in range(len(self.ssms)):
                progs.run(f"catchup{j}")
                for _ in range(d_run - 1):
                    progs.run(f"step{j}")
            progs.run("verify")
            self.rounds_run += 1


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

    Programs: ``gate``, ``catchup`` (with level 0), ``level{t}`` for t =
    1 .. depth-1 (each bakes its own slice offsets) and ``verify`` (the
    tree pass, the acceptance walk, the commit and the bookkeeping).

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
        self._init_programs()

    def _models(self):
        return [self.llm, self.ssm]

    def _stages(self):
        stages = {"gate": self._tree_gate, "catchup": self._catchup}
        for t in range(1, self.depth):
            stages[f"level{t}"] = functools.partial(self._level, t)
        stages["verify"] = self._verify
        return stages

    def _state(self, R, dev):
        W, Tp = self.width, self.tree_width
        st = self._tree_state(self._block_state(R, dev), R, dev)
        st.update(tokens=_i32(R, Tp, dev=dev), parent=_i32(R, Tp, dev=dev),
                  anc=torch.zeros((R, Tp, Tp), dtype=torch.bool, device=dev),
                  cum=torch.zeros((R, W), dtype=torch.float32, device=dev),
                  positions=_i32(R, Tp, dev=dev), r_pos=_i32(R, dev=dev))
        return st

    def _select(self, cand, ids_flat, par_flat):
        """The W best candidates: (cum [R, W], tokens [R, W], parents
        [R, W]); equal scores keep their flat index order."""
        cum, idx = stable_top_k(cand, self.width)
        tok = ids_flat.gather(1, idx).to(torch.int32)
        par = par_flat.gather(1, idx).to(torch.int32)
        return cum, tok, par

    def _place_level(self, t, st, cand, ids_flat, par_flat):
        """Select level t's W nodes, write them into their fixed slots of
        the state's tree (tokens, parent, anc) and keep the new
        cumulative scores."""
        tokens, parent, anc = st["tokens"], st["parent"], st["anc"]
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
        st["cum"].copy_(cum)

    def _catchup(self, st, generator=None):
        """Catch-up + root expansion: one causal pass of width d + 1 over
        the accepted block, then level 0 from the root's top W."""
        d, W, ssm = self.depth, self.width, self.ssm
        tks, nblk, base, act = st["tks"], st["nblk"], st["base"], st["act"]
        R, dev = tks.shape[0], tks.device
        last = (nblk - 1).clamp(min=0).long()
        rows = torch.arange(R, device=dev)
        pos = base[:, None] + torch.arange(d + 1, dtype=torch.int32,
                                           device=dev)[None, :]
        out0, ssm.op_state = _forward_tokens(
            ssm, ssm.params, ssm.op_state, tks, pos, base,
            torch.where(act, nblk, 0), act, self._compute_dtype)
        root_out = out0[rows, last]                              # [R, 2W]
        r_pos = base + nblk - 1
        st["r_pos"].copy_(r_pos)
        st["positions"].copy_(r_pos[:, None] + self._depth_of[None, :])
        st["tokens"].zero_()
        st["tokens"][:, 0] = tks[rows, last]
        st["parent"].fill_(-1)
        st["anc"].zero_()
        st["anc"][:, 0, 0] = True
        self._place_level(
            0, st, torch.log(root_out[:, :W].float().clamp(min=1e-20)),
            root_out[:, W:2 * W], torch.zeros((R, W), dtype=torch.int32,
                                              device=dev))

    def _level(self, t, st, generator=None):
        """Beam level t >= 1: stage the tree grown so far on the draft and
        keep the W best children of the frontier."""
        W, ssm = self.width, self.ssm
        act = st["act"]
        R, dev = act.shape[0], act.device
        meta = TreeBatchMeta(
            tokens=st["tokens"], positions=st["positions"],
            parent=st["parent"], ancestor=st["anc"], start_pos=st["r_pos"],
            num_nodes=torch.where(act, 1 + t * W, 0).to(torch.int32),
            active=act)
        out, ssm.op_state = forward_with_meta(
            ssm, ssm.params, ssm.op_state, meta, self._compute_dtype,
            kv_contiguous=True)                                # [R, Tp, 2W]
        f0 = 1 + (t - 1) * W
        probs = out[:, f0:f0 + W, :W].float()
        # candidate (frontier i, child j) at flat index i * W + j
        cand = (st["cum"][:, :, None]
                + torch.log(probs.clamp(min=1e-20))).reshape(R, W * W)
        par_flat = (f0 + torch.arange(W, dtype=torch.int32, device=dev)
                    )[None, :, None].expand(R, W, W).reshape(R, W * W)
        self._place_level(t, st, cand,
                          out[:, f0:f0 + W, W:2 * W].reshape(R, W * W),
                          par_flat)

    def _verify(self, st, generator=None):
        """The whole tree on the verifier, the greedy acceptance walk, the
        commit of the accepted nodes' KV and the bookkeeping."""
        d, W, T = self.depth, self.width, self.T
        llm = self.llm
        tokens, parent, r_pos, act = (st["tokens"], st["parent"],
                                      st["r_pos"], st["act"])
        R, dev = tokens.shape[0], tokens.device
        meta = TreeBatchMeta(
            tokens=tokens, positions=st["positions"], parent=parent,
            ancestor=st["anc"], start_pos=r_pos,
            num_nodes=torch.where(act, T, 0).to(torch.int32), active=act)
        out, llm.op_state = forward_with_meta(
            llm, llm.params, llm.op_state, meta, self._compute_dtype,
            kv_contiguous=True)
        o = out.to(torch.int32)                                   # [R, Tp]
        # greedy acceptance walk over the levels
        cur = torch.zeros((R,), dtype=torch.long, device=dev)
        walk = act.clone()
        n_acc = torch.zeros((R,), dtype=torch.int32, device=dev)
        path = torch.zeros((R, d), dtype=torch.long, device=dev)
        for t in range(d):
            lvl0 = 1 + t * W
            want = o.gather(1, cur[:, None])
            ok = ((parent[:, lvl0:lvl0 + W] == cur[:, None])
                  & (tokens[:, lvl0:lvl0 + W] == want)
                  & (walk & (st["depth_v"] > t))[:, None])
            has = ok.any(dim=1)
            nxt = lvl0 + ok.to(torch.int32).argmax(dim=1)
            path[:, t] = torch.where(has, nxt, 0)
            cur = torch.where(has, nxt, cur)
            n_acc = n_acc + has.to(torch.int32)
            walk = walk & has
        bonus = o.gather(1, cur[:, None])[:, 0]
        # the accepted nodes' KV: cache[r, r_pos+1+i] <- cache[r,
        # r_pos+path[r, i]] for i < n_acc
        commit_tree_kv(llm.op_state, path - 1, n_acc, r_pos + 1, act,
                       mesh=getattr(llm, "mesh", None),
                       seq_len=llm.config.max_sequence_length)
        blk = _next_block(tokens.gather(1, path), n_acc, bonus)
        self._book(st, blk, n_acc)
        self._tree_advance(st, blk, n_acc)
        self._tree_gate(st)

    def _rounds(self, progs, n_rounds):
        for _ in range(n_rounds):
            d_run = _round_depth(progs.st)
            if d_run == 0:
                break
            progs.run("catchup")
            for t in range(1, min(self.depth, d_run)):
                progs.run(f"level{t}")
                self.levels_run += 1
            progs.run("verify")
            self.rounds_run += 1
