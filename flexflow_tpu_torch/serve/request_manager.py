"""RequestManager: continuous batching for incremental decoding
(counterpart of ``flexflow_tpu/serve/request_manager.py``).

The loop is the JAX package's pure-Python scheduler: fill free slots
from the queue, dispatch at most one bounded prefill chunk, then run a
multi-step decode block for every slot whose cache has caught up, and
reconcile EOS/length overshoot on the host.

Slot convention: a request's ``tokens`` are prompt + generated;
``cache_depth`` counts the tokens whose KV is in the cache, and the last
token is always pending (it is fed to produce the next one).

Speculative inference (``generate_spec_infer``) keeps the JAX package's
scheduler loops: the fused chain, tree and beam engines with the
adaptive speculation controller, and the host-stepped tree path (beam
drafts of several draft models merged into one tree, verified, and its
accepted path's KV compacted by ``commit_tree_kv``). Per request,
``ssm_cache_depth[i]`` counts the tokens whose KV is in draft model i's
cache. Speculation is greedy; sampling is a property of an incremental
decoding graph (``GenerationConfig.do_sample``).

Not in this slice: the native C++ scheduler, the shared-prefix cache,
telemetry, admission control, preemption, deadlines and the
``inference_debugging`` per-op dumps.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from flexflow_tpu_torch.ops.inc_attention import commit_tree_kv
from flexflow_tpu_torch.serve.batch_config import (BatchMeta,
                                                   GenerationConfig,
                                                   TreeBatchMeta,
                                                   ancestor_mask_from_parents)
from flexflow_tpu_torch.serve.inference_manager import (VERIFY_WIDTH,
                                                        InferenceManager,
                                                        kernel_serves)

# Reference include/flexflow/batch_config.h:126 (MAX_BEAM_DEPTH)
MAX_SPEC_DEPTH = 8


@dataclasses.dataclass
class Request:
    """One generation request."""

    guid: int
    prompt_tokens: List[int]
    max_new_tokens: int = 128
    max_sequence_length: int = 0          # 0 -> model max_sequence_length
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    cache_depth: int = 0                  # verifier/incr cache depth
    ssm_cache_depth: Dict[int, int] = dataclasses.field(default_factory=dict)
    finished: bool = False
    # time.perf_counter() stamps: admission, slot grant, first token
    arrival_s: float = 0.0
    prefill_start_s: float = 0.0
    first_token_s: float = 0.0
    status: str = "ok"                    # ok | rejected
    error: str = ""

    def __post_init__(self):
        if not self.tokens:
            self.tokens = list(self.prompt_tokens)

    @property
    def num_generated(self) -> int:
        return len(self.tokens) - len(self.prompt_tokens)


@dataclasses.dataclass
class GenerationResult:
    guid: int
    input_tokens: List[int]
    output_tokens: List[int]
    input_text: str = ""
    output_text: str = ""
    # admission -> finish, admission -> first generated token, admission
    # -> slot grant, slot grant -> first generated token
    latency_s: float = 0.0
    ttft_s: float = 0.0
    queue_wait_s: float = 0.0
    prefill_s: float = 0.0
    status: str = "ok"
    error: str = ""


class RequestManager:
    """Continuous-batching scheduler over request slots."""

    _guid_counter = itertools.count(1000000)

    def __init__(self, tokenizer=None, eos_token_id: Optional[int] = None):
        self.tokenizer = tokenizer
        self.eos_token_id = eos_token_id
        self.pending: deque = deque()
        self.results: Dict[int, GenerationResult] = {}
        self.max_spec_depth = MAX_SPEC_DEPTH
        # the host tree path's KV compaction (in place)
        self._commit = commit_tree_kv
        # counts of the last generate_spec_infer call: verify passes
        # ("rounds"), (request, round) pairs that committed tokens and the
        # tokens they committed, and the controller's parks
        self.spec_stats: Dict[str, int] = {}

    def register_tokenizer(self, tokenizer, eos_token_id=None):
        self.tokenizer = tokenizer
        if eos_token_id is None:
            eos_token_id = getattr(tokenizer, "eos_token_id", None)
        self.eos_token_id = eos_token_id

    def register_new_request(self, prompt: Union[str, Sequence[int]],
                             max_new_tokens: int = 128,
                             max_sequence_length: int = 0) -> int:
        if isinstance(prompt, str):
            assert self.tokenizer is not None, "string prompts need a tokenizer"
            toks = list(self.tokenizer.encode(prompt))
        else:
            toks = [int(t) for t in prompt]
        assert toks, "empty prompt"
        guid = next(self._guid_counter)
        self.pending.append(Request(guid=guid, prompt_tokens=toks,
                                    max_new_tokens=max_new_tokens,
                                    max_sequence_length=max_sequence_length,
                                    arrival_s=time.perf_counter()))
        return guid

    # -- scheduling helpers ------------------------------------------------
    def _finish_if_done(self, req: Request, max_seq: int) -> bool:
        limit = min(req.max_sequence_length or max_seq, max_seq)
        if len(req.tokens) > limit:
            req.tokens = req.tokens[:limit]
        if (req.num_generated >= req.max_new_tokens
                or len(req.tokens) >= limit
                or (self.eos_token_id is not None and req.num_generated > 0
                    and req.tokens[-1] == self.eos_token_id)):
            req.finished = True
        return req.finished

    def _collect(self, req: Request) -> GenerationResult:
        out = req.tokens[len(req.prompt_tokens):]
        now = time.perf_counter()
        res = GenerationResult(
            guid=req.guid, input_tokens=list(req.prompt_tokens),
            output_tokens=out,
            latency_s=now - req.arrival_s,
            ttft_s=(req.first_token_s - req.arrival_s)
            if req.first_token_s else 0.0,
            queue_wait_s=(req.prefill_start_s - req.arrival_s)
            if req.prefill_start_s else 0.0,
            prefill_s=(req.first_token_s - req.prefill_start_s)
            if req.first_token_s and req.prefill_start_s else 0.0,
            status=req.status, error=req.error)
        if self.tokenizer is not None:
            try:
                res.input_text = self.tokenizer.decode(res.input_tokens)
                res.output_text = self.tokenizer.decode(out)
            except Exception:
                pass
        self.results[req.guid] = res
        return res

    def _grant(self, req: Request, slot: int, active, max_seq: int,
               done: List[GenerationResult]) -> bool:
        """Place ``req`` in ``slot``; a prompt that can never fit the cache
        is rejected straight to ``done``. True when the slot was taken."""
        limit = min(req.max_sequence_length or max_seq, max_seq)
        if len(req.prompt_tokens) >= limit:
            req.status = "rejected"
            req.error = (f"prompt length {len(req.prompt_tokens)} cannot fit "
                         f"max_sequence_length {limit}")
            req.finished = True
            done.append(self._collect(req))
            return False
        req.slot = slot
        req.prefill_start_s = time.perf_counter()
        active[slot] = req
        return True

    def _fill_slots(self, active: List[Optional[Request]], max_seq: int,
                    done: List[GenerationResult]):
        for slot in range(len(active)):
            while active[slot] is None and self.pending:
                if self._grant(self.pending.popleft(), slot, active, max_seq,
                               done):
                    break

    def _remaining_budget(self, req: Request, max_seq: int) -> int:
        limit = min(req.max_sequence_length or max_seq, max_seq)
        return max(1, min(req.max_new_tokens - req.num_generated,
                          limit - len(req.tokens)))

    @staticmethod
    def _ifm(model) -> InferenceManager:
        """The model's InferenceManager, made at first use."""
        ifm = getattr(model, "_inference_manager", None)
        if ifm is None:
            ifm = model._inference_manager = InferenceManager(model)
        return ifm

    @staticmethod
    def _note_first_token(req: Request):
        if not req.first_token_s and req.num_generated > 0:
            req.first_token_s = time.perf_counter()

    @staticmethod
    def _meta_from_rows(R: int, Q: int, rows) -> BatchMeta:
        """rows: list of (slot, tokens_chunk, start_pos)."""
        tokens = np.zeros((R, Q), np.int32)
        positions = np.zeros((R, Q), np.int32)
        start = np.zeros((R,), np.int32)
        num = np.zeros((R,), np.int32)
        act = np.zeros((R,), bool)
        for slot, chunk, sp in rows:
            n = len(chunk)
            tokens[slot, :n] = chunk
            positions[slot, :n] = np.arange(sp, sp + n)
            start[slot] = sp
            num[slot] = n
            act[slot] = True
        return BatchMeta(tokens=tokens, positions=positions, start_pos=start,
                         num_tokens=num, active=act)

    @staticmethod
    def _prefill_rows(active, chunk: int, depth_of, max_batch_tokens):
        """Slots whose pending tokens exceed 1 -> next chunk each (leaving
        at least one token pending so the decode block emits the next
        token)."""
        rows, budget = [], max_batch_tokens
        for req in active:
            if req is None or req.finished:
                continue
            d = depth_of(req)
            npend = len(req.tokens) - d
            if npend > 1:
                take = min(npend - 1, chunk, budget)
                if take <= 0:
                    continue
                rows.append((req.slot, req.tokens[d:d + take], d))
                budget -= take
        return rows

    # =====================================================================
    # Incremental decoding
    # =====================================================================
    def generate_incr_decoding(self, model,
                               generation_config:
                               Optional[GenerationConfig] = None
                               ) -> List[GenerationResult]:
        """Greedy or sampled as ``model``'s graph was built
        (``GenerationConfig.do_sample`` at graph build time, as in the JAX
        package); ``generation_config`` is accepted for the API's
        symmetry."""
        ifm = self._ifm(model)
        cfg = model.config
        R = cfg.max_requests_per_batch
        max_seq = cfg.max_sequence_length
        chunk = max(1, cfg.max_tokens_per_batch // max(1, min(R, 4)))
        active: List[Optional[Request]] = [None] * R
        done: List[GenerationResult] = []

        while self.pending or any(a is not None for a in active):
            self._fill_slots(active, max_seq, done)
            # decode-interleaved chunked prefill: at most ONE bounded
            # prefill chunk per round, then the decode block for the
            # slots that have caught up
            rows = self._prefill_rows(active, chunk,
                                      lambda r: r.cache_depth,
                                      cfg.max_tokens_per_batch)
            if rows:
                ifm.step(self._meta_from_rows(R, chunk, rows),
                         want_output=False)
                for slot, chunk_toks, sp in rows:
                    active[slot].cache_depth = sp + len(chunk_toks)
            live = [req for req in active
                    if req is not None and not req.finished
                    and req.cache_depth == len(req.tokens) - 1]
            if live:
                block = min(
                    max(self._remaining_budget(req, max_seq) for req in live),
                    cfg.decode_block_steps)
                if rows:
                    # prefill still pending: keep the decode block short
                    # so the next chunk is not starved behind it
                    block = min(block, chunk)
                tok = np.zeros((R,), np.int32)
                pos = np.zeros((R,), np.int32)
                act = np.zeros((R,), bool)
                for req in live:
                    tok[req.slot] = req.tokens[-1]
                    pos[req.slot] = len(req.tokens) - 1
                    act[req.slot] = True
                # never decode past the KV cache end
                block = max(1, min(block,
                                   max_seq - 1 - int(pos[act].max())))
                toks = ifm.decode_block(tok, pos, act, block)
                for req in live:
                    for j in range(block):
                        req.tokens.append(int(toks[req.slot, j]))
                        if self._finish_if_done(req, max_seq):
                            break
                    self._note_first_token(req)
                    req.cache_depth = len(req.tokens) - 1
            self._collect_finished(active, done)
        return done

    # =====================================================================
    # Speculative inference (reference generate_spec_infer)
    # =====================================================================
    def generate_spec_infer(self, llm, ssms: List[Any],
                            spec_depth: Optional[int] = None,
                            beam_width: Optional[int] = None,
                            generation_config:
                            Optional[GenerationConfig] = None
                            ) -> List[GenerationResult]:
        """The LLM verifies the token trees the draft SSMs propose.

        Each round every draft model proposes a depth-``spec_depth`` tree
        per request (a greedy chain at beam width 1, a ``beam_width``-wide
        beam search above it), the LLM scores the tree in one step, and
        the longest root path whose every node matches the LLM's own
        argmax is accepted, plus one bonus token: the output is the LLM's
        greedy continuation, identical to incremental decoding.
        ``generation_config`` carries the adaptive-speculation policy (on
        by default); its ``spec_depth``, when set, overrides the argument.
        Its ``do_sample`` is ignored: speculation is greedy, as in the
        JAX package.

        ``beam_width`` (default: the drafts' compiled ``max_beam_width``)
        must equal every draft's compiled width, which fixes its graph's
        output layout; a mismatch raises ``ValueError``. At width > 1 one
        draft model goes through the fused beam engine and several
        through the host tree path, which merges their beams into one
        tree. At width 1, one draft model speculates through the chain
        engine unless the CUDA attention kernel serves the LLM
        (``kernel_serves``): there the tree engine at B = 1 takes it,
        whose verify pass at depth <= 7 has the incremental decode's
        width, so both give the same tokens (the JAX package's rule with
        its Pallas kernel). Several draft models take the tree engine."""
        gc = generation_config
        if gc is not None and gc.spec_depth:
            spec_depth = gc.spec_depth
        widths = [s.config.max_beam_width for s in ssms]
        W = beam_width or max(widths)
        if any(w != W for w in widths):
            raise ValueError(
                f"beam_width={W} but the draft models were compiled with "
                f"max_beam_width={widths}; rebuild the SSMs with the "
                f"requested width (FFConfig.max_beam_width)")
        if W > 1:
            if len(ssms) == 1:
                return self._generate_spec_chain(
                    llm, ssms[0], spec_depth=spec_depth, beam_width=W,
                    generation_config=gc)
            return self._generate_spec_tree_host(llm, ssms,
                                                 spec_depth=spec_depth,
                                                 beam_width=W)
        if len(ssms) == 1 and not kernel_serves(llm):
            return self._generate_spec_chain(llm, ssms[0],
                                             spec_depth=spec_depth,
                                             generation_config=gc)
        return self._generate_spec_tree_fused(llm, ssms,
                                              spec_depth=spec_depth,
                                              generation_config=gc)

    # -- adaptive speculation support (serve/spec_controller.py) ----------
    @staticmethod
    def _spec_controller(gc: Optional[GenerationConfig], llm, ssms,
                         engine_depth: int, beam_width: int = 1):
        """(the per-request adaptive controller, or None when the policy
        disables it; the resolved GenerationConfig)."""
        gc = gc or GenerationConfig()
        if not gc.adaptive_spec:
            return None, gc
        from flexflow_tpu_torch.serve.spec_controller import SpecController

        return SpecController.from_generation_config(
            gc, llm, ssms, engine_depth=engine_depth,
            beam_width=beam_width), gc

    @staticmethod
    def _partition_spec(ctrl, roomy, rounds):
        """Split the roomy requests into (draftable, parked) by the
        controller, and shrink a tick that only probes parked requests to
        one round. Returns (draftable, parked, rounds)."""
        if ctrl is None:
            return roomy, [], rounds
        draftable = [req for req in roomy if ctrl.wants_draft(req.guid)]
        draft_guids = {req.guid for req in draftable}
        parked = [req for req in roomy if req.guid not in draft_guids]
        if draftable and all(ctrl.in_fallback(r.guid) for r in draftable):
            rounds = 1
        return draftable, parked, rounds

    def _fallback_decode(self, llm_ifm, reqs, R, max_seq, cfg) -> int:
        """Incremental decode block for the requests the controller parked:
        the program generate_incr_decoding drives, so a parked request
        pays the incremental cost and emits the same greedy tokens. Draft
        caches are left stale; the prefill cycle heals them when the
        request probes back into drafting."""
        block = min(max(self._remaining_budget(r, max_seq) for r in reqs),
                    cfg.decode_block_steps)
        tok = np.zeros((R,), np.int32)
        pos = np.zeros((R,), np.int32)
        act = np.zeros((R,), bool)
        for req in reqs:
            tok[req.slot] = req.tokens[-1]
            pos[req.slot] = len(req.tokens) - 1
            act[req.slot] = True
        block = max(1, min(block, max_seq - 1 - int(pos[act].max())))
        toks = llm_ifm.decode_block(tok, pos, act, block)
        for req in reqs:
            for j in range(block):
                req.tokens.append(int(toks[req.slot, j]))
                if self._finish_if_done(req, max_seq):
                    break
            self._note_first_token(req)
            req.cache_depth = len(req.tokens) - 1
        return block

    def _cramped_step(self, llm_ifm, cramped, R, max_seq, n_ssms):
        """One width-1 verifier step for requests whose cache has no room
        for a speculation round; their draft caches fall behind."""
        rows = [(req.slot, req.tokens[-1:], len(req.tokens) - 1)
                for req in cramped]
        out = llm_ifm.step(self._meta_from_rows(R, 1, rows))
        for req in cramped:
            sp = len(req.tokens) - 1
            req.tokens.append(int(out[req.slot, 0]))
            req.cache_depth = sp + 1
            for i in range(n_ssms):
                req.ssm_cache_depth[i] = min(req.ssm_cache_depth.get(i, 0),
                                             sp)
            self._note_first_token(req)
            self._finish_if_done(req, max_seq)

    def _engine_inputs(self, draftable, R, max_seq, ctrl, depth):
        """(tok, pos, active, remaining, depth vector or None) of a block."""
        tok = np.zeros((R,), np.int32)
        pos = np.zeros((R,), np.int32)
        act = np.zeros((R,), bool)
        remaining = np.zeros((R,), np.int32)
        depth_vec = None if ctrl is None else np.full((R,), depth, np.int32)
        for req in draftable:
            tok[req.slot] = req.tokens[-1]
            pos[req.slot] = len(req.tokens) - 1
            act[req.slot] = True
            remaining[req.slot] = self._remaining_budget(req, max_seq)
            if ctrl is not None:
                depth_vec[req.slot] = ctrl.depth_for(req.guid)
        return tok, pos, act, remaining, depth_vec

    def _take_rounds(self, req, rounds, n_acc, d_used, tokens_of, max_seq):
        """Append what ``req`` committed in each round of a block, trimmed
        at its budget and at EOS (where incremental decoding would have
        stopped). ``tokens_of(k, n)`` is round k's committed tokens.
        Returns ([(depth_used, n_acc)] of the rounds it ran, its last
        round's root position)."""
        observed = []
        last_rpos = len(req.tokens) - 1
        for k in range(rounds):
            n = int(n_acc[req.slot, k])
            if n < 0:             # the request drafted nothing this round
                continue
            observed.append((int(d_used[req.slot, k]), n))
            self.spec_stats["request_rounds"] += 1
            self.spec_stats["committed"] += n + 1
            last_rpos = len(req.tokens) - 1
            new_toks = tokens_of(k, n)
            new_toks = new_toks[:max(0, req.max_new_tokens
                                     - req.num_generated)]
            if (self.eos_token_id is not None
                    and self.eos_token_id in new_toks):
                new_toks = new_toks[:new_toks.index(self.eos_token_id) + 1]
            req.tokens.extend(new_toks)
            if self._finish_if_done(req, max_seq):
                break
        self._note_first_token(req)
        return observed, last_rpos

    def _generate_spec_chain(self, llm, ssm,
                             spec_depth: Optional[int] = None,
                             beam_width: int = 1,
                             generation_config:
                             Optional[GenerationConfig] = None
                             ) -> List[GenerationResult]:
        """Single-SSM speculation through ``SpecChainEngine`` at beam
        width 1, ``BeamSpecEngine`` above it (both share the packed
        contract).

        Each engine call runs up to ``spec_rounds_per_call`` rounds; the
        host commits ``a[slot, k, :n_acc + 1]`` per round and reconciles
        EOS and length limits. Every loop turn runs, in order: one bounded
        prefill chunk per model, the cramped requests' single steps, the
        parked requests' incremental block, the draftable requests' block.
        """
        from flexflow_tpu_torch.serve.engine import (BeamSpecEngine,
                                                     SpecChainEngine)

        llm_ifm, ssm_ifm = self._ifm(llm), self._ifm(ssm)
        cfg = llm.config
        R = cfg.max_requests_per_batch
        max_seq = cfg.max_sequence_length
        depth = min(spec_depth or self.max_spec_depth, self.max_spec_depth)
        ctrl, gc = self._spec_controller(generation_config, llm, [ssm],
                                         engine_depth=depth,
                                         beam_width=beam_width)
        # the host gate is at least as strict as the engine's live mask, or
        # a request the engine masks dead every round would be rescheduled
        # forever: the beam engine stages its whole padded tree a round
        if beam_width > 1:
            engine = getattr(llm, "_beam_engine", None)
            if (engine is None or engine.ssm is not ssm
                    or engine.depth != depth or engine.width != beam_width):
                engine = llm._beam_engine = BeamSpecEngine(
                    llm, ssm, depth, beam_width,
                    max_rounds=cfg.spec_rounds_per_call)
            room_needed = engine.tree_width
        else:
            engine = getattr(llm, "_chain_engine", None)
            if (engine is None or engine.ssm is not ssm
                    or engine.depth != depth):
                engine = llm._chain_engine = SpecChainEngine(
                    llm, ssm, depth, max_rounds=cfg.spec_rounds_per_call)
            room_needed = depth + 1
        chunk = max(1, cfg.max_tokens_per_batch // max(1, min(R, 4)))
        active: List[Optional[Request]] = [None] * R
        done: List[GenerationResult] = []
        self.spec_stats = dict.fromkeys(
            ("rounds", "request_rounds", "committed", "parked"), 0)
        rounds0 = engine.rounds_run

        while self.pending or any(a is not None for a in active):
            self._fill_slots(active, max_seq, done)
            # one bounded prefill chunk per model; caught-up slots draft or
            # decode below in the same turn
            prefilled = False
            for ifm, depth_of in ((llm_ifm, lambda r: r.cache_depth),
                                  (ssm_ifm,
                                   lambda r: r.ssm_cache_depth.get(0, 0))):
                rows = self._prefill_rows(active, chunk, depth_of,
                                          cfg.max_tokens_per_batch)
                if ifm is ssm_ifm:
                    # the draft cache catches up only for requests that can
                    # still draft: a full round of room left, and not
                    # parked by the controller
                    rows = [(slot, toks, sp) for slot, toks, sp in rows
                            if max_seq - len(active[slot].tokens) - 1
                            >= room_needed
                            and (ctrl is None
                                 or ctrl.wants_draft(active[slot].guid))]
                if rows:
                    ifm.step(self._meta_from_rows(R, chunk, rows),
                             want_output=False)
                    for slot, toks, sp in rows:
                        if ifm is llm_ifm:
                            active[slot].cache_depth = sp + len(toks)
                        else:
                            active[slot].ssm_cache_depth[0] = sp + len(toks)
                    prefilled = True
            live = [req for req in active
                    if req is not None and not req.finished]
            # only slots whose verifier cache has caught up run this turn
            ready = [req for req in live
                     if req.cache_depth == len(req.tokens) - 1]
            if ready:
                roomy = [req for req in ready
                         if max_seq - len(req.tokens) - 1 >= room_needed]
                cramped = [req for req in ready
                           if max_seq - len(req.tokens) - 1 < room_needed]
                draftable, parked, rounds = self._partition_spec(
                    ctrl, roomy, min(cfg.spec_rounds_per_call,
                                     engine.max_rounds))
                if prefilled:
                    rounds = 1    # prefill pending: back to the next chunk
                # a draft cache still catching up drafts next turn
                draftable = [req for req in draftable
                             if req.ssm_cache_depth.get(0, 0)
                             == len(req.tokens) - 1]
                if cramped:
                    self._cramped_step(llm_ifm, cramped, R, max_seq, 1)
                if parked:
                    self._fallback_decode(llm_ifm, parked, R, max_seq, cfg)
                    for req in parked:
                        ctrl.note_fallback_block(req.guid)
                if draftable:
                    tok, pos, act, remaining, depth_vec = \
                        self._engine_inputs(draftable, R, max_seq, ctrl,
                                            depth)
                    a, n_acc, d_used = engine.run_block(
                        tok, pos, act, rounds, remaining, depth=depth_vec,
                        min_depth=gc.min_spec_depth)
                    for req in draftable:
                        observed, _ = self._take_rounds(
                            req, rounds, n_acc, d_used,
                            lambda k, n, s=req.slot:
                            [int(t) for t in a[s, k, :n + 1]], max_seq)
                        if ctrl is not None:
                            ctrl.observe_block(req.guid, observed)
                        d = len(req.tokens) - 1
                        req.cache_depth = d
                        req.ssm_cache_depth[0] = d
            self._collect_finished(active, done, ctrl)
        self.spec_stats.update(
            rounds=engine.rounds_run - rounds0,
            parked=ctrl.fallback_entries_total if ctrl is not None else 0)
        return done

    def _generate_spec_tree_fused(self, llm, ssms: List[Any],
                                  spec_depth: Optional[int] = None,
                                  generation_config:
                                  Optional[GenerationConfig] = None
                                  ) -> List[GenerationResult]:
        """Tree speculation through ``MultiSpecEngine`` (any number of
        draft models; one on the CUDA path).

        The same loop as ``_generate_spec_chain``, with the differences
        that are real: every draft model prefills, a request drafts only
        with the engine's whole padded tree window of room, and a round's
        committed tokens are ``toks[slot, k, :n_acc]`` plus the bonus at
        ``toks[slot, k, depth]``. A fix to one loop almost certainly
        belongs in the other.
        """
        from flexflow_tpu_torch.serve.engine import MultiSpecEngine

        llm_ifm = self._ifm(llm)
        ssm_ifms = [self._ifm(s) for s in ssms]
        cfg = llm.config
        R = cfg.max_requests_per_batch
        max_seq = cfg.max_sequence_length
        B = len(ssms)
        depth = min(spec_depth or self.max_spec_depth, self.max_spec_depth)
        ctrl, gc = self._spec_controller(generation_config, llm, ssms,
                                         engine_depth=depth)
        engine = getattr(llm, "_multi_engine", None)
        if (engine is None or engine.ssms != list(ssms)
                or engine.depth != depth):
            engine = llm._multi_engine = MultiSpecEngine(
                llm, ssms, depth, max_rounds=cfg.spec_rounds_per_call)
        chunk = max(1, cfg.max_tokens_per_batch // max(1, min(R, 4)))
        active: List[Optional[Request]] = [None] * R
        done: List[GenerationResult] = []
        # a request drafts only with the engine's whole staging window of
        # room: its live mask reserves the padded verify width, and a
        # looser host gate would reschedule a request the engine masks
        # dead every round, forever
        room_needed = engine.tree_width
        self.spec_stats = dict.fromkeys(
            ("rounds", "request_rounds", "committed", "parked"), 0)
        rounds0 = engine.rounds_run

        while self.pending or any(a is not None for a in active):
            self._fill_slots(active, max_seq, done)
            prefilled = False
            rows = self._prefill_rows(active, chunk, lambda r: r.cache_depth,
                                      cfg.max_tokens_per_batch)
            if rows:
                llm_ifm.step(self._meta_from_rows(R, chunk, rows),
                             want_output=False)
                for slot, toks, sp in rows:
                    active[slot].cache_depth = sp + len(toks)
                prefilled = True
            for i, ifm in enumerate(ssm_ifms):
                rows = self._prefill_rows(
                    active, chunk, lambda r, i=i: r.ssm_cache_depth.get(i, 0),
                    cfg.max_tokens_per_batch)
                rows = [(slot, toks, sp) for slot, toks, sp in rows
                        if max_seq - len(active[slot].tokens) >= room_needed
                        and (ctrl is None
                             or ctrl.wants_draft(active[slot].guid))]
                if rows:
                    ifm.step(self._meta_from_rows(R, chunk, rows),
                             want_output=False)
                    for slot, toks, sp in rows:
                        active[slot].ssm_cache_depth[i] = sp + len(toks)
                    prefilled = True
            live = [req for req in active
                    if req is not None and not req.finished]
            ready = [req for req in live
                     if req.cache_depth == len(req.tokens) - 1]
            if not ready:
                continue
            roomy = [req for req in ready
                     if max_seq - len(req.tokens) >= room_needed]
            cramped = [req for req in ready
                       if max_seq - len(req.tokens) < room_needed]
            draftable, parked, rounds = self._partition_spec(
                ctrl, roomy, min(cfg.spec_rounds_per_call, engine.max_rounds))
            if prefilled:
                rounds = 1
            draftable = [req for req in draftable
                         if all(req.ssm_cache_depth.get(i, 0)
                                == len(req.tokens) - 1 for i in range(B))]
            if cramped:
                self._cramped_step(llm_ifm, cramped, R, max_seq, B)
            if parked:
                self._fallback_decode(llm_ifm, parked, R, max_seq, cfg)
                for req in parked:
                    ctrl.note_fallback_block(req.guid)
            if draftable:
                tok, pos, act, remaining, depth_vec = self._engine_inputs(
                    draftable, R, max_seq, ctrl, depth)
                toks, n_acc, d_used = engine.run_block(
                    tok, pos, act, rounds, remaining, depth=depth_vec,
                    min_depth=gc.min_spec_depth)
                for req in draftable:
                    observed, last_rpos = self._take_rounds(
                        req, rounds, n_acc, d_used,
                        lambda k, n, s=req.slot:
                        [int(t) for t in toks[s, k, :n]]
                        + [int(toks[s, k, depth])], max_seq)
                    if ctrl is not None:
                        ctrl.observe_block(req.guid, observed)
                    d = len(req.tokens) - 1
                    # the verifier committed through the last accepted
                    # prefix in-engine; a draft cache is right only through
                    # the last round's catch-up (a losing branch's cache
                    # holds its own chain), and the prefill cycle feeds
                    # the gap
                    req.cache_depth = d
                    for i in range(B):
                        req.ssm_cache_depth[i] = min(last_rpos + 1, d)
            self._collect_finished(active, done, ctrl)
        self.spec_stats.update(
            rounds=engine.rounds_run - rounds0,
            parked=ctrl.fallback_entries_total if ctrl is not None else 0)
        return done

    # =====================================================================
    # The host tree path (beam drafts of several draft models)
    # =====================================================================
    def _generate_spec_tree_host(self, llm, ssms: List[Any],
                                 spec_depth: Optional[int] = None,
                                 beam_width: int = 1
                                 ) -> List[GenerationResult]:
        """Host-stepped tree speculation: per round each draft model
        proposes greedy chains (``_draft_chains``) or ``beam_width``-wide
        beams (``_draft_beams``), the host merges them into one token
        tree per request (shared prefixes dedup), the LLM verifies it in
        one step and the accepted path's KV is compacted
        (``_verify_and_commit``). One dispatch per phase, so slower than
        the fused engines; it is the route for beams of several drafts.
        Static depth; every turn either prefills (all models, then the
        next turn) or runs one round."""
        llm_ifm = self._ifm(llm)
        ssm_ifms = [self._ifm(s) for s in ssms]
        cfg = llm.config
        R = cfg.max_requests_per_batch
        max_seq = cfg.max_sequence_length
        depth = min(spec_depth or self.max_spec_depth, self.max_spec_depth)
        chunk = max(1, cfg.max_tokens_per_batch // max(1, min(R, 4)))
        # tree capacity: root + depth nodes per surviving branch
        T = 1 + depth * len(ssms) * beam_width
        active: List[Optional[Request]] = [None] * R
        done: List[GenerationResult] = []
        self.spec_stats = dict.fromkeys(
            ("rounds", "request_rounds", "committed", "parked"), 0)

        while self.pending or any(a is not None for a in active):
            self._fill_slots(active, max_seq, done)
            prefilled = False
            for ifm, depth_of, setter in (
                    [(llm_ifm, lambda r: r.cache_depth, None)]
                    + [(m, lambda r, i=i: r.ssm_cache_depth.get(i, 0), i)
                       for i, m in enumerate(ssm_ifms)]):
                rows = self._prefill_rows(active, chunk, depth_of,
                                          cfg.max_tokens_per_batch)
                if rows:
                    ifm.step(self._meta_from_rows(R, chunk, rows),
                             want_output=False)
                    for slot, toks, sp in rows:
                        if setter is None:
                            active[slot].cache_depth = sp + len(toks)
                        else:
                            active[slot].ssm_cache_depth[setter] = \
                                sp + len(toks)
                    prefilled = True
            if prefilled:
                continue
            live = [req for req in active
                    if req is not None and not req.finished]
            if live:
                # per branch: slot -> drafted tokens
                chains: List[Dict[int, List[int]]] = []
                for i, ifm in enumerate(ssm_ifms):
                    if beam_width > 1:
                        chains.extend(self._draft_beams(
                            ifm, i, live, R, depth, beam_width))
                    else:
                        chains.append(self._draft_chains(ifm, i, live, R,
                                                         depth))
                trees = {req.slot: self._merge_tree(req, chains, max_seq)
                         for req in live}
                self._verify_and_commit(llm, llm_ifm, live, trees, R, T,
                                        max_seq)
            self._collect_finished(active, done)
        return done

    @staticmethod
    def _merge_tree(req: Request, chains, max_seq: int):
        """One request's drafted chains -> (node tokens, node parents): a
        token tree rooted at the pending token, shared prefixes merged.
        Chains are clamped so tree positions never pass the KV cache end
        or the request's length limit, and the merged tree is capped to
        the cache slots left (parents precede children, so a truncated
        suffix keeps a valid tree)."""
        limit = min(req.max_sequence_length or max_seq, max_seq)
        room = max(0, limit - len(req.tokens) - 1)
        node_tok, node_parent = [req.tokens[-1]], [-1]
        for c in chains:
            cur = 0
            for t in c.get(req.slot, [])[:room]:
                child = next((j for j in range(len(node_tok))
                              if node_parent[j] == cur and node_tok[j] == t),
                             None)
                if child is None:
                    node_tok.append(t)
                    node_parent.append(cur)
                    child = len(node_tok) - 1
                cur = child
        cap = max_seq - (len(req.tokens) - 1)
        return node_tok[:cap], node_parent[:cap]

    def _draft_chains(self, ifm, ssm_idx, live, R, depth):
        """A greedy depth-``depth`` chain per live request on one draft
        model, in one program call (``engine.make_draft_chain``) and one
        readback. The prefill cycle has caught the draft cache up to one
        pending token; it commits that token's KV (+1), and the drafted
        tokens' KV is tentative."""
        from flexflow_tpu_torch.serve.engine import make_draft_chain

        model = ifm.model
        fn = getattr(model, "_draft_chain_fn", None)
        if fn is None or model._draft_chain_depth != depth:
            fn = make_draft_chain(model, ifm._compute_dtype, depth)
            model._draft_chain_fn = fn
            model._draft_chain_depth = depth
        tok = np.zeros((R,), np.int32)
        pos = np.zeros((R,), np.int32)
        act = np.zeros((R,), bool)
        for req in live:
            d = req.ssm_cache_depth.get(ssm_idx, 0)
            assert d == len(req.tokens) - 1, (d, len(req.tokens))
            tok[req.slot] = req.tokens[-1]
            pos[req.slot] = d
            act[req.slot] = True
        dev = model.device
        toks, model.op_state = fn(
            model.params, model.op_state,
            torch.as_tensor(tok, device=dev), torch.as_tensor(pos, device=dev),
            torch.as_tensor(act, device=dev))
        toks = toks.cpu().numpy()
        chains = {}
        for req in live:
            chains[req.slot] = [int(t) for t in toks[req.slot]]
            req.ssm_cache_depth[ssm_idx] = \
                req.ssm_cache_depth.get(ssm_idx, 0) + 1
        return chains

    def _draft_beams(self, ifm, ssm_idx, live, R, depth, width):
        """Beam search of width ``width`` on one draft model; returns
        ``width`` chain dicts (the surviving beam paths, best first, root
        excluded) for tree merging.

        Each step stages the whole beam tree so far as tree nodes on the
        draft (tree attention gives each frontier node its ancestor
        path; no per-beam KV), at a width padded to ``VERIFY_WIDTH``. The
        draft's BEAM_SEARCH_MODE graph emits packed [top-W probs, top-W
        ids] per node; the host keeps the cumulative log-probabilities
        and ranks the W x W candidates by a stable sort (ties to the
        lower (frontier, child) index). Staging near the cache end is
        safe: out-of-range KV writes are dropped, and a garbage proposal
        there fails verification."""
        assert ifm.model.config.max_beam_width == width, \
            (ifm.model.config.max_beam_width, width)
        W = width
        # per slot: node tokens, parents, depths in the tree, cumulative
        # log-probabilities by node, the frontier's nodes, the root's
        # cache position
        nodes, parents, ndepth, scores, frontier, start = (
            {}, {}, {}, {}, {}, {})
        for req in live:
            s = req.slot
            d = req.ssm_cache_depth.get(ssm_idx, 0)
            assert d == len(req.tokens) - 1, (d, len(req.tokens))
            nodes[s], parents[s], ndepth[s] = [req.tokens[-1]], [-1], [0]
            scores[s], frontier[s], start[s] = {0: 0.0}, [0], d
        for _t in range(depth):
            T = -(-max(len(nodes[req.slot]) for req in live)
                  // VERIFY_WIDTH) * VERIFY_WIDTH
            tokens = np.zeros((R, T), np.int32)
            positions = np.zeros((R, T), np.int32)
            parent = np.full((R, T), -1, np.int32)
            sp = np.zeros((R,), np.int32)
            num = np.zeros((R,), np.int32)
            act = np.zeros((R,), bool)
            for req in live:
                s = req.slot
                n = len(nodes[s])
                tokens[s, :n] = nodes[s]
                parent[s, :n] = parents[s]
                positions[s, :n] = start[s] + np.asarray(ndepth[s])
                sp[s], num[s], act[s] = start[s], n, True
            out = ifm.step(TreeBatchMeta(
                tokens=tokens, positions=positions, parent=parent,
                ancestor=ancestor_mask_from_parents(parent), start_pos=sp,
                num_nodes=num, active=act))               # [R, T, 2W]
            probs, ids = out[..., :W], out[..., W:].astype(np.int32)
            for req in live:
                s = req.slot
                cands = []
                for fi in frontier[s]:
                    for j in range(W):
                        p = max(float(probs[s, fi, j]), 1e-20)
                        cands.append((scores[s][fi] + math.log(p),
                                      int(ids[s, fi, j]), fi))
                cands.sort(key=lambda c: -c[0])
                frontier[s] = []
                for sc, tok, fi in cands[:W]:
                    nodes[s].append(tok)
                    parents[s].append(fi)
                    ndepth[s].append(ndepth[s][fi] + 1)
                    scores[s][len(nodes[s]) - 1] = sc
                    frontier[s].append(len(nodes[s]) - 1)
        out_chains: List[Dict[int, List[int]]] = [dict() for _ in range(W)]
        for req in live:
            s = req.slot
            order = sorted(frontier[s], key=lambda i: -scores[s][i])
            for b, leaf in enumerate(order):
                path, cur = [], leaf
                while cur != 0:
                    path.append(nodes[s][cur])
                    cur = parents[s][cur]
                out_chains[b][s] = path[::-1]
            # the first step committed the pending root's KV; the staged
            # nodes beyond it are tentative
            req.ssm_cache_depth[ssm_idx] = start[s] + 1
        return out_chains

    def _verify_and_commit(self, llm, ifm, live, trees, R, T, max_seq):
        """Verify each live request's merged tree in one LLM step (width
        ``T`` padded to ``VERIFY_WIDTH``), accept the longest root path
        whose nodes match the verifier's argmax plus the bonus token, and
        compact the accepted nodes' KV (``self._commit``) where the path
        is not already contiguous."""
        T = -(-T // VERIFY_WIDTH) * VERIFY_WIDTH
        tokens = np.zeros((R, T), np.int32)
        positions = np.zeros((R, T), np.int32)
        parent = np.full((R, T), -1, np.int32)
        start = np.zeros((R,), np.int32)
        num = np.zeros((R,), np.int32)
        act = np.zeros((R,), bool)
        node_depth = np.zeros((R, T), np.int32)
        for req in live:
            ntok, npar = trees[req.slot]
            n = len(ntok)
            sp = len(req.tokens) - 1
            assert req.cache_depth == sp, (req.cache_depth, sp)
            tokens[req.slot, :n] = ntok
            parent[req.slot, :n] = npar
            for j in range(1, n):
                node_depth[req.slot, j] = node_depth[req.slot, npar[j]] + 1
            positions[req.slot, :n] = sp + node_depth[req.slot, :n]
            start[req.slot], num[req.slot], act[req.slot] = sp, n, True
        out = ifm.step(TreeBatchMeta(
            tokens=tokens, positions=positions, parent=parent,
            ancestor=ancestor_mask_from_parents(parent), start_pos=start,
            num_nodes=num, active=act))                   # [R, T] argmax
        self.spec_stats["rounds"] += 1
        src_node = np.zeros((R, self.max_spec_depth + 1), np.int32)
        ncommit = np.zeros((R,), np.int32)
        needs_commit = False
        for req in live:
            ntok, npar = trees[req.slot]
            cur, path = 0, []
            while True:
                want = int(out[req.slot, cur])
                child = next((j for j in range(cur + 1, len(ntok))
                              if npar[j] == cur and ntok[j] == want), None)
                if child is None:
                    break
                path.append(child)
                cur = child
            # the verifier's cache: path nodes must land at start+1..
            if path != list(range(1, len(path) + 1)):
                needs_commit = True
            src_node[req.slot, :len(path)] = [j - 1 for j in path]
            ncommit[req.slot] = len(path)
            self.spec_stats["request_rounds"] += 1
            self.spec_stats["committed"] += len(path) + 1
            # trim at the budget and at EOS, where incremental decoding
            # would have stopped
            new_toks = [ntok[j] for j in path] + [int(out[req.slot, cur])]
            new_toks = new_toks[:max(0, req.max_new_tokens
                                     - req.num_generated)]
            if (self.eos_token_id is not None
                    and self.eos_token_id in new_toks):
                new_toks = new_toks[:new_toks.index(self.eos_token_id) + 1]
            req.tokens.extend(new_toks)
            self._note_first_token(req)
            req.cache_depth = min(start[req.slot] + 1 + len(path),
                                  len(req.tokens) - 1)
            self._finish_if_done(req, max_seq)
        if needs_commit:
            dev = llm.device
            llm.op_state = self._commit(
                llm.op_state, torch.as_tensor(src_node, device=dev),
                torch.as_tensor(ncommit, device=dev),
                torch.as_tensor(start + 1, device=dev),
                torch.as_tensor(act, device=dev))

    def _collect_finished(self, active, done, ctrl=None):
        for slot, req in enumerate(active):
            if req is not None and req.finished:
                if ctrl is not None:
                    ctrl.drop(req.guid)
                done.append(self._collect(req))
                active[slot] = None
