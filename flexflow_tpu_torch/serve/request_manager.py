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

The request lifecycle is the JAX package's: a request may carry a
deadline (``timeout_s`` relative to arrival, or an absolute
``deadline_s``), a tenant and a priority, and may be cancelled from any
thread (``cancel``). Every scheduler loop runs the same seams at the top
of each turn: ``_reap_expired`` resolves expired and cancelled requests
with their partial tokens, ``_fill_slots`` grants free slots by priority
then FIFO and, when every slot is taken, lets a pending request whose
deadline is at risk preempt a lower-priority one (``_maybe_preempt``: the
victim is re-queued and re-prefilled, so its tokens do not change), and
``_prefix_install`` copies a pooled shared prefix's KV into a fresh slot
(serve/prefix_cache.py). Finished prompts are pooled by
``_prefix_store``. Cancellation and deadlines are therefore reaped
between decode blocks and speculation rounds, never inside one.

Telemetry (``flexflow_tpu_torch/telemetry``): every loop resolves
``_tel()`` (an explicit ``telemetry=``, else the process-global one) once
a turn and, when it is on, records admissions, slot grants, preemptions,
prefix lookups and stores, finishes, fenced prefill steps, decode blocks
(whose tokens' readback is the fence) and speculation rounds; the engines
record their own blocks. Telemetry off, every site costs one attribute
read and records nothing, and the prefill steps stay asynchronous.
Telemetry on or off, the tokens are the same.

Incremental decoding has two loops, chosen as in the JAX package.
``FFConfig.use_native_scheduler`` (on by default) runs the native C++
scheduler (``native/scheduler.py`` over ``native/src/
batch_scheduler.cpp``), which owns slot fill, batch assembly and the
EOS/length bookkeeping; the Python loop serves requests with priorities
and the shared-prefix pool (``_needs_host_loop``), and runs when the
native scheduler is off. Where the native scheduler is asked for and its
library cannot build, the port raises (``NativeBuildError``); the JAX
package falls back to its Python loop there. The native loop keeps a
mirror of the C++ slot table (its slot grants follow ``ffs_fill_slots``'s
order: lowest free slot, queue order) with every request's tokens, and
checks it against the C++ state at every batch and every finished
request. The mirror lets the native loop run the Python loop's seams:
``_reap_expired`` at the top of each turn (expired and cancelled
requests leave the C++ table through ``ffs_cancel``), first-token times,
requests that arrive while it runs (they join its batch), and, when a
request that needs the Python loop arrives, the handover of the slot
table to it. Its telemetry is the Python loop's, per-request prefill and
decode spans included (the mirror knows which request holds each slot):
a superset of the JAX native loop's, which records no per-request
spans.

With ``FFConfig.inference_debugging`` every op's inputs, weights and
outputs are dumped per serving step (``utils/debugging.py``): decode and
draft chains run step by step, and speculation goes through the host
tree path except where one draft model takes the chain engine, as in the
JAX package. ``register_output_filepath`` appends each finished
request's text (or tokens) to a file, in the JAX package's format.
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
from flexflow_tpu_torch.serve.batch_config import (MAX_BEAM_DEPTH,
                                                   BatchMeta,
                                                   GenerationConfig,
                                                   TreeBatchMeta,
                                                   ancestor_mask_from_parents)
from flexflow_tpu_torch.serve.graphs import (ProgramCache, ProgramSet,
                                             tensor_key)
from flexflow_tpu_torch.serve.inference_manager import (VERIFY_WIDTH,
                                                        InferenceManager,
                                                        kernel_serves)
from flexflow_tpu_torch.telemetry import get_telemetry, mint_trace_id


class CommitProgram:
    """The host tree path's ``commit_tree_kv`` as a program, as the JAX
    request manager jits it (``flexflow_tpu/serve/request_manager.py``):
    called as ``commit_tree_kv`` is, it copies its inputs into the
    program's device tensors and runs the program of its key (the cache
    tensors' addresses and src_node's shape; every key kept, one build
    each, ``builds``). Captured as a CUDA graph where the caches live on
    one CUDA device and no mesh is given; under a mesh the move runs
    directly (across a ``seq`` axis it reads the host and crosses
    ranks: ``_commit_tree_kv_sharded``)."""

    def __init__(self):
        self._cache = ProgramCache(keep=None)
        self._op_state = None
        self.graph_pool = None

    @property
    def builds(self) -> int:
        return self._cache.builds

    def __call__(self, op_state, src_node, num_commit, start_pos, active,
                 mesh=None, seq_len=None):
        if mesh is not None:
            return commit_tree_kv(op_state, src_node, num_commit, start_pos,
                                  active, mesh=mesh, seq_len=seq_len)
        devs = {t.device for st in op_state.values() if isinstance(st, dict)
                for t in st.values()}
        dev = next(iter(devs))
        capture = len(devs) == 1 and dev.type == "cuda"
        if capture and self.graph_pool is None:
            self.graph_pool = torch.cuda.graph_pool_handle()
        R, C = src_node.shape
        self._op_state = op_state

        def make(cap):
            st = {"src": torch.zeros((R, C), dtype=torch.int32, device=dev),
                  "num": torch.zeros(R, dtype=torch.int32, device=dev),
                  "start": torch.zeros(R, dtype=torch.int32, device=dev),
                  "active": torch.zeros(R, dtype=torch.bool, device=dev)}
            return ProgramSet({"commit": self._stage}, st, cap,
                              pool=self.graph_pool)
        progs = self._cache.get((R, C, tensor_key(op_state)), make, capture)
        for name, v in (("src", src_node), ("num", num_commit),
                        ("start", start_pos), ("active", active)):
            progs.st[name].copy_(torch.as_tensor(v))
        progs.run("commit")
        return op_state

    def _stage(self, st, generator=None):
        commit_tree_kv(self._op_state, st["src"], st["num"], st["start"],
                       st["active"])


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
    # tenant/priority drive admission and slot scheduling; deadline_s is
    # an absolute time.perf_counter() instant (0.0 = none)
    tenant: str = "default"
    priority: int = 0
    deadline_s: float = 0.0
    status: str = "ok"            # ok|timed_out|cancelled|error|rejected
    error: str = ""
    cancel_requested: bool = False
    preemptions: int = 0
    # fleet failover (serve/replica.py): re-dispatches to a surviving
    # replica after an engine crash (the pool re-registers the prompt with
    # the count so far)
    failovers: int = 0
    # fleet-wide correlation id (telemetry.mint_trace_id), minted at the
    # front door; kept across failover re-registration and preemption
    # re-queues, it joins the request's spans across replicas' trace rows
    trace_id: str = ""
    # shared-prefix KV pool: the refcounted entry of the admission-time
    # match (released at _collect), how many leading prompt positions it
    # covers, and whether the lookup ran
    prefix_entry: Any = None
    prefix_len: int = 0
    prefix_hit_tokens: int = 0
    prefix_checked: bool = False

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
    # terminal disposition: "ok", "timed_out" (deadline expired between
    # rounds; output_tokens holds the partial prefix), "cancelled",
    # "error" (the serving loop died; ``error`` says why) or "rejected"
    # (the prompt can never fit). Every registered request gets a result.
    status: str = "ok"
    timed_out: bool = False
    cancelled: bool = False
    error: str = ""
    tenant: str = "default"
    preemptions: int = 0
    # re-dispatches to a surviving replica after a crash (serve/replica.py)
    failovers: int = 0
    # fleet-wide correlation id (see Request.trace_id)
    trace_id: str = ""
    # leading prompt tokens served from the shared-prefix KV pool
    prefix_hit_tokens: int = 0


class RequestManager:
    """Continuous-batching scheduler over request slots."""

    _guid_counter = itertools.count(1000000)

    def __init__(self, tokenizer=None, eos_token_id: Optional[int] = None,
                 telemetry=None):
        self.tokenizer = tokenizer
        self.eos_token_id = eos_token_id
        self.pending: deque = deque()
        self.results: Dict[int, GenerationResult] = {}
        # every registered-but-unfinished request, pending or slotted: the
        # cancel/abort surface (entries removed at _collect)
        self.inflight: Dict[int, Request] = {}
        # deadline-aware preemption: a pending request whose deadline has
        # burned down past preempt_risk of its total budget may evict a
        # strictly-lower-priority running request
        self.preempt_enabled = True
        self.preempt_risk = 0.5
        # the shared-prefix KV pool (serve/prefix_cache.PrefixCache), or
        # None: attached directly or at the first generate call whose
        # GenerationConfig asks for it, and kept across calls
        self.prefix_cache = None
        self.max_spec_depth = MAX_BEAM_DEPTH
        # the host tree path's KV compaction (in place), a program
        self._commit = CommitProgram()
        # counts of the last generate_spec_infer call: verify passes
        # ("rounds"), (request, round) pairs that committed tokens and the
        # tokens they committed, and the controller's parks
        self.spec_stats: Dict[str, int] = {}
        # an explicit ServingTelemetry, or None: the process-global one,
        # resolved once a loop turn (enabling mid-session attaches)
        self.telemetry = telemetry
        # register_output_filepath's per-request log, or None
        self.output_filepath: Optional[str] = None

    def register_output_filepath(self, path: str):
        """Append each finished request's input and output (text where a
        tokenizer is registered, else token ids) to ``path``, truncated
        here, in the JAX package's format."""
        self.output_filepath = path
        open(path, "w").close()

    def _tel(self):
        return self.telemetry if self.telemetry is not None \
            else get_telemetry()

    def register_tokenizer(self, tokenizer, eos_token_id=None):
        self.tokenizer = tokenizer
        if eos_token_id is None:
            eos_token_id = getattr(tokenizer, "eos_token_id", None)
        self.eos_token_id = eos_token_id

    def register_new_request(self, prompt: Union[str, Sequence[int]],
                             max_new_tokens: int = 128,
                             max_sequence_length: int = 0,
                             timeout_s: Optional[float] = None,
                             deadline_s: Optional[float] = None,
                             tenant: str = "default",
                             priority: int = 0,
                             trace_id: Optional[str] = None,
                             failovers: int = 0,
                             preemptions: int = 0) -> int:
        """Register one request. ``timeout_s`` is relative to arrival;
        ``deadline_s`` is an absolute time.perf_counter() instant (wins
        when both are given). An expired request is resolved between
        decode rounds with its partial output (``timed_out=True``).

        ``trace_id`` is the fleet-wide correlation id: the replica pool
        passes the one it minted at its door (a failed-over request keeps
        it across replicas; ``failovers`` and ``preemptions`` carry the
        earlier lives' counts the same way); a lone manager mints its
        own."""
        if isinstance(prompt, str):
            assert self.tokenizer is not None, "string prompts need a tokenizer"
            toks = list(self.tokenizer.encode(prompt))
        else:
            toks = [int(t) for t in prompt]
        assert toks, "empty prompt"
        guid = next(self._guid_counter)
        arrival = time.perf_counter()
        if deadline_s is None and timeout_s is not None:
            deadline_s = arrival + timeout_s
        req = Request(guid=guid, prompt_tokens=toks,
                      max_new_tokens=max_new_tokens,
                      max_sequence_length=max_sequence_length,
                      arrival_s=arrival, tenant=tenant, priority=priority,
                      deadline_s=deadline_s or 0.0,
                      trace_id=trace_id or mint_trace_id(),
                      failovers=int(failovers),
                      preemptions=int(preemptions))
        if self.prefix_cache is not None:
            # the radix lookup and its refcount happen at admission, so
            # eviction before the slot grant cannot pull the segment away
            self._prefix_match(req)
        self.pending.append(req)
        self.inflight[guid] = req
        tel = self._tel()
        if tel is not None:
            tel.note_admission(guid, len(toks), max_new_tokens,
                               trace_id=req.trace_id)
        return guid

    def cancel(self, guid: int) -> bool:
        """Ask for a request's cancellation. Safe from any thread: it only
        sets a flag, which the serving loop reaps at its next
        between-rounds seam on every scheduler path. False when the guid
        is unknown or already finished."""
        req = self.inflight.get(guid)
        if req is None or req.finished:
            return False
        req.cancel_requested = True
        return True

    def abort_outstanding(self, error: BaseException
                          ) -> List[GenerationResult]:
        """Fail every registered-but-unfinished request with ``error``
        (status "error", partial tokens kept). Called when the serving
        loop dies, so that no submitter waits on a result that will never
        come; leaves the manager clean for a server restart."""
        self.pending.clear()
        out = []
        for req in list(self.inflight.values()):
            if req.finished:
                continue
            req.status = "error"
            req.error = f"{type(error).__name__}: {error}"
            req.finished = True
            req.slot = -1
            out.append(self._collect(req))
        return out

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
        if req.prefix_entry is not None and self.prefix_cache is not None:
            # drop the pool reference taken at admission (every terminal
            # path goes through here, so no handle leaks)
            self.prefix_cache.release(req.prefix_entry)
            req.prefix_entry = None
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
            status=req.status, timed_out=req.status == "timed_out",
            cancelled=req.status == "cancelled", error=req.error,
            tenant=req.tenant, preemptions=req.preemptions,
            failovers=req.failovers, trace_id=req.trace_id,
            prefix_hit_tokens=req.prefix_hit_tokens)
        self.inflight.pop(req.guid, None)
        tel = self._tel()
        if tel is not None:
            tel.note_finish(req.guid, len(out), res.latency_s, res.ttft_s,
                            queue_wait_s=res.queue_wait_s,
                            prefill_s=res.prefill_s, status=req.status,
                            failovers=req.failovers,
                            preemptions=req.preemptions)
        if self.tokenizer is not None:
            try:
                res.input_text = self.tokenizer.decode(res.input_tokens)
                res.output_text = self.tokenizer.decode(out)
            except Exception:
                pass
        self.results[req.guid] = res
        if self.output_filepath:
            with open(self.output_filepath, "a") as f:
                f.write(f"guid({res.guid})\n"
                        f"input: {res.input_text or res.input_tokens}\n"
                        f"output: {res.output_text or res.output_tokens}\n")
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
        tel = self._tel()
        if tel is not None:
            tel.note_slot_grant(req.guid, slot)
        return True

    def _next_pending(self) -> Optional[Request]:
        """Dequeue the next request to grant a slot: highest priority
        first, FIFO within a priority class. Submitter threads append to
        ``pending`` while the loop runs, so it is read through a snapshot
        (taking ``list`` of a deque runs without a thread switch)."""
        queue = list(self.pending)
        if not queue:
            return None
        best = queue[0]
        for r in queue:
            if r.priority > best.priority:
                best = r
        self.pending.remove(best)
        return best

    def _fill_slots(self, active: List[Optional[Request]], max_seq: int,
                    done: List[GenerationResult], parked=()):
        for slot in range(len(active)):
            while active[slot] is None and self.pending:
                if self._grant(self._next_pending(), slot, active, max_seq,
                               done):
                    break
        if self.pending and self.preempt_enabled:
            # every slot taken and requests still waiting: deadline-aware
            # preemption may evict a lower-priority victim
            self._maybe_preempt(active, max_seq, done, parked)

    def _maybe_preempt(self, active, max_seq: int,
                       done: List[GenerationResult], parked=()):
        """At the slot-grant seam: if a pending request's deadline is at
        risk (more than ``preempt_risk`` of its budget already burned
        waiting), evict a strictly-lower-priority running request,
        preferring one the speculation controller parked (``parked``:
        guids), then the fewest generated tokens (the cheapest
        re-prefill). The victim is re-queued, not killed: its prompt and
        generated tokens are prefilled again at its next grant, so its
        final tokens are the same (greedy decoding depends only on the
        token prefix)."""
        now = time.perf_counter()
        while self.pending:
            cand = None
            for r in list(self.pending):
                if r.deadline_s <= 0 or r.cancel_requested:
                    continue
                total = max(r.deadline_s - r.arrival_s, 1e-9)
                if (r.deadline_s - now) > self.preempt_risk * total:
                    continue
                if cand is None or r.priority > cand.priority:
                    cand = r
            if cand is None:
                return
            victims = [r for r in active
                       if r is not None and not r.finished
                       and r.priority < cand.priority]
            if not victims:
                return
            victim = min(victims, key=lambda r: (r.guid not in parked,
                                                 r.priority,
                                                 r.num_generated))
            slot = victim.slot
            victim.slot = -1
            victim.cache_depth = 0
            victim.ssm_cache_depth.clear()
            victim.preemptions += 1
            victim.prefill_start_s = 0.0
            active[slot] = None
            self.pending.remove(cand)
            self.pending.append(victim)
            tel = self._tel()
            if tel is not None:
                tel.note_preempted(victim.guid)
            self._grant(cand, slot, active, max_seq, done)

    def _reap_expired(self, active, max_seq: int,
                      done: List[GenerationResult], ctrl=None):
        """The between-rounds timeout/cancel seam: resolve every pending or
        slotted request whose deadline expired or whose host asked for
        its cancellation (slot freed, partial result collected with the
        matching status). Runs at the top of every scheduler-loop turn on
        every path."""
        now = time.perf_counter()

        def expired(r):
            return r.cancel_requested or (r.deadline_s
                                          and now >= r.deadline_s)

        def resolve(r):
            r.status = "cancelled" if r.cancel_requested else "timed_out"
            r.finished = True
            done.append(self._collect(r))

        for req in [r for r in list(self.pending) if expired(r)]:
            self.pending.remove(req)
            resolve(req)
        for slot, req in enumerate(active):
            if req is not None and not req.finished and expired(req):
                if ctrl is not None:
                    ctrl.drop(req.guid)
                resolve(req)
                active[slot] = None

    def _remaining_budget(self, req: Request, max_seq: int) -> int:
        limit = min(req.max_sequence_length or max_seq, max_seq)
        return max(1, min(req.max_new_tokens - req.num_generated,
                          limit - len(req.tokens)))

    # -- shared-prefix KV pool (serve/prefix_cache.py) --------------------
    def _resolve_prefix_cache(self, gc: Optional[GenerationConfig],
                              model=None):
        """Attach the pool when the generation config asks for it (requests
        registered before that are matched at their slot grant). Under
        parallel serving each rank pools its share of the caches, on a
        logical clock and with byte figures agreed over the ranks, so
        that every rank takes the same decisions (serve/prefix_cache.py)."""
        if (gc is not None and gc.prefix_cache
                and self.prefix_cache is None):
            from flexflow_tpu_torch.serve.prefix_cache import PrefixCache

            kw = {}
            mesh = getattr(model, "mesh", None)
            if mesh is not None and mesh.size > 1:
                kw = dict(clock=itertools.count().__next__,
                          reduce=_world_reducer(model.device))
            self.prefix_cache = PrefixCache(
                max_tokens=gc.prefix_cache_tokens, **kw)

    def _prefix_match(self, req: Request):
        """Longest-prefix radix lookup for one request (admission time, or
        grant time for requests admitted before the pool existed)."""
        pc = self.prefix_cache
        req.prefix_checked = True
        if pc is None:
            return
        shared, entry = pc.match(req.prompt_tokens)
        if entry is not None:
            req.prefix_entry = entry
            req.prefix_len = shared
            req.prefix_hit_tokens = shared
        tel = self._tel()
        if tel is not None:
            tel.note_prefix_lookup(shared, pc.pool_tokens)

    def _prefix_install(self, active, pairs):
        """Grant-time KV install: a slotted request holding a pool handle
        with an empty cache (a fresh grant, or a preemption re-queue that
        reset ``cache_depth``) gets the shared positions copied into its
        slot's caches in place, and its depths advanced past them: those
        prefill tokens are skipped. ``pairs`` is the loop's ordered
        [("llm", ifm), ("ssm0", ifm), ...]; a model whose cache does not
        take the stored segment prefills the prefix itself."""
        pc = self.prefix_cache
        if pc is None:
            return
        from flexflow_tpu_torch.serve import prefix_cache as pcm

        for req in active:
            if req is None or req.finished or req.slot < 0:
                continue
            if not req.prefix_checked:
                self._prefix_match(req)
            entry = req.prefix_entry
            if entry is None or req.cache_depth != 0:
                continue
            n = min(req.prefix_len, len(req.tokens) - 1)
            if n <= 0:
                continue
            for key, ifm in pairs:
                segs = entry.segments.get(key)
                rows = pcm.rank_rows(ifm.model)
                if segs is None or not pcm.prefix_compatible(
                        ifm.model.op_state, segs, n, rows):
                    continue
                pcm.install_prefix_kv(ifm.model.op_state, req.slot, segs, n,
                                      rows)
                if key == "llm":
                    req.cache_depth = n
                else:
                    req.ssm_cache_depth[int(key[3:])] = n

    def _prefix_store(self, req: Request, pairs):
        """Insert-on-finish: pool the finished request's prompt KV from its
        still-intact slot (called before the slot is cleared). A model
        whose cache never covered the whole prompt (a draft the
        controller parked) is left out; a later reuse prefills it."""
        pc = self.prefix_cache
        if pc is None or req.slot < 0 or req.status != "ok":
            return
        prompt = req.prompt_tokens
        if req.cache_depth < len(prompt) or not pc.would_store(prompt):
            return
        from flexflow_tpu_torch.serve import prefix_cache as pcm

        segments = {}
        for key, ifm in pairs:
            depth = (req.cache_depth if key == "llm"
                     else req.ssm_cache_depth.get(int(key[3:]), 0))
            if depth < len(prompt):
                continue
            segs = pcm.extract_prefix_kv(ifm.model.op_state, req.slot,
                                         len(prompt),
                                         pcm.rank_rows(ifm.model))
            if segs is not None:
                segments[key] = segs
        if "llm" not in segments:
            return
        _entry, evicted = pc.insert(prompt, segments)
        tel = self._tel()
        if tel is not None:
            tel.note_prefix_store(evicted, pc.pool_tokens)

    @staticmethod
    def _ifm(model) -> InferenceManager:
        """The model's InferenceManager, made at first use."""
        ifm = getattr(model, "_inference_manager", None)
        if ifm is None:
            ifm = model._inference_manager = InferenceManager(model)
        return ifm

    # -- telemetry hooks (all no-ops when telemetry is disabled) -----------
    @staticmethod
    def _note_first_token(req: Request):
        if not req.first_token_s and req.num_generated > 0:
            req.first_token_s = time.perf_counter()

    def _timed_prefill(self, ifm, meta, tel, rows, active):
        """One prefill step, wall-clocked when telemetry is on. Its outputs
        stay on the device (the KV lands in the caches in place), so honest
        timing needs an explicit fence (``utils/profiling.device_fence`` on
        the model's caches). The fence runs only with telemetry on; off,
        the step stays asynchronous. ``rows``/``active`` feed the
        per-request prefill spans."""
        if tel is None:
            ifm.step(meta, want_output=False)
            return
        from flexflow_tpu_torch.utils.profiling import device_fence

        t0 = time.perf_counter()
        ifm.step(meta, want_output=False)
        device_fence(ifm.model.op_state)
        tel.record_prefill(time.perf_counter() - t0,
                           sum(len(chunk) for _, chunk, _ in rows),
                           [(active[slot].guid, sp, len(chunk))
                            for slot, chunk, sp in rows])

    def _tel_tick(self, tel, live, slots: int, max_seq: int):
        """Once per scheduling tick that dispatches decode or speculation
        work: queue depth, batch occupancy, KV-cache utilization."""
        if tel is None:
            return
        kv = (sum(len(r.tokens) for r in live)
              / (len(live) * max_seq)) if live else None
        tel.note_batch(len(self.pending), len(live), slots, kv)

    def _timed_decode(self, ifm, tel, live, tok, pos, act, block):
        """One decode block; with telemetry on, its wall time (the tokens'
        readback is the fence) and per-request spans."""
        if tel is None:
            return ifm.decode_block(tok, pos, act, block)
        t0 = time.perf_counter()
        toks = ifm.decode_block(tok, pos, act, block)
        tel.record_decode_block(time.perf_counter() - t0, block, len(live),
                                [r.guid for r in live])
        return toks

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
        symmetry, and attaches the prefix pool when it asks for one. On
        the native loop when ``use_native_scheduler`` is on and no
        request needs the Python loop, else on the Python loop."""
        ifm = self._ifm(model)
        cfg = model.config
        self._resolve_prefix_cache(generation_config, model)
        active: List[Optional[Request]] = [None] * cfg.max_requests_per_batch
        done: List[GenerationResult] = []
        if getattr(cfg, "use_native_scheduler", True):
            # asked for: a library that cannot build raises here, before
            # any request leaves the queue
            from flexflow_tpu_torch.native.scheduler import \
                NativeBatchScheduler

            sched = NativeBatchScheduler(cfg.max_requests_per_batch,
                                         cfg.max_sequence_length,
                                         self.eos_token_id)
            self._native_sched = sched
            try:
                if not self._generate_incr_native(ifm, cfg, sched, active,
                                                  done):
                    return done
            finally:
                self._native_sched = None
        return self._generate_incr_python(ifm, cfg, active, done)

    def native_shadow_empty(self) -> bool:
        """True when the native scheduler holds no requests (always true
        outside a native-loop generation)."""
        sched = getattr(self, "_native_sched", None)
        return sched is None or not sched.has_work()

    def _needs_host_loop(self) -> bool:
        """Priorities need the Python loop's preemption and the prefix
        pool its decode-interleaved prefill: the native scheduler has
        neither."""
        return self.prefix_cache is not None or any(
            r.priority for r in list(self.pending))

    def _generate_incr_python(self, ifm, cfg, active, done
                              ) -> List[GenerationResult]:
        """The Python loop, from the slot table ``active`` (empty, or
        handed over by the native loop)."""
        R = cfg.max_requests_per_batch
        max_seq = cfg.max_sequence_length
        chunk = max(1, cfg.max_tokens_per_batch // max(1, min(R, 4)))
        pairs = (("llm", ifm),)

        while self.pending or any(a is not None for a in active):
            tel = self._tel()
            self._reap_expired(active, max_seq, done)
            self._fill_slots(active, max_seq, done)
            self._prefix_install(active, pairs)
            # decode-interleaved chunked prefill: at most ONE bounded
            # prefill chunk per round, then the decode block for the
            # slots that have caught up
            rows = self._prefill_rows(active, chunk,
                                      lambda r: r.cache_depth,
                                      cfg.max_tokens_per_batch)
            if rows:
                self._timed_prefill(ifm, self._meta_from_rows(R, chunk, rows),
                                    tel, rows, active)
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
                self._tel_tick(tel, live, R, max_seq)
                toks = self._timed_decode(ifm, tel, live, tok, pos, act,
                                          block)
                self._take_block(live, toks, block, max_seq)
            self._collect_finished(active, done, pairs=pairs)
        return done

    def _take_block(self, live, toks, block: int, max_seq: int):
        """Append each live request's tokens of a decode block up to its
        EOS or length limit (the host-side reconciliation of overshoot)."""
        for req in live:
            for j in range(block):
                req.tokens.append(int(toks[req.slot, j]))
                if self._finish_if_done(req, max_seq):
                    break
            self._note_first_token(req)
            req.cache_depth = len(req.tokens) - 1

    def _generate_incr_native(self, ifm, cfg, sched, active, done) -> bool:
        """Incremental decoding with the native scheduler owning slot fill,
        batch assembly and the EOS/length bookkeeping (the JAX package's
        ``_generate_incr_native``). A turn whose prefill chunk leaves no
        prompt mid-prefill also decodes, in a block no longer than the
        chunk, as the Python loop does (the JAX package's native loop
        decodes only in turns without prefill); so both loops run the same
        blocks. ``active`` mirrors the C++ slot table;
        every disagreement between the two raises. Returns True when a
        request that needs the Python loop arrived: ``active`` is then the
        live slot table to continue from (the KV caches stay valid, the
        slots being the same)."""
        R = cfg.max_requests_per_batch
        max_seq = cfg.max_sequence_length
        chunk = max(1, cfg.max_tokens_per_batch // max(1, min(R, 4)))

        def mismatch(what):
            raise RuntimeError(f"native scheduler and its slot mirror "
                               f"disagree: {what}")

        def drain():
            while True:
                popped = sched.pop_done()
                if popped is None:
                    return
                guid, tokens, _plen = popped
                if guid in self.results:
                    continue    # resolved on the host: rejected or reaped
                slot = next((s for s, r in enumerate(active)
                             if r is not None and r.guid == guid), None)
                if slot is None or active[slot].tokens != tokens:
                    mismatch(f"request {guid} finished with {tokens}")
                done.append(self._collect(active[slot]))
                active[slot] = None
            if any(r is not None and r.finished for r in active):
                mismatch("a finished request is still slotted")

        while self.pending or sched.has_work():
            if self._needs_host_loop():
                return True
            tel = self._tel()
            # the between-rounds seam: expired and cancelled requests are
            # resolved on the host and taken out of the C++ table
            slotted = {r.guid for r in active if r is not None}
            self._reap_expired(active, max_seq, done)
            for guid in slotted - {r.guid for r in active if r is not None}:
                if not sched.cancel(guid):
                    mismatch(f"request {guid} could not be cancelled")
            # slot grants in ffs_fill_slots's order: the lowest free slot,
            # the queue's order; a prompt that can never fit is rejected
            for slot in range(R):
                while active[slot] is None and self.pending:
                    req = self.pending.popleft()
                    sched.add_request(req.guid, req.prompt_tokens,
                                      req.max_new_tokens,
                                      req.max_sequence_length)
                    placed = sched.fill_slots()
                    if placed != int(self._grant(req, slot, active, max_seq,
                                                 done)):
                        mismatch(f"slot grant of request {req.guid}")
            drain()
            rows, tokens, positions, start, num, act = \
                sched.assemble_prefill(chunk, cfg.max_tokens_per_batch, chunk)
            if rows:
                prows = []
                for slot in np.flatnonzero(act):
                    req, sp, n = active[slot], int(start[slot]), int(num[slot])
                    if (req is None or req.cache_depth != sp or req.tokens[
                            sp:sp + n] != tokens[slot, :n].tolist()):
                        mismatch(f"prefill of slot {slot}")
                    prows.append((slot, req.tokens[sp:sp + n], sp))
                    req.cache_depth = sp + n
                meta = BatchMeta(tokens=tokens, positions=positions,
                                 start_pos=start, num_tokens=num,
                                 active=act)
                self._timed_prefill(ifm, meta, tel, prows, active)
                if any(r is not None and r.cache_depth < len(r.tokens) - 1
                       for r in active):
                    # a prompt is still mid-prefill, and the C++ decode
                    # batch takes every slotted request: prefill first
                    continue
            n_live, tok, pos, act = sched.assemble_decode()
            if n_live:
                live = [active[s] for s in np.flatnonzero(act)]
                if any(r is None or r.tokens[-1] != tok[r.slot]
                       or len(r.tokens) - 1 != pos[r.slot] for r in live):
                    mismatch("decode batch")
                # the Python loop's blocks: short behind a prefill chunk,
                # so that the next chunk (or a reap) is not starved
                block = sched.decode_block(
                    min(cfg.decode_block_steps, chunk) if rows
                    else cfg.decode_block_steps)
                self._tel_tick(tel, live, R, max_seq)
                toks = self._timed_decode(ifm, tel, live, tok, pos, act,
                                          block)
                toks = np.asarray(toks)[:, :block]
                sched.append_block(toks)
                self._take_block(live, toks, block, max_seq)
            drain()
        return False

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
        self._resolve_prefix_cache(gc, llm)
        if gc is not None and gc.spec_depth:
            spec_depth = gc.spec_depth
        widths = [s.config.max_beam_width for s in ssms]
        W = beam_width or max(widths)
        if any(w != W for w in widths):
            raise ValueError(
                f"beam_width={W} but the draft models were compiled with "
                f"max_beam_width={widths}; rebuild the SSMs with the "
                f"requested width (FFConfig.max_beam_width)")
        debugging = llm.config.inference_debugging
        if W > 1:
            if len(ssms) == 1 and not debugging:
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
        if not debugging:
            return self._generate_spec_tree_fused(llm, ssms,
                                                  spec_depth=spec_depth,
                                                  generation_config=gc)
        # per-op dumps need the host-stepped tree path
        return self._generate_spec_tree_host(llm, ssms,
                                             spec_depth=spec_depth,
                                             beam_width=1)

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
    def _tick_controller(ctrl, tel, live):
        if ctrl is None or tel is None:
            return
        stats = ctrl.live_stats(r.guid for r in live)
        tel.note_spec_controller(stats["ewma_mean"], stats["n_fallback"],
                                 ctrl.take_new_fallbacks())

    def _partition_spec(self, ctrl, tel, live, roomy, rounds):
        """Split the roomy requests into (draftable, parked) by the
        controller (feeding its telemetry gauges), and shrink a tick that
        only probes parked requests to one round. Returns (draftable,
        parked, rounds)."""
        self._tick_controller(ctrl, tel, live)
        if ctrl is None:
            return roomy, [], rounds
        draftable = [req for req in roomy if ctrl.wants_draft(req.guid)]
        draft_guids = {req.guid for req in draftable}
        parked = [req for req in roomy if req.guid not in draft_guids]
        if draftable and all(ctrl.in_fallback(r.guid) for r in draftable):
            rounds = 1
        return draftable, parked, rounds

    def _fallback_decode(self, llm_ifm, reqs, R, max_seq, cfg, tel) -> int:
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
        self._tel_tick(tel, reqs, R, max_seq)
        toks = self._timed_decode(llm_ifm, tel, reqs, tok, pos, act, block)
        self._take_block(reqs, toks, block, max_seq)
        return block

    def _cramped_step(self, llm_ifm, cramped, R, max_seq, n_ssms, tel):
        """One width-1 verifier step for requests whose cache has no room
        for a speculation round; their draft caches fall behind."""
        rows = [(req.slot, req.tokens[-1:], len(req.tokens) - 1)
                for req in cramped]
        t0 = time.perf_counter()
        out = llm_ifm.step(self._meta_from_rows(R, 1, rows))
        if tel is not None:       # the step's readback is the fence
            tel.record_decode_block(time.perf_counter() - t0, 1,
                                    len(cramped),
                                    [req.guid for req in cramped])
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
        round's root position, [(round, n_acc, tokens committed)] for the
        round spans)."""
        observed, events = [], []
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
            events.append((k, n, len(new_toks)))
            if self._finish_if_done(req, max_seq):
                break
        self._note_first_token(req)
        return observed, last_rpos, events

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
        pairs = (("llm", llm_ifm), ("ssm0", ssm_ifm))

        while self.pending or any(a is not None for a in active):
            tel = self._tel()
            self._reap_expired(active, max_seq, done, ctrl)
            self._fill_slots(active, max_seq, done, self._parked(ctrl, active))
            self._prefix_install(active, pairs)
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
                    self._timed_prefill(
                        ifm, self._meta_from_rows(R, chunk, rows), tel, rows,
                        active)
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
                    ctrl, tel, live, roomy, min(cfg.spec_rounds_per_call,
                                                engine.max_rounds))
                if prefilled:
                    rounds = 1    # prefill pending: back to the next chunk
                # a draft cache still catching up drafts next turn
                draftable = [req for req in draftable
                             if req.ssm_cache_depth.get(0, 0)
                             == len(req.tokens) - 1]
                if cramped:
                    self._cramped_step(llm_ifm, cramped, R, max_seq, 1, tel)
                if parked:
                    self._fallback_decode(llm_ifm, parked, R, max_seq, cfg,
                                          tel)
                    for req in parked:
                        ctrl.note_fallback_block(req.guid)
                if draftable:
                    tok, pos, act, remaining, depth_vec = \
                        self._engine_inputs(draftable, R, max_seq, ctrl,
                                            depth)
                    self._tel_tick(tel, draftable, R, max_seq)
                    # engines are cached on the llm across managers: hand
                    # THIS manager's explicit telemetry through (None keeps
                    # the engine on the process-global one)
                    engine.telemetry = self.telemetry
                    t0 = time.perf_counter()
                    a, n_acc, d_used = engine.run_block(
                        tok, pos, act, rounds, remaining, depth=depth_vec,
                        min_depth=gc.min_spec_depth)
                    block_dt = time.perf_counter() - t0
                    for req in draftable:
                        observed, _, events = self._take_rounds(
                            req, rounds, n_acc, d_used,
                            lambda k, n, s=req.slot:
                            [int(t) for t in a[s, k, :n + 1]], max_seq)
                        if ctrl is not None:
                            ctrl.observe_block(req.guid, observed)
                        if tel is not None and events:
                            tel.trace_rounds(req.guid, events, t0, block_dt,
                                             rounds)
                        d = len(req.tokens) - 1
                        req.cache_depth = d
                        req.ssm_cache_depth[0] = d
            self._collect_finished(active, done, ctrl, pairs)
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
        pairs = (("llm", llm_ifm),
                 *((f"ssm{i}", m) for i, m in enumerate(ssm_ifms)))

        while self.pending or any(a is not None for a in active):
            tel = self._tel()
            self._reap_expired(active, max_seq, done, ctrl)
            self._fill_slots(active, max_seq, done, self._parked(ctrl, active))
            self._prefix_install(active, pairs)
            prefilled = False
            rows = self._prefill_rows(active, chunk, lambda r: r.cache_depth,
                                      cfg.max_tokens_per_batch)
            if rows:
                self._timed_prefill(llm_ifm,
                                    self._meta_from_rows(R, chunk, rows), tel,
                                    rows, active)
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
                    self._timed_prefill(
                        ifm, self._meta_from_rows(R, chunk, rows), tel, rows,
                        active)
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
                ctrl, tel, live, roomy,
                min(cfg.spec_rounds_per_call, engine.max_rounds))
            if prefilled:
                rounds = 1
            draftable = [req for req in draftable
                         if all(req.ssm_cache_depth.get(i, 0)
                                == len(req.tokens) - 1 for i in range(B))]
            if cramped:
                self._cramped_step(llm_ifm, cramped, R, max_seq, B, tel)
            if parked:
                self._fallback_decode(llm_ifm, parked, R, max_seq, cfg, tel)
                for req in parked:
                    ctrl.note_fallback_block(req.guid)
            if draftable:
                tok, pos, act, remaining, depth_vec = self._engine_inputs(
                    draftable, R, max_seq, ctrl, depth)
                self._tel_tick(tel, draftable, R, max_seq)
                engine.telemetry = self.telemetry   # see the chain loop
                t0 = time.perf_counter()
                toks, n_acc, d_used = engine.run_block(
                    tok, pos, act, rounds, remaining, depth=depth_vec,
                    min_depth=gc.min_spec_depth)
                block_dt = time.perf_counter() - t0
                for req in draftable:
                    observed, last_rpos, events = self._take_rounds(
                        req, rounds, n_acc, d_used,
                        lambda k, n, s=req.slot:
                        [int(t) for t in toks[s, k, :n]]
                        + [int(toks[s, k, depth])], max_seq)
                    if ctrl is not None:
                        ctrl.observe_block(req.guid, observed)
                    if tel is not None and events:
                        tel.trace_rounds(req.guid, events, t0, block_dt,
                                         rounds)
                    d = len(req.tokens) - 1
                    # the verifier committed through the last accepted
                    # prefix in-engine; a draft cache is right only through
                    # the last round's catch-up (a losing branch's cache
                    # holds its own chain), and the prefill cycle feeds
                    # the gap
                    req.cache_depth = d
                    for i in range(B):
                        req.ssm_cache_depth[i] = min(last_rpos + 1, d)
            self._collect_finished(active, done, ctrl, pairs)
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
            tel = self._tel()
            self._reap_expired(active, max_seq, done)
            self._fill_slots(active, max_seq, done)
            prefilled = False
            for ifm, depth_of, setter in (
                    [(llm_ifm, lambda r: r.cache_depth, None)]
                    + [(m, lambda r, i=i: r.ssm_cache_depth.get(i, 0), i)
                       for i, m in enumerate(ssm_ifms)]):
                rows = self._prefill_rows(active, chunk, depth_of,
                                          cfg.max_tokens_per_batch)
                if rows:
                    self._timed_prefill(
                        ifm, self._meta_from_rows(R, chunk, rows), tel, rows,
                        active)
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
                self._tel_tick(tel, live, R, max_seq)
                if tel is not None:
                    tel.draft_depth.set(depth)
                    tel.tree_width.set(T)
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
                                        max_seq, tel)
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
        if model.config.inference_debugging:
            return self._draft_chains_debug(ifm, ssm_idx, live, R, depth)
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

    def _draft_chains_debug(self, ifm, ssm_idx, live, R, depth):
        """The draft chains one ``InferenceManager.step`` a token, so that
        ``inference_debugging`` dumps every drafted token's ops (the JAX
        package's ``_draft_chains_debug``); the same tokens and cache
        depths as ``_draft_chains``."""
        rows = [(req.slot, req.tokens[-1:], req.ssm_cache_depth.get(ssm_idx,
                                                                    0))
                for req in live]
        chains = {req.slot: [] for req in live}
        for i in range(depth):
            out = ifm.step(self._meta_from_rows(R, 1, rows))
            rows = [(slot, [int(out[slot, 0])], d + 1)
                    for slot, _tok, d in rows]
            for slot, tok, _d in rows:
                chains[slot].append(tok[0])
        for req in live:
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

    def _verify_and_commit(self, llm, ifm, live, trees, R, T, max_seq,
                           tel=None):
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
        t0 = time.perf_counter()
        out = ifm.step(TreeBatchMeta(
            tokens=tokens, positions=positions, parent=parent,
            ancestor=ancestor_mask_from_parents(parent), start_pos=start,
            num_nodes=num, active=act))                   # [R, T] argmax
        if tel is not None:           # the step's readback is the fence
            tel.spec_block_seconds.observe(time.perf_counter() - t0)
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
            if tel is not None:
                # one host-stepped round: the per-round metrics the fused
                # engines record in run_block
                tel.spec_rounds.inc()
                tel.acceptance_length.observe(len(path))
                tel.tokens_per_round.observe(len(new_toks))
            req.cache_depth = min(start[req.slot] + 1 + len(path),
                                  len(req.tokens) - 1)
            self._finish_if_done(req, max_seq)
        if needs_commit:
            dev = llm.device
            llm.op_state = self._commit(
                llm.op_state, torch.as_tensor(src_node, device=dev),
                torch.as_tensor(ncommit, device=dev),
                torch.as_tensor(start + 1, device=dev),
                torch.as_tensor(act, device=dev),
                mesh=getattr(llm, "mesh", None),
                seq_len=llm.config.max_sequence_length)

    @staticmethod
    def _parked(ctrl, active):
        """Guids the speculation controller has parked on fallback decode:
        preemption's preferred victims."""
        if ctrl is None:
            return ()
        return {req.guid for req in active
                if req is not None and ctrl.in_fallback(req.guid)}

    def _collect_finished(self, active, done, ctrl=None, pairs=()):
        """Collect every finished slotted request (pooling its prompt's KV
        first when ``pairs`` names the loop's models) and free its slot."""
        for slot, req in enumerate(active):
            if req is not None and req.finished:
                if ctrl is not None:
                    ctrl.drop(req.guid)
                if pairs:
                    self._prefix_store(req, pairs)
                done.append(self._collect(req))
                active[slot] = None


_request_manager: Optional[RequestManager] = None


def get_request_manager() -> RequestManager:
    """Singleton accessor (reference RequestManager::get_request_manager)."""
    global _request_manager
    if _request_manager is None:
        _request_manager = RequestManager()
    return _request_manager


def _world_reducer(device):
    """reduce(values, "min" | "max"): a list of ints all-reduced over every
    rank of the process group (the prefix pool's agreed figures)."""
    import torch.distributed as dist

    from flexflow_tpu_torch.parallel.collectives import _run

    ops = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}

    def reduce(values, op):
        t = torch.tensor(values, dtype=torch.int64, device=device)
        return _run(t, None, lambda y: dist.all_reduce(y, op=ops[op])
                    ).tolist()

    return reduce
