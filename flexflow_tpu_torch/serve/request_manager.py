"""RequestManager: continuous batching for incremental decoding
(counterpart of ``flexflow_tpu/serve/request_manager.py``).

The loop is the JAX package's pure-Python scheduler: fill free slots
from the queue, dispatch at most one bounded prefill chunk, then run a
multi-step decode block for every slot whose cache has caught up, and
reconcile EOS/length overshoot on the host.

Slot convention: a request's ``tokens`` are prompt + generated;
``cache_depth`` counts the tokens whose KV is in the cache, and the last
token is always pending (it is fed to produce the next one).

Not in this slice: the native C++ scheduler, the shared-prefix cache,
telemetry, admission control, preemption, deadlines and speculative
inference.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from flexflow_tpu_torch.serve.batch_config import BatchMeta, GenerationConfig
from flexflow_tpu_torch.serve.inference_manager import InferenceManager


@dataclasses.dataclass
class Request:
    """One generation request."""

    guid: int
    prompt_tokens: List[int]
    max_new_tokens: int = 128
    max_sequence_length: int = 0          # 0 -> model max_sequence_length
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: int = -1
    cache_depth: int = 0
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
        if generation_config is not None and generation_config.do_sample:
            raise NotImplementedError(
                "sampling is not ported yet; the slice decodes greedily")
        ifm = getattr(model, "_inference_manager", None)
        if ifm is None:
            ifm = model._inference_manager = InferenceManager(model)
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
                    if not req.first_token_s and req.num_generated > 0:
                        req.first_token_s = time.perf_counter()
                    req.cache_depth = len(req.tokens) - 1
            for slot in range(R):
                req = active[slot]
                if req is not None and req.finished:
                    done.append(self._collect(req))
                    active[slot] = None
        return done
