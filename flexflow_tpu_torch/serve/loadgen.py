"""Closed/open-loop load generator + SLO observability for the serving stack
(counterpart of ``flexflow_tpu/serve/loadgen.py``, copied with the port's
imports: the same seed gives the same schedule in both packages, and
``summarize`` accounts exactly as the JAX package does).

Arrival-driven traffic against the continuous batcher is the regime where
the SpecInfer paper's claims and a production front door actually live.
Back-to-back batch runs measure peak throughput; only arrival-driven load
exposes queueing, tail latency, and the saturation knee.

Pieces (all seeded + deterministic where determinism is possible):

* **Schedule**: :func:`build_schedule` draws a per-request (arrival time,
  tenant, prompt, output budget, deadline) tuple stream from a
  :class:`WorkloadSpec` — Poisson or fixed-rate arrivals, mixed
  prompt/output-length distributions, weighted tenants, optional
  per-tenant deadlines. Same seed -> byte-identical schedule.
* **Runner**: :class:`LoadRunner` replays a schedule against the
  ``serve/api.py`` background-server submission queue (open loop: submit
  at the scheduled instants regardless of completions; closed loop: a
  concurrency cap K gates submission, the classic closed-loop client).
  Each finished request yields a :class:`RequestRecord` carrying the
  queue-wait/prefill/TTFT/latency decomposition the RequestManager stamps
  on every GenerationResult.
* **Report**: :func:`summarize` is a PURE function from records to the
  SLO dict (throughput, goodput, p50/p99 TTFT/latency/TPOT, queue-wait vs
  service split, per-tenant breakdown) so the accounting is unit-testable
  on hand-built schedules with exact expected numbers.
* **Knee sweep**: :func:`sweep` steps the offered load and
  :func:`find_knee` locates the last sustainable step — the max offered
  req/s where achieved throughput keeps up AND the p99 SLO holds. This is
  the instrument later scaling PRs (adaptive speculation, prefix-sharing
  KV, chunked prefill) are judged with.

Models built without an HF checkpoint (``chip_smoke.py``, the tests)
wrap their FFModel in :class:`EngineHandle`, a duck-typed stand-in for
``serve.api.LLM`` that the background server drives identically.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from flexflow_tpu_torch.serve.admission import RejectedError
from flexflow_tpu_torch.telemetry.metrics import percentile

__all__ = [
    "TenantSpec",
    "WorkloadSpec",
    "LoadRequest",
    "RequestRecord",
    "EngineHandle",
    "LoadRunner",
    "build_schedule",
    "poisson_arrivals",
    "uniform_arrivals",
    "summarize",
    "attribute_failover_wait",
    "overload_run",
    "find_knee",
    "sweep",
    "format_report",
]


# ---------------------------------------------------------------------------
# workload specification + schedule synthesis (pure, seeded)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One traffic class. ``weight`` is the sampling weight across
    tenants; ``deadline_s`` (optional) is the per-request completion SLO
    — requests finishing later still count as throughput but not as
    goodput. ``priority`` feeds the RequestManager's slot scheduler
    (higher grants first, and deadline-at-risk requests may preempt
    lower-priority ones); ``timeout_s`` is a hard per-request wall-clock
    bound — past it the request is cancelled between decode rounds and
    resolves with ``timed_out`` status."""

    name: str = "default"
    weight: float = 1.0
    deadline_s: Optional[float] = None
    priority: int = 0
    timeout_s: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Mixed prompt/output-length workload over weighted tenants.

    Lengths are drawn from the discrete distributions given by
    ``prompt_lens``/``prompt_weights`` (uniform when weights omitted) —
    discrete mixes reproduce the bimodal short-chat/long-document shape
    real traffic has without dragging in a trace corpus.

    ``shared_prefix_groups``/``shared_prefix_len`` model multi-tenant
    system prompts: when both are > 0, each request's prompt is one of N
    seeded group prefixes (drawn once per schedule) followed by a
    per-request random suffix of the drawn prompt length — the workload
    shape prefix-sharing KV caching (serve/prefix_cache.py) feeds on.
    Defaults off, and when off the rng draw order is untouched, so
    pre-existing seeded schedules stay byte-identical."""

    prompt_lens: Sequence[int] = (4, 8, 16)
    prompt_weights: Optional[Sequence[float]] = None
    output_lens: Sequence[int] = (4, 8, 16)
    output_weights: Optional[Sequence[float]] = None
    tenants: Sequence[TenantSpec] = (TenantSpec(),)
    vocab_size: int = 128
    # shared-prefix mix: N distinct system prompts of this token length
    shared_prefix_groups: int = 0
    shared_prefix_len: int = 0

    def _norm(self, weights, n):
        w = np.ones(n) if weights is None else np.asarray(weights, float)
        return w / w.sum()


@dataclasses.dataclass
class LoadRequest:
    """One scheduled request (before execution)."""

    idx: int
    arrival_s: float               # offset from schedule start
    tenant: str
    prompt: List[int]
    max_new_tokens: int
    deadline_s: Optional[float] = None
    priority: int = 0
    timeout_s: Optional[float] = None


def poisson_arrivals(rate_rps: float, n: int,
                     rng: np.random.RandomState) -> np.ndarray:
    """Cumulative arrival offsets of a Poisson process at ``rate_rps``
    (exponential inter-arrivals); deterministic given the rng state."""
    assert rate_rps > 0 and n >= 0
    return np.cumsum(rng.exponential(1.0 / rate_rps, size=n))


def uniform_arrivals(rate_rps: float, n: int) -> np.ndarray:
    """Fixed-rate arrivals: request i at i / rate."""
    assert rate_rps > 0 and n >= 0
    return np.arange(n, dtype=float) / rate_rps


def build_schedule(spec: WorkloadSpec, n_requests: int, rate_rps: float,
                   seed: int, process: str = "poisson"
                   ) -> List[LoadRequest]:
    """Draw a deterministic schedule: arrivals, tenant assignment, prompt
    tokens, and output budgets all come from one seeded RandomState, so
    the same (spec, n, rate, seed) is byte-identical across runs/hosts —
    the property a benchmark's trajectory depends on."""
    rng = np.random.RandomState(seed)
    if process == "poisson":
        arrivals = poisson_arrivals(rate_rps, n_requests, rng)
    elif process in ("uniform", "fixed"):
        arrivals = uniform_arrivals(rate_rps, n_requests)
    else:
        raise ValueError(f"unknown arrival process {process!r}; "
                         "use 'poisson' or 'uniform'")
    tenants = list(spec.tenants)
    tw = spec._norm([t.weight for t in tenants], len(tenants))
    pl = np.asarray(spec.prompt_lens, int)
    pw = spec._norm(spec.prompt_weights, len(pl))
    ol = np.asarray(spec.output_lens, int)
    ow = spec._norm(spec.output_weights, len(ol))
    # shared-prefix mix: draw the N group "system prompts" up front from
    # the same rng (extra draws only happen when the mix is armed, so
    # legacy schedules keep their byte-identical draw order)
    prefixes = []
    if spec.shared_prefix_groups > 0 and spec.shared_prefix_len > 0:
        prefixes = [[int(t) for t in
                     rng.randint(1, spec.vocab_size,
                                 size=spec.shared_prefix_len)]
                    for _ in range(spec.shared_prefix_groups)]
    out = []
    for i in range(n_requests):
        tenant = tenants[rng.choice(len(tenants), p=tw)]
        n_prompt = int(pl[rng.choice(len(pl), p=pw)])
        n_out = int(ol[rng.choice(len(ol), p=ow)])
        prompt = [int(t) for t in
                  rng.randint(1, spec.vocab_size, size=n_prompt)]
        if prefixes:
            prompt = prefixes[rng.choice(len(prefixes))] + prompt
        out.append(LoadRequest(idx=i, arrival_s=float(arrivals[i]),
                               tenant=tenant.name, prompt=prompt,
                               max_new_tokens=n_out,
                               deadline_s=tenant.deadline_s,
                               priority=tenant.priority,
                               timeout_s=tenant.timeout_s))
    return out


# ---------------------------------------------------------------------------
# execution: drive the background-server submission queue
# ---------------------------------------------------------------------------

class EngineHandle:
    """Duck-typed stand-in for ``serve.api.LLM`` over a compiled FFModel.

    ``serve.api._BackgroundServer`` only touches ``.rm``, ``.ffmodel``
    and ``.ssms`` (each exposing ``.ffmodel``), so models built WITHOUT
    an HF checkpoint (``chip_smoke.py``'s synthetic 7B, the tests' tiny
    pair) get the same submission-queue/continuous-batching
    path the user-facing LLM serves through — one serving front door,
    not a parallel harness."""

    class _Ref:
        def __init__(self, ffmodel):
            self.ffmodel = ffmodel

    def __init__(self, ffmodel, ssms: Sequence = (), rm=None,
                 spec_depth: Optional[int] = None,
                 generation_config=None):
        from flexflow_tpu_torch.serve.request_manager import RequestManager

        self.ffmodel = ffmodel
        self.ssms = [self._Ref(m) for m in ssms]
        self.rm = rm if rm is not None else RequestManager()
        if spec_depth is not None:
            self.rm.max_spec_depth = spec_depth
        # threaded into the scheduler loops by _BackgroundServer._run,
        # exactly like serve.api.LLM.generation_config (arms prefix
        # caching / spec-controller knobs for checkpoint-less models)
        self.generation_config = generation_config
        self._server = None

    def start_server(self, admission=None):
        from flexflow_tpu_torch.serve.api import _start_server

        return _start_server(self, admission)

    def stop_server(self, flush_timeout_s: Optional[float] = 30.0):
        from flexflow_tpu_torch.serve.api import _stop_server

        return _stop_server(self, flush_timeout_s)


@dataclasses.dataclass
class RequestRecord:
    """One finished request, ready for :func:`summarize`."""

    idx: int
    tenant: str
    scheduled_s: float             # intended arrival offset
    submitted_s: float             # actual submit offset (run clock)
    prompt_tokens: int
    output_tokens: int
    latency_s: float
    ttft_s: float
    queue_wait_s: float
    prefill_s: float
    deadline_s: Optional[float] = None
    # ok | rejected | timed_out | cancelled | error — what resolved the
    # request. Every scheduled request yields exactly one record (the
    # every-future-resolves invariant), so nothing disappears from the
    # accounting denominators.
    status: str = "ok"
    # times the request was re-dispatched to a surviving replica after a
    # crash (serve/replica.py); 0 on a single-engine run
    failovers: int = 0
    # the fleet-wide correlation id of its spans (telemetry.tracing)
    trace_id: str = ""
    # prompt tokens whose KV came from the shared-prefix pool instead of
    # being prefilled (serve/prefix_cache.py); 0 with the cache off
    prefix_hit_tokens: int = 0

    @property
    def finished_s(self) -> float:
        return self.submitted_s + self.latency_s

    @property
    def met_deadline(self) -> bool:
        """No deadline -> vacuously met (all tokens are goodput); a
        rejected/timed-out/cancelled/errored request never counts."""
        if self.status != "ok":
            return False
        return self.deadline_s is None or self.latency_s <= self.deadline_s

    @property
    def tpot_s(self) -> float:
        """Time per output token after the first (decode cadence)."""
        return ((self.latency_s - self.ttft_s)
                / max(1, self.output_tokens - 1))


class LoadRunner:
    """Replays a schedule against a serving handle's submission queue.

    ``handle`` is a ``serve.api.LLM`` or :class:`EngineHandle`; the
    runner starts its background server if needed. Open loop (default):
    requests are submitted at their scheduled offsets whether or not
    earlier ones finished — offered load is the independent variable.
    Closed loop (``closed_concurrency=K``): at most K requests are in
    flight; a scheduled request waits for a slot, modeling K synchronous
    clients. Submission happens on the caller's thread; completion waits
    ride the per-submission events the server already provides."""

    def __init__(self, handle):
        self.handle = handle

    def run(self, schedule: Sequence[LoadRequest],
            closed_concurrency: Optional[int] = None,
            timeout_s: float = 300.0) -> List[RequestRecord]:
        handle = self.handle
        if getattr(handle, "_server", None) is None:
            handle.start_server()
        srv = handle._server
        rm = handle.rm
        sem = (threading.Semaphore(int(closed_concurrency))
               if closed_concurrency else None)
        pending = []                       # (req, guid, ev, submitted_s)
        records_rejected: List[RequestRecord] = []
        t0 = time.perf_counter()
        for req in schedule:
            if sem is not None:
                # closed loop: the arrival schedule still paces submission
                # (a K-client pool with think time), but a full pool gates
                if not sem.acquire(timeout=timeout_s):
                    with srv._work:     # see the purge note below
                        rm.pending.clear()
                    raise TimeoutError(
                        f"closed-loop slot wait exceeded {timeout_s}s "
                        f"(request {req.idx}); pending backlog purged")
            delay = req.arrival_s - (time.perf_counter() - t0)
            if delay > 0:
                time.sleep(delay)
            try:
                guids, ev = srv.submit([req.prompt], req.max_new_tokens, 0,
                                       timeout_s=req.timeout_s,
                                       tenant=req.tenant,
                                       priority=req.priority)
            except RejectedError:
                # admission shed this request: it resolves RIGHT HERE as
                # a rejection record (0 tokens, no latency) — never
                # silently dropped from the accounting
                if sem is not None:
                    sem.release()
                records_rejected.append(RequestRecord(
                    idx=req.idx, tenant=req.tenant,
                    scheduled_s=req.arrival_s,
                    submitted_s=time.perf_counter() - t0,
                    prompt_tokens=len(req.prompt), output_tokens=0,
                    latency_s=0.0, ttft_s=0.0, queue_wait_s=0.0,
                    prefill_s=0.0, deadline_s=req.deadline_s,
                    status="rejected"))
                continue
            pending.append((req, guids[0], ev, time.perf_counter() - t0))
            if sem is not None:
                ev_local, sem_local = ev, sem
                threading.Thread(
                    target=lambda: (ev_local.wait(timeout_s),
                                    sem_local.release()),
                    daemon=True).start()
        records = []
        deadline = time.monotonic() + timeout_s
        for req, guid, ev, submitted in pending:
            if not ev.wait(timeout=max(0.0, deadline - time.monotonic())):
                # purge the unstarted backlog BEFORE raising: the
                # caller's stop_server() joins a server thread that only
                # exits once rm.pending drains, so leaving the schedule
                # queued would turn this timeout into an indefinite hang
                # (only the in-flight batch still runs to completion)
                with srv._work:
                    rm.pending.clear()
                raise TimeoutError(
                    f"request {req.idx} (guid {guid}) not finished after "
                    f"{timeout_s}s; pending backlog purged")
            if srv._error is not None:
                raise RuntimeError("serving loop died") from srv._error
            res = rm.results[guid]
            records.append(RequestRecord(
                idx=req.idx, tenant=req.tenant, scheduled_s=req.arrival_s,
                submitted_s=submitted,
                prompt_tokens=len(res.input_tokens),
                output_tokens=len(res.output_tokens),
                latency_s=res.latency_s, ttft_s=res.ttft_s,
                queue_wait_s=res.queue_wait_s, prefill_s=res.prefill_s,
                deadline_s=req.deadline_s, status=res.status,
                failovers=getattr(res, "failovers", 0),
                trace_id=getattr(res, "trace_id", ""),
                prefix_hit_tokens=getattr(res, "prefix_hit_tokens", 0)))
        records.extend(records_rejected)
        records.sort(key=lambda r: r.idx)
        return records


# ---------------------------------------------------------------------------
# SLO accounting (pure; exact-number unit tests live on this seam)
# ---------------------------------------------------------------------------

def attribute_failover_wait(pool_latency_s: float, final_latency_s: float,
                            final_queue_wait_s: float,
                            final_prefill_s: float = 0.0):
    """Split a failed-over request's pool-level latency into
    (queue_wait_s, ttft_s).

    A request that crashed mid-flight and was re-dispatched spends its
    life in three places: queued/served on the dead replica (work that
    was THROWN AWAY), queued on the survivor, and finally served on the
    survivor. Only the LAST service counts as service time — everything
    before the survivor's slot grant is wait, else per-replica p99
    service times would absorb crash recovery and stop meaning "how fast
    does a healthy replica serve" (the seam ``summarize()``'s
    queue-wait/service split is built on).

    Pure arithmetic on already-measured durations (unit-tested on a fake
    clock): the survivor's own service time is
    ``final_latency_s - final_queue_wait_s``; all remaining pool time is
    attributed to queue wait, and TTFT restarts with the survivor's
    re-prefill."""
    service_s = max(0.0, final_latency_s - final_queue_wait_s)
    queue_wait_s = max(0.0, pool_latency_s - service_s)
    ttft_s = queue_wait_s + max(0.0, final_prefill_s)
    return queue_wait_s, ttft_s


def _pcts(values, lo=50, hi=99):
    srt = sorted(values)
    return percentile(srt, lo), percentile(srt, hi)


def summarize(records: Sequence[RequestRecord],
              duration_s: Optional[float] = None,
              offered_rps: Optional[float] = None,
              n_scheduled: Optional[int] = None) -> dict:
    """Aggregate records into the SLO report dict.

    ``duration_s`` defaults to first-submit -> last-finish; callers with
    a wall-clocked pass may override. Goodput counts ONLY tokens from
    requests that met their deadline (requests without a deadline always
    count) — the metric that distinguishes "fast on average" from "fast
    for the requests that still mattered".

    Rejected/timed-out requests are accounted EXPLICITLY: they stay in
    ``n_requests`` and the ``deadline_met_fraction`` denominator (and
    surface as ``n_rejected``/``n_timed_out``/...), but the latency/TTFT
    percentiles and achieved_rps are computed over requests the engine
    actually served (everything except rejections). ``n_scheduled``,
    when given, yields ``resolved_fraction`` = records / scheduled — the
    every-future-resolves invariant as a number (1.0 = nothing silently
    dropped)."""
    recs = list(records)
    if not recs:
        return {"n_requests": 0}
    # rejected requests never entered the engine: no latency to rank
    served = [r for r in recs if r.status != "rejected"]
    if duration_s is None:
        start = min(r.submitted_s for r in recs)
        end = max(r.finished_s for r in recs)
        duration_s = max(end - start, 1e-9)
    out_tokens = sum(r.output_tokens for r in served)
    good_tokens = sum(r.output_tokens for r in recs if r.met_deadline)
    if served:
        lat_p50, lat_p99 = _pcts([r.latency_s for r in served])
        ttfts = [r.ttft_s for r in served if r.ttft_s > 0]
        ttft_p50, ttft_p99 = _pcts(ttfts) if ttfts else (0.0, 0.0)
        tpot_p50, tpot_p99 = _pcts([r.tpot_s for r in served])
        qw_p50, qw_p99 = _pcts([r.queue_wait_s for r in served])
        mean_lat = sum(r.latency_s for r in served) / len(served)
        mean_qw = sum(r.queue_wait_s for r in served) / len(served)
    else:
        lat_p50 = lat_p99 = ttft_p50 = ttft_p99 = 0.0
        tpot_p50 = tpot_p99 = qw_p50 = qw_p99 = 0.0
        mean_lat = mean_qw = 0.0
    n_by = {}
    for r in recs:
        n_by[r.status] = n_by.get(r.status, 0) + 1
    report = {
        "n_requests": len(recs),
        "n_ok": n_by.get("ok", 0),
        "n_rejected": n_by.get("rejected", 0),
        "n_timed_out": n_by.get("timed_out", 0),
        "n_cancelled": n_by.get("cancelled", 0),
        "n_errors": n_by.get("error", 0),
        # crash-failover visibility: how many served requests were
        # re-dispatched at least once, and the total re-dispatch count
        # (their wait is attributed to queue_wait_s by the pool via
        # attribute_failover_wait, so the service split stays honest)
        "n_failed_over": sum(r.failovers > 0 for r in recs),
        "failovers_total": sum(r.failovers for r in recs),
        "resolved_fraction": (round(len(recs) / n_scheduled, 4)
                              if n_scheduled else 1.0),
        "duration_s": round(duration_s, 4),
        "offered_rps": (round(offered_rps, 4)
                        if offered_rps is not None else None),
        "achieved_rps": round(len(served) / duration_s, 4),
        "throughput_tokens_per_s": round(out_tokens / duration_s, 2),
        "goodput_tokens_per_s": round(good_tokens / duration_s, 2),
        "deadline_met_fraction": round(
            sum(r.met_deadline for r in recs) / len(recs), 4),
        "ttft_p50_s": round(ttft_p50, 4),
        "ttft_p99_s": round(ttft_p99, 4),
        "latency_p50_s": round(lat_p50, 4),
        "latency_p99_s": round(lat_p99, 4),
        "tpot_p50_ms": round(1e3 * tpot_p50, 4),
        "tpot_p99_ms": round(1e3 * tpot_p99, 4),
        "queue_wait_p50_s": round(qw_p50, 4),
        "queue_wait_p99_s": round(qw_p99, 4),
        # the decomposition headline: of the mean request's lifetime, how
        # much was waiting for a batch slot vs being served
        "queue_wait_mean_s": round(mean_qw, 4),
        "service_mean_s": round(mean_lat - mean_qw, 4),
        "queue_wait_fraction": round(mean_qw / max(mean_lat, 1e-9), 4),
        # shared-prefix reuse: how many prompt tokens the KV pool served
        # instead of the prefill step, and what was actually prefilled
        # per request after reuse (the FLOP-savings proxy)
        "prefix_hit_tokens_total": sum(r.prefix_hit_tokens for r in served),
        "prefill_tokens_per_request": (round(
            sum(r.prompt_tokens - r.prefix_hit_tokens for r in served)
            / len(served), 2) if served else 0.0),
    }
    tenants = sorted({r.tenant for r in recs})
    if len(tenants) > 1:
        per = {}
        for t in tenants:
            tr = [r for r in recs if r.tenant == t]
            ts = [r for r in tr if r.status != "rejected"]
            tl50, tl99 = (_pcts([r.latency_s for r in ts])
                          if ts else (0.0, 0.0))
            per[t] = {
                "n_requests": len(tr),
                "n_rejected": sum(r.status == "rejected" for r in tr),
                "n_timed_out": sum(r.status == "timed_out" for r in tr),
                "throughput_tokens_per_s": round(
                    sum(r.output_tokens for r in ts) / duration_s, 2),
                "goodput_tokens_per_s": round(
                    sum(r.output_tokens for r in tr if r.met_deadline)
                    / duration_s, 2),
                "deadline_met_fraction": round(
                    sum(r.met_deadline for r in tr) / len(tr), 4),
                "latency_p50_s": round(tl50, 4),
                "latency_p99_s": round(tl99, 4),
            }
        report["per_tenant"] = per
    return report


# ---------------------------------------------------------------------------
# stepped-offered-load sweep -> saturation knee
# ---------------------------------------------------------------------------

def find_knee(steps: Sequence[dict], p99_ttft_bound_s: Optional[float] = None,
              sustain_fraction: float = 0.9) -> Optional[float]:
    """Max offered req/s that the system SUSTAINED: achieved_rps kept up
    (>= ``sustain_fraction`` x offered) and, when a bound is given, TTFT
    p99 stayed under it. Returns None when even the first step failed."""
    knee = None
    for s in steps:
        offered = s.get("offered_rps") or 0.0
        ok = (s.get("achieved_rps", 0.0) >= sustain_fraction * offered)
        if ok and p99_ttft_bound_s is not None:
            ok = s.get("ttft_p99_s", float("inf")) <= p99_ttft_bound_s
        if ok:
            knee = max(knee or 0.0, offered)
    return knee


def sweep(handle, spec: WorkloadSpec, rates: Sequence[float],
          n_per_step: int, seed: int = 0, process: str = "poisson",
          closed_concurrency: Optional[int] = None,
          p99_ttft_bound_s: Optional[float] = None,
          timeout_s: float = 300.0) -> dict:
    """Stepped offered-load sweep: one :class:`LoadRunner` pass per rate
    (each step reseeded with ``seed + step_idx`` so schedules differ
    across steps but the WHOLE sweep is deterministic), then knee
    location over the per-step reports."""
    if n_per_step < 1:
        raise ValueError(f"n_per_step must be >= 1, got {n_per_step}")
    if not rates:
        raise ValueError("rates must be non-empty")
    runner = LoadRunner(handle)
    steps = []
    for i, rate in enumerate(rates):
        schedule = build_schedule(spec, n_per_step, rate, seed + i, process)
        records = runner.run(schedule, closed_concurrency=closed_concurrency,
                             timeout_s=timeout_s)
        steps.append(summarize(records, offered_rps=rate))
    return {
        "seed": seed,
        "arrival_process": process,
        "n_per_step": n_per_step,
        "closed_concurrency": closed_concurrency,
        "p99_ttft_bound_s": p99_ttft_bound_s,
        "steps": steps,
        "knee_rps": find_knee(steps, p99_ttft_bound_s),
        # trajectory-gate headlines: best sustained rates across steps
        "peak_tokens_per_s": max(
            s.get("throughput_tokens_per_s", 0.0) for s in steps),
        "peak_goodput_tokens_per_s": max(
            s.get("goodput_tokens_per_s", 0.0) for s in steps),
    }


def overload_run(handle, spec: WorkloadSpec, knee_rps: float,
                 multiple: float = 2.0, n_requests: int = 32, seed: int = 0,
                 process: str = "poisson", timeout_s: float = 300.0,
                 admission=None, slo_policy=None) -> dict:
    """Drive the engine PAST its measured knee and report how it sheds.

    Offered load is ``multiple`` x ``knee_rps`` (2x by default). When
    ``admission`` (an ``AdmissionPolicy`` or ``AdmissionController``) is
    given, the handle's server is restarted with it so over-limit
    submissions reject at the front door instead of queueing without
    bound.

    Headlines: ``priority_goodput`` — deadline-met fraction over the
    highest-priority tenants' requests; ``resolved_fraction`` — every
    scheduled request came back as exactly one record; ``besteffort_shed_fraction`` — how much
    lower-priority traffic was rejected/timed out to protect them;
    ``peak_queue_depth`` from the admission controller (bounded by the
    policy when one is installed)."""
    from flexflow_tpu_torch.serve.admission import (AdmissionController,
                                                    AdmissionPolicy)

    if admission is not None:
        if isinstance(admission, AdmissionPolicy):
            admission = AdmissionController(admission)
        handle.stop_server()
        handle.start_server(admission=admission)
    elif getattr(handle, "_server", None) is None:
        handle.start_server()
    rate = float(knee_rps) * float(multiple)
    schedule = build_schedule(spec, n_requests, rate, seed, process)
    records = LoadRunner(handle).run(schedule, timeout_s=timeout_s)
    report = summarize(records, offered_rps=rate,
                       n_scheduled=len(schedule))
    top = max(t.priority for t in spec.tenants)
    prio_names = {t.name for t in spec.tenants if t.priority == top}
    prio = [r for r in records if r.tenant in prio_names]
    rest = [r for r in records if r.tenant not in prio_names]
    shed = [r for r in rest if r.status != "ok"]
    ctrl = admission if admission is not None else \
        getattr(getattr(handle, "_server", None), "admission", None)
    # structured burn-rate alert timeline over the run's own record
    # clock (telemetry/slo.py) — what an operator would have been paged
    # with while the engine shed load
    from flexflow_tpu_torch.telemetry.slo import replay_records
    slo = replay_records(records, policy=slo_policy).report()
    return {
        "knee_rps": float(knee_rps),
        "offered_multiple": float(multiple),
        "offered_rps": rate,
        "priority_tenants": sorted(prio_names),
        "priority_goodput": (round(
            sum(r.met_deadline for r in prio) / len(prio), 4)
            if prio else 1.0),
        "resolved_fraction": report["resolved_fraction"],
        "besteffort_shed_fraction": (round(len(shed) / len(rest), 4)
                                     if rest else 0.0),
        "admission": ctrl.stats() if ctrl is not None else None,
        "slo": slo,
        "report": report,
    }


_STEP_COLS = (
    ("offered_rps", "offered r/s", "{:.2f}"),
    ("achieved_rps", "achieved r/s", "{:.2f}"),
    ("throughput_tokens_per_s", "tok/s", "{:.1f}"),
    ("goodput_tokens_per_s", "goodput tok/s", "{:.1f}"),
    ("ttft_p50_s", "ttft p50 s", "{:.4f}"),
    ("ttft_p99_s", "ttft p99 s", "{:.4f}"),
    ("latency_p50_s", "lat p50 s", "{:.4f}"),
    ("latency_p99_s", "lat p99 s", "{:.4f}"),
    ("queue_wait_mean_s", "queue s", "{:.4f}"),
    ("service_mean_s", "service s", "{:.4f}"),
)


def format_report(sweep_result: dict) -> str:
    """Human-readable knee-sweep table."""
    headers = [h for _, h, _ in _STEP_COLS]
    rows = []
    for s in sweep_result["steps"]:
        rows.append([fmt.format(s[k]) if s.get(k) is not None else "-"
                     for k, _, fmt in _STEP_COLS])
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    lines = ["  ".join(h.rjust(w) for h, w in zip(headers, widths))]
    for r in rows:
        lines.append("  ".join(c.rjust(w) for c, w in zip(r, widths)))
    knee = sweep_result.get("knee_rps")
    bound = sweep_result.get("p99_ttft_bound_s")
    lines.append(
        f"knee: {'none sustained' if knee is None else f'{knee:.2f} req/s'}"
        + (f" (ttft p99 bound {bound}s)" if bound is not None else ""))
    return "\n".join(lines)
