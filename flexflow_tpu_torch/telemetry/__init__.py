"""Serving telemetry of the PyTorch/CUDA port: metrics registry +
per-request tracing (counterpart of ``flexflow_tpu/telemetry``; its own
copy of every module, the same ``ffsv_*`` vocabulary and span schema).

The instrumentation seam for the serving stack: ``serve/request_manager.py``
and ``serve/engine.py`` call the ``ServingTelemetry`` hooks below at
block granularity, the registry exports Prometheus text / JSON
(``serve/api.py`` ``/metrics``, ``MetricsHTTPServer``), and the tracer
writes a Perfetto-loadable JSONL span trace per request.

Disabled by default. ``enable_telemetry()`` installs a process-global
``ServingTelemetry``; every instrumentation site resolves
``get_telemetry()`` once per host-loop iteration and skips ALL work on
None — the disabled decode round pays one attribute read, nothing else
(tests/test_telemetry.py pins zero events recorded when disabled).

Metric vocabulary (all ``ffsv_`` — the serving ABI prefix):

===============================  =========  =================================
name                             kind       meaning
===============================  =========  =================================
ffsv_requests_total              counter    requests admitted
ffsv_requests_finished_total     counter    requests completed
ffsv_requests_rejected_total     counter    submissions refused at admission
ffsv_requests_timed_out_total    counter    requests expired between rounds
ffsv_requests_cancelled_total    counter    requests cancelled by the host
ffsv_requests_preempted_total    counter    slot evictions for a deadline
ffsv_queue_depth                 gauge      submission queue depth (front door)
ffsv_tokens_generated_total      counter    output tokens committed
ffsv_prefill_tokens_total        counter    prompt tokens prefilled
ffsv_spec_rounds_total           counter    speculation rounds executed
ffsv_decode_steps_total          counter    incremental decode steps
ffsv_acceptance_length           histogram  accepted draft tokens per round
ffsv_tokens_per_round            histogram  committed tokens per round (+bonus)
ffsv_batch_occupancy             histogram  live slots / max slots per tick
ffsv_kv_cache_utilization        histogram  mean seq_len / max_seq over live
ffsv_prefill_queue_depth         gauge      pending (unadmitted) requests
ffsv_prefill_step_seconds        histogram  device-fenced prefill step time
ffsv_decode_block_seconds        histogram  device-fenced decode block time
ffsv_spec_block_seconds          histogram  device-fenced speculation block
ffsv_request_latency_seconds     histogram  admission -> finish
ffsv_request_ttft_seconds        histogram  admission -> first token
ffsv_request_queue_wait_seconds  histogram  admission -> batch-slot grant
ffsv_request_prefill_seconds     histogram  slot grant -> first token
ffsv_per_token_latency_seconds   histogram  latency / output tokens
ffsv_draft_depth                 gauge      compiled speculation chain depth
ffsv_tree_width                  gauge      verify-pass token-tree width
ffsv_spec_effective_depth        histogram  controller depth per spec round
ffsv_spec_fallback_total         counter    requests parked on incremental
ffsv_spec_fallback_active        gauge      requests currently parked
ffsv_spec_acceptance_ewma        gauge      mean controller acceptance EWMA
ffsv_jit_cache_misses_total      counter    engine block compiles (traces)
ffsv_engine_retraces_total       counter    compiles BEYOND each engine's 1st
ffsv_failovers_total             counter    crash re-dispatches to survivors
ffsv_prefix_cache_hits_total     counter    admission lookups matching a prefix
ffsv_prefix_cache_misses_total   counter    admission lookups with no match
ffsv_prefix_cache_evictions_total counter   pooled prefixes LRU-evicted
ffsv_prefix_shared_tokens_total  counter    prompt tokens served from the pool
ffsv_prefix_pool_tokens          gauge      tokens held by the prefix pool
===============================  =========  =================================

Fleet layer (this package's distributed half): ``fleet.FleetTelemetry``
keeps one ServingTelemetry per replica (distinct Chrome-trace ``pid``
rows, merged registries via ``MetricsRegistry.merge``), ``slo`` holds
the error-budget burn-rate alerting the load harnesses report, and
``flight_recorder`` is the bounded per-replica event ring the
ReplicaPool dumps as a JSONL incident report on crash detection.

The request-level SLO histograms (latency/ttft/queue-wait/prefill/
per-token) carry a sliding window (``slo_window_s``, default 60 s):
``/metrics`` additionally exports ``<name>_window`` summaries with exact
p50/p90/p99 over the trailing window, so a scrape under load reads the
CURRENT tail, not the whole-run aggregate (serve/loadgen.py's live-SLO
contract).

Timing honesty: block/step timings are recorded by the serving loop
AROUND device calls whose results are read back to the host (the
``.cpu()`` of a decode block's tokens or a speculation block's packed
result), or, for output-free prefill steps, followed by an explicit
``utils/profiling.device_fence`` (``torch.cuda.synchronize`` on the
model's device) — which runs only with telemetry on, so the disabled
path keeps prefill asynchronous.

The port never compiles (PyTorch runs eagerly and there are no CUDA
graphs yet), so ``ffsv_jit_cache_misses_total`` and
``ffsv_engine_retraces_total`` are registered for the vocabulary's sake
and stay 0 (the JAX package's ``note_retrace`` hook, which feeds them,
has no caller here and is not ported).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

from flexflow_tpu_torch.telemetry.metrics import (
    COUNT_BUCKETS,
    DEFAULT_TIME_BUCKETS,
    FRACTION_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsHTTPServer,
    MetricsRegistry,
    percentile,
)
from flexflow_tpu_torch.telemetry.flight_recorder import (FlightRecorder,
                                                    load_incident_report)
from flexflow_tpu_torch.telemetry.slo import SLOMonitor, SLOPolicy, replay_records
from flexflow_tpu_torch.telemetry.tracing import (SpanTracer, load_jsonl,
                                            mint_trace_id,
                                            stitch_chrome_trace)


class ServingTelemetry:
    """One registry + tracer pair with the serving hook vocabulary.

    The hook methods keep every instrumentation site in the serving
    stack to one guarded line; they are the only place metric names are
    spelled, so the table in the module docstring stays the schema."""

    SLO_WINDOW_S = 60.0
    FLIGHT_CAPACITY = 512

    def __init__(self, trace_path: Optional[str] = None,
                 slo_window_s: Optional[float] = None,
                 pid: int = 1, process_name: Optional[str] = None,
                 flight_capacity: Optional[int] = None):
        self.registry = MetricsRegistry()
        self.tracer = SpanTracer(trace_path, pid=pid,
                                 process_name=process_name)
        # crash-forensics ring: hooks below append; the ReplicaPool
        # monitor dumps it as an incident report on crash detection
        self.flight = FlightRecorder(
            self.FLIGHT_CAPACITY if flight_capacity is None
            else flight_capacity)
        win = self.SLO_WINDOW_S if slo_window_s is None else slo_window_s
        r = self.registry
        self.requests_total = r.counter(
            "ffsv_requests_total", "requests admitted")
        self.requests_finished = r.counter(
            "ffsv_requests_finished_total", "requests completed")
        # overload front door (serve/admission.py + request_manager):
        # every non-success terminal disposition gets its own counter so
        # a dashboard can see WHERE load is being shed
        self.requests_rejected = r.counter(
            "ffsv_requests_rejected_total",
            "submissions refused by admission control")
        self.requests_timed_out = r.counter(
            "ffsv_requests_timed_out_total",
            "requests whose deadline expired between decode rounds")
        self.requests_cancelled = r.counter(
            "ffsv_requests_cancelled_total",
            "requests cancelled host-side (LLM.cancel / ffsv_request_cancel)")
        self.requests_preempted = r.counter(
            "ffsv_requests_preempted_total",
            "slot evictions re-queueing a best-effort request for a "
            "deadline-at-risk one")
        self.submit_queue_depth = r.gauge(
            "ffsv_queue_depth",
            "submission queue depth (registered, not yet slotted)")
        self.tokens_generated = r.counter(
            "ffsv_tokens_generated_total", "output tokens committed")
        self.prefill_tokens = r.counter(
            "ffsv_prefill_tokens_total", "prompt tokens prefilled")
        self.spec_rounds = r.counter(
            "ffsv_spec_rounds_total", "speculation rounds executed")
        self.decode_steps = r.counter(
            "ffsv_decode_steps_total", "incremental decode steps")
        self.acceptance_length = r.histogram(
            "ffsv_acceptance_length",
            "accepted draft tokens per speculation round",
            buckets=COUNT_BUCKETS)
        self.tokens_per_round = r.histogram(
            "ffsv_tokens_per_round",
            "committed tokens per round (accepted + bonus)",
            buckets=COUNT_BUCKETS)
        self.batch_occupancy = r.histogram(
            "ffsv_batch_occupancy", "live slots / max slots per host tick",
            buckets=FRACTION_BUCKETS)
        self.kv_utilization = r.histogram(
            "ffsv_kv_cache_utilization",
            "mean sequence length / max_seq over live requests",
            buckets=FRACTION_BUCKETS)
        self.queue_depth = r.gauge(
            "ffsv_prefill_queue_depth", "pending (unadmitted) requests")
        self.prefill_seconds = r.histogram(
            "ffsv_prefill_step_seconds", "device-fenced prefill step time")
        self.decode_block_seconds = r.histogram(
            "ffsv_decode_block_seconds",
            "device-fenced fused decode block time")
        self.spec_block_seconds = r.histogram(
            "ffsv_spec_block_seconds",
            "device-fenced fused speculation block time")
        self.request_latency = r.histogram(
            "ffsv_request_latency_seconds", "admission -> finish",
            window_s=win)
        self.request_ttft = r.histogram(
            "ffsv_request_ttft_seconds", "admission -> first token",
            window_s=win)
        self.request_queue_wait = r.histogram(
            "ffsv_request_queue_wait_seconds",
            "admission -> batch-slot grant", window_s=win)
        self.request_prefill = r.histogram(
            "ffsv_request_prefill_seconds",
            "batch-slot grant -> first token", window_s=win)
        self.per_token_latency = r.histogram(
            "ffsv_per_token_latency_seconds",
            "request latency / output tokens", window_s=win)
        self.draft_depth = r.gauge(
            "ffsv_draft_depth", "compiled speculation chain depth")
        self.tree_width = r.gauge(
            "ffsv_tree_width", "verify-pass token-tree width")
        # adaptive speculation controller (serve/spec_controller.py)
        self.spec_effective_depth = r.histogram(
            "ffsv_spec_effective_depth",
            "controller-chosen draft depth per speculation round",
            buckets=COUNT_BUCKETS)
        self.spec_fallback_total = r.counter(
            "ffsv_spec_fallback_total",
            "times a request was parked on incremental decoding")
        self.spec_fallback_active = r.gauge(
            "ffsv_spec_fallback_active",
            "requests currently parked on incremental decoding")
        self.spec_acceptance_ewma = r.gauge(
            "ffsv_spec_acceptance_ewma",
            "mean per-token acceptance EWMA over live spec requests")
        # compile observability: the JAX engines count their block
        # compiles here; the port runs eagerly and compiles nothing, so
        # both stay 0 (kept so the two packages export one vocabulary)
        self.jit_cache_misses = r.counter(
            "ffsv_jit_cache_misses_total",
            "fused engine block compiles (jit cache misses)")
        self.engine_retraces = r.counter(
            "ffsv_engine_retraces_total",
            "engine block compiles beyond each engine's expected first")
        self.failovers = r.counter(
            "ffsv_failovers_total",
            "crash re-dispatches of in-flight/queued requests to "
            "surviving replicas (serve/replica.py)")
        # shared-prefix KV cache (serve/prefix_cache.py)
        self.prefix_hits = r.counter(
            "ffsv_prefix_cache_hits_total",
            "admission-time prefix lookups that matched a pooled prefix")
        self.prefix_misses = r.counter(
            "ffsv_prefix_cache_misses_total",
            "admission-time prefix lookups with no usable match")
        self.prefix_evictions = r.counter(
            "ffsv_prefix_cache_evictions_total",
            "pooled prefixes evicted (LRU, token-budget pressure)")
        self.prefix_shared_tokens = r.counter(
            "ffsv_prefix_shared_tokens_total",
            "prompt tokens served from the shared-prefix pool "
            "(prefill FLOPs skipped)")
        self.prefix_pool_tokens = r.gauge(
            "ffsv_prefix_pool_tokens",
            "tokens currently held by the shared-prefix pool")

    # -- hooks (serve/request_manager.py, serve/engine.py) ---------------
    def note_admission(self, guid: int, prompt_tokens: int,
                       max_new_tokens: int,
                       trace_id: Optional[str] = None):
        self.requests_total.inc()
        self.tracer.admission(guid, prompt_tokens, max_new_tokens,
                              trace_id=trace_id)
        self.flight.record("admission", guid=guid, trace_id=trace_id,
                           prompt_tokens=prompt_tokens,
                           max_new_tokens=max_new_tokens)

    def note_batch(self, pending: int, live: int, slots: int,
                   kv_fraction: Optional[float]):
        """Once per host scheduling tick that dispatched device work."""
        self.queue_depth.set(pending)
        self.submit_queue_depth.set(pending)
        self.batch_occupancy.observe(live / max(1, slots))
        if kv_fraction is not None:
            self.kv_utilization.observe(kv_fraction)
        self.flight.record("batch", pending=pending, live=live,
                           slots=slots,
                           kv_fraction=(round(kv_fraction, 4)
                                        if kv_fraction is not None
                                        else None))

    def note_rejected(self, tenant: str, reason: str, queue_depth: int):
        """One admission rejection at the front door (serve/api.py's
        submit path, before any request is registered)."""
        self.requests_rejected.inc()
        self.submit_queue_depth.set(queue_depth)
        self.flight.record("rejection", tenant=tenant, reason=reason,
                           queue_depth=queue_depth)

    def note_preempted(self, guid: int):
        """One slot eviction: a running best-effort request re-queued so
        a deadline-at-risk higher-priority one takes its slot."""
        self.requests_preempted.inc()
        self.flight.record("preemption", guid=guid)

    def note_prefix_lookup(self, shared_tokens: int, pool_tokens: int):
        """One admission-time shared-prefix lookup (request_manager.
        _prefix_match): hit/miss, tokens the slot will NOT re-prefill,
        and the pool-occupancy gauge."""
        if shared_tokens > 0:
            self.prefix_hits.inc()
            self.prefix_shared_tokens.inc(shared_tokens)
        else:
            self.prefix_misses.inc()
        self.prefix_pool_tokens.set(pool_tokens)
        self.flight.record("prefix_lookup", shared_tokens=shared_tokens)

    def note_prefix_store(self, evicted: int, pool_tokens: int):
        """One insert-on-finish into the shared-prefix pool
        (request_manager._prefix_store), with how many LRU victims the
        token budget claimed to make room."""
        if evicted > 0:
            self.prefix_evictions.inc(evicted)
        self.prefix_pool_tokens.set(pool_tokens)

    def note_slot_grant(self, guid: int, slot: int):
        """One batch-slot grant (request_manager._grant): the queue-wait
        -> service boundary, recorded for crash forensics — "what was
        scheduled right before the crash" is the first question an
        incident report answers."""
        self.flight.record("slot_grant", guid=guid, slot=slot)

    def note_failover(self, guid: int, replica: int, target: int,
                      trace_id: Optional[str] = None):
        """One crash re-dispatch (serve/replica.py): the request keeps
        its trace_id; only the serving replica (and per-replica guid)
        changes."""
        self.failovers.inc()
        self.flight.record("failover", guid=guid, replica=replica,
                           target=target, trace_id=trace_id)

    def record_prefill(self, seconds: float, n_tokens: int, rows=()):
        self.prefill_seconds.observe(seconds)
        self.prefill_tokens.inc(n_tokens)
        t0 = time.perf_counter() - seconds
        for guid, start_pos, n in rows:
            self.tracer.prefill(guid, start_pos, n, t0, seconds)

    def record_decode_block(self, seconds: float, steps: int, n_live: int,
                            guids=()):
        self.decode_block_seconds.observe(seconds)
        self.decode_steps.inc(steps * n_live)
        t0 = time.perf_counter() - seconds
        for g in guids:
            self.tracer.decode_block(g, steps, t0, seconds)
        self.flight.record("decode_block", seconds=round(seconds, 6),
                           steps=int(steps), n_live=int(n_live))

    def record_spec_block(self, seconds: float, n_acc: np.ndarray,
                          depth: int, tree_width: int, depths=None):
        """After one fused speculation block (all engines): ``n_acc`` is
        the packed [R, rounds] accepted-length matrix, -1 marking idle
        rounds. Called from engine.run_block, so direct engine
        drivers are instrumented too, not just the RequestManager.
        ``depths`` (same shape, optional) is the per-round EFFECTIVE
        draft depth the adaptive controller ran each row under."""
        self.spec_block_seconds.observe(seconds)
        self.draft_depth.set(depth)
        self.tree_width.set(tree_width)
        valid = np.asarray(n_acc).ravel()
        mask = valid >= 0
        valid = valid[mask]
        self.spec_rounds.inc(int(valid.size))
        self.acceptance_length.observe_many(valid.tolist())
        self.tokens_per_round.observe_many((valid + 1).tolist())
        dv = None
        if depths is not None:
            dv = np.asarray(depths).ravel()[mask]
            self.spec_effective_depth.observe_many(dv[dv > 0].tolist())
        # flight-recorder round summary + depth decision, one event per
        # fused block (same granularity as every other hook)
        self.flight.record(
            "spec_block", seconds=round(seconds, 6),
            rounds=int(valid.size), committed=int((valid + 1).sum()),
            mean_acc=(round(float(valid.mean()), 3) if valid.size else 0.0),
            depths=(sorted(set(int(d) for d in dv[dv > 0]))
                    if dv is not None else [int(depth)]))

    def note_spec_controller(self, ewma_mean, n_fallback: int,
                             new_fallbacks: int):
        """Once per scheduling tick that consulted the adaptive
        speculation controller: batch-mean acceptance EWMA, requests
        currently parked on incremental decoding, and how many parked
        since the last tick."""
        if ewma_mean is not None:
            self.spec_acceptance_ewma.set(ewma_mean)
        self.spec_fallback_active.set(n_fallback)
        if new_fallbacks > 0:
            self.spec_fallback_total.inc(new_fallbacks)

    def trace_rounds(self, guid: int, committed_per_round, block_t0: float,
                     block_dur: float, rounds_in_block: int):
        """Per-request round events reconciled from a fused block;
        ``committed_per_round`` is [(round_idx, n_accepted, committed)]."""
        for k, n, c in committed_per_round:
            self.tracer.decode_round(guid, k, n, c, block_t0, block_dur,
                                     rounds_in_block)

    def note_finish(self, guid: int, output_tokens: int, latency_s: float,
                    ttft_s: float, queue_wait_s: float = 0.0,
                    prefill_s: float = 0.0, status: str = "ok",
                    failovers: int = 0, preemptions: int = 0):
        self.requests_finished.inc()
        if status == "timed_out":
            self.requests_timed_out.inc()
        elif status == "cancelled":
            self.requests_cancelled.inc()
        self.tokens_generated.inc(output_tokens)
        if latency_s > 0:
            self.request_latency.observe(latency_s)
            self.per_token_latency.observe(
                latency_s / max(1, output_tokens))
        if ttft_s > 0:
            self.request_ttft.observe(ttft_s)
        if queue_wait_s > 0:
            self.request_queue_wait.observe(queue_wait_s)
        if prefill_s > 0:
            self.request_prefill.observe(prefill_s)
        self.tracer.finish(guid, output_tokens, latency_s, ttft_s,
                           status=status, failovers=failovers,
                           preemptions=preemptions)
        self.flight.record("finish", guid=guid, status=status,
                           output_tokens=int(output_tokens),
                           latency_s=round(latency_s, 6))

    def close(self):
        self.tracer.close()


# ---------------------------------------------------------------------------
# process-global switch (resolved per host-loop iteration, never cached
# across loops, so enabling mid-session takes effect at the next batch)
# ---------------------------------------------------------------------------

_telemetry: Optional[ServingTelemetry] = None


def enable_telemetry(trace_path: Optional[str] = None) -> ServingTelemetry:
    """Install (or replace) the global ServingTelemetry and return it."""
    global _telemetry
    if _telemetry is not None:
        _telemetry.close()
    _telemetry = ServingTelemetry(trace_path)
    return _telemetry


def disable_telemetry():
    global _telemetry
    if _telemetry is not None:
        _telemetry.close()
    _telemetry = None


def get_telemetry() -> Optional[ServingTelemetry]:
    return _telemetry


_fleets = None      # weak set of live FleetTelemetry instances


def _fleet_set():
    global _fleets
    if _fleets is None:
        import weakref

        _fleets = weakref.WeakSet()
    return _fleets


def register_fleet(fleet):
    """FleetTelemetry self-registers so process-wide aggregation
    (``aggregate_registry``) sees every live replica pool. Weakly held:
    a collected pool drops out on its own."""
    _fleet_set().add(fleet)


def aggregate_registry() -> MetricsRegistry:
    """Process-wide fleet totals: the global registry (single-engine
    traffic) merged with every live fleet's per-replica registries.
    Exact by construction (MetricsRegistry.merge); an empty process
    yields an empty registry."""
    regs = []
    tel = get_telemetry()
    if tel is not None:
        regs.append(tel.registry)
    for fleet in list(_fleet_set()):
        regs.extend(t.registry for t in fleet.replica_telemetries())
    return MetricsRegistry.merge(regs)


def ensure_telemetry(trace_path: Optional[str] = None) -> ServingTelemetry:
    """Enable the global telemetry if absent, otherwise keep the live
    instance (its registry survives) and attach ``trace_path`` to its
    tracer — warning, not silently dropping, if the tracer is already
    writing a DIFFERENT file. The one bootstrap used by LLM.compile and
    start_metrics_server."""
    tel = get_telemetry()
    if tel is None:
        return enable_telemetry(trace_path)
    if trace_path and not tel.tracer.attach_file(trace_path):
        import warnings

        warnings.warn(
            f"telemetry trace path {trace_path!r} ignored: telemetry is "
            f"already tracing to {tel.tracer.path!r}", stacklevel=2)
    return tel


__all__ = [
    "COUNT_BUCKETS",
    "DEFAULT_TIME_BUCKETS",
    "FRACTION_BUCKETS",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsHTTPServer",
    "MetricsRegistry",
    "SLOMonitor",
    "SLOPolicy",
    "ServingTelemetry",
    "SpanTracer",
    "aggregate_registry",
    "disable_telemetry",
    "enable_telemetry",
    "ensure_telemetry",
    "get_telemetry",
    "load_incident_report",
    "load_jsonl",
    "mint_trace_id",
    "percentile",
    "register_fleet",
    "replay_records",
    "stitch_chrome_trace",
]
