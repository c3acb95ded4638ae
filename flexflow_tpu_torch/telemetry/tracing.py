"""Per-request span tracing: structured JSONL events, Perfetto-loadable
(counterpart of ``flexflow_tpu/telemetry/tracing.py``, stdlib only; the
same span sequence and schema as the JAX package's).

Every serving request emits a span sequence — admission -> prefill
chunk(s) -> decode/speculation rounds -> finish — as Chrome Trace Event
Format objects, one JSON object per line (JSONL). Each event carries the
request guid as its ``tid``, so Perfetto renders one track per request;
``pid`` identifies the serving process (1 for a single engine; replica
pools assign one pid per replica and ``stitch_chrome_trace`` merges the
per-replica tracers onto one clock-corrected timeline, correlated by the
fleet-wide ``args.trace_id``). ``export_chrome_trace`` wraps the
buffered events into a ``{"traceEvents": [...]}`` file that Perfetto /
chrome://tracing load directly (the raw JSONL is for programmatic
consumption: one ``json.loads`` per line).

Correlation with device traces: the first event is a ``clock_sync``
metadata record holding both ``time.time()`` (wall clock) and the
``perf_counter`` origin all span timestamps are relative to. A
``torch.profiler`` trace taken around the same run
(``utils/profiling.profiler_trace``, exported with
``export_chrome_trace``) records the wall-clock epoch of its CUDA kernel
and host-op timestamps, so the recipe is: load both files in Perfetto and align
on the wall-clock epoch. Span events also carry the guid in ``args`` so
a device-trace step can be matched to the request(s) it served.

Round-granularity caveat: speculation/decode rounds execute INSIDE one
engine block (serve/engine.py) that reads back once at its end, so the
host only observes the block's fenced wall time plus per-round
acceptance counts after the fact. Round events are therefore
reconstructed with the block duration divided evenly across its rounds — per-round ordering and counts are
exact, per-round timestamps are block-granular estimates.
"""

from __future__ import annotations

import itertools
import json
import time
from typing import IO, Iterable, List, Optional

# Process-wide trace-id mint (serve/api.py front door + serve/replica.py
# pool). A counter, not a UUID: runs replay deterministically, and the
# id only needs to be unique within one serving process/trace file. The
# hex digits keep grep-ability ("t-0000002a") without dragging in
# entropy the tests would have to mock out.
_trace_counter = itertools.count(1)


def mint_trace_id() -> str:
    """New distributed-trace id. Minted ONCE per request at the front
    door (submit/pool dispatch) and carried unchanged across failover
    re-dispatch and preemption re-queue — the correlation key that
    stitches a request's spans across replicas."""
    return f"t-{next(_trace_counter):08x}"


class SpanTracer:
    """Buffers trace events; optionally appends them to a JSONL file.

    The in-memory buffer is a RING of the most recent ``max_events``
    (default 64k) so a long-lived serving process cannot grow without
    bound — the JSONL file, when a path is given, still receives every
    event. The ``clock_sync`` epoch record is kept outside the ring so
    exports stay alignable however much history has rotated out.
    """

    FLUSH_EVERY = 128

    def __init__(self, path: Optional[str] = None, max_events: int = 65536,
                 pid: int = 1, process_name: Optional[str] = None):
        from collections import deque

        self.path = path
        self.pid = int(pid)
        self._ring = deque(maxlen=max(1, int(max_events)))
        self._sync: Optional[dict] = None
        self._name_ev: Optional[dict] = None
        # guid -> trace_id, registered at admission and stamped into
        # every subsequent span's args (popped at finish). Distinct from
        # tid=guid: the guid is per-replica, the trace_id is fleet-wide.
        self._ids = {}
        self._file: Optional[IO[str]] = None
        self._n_written = 0
        self._t0 = time.perf_counter()
        if path:
            self._file = open(path, "w")
        self.emit("clock_sync", "M", ts_s=self._t0,
                  wall_time_s=time.time(), perf_counter_origin=self._t0)
        if process_name:
            # Chrome-trace process_name metadata: Perfetto labels this
            # pid's row group (one group per replica in a stitched trace)
            ev = {"name": "process_name", "ph": "M", "pid": self.pid,
                  "tid": 0, "ts": 0.0, "args": {"name": process_name}}
            self._name_ev = ev
            if self._file is not None:
                self._file.write(json.dumps(ev) + "\n")
                self._n_written += 1

    @property
    def events(self) -> List[dict]:
        """clock_sync (+ process_name) + the retained event window."""
        head = [e for e in (self._sync, self._name_ev) if e]
        return head + list(self._ring)

    def attach_file(self, path: str) -> bool:
        """Start writing JSONL to ``path`` on an already-live tracer,
        seeding it with the retained event window. Re-attaching the
        SAME path is a no-op success; returns False (and does nothing)
        only if a DIFFERENT trace file is already attached."""
        if self._file is not None:
            return self.path == path
        self.path = path
        self._file = open(path, "w")
        for ev in self.events:
            self._file.write(json.dumps(ev) + "\n")
        self._file.flush()
        return True

    # -- core -------------------------------------------------------------
    def _us(self, t: Optional[float]) -> float:
        return ((time.perf_counter() if t is None else t) - self._t0) * 1e6

    def emit(self, name: str, ph: str, guid: Optional[int] = None,
             ts_s: Optional[float] = None, dur_s: Optional[float] = None,
             **args):
        """Record one Trace Event Format object. ``ph``: "X" complete
        span (needs dur_s), "i" instant, "M" metadata. ``ts_s``/``dur_s``
        are perf_counter-based seconds; ts defaults to now. A trace_id
        registered for ``guid`` (via admission) is stamped into args."""
        ev = {"name": name, "ph": ph, "pid": self.pid,
              "tid": int(guid) if guid is not None else 0,
              "ts": round(self._us(ts_s), 1)}
        if dur_s is not None:
            ev["dur"] = round(dur_s * 1e6, 1)
        if ph == "i":
            ev["s"] = "t"            # thread-scoped instant
        if guid is not None and "trace_id" not in args:
            tid = self._ids.get(int(guid))
            if tid is not None:
                args["trace_id"] = tid
        if args:
            ev["args"] = args
        if ev["name"] == "clock_sync":
            self._sync = ev
        else:
            self._ring.append(ev)
        if self._file is not None:
            # buffered write; flushed every FLUSH_EVERY events and on
            # close()/flush() — a per-event fsync-style flush would put
            # syscall pairs inside the serving host loop
            self._file.write(json.dumps(ev) + "\n")
            self._n_written += 1
            if self._n_written % self.FLUSH_EVERY == 0:
                self._file.flush()

    # -- span vocabulary (the JSONL schema documented in README) ----------
    def admission(self, guid: int, prompt_tokens: int, max_new_tokens: int,
                  trace_id: Optional[str] = None):
        if trace_id:
            self._ids[int(guid)] = trace_id
        self.emit("admission", "i", guid, request_guid=guid,
                  prompt_tokens=prompt_tokens,
                  max_new_tokens=max_new_tokens)

    def prefill(self, guid: int, start_pos: int, n_tokens: int,
                ts_s: float, dur_s: float):
        self.emit("prefill", "X", guid, ts_s=ts_s, dur_s=dur_s,
                  request_guid=guid,
                  start_pos=start_pos, n_tokens=n_tokens)

    def decode_block(self, guid: int, steps: int, ts_s: float,
                     dur_s: float):
        self.emit("decode_block", "X", guid, ts_s=ts_s, dur_s=dur_s,
                  request_guid=guid, steps=steps)

    def decode_round(self, guid: int, round_idx: int, n_accepted: int,
                     committed: int, block_t0: float, block_dur: float,
                     rounds_in_block: int):
        """One speculation round, reconstructed from a fused block (see
        module docstring for the timestamp caveat)."""
        per = block_dur / max(1, rounds_in_block)
        self.emit("decode_round", "X", guid,
                  ts_s=block_t0 + round_idx * per, dur_s=per,
                  request_guid=guid,
                  round=round_idx, n_accepted=n_accepted,
                  committed_tokens=committed)

    def finish(self, guid: int, output_tokens: int, latency_s: float,
               ttft_s: float, status: str = "ok", failovers: int = 0,
               preemptions: int = 0):
        """Terminal span: carries the closed status taxonomy
        (ok|timed_out|cancelled|error) plus the disruption counts, so a
        trace query can partition requests by disposition without
        joining against the metrics registry."""
        self.emit("finish", "i", guid, request_guid=guid,
                  output_tokens=output_tokens,
                  latency_s=round(latency_s, 6),
                  ttft_s=round(ttft_s, 6),
                  status=status, failovers=int(failovers),
                  preemptions=int(preemptions))
        self._ids.pop(int(guid), None)

    # -- output -----------------------------------------------------------
    def export_chrome_trace(self, path: str):
        """Write the buffered events as one Perfetto-loadable JSON file."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events,
                       "displayTimeUnit": "ms"}, f)

    def flush(self):
        if self._file is not None:
            self._file.flush()

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None


def load_jsonl(path: str) -> List[dict]:
    """Parse a JSONL trace back into event dicts (test/analysis helper)."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def stitch_chrome_trace(tracers: Iterable["SpanTracer"],
                        path: Optional[str] = None) -> List[dict]:
    """Merge several tracers' buffered events into ONE Chrome trace on a
    common timeline (the fleet view: one pid row group per replica).

    Every tracer timestamps relative to its own ``perf_counter`` origin
    (its ``clock_sync`` record), so naive concatenation would overlay
    replicas spawned minutes apart at t=0. Correction: the EARLIEST
    origin becomes the fleet epoch and each tracer's events shift by
    ``(origin_i - origin_base) * 1e6`` µs — all tracers live in one
    process, so perf_counter deltas ARE the true skew (for cross-host
    stitching the clock_sync wall_time_s field would anchor instead).
    Per-tracer pids keep replica rows separate; a failed-over request's
    spans appear under BOTH pids sharing one ``args.trace_id``.

    Returns the merged event list; writes ``{"traceEvents": ...}`` JSON
    when ``path`` is given."""
    tracers = list(tracers)
    if not tracers:
        merged: List[dict] = []
    else:
        base = min(tr._t0 for tr in tracers)
        merged = []
        for tr in tracers:
            shift_us = (tr._t0 - base) * 1e6
            for ev in tr.events:
                ev = dict(ev)
                if ev.get("ph") != "M":
                    ev["ts"] = round(ev.get("ts", 0.0) + shift_us, 1)
                merged.append(ev)
    if path is not None:
        with open(path, "w") as f:
            json.dump({"traceEvents": merged, "displayTimeUnit": "ms"}, f)
    return merged
