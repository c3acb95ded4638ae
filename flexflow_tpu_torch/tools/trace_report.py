"""Summarize a serving trace: critical paths, wait attribution, slow spans
(a copy of the JAX package's ``tools/trace_report.py``; both packages
write the same span JSONL and stitched Chrome traces).

Input is either a per-replica span JSONL (telemetry.tracing.SpanTracer
output) or a stitched Chrome trace (``{"traceEvents": [...]}`` — what
``FleetTelemetry.stitch_chrome_trace`` / ``failover_run`` write). Spans
are grouped by the fleet-wide ``args.trace_id`` (falling back to
pid/tid for pre-fleet traces), so a failed-over request's events on two
replicas analyze as ONE request.

Per request the report gives the critical path (its spans in order,
with the pid row each ran on) and the wait decomposition:

* queue wait   — admission instant -> first prefill span start
* service      — sum of executed span durations (prefill + decode)
* other wait   — everything else inside admission -> finish, which for
  a failed-over request is dominated by the crash-to-redispatch gap
  (the pool's honest-SLO attribution, loadgen.attribute_failover_wait,
  applies the same split to latency numbers; this is the trace view)

plus the fleet-wide top-N slowest spans. Usage::

    python -m flexflow_tpu_torch.tools.trace_report TRACE.json[l] \
        [--top N] [--requests N]
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

__all__ = ["load_trace", "request_traces", "summarize_request",
           "trace_report", "format_report"]


def load_trace(path: str) -> List[dict]:
    """Read span events from a JSONL trace or a Chrome-trace JSON file."""
    with open(path) as f:
        text = f.read()
    stripped = text.lstrip()
    if stripped.startswith("{") and "traceEvents" in stripped[:200]:
        return list(json.loads(text)["traceEvents"])
    return [json.loads(ln) for ln in text.splitlines() if ln.strip()]


def request_traces(events: List[dict]) -> Dict[str, List[dict]]:
    """Group span events into per-request traces keyed by trace_id
    (pid/tid fallback), each sorted by timestamp."""
    out: Dict[str, List[dict]] = {}
    for ev in events:
        if ev.get("ph") == "M":
            continue
        args = ev.get("args") or {}
        key = args.get("trace_id")
        if key is None:
            if not ev.get("tid"):
                continue                     # unattributed metadata-ish row
            key = f"pid{ev.get('pid', 0)}/tid{ev['tid']}"
        out.setdefault(key, []).append(ev)
    for evs in out.values():
        evs.sort(key=lambda e: e.get("ts", 0.0))
    return out


def summarize_request(trace_id: str, evs: List[dict]) -> dict:
    """Wait decomposition + critical path for one request's spans."""
    admission = next((e for e in evs if e["name"] == "admission"), None)
    # A failed-over request carries one finish per replica that touched
    # it: the dead replica's abort path stamps an "error" finish before
    # the survivor's terminal one. The LAST finish (evs are ts-sorted)
    # is the request's actual outcome.
    finishes = [e for e in evs if e["name"] == "finish"]
    finish = finishes[-1] if finishes else None
    spans = [e for e in evs if e.get("ph") == "X"]
    prefills = [e for e in spans if e["name"] == "prefill"]
    t0 = admission["ts"] if admission else (evs[0]["ts"] if evs else 0.0)
    t1 = finish["ts"] if finish else (evs[-1]["ts"] if evs else 0.0)
    total_us = max(0.0, t1 - t0)
    queue_us = max(0.0, prefills[0]["ts"] - t0) if prefills else 0.0
    service_us = sum(e.get("dur", 0.0) for e in spans)
    fargs = (finish.get("args") or {}) if finish else {}
    return {
        "trace_id": trace_id,
        "pids": sorted({e.get("pid", 0) for e in evs}),
        "guids": sorted({(e.get("args") or {}).get("request_guid")
                         for e in evs
                         if (e.get("args") or {}).get("request_guid")
                         is not None}),
        "status": fargs.get("status", "unknown" if finish is None
                            else "ok"),
        "failovers": int(fargs.get("failovers", 0)),
        "preemptions": int(fargs.get("preemptions", 0)),
        "output_tokens": fargs.get("output_tokens"),
        "latency_s": fargs.get("latency_s"),
        "total_us": round(total_us, 1),
        "queue_wait_us": round(queue_us, 1),
        "service_us": round(service_us, 1),
        # crash-to-redispatch gaps, scheduler stalls, inter-round slack
        "other_wait_us": round(
            max(0.0, total_us - queue_us - service_us), 1),
        "critical_path": [
            {"name": e["name"], "pid": e.get("pid", 0),
             "ts_us": round(e.get("ts", 0.0), 1),
             "dur_us": round(e.get("dur", 0.0), 1)}
            for e in evs],
    }


def trace_report(events: List[dict], top: int = 10) -> dict:
    """The full analysis: per-request summaries (slowest first) + the
    fleet-wide top-N slowest executed spans."""
    reqs = [summarize_request(tid, evs)
            for tid, evs in request_traces(events).items()]
    reqs.sort(key=lambda r: -r["total_us"])
    spans = [e for e in events if e.get("ph") == "X"]
    spans.sort(key=lambda e: -e.get("dur", 0.0))
    return {
        "n_requests": len(reqs),
        "n_failed_over": sum(r["failovers"] > 0 for r in reqs),
        "n_preempted": sum(r["preemptions"] > 0 for r in reqs),
        "requests": reqs,
        "slowest_spans": [
            {"name": e["name"], "pid": e.get("pid", 0),
             "tid": e.get("tid", 0),
             "trace_id": (e.get("args") or {}).get("trace_id"),
             "dur_us": round(e.get("dur", 0.0), 1)}
            for e in spans[:top]],
    }


def format_report(rep: dict, requests: int = 8) -> str:
    lines = [f"requests: {rep['n_requests']}  "
             f"failed-over: {rep['n_failed_over']}  "
             f"preempted: {rep['n_preempted']}",
             "", "== slowest requests (critical path) =="]
    for r in rep["requests"][:requests]:
        lines.append(
            f"{r['trace_id']}  status={r['status']} "
            f"failovers={r['failovers']} pids={r['pids']}  "
            f"total {r['total_us'] / 1e3:.2f} ms = "
            f"queue {r['queue_wait_us'] / 1e3:.2f} "
            f"+ service {r['service_us'] / 1e3:.2f} "
            f"+ other {r['other_wait_us'] / 1e3:.2f}")
        for s in r["critical_path"]:
            lines.append(f"    {s['ts_us'] / 1e3:10.2f} ms "
                         f"pid {s['pid']}  {s['name']}"
                         + (f"  ({s['dur_us'] / 1e3:.2f} ms)"
                            if s["dur_us"] else ""))
    lines += ["", "== slowest spans =="]
    for s in rep["slowest_spans"]:
        lines.append(f"{s['dur_us'] / 1e3:10.2f} ms  pid {s['pid']} "
                     f"{s['name']}  trace={s['trace_id']}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    top, nreq = 10, 8
    paths = []
    i = 0
    while i < len(argv):
        if argv[i] == "--top":
            top = int(argv[i + 1]); i += 2
        elif argv[i] == "--requests":
            nreq = int(argv[i + 1]); i += 2
        else:
            paths.append(argv[i]); i += 1
    if not paths:
        print(__doc__)
        return 2
    events: List[dict] = []
    for p in paths:
        events.extend(load_trace(p))
    print(format_report(trace_report(events, top=top), requests=nreq))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
