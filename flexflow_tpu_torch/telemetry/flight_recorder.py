"""Crash-forensics flight recorder: a bounded ring of recent events
(counterpart of ``flexflow_tpu/telemetry/flight_recorder.py``, stdlib
only; an incident report dumped by either package loads in the other).

Aircraft analogy intended: metrics tell you THAT a replica crashed
(counters jump, a gauge flatlines) and the Chrome trace tells you what
each request did, but neither answers the first incident question —
"what was the engine doing in the seconds BEFORE it died?". The flight
recorder is a per-replica deque of the most recent scheduler decisions
(round summaries, adaptive-depth choices, admissions/rejections, slot
grants, preemptions, finishes), each a small dict with a monotonic
timestamp. It is always on once telemetry is enabled, costs one append
per already-instrumented hook call (the hooks fire at block granularity,
not token granularity), and is only ever WRITTEN OUT when the
``ReplicaPool`` monitor detects a crash — the dump is the incident
report ``faultinject.run_chaos`` asserts is produced and parseable.

Incident report format (JSONL, one object per line):

* line 1 — header: ``{"kind": "incident", "replica", "t_detect_s",
  "error", "n_waiting", "wall_time_s", "n_events"}``
* lines 2..N — ring events oldest-first: ``{"kind": <event kind>,
  "t_s": <monotonic seconds>, ...event fields}``

``load_incident_report`` parses one back (and is what the tests and
``run_chaos`` validate with).
"""

from __future__ import annotations

import json
import time
from collections import deque
from typing import Callable, List, Optional, Tuple


class FlightRecorder:
    """Bounded ring of recent serving events (crash forensics).

    ``capacity`` bounds memory (default 512 events ~ the last few
    seconds of block-granular activity on a busy replica). ``clock`` is
    injectable for deterministic tests; defaults to ``time.monotonic``.
    Single-writer like the metrics registry: the serving thread records,
    the pool monitor snapshots via ``list(deque)`` (atomic under the
    GIL) when dumping.
    """

    def __init__(self, capacity: int = 512,
                 clock: Optional[Callable[[], float]] = None):
        self.capacity = max(1, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self._clock = clock if clock is not None else time.monotonic
        self.n_recorded = 0

    def record(self, kind: str, **fields):
        """Append one event. ``kind`` is the event vocabulary key
        (admission | rejection | slot_grant | preemption | round |
        depth_decision | finish | ...); fields must be JSON-serializable
        scalars/short lists — the recorder never holds tensors."""
        ev = {"kind": kind, "t_s": round(self._clock(), 6)}
        ev.update(fields)
        self._ring.append(ev)
        self.n_recorded += 1

    def events(self) -> List[dict]:
        """Snapshot, oldest-first (atomic copy; see class docstring)."""
        return list(self._ring)

    def clear(self):
        self._ring.clear()

    def dump(self, path: str, header: Optional[dict] = None) -> str:
        """Write the incident report: header line + ring events, one
        JSON object per line. Returns ``path``."""
        head = {"kind": "incident", "wall_time_s": time.time(),
                "n_events": len(self._ring)}
        if header:
            head.update(header)
            head["kind"] = "incident"       # the parse anchor, always
        with open(path, "w") as f:
            f.write(json.dumps(head) + "\n")
            for ev in list(self._ring):
                f.write(json.dumps(ev) + "\n")
        return path


def load_incident_report(path: str) -> Tuple[dict, List[dict]]:
    """Parse an incident report back into (header, events). Raises
    ``ValueError`` on an empty file or a header that is not an incident
    record — the parseability check ``run_chaos`` runs on every dump."""
    with open(path) as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    if not lines:
        raise ValueError(f"incident report {path!r} is empty")
    header, events = lines[0], lines[1:]
    if header.get("kind") != "incident":
        raise ValueError(f"incident report {path!r}: first line is "
                         f"{header.get('kind')!r}, expected 'incident'")
    if len(events) != header.get("n_events", len(events)):
        raise ValueError(
            f"incident report {path!r}: header claims "
            f"{header['n_events']} events, found {len(events)}")
    return header, events
