"""Fleet telemetry: one ServingTelemetry per replica, merged views
(counterpart of ``flexflow_tpu/telemetry/fleet.py``).

The replica pool (serve/replica.py) runs N engines, each with its own
RequestManager on its own serving thread. Pointing them all at the
process-global ServingTelemetry would interleave their span rings and
make per-replica forensics impossible; giving each a throwaway registry
would lose fleet totals. :class:`FleetTelemetry` resolves the tension:

* ``for_replica(rid)`` lazily creates ONE ServingTelemetry per replica
  id — Chrome-trace ``pid`` = rid + 1 with a ``process_name`` metadata
  row, its own metrics registry, its own flight-recorder ring. The
  instance PERSISTS across crash/respawn of the same replica id, so
  counters accumulate over the replica's whole (multi-incarnation) life
  and the flight ring still holds the pre-crash events when the monitor
  dumps it.
* ``merged_registry()`` is the exact fleet aggregate
  (``MetricsRegistry.merge``); ``to_json``/``to_prometheus`` expose it
  with per-replica breakdowns (``replica="N"`` labels), so a
  ``MetricsHTTPServer(lambda: fleet)`` IS the pool-level ``/metrics`` +
  ``/metrics.json`` endpoint — the handler only ever calls those two
  methods.
* ``stitch_chrome_trace()`` merges every replica tracer's events onto
  one clock-corrected timeline (telemetry.tracing.stitch_chrome_trace),
  where a failed-over request's spans appear under both replicas' pid
  rows joined by ``args.trace_id``.

Construction registers the fleet in the telemetry package's weak set so
``aggregate_registry()`` sees fleet totals without the pool having to be
the process-global telemetry.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

from flexflow_tpu_torch.telemetry.metrics import (Counter, Gauge, Histogram,
                                            MetricsRegistry, _fmt)
from flexflow_tpu_torch.telemetry.tracing import stitch_chrome_trace

__all__ = ["FleetTelemetry"]


class FleetTelemetry:
    """Per-replica ServingTelemetry factory + merged fleet exports."""

    def __init__(self, trace_dir: Optional[str] = None,
                 slo_window_s: Optional[float] = None,
                 flight_capacity: Optional[int] = None):
        from flexflow_tpu_torch.telemetry import register_fleet

        self.trace_dir = trace_dir
        self._slo_window_s = slo_window_s
        self._flight_capacity = flight_capacity
        self._replicas: Dict[int, object] = {}
        self._lock = threading.Lock()
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)
        register_fleet(self)

    # -- per-replica instances -------------------------------------------
    def for_replica(self, rid: int):
        """The replica's ServingTelemetry (created on first use; reused
        across respawns of the same id — see module docstring)."""
        from flexflow_tpu_torch.telemetry import ServingTelemetry

        rid = int(rid)
        with self._lock:
            tel = self._replicas.get(rid)
            if tel is None:
                path = (os.path.join(self.trace_dir,
                                     f"replica{rid}.jsonl")
                        if self.trace_dir else None)
                tel = ServingTelemetry(
                    trace_path=path, slo_window_s=self._slo_window_s,
                    pid=rid + 1, process_name=f"replica {rid}",
                    flight_capacity=self._flight_capacity)
                self._replicas[rid] = tel
            return tel

    def replica_telemetries(self) -> List:
        with self._lock:
            return [self._replicas[r] for r in sorted(self._replicas)]

    def replica_ids(self) -> List[int]:
        with self._lock:
            return sorted(self._replicas)

    # -- merged views -----------------------------------------------------
    def merged_registry(self) -> MetricsRegistry:
        return MetricsRegistry.merge(
            [t.registry for t in self.replica_telemetries()])

    def snapshot(self) -> dict:
        """``{"fleet": <merged snapshot>, "replicas": {rid: snapshot}}``
        — merged counters equal the sum of per-replica registries by
        MetricsRegistry.merge's exactness contract."""
        with self._lock:
            per = {str(rid): tel.registry.snapshot()
                   for rid, tel in sorted(self._replicas.items())}
        return {"fleet": self.merged_registry().snapshot(),
                "replicas": per}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def to_prometheus(self) -> str:
        """Fleet totals in standard exposition form, followed by
        per-replica counter/gauge breakdowns as ``{replica="N"}``
        labeled series (histogram breakdowns stay in the JSON snapshot —
        N full bucket expositions per scrape would dwarf the totals)."""
        lines = [self.merged_registry().to_prometheus().rstrip("\n")]
        with self._lock:
            items = sorted(self._replicas.items())
        for rid, tel in items:
            for name, m in sorted(tel.registry._metrics.items()):
                if isinstance(m, (Counter, Gauge)):
                    lines.append(
                        f'{name}{{replica="{rid}"}} {_fmt(m.value)}')
                elif isinstance(m, Histogram):
                    lines.append(
                        f'{name}_count{{replica="{rid}"}} {m.count}')
                    lines.append(
                        f'{name}_sum{{replica="{rid}"}} {_fmt(m.sum)}')
        return "\n".join(ln for ln in lines if ln) + "\n"

    # -- traces -----------------------------------------------------------
    def stitch_chrome_trace(self, path: Optional[str] = None) -> List[dict]:
        """One fleet-wide Chrome trace: every replica's buffered spans on
        a common clock-corrected timeline, one pid row group each."""
        return stitch_chrome_trace(
            [t.tracer for t in self.replica_telemetries()], path)

    def close(self):
        for tel in self.replica_telemetries():
            tel.close()
