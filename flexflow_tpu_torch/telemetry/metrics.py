"""Serving metrics: counters, gauges, histograms + Prometheus/JSON export
(counterpart of ``flexflow_tpu/telemetry/metrics.py``, stdlib only, copied
so that registries fed the same observations export byte-identical
Prometheus text and equal snapshots in both packages).

A dependency-free registry of instruments whose snapshot exports as
Prometheus text (the ``/metrics`` endpoint, ``LLM.start_metrics_server``
in serve/api.py) or JSON (``/metrics.json``). It also holds
``percentile``, which the admission controller and the load generator
share.

Overhead contract: the serving hot loop is the host side of device
blocks (one readback per ~decode_block_steps tokens), so instrument
updates happen at block granularity, not token granularity. All mutation
is plain attribute/list append — GIL-atomic, no locks — and the serving
thread is the single writer (readers snapshot; a torn read across
``_sum``/``_n`` costs one sample of skew, never a crash). When telemetry
is disabled nothing in this module is touched on the decode path.
"""

from __future__ import annotations

import json
import math
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

# Prometheus-style default latency buckets (seconds), wide enough for
# both a single fused decode step (~ms) and whole-request latency (~min).
DEFAULT_TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)
# Fractions (occupancy, utilization).
FRACTION_BUCKETS = tuple(i / 10 for i in range(1, 11))
# Small-integer buckets (acceptance lengths, tokens/round) — upper bounds
# cover the reference's MAX_BEAM_DEPTH=8 envelope plus the bonus token.
COUNT_BUCKETS = tuple(float(i) for i in range(0, 17))


def percentile(sorted_values: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile of an ASCENDING-sorted sequence
    (q in [0, 100]). Returns nan on empty input."""
    n = len(sorted_values)
    if n == 0:
        return float("nan")
    if n == 1:
        return float(sorted_values[0])
    pos = (q / 100.0) * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_values[lo] * (1 - frac) + sorted_values[hi] * frac)


class Counter:
    """Monotonic counter."""

    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def inc(self, n: float = 1.0):
        self._value += n

    def reset(self):
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("name", "help", "_value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def set(self, v: float):
        self._value = float(v)

    def inc(self, n: float = 1.0):
        self._value += n

    def reset(self):
        self._value = 0.0

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Bucketed histogram that ALSO retains raw samples for exact
    percentiles.

    Prometheus histograms are cumulative-bucket-only, which quantizes
    p99 to a bucket edge; serving telemetry wants exact tail latency, so
    observations append to a bounded ring (``sample_cap``, default 64k)
    and ``percentile(q)`` sorts the retained window. Export emits both
    forms: cumulative ``_bucket`` lines for Prometheus scrapers and a
    ``percentiles`` block in the JSON snapshot.

    **Sliding window** (``window_s``): SLO gauges under live load must
    answer "what is p99 RIGHT NOW", not "since process start" — a
    whole-run aggregate buries a saturation spike under minutes of
    healthy history. With ``window_s`` set, each observation also keeps
    its timestamp in a time-bounded deque and ``windowed_percentiles()``
    (and the ``window`` block of ``snapshot()`` / the ``{name}_window``
    summary in the Prometheus exposition) covers only the last
    ``window_s`` seconds. Timestamps default to ``time.monotonic()``;
    tests inject explicit ``at=``/``now=`` values for determinism.
    """

    __slots__ = ("name", "help", "buckets", "_counts", "_sum", "_n",
                 "_samples", "_cap", "_next", "window_s", "_win")

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                 sample_cap: int = 65536,
                 window_s: Optional[float] = None):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)   # +Inf tail
        self._sum = 0.0
        self._n = 0
        self._samples: List[float] = []
        self._cap = int(sample_cap)
        self._next = 0                                  # ring write cursor
        self.window_s = window_s
        self._win: Optional[deque] = deque() if window_s else None

    def observe(self, v: float, at: Optional[float] = None):
        v = float(v)
        # linear scan beats bisect for the short bucket lists used here
        for i, b in enumerate(self.buckets):
            if v <= b:
                self._counts[i] += 1
                break
        else:
            self._counts[-1] += 1
        self._sum += v
        self._n += 1
        if len(self._samples) < self._cap:
            self._samples.append(v)
        else:                       # ring overwrite keeps a recent window
            self._samples[self._next] = v
            self._next = (self._next + 1) % self._cap
        if self._win is not None:
            t = time.monotonic() if at is None else at
            self._win.append((t, v))
            self._evict(t)

    def observe_many(self, values):
        for v in values:
            self.observe(v)

    def _evict(self, now: float):
        cutoff = now - self.window_s
        win = self._win
        while win and win[0][0] < cutoff:
            win.popleft()
        # cap the window's memory too (a burst far above sample_cap
        # within one window would otherwise grow without bound)
        while len(win) > self._cap:
            win.popleft()

    def reset(self):
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._n = 0
        self._samples = []
        self._next = 0
        if self._win is not None:
            self._win.clear()

    @property
    def count(self) -> int:
        return self._n

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, q: float) -> float:
        return percentile(sorted(self._samples), q)

    def windowed_percentiles(self, qs: Sequence[float] = (50, 90, 99),
                             now: Optional[float] = None) -> dict:
        """Exact percentiles over the trailing ``window_s`` seconds:
        ``{"count", "sum", "p<q>": ...}``. Empty dict when the histogram
        has no window configured; ``count`` 0 and no percentile keys
        when the window holds no samples.

        Called from scrape threads while the serving thread observes:
        NEVER mutates the deque (eviction is writer-only, in observe) and
        copies it atomically first — ``list(deque)`` runs entirely in C
        under the GIL, whereas iterating the live deque would raise
        "deque mutated during iteration" mid-scrape."""
        if self._win is None:
            return {}
        cutoff = (time.monotonic() if now is None else now) - self.window_s
        vals = sorted(v for t, v in list(self._win) if t >= cutoff)
        out = {"count": len(vals), "sum": float(sum(vals))}
        if vals:
            for q in qs:
                out[f"p{q:g}"] = percentile(vals, q)
        return out

    def snapshot(self) -> dict:
        srt = sorted(self._samples)
        cum, counts = 0, []
        for c in self._counts:
            cum += c
            counts.append(cum)
        snap = {
            "type": "histogram",
            "count": self._n,
            "sum": self._sum,
            "buckets": [[b, c] for b, c in zip(self.buckets, counts)]
            + [["+Inf", counts[-1]]],
            "percentiles": {
                "p50": percentile(srt, 50),
                "p90": percentile(srt, 90),
                "p99": percentile(srt, 99),
            } if srt else {},
        }
        if self.window_s:
            snap["window"] = {"seconds": self.window_s,
                              **self.windowed_percentiles()}
        return snap


class MetricsRegistry:
    """Name -> instrument map with get-or-create accessors.

    ``counter``/``gauge``/``histogram`` return the existing instrument
    when the name is already registered (mismatched kinds raise), so
    instrumentation sites never need to coordinate creation order.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name, help, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, help, **kw)
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, not {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_TIME_BUCKETS,
                  window_s: Optional[float] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets,
                                   window_s=window_s)

    def get(self, name: str):
        return self._metrics.get(name)

    @classmethod
    def merge(cls, registries: Sequence["MetricsRegistry"]
              ) -> "MetricsRegistry":
        """EXACT fleet aggregation: a new registry whose every instrument
        equals what one registry would hold had all inputs' observations
        landed on it (the pool-level ``/metrics`` contract).

        * counters: values sum.
        * gauges: values sum — the fleet gauges here are extensive
          (queue depths, parked-request counts); a fleet-wide "current
          depth" IS the per-replica sum. Intensive gauges (EWMA means)
          lose their mean-of-means subtlety, documented in README.
        * histograms: bucket counts add elementwise, sums/counts add,
          retained samples concatenate (re-capped at sample_cap), and
          sliding windows merge by timestamp so windowed percentiles
          over the merged registry equal percentiles over the union of
          in-window samples. Same-name histograms must share bucket
          layout and window_s (one vocabulary — ServingTelemetry — so a
          mismatch means two incompatible schema versions: raise).
        """
        out = cls()
        for reg in registries:
            for name, m in reg._metrics.items():
                if isinstance(m, Counter):
                    out.counter(name, m.help).inc(m.value)
                elif isinstance(m, Gauge):
                    out.gauge(name, m.help).inc(m.value)
                elif isinstance(m, Histogram):
                    t = out._get_or_create(Histogram, name, m.help,
                                           buckets=m.buckets,
                                           window_s=m.window_s)
                    if t.buckets != m.buckets:
                        raise ValueError(
                            f"histogram {name!r}: bucket layouts differ "
                            f"across replicas ({t.buckets} vs {m.buckets})")
                    if t.window_s != m.window_s:
                        raise ValueError(
                            f"histogram {name!r}: window_s differs across "
                            f"replicas ({t.window_s} vs {m.window_s})")
                    for i, c in enumerate(m._counts):
                        t._counts[i] += c
                    t._sum += m._sum
                    t._n += m._n
                    t._samples.extend(m._samples)
                    if len(t._samples) > t._cap:
                        # keep the most RECENT samples, like the ring
                        t._samples = t._samples[-t._cap:]
                        t._next = 0
                    if t._win is not None and m._win:
                        t._win.extend(m._win)
                else:           # pragma: no cover — closed instrument set
                    raise TypeError(f"unmergeable metric {name!r}: "
                                    f"{type(m).__name__}")
        # merged windows must be time-ordered for writer-side eviction
        for m in out._metrics.values():
            if isinstance(m, Histogram) and m._win:
                m._win = deque(sorted(m._win))
        return out

    def reset(self):
        """Zero every instrument IN PLACE (for callers separating timed
        passes). Instruments stay registered, so cached references —
        ServingTelemetry holds its hooks' instruments as attributes —
        keep feeding the same registry after the reset."""
        for m in self._metrics.values():
            m.reset()

    # -- export -----------------------------------------------------------
    def snapshot(self) -> Dict[str, dict]:
        return {name: m.snapshot() for name, m in sorted(self._metrics.items())}

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format v0.0.4."""
        lines: List[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {m.help}")
            if isinstance(m, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {_fmt(m.value)}")
            elif isinstance(m, Gauge):
                lines.append(f"# TYPE {name} gauge")
                lines.append(f"{name} {_fmt(m.value)}")
            elif isinstance(m, Histogram):
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for b, c in zip(m.buckets, m._counts):
                    cum += c
                    lines.append(f'{name}_bucket{{le="{_fmt(b)}"}} {cum}')
                cum += m._counts[-1]
                lines.append(f'{name}_bucket{{le="+Inf"}} {cum}')
                lines.append(f"{name}_sum {_fmt(m.sum)}")
                lines.append(f"{name}_count {m.count}")
                if m.window_s:
                    # live SLO view: exact quantiles over the trailing
                    # window, exported as a Prometheus summary so
                    # scrapers see CURRENT tail latency, not the
                    # whole-run aggregate above
                    w = m.windowed_percentiles()
                    lines.append(f"# TYPE {name}_window summary")
                    for q in (50, 90, 99):
                        if f"p{q}" in w:
                            # Prometheus quantile labels are minimal-form
                            # decimals ("0.5", not "0.50")
                            lines.append(
                                f'{name}_window{{quantile="{q / 100:g}"}} '
                                f'{_fmt(w[f"p{q}"])}')
                    lines.append(f"{name}_window_sum {_fmt(w['sum'])}")
                    lines.append(f"{name}_window_count {w['count']}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


# ---------------------------------------------------------------------------
# /metrics HTTP endpoint (serve/api.py LLM.start_metrics_server)
# ---------------------------------------------------------------------------

class MetricsHTTPServer:
    """Minimal scrape endpoint: ``GET /metrics`` (Prometheus text),
    ``GET /metrics.json`` (JSON snapshot). Daemon thread, stdlib-only.
    ``port=0`` binds an ephemeral port (``.port`` holds the real one)."""

    def __init__(self, registry_fn, host: str = "127.0.0.1", port: int = 0):
        import http.server
        import threading

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                reg = outer._registry_fn()
                if self.path.startswith("/metrics.json"):
                    body = (reg.to_json() if reg else "{}").encode()
                    ctype = "application/json"
                elif self.path.startswith("/metrics"):
                    body = (reg.to_prometheus() if reg else "").encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):          # no stderr chatter
                pass

        self._registry_fn = registry_fn
        self._httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="flexflow-metrics")
        self._thread.start()

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join()
