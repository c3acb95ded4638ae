"""SLO error budgets + multi-window burn-rate alerting (counterpart of
``flexflow_tpu/telemetry/slo.py``, stdlib only, copied as it is).

At the ROADMAP's million-user scale, operators do not page on raw p99
numbers — they page on the *error budget burn rate* (Google SRE
workbook): with an availability target of, say, 99%, the budget is the
1% of requests allowed to be bad; the burn rate is how many multiples of
the budget the current bad-request fraction is consuming. Burn rate 1
spends exactly the budget; burn rate 25 exhausts a month's budget in
~29 hours. Alerting on TWO windows at once (a fast window to confirm the
problem is happening NOW, a slow window to confirm it is material and
not a blip) is the standard anti-flap construction and is what
:class:`SLOMonitor` implements, on an injectable clock so tests replay
deterministic timelines.

What counts as a *bad* request is the policy's business
(:class:`SLOPolicy`): terminal status other than ``ok`` always does;
crash failovers, missed deadlines, and per-request latency/TTFT bounds
are opt-in classifiers. The serving harness (``loadgen.overload_run``)
replays its finished request records through :func:`replay_records` in
completion order and reports the structured alert timeline.

The monitor also annotates each evaluation with the live windowed
goodput/latency/TTFT percentiles from a telemetry object with a
``registry`` of histograms when one is handed to ``tick`` (the port has
no telemetry registry yet, so its harness hands none).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

__all__ = [
    "SLOPolicy",
    "SLOMonitor",
    "replay_records",
]


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Error-budget policy: availability target, badness classifiers,
    and the two burn-rate alert windows.

    ``availability_target`` sets the budget (1 - target). The default
    fast/slow thresholds follow the SRE workbook's 14.4x/6x pairing
    (scaled to these windows): both must be exceeded to fire, both must
    drop to clear.

    Classifiers beyond status are opt-in so harnesses pick deterministic
    ones: ``count_failovers`` marks any crash-failed-over request bad
    (deterministic under seeded fault injection — the outage detector);
    ``count_deadline_miss`` marks deadline-missing requests bad (honest
    but wall-clock sensitive); ``latency_slo_s``/``ttft_slo_s`` are
    per-request bounds (fake-clock tests)."""

    name: str = "serving"
    availability_target: float = 0.99
    count_failovers: bool = True
    count_deadline_miss: bool = False
    latency_slo_s: Optional[float] = None
    ttft_slo_s: Optional[float] = None
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    fast_burn_threshold: float = 14.4
    slow_burn_threshold: float = 6.0

    def __post_init__(self):
        if not 0.0 < self.availability_target < 1.0:
            raise ValueError("availability_target must be in (0, 1), got "
                             f"{self.availability_target}")
        if self.fast_window_s > self.slow_window_s:
            raise ValueError("fast_window_s must be <= slow_window_s")

    @property
    def budget(self) -> float:
        return 1.0 - self.availability_target

    def is_good(self, status: str = "ok", latency_s: float = 0.0,
                ttft_s: float = 0.0, deadline_s: Optional[float] = None,
                failovers: int = 0) -> bool:
        """Classify one finished request under this policy."""
        if status != "ok":
            return False
        if self.count_failovers and failovers > 0:
            return False
        if (self.count_deadline_miss and deadline_s is not None
                and latency_s > deadline_s):
            return False
        if self.latency_slo_s is not None and latency_s > self.latency_slo_s:
            return False
        if self.ttft_slo_s is not None and ttft_s > self.ttft_slo_s:
            return False
        return True


class SLOMonitor:
    """Error-budget accountant with multi-window burn-rate alerting.

    Single-writer like the rest of telemetry: the serving/harness thread
    observes and ticks; ``timeline`` is append-only. All timestamps come
    from ``clock`` (default ``time.monotonic``) or explicit ``at=``/
    ``now=`` arguments, so replays are exact."""

    def __init__(self, policy: Optional[SLOPolicy] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.policy = policy if policy is not None else SLOPolicy()
        self._clock = clock if clock is not None else time.monotonic
        self._events: deque = deque()       # (t, good: bool)
        self.timeline: List[dict] = []      # fire/clear records
        self.alert_active = False
        self.n_good = 0
        self.n_bad = 0

    # -- ingestion --------------------------------------------------------
    def observe(self, good: bool, at: Optional[float] = None):
        """Record one classified request outcome."""
        t = self._clock() if at is None else float(at)
        self._events.append((t, bool(good)))
        if good:
            self.n_good += 1
        else:
            self.n_bad += 1
        # writer-side eviction past the slow window (burn computations
        # never look further back, and the deque stays bounded)
        cutoff = t - self.policy.slow_window_s
        while self._events and self._events[0][0] < cutoff:
            self._events.popleft()

    def observe_result(self, status: str = "ok", latency_s: float = 0.0,
                       ttft_s: float = 0.0,
                       deadline_s: Optional[float] = None,
                       failovers: int = 0,
                       at: Optional[float] = None) -> bool:
        """Classify via the policy and record; returns the verdict."""
        good = self.policy.is_good(status=status, latency_s=latency_s,
                                   ttft_s=ttft_s, deadline_s=deadline_s,
                                   failovers=failovers)
        self.observe(good, at=at)
        return good

    # -- burn math --------------------------------------------------------
    def _window_stats(self, window_s: float, now: float):
        cutoff = now - window_s
        n = bad = 0
        for t, good in self._events:
            if t >= cutoff:
                n += 1
                bad += not good
        return n, bad

    def burn_rates(self, now: Optional[float] = None) -> dict:
        """Current fast/slow burn rates: bad-fraction over each trailing
        window divided by the error budget (1 = spending exactly the
        allowed budget; an empty window burns 0)."""
        t = self._clock() if now is None else float(now)
        out = {"t_s": round(t, 6)}
        for label, win in (("fast", self.policy.fast_window_s),
                           ("slow", self.policy.slow_window_s)):
            n, bad = self._window_stats(win, t)
            frac = (bad / n) if n else 0.0
            out[f"{label}_n"] = n
            out[f"{label}_bad"] = bad
            out[f"{label}_burn"] = round(frac / self.policy.budget, 4)
        return out

    # -- alert evaluation -------------------------------------------------
    def tick(self, now: Optional[float] = None,
             telemetry=None) -> Optional[dict]:
        """Evaluate the alert condition; append a ``fire``/``clear``
        record to the timeline on a state change and return it (None
        when the state held). ``telemetry`` (a ServingTelemetry)
        annotates the record with live windowed percentiles."""
        t = self._clock() if now is None else float(now)
        rates = self.burn_rates(now=t)
        p = self.policy
        burning = (rates["fast_burn"] >= p.fast_burn_threshold
                   and rates["slow_burn"] >= p.slow_burn_threshold)
        event = None
        if burning and not self.alert_active:
            self.alert_active = True
            event = {"type": "fire", "slo": p.name,
                     "availability_target": p.availability_target, **rates}
        elif self.alert_active and not burning:
            self.alert_active = False
            event = {"type": "clear", "slo": p.name, **rates}
        if event is not None:
            if telemetry is not None:
                event["live"] = _live_percentiles(telemetry, now=t)
            self.timeline.append(event)
        return event

    @property
    def alerts_fired(self) -> int:
        return sum(e["type"] == "fire" for e in self.timeline)

    def report(self) -> dict:
        """Summary dict the harnesses embed in their reports."""
        return {
            "slo": self.policy.name,
            "availability_target": self.policy.availability_target,
            "n_good": self.n_good,
            "n_bad": self.n_bad,
            "alerts_fired": self.alerts_fired,
            "alert_active": self.alert_active,
            "timeline": list(self.timeline),
        }


def _live_percentiles(telemetry, now: Optional[float] = None) -> dict:
    """Windowed p50/p99 snapshot of the SLO histograms a page should
    carry (latency, TTFT) — tolerant of missing instruments so a bare
    registry annotates with whatever it has."""
    out = {}
    for key, name in (("latency", "ffsv_request_latency_seconds"),
                      ("ttft", "ffsv_request_ttft_seconds")):
        h = telemetry.registry.get(name)
        if h is None:
            continue
        w = h.windowed_percentiles(now=now) if h.window_s else {}
        if w.get("count"):
            out[key] = {"count": w["count"], "p50": round(w["p50"], 6),
                        "p99": round(w["p99"], 6)}
    return out


def replay_records(records: Sequence, policy: Optional[SLOPolicy] = None,
                   telemetry=None) -> SLOMonitor:
    """Feed finished loadgen ``RequestRecord``s through a fresh monitor
    in COMPLETION order on the records' own run-clock timestamps
    (``finished_s``), ticking after each — deterministic given the
    records, independent of when the analysis runs. Returns the monitor
    (``.report()`` is what the harnesses embed)."""
    mon = SLOMonitor(policy=policy, clock=lambda: 0.0)
    for r in sorted(records, key=lambda r: r.finished_s):
        mon.observe_result(status=r.status, latency_s=r.latency_s,
                           ttft_s=r.ttft_s, deadline_s=r.deadline_s,
                           failovers=getattr(r, "failovers", 0),
                           at=r.finished_s)
        mon.tick(now=r.finished_s, telemetry=telemetry)
    return mon
