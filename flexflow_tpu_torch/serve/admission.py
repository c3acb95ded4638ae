"""Admission control + backpressure for the serving front door
(counterpart of ``flexflow_tpu/serve/admission.py``, stdlib only, copied
as it is apart from its imports).

The submission queue in ``serve/api.py`` used to be unbounded: past the
saturation knee (the point ``serve/loadgen.py`` can now measure), queue
depth and tail latency grow without bound and every tenant starves
together. This module is the bounded front door (ROADMAP item 2,
robustness half): a pure policy object consulted under the server's
submission lock, rejecting with a structured 429-style
:class:`RejectedError` instead of queueing forever.

Three independent admission checks, all cheap enough for the submit path:

* **Queue depth bound** (``max_queue_depth``): reject once the number of
  registered-but-unslotted requests reaches the limit. This is the hard
  backstop — with it, queue depth (and therefore queue-wait) is bounded
  no matter what the arrival process does.
* **Estimated-wait bound** (``max_estimated_wait_s``): reject while the
  live windowed queue-wait p99 — realized slot-grant waits the server
  feeds back via :meth:`AdmissionController.observe_queue_wait` —
  exceeds the bound. Depth alone mis-sizes when request service times
  vary; realized waits track the knee directly.
* **Per-tenant weighted token buckets** (``tenant_rates``): each tenant
  refills admission credits at its own rate, so one tenant's burst
  cannot starve the rest — the classic weighted-fair front door.

Rejections carry ``retry_after_s`` derived from the same windowed
queue-wait p99 (or the bucket refill deficit, whichever the binding
constraint was), so well-behaved clients back off by exactly the time
the live system says a slot takes.

Everything is deterministic given an injectable ``clock`` — the policy
math is unit-tested with a fake clock in
tests/test_torch_admission_loadgen.py, against the JAX package's.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, Mapping, Optional, Tuple

from flexflow_tpu_torch.telemetry.metrics import percentile

__all__ = [
    "AdmissionController",
    "AdmissionPolicy",
    "RejectedError",
]


class RejectedError(RuntimeError):
    """Structured admission rejection (HTTP 429 semantics).

    ``reason`` is one of ``"queue_full"``, ``"wait_bound"``,
    ``"tenant_rate"``; ``retry_after_s`` is the live backoff hint
    (windowed queue-wait p99, or the token-bucket refill deficit);
    ``queue_depth`` is the depth observed at rejection time.
    """

    def __init__(self, reason: str, retry_after_s: float = 0.0,
                 queue_depth: int = 0, tenant: str = "default"):
        super().__init__(
            f"admission rejected ({reason}): tenant={tenant!r} "
            f"queue_depth={queue_depth} retry_after={retry_after_s:.3f}s")
        self.reason = reason
        self.retry_after_s = retry_after_s
        self.queue_depth = queue_depth
        self.tenant = tenant


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Front-door limits. ``tenant_rates`` maps tenant name to
    ``(rate_rps, burst)`` — a token bucket refilling ``rate_rps``
    admission credits per second with capacity ``burst``. Tenants not
    listed use ``default_rate`` (None = unlimited). ``window_s`` bounds
    the queue-wait sample window the retry-after/wait estimates read."""

    max_queue_depth: int = 64
    max_estimated_wait_s: Optional[float] = None
    tenant_rates: Mapping[str, Tuple[float, float]] = \
        dataclasses.field(default_factory=dict)
    default_rate: Optional[Tuple[float, float]] = None
    window_s: float = 60.0
    min_retry_after_s: float = 0.05


class _TokenBucket:
    __slots__ = ("rate", "burst", "level", "last_s")

    def __init__(self, rate: float, burst: float, now: float):
        assert rate > 0 and burst > 0, (rate, burst)
        self.rate = float(rate)
        self.burst = float(burst)
        self.level = float(burst)          # start full: bursts admit
        self.last_s = now

    def take(self, n: float, now: float) -> float:
        """Try to take ``n`` credits. Returns 0.0 on success, else the
        seconds until the bucket will have refilled enough."""
        self.level = min(self.burst,
                         self.level + (now - self.last_s) * self.rate)
        self.last_s = now
        if self.level >= n:
            self.level -= n
            return 0.0
        return (n - self.level) / self.rate


class AdmissionController:
    """Stateful mediator between the policy and the live server.

    Thread-safety: ``admit``/``observe_queue_wait`` are called under the
    background server's submission lock (serve/api.py), so no internal
    locking is needed; standalone users should serialize calls.
    """

    def __init__(self, policy: Optional[AdmissionPolicy] = None,
                 clock=time.perf_counter):
        self.policy = policy or AdmissionPolicy()
        self._clock = clock
        now = clock()
        self._buckets: Dict[str, _TokenBucket] = {
            name: _TokenBucket(rate, burst, now)
            for name, (rate, burst) in self.policy.tenant_rates.items()}
        self._waits: deque = deque()       # (t, queue_wait_s) samples
        self.n_admitted = 0
        self.n_rejected = 0
        self.rejects_by_reason: Dict[str, int] = {}
        self.peak_queue_depth = 0

    # -- live feedback ---------------------------------------------------
    def observe_queue_wait(self, wait_s: float,
                           now: Optional[float] = None):
        """Feed one realized admission->slot-grant wait (the server calls
        this for every finished request's ``queue_wait_s``)."""
        now = self._clock() if now is None else now
        self._waits.append((now, float(wait_s)))
        self._trim(now)

    def _trim(self, now: float):
        horizon = now - self.policy.window_s
        while self._waits and self._waits[0][0] < horizon:
            self._waits.popleft()

    def queue_wait_p99(self, now: Optional[float] = None) -> float:
        """Exact p99 of queue waits observed in the trailing window; 0.0
        with no samples yet (cold start admits optimistically)."""
        now = self._clock() if now is None else now
        self._trim(now)
        if not self._waits:
            return 0.0
        return percentile(sorted(w for _, w in self._waits), 99)

    def retry_after_s(self, now: Optional[float] = None) -> float:
        return max(self.queue_wait_p99(now), self.policy.min_retry_after_s)

    # -- the admission decision ------------------------------------------
    def admit(self, tenant: str, queue_depth: int, n: int = 1,
              now: Optional[float] = None):
        """Admit ``n`` requests for ``tenant`` at the given submission
        queue depth, or raise :class:`RejectedError`. Token-bucket
        credits are only consumed when every check passes."""
        now = self._clock() if now is None else now
        self.peak_queue_depth = max(self.peak_queue_depth, queue_depth)
        pol = self.policy
        if queue_depth + n > pol.max_queue_depth:
            self._reject("queue_full", queue_depth, tenant,
                         self.retry_after_s(now))
        if pol.max_estimated_wait_s is not None:
            est = self.queue_wait_p99(now)
            if est > pol.max_estimated_wait_s:
                self._reject("wait_bound", queue_depth, tenant,
                             max(est, pol.min_retry_after_s))
        bucket = self._buckets.get(tenant)
        if bucket is None and pol.default_rate is not None:
            bucket = self._buckets[tenant] = _TokenBucket(
                *pol.default_rate, now=now)
        if bucket is not None:
            deficit_s = bucket.take(n, now)
            if deficit_s > 0.0:
                self._reject("tenant_rate", queue_depth, tenant,
                             max(deficit_s, pol.min_retry_after_s))
        self.n_admitted += n

    def _reject(self, reason: str, queue_depth: int, tenant: str,
                retry_after_s: float):
        self.n_rejected += 1
        self.rejects_by_reason[reason] = \
            self.rejects_by_reason.get(reason, 0) + 1
        raise RejectedError(reason, retry_after_s=retry_after_s,
                            queue_depth=queue_depth, tenant=tenant)

    def stats(self) -> dict:
        return {
            "n_admitted": self.n_admitted,
            "n_rejected": self.n_rejected,
            "rejects_by_reason": dict(self.rejects_by_reason),
            "peak_queue_depth": self.peak_queue_depth,
            "queue_wait_p99_s": round(self.queue_wait_p99(), 4),
        }
