"""Deterministic fault injection for the serving stack (counterpart of
``flexflow_tpu/serve/faultinject.py``).

The overload front door (serve/admission.py, timeouts/cancellation in
serve/request_manager.py, the failure paths in serve/api.py) is only
trustworthy if it survives the faults it claims to handle. This module
injects them ON PURPOSE, deterministically, and checks the one invariant
everything else reduces to:

    every submitted future resolves — success, rejection, timeout,
    cancellation, or error — within a bounded wall clock, and the
    request manager leaks nothing (no pending/inflight stragglers, no
    unreleased waiters).

Pieces:

* :class:`FaultInjector` — wraps a model's ``InferenceManager.step`` /
  ``decode_block`` with seeded modulo-counter faults: raise
  :class:`EngineFault` every ``error_every``-th device call (bounded by
  ``max_errors``) and/or stall ``stall_s`` every ``stall_every``-th.
  Counter-based, not clock-based, so runs replay exactly. The fused
  speculative engines drive their forwards themselves, so a speculative
  server meets the faults in its prefill steps, cramped steps and parked
  requests' decode blocks.
* :func:`check_invariants` — post-run leak audit of a serving handle.
* :func:`run_chaos` — the harness: concurrent submitters (some with
  timeouts), seeded mid-stream cancellations, optional admission bursts,
  a monitor that restarts the server after injected engine faults, and
  a final invariant audit. Returns a report dict; ``problems`` empty
  means the invariant held. Driven by ``flexflow_tpu_torch.tools.faulttest``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from flexflow_tpu_torch.serve.admission import RejectedError

__all__ = [
    "EngineFault",
    "FaultInjector",
    "check_invariants",
    "run_chaos",
]


class EngineFault(RuntimeError):
    """The injected engine-step failure (stands in for a device OOM, a
    kernel launch failure, a lost card, ...)."""


class FaultInjector:
    """Seeded, counter-deterministic fault source.

    ``error_every=N`` raises :class:`EngineFault` on every N-th wrapped
    device call (at most ``max_errors`` times total, so a harness that
    restarts the server always converges). ``stall_every=N`` sleeps
    ``stall_s`` on every N-th call — long enough to trip request
    deadlines without stopping the loop. Both zero = transparent.
    """

    def __init__(self, error_every: int = 0, stall_every: int = 0,
                 stall_s: float = 0.01, max_errors: int = 1):
        self.error_every = int(error_every)
        self.stall_every = int(stall_every)
        self.stall_s = float(stall_s)
        self.max_errors = int(max_errors)
        self.n_calls = 0
        self.n_errors = 0
        self.n_stalls = 0
        self._installed: List[tuple] = []
        self._lock = threading.Lock()

    # -- the fault point --------------------------------------------------
    def _tick(self):
        with self._lock:
            self.n_calls += 1
            n = self.n_calls
            fire_err = (self.error_every and n % self.error_every == 0
                        and self.n_errors < self.max_errors)
            if fire_err:
                self.n_errors += 1
            fire_stall = self.stall_every and n % self.stall_every == 0
            if fire_stall:
                self.n_stalls += 1
        if fire_stall:
            time.sleep(self.stall_s)
        if fire_err:
            raise EngineFault(
                f"injected engine fault #{self.n_errors} (call {n})")

    # -- install/uninstall ------------------------------------------------
    def install(self, model) -> "FaultInjector":
        """Wrap ``model``'s InferenceManager step entry points. Creates
        the manager if the model has none yet (the generation loops
        reuse a pre-existing ``_inference_manager``)."""
        from flexflow_tpu_torch.serve.inference_manager import InferenceManager

        ifm = getattr(model, "_inference_manager", None)
        if ifm is None:
            ifm = model._inference_manager = InferenceManager(model)
        orig_step, orig_decode = ifm.step, ifm.decode_block

        def step(*a, **k):
            self._tick()
            return orig_step(*a, **k)

        def decode_block(*a, **k):
            self._tick()
            return orig_decode(*a, **k)

        ifm.step = step
        ifm.decode_block = decode_block
        self._installed.append((ifm, orig_step, orig_decode))
        return self

    def uninstall(self):
        for ifm, orig_step, orig_decode in self._installed:
            ifm.step = orig_step
            ifm.decode_block = orig_decode
        self._installed.clear()


def check_invariants(handle) -> List[str]:
    """Leak audit after a (chaotic) serving run. Returns human-readable
    problem strings; empty list = slot table / waiters clean.

    Accepts a single engine handle or a replica pool: anything exposing
    ``replicas`` (serve/replica.py) is audited per live replica — each
    surviving engine's slot tables must be clean, plus the
    pool's own entry table and waiter list — with problem strings
    prefixed by the replica id."""
    reps = getattr(handle, "replicas", None)
    if reps is not None:
        problems = []
        for rep in reps:
            if not (rep.alive and rep.handle is not None):
                continue
            problems.extend(f"replica {rep.id}: {p}"
                            for p in check_invariants(rep.handle))
        if getattr(handle, "_entries", None):
            problems.append(
                f"pool: {len(handle._entries)} entry(ies) still tracked")
        if getattr(handle, "_waiters", None):
            problems.append(
                f"pool: {len(handle._waiters)} unreleased waiter(s)")
        return problems
    problems = []
    rm = handle.rm
    if rm.pending:
        problems.append(f"{len(rm.pending)} request(s) still pending")
    stuck = [g for g, r in rm.inflight.items() if not r.finished]
    if stuck:
        problems.append(f"unfinished inflight requests: {stuck}")
    srv = getattr(handle, "_server", None)
    if srv is not None and srv._waiters:
        problems.append(f"{len(srv._waiters)} unreleased waiter(s)")
    return problems


def run_chaos(handle, n_requests: int = 16, seed: int = 0,
              injector: Optional[FaultInjector] = None,
              prompt_len: int = 4, max_new_tokens: int = 8,
              vocab: int = 128, cancel_fraction: float = 0.25,
              timeout_fraction: float = 0.25, timeout_s: float = 0.05,
              admission=None, resolve_bound_s: float = 120.0,
              restart_on_fault: bool = True) -> Dict:
    """The chaos harness: throw faulty traffic at a serving handle and
    verify every future resolves within ``resolve_bound_s``.

    Deterministic given ``seed``: prompts, which requests get a tiny
    ``timeout_s``, and which are cancelled mid-stream are all drawn up
    front from one RandomState. Submissions run on concurrent threads
    (queue-full bursts when ``admission`` bounds the door); a monitor
    restarts the server when an injected :class:`EngineFault` kills the
    loop (the injector's ``max_errors`` bounds how often). Ends with a
    :func:`check_invariants` audit.
    """
    rng = np.random.RandomState(seed)
    plan = []
    for i in range(n_requests):
        plan.append({
            "idx": i,
            "prompt": [int(t) for t in rng.randint(1, vocab,
                                                   size=prompt_len)],
            "timeout_s": (timeout_s if rng.rand() < timeout_fraction
                          else None),
            "cancel_after_s": (0.01 + 0.03 * rng.rand()
                               if rng.rand() < cancel_fraction else None),
        })
    if getattr(handle, "_server", None) is None:
        handle.start_server(admission=admission)
    rm = handle.rm
    statuses: Dict[int, str] = {}
    lock = threading.Lock()
    stop_monitor = threading.Event()
    restarts = [0]
    t0 = time.perf_counter()

    def monitor():
        # restart the serving loop when an injected fault kills it —
        # the satellite contract: a server death fails the in-flight
        # futures with the error AND leaves the stack restartable
        while not stop_monitor.is_set():
            srv = getattr(handle, "_server", None)
            if srv is not None and srv._error is not None:
                handle.stop_server(flush_timeout_s=resolve_bound_s)
                if restart_on_fault:
                    handle.start_server(admission=admission)
                    restarts[0] += 1
                else:
                    return
            stop_monitor.wait(0.01)

    def submit_one(p):
        deadline = time.monotonic() + resolve_bound_s
        while True:
            if time.monotonic() > deadline:
                with lock:
                    statuses[p["idx"]] = "unresolved"
                return
            srv = getattr(handle, "_server", None)
            if srv is None:
                # between a fault-driven stop and the monitor's restart
                time.sleep(0.02)
                continue
            try:
                guids, ev = srv.submit(
                    [p["prompt"]], max_new_tokens, 0,
                    timeout_s=p["timeout_s"])
            except RejectedError:
                with lock:
                    statuses[p["idx"]] = "rejected"
                return
            except RuntimeError:
                # server dying/restarting under us: back off and retry
                time.sleep(0.02)
                continue
            if p["cancel_after_s"] is not None:
                threading.Timer(p["cancel_after_s"], rm.cancel,
                                [guids[0]]).start()
            if not ev.wait(timeout=max(0.0,
                                       deadline - time.monotonic())):
                with lock:
                    statuses[p["idx"]] = "unresolved"
                return
            res = rm.results.get(guids[0])
            with lock:
                statuses[p["idx"]] = (res.status if res is not None
                                      else "unresolved")
            return

    mon = threading.Thread(target=monitor, daemon=True)
    mon.start()
    threads = [threading.Thread(target=submit_one, args=(p,), daemon=True)
               for p in plan]
    for t in threads:
        t.start()
    for t in threads:
        t.join(resolve_bound_s)
    stop_monitor.set()
    mon.join(5.0)
    if injector is not None:
        injector.uninstall()
    handle.stop_server(flush_timeout_s=resolve_bound_s)
    wall_s = time.perf_counter() - t0
    by_status: Dict[str, int] = {}
    for s in statuses.values():
        by_status[s] = by_status.get(s, 0) + 1
    problems = check_invariants(handle)
    missing = n_requests - len(statuses)
    if missing:
        problems.append(f"{missing} submission(s) never reported")
    if by_status.get("unresolved"):
        problems.append(
            f"{by_status['unresolved']} future(s) unresolved within "
            f"{resolve_bound_s}s")
    # flight-recorder contract (pool handles): every crash the monitor
    # detected must have produced a PARSEABLE incident report
    incident_reports = list(getattr(handle, "incident_reports", None) or ())
    if incident_reports:
        from flexflow_tpu_torch.telemetry.flight_recorder import \
            load_incident_report
        for path in incident_reports:
            try:
                load_incident_report(path)
            except (OSError, ValueError) as err:
                problems.append(f"incident report {path}: {err}")
    return {
        "incident_reports": incident_reports,
        "n_requests": n_requests,
        "statuses": by_status,
        "resolved_fraction": round(
            sum(v for k, v in by_status.items() if k != "unresolved")
            / max(1, n_requests), 4),
        "restarts": restarts[0],
        "wall_s": round(wall_s, 3),
        "injector": (None if injector is None else {
            "n_calls": injector.n_calls,
            "n_errors": injector.n_errors,
            "n_stalls": injector.n_stalls,
        }),
        "problems": problems,
    }
