"""Replica pool: N serving engines behind one front door, with crash
failover and measured cold start (counterpart of
``flexflow_tpu/serve/replica.py``).

The single server is overload-safe (admission, timeouts, preemption,
fault injection); this module is the fleet layer on top. A
:class:`ReplicaPool` owns N logical replicas — each a full engine handle
(its own FFModel on the card, RequestManager and ``_BackgroundServer``)
— and presents the SAME submission surface as a single handle (``.rm`` /
``._server.submit`` / ``start_server`` / ``stop_server``), so
:class:`~flexflow_tpu_torch.serve.loadgen.LoadRunner` and
``check_invariants`` drive a fleet exactly the way they drive one
engine. The replicas of one process share its card (each is a model of
its own on it): the pool is about crash isolation and elastic capacity,
and failover moves requests between replicas, never to the CPU.

Design points:

* **One admission controller at the pool door.** Replica servers run
  with ``admission=None``; the shared controller sees the AGGREGATE
  queue depth and its windowed queue-wait p99 is fed from pool-level
  waits. Per-replica admission would let a crashed replica's capacity
  vanish without the front door noticing.
* **Crash detection + failover.** A monitor thread watches each
  replica's server; when an engine dies (e.g. a seeded
  :class:`~flexflow_tpu_torch.serve.faultinject.FaultInjector` fault), the
  server's ``abort_outstanding`` has already resolved that replica's
  in-flight AND queued requests with ``status="error"`` — the pool
  intercepts those terminal errors and RE-DISPATCHES each request to a
  surviving replica (full re-prefill, so the completion is
  token-identical to an undisturbed run), counting ``failovers`` on the
  final result. Every pool future still resolves: the single server's
  invariant audit holds at fleet scope.
* **Honest SLO attribution.** A failed-over request's time on the dead
  replica is wait, not service:
  :func:`~flexflow_tpu_torch.serve.loadgen.attribute_failover_wait` splits the
  pool-level latency so per-replica service p99s stay meaningful.
* **Measured cold start.** Replacement replicas (and autoscale
  spin-ups) are built by the pool's ``factory`` — typically
  :func:`checkpoint_replica_factory`, which cold-starts from the
  HF-layout disk checkpoint store
  (``models/checkpoint_store.py``) with optional quantize-on-load. The
  build+load+start wall time is recorded per replica as
  ``cold_start_s`` — the number an autoscaler actually pays, measured
  (not guessed) by ``chip_smoke.py``'s phase 12b on the card.
* **Autoscaling loop.** :func:`spike_run` drives a base->spike traffic
  step through the pool while a queue-depth trigger spins up an extra
  replica mid-spike, and reports the SLO-violation-seconds absorbed
  during scale-out next to the measured ``cold_start_s``.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, List, Optional, Sequence

from flexflow_tpu_torch.serve.loadgen import (LoadRunner, WorkloadSpec,
                                        attribute_failover_wait,
                                        build_schedule, summarize)
from flexflow_tpu_torch.serve.request_manager import (GenerationResult,
                                                RequestManager)
from flexflow_tpu_torch.telemetry import mint_trace_id

__all__ = [
    "Replica",
    "ReplicaPool",
    "checkpoint_replica_factory",
    "failover_run",
    "spike_run",
]


# ---------------------------------------------------------------------------
# replica factories
# ---------------------------------------------------------------------------

def checkpoint_replica_factory(checkpoint_dir: str, slots: int = 2,
                               max_seq: int = 64,
                               quantize: Optional[str] = None,
                               seed_base: int = 7000,
                               warmup: bool = True,
                               device: str = "cuda") -> Callable:
    """Factory building one replica engine from a disk checkpoint.

    This is the production-shaped cold-start path the pool measures:
    read ``config.json`` -> build the family graph -> initialize it on
    ``device`` -> load the HF-layout weights
    (``checkpoint_store.load_checkpoint_into``, optionally quantizing on
    load) -> warm up the prefill and decode path with one throwaway
    request (first-use costs: the CUDA kernels' loading and the
    allocator's first blocks, charged to the cold start, not to an
    unlucky production request). The per-replica FFConfig seed differs
    (seed_base + replica id) so a replica's token-identity to the others
    comes from the CHECKPOINT, never from a shared init seed.

    ``device`` (the one argument the JAX factory lacks: the port's device
    is explicit) defaults to ``"cuda"``; a replica built for CUDA where
    CUDA is missing raises (``config.resolve_device``)."""
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.core.model import FFModel
    from flexflow_tpu_torch.ffconst import InferenceMode
    from flexflow_tpu_torch.models import family_for_hf_config
    from flexflow_tpu_torch.models.checkpoint_store import (
        load_checkpoint_into, read_checkpoint_config)
    from flexflow_tpu_torch.serve.loadgen import EngineHandle

    def factory(replica_id: int):
        cfg_dict = read_checkpoint_config(checkpoint_dir)
        fam = family_for_hf_config(cfg_dict)
        mcfg = fam.config_cls.from_hf_config(cfg_dict)
        cfg = FFConfig(device=device, max_requests_per_batch=slots,
                       max_sequence_length=max_seq,
                       max_tokens_per_batch=max(16, 4 * slots),
                       seed=seed_base + replica_id,
                       kv_cache_dtype="float32")
        model = FFModel(cfg)
        fam.build(model, mcfg, mode=InferenceMode.INC_DECODING_MODE)
        model.compile()
        load_checkpoint_into(model, checkpoint_dir, quantize=quantize)
        if warmup:
            warm_rm = RequestManager()
            warm_rm.register_new_request([1, 2], max_new_tokens=2)
            warm_rm.generate_incr_decoding(model)
        return EngineHandle(model)

    return factory


# ---------------------------------------------------------------------------
# pool internals
# ---------------------------------------------------------------------------

class Replica:
    """One pool slot: id + current engine handle + health/cold-start
    bookkeeping. ``handle`` is an ``EngineHandle``/``LLM``; ``None``
    between a crash and the respawned replacement attaching."""

    def __init__(self, replica_id: int):
        self.id = replica_id
        self.handle = None
        self.alive = False
        self.crashes = 0
        self.cold_start_s: Optional[float] = None

    @property
    def server(self):
        return getattr(self.handle, "_server", None)

    def __repr__(self):
        state = "alive" if self.alive else "down"
        return f"Replica({self.id}, {state}, crashes={self.crashes})"


@dataclasses.dataclass
class _Entry:
    """Pool-level bookkeeping for one submitted request. ``guid`` is the
    pool-visible id, minted from the RequestManager's global counter so
    it can never collide with a replica-level guid; each (re)dispatch
    registers a fresh ``cur_guid`` on its replica while the pool result
    keeps ``guid``. An entry with ``retry_pending`` has no live dispatch
    — it is buffered at the pool door until a replica is healthy (the
    every-future-resolves invariant survives a whole-fleet outage: the
    respawned replica drains the buffer)."""

    guid: int
    prompt: List[int]
    max_new_tokens: int
    max_length: int
    tenant: str
    priority: int
    t_submit: float
    deadline: Optional[float]          # absolute, pool clock
    replica: Optional[Replica] = None
    cur_guid: Optional[int] = None
    failovers: int = 0
    finished: bool = False
    retry_pending: bool = True         # no live dispatch yet
    cancel_requested: bool = False
    # fleet-wide correlation id, minted ONCE at the pool door; every
    # (re)dispatch registers it on the target replica, so the request's
    # spans on a crashed replica and on its failover survivor join under
    # the same id in the stitched Chrome trace
    trace_id: str = ""


class _PendingProxy:
    """``rm.pending`` facade over all replicas (LoadRunner purges it on
    timeout; check_invariants counts it)."""

    def __init__(self, pool: "ReplicaPool"):
        self._pool = pool

    def _reps(self):
        return [r for r in self._pool.replicas
                if r.alive and r.handle is not None]

    def __len__(self):
        return sum(len(r.handle.rm.pending) for r in self._reps())

    def __bool__(self):
        return len(self) > 0

    def clear(self):
        for r in self._reps():
            r.handle.rm.pending.clear()


class _PoolRM:
    """RequestManager facade at pool scope: pool-level results/inflight,
    pending aggregated across replicas, cancel forwarded to wherever the
    request currently runs. Quacks enough for LoadRunner and
    ``faultinject.check_invariants``."""

    def __init__(self, pool: "ReplicaPool"):
        self._pool = pool
        self.results = {}
        self.inflight = {}             # guid -> _Entry (popped on finish)
        self.pending = _PendingProxy(pool)

    def cancel(self, guid: int) -> bool:
        with self._pool._work:
            e = self.inflight.get(guid)
            if e is None or e.finished:
                return False
            e.cancel_requested = True
            rep = e.replica
            if rep is not None and rep.alive and rep.handle is not None:
                rep.handle.rm.cancel(e.cur_guid)
            return True


class ReplicaPool:
    """N replicas behind one submission front door (see module docs).

    ``factory(replica_id) -> handle`` builds one engine (not yet
    started); the pool measures every factory call as that replica's
    ``cold_start_s``. ``admission`` is the SHARED front-door controller
    (an ``AdmissionPolicy`` or ``AdmissionController``); replicas run
    admission-free behind it.

    ``telemetry`` is a
    :class:`~flexflow_tpu_torch.telemetry.fleet.FleetTelemetry`: each replica's
    RequestManager gets its per-replica ServingTelemetry (own Chrome-trace
    pid row, registry, flight-recorder ring) BEFORE its server starts,
    and on a crash the monitor dumps the dead replica's flight ring as an
    incident report under ``incident_dir`` (defaults to the fleet's
    ``trace_dir``), appending the path to ``incident_reports``."""

    def __init__(self, factory: Callable, n_replicas: int = 2,
                 admission=None, max_failovers: int = 3,
                 respawn: bool = True, poll_interval_s: float = 0.002,
                 clock=time.perf_counter, telemetry=None,
                 incident_dir: Optional[str] = None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        self._factory = factory
        self._clock = clock
        self.max_failovers = int(max_failovers)
        self.respawn = bool(respawn)
        self.poll_interval_s = float(poll_interval_s)
        self.admission = None
        self._pending_admission = admission
        self.replicas: List[Replica] = [Replica(i) for i in range(n_replicas)]
        self.rm = _PoolRM(self)
        self._work = threading.Condition()
        self._waiters: List = []       # (remaining-guid-set, event)
        self._error: Optional[BaseException] = None
        self._server = None            # self while started (handle duck type)
        self._started = False
        self._stopping = False
        self._loop_thread: Optional[threading.Thread] = None
        self._respawn_threads: List[threading.Thread] = []
        self._rr = 0                   # round-robin cursor
        self._entries = {}             # guid -> _Entry (unfinished only)
        self._cold_starts: List[float] = []
        self._failover_events: List[dict] = []
        self._failovers_total = 0
        self._dirty_shutdowns = 0
        self.telemetry = telemetry     # FleetTelemetry (or None: untraced)
        self.incident_dir = incident_dir
        self.incident_reports: List[str] = []
        self._incident_seq = 0

    # -- lifecycle ----------------------------------------------------------

    def _build_replica(self, rep: Replica):
        t0 = self._clock()
        handle = self._factory(rep.id)
        if self.telemetry is not None:
            handle.rm.telemetry = self.telemetry.for_replica(rep.id)
        handle.start_server()          # admission=None: pool door decides
        rep.cold_start_s = self._clock() - t0
        self._cold_starts.append(rep.cold_start_s)
        rep.handle = handle
        rep.alive = True
        return rep

    def start_server(self, admission=None):
        from flexflow_tpu_torch.serve.admission import (AdmissionController,
                                                  AdmissionPolicy)

        if self._started:
            return self
        ctrl = admission if admission is not None else self._pending_admission
        if isinstance(ctrl, AdmissionPolicy):
            ctrl = AdmissionController(ctrl)
        self.admission = ctrl
        for rep in self.replicas:
            if rep.handle is None:
                self._build_replica(rep)
            elif rep.server is None:
                if self.telemetry is not None:
                    rep.handle.rm.telemetry = \
                        self.telemetry.for_replica(rep.id)
                rep.handle.start_server()
                rep.alive = True
        self._stopping = False
        self._error = None
        self._started = True
        self._server = self
        self._loop_thread = threading.Thread(
            target=self._loop, daemon=True, name="flexflow-pool")
        self._loop_thread.start()
        return self

    def stop_server(self, flush_timeout_s: Optional[float] = 30.0):
        if not self._started:
            return self
        with self._work:
            self._stopping = True
            self._work.notify_all()
        bound = flush_timeout_s if flush_timeout_s is not None else 30.0
        self._loop_thread.join(bound)
        if self._loop_thread.is_alive():
            # flush window expired: cancel stragglers (reaped between
            # decode rounds) and give the loop one more bounded join
            with self._work:
                for e in list(self._entries.values()):
                    if not e.finished:
                        self.rm.cancel(e.guid)
            self._loop_thread.join(bound)
        for t in self._respawn_threads:
            t.join(bound)
        self._respawn_threads.clear()
        for rep in self.replicas:
            if rep.handle is not None:
                try:
                    rep.handle.stop_server(flush_timeout_s)
                except Exception:
                    self._dirty_shutdowns += 1
            rep.alive = False
        with self._work:
            # every pool waiter resolves, even on an unclean flush
            for _, ev in self._waiters:
                ev.set()
            self._waiters.clear()
        self._started = False
        self._server = None
        return self

    # -- submission front door ----------------------------------------------

    def queue_depth(self) -> int:
        depth = len(self.rm.pending)
        depth += sum(1 for e in self._entries.values() if e.retry_pending)
        return depth

    def outstanding(self) -> int:
        """Unfinished pool requests (queued + in a batch slot). The
        autoscale trigger compares this against serving capacity:
        ``pending`` alone drains to the slot tables the moment a batch
        forms, so it under-reads sustained overload between samples."""
        return len(self._entries)

    def _pick_replica(self, exclude: Optional[Replica] = None
                      ) -> Optional[Replica]:
        alive = [r for r in self.replicas
                 if r.alive and r.handle is not None and r is not exclude]
        if not alive:
            return None
        self._rr += 1
        return alive[self._rr % len(alive)]

    def submit(self, prompts, max_new_tokens: int, max_length: int,
               timeout_s: Optional[float] = None, tenant: str = "default",
               priority: int = 0):
        ev = threading.Event()
        with self._work:
            if self._error is not None:
                raise RuntimeError("pool loop died") from self._error
            if self._stopping or not self._started:
                raise RuntimeError(
                    "pool is stopping/stopped; submit raced stop_server()")
            if self.admission is not None:
                self.admission.admit(tenant, self.queue_depth(),
                                     n=len(prompts))
            now = self._clock()
            guids = []
            for prompt in prompts:
                e = self._dispatch_new(list(prompt), max_new_tokens,
                                       max_length, timeout_s, tenant,
                                       priority, now)
                guids.append(e.guid)
            self._waiters.append((set(guids), ev))
            self._work.notify_all()
        return guids, ev

    def _dispatch_new(self, prompt, max_new_tokens, max_length, timeout_s,
                      tenant, priority, now) -> _Entry:
        deadline = None if timeout_s is None else now + float(timeout_s)
        e = _Entry(guid=next(RequestManager._guid_counter), prompt=prompt,
                   max_new_tokens=max_new_tokens, max_length=max_length,
                   tenant=tenant, priority=priority, t_submit=now,
                   deadline=deadline, trace_id=mint_trace_id())
        self._entries[e.guid] = e
        self.rm.inflight[e.guid] = e
        # whole fleet down (mid-respawn): the entry buffers at the pool
        # door (retry_pending) and the monitor loop places it as soon as
        # a replica is healthy
        self._try_dispatch(e, now)
        return e

    def _try_dispatch(self, e: _Entry, now: float,
                      exclude: Optional[Replica] = None) -> bool:
        """Place ``e`` on a healthy replica. A placement after a previous
        dispatch is a failover (counted); no target leaves the entry
        buffered with ``retry_pending``."""
        remaining = (None if e.deadline is None
                     else max(0.01, e.deadline - now))
        redispatch = e.cur_guid is not None
        prev_id = e.replica.id if e.replica is not None else -1
        for _ in range(max(1, len(self.replicas))):
            target = self._pick_replica(exclude=exclude)
            if target is None:
                # buffered: drop the stale replica ref so a later retry
                # may land on ANY healthy replica — including this one's
                # own respawn (same Replica object, fresh engine)
                e.retry_pending = True
                e.replica = None
                return False
            try:
                rg, _ = target.handle._server.submit(
                    [e.prompt], e.max_new_tokens, e.max_length,
                    timeout_s=remaining, tenant=e.tenant,
                    priority=e.priority, trace_id=e.trace_id,
                    failovers=e.failovers + (1 if redispatch else 0))
            except RuntimeError:       # replica died under us: next one
                target.alive = False
                continue
            e.cur_guid = rg[0]
            e.replica = target
            e.retry_pending = False
            if redispatch:
                e.failovers += 1
                self._failovers_total += 1
                if self.telemetry is not None:
                    # recorded on the SURVIVOR: the dead replica's ring
                    # is (being) dumped as the incident report
                    self.telemetry.for_replica(target.id).note_failover(
                        e.guid, prev_id, target.id, trace_id=e.trace_id)
            if e.cancel_requested:
                target.handle.rm.cancel(e.cur_guid)
            return True
        e.retry_pending = True
        e.replica = None
        return False

    # -- monitor / failover loop --------------------------------------------

    def _loop(self):
        try:
            while True:
                with self._work:
                    if self._stopping and not self._entries:
                        for _, ev in self._waiters:
                            ev.set()
                        self._waiters.clear()
                        return
                    now = self._clock()
                    for rep in self.replicas:
                        srv = rep.server
                        if rep.alive and srv is not None \
                                and srv._error is not None:
                            self._handle_crash(rep, now)
                    for e in list(self._entries.values()):
                        if e.finished:
                            continue
                        if e.retry_pending:
                            if e.cancel_requested:
                                self._finalize(e, GenerationResult(
                                    guid=e.guid,
                                    input_tokens=list(e.prompt),
                                    output_tokens=[], status="cancelled",
                                    cancelled=True, tenant=e.tenant,
                                    trace_id=e.trace_id), now)
                            else:
                                self._redispatch(e, None, None, now)
                            continue
                        rep = e.replica
                        if rep is None or rep.handle is None:
                            e.retry_pending = True
                            continue
                        res = rep.handle.rm.results.get(e.cur_guid)
                        if res is None:
                            continue
                        if res.status == "error" and not e.cancel_requested:
                            self._redispatch(e, res, res.error, now)
                        else:
                            self._finalize(e, res, now)
                    self._fire_waiters()
                time.sleep(self.poll_interval_s)
        except BaseException as err:           # pool loop must not die silent
            with self._work:
                self._error = err
                for _, ev in self._waiters:
                    ev.set()
                self._waiters.clear()
            raise

    def _handle_crash(self, rep: Replica, now: float):
        """An engine died: its server already failed every in-flight and
        queued request (``abort_outstanding``) — sweep those terminal
        errors into failovers NOW (while the dead rm is still readable),
        then detach the handle and respawn from the checkpoint store."""
        rep.crashes += 1
        rep.alive = False
        err = rep.server._error if rep.server is not None else None
        old = rep.handle
        mine = [e for e in self._entries.values()
                if not e.finished and e.replica is rep]
        if mine:
            self._failover_events.append({
                "t_detect": now, "replica": rep.id,
                "waiting": {e.guid for e in mine},
                "n_requests": len(mine), "recovery_s": None})
        self._dump_incident(rep, now, err, n_waiting=len(mine))
        for e in mine:
            res = old.rm.results.get(e.cur_guid) if old is not None else None
            self._redispatch(e, res, err, now)
        rep.handle = None
        if old is not None:
            try:
                old.stop_server(flush_timeout_s=1.0)
            except Exception:
                self._dirty_shutdowns += 1
        if self.respawn and not self._stopping:
            t = threading.Thread(target=self._respawn_replica, args=(rep,),
                                 daemon=True,
                                 name=f"flexflow-respawn-{rep.id}")
            t.start()
            self._respawn_threads.append(t)

    def _dump_incident(self, rep: Replica, now: float, err,
                       n_waiting: int):
        """Write the crashed replica's flight-recorder ring as an
        incident report (telemetry/flight_recorder.py JSONL format) —
        the what-was-it-doing-before-it-died artifact
        ``faultinject.run_chaos`` asserts is produced and parseable."""
        if self.telemetry is None:
            return
        out_dir = self.incident_dir or self.telemetry.trace_dir
        if not out_dir:
            return
        self._incident_seq += 1
        path = os.path.join(
            out_dir, f"incident_r{rep.id}_{self._incident_seq}.jsonl")
        try:
            os.makedirs(out_dir, exist_ok=True)
            self.telemetry.for_replica(rep.id).flight.dump(path, header={
                "replica": rep.id, "t_detect_s": round(now, 6),
                "error": (f"{type(err).__name__}: {err}"
                          if err is not None else ""),
                "n_waiting": n_waiting, "crashes": rep.crashes})
        except Exception:
            self._dirty_shutdowns += 1
            return
        self.incident_reports.append(path)

    def _respawn_replica(self, rep: Replica):
        """Cold-start a replacement OFF the monitor thread (survivors
        keep serving while the build runs); the factory call is the
        measured cold start."""
        t0 = self._clock()
        try:
            handle = self._factory(rep.id)
        except BaseException as err:
            with self._work:
                self._error = err
            return
        with self._work:
            if self._stopping:
                return
            if self.telemetry is not None:
                # same ServingTelemetry instance as the previous
                # incarnation: counters span the replica's whole life
                handle.rm.telemetry = self.telemetry.for_replica(rep.id)
            handle.start_server()
            rep.handle = handle
            rep.alive = True
            rep.cold_start_s = self._clock() - t0
            self._cold_starts.append(rep.cold_start_s)
            self._work.notify_all()

    def _redispatch(self, e: _Entry, res, err, now: float):
        """Re-dispatch a crashed request to a survivor (re-prefill from
        the original prompt -> token-identical), or finalize it when out
        of budget/deadline/targets."""
        if e.failovers >= self.max_failovers or self._stopping:
            final = res if res is not None else GenerationResult(
                guid=e.guid, input_tokens=list(e.prompt), output_tokens=[],
                status="error", error=str(err or "replica lost"),
                tenant=e.tenant, trace_id=e.trace_id)
            self._finalize(e, final, now)
            return
        if e.deadline is not None and now >= e.deadline:
            self._finalize(e, GenerationResult(
                guid=e.guid, input_tokens=list(e.prompt), output_tokens=[],
                status="timed_out", timed_out=True, tenant=e.tenant,
                trace_id=e.trace_id), now)
            return
        self._try_dispatch(e, now, exclude=e.replica)

    def _finalize(self, e: _Entry, res, now: float):
        pool_latency = max(0.0, now - e.t_submit)
        if e.failovers > 0:
            qw, ttft = attribute_failover_wait(
                pool_latency, res.latency_s, res.queue_wait_s, res.prefill_s)
            out = dataclasses.replace(
                res, guid=e.guid, latency_s=round(pool_latency, 6),
                queue_wait_s=round(qw, 6), ttft_s=round(ttft, 6),
                failovers=e.failovers)
        elif res.guid != e.guid:
            out = dataclasses.replace(res, guid=e.guid)
        else:
            out = res
        e.finished = True
        self.rm.results[e.guid] = out
        self.rm.inflight.pop(e.guid, None)
        self._entries.pop(e.guid, None)
        if self.admission is not None and out.queue_wait_s > 0.0:
            self.admission.observe_queue_wait(out.queue_wait_s)
        for rec in self._failover_events:
            waiting = rec["waiting"]
            if rec["recovery_s"] is None and e.guid in waiting:
                waiting.discard(e.guid)
                if not waiting:
                    rec["recovery_s"] = round(now - rec["t_detect"], 6)

    def _fire_waiters(self):
        done = set(self.rm.results)
        keep, fire = [], []
        for guids, ev in self._waiters:
            guids -= done
            (keep if guids else fire).append((guids, ev))
        self._waiters = keep
        for _, ev in fire:
            ev.set()

    # -- elasticity ----------------------------------------------------------

    def scale_up(self) -> Replica:
        """Add one replica (autoscaler action). Blocks for the measured
        cold start — the delay the spike harness charges against SLOs —
        then the new replica joins the round-robin."""
        rep = Replica(len(self.replicas))
        self._build_replica(rep)
        with self._work:
            self.replicas.append(rep)
        return rep

    def n_alive(self) -> int:
        return sum(r.alive for r in self.replicas)

    def stats(self) -> dict:
        events = [dict(ev, waiting=sorted(ev["waiting"]))
                  for ev in self._failover_events]
        recoveries = [ev["recovery_s"] for ev in self._failover_events
                      if ev["recovery_s"] is not None]
        return {
            "n_replicas": len(self.replicas),
            "n_alive": self.n_alive(),
            "crashes": sum(r.crashes for r in self.replicas),
            "failovers_total": self._failovers_total,
            "cold_starts_s": [round(c, 4) for c in self._cold_starts],
            "cold_start_s": (round(sorted(self._cold_starts)
                                   [len(self._cold_starts) // 2], 4)
                             if self._cold_starts else None),
            "failover_recovery_s": (round(max(recoveries), 4)
                                    if recoveries else None),
            "failover_events": events,
            "dirty_shutdowns": self._dirty_shutdowns,
            "incident_reports": list(self.incident_reports),
            "admission": (self.admission.stats()
                          if self.admission is not None else None),
        }


# ---------------------------------------------------------------------------
# harnesses: seeded crash chaos + autoscaling spike (chip_smoke + tests)
# ---------------------------------------------------------------------------

def failover_run(pool: ReplicaPool, spec: WorkloadSpec, rate_rps: float,
                 n_requests: int = 12, seed: int = 0,
                 crash_replica: int = 0, crash_after: int = 6,
                 process: str = "poisson", timeout_s: float = 180.0,
                 slo_policy=None) -> dict:
    """Seeded replica-crash chaos: install a FaultInjector on one
    replica's engine, replay a schedule through the pool, and report the
    failover outcome (resolved_fraction must stay 1.0 — every scheduled
    request resolves even though a replica died mid-run).

    The report carries the SLO burn-rate alert timeline (records
    replayed through ``telemetry.slo.replay_records`` under
    ``slo_policy``; the injected crash's failovers are the bad events,
    so at least one alert fires). When the pool has a FleetTelemetry
    with a trace_dir, the observability artifacts land next to the
    per-replica traces: ``fleet_trace.json`` (stitched Chrome trace)
    and ``metrics.json`` (merged + per-replica snapshot)."""
    from flexflow_tpu_torch.serve.faultinject import FaultInjector
    from flexflow_tpu_torch.telemetry.slo import replay_records

    if not pool._started:
        pool.start_server()
    rep = pool.replicas[crash_replica]
    injector = FaultInjector(error_every=crash_after, max_errors=1)
    injector.install(rep.handle.ffmodel)
    try:
        schedule = build_schedule(spec, n_requests, rate_rps, seed, process)
        records = LoadRunner(pool).run(schedule, timeout_s=timeout_s)
    finally:
        injector.uninstall()
    report = summarize(records, offered_rps=rate_rps,
                       n_scheduled=len(schedule))
    stats = pool.stats()
    slo = replay_records(records, policy=slo_policy).report()
    artifacts = None
    if pool.telemetry is not None and pool.telemetry.trace_dir:
        trace_path = os.path.join(pool.telemetry.trace_dir,
                                  "fleet_trace.json")
        pool.telemetry.stitch_chrome_trace(trace_path)
        metrics_path = os.path.join(pool.telemetry.trace_dir,
                                    "metrics.json")
        with open(metrics_path, "w") as f:
            f.write(pool.telemetry.to_json(indent=2))
        artifacts = {"trace": trace_path, "metrics": metrics_path,
                     "incidents": list(pool.incident_reports)}
    return {
        "crash_replica": crash_replica,
        "crash_after_calls": crash_after,
        "injector": injector.stats() if hasattr(injector, "stats") else {
            "n_errors": injector.n_errors, "n_calls": injector.n_calls},
        "resolved_fraction": report["resolved_fraction"],
        "n_failed_over": report["n_failed_over"],
        "failovers_total": report["failovers_total"],
        "cold_start_s": stats["cold_start_s"],
        "failover_recovery_s": stats["failover_recovery_s"],
        "alerts_fired": slo["alerts_fired"],
        "slo": slo,
        "artifacts": artifacts,
        "pool": stats,
        "report": report,
    }


def spike_run(pool: ReplicaPool, spec: WorkloadSpec, base_rps: float,
              spike_multiple: float = 4.0, n_base: int = 8,
              n_spike: int = 16, seed: int = 0,
              scale_threshold: Optional[int] = None,
              scale_consecutive: int = 2,
              check_interval_s: float = 0.02, process: str = "poisson",
              timeout_s: float = 180.0, slo_policy=None) -> dict:
    """Measured autoscaling loop: a base phase at ``base_rps``, then a
    spike at ``spike_multiple`` x while an autoscaler thread watches the
    pool's outstanding-request count and calls ``pool.scale_up()``
    (blocking for the real cold start) once it has stayed >=
    ``scale_threshold`` for ``scale_consecutive`` checks (default
    threshold: one more than the pool's current slot capacity — i.e.
    "the fleet can no longer hold the offered load in its batch
    slots"). The spike phase's
    ``slo_violation_s`` integrates lateness (sum of latency beyond each
    request's deadline) — the price of scale-out paid at the measured
    cold-start delay, reported next to ``cold_start_s``."""
    if not pool._started:
        pool.start_server()
    runner = LoadRunner(pool)
    n0 = len(pool.replicas)
    if scale_threshold is None:
        slots = sum(
            getattr(r.handle.ffmodel.config, "max_requests_per_batch", 1)
            for r in pool.replicas if r.alive and r.handle is not None)
        scale_threshold = slots + 1

    base_records = runner.run(
        build_schedule(spec, n_base, base_rps, seed, process),
        timeout_s=timeout_s)
    base = summarize(base_records, offered_rps=base_rps,
                     n_scheduled=n_base)

    scaled = {"replica": None, "cold_start_s": None, "triggered_at_s": None}
    stop = threading.Event()
    t_spike0 = time.perf_counter()

    def autoscaler():
        consecutive = 0
        while not stop.is_set():
            if pool.outstanding() >= scale_threshold:
                consecutive += 1
            else:
                consecutive = 0
            if consecutive >= scale_consecutive:
                t_trig = time.perf_counter() - t_spike0
                rep = pool.scale_up()
                scaled.update(replica=rep.id,
                              cold_start_s=round(rep.cold_start_s, 4),
                              triggered_at_s=round(t_trig, 4))
                return
            stop.wait(check_interval_s)

    th = threading.Thread(target=autoscaler, daemon=True,
                          name="flexflow-autoscaler")
    th.start()
    try:
        spike_rate = base_rps * spike_multiple
        spike_records = runner.run(
            build_schedule(spec, n_spike, spike_rate, seed + 1, process),
            timeout_s=timeout_s)
    finally:
        stop.set()
        th.join(timeout_s)
    spike = summarize(spike_records, offered_rps=spike_rate,
                      n_scheduled=n_spike)
    from flexflow_tpu_torch.telemetry.slo import replay_records
    # per-phase alert timelines: the base phase is the steady-state
    # control (zero alerts expected), the spike phase may burn
    slo = {"base": replay_records(base_records, policy=slo_policy).report(),
           "spike": replay_records(spike_records,
                                   policy=slo_policy).report()}
    slo_violation_s = sum(
        max(0.0, r.latency_s - r.deadline_s) for r in spike_records
        if r.deadline_s is not None and r.status != "rejected")
    return {
        "base_rps": base_rps,
        "spike_rps": spike_rate,
        "scale_threshold": scale_threshold,
        "n_replicas_before": n0,
        "n_replicas_after": len(pool.replicas),
        "scaled_up": scaled["replica"] is not None,
        "scale_trigger_s": scaled["triggered_at_s"],
        "cold_start_s": scaled["cold_start_s"],
        "slo_violation_s": round(slo_violation_s, 4),
        "slo": slo,
        "base": base,
        "spike": spike,
        "pool": pool.stats(),
    }
