"""The engines' compiled programs: the port's form of ``jax.jit`` for the
serving loops (counterpart of the jitted ``while_loop`` bodies of
``flexflow_tpu/serve/engine.py``).

An engine splits its block into stages: functions ``fn(st, generator)``
that read and update, in place, a dict ``st`` of device tensors (the
block state: tokens, positions, masks, step and round indices, the
packed result). A ``ProgramSet`` holds one engine's stages for one key
and runs each by name:

* on one CUDA device (``captures``) each stage is a ``torch.cuda.
  CUDAGraph`` over the tensors of ``st`` and the models' parameters and
  caches, captured once and replayed per use. Before the captures, every
  stage runs once eagerly on a side stream over a scratch copy of
  ``st`` with every row inactive (``INACTIVE``): no cache slot is
  written, a sampled head draws from a scratch generator, and the
  launches are tallied away (they are no work of the path). That
  warm-up takes nvcc's first-use build, K3's tensor maps, cuBLAS's
  handles and the kernels' shared-memory attributes out of the capture,
  for every stage, whatever the first round runs. The captures share
  one memory pool: a stage passes nothing to another except through
  ``st``, which lives outside the pool, so the replay order is free. The
  kernels' scratch (``torch.empty`` in their wrappers) comes from the
  pool at fixed addresses, which K3's x tensor map, encoded at capture,
  relies on. A sampled stage draws from the generator registered with
  its graph (``register_generator_state``): replays advance it as the
  eager loop does, so the draws are the same. A capture that fails
  raises.
  A stage may add an entry to ``st`` at its first run (its output
  buffer, whose shape the forward decides): the warm-up's entry gives
  the program its own, allocated outside the pool before the captures.
  An offloaded model's weight copies are memcpy nodes of the graph
  (``offload.Prefetcher``: a fixed ring, forked and joined by events).
* on the CPU, under a mesh (the collectives stage through pinned host
  memory under gloo), under ``inference_debugging`` and with the kernels
  off (the plain versions read the host), a stage is its function,
  called directly.

The wrappers of K1-K3 count on the host (``kernels.bump``): during a
capture their counts go to the stage's ``kernels.Tally``, and each
replay adds it to ``kernels.counts``, so a replayed block counts what
the eager body counts.

``ProgramCache`` keeps an engine's ``ProgramSet`` under its key: the
shapes and dtypes a program bakes in and the addresses of the parameter
and cache tensors it reads (``tensor_key``), never a trip count. An
engine keeps one key; the serving steps of an ``InferenceManager`` and
the host tree path's commit keep every key they have built, as a
``jax.jit`` keeps its traces, all their programs in one graph pool.
Each new key is one build (``builds``, the engines' ``_trace_count``),
on every device, so the CPU counts what the card does. Offloading a
model's weights drops the programs that read them (``drop_programs``);
the next block builds again. ``eager_bodies()`` runs the stages
directly on any device, uncached and uncounted (the chip smoke test
holds each program against its eager body with it).
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import threading
import weakref
from typing import Callable, Dict, Optional

import torch

from flexflow_tpu_torch import kernels

# the block-state entries a warm-up clears: with them all False (or 0) no
# row is live, so a stage writes no cache slot
INACTIVE = ("active", "act", "alive", "num")

_eager = contextvars.ContextVar("flexflow_tpu_torch_eager_bodies",
                                default=False)
# one capture at a time in the process (concurrent captures on one device
# are not supported); replays need no lock
_capture_lock = threading.Lock()


@contextlib.contextmanager
def eager_bodies():
    """Inside: engines run their stages directly, uncached and uncounted,
    on any device."""
    tok = _eager.set(True)
    try:
        yield
    finally:
        _eager.reset(tok)


def captures(*models) -> bool:
    """Are the programs over ``models`` captured CUDA graphs? Every model
    on one CUDA device, with no mesh, no ``inference_debugging`` and the
    kernels on (offloaded weights or not); else the stages run directly.
    Decided from the configuration, never by trying."""
    devs = {torch.device(m.device) for m in models}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        return False
    return all(getattr(m, "mesh", None) is None
               and not m.config.inference_debugging
               and m.config.use_kernels for m in models)


def tensor_key(*trees) -> tuple:
    """(address, shape, dtype) of every tensor in ``trees`` (nested dicts,
    lists and tuples of tensors and QuantizedWeights: parameters, op
    state), in order: a program reads them by address."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append((x.data_ptr(), tuple(x.shape), x.dtype))
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif hasattr(x, "q") and hasattr(x, "scale"):
            walk(x.q)
            walk(x.scale)
    for t in trees:
        walk(t)
    return tuple(out)


class ProgramSet:
    """The stages of one engine for one key, over the block state ``st``.

    ``stages``: {name: fn(st, generator)}; ``generator``: the generator a
    sampled stage draws from (None for greedy programs); ``state_of``:
    the op-state dicts the stages update, whose tensors must stay the
    same (a forward that replaced one would leave a graph writing into
    its own copy); ``capture``: build CUDA graphs (else run directly).
    """

    def __init__(self, stages: Dict[str, Callable], st: Dict[str, torch.Tensor],
                 capture: bool, generator=None, state_of: Callable = None,
                 pool=None):
        self.stages = dict(stages)
        self.st = st
        self.generator = generator
        self.graphs: Dict[str, tuple] = {}
        self.pool = None            # the graph pool of the captures
        if capture:
            with _capture_lock:
                self._capture(state_of, pool)

    def _capture(self, state_of, pool):
        dev = next(iter(self.st.values())).device
        before = tensor_key(state_of()) if state_of else ()
        scratch = {k: v.clone() for k, v in self.st.items()}
        for k in INACTIVE:
            if k in scratch:
                scratch[k].zero_()
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        gen = None
        if self.generator is not None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
        with torch.cuda.stream(side), kernels.tallying(kernels.Tally()):
            for fn in self.stages.values():
                fn(scratch, gen)
        cur.wait_stream(side)
        torch.cuda.synchronize(dev)
        if state_of and tensor_key(state_of()) != before:
            raise RuntimeError("a serving forward replaced an op-state "
                               "tensor; its programs cannot be captured")
        for k, v in scratch.items():
            if k not in self.st:         # a stage's output buffer
                self.st[k] = torch.zeros_like(v)
        if pool is None:
            pool = torch.cuda.graph_pool_handle()
        self.pool = pool
        for name, fn in self.stages.items():
            g = torch.cuda.CUDAGraph()
            if self.generator is not None:
                g.register_generator_state(self.generator)
            tally = kernels.Tally()
            with kernels.tallying(tally), torch.cuda.graph(
                    g, pool=pool, stream=side,
                    capture_error_mode="thread_local"):
                fn(self.st, self.generator)
            self.graphs[name] = (g, tally)

    def run(self, name: str):
        """One use of stage ``name``: its graph's replay, or the call."""
        entry = self.graphs.get(name)
        if entry is None:
            self.stages[name](self.st, self.generator)
            return
        g, tally = entry
        g.replay()
        kernels.add_tally(tally)

    def release(self):
        for g, _t in self.graphs.values():
            g.reset()
        self.graphs.clear()


class ProgramCache:
    """Programs under their key. ``keep``: how many keys are kept (a new
    key past them drops the oldest; None keeps every key, as a jax.jit
    keeps its traces). ``builds`` counts the builds, the JAX engines'
    ``_trace_count``; ``reported`` is how many of them the engine has
    reported to telemetry (``report``)."""

    def __init__(self, *models, keep: Optional[int] = 1):
        self.keep = keep
        self.programs: "collections.OrderedDict" = collections.OrderedDict()
        self.builds = 0
        self.reported = 0
        for m in models:
            caches = getattr(m, "_program_caches", None)
            if caches is None:
                caches = m._program_caches = weakref.WeakSet()
            caches.add(self)

    def get(self, key, make: Callable[[bool], ProgramSet],
            capture: bool) -> ProgramSet:
        """The ProgramSet for ``key``: ``make(capture)`` on a new key (one
        build), else the cached one. Inside ``eager_bodies()``: a new
        direct set, uncached and uncounted."""
        if _eager.get():
            return make(False)
        progs = self.programs.get(key)
        if progs is None:
            if self.keep is not None and len(self.programs) >= self.keep:
                self.programs.popitem(last=False)[1].release()
            self.builds += 1
            progs = self.programs[key] = make(capture)
        return progs

    def drop(self):
        for progs in self.programs.values():
            progs.release()
        self.programs.clear()

    def report(self, tel, engine: str):
        """Report the builds since the last report as ``note_retrace``
        does in the JAX engines (after the block's readback)."""
        if tel is not None and self.builds != self.reported:
            tel.note_retrace(engine, self.builds - self.reported, self.builds)
            self.reported = self.builds


def pool_bytes(pool) -> int:
    """Bytes of the device memory segments that graph pool ``pool``
    holds (``torch.cuda.memory_snapshot``)."""
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def drop_programs(model):
    """Drop every program that reads ``model``'s tensors (its weights
    moved: ``offload.offload_model_weights``)."""
    for cache in list(getattr(model, "_program_caches", ())):
        cache.drop()
