"""Profiling hooks (counterpart of ``flexflow_tpu/utils/profiling.py``).

Two layers, as in the JAX package: per-step wall time behind a device
fence (``device_fence``; the serving telemetry's block and prefill
histograms), and a device trace (``profiler_trace``: ``torch.profiler``
in place of ``jax.profiler``), whose Chrome-trace export loads in
Perfetto beside the span tracer's JSONL (telemetry/tracing.py).
``StepTimer`` gathers the per-step times that ``FFModel.fit`` prints under
``FFConfig.profiling`` (the reference's ``--profiling``); ``timed_call``,
``slope_time`` and ``adaptive_slope_time`` time a callable behind the
fence, the last two as the slope over trip counts, which cancels a fixed
per-call cost.

CUDA work is asynchronous: a host clock read after a launch measures the
launch, not the kernel. A host readback (``.cpu()``) of a result fences
the work that produced it; a step whose outputs stay on the device (a
prefill chunk: its KV lands in the caches in place) needs
``device_fence``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, List

import torch


def _devices(out) -> set:
    """The CUDA devices of every tensor in a nested dict/list/tuple."""
    if isinstance(out, torch.Tensor):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = out.values()
    elif not isinstance(out, (list, tuple)):
        return set()
    devs = set()
    for v in out:
        devs |= _devices(v)
    return devs


def device_fence(out):
    """Block until every CUDA tensor in ``out`` (a tensor, or a nested
    dict/list of them: a model's ``op_state``) has been computed:
    ``torch.cuda.synchronize`` on each of their devices. CPU tensors
    need no fence, so on the CPU this does nothing. Returns ``out``."""
    for dev in _devices(out):
        torch.cuda.synchronize(dev)
    return out


def timed_call(fn, *args, **kwargs):
    """Run fn, fence its outputs, return (result, seconds)."""
    t0 = time.perf_counter()
    out = device_fence(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def _best_of(run: Callable[[int], object], t: int, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        device_fence(run(t))
        best = min(best, time.perf_counter() - t0)
    return best


def slope_time(run: Callable[[int], object], t1: int = 1, t2: int = 5,
               reps: int = 2) -> float:
    """Seconds per iteration of ``run(T)``, which runs T iterations of
    the workload: ``(time(t2) - time(t1)) / (t2 - t1)``, each the best of
    ``reps`` fenced calls. The slope cancels the fixed cost of a call
    (launch, readback); it may be <= 0 under jitter, which callers treat
    as too fast to resolve."""
    return ((_best_of(run, t2, reps) - _best_of(run, t1, reps))
            / (t2 - t1))


def adaptive_slope_time(run: Callable[[int], object], cap: int = 4096,
                        reps: int = 3, min_resolve_s: float = 5e-3) -> float:
    """``slope_time`` with the upper trip count grown 4x at a time (from
    8, up to ``cap``) until the extra work clears a noise floor of
    ``max(0.5 * time(1), min_resolve_s)``; the slope against T = 1.
    Returns 0.0 when even ``cap`` trips do not clear it: callers then
    fall back to an analytic estimate."""
    t_fix = _best_of(run, 1, reps)
    thresh = max(0.5 * t_fix, min_resolve_s)
    t = 8
    while True:
        t_hi = _best_of(run, t, reps)
        if t_hi - t_fix >= thresh:
            return (t_hi - t_fix) / (t - 1)
        if t >= cap:
            return 0.0
        t = min(t * 4, cap)


class StepTimer:
    """Per-step fenced wall times by name (the ``--profiling`` print path,
    reference linear_kernels.cu:159-225 style)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.times: Dict[str, List[float]] = {}

    def record(self, name: str, seconds: float):
        if self.enabled:
            self.times.setdefault(name, []).append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"count": len(ts), "total_s": sum(ts),
                       "mean_ms": 1e3 * sum(ts) / max(1, len(ts)),
                       "last_ms": 1e3 * ts[-1]}
                for name, ts in self.times.items()}

    def report(self) -> str:
        return " ".join(f"{k}={v['mean_ms']:.2f}ms(x{v['count']})"
                        for k, v in self.summary().items())


@contextlib.contextmanager
def profiler_trace(path: str) -> Iterator:
    """A ``torch.profiler`` trace of the CPU and, where CUDA is present,
    the card, written as a Chrome trace to ``path`` when the block ends
    (view it in Perfetto or chrome://tracing). Yields the profiler (its
    ``key_averages()`` gives the time by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(path)
