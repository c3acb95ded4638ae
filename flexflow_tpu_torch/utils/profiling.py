"""Profiling hooks (counterpart of ``flexflow_tpu/utils/profiling.py``).

Two layers, as in the JAX package: per-step wall time behind a device
fence (``device_fence``; the serving telemetry's block and prefill
histograms), and a device trace (``profiler_trace``: ``torch.profiler``
in place of ``jax.profiler``), whose Chrome-trace export loads in
Perfetto beside the span tracer's JSONL (telemetry/tracing.py).

CUDA work is asynchronous: a host clock read after a launch measures the
launch, not the kernel. A host readback (``.cpu()``) of a result fences
the work that produced it; a step whose outputs stay on the device (a
prefill chunk: its KV lands in the caches in place) needs
``device_fence``.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

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
