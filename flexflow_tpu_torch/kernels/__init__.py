"""Hand-written Hopper kernels of the port (CUDA C++ for ``sm_90a``).

K1/K2 (``attention.py``, ``csrc/flash_attend.cu`` and, for fp32 caches,
``csrc/flash_attend_f32.cu``) replace the Pallas TPU
kernels of ``flexflow_tpu/kernels``; K3 (``qmatmul.py``,
``csrc/qmatmul.cu``) is the weight-only dequant-GEMM that XLA fuses for
the TPU. Each has a plain PyTorch version beside it. A wrapper takes the
plain version only for tensors on the CPU; on CUDA tensors it launches
the kernel or raises — nothing falls back. The one exception is asked
for: ``FFConfig(use_kernels=False)`` runs a model's forwards inside
``use_kernels(False)``, where the wrappers take the plain versions on
CUDA tensors too (a context variable, so each thread has its own).

``counts`` holds one plain integer per kernel, bumped where the wrapper
launches it; ``flash_attend_bias`` counts the K1 launches that carry an
additive bias (tree verification), which ``flash_attend`` counts too;
``flash_attend_partials`` counts the K1 and K2 launches that return
their partials (sequence-parallel serving), ``flash_attend_fp32``
those on an fp32 cache (the FFMA kernel) and ``flash_attend_wide`` the
16-bit launches at head dims 256 and past (the wide cluster kernel), which
``flash_attend`` and ``flash_attend_append`` count too.
``plain_attend_cuda`` and ``qmatmul_plain_cuda`` count calls of the plain
versions on CUDA tensors, which the serving path never makes
(``chip_smoke.py`` checks they read 0 after every serving run).

Inside ``record_shapes()`` every launch also adds its shape to
``shapes[kernel]`` (``note_shape``): (R, Q, H, KH, S, D, cache dtype,
output dtype or "partials", bias) for K1/K2, (M, K, N, qtype, compute
dtype, output dtype) for K3, so a caller can hold the kernels against
their plain versions at the shapes a run gave them.

A wrapper counts through ``bump``. While a CUDA graph is captured
(``serve/graphs.py``) nothing launches, so inside ``tallying(t)`` the
bumps and shapes go to the ``Tally`` ``t`` instead of ``counts`` and
``shapes``; each replay of the graph adds its tally (``add_tally``).
Other host-side counters of a graph's work go through ``each_run`` (the
offload prefetcher's bytes): called now, or at each replay.
"""

from __future__ import annotations

import contextlib
import contextvars

counts = {"flash_attend": 0, "flash_attend_append": 0,
          "flash_attend_bias": 0, "flash_attend_partials": 0,
          "flash_attend_fp32": 0, "flash_attend_wide": 0,
          "plain_attend_cuda": 0, "qmatmul": 0, "qmatmul_plain_cuda": 0}
shapes: dict = {}
_recording = [False]


def reset_counts():
    for k in counts:
        counts[k] = 0


class Tally:
    """The launches (``counts``) and launch shapes (``shapes``: a set of
    (kernel, shape)) that one captured CUDA graph makes at each replay."""

    def __init__(self):
        self.counts = dict.fromkeys(counts, 0)
        self.shapes = set()
        self.each_run = []          # host counters bumped at each replay


_tally = contextvars.ContextVar("flexflow_tpu_torch_tally", default=None)


@contextlib.contextmanager
def tallying(tally: "Tally"):
    """Inside: ``bump`` and ``note_shape`` go to ``tally`` (a capture, or a
    warm-up whose launches are not the path's work)."""
    tok = _tally.set(tally)
    try:
        yield tally
    finally:
        _tally.reset(tok)


def bump(key: str):
    """Called by a wrapper where it launches (or, for the plain counters,
    runs) ``key``: one more in ``counts``, or in the tally being taken."""
    t = _tally.get()
    (counts if t is None else t.counts)[key] += 1


def each_run(fn):
    """``fn()`` now, or, inside a tally being taken, at each replay of
    its graph: a host-side counter of work the graph does."""
    t = _tally.get()
    if t is None:
        fn()
    else:
        t.each_run.append(fn)


def note_shape(kernel: str, shape: tuple):
    """Called by a wrapper where it launches ``kernel``."""
    t = _tally.get()
    if t is not None:
        t.shapes.add((kernel, shape))
    elif _recording[0]:
        shapes.setdefault(kernel, set()).add(shape)


def add_tally(tally: "Tally"):
    """One replay of a captured graph: its launches into ``counts``, and
    its shapes into ``shapes`` inside ``record_shapes()``."""
    for k, n in tally.counts.items():
        counts[k] += n
    for fn in tally.each_run:
        fn()
    if _recording[0]:
        for kernel, shape in tally.shapes:
            shapes.setdefault(kernel, set()).add(shape)


@contextlib.contextmanager
def record_shapes():
    """Record the launch shapes of the block into ``shapes`` (emptied
    first); yields ``shapes``."""
    shapes.clear()
    _recording[0] = True
    try:
        yield shapes
    finally:
        _recording[0] = False


_enabled = contextvars.ContextVar("flexflow_tpu_torch_kernels",
                                  default=True)


def kernels_enabled() -> bool:
    """False inside ``use_kernels(False)``: CUDA tensors take the plain
    versions."""
    return _enabled.get()


@contextlib.contextmanager
def use_kernels(on: bool = True):
    tok = _enabled.set(bool(on))
    try:
        yield
    finally:
        _enabled.reset(tok)


from flexflow_tpu_torch.kernels.attention import (  # noqa: E402
    flash_attend, reference_attend)

__all__ = ["Tally", "add_tally", "bump", "counts", "flash_attend",
           "kernels_enabled", "reference_attend", "reset_counts", "tallying",
           "use_kernels"]
