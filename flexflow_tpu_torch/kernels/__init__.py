"""Hand-written Hopper kernels of the port (CUDA C++ for ``sm_90a``).

K1/K2 (``attention.py``, ``csrc/flash_attend.cu``) replace the Pallas TPU
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
their partials (sequence-parallel serving), which ``flash_attend`` and
``flash_attend_append`` count too.
``plain_attend_cuda`` and ``qmatmul_plain_cuda`` count calls of the plain
versions on CUDA tensors, which the serving path never makes
(``chip_smoke.py`` checks they read 0 after every serving run).

Inside ``record_shapes()`` every launch also adds its shape to
``shapes[kernel]`` (``note_shape``): (R, Q, H, KH, S, D, cache dtype,
output dtype or "partials", bias) for K1/K2, (M, K, N, qtype, compute
dtype, output dtype) for K3, so a caller can hold the kernels against
their plain versions at the shapes a run gave them.
"""

from __future__ import annotations

import contextlib
import contextvars

counts = {"flash_attend": 0, "flash_attend_append": 0,
          "flash_attend_bias": 0, "flash_attend_partials": 0,
          "plain_attend_cuda": 0, "qmatmul": 0, "qmatmul_plain_cuda": 0}
shapes: dict = {}
_recording = [False]


def reset_counts():
    for k in counts:
        counts[k] = 0


def note_shape(kernel: str, shape: tuple):
    """Called by a wrapper where it launches ``kernel``."""
    if _recording[0]:
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

__all__ = ["counts", "flash_attend", "kernels_enabled", "reference_attend",
           "reset_counts", "use_kernels"]
