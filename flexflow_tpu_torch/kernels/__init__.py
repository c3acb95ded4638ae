"""Hand-written Hopper kernels of the port (CUDA C++ for ``sm_90a``).

K1/K2 (``attention.py``, ``csrc/flash_attend.cu``) replace the Pallas TPU
kernels of ``flexflow_tpu/kernels``; K3 (``qmatmul.py``,
``csrc/qmatmul.cu``) is the weight-only dequant-GEMM that XLA fuses for
the TPU. Each has a plain PyTorch version beside it. A wrapper takes the
plain version only for tensors on the CPU; on CUDA tensors it launches
the kernel or raises — nothing falls back.

``counts`` holds one plain integer per kernel, bumped where the wrapper
launches it; ``flash_attend_bias`` counts the K1 launches that carry an
additive bias (tree verification), which ``flash_attend`` counts too.
``plain_attend_cuda`` and ``qmatmul_plain_cuda`` count calls of the plain
versions on CUDA tensors, which the serving path never makes
(``chip_smoke.py`` checks they read 0 after every serving run).
"""

from __future__ import annotations

counts = {"flash_attend": 0, "flash_attend_append": 0,
          "flash_attend_bias": 0, "plain_attend_cuda": 0,
          "qmatmul": 0, "qmatmul_plain_cuda": 0}


def reset_counts():
    for k in counts:
        counts[k] = 0


from flexflow_tpu_torch.kernels.attention import (  # noqa: E402
    flash_attend, reference_attend)

__all__ = ["counts", "flash_attend", "reference_attend", "reset_counts"]
