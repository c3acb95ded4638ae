"""Weight-only dequant-GEMM: kernel K3 and its plain PyTorch version.

``y = (x @ q) * scale`` for an int8 payload ``q`` [K, N] or an int4 one
packed two rows a byte [ceil(K/2), N], with a per-column fp32 scale: what
``flexflow_tpu/quant.py:138 qmatmul`` computes on a ``QuantizedWeight``
(XLA fuses the int8 -> bf16 convert into the dot there; no Pallas kernel).
``csrc/qmatmul.cu`` converts the payload on chip and never writes a
dequantized weight.

On CUDA tensors ``qmatmul`` launches K3 or raises: x in bf16 (tensor
cores) or fp32 (fp32 FMA), out in bf16 or fp32, N a multiple of 4. On
CPU tensors it runs ``qmatmul_plain``.

Split-K: where the N tiles alone would leave SMs idle, ``split_plan``
cuts K into splits whose fp32 partials a second small launch adds in a
fixed order. The plan depends on (K, N, SM count) only, never on M: a
row gives the same bits whatever the batch around it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flexflow_tpu_torch.quant import _unpack_int4

BN = 256    # weight columns per block (csrc/qmatmul.cu BN)
BK = 64     # k per stage: the split plan's unit (csrc/qmatmul.cu BK)
SPLIT_MIN_CHUNKS = 8   # a split streams at least this many BK chunks
_ACT = (torch.bfloat16, torch.float32)
_OUT = (torch.bfloat16, torch.float32)


@functools.lru_cache(maxsize=None)
def split_plan(K: int, N: int, sms: int):
    """(splits, BK-chunks per split) for a [K, N] payload on ``sms`` SMs:
    as many K splits as keep the N tiles times the splits within two
    blocks an SM (what fits in shared memory), each split at least
    ``SPLIT_MIN_CHUNKS`` chunks long. Chosen on an H100 by sweeping the
    split count at the 7B projections' shapes."""
    n_tiles = -(-N // BN)
    chunks = -(-K // BK)
    splits = max(1, min(2 * sms // n_tiles, chunks // SPLIT_MIN_CHUNKS))
    cps = -(-chunks // splits)
    return -(-chunks // cps), cps


def qmatmul_plain(x, w, compute_dtype, out_dtype):
    """Plain version of K3: unpack, ``.to(compute_dtype)``, the product in
    fp32 (exact products of the rounded operands, fp32 sums), then the
    scale, then ``out_dtype``. ``counts["qmatmul_plain_cuda"]`` counts
    calls on CUDA tensors, which the serving path never makes."""
    from flexflow_tpu_torch import kernels

    if x.is_cuda:
        kernels.counts["qmatmul_plain_cuda"] += 1
    q = _unpack_int4(w.q, w.rows) if w.qtype == "int4" else w.q
    q = q.to(compute_dtype).float()
    y = torch.matmul(x.to(compute_dtype).float(), q)
    return (y * w.scale).to(out_dtype)


def qmatmul(x, w, compute_dtype, out_dtype):
    """``x [..., K] @ w`` for a QuantizedWeight ``w`` of K rows: K3 on a
    CUDA tensor, ``qmatmul_plain`` on a CPU one."""
    if x.shape[-1] != w.rows:
        raise ValueError(f"x has {x.shape[-1]} columns, the weight "
                         f"{w.rows} rows")
    if not x.is_cuda:
        return qmatmul_plain(x, w, compute_dtype, out_dtype)
    return _launch(x, w, compute_dtype, out_dtype)


def _bind(lib):
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.ff_qmatmul.argtypes = [vp] * 5 + [i] * 10 + [vp]
    lib.ff_qmatmul.restype = i


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _launch(x, w, cd, od):
    """Check everything K3 assumes, then launch it on the current stream.
    Raises on what it does not take."""
    from flexflow_tpu_torch import kernels
    from flexflow_tpu_torch.kernels import build

    if cd not in _ACT or od not in _OUT:
        raise ValueError(f"qmatmul kernel takes compute dtype in {_ACT} and "
                         f"out dtype in {_OUT}, got {cd} / {od}")
    q, scale = w.q, w.scale
    if (q.dtype != torch.int8 or scale.dtype != torch.float32
            or w.qtype not in ("int8", "int4")):
        raise ValueError(f"qmatmul kernel takes an int8/int4 payload with an "
                         f"fp32 scale, got {w.qtype} {q.dtype} / {scale.dtype}")
    dev = x.device
    K, N = w.rows, q.shape[1]
    prows = -(-K // 2) if w.qtype == "int4" else K
    if tuple(q.shape) != (prows, N) or tuple(scale.shape) != (N,):
        raise ValueError(f"payload {tuple(q.shape)} / scale "
                         f"{tuple(scale.shape)} do not fit {K} rows")
    if N % 4:
        raise ValueError(f"qmatmul kernel takes N % 4 == 0, got N = {N}")
    for name, t in (("payload", q), ("scale", scale)):
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned "
                             f"on {dev}")
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, K).to(cd)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=od, device=dev)
    if M == 0:
        return out.reshape(*lead, N)
    Kp = -(-K // 8) * 8
    if Kp != K or not x2.is_contiguous() or x2.data_ptr() % 16:
        # the kernel reads x in 16-byte chunks: a zero-padded copy
        xp = torch.zeros((M, Kp), dtype=cd, device=dev)
        xp[:, :K] = x2
        x2 = xp
    splits, cps = split_plan(K, N, _sm_count(dev))
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    lib = build.load("qmatmul")
    if not getattr(lib, "_ff_bound", False):
        _bind(lib)
        lib._ff_bound = True
    ptr = ctypes.c_void_p
    rc = lib.ff_qmatmul(
        ptr(x2.data_ptr()), ptr(q.data_ptr()), ptr(scale.data_ptr()),
        ptr(out.data_ptr()), ptr(part.data_ptr() if part is not None else 0),
        M, N, K, Kp, splits, cps, int(w.qtype == "int4"),
        int(cd == torch.bfloat16), int(od == torch.bfloat16),
        int(N % 16 == 0), ptr(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"qmatmul kernel launch failed: CUDA error {rc}")
    kernels.counts["qmatmul"] += 1
    return out.reshape(*lead, N)
