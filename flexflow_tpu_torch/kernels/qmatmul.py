"""Weight-only dequant-GEMM: kernel K3 and its plain PyTorch version.

``y = (x @ q) * scale`` for an int8 payload ``q`` [K, N] or an int4 one
packed two rows a byte [ceil(K/2), N], with a per-column fp32 scale: what
``flexflow_tpu/quant.py:138 qmatmul`` computes on a ``QuantizedWeight``
(XLA fuses the int8 -> bf16 convert into the dot there; no Pallas kernel).
``csrc/qmatmul.cu`` converts the payload on chip and never writes a
dequantized weight.

On CUDA tensors ``qmatmul`` launches K3 or raises: x in bf16 or fp16
(TMA + wgmma) or fp32 (fp32 FMA), out in bf16, fp16 or fp32, N a
multiple of 4. On CPU tensors it runs ``qmatmul_plain``.

Split-K: where the 128-column N tiles alone would leave SMs idle,
``split_plan`` cuts K into at most 8 splits. For 16-bit x the splits of
one N tile are a thread-block cluster that adds its fp32 partials in
shared memory, in rank order, in the same launch; fp32 x writes partials
that a second small launch adds in order. The plan depends on (K, N, SM
count) only, never on M: a row gives the same bits whatever the batch
around it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from flexflow_tpu_torch.quant import _unpack_int4

BN = 128    # weight columns per block (csrc/qmatmul.cu BN)
BK = 64     # k per stage: the split plan's unit (csrc/qmatmul.cu BK)
SPLIT_MIN_CHUNKS = 8   # a split streams at least this many BK chunks
MAX_CLUSTER = 8        # the portable thread-block cluster size
_DT = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}  # dtype codes


@functools.lru_cache(maxsize=None)
def split_plan(K: int, N: int, sms: int):
    """(splits, BK-chunks per split) for a [K, N] payload on ``sms`` SMs:
    as many K splits as keep the N tiles times the splits within 1.5
    blocks an SM, at most ``MAX_CLUSTER`` (the splits of an N tile are
    one cluster) and each split at least ``SPLIT_MIN_CHUNKS`` chunks
    long. Every chunk lies in exactly one split and no split is empty.
    The 1.5 comes from sweeping the split count on an H100 at the 7B
    projections' shapes (PERF.md): two blocks an SM (256 and more
    blocks, in clusters of up to 8) ran slower at M = 64."""
    n_tiles = -(-N // BN)
    chunks = -(-K // BK)
    splits = max(1, min(MAX_CLUSTER, 3 * sms // (2 * n_tiles),
                        chunks // SPLIT_MIN_CHUNKS))
    cps = -(-chunks // splits)
    return -(-chunks // cps), cps


def qmatmul_plain(x, w, compute_dtype, out_dtype):
    """Plain version of K3: unpack, ``.to(compute_dtype)``, the product in
    fp32 (exact products of the rounded operands, fp32 sums), then the
    scale, then ``out_dtype``. ``counts["qmatmul_plain_cuda"]`` counts
    calls on CUDA tensors, which the serving path never makes."""
    from flexflow_tpu_torch import kernels

    if x.is_cuda:
        kernels.bump("qmatmul_plain_cuda")
    q = _unpack_int4(w.q, w.rows) if w.qtype == "int4" else w.q
    q = q.to(compute_dtype).float()
    y = torch.matmul(x.to(compute_dtype).float(), q)
    return (y * w.scale).to(out_dtype)


def qmatmul(x, w, compute_dtype, out_dtype):
    """``x [..., K] @ w`` for a QuantizedWeight ``w`` of K rows: K3 on a
    CUDA tensor, ``qmatmul_plain`` on a CPU one (and on a CUDA one inside
    ``kernels.use_kernels(False)``)."""
    if x.shape[-1] != w.rows:
        raise ValueError(f"x has {x.shape[-1]} columns, the weight "
                         f"{w.rows} rows")
    from flexflow_tpu_torch.kernels import kernels_enabled

    if not x.is_cuda or not kernels_enabled():
        return qmatmul_plain(x, w, compute_dtype, out_dtype)
    return _launch(x, w, compute_dtype, out_dtype)


def _lib():
    from flexflow_tpu_torch.kernels import build

    lib = build.load("qmatmul")
    if not getattr(lib, "_ff_bound", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.ff_qmatmul.argtypes = [vp] * 6 + [i] * 9 + [vp]
        lib.ff_qmatmul.restype = i
        lib.ff_qmatmul_wmap.argtypes = [vp, i, i, i, vp]
        lib.ff_qmatmul_wmap.restype = i
        lib._ff_bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _weight_entry(w, dev):
    """(payload tensor map or None, splits, chunks per split) of ``w`` on
    ``dev``, checked and encoded at its first launch and kept on the
    weight itself (it dies with it), valid while ``w.q`` and ``w.scale``
    are the same tensors."""
    q, scale = w.q, w.scale
    cached = getattr(w, "_k3_entry", None)
    if (cached is not None and cached[0] is q and cached[1] is scale
            and cached[2] == (w.qtype, w.rows, dev)):
        return cached[3]
    if (q.dtype != torch.int8 or scale.dtype != torch.float32
            or w.qtype not in ("int8", "int4")):
        raise ValueError(f"qmatmul kernel takes an int8/int4 payload with an "
                         f"fp32 scale, got {w.qtype} {q.dtype} / {scale.dtype}")
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
    wmap = None
    if N % 16 == 0:   # a payload row of whole 16-byte units: a TMA tensor
        wmap = ctypes.create_string_buffer(128)
        rc = _lib().ff_qmatmul_wmap(ctypes.c_void_p(q.data_ptr()), prows, N,
                                    int(w.qtype == "int4"), wmap)
        if rc != 0:
            raise RuntimeError(f"qmatmul: payload tensor map failed ({rc})")
    entry = (wmap, *split_plan(K, N, _sm_count(dev)))
    w._k3_entry = (q, scale, (w.qtype, w.rows, dev), entry)
    return entry


def _launch(x, w, cd, od):
    """Check everything K3 assumes, then launch it on the current stream.
    Raises on what it does not take."""
    from flexflow_tpu_torch import kernels

    if cd not in _DT or od not in _DT:
        raise ValueError(f"qmatmul kernel takes compute and out dtypes in "
                         f"{list(_DT)}, got {cd} / {od}")
    dev = x.device
    wmap, splits, cps = _weight_entry(w, dev)
    K, N = w.rows, w.q.shape[1]
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, K).to(cd)
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=od, device=dev)
    if M == 0:
        return out.reshape(*lead, N)
    Kx = K
    if K % 8 or not x2.is_contiguous() or x2.data_ptr() % 16:
        # x rows must be 16-byte units at 16-byte addresses: a padded copy
        Kx = -(-K // 8) * 8
        xp = torch.zeros((M, Kx), dtype=cd, device=dev)
        xp[:, :K] = x2
        x2 = xp
    part = None
    if cd == torch.float32 and splits > 1:
        part = torch.empty((splits, M, N), dtype=torch.float32, device=dev)
    ptr = ctypes.c_void_p
    rc = _lib().ff_qmatmul(
        ptr(x2.data_ptr()), ptr(w.q.data_ptr()), ptr(w.scale.data_ptr()),
        ptr(out.data_ptr()), ptr(part.data_ptr() if part is not None else 0),
        wmap, M, N, K, Kx, splits, cps, int(w.qtype == "int4"), _DT[cd],
        _DT[od], ptr(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"qmatmul kernel launch failed: CUDA error {rc}")
    kernels.bump("qmatmul")
    kernels.note_shape("qmatmul", (x2.shape[0], K, N, w.qtype, str(cd)[6:],
                                   str(od)[6:]))
    return out.reshape(*lead, N)
