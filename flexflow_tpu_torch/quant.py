"""Weight-only int8/int4 quantization for serving (counterpart of
``flexflow_tpu/quant.py``).

Weights live on the device as int8 (int4 packs two rows per byte) with a
per-output-column fp32 scale, ``q = round(w / s)``, ``s = max|w_col| /
qmax``: the scheme, the rounding and the packing of the JAX package, so
that a weight quantized in either package gives the same bits.

``qmatmul`` keeps the scale out of the product, ``y = (x @ q) * scale``.
On CUDA tensors the product is the hand-written dequant-GEMM K3
(``kernels/qmatmul.py``): it reads the int8 or packed int4 payload and
converts it to the activation type on chip, so no dequantized copy of a
weight is ever written. On CPU tensors it is the same function in plain
PyTorch.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from flexflow_tpu_torch.ffconst import torch_dtype


class QuantizedWeight:
    """An int8 payload ``q`` ([rows, N], or [ceil(rows / 2), N] packed for
    int4) and its fp32 per-column ``scale`` [N], with the original row
    count and dtype name (``"bfloat16"``, ``"float32"``)."""

    def __init__(self, qtype: str, q, scale, rows: int, dtype: str):
        self.qtype = qtype
        self.q = q
        self.scale = scale
        self.rows = rows
        self.dtype = dtype

    @property
    def nbytes(self) -> int:
        return int(self.q.nbytes) + int(self.scale.nbytes)

    @property
    def shape(self):
        return (self.rows, self.q.shape[1])

    def __repr__(self):
        return (f"QuantizedWeight({self.qtype}, shape={self.shape}, "
                f"dtype={self.dtype})")


_QTYPE_ALIASES = {"int8": "int8", "8": "int8", "q8": "int8",
                  "int4": "int4", "4": "int4", "q4": "int4"}


def normalize_qtype(qtype) -> Optional[str]:
    """A user-facing quantization spec -> ``"int8"``/``"int4"``/``None``.
    Unknown values raise: a typo silently serving float weights would
    defeat the point."""
    if qtype is None or qtype is False:
        return None
    q = str(qtype).strip().lower()
    if q in ("", "none", "fp", "float", "fp32", "bf16", "off"):
        return None
    if q not in _QTYPE_ALIASES:
        raise ValueError(
            f"unknown quantization type {qtype!r}; expected int8/int4/none")
    return _QTYPE_ALIASES[q]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def quantize_array(w, qtype: str) -> QuantizedWeight:
    """Quantize a 2-D float tensor (int4 packs two rows per byte).

    The scale is computed in the weight's own dtype and only then cast to
    fp32 (a bf16 weight gets a bf16-rounded scale); the division is
    w / fp32 scale in fp32, rounded half to even and clipped to ±qmax."""
    w = torch.as_tensor(w)
    if w.dim() != 2:
        raise ValueError(f"quantize_array takes a 2-D weight, got shape "
                         f"{tuple(w.shape)}")
    qmax = 127.0 if qtype == "int8" else 7.0
    scale = w.abs().amax(dim=0) / qmax                    # [out], w's dtype
    scale = torch.where(scale == 0, torch.ones_like(scale),
                        scale).to(torch.float32)
    q = torch.clamp(torch.round(w / scale[None, :]), -qmax, qmax).to(
        torch.int8)
    rows = int(w.shape[0])
    if qtype == "int4":
        if q.shape[0] % 2:
            q = torch.cat([q, torch.zeros_like(q[:1])])
        lo = q[0::2] & 0x0F
        hi = (q[1::2] & 0x0F) << 4                        # int8: wraps
        q = lo | hi                                       # [ceil(in/2), out]
    return QuantizedWeight(qtype, q.contiguous(), scale.contiguous(), rows,
                           _dtype_name(w.dtype))


def requantize_into(leaf: QuantizedWeight, value, lo: int = 0,
                    hi: Optional[int] = None):
    """Quantize ``value`` [rows, hi - lo] in ``leaf``'s dtype and write its
    payload and scale into columns lo:hi of ``leaf``, in place (the
    per-column scheme leaves every other column as it was)."""
    hi = leaf.q.shape[1] if hi is None else hi
    arr = torch.as_tensor(value).to(device=leaf.q.device,
                                    dtype=torch_dtype(leaf.dtype))
    new = quantize_array(arr, leaf.qtype)
    leaf.q[:, lo:hi] = new.q
    leaf.scale[lo:hi] = new.scale


def _unpack_int4(q, rows: int):
    lo = (q << 4) >> 4                                    # sign-extend nibble
    hi = q >> 4                                           # arithmetic shift
    full = torch.stack([lo, hi], dim=1).reshape(-1, q.shape[1])
    return full[:rows]


def dequantize_array(leaf: QuantizedWeight, dtype=None):
    q = leaf.q
    if leaf.qtype == "int4":
        q = _unpack_int4(q, leaf.rows)
    out_dtype = torch_dtype(dtype or leaf.dtype)
    return (q.to(torch.float32) * leaf.scale[None, :]).to(out_dtype)


def is_quantized(leaf) -> bool:
    return isinstance(leaf, QuantizedWeight)


# weights eligible for quantization: the serving matmul weights
# ("wqkv" = the gemm-fusion concat, serve/gemm_fusion.py)
_QUANT_NAMES = {"kernel", "wq", "wk", "wv", "wo", "wqkv", "weight",
                "w1", "w2", "w3", "gate", "up", "down"}


def quantize_params(params: Dict[str, Dict[str, Any]], qtype: str,
                    min_dim: int = 64) -> Dict[str, Dict[str, Any]]:
    """Quantize every eligible 2-D weight of a ``{layer: {name: tensor}}``
    tree; other leaves pass through as they are."""
    if qtype not in ("int8", "int4"):
        raise ValueError(f"quantization type {qtype!r} is not int8/int4")
    out: Dict[str, Dict[str, Any]] = {}
    for layer, ws in params.items():
        new_ws = {}
        for name, w in ws.items():
            if (not is_quantized(w) and name in _QUANT_NAMES
                    and w.dim() == 2 and min(w.shape) >= min_dim
                    and w.dtype.is_floating_point):
                new_ws[name] = quantize_array(w, qtype)
            else:
                new_ws[name] = w
        out[layer] = new_ws
    return out


def qmatmul(x, w, compute_dtype=None, out_dtype=None):
    """``x @ w`` for a possibly quantized 2-D weight: operands in
    ``compute_dtype`` (default x's), fp32 accumulation, the per-column
    scale applied after the product, the result in ``out_dtype`` (default
    the compute dtype; logits heads ask for fp32).

    A quantized weight on a CUDA tensor launches K3 (or raises); on the
    CPU it takes ``kernels.qmatmul.qmatmul_plain``. A plain weight is a
    ``torch.matmul``; with an fp32 result from narrower operands it runs
    on fp32 copies of the rounded operands (the product of two bf16
    values is exact in fp32, so that is the fp32 accumulator of the bf16
    GEMM, unrounded)."""
    cd = torch_dtype(compute_dtype) if compute_dtype is not None else x.dtype
    od = torch_dtype(out_dtype) if out_dtype is not None else cd
    if is_quantized(w):
        from flexflow_tpu_torch.kernels.qmatmul import qmatmul as k3

        return k3(x, w, cd, od)
    x, w = x.to(cd), w.to(cd)
    if od != cd:
        return torch.matmul(x.to(od), w.to(od))
    if cd == torch.float16 and not x.is_cuda:
        # PyTorch's CPU fp16 GEMM accumulates in fp32 but runs orders of
        # magnitude slower than its fp32 one in some builds: the product
        # of the widened operands, rounded once, is the same
        # fp32-accumulated product
        return torch.matmul(x.float(), w.float()).to(cd)
    return torch.matmul(x, w)


def qtake(table, ids):
    """Embedding-row gather for a possibly quantized table: gather the
    packed rows first and dequantize only those (never the whole table)."""
    ids = ids.long()
    if not is_quantized(table):
        return table[ids]
    if table.qtype == "int4":
        # rows pack in pairs: entry r lives in packed row r // 2, nibble r % 2
        packed = table.q[ids // 2]
        lo = (packed << 4) >> 4
        hi = packed >> 4
        rows = torch.where((ids % 2 == 0)[..., None], lo, hi)
    else:
        rows = table.q[ids]
    out_dtype = torch_dtype(table.dtype)
    return (rows.to(torch.float32) * table.scale).to(out_dtype)


def dequantize_layer_params(ws: Optional[Dict[str, Any]], dtype=None):
    """One layer's weights with every quantized leaf dequantized (for ops
    that read float weights)."""
    if not ws or not any(is_quantized(v) for v in ws.values()):
        return ws
    return {k: dequantize_array(v, dtype) if is_quantized(v) else v
            for k, v in ws.items()}


def quantized_nbytes(params) -> int:
    """Device bytes of a (possibly quantized) ``{layer: {name: leaf}}``
    tree: payload + scale for a quantized leaf."""
    return sum(int(getattr(leaf, "nbytes", 0)) for lp in params.values()
               for leaf in lp.values())
