"""Linear (dense) operator (counterpart of ``flexflow_tpu/ops/linear.py``).

Weight layout: kernel [in_dim, out_dim] (activations @ kernel), bias
[out_dim] — the JAX package's layout, so parameters cross over unchanged.
The product is ``quant.qmatmul``: a plain ``torch.matmul`` for a float
kernel (the JAX package leaves it to XLA; no TPU kernel), the dequant-GEMM
K3 for a quantized one on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.core.initializer import (default_bias_initializer,
                                                 default_kernel_initializer)
from flexflow_tpu_torch.core.layer import WeightSpec
from flexflow_tpu_torch.ffconst import ActiMode, DataType, OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op
from flexflow_tpu_torch.quant import qmatmul


def apply_activation(x, mode: ActiMode):
    if mode == ActiMode.AC_MODE_NONE:
        return x
    if mode == ActiMode.AC_MODE_RELU:
        return F.relu(x)
    if mode == ActiMode.AC_MODE_SIGMOID:
        return torch.sigmoid(x)
    if mode == ActiMode.AC_MODE_TANH:
        return torch.tanh(x)
    if mode == ActiMode.AC_MODE_GELU:
        return F.gelu(x)
    raise ValueError(mode)


@register_op
class Linear(OpImpl):
    op_type = OpType.LINEAR
    quant_aware = True

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (shape, dtype) = input_specs[0]
        out_dtype = attrs.get("data_type") or dtype
        if attrs.get("keep_f32_logits"):
            out_dtype = DataType.DT_FLOAT   # forward emits f32 logits
        return [(tuple(shape[:-1]) + (attrs["out_dim"],), out_dtype)]

    @staticmethod
    def weight_specs(attrs, input_specs):
        (shape, dtype) = input_specs[0]
        out_dim = attrs["out_dim"]
        wdtype = attrs.get("data_type") or dtype
        specs = [WeightSpec("kernel", (shape[-1], out_dim), wdtype,
                            attrs.get("kernel_initializer")
                            or default_kernel_initializer())]
        if attrs.get("use_bias", True):
            specs.append(WeightSpec("bias", (out_dim,), wdtype,
                                    attrs.get("bias_initializer")
                                    or default_bias_initializer()))
        return specs

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        compute_dtype = ctx.compute_dtype or x.dtype
        # logits heads keep the gemm's fp32 accumulator: bf16 ties between
        # near-equal logits would flip greedy argmax between programs. A
        # quantized head does so inside K3, with no fp32 copy of the weight
        out_dtype = torch.float32 if attrs.get("keep_f32_logits") else None
        y = qmatmul(x, params["kernel"], compute_dtype, out_dtype=out_dtype)
        if attrs.get("use_bias", True):
            y = y + params["bias"].to(compute_dtype)
        return [apply_activation(y, attrs.get("activation",
                                              ActiMode.AC_MODE_NONE))]
