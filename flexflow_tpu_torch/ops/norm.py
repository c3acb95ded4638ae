"""Normalization operators of the serving path (counterpart of
``flexflow_tpu/ops/norm.py``): RMSNorm, ResidualRMSNorm and the SwiGLU gate
SigmoidSiluMulti. Bandwidth-bound elementwise + reduce passes left to
PyTorch's own kernels, as the JAX package leaves them to XLA."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.core.initializer import ConstantInitializer
from flexflow_tpu_torch.core.layer import WeightSpec
from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op


def _rms_norm(x, weight, eps):
    # fp32 statistics whatever the activation dtype, cast back before the
    # weight multiply (HF LLaMA semantics, as flexflow_tpu/ops/norm.py)
    dtype = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y.to(dtype) * weight).to(dtype)


@register_op
class RMSNorm(OpImpl):
    op_type = OpType.RMS_NORM

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        return [input_specs[0]]

    @staticmethod
    def weight_specs(attrs, input_specs):
        (shape, dtype) = input_specs[0]
        return [WeightSpec("weight", (attrs.get("dim", shape[-1]),), dtype,
                           ConstantInitializer(1.0))]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        return [_rms_norm(inputs[0], params["weight"], attrs.get("eps", 1e-6))]


@register_op
class ResidualRMSNorm(OpImpl):
    """Returns (x + residual, rms_norm(x + residual))."""

    op_type = OpType.RESIDUAL_RMS_NORM

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        return [input_specs[0], input_specs[0]]

    @staticmethod
    def weight_specs(attrs, input_specs):
        return RMSNorm.weight_specs(attrs, input_specs)

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        added = inputs[0] + inputs[1]
        return [added, _rms_norm(added, params["weight"], attrs.get("eps", 1e-6))]


@register_op
class SigmoidSiluMulti(OpImpl):
    """silu(x1) * x2 — the SwiGLU gate (one packed [..., 2I] input with
    attrs["packed"])."""

    op_type = OpType.SIGMOID_SILU_MULTI

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        return [input_specs[0]]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        if attrs.get("packed"):
            # gemm fusion rewired the (gate, up) pair into one packed
            # [..., 2I] input (serve/gemm_fusion.py): split it in halves
            x = inputs[0]
            half = x.shape[-1] // 2
            return [F.silu(x[..., :half]) * x[..., half:]]
        return [F.silu(inputs[0]) * inputs[1]]
