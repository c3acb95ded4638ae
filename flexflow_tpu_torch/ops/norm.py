"""Normalization operators (counterpart of ``flexflow_tpu/ops/norm.py``):
LayerNorm, ResidualLayerNorm and AddBiasResidualLayerNorm (OPT, Falcon,
MPT, StarCoder, BERT), RMSNorm, ResidualRMSNorm and the SwiGLU gate
SigmoidSiluMulti (LLaMA), and the training path's BatchNorm.
Bandwidth-bound elementwise + reduce passes left to PyTorch's own kernels,
as the JAX package leaves them to XLA.

In a tensor-parallel train step the normalised dim may be split over
``model`` (``OpContext.row_shards``; the placement GSPMD gives the JAX
package's step): the mean, then the variance of the centred values, are
each a local sum added over the axis (``psum_parts``), two passes as in
the whole op, and the affine weights are cut to the rank's features
(their gradients, partial, are summed by ``GradReducer``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.core.initializer import (ConstantInitializer,
                                                 ZeroInitializer)
from flexflow_tpu_torch.core.layer import WeightSpec
from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.ops.base import OpImpl, part, register_op


def _split_dims(ctx, dims, rank):
    """``ctx.split_dims`` (none without a context: a direct call)."""
    return ctx.split_dims(dims, rank) if ctx is not None else {}


def _split_mean(v, dims, split, ctx):
    """The mean of ``v`` over ``dims`` (keepdim), of which ``split``
    ({dim: (axis, size, index)}) names those this rank holds a part of:
    the local sums are added over each such axis."""
    if not split:
        return v.mean(dim=dims, keepdim=True)
    from flexflow_tpu_torch.parallel.collectives import psum_parts

    count = 1
    for d in dims:
        count *= v.shape[d]
    s = v.sum(dim=dims, keepdim=True)
    for axis, n, _i in split.values():
        s = psum_parts(s, ctx.mesh, axis)
        count *= n
    return s / count


def _affine_parts(ws, axes, split, rank):
    """The affine weights (over ``axes``) cut to the rank's part of each
    split normalised dim."""
    pos = [a % rank for a in axes]
    out = []
    for w in ws:
        if w is not None:
            for d, shard in split.items():
                w = part(w, pos.index(d), shard)
        out.append(w)
    return out


def _layer_norm(x, gamma, beta, eps, axes, ctx):
    # in x's own dtype, statistics included (the JAX package's
    # _layer_norm), unlike _rms_norm's fp32 statistics
    dims = tuple(axes)
    split = _split_dims(ctx, dims, x.dim())
    gamma, beta = _affine_parts((gamma, beta), dims, split, x.dim())
    mean = _split_mean(x, dims, split, ctx)
    var = _split_mean((x - mean).square(), dims, split, ctx)
    y = (x - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        y = y * gamma
    if beta is not None:
        y = y + beta
    return y


def _rms_norm(x, weight, eps, ctx):
    # fp32 statistics whatever the activation dtype, cast back before the
    # weight multiply (HF LLaMA semantics, as flexflow_tpu/ops/norm.py)
    dtype = x.dtype
    split = _split_dims(ctx, (-1,), x.dim())
    (weight,) = _affine_parts((weight,), (-1,), split, x.dim())
    xf = x.float()
    var = _split_mean(xf.square(), (-1,), split, ctx)
    y = xf * torch.rsqrt(var + eps)
    return (y.to(dtype) * weight).to(dtype)


@register_op
class LayerNorm(OpImpl):
    """``elementwise_affine=False``: no weights; ``use_bias=False``: gamma
    only."""

    op_type = OpType.LAYERNORM

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        return [input_specs[0]]

    @staticmethod
    def weight_specs(attrs, input_specs):
        if not attrs.get("elementwise_affine", True):
            return []
        (shape, dtype) = input_specs[0]
        norm_shape = tuple(shape[a] for a in attrs["axes"])
        specs = [WeightSpec("gamma", norm_shape, dtype,
                            ConstantInitializer(1.0))]
        if attrs.get("use_bias", True):
            specs.append(WeightSpec("beta", norm_shape, dtype,
                                    ZeroInitializer()))
        return specs

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        return [_layer_norm(inputs[0], params.get("gamma"),
                            params.get("beta"), attrs.get("eps", 1e-5),
                            attrs["axes"], ctx)]


@register_op
class ResidualLayerNorm(OpImpl):
    """Returns (x + residual1 [+ residual2], layer_norm of that sum)."""

    op_type = OpType.RESIDUAL_LAYERNORM

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        return [input_specs[0], input_specs[0]]

    weight_specs = staticmethod(LayerNorm.weight_specs)

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        added = inputs[0]
        for r in inputs[1:]:
            added = added + r
        return [added, _layer_norm(added, params.get("gamma"),
                                   params.get("beta"),
                                   attrs.get("eps", 1e-5), attrs["axes"],
                                   ctx)]


@register_op
class AddBiasResidualLayerNorm(OpImpl):
    """Returns (x + attn_bias + residual, layer_norm of that sum)."""

    op_type = OpType.ADD_BIAS_RESIDUAL_LAYERNORM

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        return [input_specs[0], input_specs[0]]

    @staticmethod
    def weight_specs(attrs, input_specs):
        (shape, dtype) = input_specs[0]
        return ([WeightSpec("attn_bias", (shape[-1],), dtype,
                            ZeroInitializer())]
                + LayerNorm.weight_specs(attrs, input_specs))

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        (bias,) = _affine_parts((params["attn_bias"],), (-1,),
                                _split_dims(ctx, (-1,), x.dim()), x.dim())
        added = x + bias + inputs[1]
        return [added, _layer_norm(added, params.get("gamma"),
                                   params.get("beta"),
                                   attrs.get("eps", 1e-5), attrs["axes"],
                                   ctx)]


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
        return [_rms_norm(inputs[0], params["weight"],
                          attrs.get("eps", 1e-6), ctx)]


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
        return [added, _rms_norm(added, params["weight"],
                                 attrs.get("eps", 1e-6), ctx)]


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


@register_op
class BatchNorm(OpImpl):
    """Batch normalization over NCHW (or [N, C]) input, with the JAX
    package's arithmetic rather than ``F.batch_norm``'s: fp32 statistics
    in one pass about the running mean c (E[(x-c)^2] - (mean-c)^2), and
    the running variance updated with the biased batch variance
    (momentum 0.1). Eval uses the running statistics. The running
    statistics are op state (``init_state``); a training forward puts the
    updated pair in ``ctx.state_out``. When the batch is split over a
    mesh axis the statistics are the whole batch's, as under XLA SPMD:
    every rank updates the running statistics identically."""

    op_type = OpType.BATCHNORM

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        return [input_specs[0]]

    @staticmethod
    def weight_specs(attrs, input_specs):
        (shape, dtype) = input_specs[0]
        if not attrs.get("relu", False) and not attrs.get("affine", True):
            return []
        return [WeightSpec("scale", (shape[1],), dtype,
                           ConstantInitializer(1.0)),
                WeightSpec("bias", (shape[1],), dtype, ZeroInitializer())]

    @staticmethod
    def init_state(attrs, input_specs, device):
        c = input_specs[0][0][1]
        return {"running_mean": torch.zeros(c, device=device),
                "running_var": torch.ones(c, device=device)}

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        eps = attrs.get("eps", 1e-5)
        momentum = attrs.get("momentum", 0.1)
        dims = (0, 2, 3) if x.dim() == 4 else (0,)
        bshape = (1, -1, 1, 1) if x.dim() == 4 else (1, -1)
        state = ctx.state_in.get(ctx.layer_name)
        if ctx.training or state is None:
            rm = state["running_mean"] if state is not None else None
            xs = x.float()
            if rm is not None:
                xs = xs - rm.reshape(bshape)
            shard = ctx.row_shards.get(0)
            if shard is None:
                dmean = xs.mean(dim=dims)
                sq_mean = xs.square().mean(dim=dims)
            else:
                # this rank holds some of the batch's rows: the fp32 sum
                # and sum of squares (about the running mean) are summed
                # over the axis before normalising, so the statistics are
                # the whole batch's
                from flexflow_tpu_torch.parallel.collectives import (
                    psum, sum_grads)

                axis, n, _i = shard
                count = xs.numel() // xs.shape[1] * n
                sums = sum_grads(psum(torch.stack(
                    [xs.sum(dim=dims), xs.square().sum(dim=dims)]),
                    ctx.mesh, axis), ctx.mesh, axis) / count
                dmean, sq_mean = sums[0], sums[1]
            mean = dmean + rm if rm is not None else dmean
            var = torch.clamp_min(sq_mean - dmean.square(), 0.0)
            if state is not None:
                with torch.no_grad():
                    ctx.state_out[ctx.layer_name] = {
                        "running_mean": (1 - momentum) * rm
                        + momentum * mean,
                        "running_var": (1 - momentum)
                        * state["running_var"] + momentum * var}
        else:
            mean = state["running_mean"]
            var = state["running_var"]
        # normalization and affine folded into one fp32 scale and shift,
        # then one multiply-add over the activation in its own dtype
        rstd = torch.rsqrt(var.float() + eps)
        scale, shift = rstd, -mean.float() * rstd
        if "scale" in params:
            g = params["scale"].float()
            scale = rstd * g
            shift = shift * g + params["bias"].float()
        y = x * scale.to(x.dtype).reshape(bshape) \
            + shift.to(x.dtype).reshape(bshape)
        if attrs.get("relu", True):
            y = F.relu(y)
        return [y]
