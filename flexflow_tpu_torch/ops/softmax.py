"""Softmax operator (counterpart of ``flexflow_tpu/ops/softmax.py``).

A model's final Softmax still runs in a train step (the metrics read its
output); the loss takes the logits before it (``training/loss.py``).

In a tensor-parallel train step the softmax axis may be split over
``model`` (``OpContext.row_shards``; a vocabulary split across ranks, as
GSPMD keeps it in the JAX package's step): the max is taken over the
axis (``pmax``, outside autograd: it only shifts the exponent), then
the exponentials' sum (``psum``); the backward sums ``g * y`` over the
axis (``_SplitSoftmax``)."""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op


class _SplitSoftmax(torch.autograd.Function):
    """The whole tensor's softmax over ``dim``, of which ``x`` is this
    rank's part of ``dim`` (split over ``axis``), in fp32 as
    ``torch.softmax`` computes a 16-bit input. Saves only its output, as
    ``torch.softmax`` does (backward: ``y * (g - sum(g * y))``, the sum
    added over the axis)."""

    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        from flexflow_tpu_torch.parallel.collectives import pmax, psum

        xf = x.float()
        m = pmax(xf.amax(dim=dim, keepdim=True), mesh, axis)
        e = torch.exp(xf - m)
        y = (e / psum(e.sum(dim=dim, keepdim=True), mesh, axis)).to(x.dtype)
        ctx.save_for_backward(y)
        ctx.args = (dim, mesh, axis)
        return y

    @staticmethod
    def backward(ctx, g):
        from flexflow_tpu_torch.parallel.collectives import psum

        (y,) = ctx.saved_tensors
        dim, mesh, axis = ctx.args
        yf, gf = y.float(), g.float()
        dot = psum((gf * yf).sum(dim=dim, keepdim=True), mesh, axis)
        return (yf * (gf - dot)).to(g.dtype), None, None, None


@register_op
class Softmax(OpImpl):
    op_type = OpType.SOFTMAX

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        return [input_specs[0]]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        dim = attrs.get("axis", -1)
        split = ctx.split_dims((dim,), x.dim()) if ctx is not None else {}
        if split:
            ((axis, _n, _i),) = split.values()
            return [_SplitSoftmax.apply(x, dim, ctx.mesh, axis)]
        return [torch.softmax(x, dim=dim)]
