"""Reduction and selection operators: reduce_sum, reduce_mean, mean,
gather, top_k and arg_top_k (counterpart of
``flexflow_tpu/ops/reduction_ops.py``).

``jax.lax.top_k`` orders equal values by their lower index; ``torch.topk``
promises no order for ties (on CUDA in particular), so the selections
here take a stable descending sort and slice it.
"""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import DataType, OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op, register_op_as


def stable_top_k(x: torch.Tensor, k: int):
    """(values, int64 indices) of the k largest along the last dim, ties
    in the order of their lower index (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _reduced_shape(shape, axes, keepdims):
    axes = tuple(a % len(shape) for a in axes)
    if keepdims:
        return tuple(1 if i in axes else d for i, d in enumerate(shape))
    return tuple(d for i, d in enumerate(shape) if i not in axes)


@register_op_as(OpType.REDUCE_SUM, OpType.REDUCE_MEAN)
class Reduce(OpImpl):
    op_type = OpType.REDUCE_SUM

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (s, d) = input_specs[0]
        return [(_reduced_shape(s, attrs["axes"],
                                attrs.get("keepdims", False)), d)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        fn = torch.sum if attrs["op_type"] == OpType.REDUCE_SUM \
            else torch.mean
        return [fn(inputs[0], dim=tuple(attrs["axes"]),
                   keepdim=attrs.get("keepdims", False))]


@register_op
class Mean(OpImpl):
    op_type = OpType.MEAN

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (s, d) = input_specs[0]
        return [(_reduced_shape(s, attrs["dims"],
                                attrs.get("keepdims", False)), d)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        return [torch.mean(inputs[0], dim=tuple(attrs["dims"]),
                           keepdim=attrs.get("keepdims", False))]


@register_op
class Gather(OpImpl):
    """Gather along a dim with an index tensor (torch.gather semantics)."""

    op_type = OpType.GATHER

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (_si, di) = input_specs[0]
        (sidx, _didx) = input_specs[1]
        return [(sidx, di)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x, idx = inputs
        return [torch.gather(x, attrs["dim"], idx.long())]


@register_op
class TopK(OpImpl):
    """(values, int32 indices) of the top-k along the last dim."""

    op_type = OpType.TOPK

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (s, d) = input_specs[0]
        out_shape = tuple(s[:-1]) + (attrs["k"],)
        return [(out_shape, d), (out_shape, DataType.DT_INT32)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        values, indices = stable_top_k(inputs[0], attrs["k"])
        return [values, indices.to(torch.int32)]


@register_op
class ArgTopK(OpImpl):
    """Top-k indices; the speculative-decoding variant also returns the
    softmax probabilities at those indices: ``[probs, int32 ids]``, the
    probabilities in the input's dtype (the fp32 logits of a beam
    draft's head)."""

    op_type = OpType.ARG_TOPK

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (s, _d) = input_specs[0]
        out_shape = tuple(s[:-1]) + (attrs["k"],)
        if attrs.get("speculative_decoding", False):
            return [(out_shape, DataType.DT_FLOAT),
                    (out_shape, DataType.DT_INT32)]
        return [(out_shape, DataType.DT_INT32)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        _values, indices = stable_top_k(x, attrs["k"])
        if attrs.get("speculative_decoding", False):
            p = torch.gather(torch.softmax(x, dim=-1), -1, indices)
            return [p, indices.to(torch.int32)]
        return [indices.to(torch.int32)]
