"""Constant, selection and free-parameter operators (counterpart of
``flexflow_tpu/ops/constants.py``): CONSTANT (an embedded literal),
WEIGHT (a free-standing trainable parameter, the reference PCG's Weight
node), WHERE, COMPARE and BROADCAST_TO."""

from __future__ import annotations

import torch

from flexflow_tpu_torch.core.initializer import ConstantInitializer
from flexflow_tpu_torch.core.layer import WeightSpec
from flexflow_tpu_torch.ffconst import DataType, OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op


@register_op
class Constant(OpImpl):
    """An embedded literal tensor (attrs: value as nested lists, dtype
    name, shape), made on the forward's device."""

    op_type = OpType.CONSTANT

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        return [(tuple(attrs["shape"]), DataType(attrs["dtype"]))]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        dt = DataType(attrs["dtype"]).to_torch()
        return [torch.tensor(attrs["value"], dtype=dt,
                             device=ctx.device or "cpu").reshape(
                                 tuple(attrs["shape"]))]


@register_op
class WeightParam(OpImpl):
    """A free-standing trainable parameter (attrs: shape, dtype name,
    init value)."""

    op_type = OpType.WEIGHT

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        return [(tuple(attrs["shape"]), DataType(attrs["dtype"]))]

    @staticmethod
    def weight_specs(attrs, input_specs):
        return [WeightSpec("weight", tuple(attrs["shape"]),
                           DataType(attrs["dtype"]),
                           ConstantInitializer(attrs.get("init", 1.0)))]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        return [params["weight"]]


@register_op
class Where(OpImpl):
    """``where(cond, a, b)``, broadcast as ``torch.where``."""

    op_type = OpType.WHERE

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (sc, _), (sa, da), (sb, _) = input_specs
        return [(tuple(torch.broadcast_shapes(tuple(sc), tuple(sa),
                                              tuple(sb))), da)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        c, a, b = inputs
        return [torch.where(c.bool(), a, b.to(a.dtype))]


_CMP = {"eq": torch.eq, "ne": torch.ne, "lt": torch.lt, "le": torch.le,
        "gt": torch.gt, "ge": torch.ge}


@register_op
class Compare(OpImpl):
    """Elementwise comparison (attrs["cmp"] in eq/ne/lt/le/gt/ge) with a
    tensor input or attrs["scalar"]; a bool output."""

    op_type = OpType.COMPARE

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        if len(input_specs) == 2:
            (s0, _), (s1, _) = input_specs
            shape = tuple(torch.broadcast_shapes(tuple(s0), tuple(s1)))
        else:
            shape = tuple(input_specs[0][0])
        return [(shape, DataType.DT_BOOLEAN)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        rhs = inputs[1] if len(inputs) > 1 else attrs["scalar"]
        return [_CMP[attrs["cmp"]](inputs[0], rhs)]


@register_op
class BroadcastTo(OpImpl):
    """A materialised broadcast (torch ``Tensor.expand``)."""

    op_type = OpType.BROADCAST_TO

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        return [(tuple(attrs["shape"]), input_specs[0][1])]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        return [inputs[0].expand(tuple(attrs["shape"])).contiguous()]
