"""Elementwise unary, binary and scalar operators (counterpart of
``flexflow_tpu/ops/elementwise.py``): broadcast-aware binary ops, the unary
activations, ``Pow`` and the scalar ops. Each is one PyTorch call, as each
is one XLA op in the JAX package; nothing here needs a kernel of its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op_as

_BINARY_FNS = {
    OpType.EW_ADD: torch.add,
    OpType.EW_SUB: torch.sub,
    OpType.EW_MUL: torch.mul,
    OpType.EW_DIV: torch.div,
    OpType.EW_MAX: torch.maximum,
    OpType.EW_MIN: torch.minimum,
}

_UNARY_FNS = {
    OpType.RELU: F.relu,
    OpType.SIGMOID: torch.sigmoid,
    OpType.TANH: torch.tanh,
    OpType.ELU: F.elu,
    # exact (erf) form by default; the tanh form with attrs["approximate"]
    OpType.GELU: F.gelu,
    OpType.EXP: torch.exp,
    OpType.SIN: torch.sin,
    OpType.COS: torch.cos,
    OpType.RSQRT: torch.rsqrt,
    OpType.IDENTITY: lambda x: x,
}

_SCALAR_FNS = {
    OpType.SCALAR_MULTIPLY: lambda x, s: x * s,
    OpType.SCALAR_ADD: lambda x, s: x + s,
    OpType.SCALAR_SUB: lambda x, s: x - s,
    OpType.SCALAR_TRUE_DIV: lambda x, s: x / s,
}


def _same_spec(attrs, input_specs):
    return [input_specs[0]]


@register_op_as(*_BINARY_FNS)
class ElementBinary(OpImpl):
    op_type = OpType.EW_ADD   # registered for every binary type

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (s0, d0), (s1, _d1) = input_specs
        return [(tuple(torch.broadcast_shapes(tuple(s0), tuple(s1))), d0)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        return [_BINARY_FNS[attrs["op_type"]](inputs[0], inputs[1])]


@register_op_as(*_UNARY_FNS)
class ElementUnary(OpImpl):
    op_type = OpType.RELU     # registered for every unary type
    infer_output_specs = staticmethod(_same_spec)

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        if attrs["op_type"] == OpType.GELU and attrs.get("approximate"):
            return [F.gelu(inputs[0], approximate="tanh")]
        return [_UNARY_FNS[attrs["op_type"]](inputs[0])]


@register_op_as(OpType.POW)
class Pow(OpImpl):
    op_type = OpType.POW
    infer_output_specs = staticmethod(_same_spec)

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        return [torch.pow(inputs[0], attrs["exponent"])]


@register_op_as(*_SCALAR_FNS)
class ScalarOp(OpImpl):
    op_type = OpType.SCALAR_MULTIPLY
    infer_output_specs = staticmethod(_same_spec)

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        return [_SCALAR_FNS[attrs["op_type"]](inputs[0], attrs["scalar"])]
