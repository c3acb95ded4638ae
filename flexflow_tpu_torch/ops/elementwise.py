"""Elementwise binary operators of the serving path (counterpart of
``flexflow_tpu/ops/elementwise.py``); the slice needs EW_ADD only."""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op


@register_op
class ElementAdd(OpImpl):
    op_type = OpType.EW_ADD

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (s0, d0), (s1, _d1) = input_specs
        return [(tuple(torch.broadcast_shapes(tuple(s0), tuple(s1))), d0)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        return [inputs[0] + inputs[1]]
