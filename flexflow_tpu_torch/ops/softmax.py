"""Softmax operator (counterpart of ``flexflow_tpu/ops/softmax.py``).

A model's final Softmax still runs in a train step (the metrics read its
output); the loss takes the logits before it (``training/loss.py``)."""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op


@register_op
class Softmax(OpImpl):
    op_type = OpType.SOFTMAX

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        return [input_specs[0]]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        return [torch.softmax(inputs[0], dim=attrs.get("axis", -1))]
