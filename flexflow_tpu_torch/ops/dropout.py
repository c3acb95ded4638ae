"""Dropout operator (counterpart of ``flexflow_tpu/ops/dropout.py``):
a Bernoulli keep mask scaled by 1/keep, drawn from the context's
generator; the identity when not training, at rate 0 or without a
generator. The draws cannot match JAX's (different generators). In a
parallel train step the mask is drawn for the whole batch and each rank
keeps its rows (``OpContext.keep_mask``), so the masks equal one
rank's."""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op


@register_op
class Dropout(OpImpl):
    op_type = OpType.DROPOUT

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        return [input_specs[0]]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        rate = attrs.get("rate", 0.5)
        if not ctx.training or rate == 0.0:
            return [x]
        keep = 1.0 - rate
        mask = ctx.keep_mask(x.shape, keep, x.device)
        if mask is None:
            return [x]
        return [torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))]
