"""Token selection for serving (counterpart of
``flexflow_tpu/ops/sampling_ops.py``): greedy ArgMax. The default
GenerationConfig is greedy; top-p Sampling comes with a later slice."""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import DataType, OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op


@register_op
class ArgMax(OpImpl):
    op_type = OpType.ARGMAX

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (s, _d) = input_specs[0]
        return [(tuple(s[:-1]), DataType.DT_INT32)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        # torch.argmax, like jnp.argmax, returns the first maximal index
        return [torch.argmax(inputs[0], dim=-1).to(torch.int32)]
