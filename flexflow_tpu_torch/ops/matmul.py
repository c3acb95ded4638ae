"""BatchMatmul operator (counterpart of ``flexflow_tpu/ops/matmul.py``;
reference src/ops/batch_matmul.cc): ``a @ b`` over the leading batch
dims, accumulated in fp32 and returned in ``a``'s dtype, as the JAX
package's ``preferred_element_type=float32`` product. XLA lowers it
there, so the port has no kernel: ``torch.matmul``."""

from __future__ import annotations

import torch

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op


@register_op
class BatchMatmul(OpImpl):
    op_type = OpType.BATCH_MATMUL

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (sa, da), (sb, _db) = input_specs
        if tuple(sa[:-2]) != tuple(sb[:-2]) or sa[-1] != sb[-2]:
            raise ValueError(f"batch_matmul: shapes {sa} and {sb} do not "
                             "multiply")
        return [(tuple(sa[:-1]) + (sb[-1],), da)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        a, b = inputs
        if a.dtype in (torch.bfloat16, torch.float16):
            # the product of two 16-bit values is exact in fp32
            return [torch.matmul(a.float(), b.float()).to(a.dtype)]
        return [torch.matmul(a, b.to(a.dtype))]
