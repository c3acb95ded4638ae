"""Operator implementations of the PyTorch/CUDA port. Importing this package
registers every ported op with ``ops.base``'s registry."""

from flexflow_tpu_torch.ops import (attention, cache,  # noqa: F401
                                    constants, conv, dropout, elementwise,
                                    embedding, inc_attention, linear,
                                    matmul, moe, norm, reduction_ops,
                                    sampling_ops, shape_ops, softmax)
from flexflow_tpu_torch.parallel import ops as _parallel_ops  # noqa: F401,E402
from flexflow_tpu_torch.ops.base import (OpContext, OpImpl, get_op_impl,
                                         register_op, register_op_as)

__all__ = ["OpContext", "OpImpl", "get_op_impl", "register_op",
           "register_op_as"]
