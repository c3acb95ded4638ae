"""Conv2D and Pool2D operators, NCHW (counterpart of
``flexflow_tpu/ops/conv.py``): ``F.conv2d`` (cuDNN on the card) and
PyTorch's pooling, as the JAX package leaves them to XLA's
``conv_general_dilated`` and ``reduce_window``.

The JAX package rewrites stride-2 stems on few channels as a stride-1
conv on a space-to-depth view (a TPU MXU lowering of the same linear
function); the port calls ``F.conv2d`` directly. The conv runs in the
compute dtype; weights keep theirs, so their gradients do too.
"""

from __future__ import annotations

import torch.nn.functional as F

from flexflow_tpu_torch.core.initializer import (default_bias_initializer,
                                                 default_kernel_initializer)
from flexflow_tpu_torch.core.layer import WeightSpec
from flexflow_tpu_torch.ffconst import ActiMode, OpType, PoolType
from flexflow_tpu_torch.ops.base import OpImpl, register_op
from flexflow_tpu_torch.ops.linear import apply_activation


def _conv_out(size, kernel, stride, pad):
    return (size + 2 * pad - kernel) // stride + 1


def _out_hw(attrs, h, w):
    return (_conv_out(h, attrs["kernel_h"], attrs["stride_h"],
                      attrs["padding_h"]),
            _conv_out(w, attrs["kernel_w"], attrs["stride_w"],
                      attrs["padding_w"]))


@register_op
class Conv2D(OpImpl):
    op_type = OpType.CONV2D

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (s, d) = input_specs[0]
        n, _c, h, w = s
        return [((n, attrs["out_channels"]) + _out_hw(attrs, h, w), d)]

    @staticmethod
    def weight_specs(attrs, input_specs):
        (s, d) = input_specs[0]
        groups = attrs.get("groups", 1)
        specs = [WeightSpec("kernel", (attrs["out_channels"], s[1] // groups,
                                       attrs["kernel_h"], attrs["kernel_w"]),
                            d, attrs.get("kernel_initializer")
                            or default_kernel_initializer())]
        if attrs.get("use_bias", True):
            specs.append(WeightSpec("bias", (attrs["out_channels"],), d,
                                    attrs.get("bias_initializer")
                                    or default_bias_initializer()))
        return specs

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        cd = ctx.compute_dtype or x.dtype
        y = F.conv2d(x.to(cd), params["kernel"].to(cd),
                     stride=(attrs["stride_h"], attrs["stride_w"]),
                     padding=(attrs["padding_h"], attrs["padding_w"]),
                     groups=attrs.get("groups", 1))
        if attrs.get("use_bias", True):
            y = y + params["bias"].to(cd).reshape(1, -1, 1, 1)
        return [apply_activation(y, attrs.get("activation",
                                              ActiMode.AC_MODE_NONE))]


@register_op
class Pool2D(OpImpl):
    """Max pooling pads with -inf; average pooling divides by the count of
    unpadded elements in the window (JAX's ``reduce_window`` sum over the
    window of ones). PyTorch takes a padding of at most half the kernel
    and raises beyond it."""

    op_type = OpType.POOL2D

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (s, d) = input_specs[0]
        n, c, h, w = s
        return [((n, c) + _out_hw(attrs, h, w), d)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        kernel = (attrs["kernel_h"], attrs["kernel_w"])
        stride = (attrs["stride_h"], attrs["stride_w"])
        padding = (attrs["padding_h"], attrs["padding_w"])
        if attrs.get("pool_type", PoolType.POOL_MAX) == PoolType.POOL_MAX:
            y = F.max_pool2d(x, kernel, stride, padding)
        else:
            y = F.avg_pool2d(x, kernel, stride, padding,
                             count_include_pad=False)
        return [apply_activation(y, attrs.get("activation",
                                              ActiMode.AC_MODE_NONE))]
