"""Shape operators: concat, split, reshape, transpose, reverse, flat, cast
and slice (counterpart of ``flexflow_tpu/ops/shape_ops.py``).

Data movement only; ``Cast`` changes the dtype to exactly the one it was
built with, whatever the forward's compute dtype (the beam draft's packed
``[probs, ids]`` output depends on its ids staying fp32).
"""

from __future__ import annotations

import numpy as np
import torch

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op


@register_op
class Concat(OpImpl):
    op_type = OpType.CONCAT

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        axis = attrs["axis"]
        (s0, d0) = input_specs[0]
        out = list(s0)
        out[axis] = sum(s[axis] for s, _ in input_specs)
        return [(tuple(out), d0)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        return [torch.cat(inputs, dim=attrs["axis"])]


@register_op
class Split(OpImpl):
    op_type = OpType.SPLIT

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        axis = attrs["axis"]
        sizes = attrs["sizes"]
        (s0, d0) = input_specs[0]
        assert sum(sizes) == s0[axis], (sizes, s0, axis)
        outs = []
        for sz in sizes:
            shape = list(s0)
            shape[axis] = sz
            outs.append((tuple(shape), d0))
        return outs

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        return list(torch.split(inputs[0], list(attrs["sizes"]),
                                dim=attrs["axis"]))


@register_op
class Reshape(OpImpl):
    op_type = OpType.RESHAPE

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (s0, d0) = input_specs[0]
        shape = list(attrs["shape"])
        if -1 in shape:
            known = int(np.prod([d for d in shape if d != -1]))
            shape[shape.index(-1)] = int(np.prod(s0)) // known
        assert int(np.prod(shape)) == int(np.prod(s0)), (shape, s0)
        return [(tuple(shape), d0)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        return [torch.reshape(inputs[0], tuple(attrs["shape"]))]


@register_op
class Transpose(OpImpl):
    op_type = OpType.TRANSPOSE

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (s0, d0) = input_specs[0]
        return [(tuple(s0[p] for p in attrs["perm"]), d0)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        return [inputs[0].permute(*attrs["perm"])]


@register_op
class Reverse(OpImpl):
    op_type = OpType.REVERSE

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        return [input_specs[0]]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        return [torch.flip(inputs[0], dims=[attrs["axis"]])]


@register_op
class Flat(OpImpl):
    """Flatten all non-batch dims."""

    op_type = OpType.FLAT

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (s0, d0) = input_specs[0]
        return [((s0[0], int(np.prod(s0[1:]))), d0)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        return [torch.reshape(x, (x.shape[0], -1))]


@register_op
class Cast(OpImpl):
    op_type = OpType.CAST

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (s0, _d0) = input_specs[0]
        return [(s0, attrs["dtype"])]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        return [inputs[0].to(attrs["dtype"].to_torch())]


@register_op
class Slice(OpImpl):
    """Static slice: starts/ends per dim (ends exclusive; None = full
    extent; negatives wrap); squeeze_dims drop size-1 sliced dims."""

    op_type = OpType.SLICE

    @staticmethod
    def _resolve(attrs, shape):
        starts, ends = [], []
        for d, size in enumerate(shape):
            s, e = (attrs["starts"][d], attrs["ends"][d]) \
                if d < len(attrs["starts"]) else (None, None)
            s = 0 if s is None else (s + size if s < 0 else s)
            e = size if e is None else (e + size if e < 0 else e)
            starts.append(max(0, min(s, size)))
            ends.append(max(starts[-1], min(e, size)))
        return starts, ends

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (shape, dtype) = input_specs[0]
        starts, ends = Slice._resolve(attrs, shape)
        out = [e - s for s, e in zip(starts, ends)]
        squeeze = set(attrs.get("squeeze_dims", ()))
        for d in squeeze:
            if out[d] != 1:
                raise IndexError(
                    f"slice squeeze dim {d} has extent {out[d]} "
                    f"(start={attrs['starts'][d]} on size {shape[d]})")
        out = [n for d, n in enumerate(out) if d not in squeeze]
        return [(tuple(out), dtype)]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        starts, ends = Slice._resolve(attrs, x.shape)
        y = x[tuple(slice(s, e) for s, e in zip(starts, ends))]
        for d in sorted(set(attrs.get("squeeze_dims", ())), reverse=True):
            y = y.squeeze(d)
        return [y]
