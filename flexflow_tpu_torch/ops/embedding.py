"""Embedding operator (counterpart of ``flexflow_tpu/ops/embedding.py``):
row gather with aggregation modes NONE/SUM/AVG. A quantized table gathers
packed rows and dequantizes only those (``quant.qtake``). Under tensor
parallelism the table is split by columns (``sharding_dims=(None,
"model")``) and the rows gathered from each shard are concatenated over
the ``model`` axis. A searched strategy may split the table by rows
instead (``tp-vocab``): each rank gathers the ids it holds, zeros the
others, and the rows are summed over ``model``."""

from __future__ import annotations

from flexflow_tpu_torch.core.initializer import NormInitializer
from flexflow_tpu_torch.core.layer import WeightSpec
from flexflow_tpu_torch.ffconst import AggrMode, DataType, OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op
from flexflow_tpu_torch.quant import qtake


@register_op
class Embedding(OpImpl):
    op_type = OpType.EMBEDDING
    quant_aware = True

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (shape, _dtype) = input_specs[0]
        out_dim = attrs["out_dim"]
        dtype = attrs.get("data_type", DataType.DT_FLOAT)
        if attrs.get("aggr", AggrMode.AGGR_MODE_NONE) == AggrMode.AGGR_MODE_NONE:
            return [(tuple(shape) + (out_dim,), dtype)]
        # SUM/AVG reduce over the last (bag) dim
        return [(tuple(shape[:-1]) + (out_dim,), dtype)]

    @staticmethod
    def weight_specs(attrs, input_specs):
        dtype = attrs.get("data_type", DataType.DT_FLOAT)
        init = attrs.get("kernel_initializer") or NormInitializer(stddev=0.02)
        return [WeightSpec("weight", (attrs["num_entries"], attrs["out_dim"]),
                           dtype, init, sharding_dims=(None, "model"))]

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        ids = inputs[0]
        vocab = attrs.get("vocab_parallel", False)
        if vocab:
            # a row shard of the table (``tp-vocab``): the ids this rank
            # holds
            rows = params["weight"].shape[0]
            ids = ids - ctx.mesh.index("model") * rows
            hit = (ids >= 0) & (ids < rows)
            ids = ids.clamp(0, rows - 1)
        out = qtake(params["weight"], ids)
        if vocab:
            out = out * hit.unsqueeze(-1).to(out.dtype)
        aggr = attrs.get("aggr", AggrMode.AGGR_MODE_NONE)
        if aggr == AggrMode.AGGR_MODE_SUM:
            out = out.sum(dim=-2)
        elif aggr == AggrMode.AGGR_MODE_AVG:
            out = out.mean(dim=-2)
        if vocab:
            from flexflow_tpu_torch.parallel.collectives import psum

            out = psum(out, ctx.mesh, "model")
        if params["weight"].shape[1] != attrs["out_dim"]:
            from flexflow_tpu_torch.ops.linear import gather_columns

            out = gather_columns(out, ctx)
        return [out]
