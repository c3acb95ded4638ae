"""Linear (dense) operator (counterpart of ``flexflow_tpu/ops/linear.py``).

Weight layout: kernel [in_dim, out_dim] (activations @ kernel), bias
[out_dim] — the JAX package's layout, so parameters cross over unchanged.
Under tensor parallelism the kernel and bias are column shards
(``sharding_dims=(None, "model")``, as in the JAX package) and each rank
computes its columns of the output. In a train step and in a serving
forward the output stays split so, on its last dim over ``model``
(``OpContext.split_columns``, where GSPMD keeps it in the JAX package's
step and serving forward). In a train step an input split the same way
(the previous layer's columns) is gathered for the product through
``collectives.gather_product``, which saves only the rank's shard for
the backward and reduce-scatters the input's gradient; a whole input's
gradient, a partial sum over the rank's columns, is summed over
``model`` (``collectives.sum_grads``). A serving forward hands the op its
input gathered (``placement.Walk.gather``, once a forward for all its
consumers). Outside the walk (a model compiled for inference that no
walk runs) the op gathers its columns (``gather_columns``) and hands the
consumer the whole output. A searched strategy may instead rest the
kernel in row shards (``tp-row``, ``parallel/placement.py``): the rank
then takes its slice of the input's features (in a serving forward, the
split the walk hands it as it is), and the partial products are
reduce-scattered over ``model`` onto the output's split before the
rank's part of the bias is added, or summed before the whole bias where
the output is whole.

The product is ``quant.qmatmul``: a plain ``torch.matmul`` for a float
kernel (the JAX package leaves it to XLA; no TPU kernel), the dequant-GEMM
K3 for a quantized one on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.core.initializer import (default_bias_initializer,
                                                 default_kernel_initializer)
from flexflow_tpu_torch.core.layer import WeightSpec
from flexflow_tpu_torch.ffconst import ActiMode, DataType, OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op
from flexflow_tpu_torch.quant import qmatmul


def gather_columns(y, ctx):
    """Concatenate the ``model``-axis peers' column shards of ``y``."""
    from flexflow_tpu_torch.parallel.collectives import all_gather

    return all_gather(y, ctx.mesh, "model", axis=-1)


def own_part(w, ctx):
    """This rank's chunk of a whole ``w`` along its last dim over
    ``model`` (the part of a bias that lines up with its output
    split)."""
    n = ctx.mesh.axis_size("model")
    return w.chunk(n, dim=-1)[ctx.mesh.index("model")]


def apply_activation(x, mode: ActiMode):
    if mode == ActiMode.AC_MODE_NONE:
        return x
    if mode == ActiMode.AC_MODE_RELU:
        return F.relu(x)
    if mode == ActiMode.AC_MODE_SIGMOID:
        return torch.sigmoid(x)
    if mode == ActiMode.AC_MODE_TANH:
        return torch.tanh(x)
    if mode == ActiMode.AC_MODE_GELU:
        return F.gelu(x)
    raise ValueError(mode)


@register_op
class Linear(OpImpl):
    op_type = OpType.LINEAR
    quant_aware = True

    @staticmethod
    def infer_output_specs(attrs, input_specs):
        (shape, dtype) = input_specs[0]
        out_dtype = attrs.get("data_type") or dtype
        if attrs.get("keep_f32_logits"):
            out_dtype = DataType.DT_FLOAT   # forward emits f32 logits
        return [(tuple(shape[:-1]) + (attrs["out_dim"],), out_dtype)]

    @staticmethod
    def weight_specs(attrs, input_specs):
        (shape, dtype) = input_specs[0]
        out_dim = attrs["out_dim"]
        wdtype = attrs.get("data_type") or dtype
        specs = [WeightSpec("kernel", (shape[-1], out_dim), wdtype,
                            attrs.get("kernel_initializer")
                            or default_kernel_initializer(),
                            sharding_dims=(None, "model"))]
        if attrs.get("use_bias", True):
            specs.append(WeightSpec("bias", (out_dim,), wdtype,
                                    attrs.get("bias_initializer")
                                    or default_bias_initializer(),
                                    sharding_dims=("model",)))
        return specs

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        compute_dtype = ctx.compute_dtype or x.dtype
        # logits heads keep the gemm's fp32 accumulator: bf16 ties between
        # near-equal logits would flip greedy argmax between programs. A
        # quantized head does so inside K3, with no fp32 copy of the weight
        out_dtype = torch.float32 if attrs.get("keep_f32_logits") else None
        kernel = params["kernel"]
        sharded = kernel.shape[1] != attrs["out_dim"]
        # a row shard (``tp-row``): this rank's features in, a partial
        # product out
        rows = attrs.get("row_parallel", False)
        split_in = ctx.split_dims((-1,), x.dim())
        if split_in and not rows:
            # a train step's input split over ``model`` on the features
            # this product contracts (the walk passes it only to a
            # column shard)
            from flexflow_tpu_torch.parallel.collectives import \
                gather_product

            (y,) = gather_product(x.to(compute_dtype), ctx.mesh, "model",
                                  [kernel.to(compute_dtype)],
                                  dtype=out_dtype or compute_dtype)
        else:
            if sharded:
                from flexflow_tpu_torch.parallel.collectives import \
                    sum_grads

                x = sum_grads(x, ctx.mesh, "model")
            if rows and not split_in:
                from flexflow_tpu_torch.parallel.collectives import split

                x = split(x, ctx.mesh, "model", x.dim() - 1)
            y = qmatmul(x, kernel, compute_dtype, out_dtype=out_dtype)
        bias = params.get("bias") if attrs.get("use_bias", True) else None
        if rows:
            from flexflow_tpu_torch.parallel.collectives import (
                psum, reduce_scatter)

            if ctx.split_columns:
                # the output stays split on its last dim: each rank sums
                # its part of the partial products
                y = reduce_scatter(y, ctx.mesh, "model",
                                   scatter_dimension=y.dim() - 1)
                if bias is not None:
                    bias = own_part(bias, ctx)
            else:
                y = psum(y, ctx.mesh, "model")
        if bias is not None:
            y = y + bias.to(compute_dtype)
        y = apply_activation(y, attrs.get("activation",
                                          ActiMode.AC_MODE_NONE))
        if sharded and not ctx.split_columns:
            # a column shard outside the walk: the consumer takes the
            # whole output
            y = gather_columns(y, ctx)
        return [y]
