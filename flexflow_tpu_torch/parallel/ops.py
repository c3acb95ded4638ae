"""Parallel operators: the parallelism vocabulary as graph nodes
(counterpart of ``flexflow_tpu/parallel/ops.py``; reference
src/parallel_ops/{partition,combine,replicate,reduction,allreduce}.cc).

In the reference these are PCG nodes with data-movement kernels; in the
JAX package GSPMD sharding annotations. Each port rank holds its own
values, so here each node moves the data itself, over one mesh axis:

  Repartition(dim, axis)  -> this rank's chunk of ``dim`` (the whole
                             value in, ``1/n`` of it out)
  Combine(dim, axis)      -> all-gather of the chunks along ``dim``
  Reduction(dim, axis)    -> sum of the ranks' partial values, scattered
                             along ``dim`` (a reduce-scatter)
  Replicate               -> the value as it is (every rank holds it)
  AllReduce(axis)         -> sum of the ranks' partial values

The tensor-parallel serving ops run the same collectives inside their
forwards (``ops/linear.py``, ``ops/inc_attention.py``). A degree that
disagrees with the mesh axis is an error; an axis missing from the mesh,
or a dim it does not divide, leaves the value as it is, as in the JAX
package. The branch-parallel executors (``branch_parallel_apply``,
``branch_data_parallel_apply``) serve the training graph's branch plans
and come with parallel training.
"""

from __future__ import annotations

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op, register_op_as
from flexflow_tpu_torch.parallel.collectives import (all_gather, psum,
                                                     reduce_scatter)


def _check_degree(attrs, key, mesh, axis):
    """A degree must match the mesh axis size (0/None = use the axis)."""
    degree = attrs.get(key) or 0
    if degree and mesh is not None and axis in mesh.axis_names \
            and degree != mesh.shape[axis]:
        raise ValueError(
            f"{key}={degree} does not match mesh axis '{axis}' of size "
            f"{mesh.shape[axis]}; the port shards over whole named axes")


def _applies(mesh, axis, size) -> bool:
    return (mesh is not None and mesh.axis_size(axis) > 1
            and size % mesh.axis_size(axis) == 0)


class _ParallelOp(OpImpl):
    @staticmethod
    def infer_output_specs(attrs, input_specs):
        return [input_specs[0]]     # the logical tensor is unchanged


@register_op
class Repartition(_ParallelOp):
    op_type = OpType.REPARTITION

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        dim = attrs["repartition_dim"] % x.dim()
        axis = attrs.get("axis_name", "data")
        _check_degree(attrs, "repartition_degree", ctx.mesh, axis)
        if not _applies(ctx.mesh, axis, x.shape[dim]):
            return [x]
        n = ctx.mesh.axis_size(axis)
        return [x.chunk(n, dim=dim)[ctx.mesh.index(axis)].contiguous()]


@register_op
class Combine(_ParallelOp):
    op_type = OpType.COMBINE

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        dim = attrs.get("combine_dim", 0) % x.dim()
        axis = attrs.get("axis_name", "data")
        _check_degree(attrs, "combine_degree", ctx.mesh, axis)
        if ctx.mesh is None or ctx.mesh.axis_size(axis) <= 1:
            return [x]
        return [all_gather(x, ctx.mesh, axis, axis=dim)]


@register_op
class Reduction(_ParallelOp):
    """Sum the ranks' partial values and keep this rank's chunk along
    ``reduction_dim`` (the reference's reduce after a row-parallel
    linear, reduction.cc)."""

    op_type = OpType.REDUCTION

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        dim = attrs.get("reduction_dim", 0) % x.dim()
        axis = attrs.get("axis_name", "model")
        _check_degree(attrs, "reduction_degree", ctx.mesh, axis)
        if not _applies(ctx.mesh, axis, x.shape[dim]):
            return [x]
        return [reduce_scatter(x, ctx.mesh, axis, scatter_dimension=dim)]


@register_op_as(OpType.REPLICATE, OpType.ALLREDUCE)
class ReplicateOrAllReduce(_ParallelOp):
    """Replicate leaves the value as it is (each rank already holds it);
    AllReduce sums the ranks' partial values over ``axis_name``
    (``model`` by default)."""

    op_type = OpType.ALLREDUCE

    @staticmethod
    def forward(attrs, params, inputs, ctx):
        x = inputs[0]
        if attrs.get("op_type") != OpType.ALLREDUCE:
            return [x]
        axis = attrs.get("axis_name", "model")
        if ctx.mesh is None or ctx.mesh.axis_size(axis) <= 1:
            return [x]
        return [psum(x, ctx.mesh, axis)]
