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
``branch_data_parallel_apply``) serve the branch plans of the Unity
search (``core/branch_exec.py``): each rank runs only its branch, and an
all-gather over the axis gives every rank every branch's output.
"""

from __future__ import annotations

from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.ops.base import OpImpl, register_op, register_op_as
from flexflow_tpu_torch.parallel.collectives import (all_gather, psum,
                                                     reduce_scatter,
                                                     sum_grads)


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


def _pad_dim1(y, width: int):
    """``y`` zero-padded on dim 1 to ``width``."""
    import torch.nn.functional as F

    pad = [0, 0] * (y.dim() - 2) + [0, width - y.shape[1]]
    return F.pad(y, pad)


def branch_parallel_apply(mesh, axis, branch_fns, out_channels, x,
                          allocs=None):
    """Independent branch subgraphs on DISJOINT rank slices of a mesh
    axis: the runtime form of a searched nonsequence split (reference
    NonsequenceSplit, include/flexflow/graph.h:156; the JAX package's
    ``parallel/ops.py`` counterpart).

    Each rank evaluates only its slice's branch on the whole ``x``; the
    outputs are zero-padded on dim 1 (channels) to a common width,
    all-gathered over ``axis``, and returned per branch with their true
    channel counts, the first rank of each slice standing for it.
    Branches must agree on every dim but dim 1. ``x`` comes in whole on
    every rank; its gradient is summed over the axis (``sum_grads``), as
    the JAX shard_map's transpose sums a replicated input's.

    ``allocs`` (optional): per-branch rank counts summing to the axis size
    (the reference's unequal vertical(i)/horizontal(i) resource
    partitions, graph.cc:220-244); default one rank a branch."""
    d = mesh.axis_size(axis)
    nb = len(branch_fns)
    if allocs is None:
        assert nb == d == len(out_channels)
        allocs = [1] * nb
    assert sum(allocs) == d and len(allocs) == nb == len(out_channels)
    starts = [sum(allocs[:i]) for i in range(nb)]
    cmax = max(out_channels)
    j = mesh.index(axis)
    bi = sum(1 for s in starts if s <= j) - 1     # the slice rank j is in
    x = sum_grads(x, mesh, axis)
    y = _pad_dim1(branch_fns[bi](x), cmax)
    g = all_gather(y.unsqueeze(0), mesh, axis, axis=0)    # [d, B, Cmax..]
    return [g[starts[i], :, :c] for i, c in enumerate(out_channels)]


def branch_data_parallel_apply(mesh, axis, branch_fns, branch_params,
                               out_channels, x):
    """Nonsequence-split execution with data parallelism INSIDE each
    branch slice, the form the search's cost model assumes
    (search/graph_search.py ``_try_nonsequence_splits`` re-optimizes each
    branch under data degree d // nb).

    The ``axis`` (size d) is viewed as nb slices of k = d // nb ranks.
    Rank j runs branch ``j // k`` on batch rows
    ``[(j % k) * B/k, (j % k + 1) * B/k)`` of the whole ``x``, so each
    rank's flops equal pure DP's while it executes only its branch's ops
    at an nb-times larger per-op batch. The outputs are zero-padded on
    dim 1 to a common width, all-gathered once over the axis, and
    returned per branch at full batch with their true channel counts.

    ``branch_fns[i]`` takes ``(x_rows, branch_params[i])``. A rank makes
    gradients only for its branch's parameters over its rows: summing
    each branch's parameter gradients over the axis (the caller's
    gradient reduction) gives the whole batch's, as the JAX shard_map
    transpose does; ``x``'s gradient is summed over the axis here
    (``sum_grads``). Requires ``d % nb == 0`` and ``B % (d // nb) == 0``;
    the caller falls back to sequential execution otherwise."""
    nb = len(branch_fns)
    d = mesh.axis_size(axis)
    assert d % nb == 0, (d, nb)
    k = d // nb
    B = x.shape[0]
    assert B % k == 0, (B, k)
    mb = B // k
    cmax = max(out_channels)
    j = mesh.index(axis)
    x = sum_grads(x, mesh, axis)
    xl = x[(j % k) * mb:(j % k + 1) * mb]
    y = _pad_dim1(branch_fns[j // k](xl, branch_params[j // k]), cmax)
    g = all_gather(y.unsqueeze(0), mesh, axis, axis=0)   # [d, mb, Cmax..]
    # ranks along the axis are j = branch * k + shard, so the leading
    # [d, mb] dims reshape to per-branch full batches
    g = g.reshape((nb, k * mb) + tuple(g.shape[2:]))
    return [g[i, :, :c] for i, c in enumerate(out_channels)]
