"""Branch-parallel (nonsequence split) execution inside the train step
(counterpart of ``flexflow_tpu/core/branch_exec.py``).

The Unity search tags fork-join branch ops with ``OpStrategy.branch``
(search/graph_search.py ``_try_nonsequence_splits`` — reference
NonsequenceSplit, include/flexflow/graph.h:156). This module turns those
tags into an executable plan: at compile time the layer graph is scanned
for concat-joined fork regions whose branches are fully tagged, and the
placement walk (``FFModel._run_split``) then executes each region through
``parallel.ops.branch_data_parallel_apply``: rank j of the ``data`` axis
runs only branch ``j // k`` (k = ranks a branch) on its part of the batch,
instead of every rank running every branch.

A region is only planned when it is provably safe (see
``build_branch_plan``, the JAX package's conditions); anything else
falls back to the ordinary sequential walk, where branch tags degrade to
plain output specs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from flexflow_tpu_torch.ffconst import OpType


@dataclasses.dataclass
class BranchRegion:
    fork_tensor_id: int
    join_layer_name: str                 # the concat that merges branches
    concat_axis: int
    chains: List[List[object]]           # per-branch layer objects, topo order
    out_channels: List[int]              # per-branch concat-dim width
    nb: int


@dataclasses.dataclass
class BranchPlan:
    regions: List[BranchRegion]
    by_join: Dict[str, BranchRegion]
    skip: set                            # layer names executed inside regions


def _producer_map(model):
    prod = {}
    for ly in model.layers:
        for t in ly.outputs:
            prod[t.tensor_id] = ly
    return prod


def build_branch_plan(model) -> Optional[BranchPlan]:
    """Scan the layer graph for executable branch regions.

    Safety conditions (violations fall back to sequential execution):
    the mesh's only non-unit axis is ``data`` and its size is divisible
    by the branch count; every branch is a chain of stateless layers
    (no op_state: BN running stats would see one branch's rows)
    consuming only the fork tensor or same-branch outputs; the join is
    a single concat on a non-batch dim consuming exactly one output per
    branch; no offload/quantization rewrites apply.
    """
    strategy = model.strategy
    if strategy is None or model.mesh is None:
        return None
    mesh = model.mesh
    d = mesh.axis_size("data")
    if d < 2:
        return None
    if any(mesh.shape[a] != 1 for a in mesh.axis_names if a != "data"):
        return None                     # branch slices are data-axis only
    if getattr(model, "_offloaded", None):
        return None
    cfg = model.config
    from flexflow_tpu_torch.ffconst import CompMode

    if (cfg.quantization_type
            and getattr(model, "comp_mode", None)
            == CompMode.COMP_MODE_INFERENCE):
        return None

    # RNG-consuming ops (dropout, train-MHA dropout, sampling) cannot run
    # inside the region: each rank runs one branch on part of the batch,
    # so its layers would draw from the generator in another order, and
    # at other shapes, than the sequential walk's full-batch draws
    rng_ops = {OpType.DROPOUT, OpType.MULTIHEAD_ATTENTION,
               OpType.SAMPLING}

    tags = {}
    for ly in model.layers:
        st = strategy.ops.get(ly.name)
        if st is not None and st.branch is not None:
            if (getattr(st, "branch_alloc", None) is not None
                    or getattr(st, "branch_axis", "data") != "data"):
                # unequal or non-data-axis splits have no equal-slice
                # plan (per-rank shapes would differ): leave THIS op
                # untagged so only the region it belongs to falls back
                # to sequential execution; other valid equal-slice
                # regions in the same strategy still plan.
                # branch_parallel_apply(allocs=...) covers the unequal
                # form for explicit use
                continue
            tags[ly.name] = st.branch

    if not tags:
        return None

    prod = _producer_map(model)
    stateful = set(getattr(model, "op_state", {}) or {})
    regions: List[BranchRegion] = []
    claimed: set = set()

    for join in model.layers:
        if join.op_type != OpType.CONCAT:
            continue
        axis = join.attrs.get("axis", 1)
        nd0 = len(join.inputs[0].dims)
        if nd0 < 2 or axis % nd0 == 0:
            continue                    # batch-dim concat is not a join
        heads = [prod.get(t.tensor_id) for t in join.inputs]
        if any(h is None or h.name not in tags for h in heads):
            continue
        nb = len(heads)
        tag_set = [tags[h.name] for h in heads]
        if sorted(bi for bi, _ in tag_set) != list(range(nb)) \
                or any(n != nb for _, n in tag_set) or d % nb != 0:
            continue
        # order branch heads by their branch index
        heads = [h for _, h in sorted(zip((bi for bi, _ in tag_set), heads),
                                      key=lambda p: p[0])]
        # walk each branch back to the (single, shared) fork tensor
        chains: List[List[object]] = []
        fork_ids = set()
        ok = True
        for bi, head in enumerate(heads):
            chain = [head]
            frontier = [head]
            while frontier and ok:
                ly = frontier.pop()
                for t in ly.inputs:
                    p = prod.get(t.tensor_id)
                    if p is None or p.name not in tags:
                        fork_ids.add(t.tensor_id)
                        continue
                    if tags[p.name] != (bi, nb):
                        ok = False      # cross-branch edge
                        break
                    if p not in chain:
                        chain.append(p)
                        frontier.append(p)
            if not ok:
                break
            chain.sort(key=lambda ly: model.layers.index(ly))
            chains.append(chain)
        if not ok or len(fork_ids) != 1:
            continue
        names = {ly.name for c in chains for ly in c}
        if names & claimed or names & stateful:
            continue
        if any(len(ly.outputs) != 1 or ly.op_type in rng_ops
               for c in chains for ly in c):
            continue
        # no branch tensor may escape the region: every consumer of a
        # chain output must be a later layer of the SAME chain or the
        # join itself (an auxiliary head reading a branch intermediate
        # would otherwise lose its input when the region executes)
        chain_of = {ly.name: ci for ci, c in enumerate(chains) for ly in c}
        escaped = False
        region_out_ids = {ly.outputs[0].tensor_id
                          for c in chains for ly in c}
        for consumer in model.layers:
            if consumer is join or consumer.name in names:
                # same-chain consumption is checked below
                if consumer is join:
                    continue
                for t in consumer.inputs:
                    p = prod.get(t.tensor_id)
                    if (p is not None and p.name in names
                            and chain_of[p.name] != chain_of[consumer.name]):
                        escaped = True
                continue
            if any(t.tensor_id in region_out_ids for t in consumer.inputs):
                escaped = True
        if escaped:
            continue
        out_channels = []
        shapes_ok = True
        for c in chains:
            dims = c[-1].outputs[0].dims
            if axis % len(dims) == 0 or len(dims) < 2:
                shapes_ok = False
                break
            out_channels.append(dims[axis % len(dims)])
        if not shapes_ok:
            continue
        # branches must agree on every dim except the concat dim
        ref_dims = chains[0][-1].outputs[0].dims
        ax = axis % len(ref_dims)
        if any(len(c[-1].outputs[0].dims) != len(ref_dims)
               or any(a != b for i, (a, b) in enumerate(
                   zip(c[-1].outputs[0].dims, ref_dims)) if i != ax)
               for c in chains[1:]):
            continue
        # concat on a non-dim-1 axis needs a transpose inside the
        # executor; only dim-1 (channel) joins are planned for now
        if ax != 1:
            continue
        claimed |= names
        regions.append(BranchRegion(
            fork_tensor_id=next(iter(fork_ids)),
            join_layer_name=join.name, concat_axis=ax,
            chains=chains, out_channels=out_channels, nb=nb))

    if not regions:
        return None
    by_join = {r.join_layer_name: r for r in regions}
    skip = {ly.name for r in regions for c in r.chains for ly in c}
    return BranchPlan(regions=regions, by_join=by_join, skip=skip)


def run_branch_region(model, region: BranchRegion, params, values, ctx,
                      walk) -> bool:
    """Execute one fork-join region through branch_data_parallel_apply
    and write the join (concat) output into ``values``, whole on every
    rank; False (nothing done) when the batch does not split over a
    branch's ranks. ``walk`` (parallel/placement.Walk) gives the fork
    tensor whole and records the branches' parameters as summed over
    ``data``."""
    import torch

    from flexflow_tpu_torch.parallel.ops import branch_data_parallel_apply

    d = model.mesh.axis_size("data")
    k = d // region.nb
    x = values[region.fork_tensor_id]
    x, _ = walk.whole(region.fork_tensor_id, x)
    if x.shape[0] % k != 0:
        return False

    def make_branch(chain):
        def fn(xl, _params):
            vals = {region.fork_tensor_id: xl}
            for ly in chain:
                model._apply_layer(ly, params, vals, ctx)
            return vals[chain[-1].outputs[0].tensor_id]
        return fn

    branch_fns = [make_branch(c) for c in region.chains]
    branch_params = [{ly.name: params.get(ly.name, {}) for ly in c}
                     for c in region.chains]
    outs = branch_data_parallel_apply(
        model.mesh, "data", branch_fns, branch_params,
        region.out_channels, x)
    join = next(ly for ly in model.layers
                if ly.name == region.join_layer_name)
    values[join.outputs[0].tensor_id] = torch.cat(
        outs, dim=region.concat_axis)
    walk.places[join.outputs[0].tensor_id] = {}
    for c in region.chains:
        for ly in c:
            if ly.weights:
                walk.layer_axes[ly.name] = ("data",)
    return True
