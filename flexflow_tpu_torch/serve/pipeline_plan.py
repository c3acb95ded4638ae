"""Pipeline-parallel serving: stage-sharded execution of the layer graph
(counterpart of ``flexflow_tpu/serve/pipeline_plan.py``).

The reference places a contiguous block of transformer layers on each
pipeline stage (inference_manager.cc:91-132). Here each stage is a rank
(or, with tensor parallelism, a group of ranks) of the ``pipe`` mesh
axis:

* ``build_pipeline_plan`` detects the repeated transformer block
  structurally (the model zoo names its layers ``<prefix>.{i}.<op>``) and
  refuses a graph that is not a homogeneous block stack or whose block
  count the degree does not divide;
* each stage initializes and holds only its L/P contiguous blocks, their
  KV caches (``[L/P, R, KH, S, D]``, the blocks' ``cache_layer_idx``
  renumbered from 0) and, on the first stage, the layers before the
  blocks (the embedding), on the last the layers after them (the head);
* ``finalize_pipeline`` stacks the stage's block weights into
  ``params[PP_PARAMS_KEY]`` (``{position in block: {weight: [L/P,
  ...]}}``), the layout offload pages (``offload.py``);
* ``run_pp_graph`` runs a serving forward: the first stage's pre
  segment, the blocks on the GPipe M + P - 1 tick schedule over the
  request slots (M = ``microbatch_count``; each tick a stage applies its
  blocks to one microbatch's rows, with views of those rows of its KV
  caches, and sends the activation on), then the last stage's post
  segment. ``FFModel._run_graph`` broadcasts the final output from the
  last stage, so the tokens reach every rank.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

from flexflow_tpu_torch.ops.base import OpContext

PP_PARAMS_KEY = "__pp_blocks__"

_BLOCK_IDX_RE = re.compile(r"\.(\d+)\.")

# attr keys that legitimately differ between structurally identical blocks
_ATTR_IGNORE = ("cache_layer_idx", "kernel_initializer", "bias_initializer",
                "kernel_regularizer", "transformer_layer_id")


@dataclasses.dataclass
class PipelinePlan:
    """A validated stage decomposition of a serving layer graph."""

    pre: List[Any]                 # layers before the first block
    blocks: List[List[Any]]        # blocks[i] = block i's layers, graph order
    post: List[Any]                # layers after the last block
    entry_tid: int                 # tensor id entering block 0
    exit_tid: int                  # tensor id produced by the last block
    block_entry_tids: List[int]    # tensor entering each block
    block_exit_tids: List[int]     # tensor each block hands on
    num_stages: int

    @property
    def num_blocks(self) -> int:
        return len(self.blocks)

    @property
    def blocks_per_stage(self) -> int:
        return self.num_blocks // self.num_stages

    @property
    def template(self) -> List[Any]:
        return self.blocks[0]

    def stage_blocks(self, stage: int) -> List[List[Any]]:
        n = self.blocks_per_stage
        return self.blocks[stage * n:(stage + 1) * n]


def microbatch_count(R: int, P: int) -> int:
    """GPipe split: M = the largest divisor of R that is <= P (the request
    slots split evenly)."""
    return max(m for m in range(1, P + 1) if R % m == 0)


def _block_index(name: str) -> Optional[int]:
    m = _BLOCK_IDX_RE.search(name)
    return int(m.group(1)) if m else None


def _comparable_attrs(layer) -> Tuple:
    items = []
    for k in sorted(layer.attrs):
        if k in _ATTR_IGNORE:
            continue
        items.append((k, repr(layer.attrs[k])))
    return (layer.op_type, tuple(items),
            tuple((w.name, w.shape, w.dtype) for w in layer.weights))


def build_pipeline_plan(model, num_stages: int) -> Optional[PipelinePlan]:
    """Detect the repeated transformer block in ``model``'s layer list.

    Returns None when the graph is not a homogeneous block stack (a
    hand-built graph, per-layer differences) or L % num_stages != 0;
    ``FFModel.compile`` turns None into an error, as the JAX package."""
    layers = model.layers
    anchors: Dict[int, int] = {}     # block index -> first layer position
    for pos, layer in enumerate(layers):
        idx = _block_index(layer.name)
        if idx is not None and idx not in anchors:
            anchors[idx] = pos
    if not anchors:
        return None
    L = max(anchors) + 1
    if sorted(anchors) != list(range(L)) or L < 2 or L % num_stages != 0:
        return None
    start0 = anchors[0]
    n = anchors[1] - anchors[0]      # block length in layers
    if n <= 0:
        return None
    for i in range(L):
        if anchors.get(i) != start0 + i * n:
            return None
    end = start0 + L * n
    if end > len(layers):
        return None
    blocks = [layers[start0 + i * n: start0 + (i + 1) * n] for i in range(L)]
    template_sig = [_comparable_attrs(l) for l in blocks[0]]
    for blk in blocks[1:]:
        if [_comparable_attrs(l) for l in blk] != template_sig:
            return None
    # exactly one stacked-KV layer per block, in consolidated layer order
    for i, blk in enumerate(blocks):
        idxs = [l.attrs.get("cache_layer_idx") for l in blk
                if l.attrs.get("cache_layer_idx") is not None]
        if idxs != [i]:
            return None

    # single-crossing-tensor dataflow
    produced_by_block: Dict[int, int] = {}
    for bi, blk in enumerate(blocks):
        for l in blk:
            for t in l.outputs:
                produced_by_block[t.tensor_id] = bi
    entries: List[int] = []
    for bi, blk in enumerate(blocks):
        internal = {t.tensor_id for l in blk for t in l.outputs}
        ext = []
        for l in blk:
            for t in l.inputs:
                if t.tensor_id not in internal and t.tensor_id not in ext:
                    ext.append(t.tensor_id)
        if len(ext) != 1:
            return None              # block consumes more than the crossing
        if bi == 0:
            if ext[0] in produced_by_block:
                return None
        elif produced_by_block.get(ext[0]) != bi - 1:
            return None
        entries.append(ext[0])
    # the post segment consumes exactly one block tensor: the last block's
    # exit, at block 0's exit position
    rel = None
    for pos, l in enumerate(blocks[0]):
        for t in l.outputs:
            if t.tensor_id == entries[1]:
                rel = (pos, l.outputs.index(t))
    if rel is None:
        return None
    exits = [blk[rel[0]].outputs[rel[1]].tensor_id for blk in blocks]
    if exits[:-1] != entries[1:]:
        return None
    post = layers[end:]
    block_tids = set(produced_by_block)
    for l in post:
        for t in l.inputs:
            if t.tensor_id in block_tids and t.tensor_id != exits[-1]:
                return None
    R = model.config.max_requests_per_batch
    M = microbatch_count(R, num_stages)
    if M < num_stages:
        import warnings

        P_ = num_stages
        util = M / (M + P_ - 1)   # fraction of ticks each stage is busy
        warnings.warn(
            f"pipeline microbatching is degenerate: max_requests_per_batch="
            f"{R} splits into only M={M} microbatches over {P_} stages "
            f"(stage utilization {util:.0%}; M=P would give "
            f"{P_ / (2 * P_ - 1):.0%}). Choose max_requests_per_batch "
            f"divisible by pipeline_parallelism_degree={P_} (e.g. "
            f"{-(-R // P_) * P_}).", stacklevel=2)
    return PipelinePlan(pre=layers[:start0], blocks=blocks, post=post,
                        entry_tid=entries[0], exit_tid=exits[-1],
                        block_entry_tids=entries, block_exit_tids=exits,
                        num_stages=num_stages)


def stage_of(plan: PipelinePlan, layer_name: str) -> Optional[int]:
    """The stage that runs ``layer_name``: 0 for the pre segment, the last
    for the post segment, i // (L/P) for block i; None for a layer
    outside the plan."""
    for layer in plan.pre:
        if layer.name == layer_name:
            return 0
    for layer in plan.post:
        if layer.name == layer_name:
            return plan.num_stages - 1
    for i, blk in enumerate(plan.blocks):
        for layer in blk:
            if layer.name == layer_name:
                return i // plan.blocks_per_stage
    return None


def stage_holds(plan: PipelinePlan, layer_name: str, stage: int) -> bool:
    s = stage_of(plan, layer_name)
    return s is None or s == stage


def shard_stage_state(model, plan: PipelinePlan, stage: int):
    """Keep this stage's rows of the stacked KV caches and renumber its
    blocks' ``cache_layer_idx`` from 0 (the other stages' caches are
    never allocated past compile)."""
    n = plan.blocks_per_stage
    for j, blk in enumerate(plan.stage_blocks(stage)):
        for layer in blk:
            if layer.attrs.get("cache_layer_idx") is not None:
                layer.attrs["cache_layer_idx"] = j
    kv = model.op_state.get("kv_cache")
    if kv is not None:
        model.op_state["kv_cache"] = {
            name: t[stage * n:(stage + 1) * n].clone()
            for name, t in kv.items()}


# ----------------------------------------------------------------------
# Weight stacking (the "placement" step — reference inference_manager.cc:131)
# ----------------------------------------------------------------------
def finalize_pipeline(model) -> None:
    """Stack this stage's block weights into ``params[PP_PARAMS_KEY]``
    and drop the per-layer entries. Idempotent. Runs after the weights
    are loaded (``LLM.compile``, the InferenceManager) and before
    offload, which pages the stacked leaves."""
    from flexflow_tpu_torch.parallel.pipeline import stack_stage_params

    plan = model._pp_plan
    if plan is None or PP_PARAMS_KEY in model.params:
        return
    if getattr(model, "_offloaded", None):
        raise RuntimeError(
            "finalize_pipeline must run BEFORE offload_weights so paging "
            "applies to the stage-stacked leaves (LLM.compile orders "
            "them; re-run offload_weights after this call)")
    local = plan.stage_blocks(model.mesh.index("pipe"))
    stacked: Dict[str, Dict[str, Any]] = {}
    for pos, tlayer in enumerate(plan.template):
        if not tlayer.weights:
            continue
        stacked[str(pos)] = stack_stage_params(
            [model.params[blk[pos].name] for blk in local])
    for blk in local:
        for layer in blk:
            model.params.pop(layer.name, None)
    model.params[PP_PARAMS_KEY] = stacked


def stacked_param_lookup(model, layer_name: str, weight_name: str):
    """(pos, j): a block layer's position in its block (the stacked
    params key) and its index among this stage's blocks, once
    finalized; else None (not finalized, or held by another stage)."""
    plan = getattr(model, "_pp_plan", None)
    if plan is None or PP_PARAMS_KEY not in model.params:
        return None
    for j, blk in enumerate(plan.stage_blocks(model.mesh.index("pipe"))):
        for pos, layer in enumerate(blk):
            if layer.name == layer_name:
                return (str(pos), j)
    return None


# ----------------------------------------------------------------------
# Execution
# ----------------------------------------------------------------------
def _block_params(model, params, j: int, blk) -> Dict[str, Dict[str, Any]]:
    """{layer name: params} of this stage's block j: views of the stacked
    leaves once finalized (offloaded ones fetched to the device), else the
    per-layer entries."""
    from flexflow_tpu_torch.parallel.pipeline import block_slice

    if PP_PARAMS_KEY not in params:
        return params
    stacked = params[PP_PARAMS_KEY]
    fetched = {}
    if PP_PARAMS_KEY in (getattr(model, "_offloaded", None) or {}):
        from flexflow_tpu_torch.offload import fetch_block_params

        fetched = fetch_block_params(model, j)
    out = {}
    for pos, layer in enumerate(blk):
        per_w = stacked.get(str(pos))
        if not per_w:
            continue
        lp = block_slice(per_w, j)
        lp.update(fetched.get(str(pos), {}))
        out[layer.name] = lp
    return out


def _meta_rows(meta, lo: int, hi: int):
    return type(meta)(**{f.name: getattr(meta, f.name)[lo:hi]
                         for f in dataclasses.fields(meta)})


def run_pp_graph(model, params, feeds: Dict[int, Any], ctx: OpContext,
                 state: Optional[Dict[str, Any]]):
    """``FFModel._run_graph`` of a serving forward under a pipeline plan,
    on this stage: pre segment (first stage), the blocks on the GPipe
    schedule, post segment (last stage). Returns (values, new_state);
    only the last stage's values hold the final output."""
    from flexflow_tpu_torch.parallel.pipeline import gpipe

    plan = model._pp_plan
    mesh = model.mesh
    P = mesh.axis_size("pipe")
    s = mesh.index("pipe")
    values: Dict[int, Any] = dict(feeds)
    ctx.state_in = state or {}
    ctx.state_out = {}
    if s == 0:
        for layer in plan.pre:
            model._apply_layer(layer, params, values, ctx)
    meta = ctx.batch_config
    R = meta.tokens.shape[0]
    M = microbatch_count(R, P)
    rsize = R // M
    kv = ctx.state_in["kv_cache"]
    local = plan.stage_blocks(s)
    first = s * plan.blocks_per_stage
    outs: List[Any] = [None] * M

    # offloaded blocks: fetched once a forward and kept for the other
    # microbatches when the stage's paged bytes fit the prefetch reserve,
    # else fetched again for each microbatch (M times the bytes)
    pf = getattr(model, "_prefetcher", None)
    kept = ({} if pf is not None and M > 1 and pf.total_bytes() <= pf.reserve
            else None)

    def block_params(j, blk):
        if kept is None:
            return _block_params(model, params, j, blk)
        if j not in kept:
            kept[j] = _block_params(model, params, j, blk)
        return kept[j]

    def ingest(mb):
        return values[plan.entry_tid][mb * rsize:(mb + 1) * rsize]

    def apply(mb, x):
        lo, hi = mb * rsize, (mb + 1) * rsize
        sub = OpContext(
            training=False, compute_dtype=ctx.compute_dtype,
            batch_config=_meta_rows(meta, lo, hi),
            state_in={"kv_cache": {n: t[:, lo:hi] for n, t in kv.items()}},
            kv_contiguous=ctx.kv_contiguous, kv_append_q=ctx.kv_append_q,
            generator=ctx.generator, mesh=mesh)
        for j, blk in enumerate(local):
            vals = {plan.block_entry_tids[first + j]: x}
            bp = block_params(j, blk)
            for layer in blk:
                model._apply_layer(layer, bp, vals, sub)
            x = vals[plan.block_exit_tids[first + j]]
        return x

    def emit(mb, y):
        outs[mb] = y

    gpipe(mesh, M, ingest, apply, emit, model.device)
    ctx.state_out["kv_cache"] = kv
    if s == P - 1:
        values[plan.exit_tid] = torch.cat(outs)
        for layer in plan.post:
            model._apply_layer(layer, params, values, ctx)
    new_state = dict(ctx.state_in)
    new_state.update(ctx.state_out)
    return values, new_state
