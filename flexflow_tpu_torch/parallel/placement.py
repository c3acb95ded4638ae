"""Where each activation of a parallel train step lives (the port's
counterpart of the placement GSPMD gives the JAX package's jitted step).

A batch input is split as the JAX ``ShardingPolicy.batch_sharding``
splits it: dim 0 over ``data`` and dim 1 over ``seq`` where the axis
divides the dim. The graph walk then keeps, for every activation, the
batch axes it is split over and the dim of each (``{axis: dim}``);
anything else is replicated over those axes. (The ``model`` and
``expert`` axes never split an activation between layers: the ops that
split their weights over them gather or sum inside their forwards.)

For each layer, ``_out_dim`` says where an input's split dim lands in the
output when every rank can compute its part of the output from its part
of the input alone (elementwise ops, the feature-wise ops on any dim but
their features, reshapes that keep the chunk contiguous, ...), and
``None`` where the op mixes along that dim. An axis on which the op
mixes is gathered first (``all_gather``, whose backward keeps the rank's
slice of the gradient), and the layer runs replicated over it. A
replicated input of a layer that runs split is cut to the rank's part
(``split``) or, when it broadcasts (a bias-like WEIGHT, a size-1 dim),
passed whole through ``sum_grads``: its gradient, a partial sum over the
rank's part, is summed over the axis. A layer's parameters get partial
gradients on each axis it ran split over; ``GradReducer`` sums those
after the backward, in buckets, before the optimizer's update.

Three ops need to know their part: BatchNorm sums its fp32 statistics
over ``data`` (``ops/norm.py``), dropout draws the whole batch's mask and
keeps its rows (``OpContext.keep_mask``), and the training MHA takes the
ring on ``seq`` (``ops/attention.py``). ``OpContext.row_shards`` tells
them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from flexflow_tpu_torch.ffconst import AggrMode, OpType
from flexflow_tpu_torch.parallel.collectives import (all_gather, psum,
                                                     split, sum_grads)

BATCH_AXES = ("data", "seq")

# ops that act on each element alone (broadcasting, right-aligned dims)
_POINTWISE = {
    OpType.EW_ADD, OpType.EW_SUB, OpType.EW_MUL, OpType.EW_DIV,
    OpType.EW_MAX, OpType.EW_MIN, OpType.WHERE, OpType.COMPARE,
    OpType.RELU, OpType.SIGMOID, OpType.TANH, OpType.ELU, OpType.GELU,
    OpType.EXP, OpType.SIN, OpType.COS, OpType.RSQRT, OpType.IDENTITY,
    OpType.POW, OpType.SCALAR_MULTIPLY, OpType.SCALAR_ADD,
    OpType.SCALAR_SUB, OpType.SCALAR_TRUE_DIV, OpType.CAST,
    OpType.DROPOUT, OpType.BROADCAST_TO}
# ops that mix only along the last dim
_LAST_DIM = {OpType.LINEAR, OpType.RMS_NORM, OpType.RESIDUAL_RMS_NORM,
             OpType.TOPK, OpType.ARG_TOPK, OpType.ARGMAX,
             OpType.SIGMOID_SILU_MULTI}
# ops whose rows (dim 0) are independent and nothing else is
_ROWS = {OpType.CONV2D, OpType.POOL2D, OpType.BATCHNORM, OpType.EXPERTS}
_LAYER_NORMS = {OpType.LAYERNORM, OpType.RESIDUAL_LAYERNORM,
                OpType.ADD_BIAS_RESIDUAL_LAYERNORM}


def feed_place(policy, shape) -> Dict[str, int]:
    """{axis: dim} of a batch input of ``shape`` (the JAX batch
    sharding)."""
    spec = policy.batch_sharding(tuple(shape)).spec
    return {ax: d for d, ax in enumerate(spec) if ax in BATCH_AXES}


def _out_dim(layer, i: int, d: int, axis: str, mesh,
             training: bool) -> Optional[int]:
    """The output dim that input ``i``'s dim ``d`` (split over ``axis``)
    becomes when the op computes each part on its own; None when it
    mixes along ``d``."""
    op, attrs = layer.op_type, layer.attrs
    old = tuple(layer.inputs[i].dims)
    new = tuple(layer.outputs[0].dims)
    r = len(old)
    if op in _POINTWISE:
        od = d + len(new) - r
        return od if od >= 0 and new[od] == old[d] else None
    if op in _LAST_DIM:
        return d if d < r - 1 else None
    if op == OpType.EMBEDDING:
        bag = attrs.get("aggr", AggrMode.AGGR_MODE_NONE) \
            != AggrMode.AGGR_MODE_NONE
        return d if not (bag and d == r - 1) else None
    if op in _LAYER_NORMS:
        return d if d not in {a % r for a in attrs["axes"]} else None
    if op == OpType.SOFTMAX:
        return d if d != attrs.get("axis", -1) % r else None
    if op in _ROWS:
        return 0 if d == 0 else None
    if op == OpType.MULTIHEAD_ATTENTION:
        if d == 0:
            return 0
        from flexflow_tpu_torch.ops.attention import use_ring

        ok = (d == 1 and axis == "seq" and use_ring(
            attrs, layer.inputs[0].dims[1], layer.inputs[1].dims[1], mesh,
            training))
        return 1 if ok else None
    if op in (OpType.RESHAPE, OpType.FLAT):
        # each rank's part is the same contiguous run of elements in both
        # shapes when the dims before d are kept and the axis divides
        # the new dim d
        n = mesh.axis_size(axis)
        ok = len(new) > d and new[:d] == old[:d] and new[d] % n == 0
        return d if ok else None
    if op == OpType.TRANSPOSE:
        return list(attrs["perm"]).index(d)
    if op in (OpType.CONCAT, OpType.SPLIT, OpType.REVERSE):
        return d if d != attrs["axis"] % r else None
    if op == OpType.GATHER:
        return d if d != attrs["dim"] % r else None
    if op == OpType.BATCH_MATMUL:
        return d if d < r - 2 else None
    if op == OpType.SLICE:
        from flexflow_tpu_torch.ops.shape_ops import Slice

        starts, ends = Slice._resolve(attrs, old)
        squeeze = set(attrs.get("squeeze_dims", ()))
        if (starts[d], ends[d]) != (0, old[d]) or d in squeeze:
            return None
        return d - sum(1 for s in squeeze if s < d)
    if op in (OpType.REDUCE_SUM, OpType.REDUCE_MEAN, OpType.MEAN):
        axes = {a % r for a in attrs.get("axes", attrs.get("dims", ()))}
        if d in axes:
            return None
        return d if attrs.get("keepdims", False) \
            else d - sum(1 for a in axes if a < d)
    return None     # every other op sees the whole tensor


def _aligned(layer, i: int, od: int) -> int:
    """The dim of input ``i`` that lines up with output dim ``od``
    (right-aligned for the broadcasting ops); may be out of range."""
    if layer.op_type in _POINTWISE:
        return od - (len(layer.outputs[0].dims) - len(layer.inputs[i].dims))
    return od


@dataclasses.dataclass
class Walk:
    """One forward's placements: ``places[tensor_id] = {axis: dim}``,
    and the batch axes each parameter-holding layer ran split over."""

    mesh: Any
    training: bool
    places: Dict[int, Dict[str, int]] = dataclasses.field(
        default_factory=dict)
    layer_axes: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=dict)
    _gathered: Dict[Tuple[int, frozenset], torch.Tensor] = \
        dataclasses.field(default_factory=dict)

    def gather(self, tid: int, x: torch.Tensor, axes) -> torch.Tensor:
        """Tensor ``tid`` (value ``x``) made whole over ``axes``, once a
        forward for each set of axes."""
        key = (tid, frozenset(axes))
        if key not in self._gathered:
            place = self.places[tid]
            for axis in BATCH_AXES:
                if axis in axes:
                    x = all_gather(x, self.mesh, axis, axis=place[axis])
            self._gathered[key] = x
        return self._gathered[key]

    def whole(self, tid: int, x: torch.Tensor, keep_rows: bool = False):
        """(``x`` gathered over every axis it is split over, but an axis
        on dim 0 when ``keep_rows``; {axis: dim} of what stays split)."""
        place = dict(self.places.get(tid, {}))
        for axis, d in list(place.items()):
            if not (keep_rows and d == 0):
                x = all_gather(x, self.mesh, axis, axis=d)
                del place[axis]
        return x, place

    def layer_inputs(self, layer, values) -> Tuple[List[torch.Tensor],
                                                     Dict[str, int],
                                                     Dict[int, Tuple]]:
        """This layer's inputs, each gathered, cut or passed as its
        placement requires; returns (inputs, {axis: output dim},
        row_shards of the first input)."""
        mesh = self.mesh
        tids = [t.tensor_id for t in layer.inputs]
        ins = [values[tid] for tid in tids]
        places = [dict(self.places.get(tid, {})) for tid in tids]
        active: Dict[str, int] = {}
        gathers: List[set] = [set() for _ in tids]
        for axis in BATCH_AXES:
            split_at = [(i, p[axis]) for i, p in enumerate(places)
                        if axis in p]
            if not split_at:
                continue
            targets = {_out_dim(layer, i, d, axis, mesh, self.training)
                       for i, d in split_at}
            od = targets.pop() if len(targets) == 1 else None
            if od is not None and not self._fits(layer, places, axis, od):
                od = None
            if od is None:
                for i in range(len(tids)):
                    if axis in places[i]:
                        gathers[i].add(axis)
                        del places[i][axis]
                continue
            active[axis] = od
        for i, tid in enumerate(tids):
            if gathers[i]:
                ins[i] = self.gather(tid, ins[i], gathers[i])
        n_axes = {a: mesh.axis_size(a) for a in active}
        for axis, od in active.items():
            for i, tid in enumerate(tids):
                if axis in places[i]:
                    continue
                a = _aligned(layer, i, od)
                dims = layer.inputs[i].dims
                if 0 <= a < len(dims) and dims[a] != 1:
                    ins[i] = split(ins[i], mesh, axis, a)
                    places[i][axis] = a
                else:
                    ins[i] = sum_grads(ins[i], mesh, axis)
        rows = {}
        if places:
            rows = {d: (a, n_axes[a], mesh.index(a))
                    for a, d in places[0].items() if a in active}
        return ins, active, rows

    def _fits(self, layer, places, axis, od) -> bool:
        """Every replicated input lines up with ``od`` either whole-size
        (it is cut) or broadcast."""
        out = layer.outputs[0].dims
        if od >= len(out) or out[od] % self.mesh.axis_size(axis):
            return False
        for i, t in enumerate(layer.inputs):
            if axis in places[i]:
                continue
            a = _aligned(layer, i, od)
            if 0 <= a < len(t.dims) and t.dims[a] not in (1, out[od]):
                return False
        return True

    def record(self, layer, active: Dict[str, int]):
        """The outputs' placements, and the axes the layer's parameters
        got partial gradients on."""
        for t in layer.outputs:
            self.places[t.tensor_id] = {a: d for a, d in active.items()
                                        if d < len(t.dims)}
        if layer.weights:
            self.layer_axes[layer.name] = tuple(a for a in BATCH_AXES
                                                if a in active)


def local_attrs(layer, active: Dict[str, int], mesh) -> Dict[str, Any]:
    """``layer.attrs`` with the global sizes that a split run must not see
    (RESHAPE's and BROADCAST_TO's target shape, SLICE's split dims'
    bounds) made this rank's."""
    attrs = layer.attrs
    if not active:
        return attrs
    op = layer.op_type
    if op in (OpType.RESHAPE, OpType.BROADCAST_TO):
        shape = list(layer.outputs[0].dims)
        for axis, od in active.items():
            shape[od] //= mesh.axis_size(axis)
        return dict(attrs, shape=tuple(shape))
    if op == OpType.SLICE:
        r = len(layer.inputs[0].dims)
        starts = list(attrs["starts"]) + [None] * (r - len(attrs["starts"]))
        ends = list(attrs["ends"]) + [None] * (r - len(attrs["ends"]))
        squeeze = sorted(attrs.get("squeeze_dims", ()))
        for od in active.values():
            d = od
            for s in squeeze:       # the input dim of output dim od
                if s <= d:
                    d += 1
            starts[d], ends[d] = None, None
        return dict(attrs, starts=tuple(starts), ends=tuple(ends))
    return attrs


class GradReducer:
    """Sums the partial gradients of parameters over the batch axes their
    layer ran split over, after the backward: one all-reduce per bucket
    of up to ``bucket_elems`` elements of one dtype, in a fixed order
    (every rank holds the same parameters and buckets)."""

    def __init__(self, mesh, bucket_elems: int = 1 << 25):
        self.mesh = mesh
        self.bucket_elems = bucket_elems
        self.bytes_last_step = 0

    def __call__(self, params, layer_axes: Dict[str, Tuple[str, ...]]):
        groups: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
        for lname, axes in layer_axes.items():
            if not axes:
                continue
            for p in params.get(lname, {}).values():
                if not (isinstance(p, torch.Tensor) and p.requires_grad):
                    continue
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                groups.setdefault(axes, []).append(p)
        moved = 0
        for axes, ps in groups.items():
            for bucket in self._buckets(ps):
                flat = torch.cat([p.grad.reshape(-1) for p in bucket])
                for axis in axes:
                    flat = psum(flat, self.mesh, axis)
                    moved += flat.numel() * flat.element_size()
                off = 0
                for p in bucket:
                    n = p.numel()
                    p.grad.copy_(flat[off:off + n].view_as(p))
                    off += n
        self.bytes_last_step = moved

    def _buckets(self, ps):
        out, cur, size = [], [], 0
        for p in ps:
            if cur and (size + p.numel() > self.bucket_elems
                        or p.grad.dtype != cur[0].grad.dtype):
                out.append(cur)
                cur, size = [], 0
            cur.append(p)
            size += p.numel()
        if cur:
            out.append(cur)
        return out
