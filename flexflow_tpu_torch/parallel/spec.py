"""Sharding policy: which slice of each tensor a rank holds (counterpart
of ``flexflow_tpu/parallel/spec.py``).

The JAX package resolves a ``NamedSharding`` per tensor and lets GSPMD
place the pieces. In the port each rank holds its piece explicitly, so a
``Sharding`` is the same per-dim spec (a mesh axis name or None per dim)
plus the mesh, and ``index(shape, coord)`` gives the slices that the rank
at ``coord`` holds — what ``NamedSharding.devices_indices_map`` gives for
the device there. The rules are the JAX policy's: a dim shards over an
axis only if the axis divides it into whole ``shard_multiples``; any
other dim is replicated.

``shard_params`` slices a model's full parameters down to one rank's
(the weights a single process would hold, sliced, so the sharded run
computes on the very values of the unsharded one). A ``QuantizedWeight``
is sliced, never re-quantized: its scale is per output column, so
re-quantizing a row shard would change the bits. int4 packs two rows per
byte, so its row shards must start and end on even rows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

from flexflow_tpu_torch.quant import QuantizedWeight, is_quantized


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Per-dim spec over a mesh: ``spec[i]`` is the axis dim i is split
    over, or None (replicated)."""

    spec: Tuple[Optional[str], ...]
    axis_sizes: Tuple[Tuple[str, int], ...]

    def _size(self, axis):
        return dict(self.axis_sizes).get(axis, 1)

    def index(self, shape, coord: Mapping[str, int]) -> Tuple[slice, ...]:
        """The slices of a ``shape`` tensor held at mesh ``coord``."""
        out = []
        for i, dim in enumerate(shape):
            ax = self.spec[i] if i < len(self.spec) else None
            if ax is None:
                out.append(slice(0, dim))
                continue
            n = self._size(ax)
            chunk = dim // n
            j = coord.get(ax, 0)
            out.append(slice(j * chunk, (j + 1) * chunk))
        return tuple(out)

    @property
    def is_replicated(self) -> bool:
        return not any(self.spec)


class ShardingPolicy:
    """Resolves where each tensor lives on the mesh."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.axes = set(mesh.axis_names)

    def _sharding(self, spec) -> Sharding:
        return Sharding(tuple(spec), tuple(self.mesh.shape.items()))

    def _axis(self, name: Optional[str]) -> Optional[str]:
        return (name if name in self.axes and self.mesh.shape[name] > 1
                else None)

    def batch_sharding(self, shape: Tuple[int, ...]) -> Sharding:
        """Activations and batches: dim 0 on ``data`` (and dim 1 on ``seq``)
        where the axis divides it; replicated otherwise."""
        shape = tuple(shape)
        spec = [None] * len(shape)
        if (shape and self._axis("data")
                and shape[0] % self.mesh.shape["data"] == 0):
            spec[0] = "data"
        if (len(shape) >= 2 and self._axis("seq")
                and shape[1] % self.mesh.shape["seq"] == 0):
            spec[1] = "seq"
        return self._sharding(spec)

    def weight_sharding(self, shape: Tuple[int, ...],
                        sharding_dims: Optional[Tuple[Optional[str], ...]],
                        shard_multiples: Optional[
                            Tuple[Optional[int], ...]] = None) -> Sharding:
        """Parameters: split per the op's hint; a dim whose per-rank chunk
        would not be a whole multiple of ``shard_multiples[i]`` (e.g.
        head_dim, so attention splits at whole heads) is replicated."""
        if sharding_dims is None:
            return self._sharding(())
        spec = []
        for i, (dim_size, axis_name) in enumerate(zip(shape, sharding_dims)):
            ax = self._axis(axis_name)
            unit = (shard_multiples[i] or 1) if (
                shard_multiples is not None
                and i < len(shard_multiples)) else 1
            if (ax is not None and dim_size % self.mesh.shape[ax] == 0
                    and (dim_size // self.mesh.shape[ax]) % unit == 0):
                spec.append(ax)
            else:
                spec.append(None)
        return self._sharding(spec)

    def kv_cache_sharding(self, shape: Tuple[int, ...]) -> Sharding:
        """KV caches [R, KH, S, D] or stacked [L, R, KH, S, D]: S (dim -2)
        over ``seq`` where it divides (the layout ``seq_sharded_attend``
        reads), as the JAX policy; ``kv_state_sharding`` adds the
        heads."""
        shape = tuple(shape)
        spec = [None] * len(shape)
        if (len(shape) >= 2 and self._axis("seq")
                and shape[-2] % self.mesh.shape["seq"] == 0):
            spec[-2] = "seq"
        return self._sharding(spec)

    def kv_state_sharding(self, shape: Tuple[int, ...]) -> Sharding:
        """What a rank holds of a KV cache [.., KH, S, D]: the S rows of
        ``kv_cache_sharding`` and, where ``model`` divides KH (the rule
        that shards ``wk``/``wv`` at whole heads), its KV heads."""
        spec = list(self.kv_cache_sharding(shape).spec)
        if (len(shape) >= 3 and self._axis("model")
                and shape[-3] % self.mesh.shape["model"] == 0):
            spec[-3] = "model"
        return self._sharding(spec)

    def replicated(self) -> Sharding:
        return self._sharding(())

    def resolve(self, spec, shape: Tuple[int, ...]) -> Tuple:
        """``spec`` (a mesh axis name or None a dim) as it lays out a
        whole tensor of ``shape``: axes not in the mesh, or that do not
        divide their dim, are taken as None there, as in the JAX
        package."""
        shape = tuple(shape)
        dst = tuple(ax if ax is not None and self._axis(ax) is not None
                    and shape[i] % self.mesh.shape[ax] == 0 else None
                    for i, ax in enumerate(tuple(spec)[:len(shape)]))
        return dst + (None,) * (len(shape) - len(dst))

    def constrain(self, value, spec, src=None):
        """``value`` (this rank's piece of a tensor laid out as ``src``,
        default whole) laid out as ``spec``, a searched output layout
        taken as ``resolve`` takes it: the port's counterpart of the JAX
        package's sharding constraint, moved by ``placement.reshard``."""
        if not isinstance(value, torch.Tensor):
            return value
        src = tuple(src or ())
        src = src + (None,) * (value.dim() - len(src))
        whole = [d * (self.mesh.shape[a] if self._axis(a) else 1)
                 for d, a in zip(value.shape, src)]
        dst = self.resolve(spec, whole)
        if dst == src:
            return value
        from flexflow_tpu_torch.parallel.placement import reshard

        return reshard(value, self.mesh, src, dst)


def shard_leaf(leaf, sharding: Sharding, coord: Mapping[str, int]):
    """This rank's slice of one parameter, as a new contiguous tensor (or
    ``QuantizedWeight``, sliced by its logical [rows, cols])."""
    if not is_quantized(leaf):
        idx = sharding.index(tuple(leaf.shape), coord)
        return leaf[idx].clone(memory_format=torch.contiguous_format)
    rows, cols = leaf.shape
    r_sl, c_sl = sharding.index((rows, cols), coord)
    q = leaf.q[:, c_sl]
    scale = leaf.scale[c_sl]
    if (r_sl.start, r_sl.stop) != (0, rows):
        if leaf.qtype == "int4":
            if r_sl.start % 2 or (r_sl.stop % 2 and r_sl.stop != rows):
                raise ValueError(
                    f"an int4 row shard [{r_sl.start}, {r_sl.stop}) must "
                    "start and end on even rows (two rows a byte)")
            q = q[r_sl.start // 2:(r_sl.stop + 1) // 2]
        else:
            q = q[r_sl]
    return QuantizedWeight(
        leaf.qtype, q.clone(memory_format=torch.contiguous_format),
        scale.clone(memory_format=torch.contiguous_format),
        r_sl.stop - r_sl.start, leaf.dtype)


def layer_weight_shardings(model, policy: ShardingPolicy
                           ) -> Dict[str, Dict[str, Sharding]]:
    """{layer: {weight: Sharding}}: each weight's searched
    ``weight_specs`` entry where the model's strategy gives one, else its
    WeightSpec's (``placement.rest_dims``)."""
    from flexflow_tpu_torch.parallel.placement import rest_dims

    strategy = getattr(model, "strategy", None)
    out = {}
    for layer in model.layers:
        if not layer.weights:
            continue
        st = strategy.ops.get(layer.name) if strategy is not None else None
        out[layer.name] = {w.name: policy.weight_sharding(
            w.shape, rest_dims(w, st), w.shard_multiples)
            for w in layer.weights}
    return out


def shard_params(params: Mapping[str, Mapping[str, Any]], model,
                 policy: ShardingPolicy, coord: Mapping[str, int]
                 ) -> Dict[str, Dict[str, Any]]:
    """Slice full parameters ``{layer: {weight: leaf}}`` down to what the
    rank at ``coord`` holds: each weight by its WeightSpec's sharding,
    and, under a pipeline plan, only the layers of this rank's stage
    (``serve/pipeline_plan.stage_holds``)."""
    from flexflow_tpu_torch.serve.pipeline_plan import stage_holds

    shardings = layer_weight_shardings(model, policy)
    plan = getattr(model, "_pp_plan", None)
    stage = coord.get("pipe", 0)
    out: Dict[str, Dict[str, Any]] = {}
    for lname, lp in params.items():
        if plan is not None and not stage_holds(plan, lname, stage):
            continue
        sh = shardings.get(lname, {})
        out[lname] = {w: (shard_leaf(a, sh[w], coord) if w in sh else a)
                      for w, a in lp.items()}
    return out
