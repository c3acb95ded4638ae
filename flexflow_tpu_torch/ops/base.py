"""Op registry + execution context (counterpart of ``flexflow_tpu/ops/base.py``).

An op is three static pieces of metadata and a forward function on torch
tensors: ``infer_output_specs``, ``weight_specs`` and ``forward``; serving
ops add ``init_state`` for their KV caches. PyTorch runs eagerly, so the
forward is called op by op; the KV caches in ``state_in``/``state_out`` are
updated in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Type

import torch

from flexflow_tpu_torch.ffconst import DataType, OpType

TensorSpec = Tuple[Tuple[int, ...], DataType]


def stable_hash(*parts) -> int:
    """Deterministic across processes (Python's hash() is salted)."""
    import zlib

    return zlib.crc32("\x1f".join(str(p) for p in parts).encode()) & 0x7FFFFFFF


@dataclasses.dataclass
class OpContext:
    """Per-call execution context threaded through op forwards."""

    # a train step's forward (dropout draws, BatchNorm batch statistics)
    training: bool = False
    layer_name: str = ""
    compute_dtype: Any = None            # torch dtype for activations
    batch_config: Any = None             # serving BatchMeta
    state_in: Dict[str, Any] = dataclasses.field(default_factory=dict)
    state_out: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # serving-engine promises (serve/engine.py forward_with_meta)
    kv_contiguous: bool = False
    kv_append_q: Optional[int] = None
    # the tree-verify pass's [R, T, S] additive mask: built by the first
    # tree-attention layer of a forward, reused by the others
    tree_bias: Any = None
    # the model's parallel/mesh.Mesh (None for a single process): ops with
    # sharded weights or caches run their collectives over its axes
    mesh: Any = None
    # torch.Generator on the model's device for the forward's random draws
    # (the JAX package's rng key); the InferenceManager owns and seeds it
    # for sampling, the FFModel for a train step's dropout
    generator: Any = None
    # the device the forward computes on (ops that make tensors from
    # nothing: CONSTANT)
    device: Any = None
    # a parallel train step (parallel/placement.py): the dims of the
    # layer's first input that are split over an axis of the mesh (a
    # batch axis, or ``model`` on a feature dim), {dim: (axis, size, this
    # rank's index)}; empty when it is whole
    row_shards: Dict[int, Tuple[str, int, int]] = dataclasses.field(
        default_factory=dict)
    # a parallel train step: the op's weights are column shards over
    # ``model`` and its output stays split there on its last dim (the op
    # returns its columns instead of gathering them)
    split_columns: bool = False
    # the model's FFConfig (the JAX package's ``config``)
    config: Any = None
    # an integer seed, the counterpart of the JAX package's PRNG key:
    # ``layer_rng`` derives each layer's own generator from it
    rng: Optional[int] = None

    def layer_rng(self, salt: int = 0) -> Optional[torch.Generator]:
        """A generator of this layer's own, on ``device``, seeded from
        ``rng`` and the layer's stable name hash (the JAX package folds
        ``stable_hash(layer_name, salt)`` into its key); None without
        ``rng``."""
        if self.rng is None:
            return None
        g = torch.Generator(device=self.device or "cpu")
        g.manual_seed(((int(self.rng) << 31)
                       | stable_hash(self.layer_name, salt))
                      & 0x7FFF_FFFF_FFFF_FFFF)
        return g

    def split_dims(self, dims, rank: int) -> Dict[int, Tuple[str, int, int]]:
        """The entries of ``row_shards`` on ``dims`` (of a ``rank``-d
        input; negative dims count from the end): the normalised dims of
        a LayerNorm, a softmax's axis, that the rank holds only a part
        of."""
        want = {d % rank for d in dims}
        return {d: s for d, s in self.row_shards.items() if d in want}

    def keep_mask(self, shape, keep: float, device, shards=None):
        """A layer's Bernoulli(``keep``) draw of ``shape`` from
        ``generator``, or None without one (the counterpart of
        ``layer_rng``: the layers draw in graph order from the one
        stateful generator, so a seeded step repeats bit for bit).

        ``shards`` ({dim: (axis, size, index)}, default ``row_shards``)
        names the dims of ``shape`` that are this rank's part of a larger
        tensor: the draw is made at the whole shape, as one rank would
        make it, and the rank keeps its part, so the masks and the
        generator's next state are those of an unsplit run."""
        import torch

        if self.generator is None:
            return None
        shards = self.row_shards if shards is None else shards
        whole = list(shape)
        for d, (_axis, n, _i) in shards.items():
            whole[d] *= n
        mask = torch.rand(whole, generator=self.generator,
                          device=device) < keep
        if shards:
            mask = mask[tuple(
                slice(shards[d][2] * s, (shards[d][2] + 1) * s)
                if d in shards else slice(None)
                for d, s in enumerate(shape))]
        return mask


def part(w, dim: int, shard: Tuple[str, int, int]):
    """This rank's chunk of a whole weight ``w`` along ``dim``, for a
    rank that holds the ``shard`` = (axis, size, index) part of the
    activation dim it lines up with; its gradient is a partial one."""
    _axis, n, i = shard
    return w.chunk(n, dim=dim)[i]


class OpImpl:
    op_type: OpType = None
    # quant-aware ops read QuantizedWeight leaves themselves (quant.qmatmul,
    # quant.qtake); the others get dequantized params from the graph walker
    quant_aware: bool = False

    @staticmethod
    def infer_output_specs(attrs: Dict[str, Any],
                           input_specs: List[TensorSpec]) -> List[TensorSpec]:
        raise NotImplementedError

    @staticmethod
    def weight_specs(attrs: Dict[str, Any],
                     input_specs: List[TensorSpec]) -> List:
        return []

    @staticmethod
    def forward(attrs: Dict[str, Any], params: Dict[str, Any],
                inputs: List[Any], ctx: OpContext) -> List[Any]:
        raise NotImplementedError


_REGISTRY: Dict[OpType, Type[OpImpl]] = {}


def register_op(cls: Type[OpImpl]) -> Type[OpImpl]:
    assert cls.op_type is not None, cls
    _REGISTRY[cls.op_type] = cls
    return cls


def register_op_as(*op_types: OpType):
    def deco(cls):
        for t in op_types:
            _REGISTRY[t] = cls
        return cls

    return deco


def get_op_impl(op_type: OpType) -> Type[OpImpl]:
    if op_type not in _REGISTRY:
        raise NotImplementedError(
            f"No implementation registered for {op_type} in the PyTorch port")
    return _REGISTRY[op_type]
