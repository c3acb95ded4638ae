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

from flexflow_tpu_torch.ffconst import DataType, OpType

TensorSpec = Tuple[Tuple[int, ...], DataType]


def stable_hash(*parts) -> int:
    """Deterministic across processes (Python's hash() is salted)."""
    import zlib

    return zlib.crc32("\x1f".join(str(p) for p in parts).encode()) & 0x7FFFFFFF


@dataclasses.dataclass
class OpContext:
    """Per-call execution context threaded through op forwards."""

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
    # torch.Generator on the model's device for the forward's random draws
    # (the JAX package's rng key); the InferenceManager owns and seeds it
    generator: Any = None


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
