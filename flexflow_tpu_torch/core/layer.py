"""Layer: one node of the build-time graph (counterpart of
``flexflow_tpu/core/layer.py``).

Names are unique per model: every ``Layer`` takes its model's own name
counter, so two models built in one process name their layers alike and
their parameters line up key for key (``convert.params_from_jax``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from flexflow_tpu_torch.ffconst import DataType, OpType


@dataclasses.dataclass
class WeightSpec:
    """One learnable parameter of a layer."""

    name: str                      # e.g. "kernel", "bias"
    shape: Tuple[int, ...]
    dtype: DataType
    initializer: Any = None        # Initializer or None -> op default
    # mesh axis each dim splits over, e.g. (None, "model") (parallel/spec.py)
    sharding_dims: Optional[Tuple[Optional[str], ...]] = None
    # dim i splits only if each rank's chunk is a whole multiple of
    # shard_multiples[i] (None/1 = any): attention projections set
    # head_dim, so tensor parallelism splits at whole heads (rotary's
    # rotate-half never crosses a shard edge, and the kernels take
    # [*, heads, D] blocks)
    shard_multiples: Optional[Tuple[Optional[int], ...]] = None


class Layer:
    # the name counter of a layer made without its model's own
    # (``counts=None``); ``reset_naming`` clears it
    _counts: Dict[str, int] = {}

    def __init__(self, op_type: OpType, name: Optional[str],
                 inputs: List["Tensor"], attrs: Dict[str, Any],
                 counts: Optional[Dict[str, int]] = None):
        counts = counts if counts is not None else Layer._counts
        base = name or op_type.name.lower()
        n = counts.get(base, 0)
        counts[base] = n + 1
        self.name = base if n == 0 else f"{base}_{n}"
        self.op_type = op_type
        self.inputs = list(inputs)
        self.attrs = dict(attrs)
        self.outputs: List["Tensor"] = []
        self.weights: List[WeightSpec] = []

    def __repr__(self):
        return (f"Layer({self.name}, {self.op_type.name}, "
                f"in={[t.name for t in self.inputs]})")

    @classmethod
    def reset_naming(cls):
        cls._counts = {}
