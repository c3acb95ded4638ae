"""Graph-build tensor handle (counterpart of ``flexflow_tpu/core/tensor.py``):
a shape + dtype record made by the op-builder API. Values live in
``torch.Tensor``s keyed by ``tensor_id`` while a graph runs."""

from __future__ import annotations

import itertools
from typing import TYPE_CHECKING, Optional, Tuple

from flexflow_tpu_torch.ffconst import DataType

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer

_ids = itertools.count()


class Tensor:
    def __init__(self, dims: Tuple[int, ...], dtype: DataType, name: str = "",
                 owner_layer: Optional["Layer"] = None, owner_idx: int = 0,
                 model=None):
        self.tensor_id = next(_ids)
        self.dims: Tuple[int, ...] = tuple(int(d) for d in dims)
        self.dtype = dtype
        self.name = name or f"tensor_{self.tensor_id}"
        self.owner_layer = owner_layer
        self.owner_idx = owner_idx
        self.model = model

    @property
    def num_dims(self) -> int:
        return len(self.dims)

    def __repr__(self):
        return f"Tensor({self.name}, dims={self.dims}, dtype={self.dtype.name})"
