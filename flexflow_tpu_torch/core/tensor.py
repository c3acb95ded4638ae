"""Graph-build tensor handle (counterpart of ``flexflow_tpu/core/tensor.py``):
a shape + dtype record made by the op-builder API. Values live in
``torch.Tensor``s keyed by ``tensor_id`` while a graph runs. A parameter's
handle (``FFModel.get_parameter_tensor``) reads and writes the weight
through the model (the reference's get/set_weights)."""

from __future__ import annotations

import itertools
from typing import TYPE_CHECKING, Optional, Tuple

import numpy as np

from flexflow_tpu_torch.ffconst import DataType

if TYPE_CHECKING:
    from flexflow_tpu_torch.core.layer import Layer

_ids = itertools.count()


class Tensor:
    def __init__(self, dims: Tuple[int, ...], dtype: DataType, name: str = "",
                 owner_layer: Optional["Layer"] = None, owner_idx: int = 0,
                 model=None, is_weight: bool = False,
                 weight_name: Optional[Tuple[str, str]] = None):
        self.tensor_id = next(_ids)
        self.dims: Tuple[int, ...] = tuple(int(d) for d in dims)
        self.dtype = dtype
        self.name = name or f"tensor_{self.tensor_id}"
        self.owner_layer = owner_layer
        self.owner_idx = owner_idx
        self.model = model
        self.is_weight = is_weight
        self.weight_name = weight_name      # (layer, weight) of a parameter

    @property
    def num_dims(self) -> int:
        return len(self.dims)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.dims

    def get_weights(self, ffmodel=None) -> np.ndarray:
        model = ffmodel or self.model
        if model is None or not self.is_weight:
            raise ValueError(f"{self} is not a parameter tensor")
        return model.get_parameter_by_key(self.weight_name)

    def set_weights(self, ffmodel_or_array, array=None):
        if array is None:
            model, array = self.model, ffmodel_or_array
        else:
            model = ffmodel_or_array
        if model is None or not self.is_weight:
            raise ValueError(f"{self} is not a parameter tensor")
        model.set_parameter_by_key(self.weight_name, np.asarray(array))

    def get_tensor(self, ffmodel=None) -> np.ndarray:
        return self.get_weights(ffmodel)

    def set_tensor(self, ffmodel_or_array, array=None):
        return self.set_weights(ffmodel_or_array, array)

    def __repr__(self):
        return f"Tensor({self.name}, dims={self.dims}, dtype={self.dtype.name})"
