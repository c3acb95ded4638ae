"""Keras loss identifiers (reference python/flexflow/keras/losses.py)."""

from __future__ import annotations

from flexflow_tpu_torch.ffconst import LossType


class Loss:
    loss_type: LossType

    def __init__(self, name: str):
        self.name = name


class CategoricalCrossentropy(Loss):
    loss_type = LossType.LOSS_CATEGORICAL_CROSSENTROPY

    def __init__(self):
        super().__init__("categorical_crossentropy")


class SparseCategoricalCrossentropy(Loss):
    loss_type = LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY

    def __init__(self):
        super().__init__("sparse_categorical_crossentropy")


class MeanSquaredError(Loss):
    loss_type = LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE

    def __init__(self):
        super().__init__("mean_squared_error")
