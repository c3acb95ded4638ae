"""Keras metric identifiers (reference python/flexflow/keras/metrics.py)."""

from __future__ import annotations

from flexflow_tpu_torch.ffconst import MetricsType


class Metric:
    metrics_type: MetricsType

    def __init__(self, name: str):
        self.name = name


class Accuracy(Metric):
    metrics_type = MetricsType.METRICS_ACCURACY

    def __init__(self):
        super().__init__("accuracy")


class CategoricalCrossentropy(Metric):
    metrics_type = MetricsType.METRICS_CATEGORICAL_CROSSENTROPY

    def __init__(self):
        super().__init__("categorical_crossentropy")


class SparseCategoricalCrossentropy(Metric):
    metrics_type = MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY

    def __init__(self):
        super().__init__("sparse_categorical_crossentropy")


class MeanSquaredError(Metric):
    metrics_type = MetricsType.METRICS_MEAN_SQUARED_ERROR

    def __init__(self):
        super().__init__("mean_squared_error")


class RootMeanSquaredError(Metric):
    metrics_type = MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR

    def __init__(self):
        super().__init__("root_mean_squared_error")


class MeanAbsoluteError(Metric):
    metrics_type = MetricsType.METRICS_MEAN_ABSOLUTE_ERROR

    def __init__(self):
        super().__init__("mean_absolute_error")
