"""The Keras frontend of the PyTorch/CUDA port (counterpart of
``flexflow_tpu/keras``): Sequential and functional models whose layers
lower onto the port's FFModel op-builder, then train, evaluate and predict
through its ``compile``/``fit``/``evaluate``/``predict`` on the model's
device (``FFConfig.device``, the card unless the config says "cpu").
"""

from flexflow_tpu_torch.keras import (
    backend,
    callbacks,
    datasets,
    initializers,
    layers,
    losses,
    metrics,
    models,
    optimizers,
    preprocessing,
    regularizers,
    utils,
)
from flexflow_tpu_torch.keras.layers import Input
from flexflow_tpu_torch.keras.models import Model, Sequential

__all__ = ["backend", "callbacks", "datasets", "initializers", "layers", "losses",
           "metrics", "models", "optimizers", "preprocessing", "regularizers", "utils",
           "Input", "Model", "Sequential"]
