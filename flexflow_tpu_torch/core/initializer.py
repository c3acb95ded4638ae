"""Parameter initializers (counterpart of ``flexflow_tpu/core/initializer.py``).

The same distributions, drawn from an explicit ``torch.Generator`` that
``FFModel.compile`` seeds per weight (``core/model.py:weight_seed``) on the
model's device. The bits differ from JAX's for the same seed; tests that
compare the two packages carry weights across as numpy arrays instead.
"""

from __future__ import annotations

import math

import torch


class Initializer:
    def __call__(self, gen: torch.Generator, shape, dtype: torch.dtype,
                 device) -> torch.Tensor:
        raise NotImplementedError


class GlorotUniformInitializer(Initializer):
    def __call__(self, gen, shape, dtype, device):
        if len(shape) >= 2:
            fan_in, fan_out = shape[-2], shape[-1]
        else:
            fan_in = fan_out = shape[0] if shape else 1
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(shape, dtype=dtype, device=device).uniform_(
            -limit, limit, generator=gen)


class ZeroInitializer(Initializer):
    def __call__(self, gen, shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)


class ConstantInitializer(Initializer):
    def __init__(self, value: float):
        self.value = value

    def __call__(self, gen, shape, dtype, device):
        return torch.full(shape, self.value, dtype=dtype, device=device)


class NormInitializer(Initializer):
    def __init__(self, mean: float = 0.0, stddev: float = 1.0):
        self.mean = mean
        self.stddev = stddev

    def __call__(self, gen, shape, dtype, device):
        return torch.empty(shape, dtype=dtype, device=device).normal_(
            self.mean, self.stddev, generator=gen)


def default_kernel_initializer() -> Initializer:
    return GlorotUniformInitializer()


def default_bias_initializer() -> Initializer:
    return ZeroInitializer()
