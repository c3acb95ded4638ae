"""Keras initializer wrappers (reference python/flexflow/keras/initializers.py)
over the port's ``core/initializer.py``."""

from __future__ import annotations

from flexflow_tpu_torch.core.initializer import (
    ConstantInitializer,
    GlorotUniformInitializer,
    Initializer as CoreInitializer,
    NormInitializer,
    UniformInitializer,
    ZeroInitializer,
)


class Initializer:
    def to_core(self) -> CoreInitializer:
        raise NotImplementedError


class DefaultInitializer(Initializer):
    def to_core(self):
        return None


class Zeros(Initializer):
    def to_core(self):
        return ZeroInitializer()


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def to_core(self):
        return ConstantInitializer(self.value)


class GlorotUniform(Initializer):
    def __init__(self, seed: int = 0):
        self.seed = seed

    def to_core(self):
        return GlorotUniformInitializer(self.seed)


class RandomUniform(Initializer):
    def __init__(self, minval: float = -0.05, maxval: float = 0.05,
                 seed: int = 0):
        self.minval = minval
        self.maxval = maxval
        self.seed = seed

    def to_core(self):
        return UniformInitializer(self.seed, self.minval, self.maxval)


class RandomNormal(Initializer):
    def __init__(self, mean: float = 0.0, stddev: float = 0.05, seed: int = 0):
        self.mean = mean
        self.stddev = stddev
        self.seed = seed

    def to_core(self):
        return NormInitializer(self.seed, self.mean, self.stddev)


def as_core_initializer(init):
    """Accept keras-style, core, or None initializers."""
    if init is None:
        return None
    if isinstance(init, Initializer):
        return init.to_core()
    if isinstance(init, CoreInitializer):
        return init
    raise ValueError(f"unknown initializer {init!r}")
