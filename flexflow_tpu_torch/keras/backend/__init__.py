"""Keras backend ops (counterpart of ``flexflow_tpu/keras/backend``;
reference flexflow.keras.backend): thin functional
wrappers over op-layers, used by the gather/reduce_sum/rsqrt/identity-loss
examples."""

from flexflow_tpu_torch.keras.layers import Gather, ReduceSum, Rsqrt


def sum(x, axis, keepdims: bool = False):      # noqa: A001 (keras name)
    return ReduceSum(axis=axis, keepdims=keepdims)(x)


def gather(x, indices, axis: int = 1):
    return Gather(axis=axis)([x, indices])


def rsqrt(x):
    return Rsqrt()(x)
