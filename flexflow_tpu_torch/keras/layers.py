"""Keras-compatible layer classes (deferred graph builders).

Capability parity with the reference Keras frontend
(``python/flexflow/keras/layers/``: core.py Dense/Flatten/Embedding/Activation/
Dropout/Reshape/Permute, convolutional.py Conv2D, pool.py Max/AveragePooling2D,
merge.py Concatenate/Add/Subtract/Multiply/Maximum/Minimum, normalization.py
BatchNormalization, input_layer.py Input). Layers record a symbolic graph of
``KerasTensor``s; ``Model.compile`` lowers the graph onto the port's
:class:`~flexflow_tpu_torch.core.model.FFModel` via the op-builder API
(the counterpart of ``flexflow_tpu/keras/layers.py``). ``set_weights`` and
``get_weights`` go through the model's ``set_parameter_by_key`` and
``get_parameter_by_key``: arrays or tensors in, fp32 numpy out.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np

from flexflow_tpu_torch.ffconst import ActiMode, AggrMode, DataType, PoolType

_ACTIVATIONS = {
    None: ActiMode.AC_MODE_NONE,
    "linear": ActiMode.AC_MODE_NONE,
    "relu": ActiMode.AC_MODE_RELU,
    "sigmoid": ActiMode.AC_MODE_SIGMOID,
    "tanh": ActiMode.AC_MODE_TANH,
    "gelu": ActiMode.AC_MODE_GELU,
}

_DTYPES = {
    "float32": DataType.DT_FLOAT,
    "float64": DataType.DT_DOUBLE,
    "float16": DataType.DT_HALF,
    "bfloat16": DataType.DT_BFLOAT16,
    "int32": DataType.DT_INT32,
    "int64": DataType.DT_INT64,
}

_name_counters = itertools.count()


def _auto_name(prefix: str) -> str:
    return f"{prefix}_{next(_name_counters)}"


class KerasTensor:
    """Symbolic tensor: shape with a ``None`` batch dim + producing layer."""

    def __init__(self, shape: Tuple, dtype: str = "float32",
                 layer: Optional["Layer"] = None, idx: int = 0):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.layer = layer          # producing layer (None for Input)
        self.idx = idx
        self.ff_tensor = None       # filled during Model._build_ff

    @property
    def batch_shape(self):
        return self.shape

    def __repr__(self):
        who = self.layer.name if self.layer is not None else "input"
        return f"KerasTensor(shape={self.shape}, from={who})"


def Input(shape: Sequence[int], dtype: str = "float32",
          name: Optional[str] = None) -> KerasTensor:
    """Functional-API entry (reference keras/layers/input_layer.py Input)."""
    layer = InputLayer(shape=shape, dtype=dtype, name=name)
    return layer.output


class Layer:
    def __init__(self, name: Optional[str] = None, **kwargs):
        self.name = name or _auto_name(type(self).__name__.lower())
        self.input_shape_arg = kwargs.pop("input_shape", None)
        self.inbound: List[KerasTensor] = []
        self.outbound: List[KerasTensor] = []
        self._model = None          # set by Model.compile for get_weights
        # accept-and-ignore common keras kwargs we do not differentiate on
        kwargs.pop("trainable", None)
        kwargs.pop("dtype", None)

    # --- graph recording -------------------------------------------------
    def __call__(self, inputs):
        if self.inbound:
            raise NotImplementedError(
                f"{self.name}: layer called twice — shared layers (weight "
                f"tying across call sites) are not supported yet; create a "
                f"second layer instance instead")
        ins = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        for t in ins:
            if not isinstance(t, KerasTensor):
                raise TypeError(f"{self.name}: expected KerasTensor, got {t!r}")
        self.inbound = ins
        out_shapes = self.compute_output_shape([t.shape for t in ins])
        self.outbound = [KerasTensor(s, ins[0].dtype, self, i)
                         for i, s in enumerate([out_shapes])]
        return self.outbound[0]

    @property
    def output(self) -> KerasTensor:
        return self.outbound[0]

    @property
    def input(self) -> KerasTensor:
        return self.inbound[0]

    def compute_output_shape(self, input_shapes):
        raise NotImplementedError

    def build_ff(self, ffmodel, ff_inputs):
        """Lower onto the FFModel op-builder; returns the output ff tensor."""
        raise NotImplementedError

    # --- weights ---------------------------------------------------------
    _weight_names: Tuple[str, ...] = ()

    def get_weights(self, ffmodel=None) -> List[np.ndarray]:
        m = ffmodel or self._model
        if m is None:
            raise RuntimeError(f"{self.name}: model not compiled yet")
        return [m.get_parameter_by_key((self.name, w))
                for w in self._weight_names]

    def set_weights(self, weights: Sequence[np.ndarray], ffmodel=None):
        m = ffmodel or self._model
        if m is None:
            raise RuntimeError(f"{self.name}: model not compiled yet")
        if len(weights) != len(self._weight_names):
            raise ValueError(f"{self.name}: expected {len(self._weight_names)} "
                             f"arrays, got {len(weights)}")
        for w, arr in zip(self._weight_names, weights):
            m.set_parameter_by_key((self.name, w), arr)

    def count_params(self) -> int:
        try:
            return int(sum(np.prod(w.shape) for w in self.get_weights()))
        except RuntimeError:
            return 0


class InputLayer(Layer):
    def __init__(self, shape: Sequence[int], dtype: str = "float32",
                 name: Optional[str] = None):
        super().__init__(name=name or _auto_name("input"))
        self.shape = tuple(shape)
        self.dtype = dtype
        self.outbound = [KerasTensor((None,) + self.shape, dtype, self)]

    def compute_output_shape(self, input_shapes):
        return (None,) + self.shape

    def build_ff(self, ffmodel, ff_inputs):
        raise RuntimeError("InputLayer is lowered by the model, not build_ff")


class Dense(Layer):
    _weight_names = ("kernel", "bias")

    def __init__(self, units: int, activation=None, use_bias: bool = True,
                 kernel_initializer=None, bias_initializer=None,
                 kernel_regularizer=None,
                 name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.units = units
        self.activation = activation
        self.use_bias = use_bias
        if not use_bias:
            self._weight_names = ("kernel",)
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer
        self.kernel_regularizer = kernel_regularizer

    def compute_output_shape(self, input_shapes):
        (s,) = input_shapes
        return tuple(s[:-1]) + (self.units,)

    def build_ff(self, ffmodel, ff_inputs):
        act = self.activation
        if act is not None and not isinstance(act, str):
            raise ValueError(f"{self.name}: activation must be a string or "
                             f"None, got {act!r}")
        fused = _ACTIVATIONS.get(act)
        if fused is None and act not in (None, "softmax", "elu"):
            # validate BEFORE adding the layer so a caught error leaves no
            # ghost layer in the model graph (same rule as Conv2D)
            raise ValueError(f"unsupported activation {act!r}")
        from flexflow_tpu_torch.keras.initializers import as_core_initializer
        from flexflow_tpu_torch.keras.regularizers import as_attr
        x = ffmodel.dense(
            ff_inputs[0], self.units,
            activation=fused if fused is not None else ActiMode.AC_MODE_NONE,
            use_bias=self.use_bias,
            kernel_initializer=as_core_initializer(self.kernel_initializer),
            bias_initializer=as_core_initializer(self.bias_initializer),
            kernel_regularizer=as_attr(self.kernel_regularizer),
            name=self.name)
        if act == "softmax":
            x = ffmodel.softmax(x)
        elif act == "elu":
            x = ffmodel.elu(x)
        return x


class Flatten(Layer):
    def compute_output_shape(self, input_shapes):
        (s,) = input_shapes
        return (None, int(np.prod(s[1:])))

    def build_ff(self, ffmodel, ff_inputs):
        return ffmodel.flat(ff_inputs[0], name=self.name)


class Activation(Layer):
    def __init__(self, activation: str, name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.activation = activation

    def compute_output_shape(self, input_shapes):
        return tuple(input_shapes[0])

    def build_ff(self, ffmodel, ff_inputs):
        x = ff_inputs[0]
        fn = {"relu": ffmodel.relu, "sigmoid": ffmodel.sigmoid,
              "tanh": ffmodel.tanh, "elu": ffmodel.elu, "gelu": ffmodel.gelu,
              "softmax": ffmodel.softmax,
              "linear": ffmodel.identity}.get(self.activation)
        if fn is None:
            raise ValueError(f"unsupported activation {self.activation!r}")
        return fn(x, name=self.name)


class Dropout(Layer):
    def __init__(self, rate: float, seed: int = 0,
                 name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.rate = rate
        self.seed = seed

    def compute_output_shape(self, input_shapes):
        return tuple(input_shapes[0])

    def build_ff(self, ffmodel, ff_inputs):
        return ffmodel.dropout(ff_inputs[0], self.rate, self.seed,
                               name=self.name)


class Reshape(Layer):
    def __init__(self, target_shape: Sequence[int],
                 name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.target_shape = tuple(target_shape)

    def compute_output_shape(self, input_shapes):
        return (None,) + self.target_shape

    def build_ff(self, ffmodel, ff_inputs):
        batch = ff_inputs[0].dims[0]
        return ffmodel.reshape(ff_inputs[0], (batch,) + self.target_shape,
                               name=self.name)


class Permute(Layer):
    def __init__(self, dims: Sequence[int], name: Optional[str] = None,
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self.dims = tuple(dims)     # 1-indexed over non-batch dims (keras)

    def compute_output_shape(self, input_shapes):
        (s,) = input_shapes
        return (None,) + tuple(s[d] for d in self.dims)

    def build_ff(self, ffmodel, ff_inputs):
        perm = (0,) + self.dims
        return ffmodel.transpose(ff_inputs[0], perm, name=self.name)


class Embedding(Layer):
    _weight_names = ("weight",)

    def __init__(self, input_dim: int, output_dim: int,
                 embeddings_initializer=None, name: Optional[str] = None,
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.embeddings_initializer = embeddings_initializer

    def compute_output_shape(self, input_shapes):
        (s,) = input_shapes
        return tuple(s) + (self.output_dim,)

    def build_ff(self, ffmodel, ff_inputs):
        from flexflow_tpu_torch.keras.initializers import as_core_initializer
        return ffmodel.embedding(
            ff_inputs[0], self.input_dim, self.output_dim,
            aggr=AggrMode.AGGR_MODE_NONE,
            kernel_initializer=as_core_initializer(self.embeddings_initializer),
            name=self.name)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_padding(padding, kh, kw, sh=1, sw=1, h=None, w=None):
    if padding == "valid":
        return 0, 0
    if padding == "same":
        # Keras SAME pads to output ceil(size/stride), splitting the total
        # pad as (total//2, total - total//2) with the extra row/col at the
        # bottom/right. The symmetric-(ph, pw) builder can express exactly
        # the even-total cases; an odd total would silently shift every
        # window by one pixel, so reject it instead.
        def same_pad(size, k, s, axis):
            total = max((-(-size // s) - 1) * s + k - size, 0)
            if total % 2:
                raise NotImplementedError(
                    f"padding='same' with kernel {k}, stride {s} on "
                    f"{axis}={size} needs asymmetric padding "
                    f"({total // 2}, {total - total // 2}); use explicit "
                    "(ph, pw) padding instead")
            return total // 2
        return same_pad(h, kh, sh, "height"), same_pad(w, kw, sw, "width")
    return _pair(padding)


class Conv2D(Layer):
    """NCHW (channels_first) 2-D convolution, matching the reference frontend
    (python/flexflow/keras/layers/convolutional.py:25)."""

    _weight_names = ("kernel", "bias")

    def __init__(self, filters: int, kernel_size, strides=(1, 1),
                 padding="valid", activation=None, use_bias: bool = True,
                 groups: int = 1, kernel_initializer=None,
                 bias_initializer=None, kernel_regularizer=None,
                 name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.filters = filters
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding
        self.activation = activation
        self.use_bias = use_bias
        if not use_bias:
            self._weight_names = ("kernel",)
        self.groups = groups
        self.kernel_initializer = kernel_initializer
        self.bias_initializer = bias_initializer
        self.kernel_regularizer = kernel_regularizer

    def compute_output_shape(self, input_shapes):
        (s,) = input_shapes
        _, c, h, w = s
        kh, kw = self.kernel_size
        sh, sw = self.strides
        ph, pw = _conv_padding(self.padding, kh, kw, sh, sw, h, w)
        oh = (h + 2 * ph - kh) // sh + 1
        ow = (w + 2 * pw - kw) // sw + 1
        return (None, self.filters, oh, ow)

    def build_ff(self, ffmodel, ff_inputs):
        kh, kw = self.kernel_size
        sh, sw = self.strides
        _, _, h, w = ff_inputs[0].dims
        ph, pw = _conv_padding(self.padding, kh, kw, sh, sw, h, w)
        act = self.activation
        if act is not None and not isinstance(act, str):
            raise ValueError(f"{self.name}: activation must be a string or "
                             f"None, got {act!r}")
        fused = _ACTIVATIONS.get(act)
        if fused is None and act is not None:
            # validate BEFORE adding the layer so a caught error leaves no
            # ghost layer in the model graph
            raise ValueError(f"unsupported activation {act!r}")
        from flexflow_tpu_torch.keras.initializers import as_core_initializer
        from flexflow_tpu_torch.keras.regularizers import as_attr
        return ffmodel.conv2d(
            ff_inputs[0], self.filters, kh, kw, sh, sw, ph, pw,
            activation=fused if fused is not None else ActiMode.AC_MODE_NONE,
            groups=self.groups, use_bias=self.use_bias,
            kernel_initializer=as_core_initializer(self.kernel_initializer),
            bias_initializer=as_core_initializer(self.bias_initializer),
            kernel_regularizer=as_attr(self.kernel_regularizer),
            name=self.name)


class _Pooling2D(Layer):
    pool_type = PoolType.POOL_MAX

    def __init__(self, pool_size=(2, 2), strides=None, padding="valid",
                 name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.pool_size = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None else self.pool_size
        self.padding = padding

    def compute_output_shape(self, input_shapes):
        (s,) = input_shapes
        _, c, h, w = s
        kh, kw = self.pool_size
        sh, sw = self.strides
        ph, pw = _conv_padding(self.padding, kh, kw, sh, sw, h, w)
        return (None, c, (h + 2 * ph - kh) // sh + 1,
                (w + 2 * pw - kw) // sw + 1)

    def build_ff(self, ffmodel, ff_inputs):
        kh, kw = self.pool_size
        sh, sw = self.strides
        _, _, h, w = ff_inputs[0].dims
        ph, pw = _conv_padding(self.padding, kh, kw, sh, sw, h, w)
        return ffmodel.pool2d(ff_inputs[0], kh, kw, sh, sw, ph, pw,
                              pool_type=self.pool_type, name=self.name)


class MaxPooling2D(_Pooling2D):
    pool_type = PoolType.POOL_MAX


class AveragePooling2D(_Pooling2D):
    pool_type = PoolType.POOL_AVG


class BatchNormalization(Layer):
    def __init__(self, relu: bool = False, name: Optional[str] = None,
                 **kwargs):
        super().__init__(name=name, **kwargs)
        self.relu = relu

    def compute_output_shape(self, input_shapes):
        return tuple(input_shapes[0])

    def build_ff(self, ffmodel, ff_inputs):
        return ffmodel.batch_norm(ff_inputs[0], relu=self.relu, name=self.name)


class _Merge(Layer):
    def compute_output_shape(self, input_shapes):
        return tuple(input_shapes[0])

    def _merge(self, ffmodel, a, b):
        raise NotImplementedError

    def build_ff(self, ffmodel, ff_inputs):
        out = ff_inputs[0]
        for t in ff_inputs[1:]:
            out = self._merge(ffmodel, out, t)
        return out


class Add(_Merge):
    def _merge(self, ffmodel, a, b):
        return ffmodel.add(a, b, name=self.name)


class Subtract(_Merge):
    def _merge(self, ffmodel, a, b):
        return ffmodel.subtract(a, b, name=self.name)


class Multiply(_Merge):
    def _merge(self, ffmodel, a, b):
        return ffmodel.multiply(a, b, name=self.name)


class Maximum(_Merge):
    def _merge(self, ffmodel, a, b):
        return ffmodel.max(a, b, name=self.name)


class Minimum(_Merge):
    def _merge(self, ffmodel, a, b):
        return ffmodel.min(a, b, name=self.name)


class Concatenate(_Merge):
    def __init__(self, axis: int = 1, name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.axis = axis

    def compute_output_shape(self, input_shapes):
        out = list(input_shapes[0])
        out[self.axis] = sum(s[self.axis] for s in input_shapes)
        return tuple(out)

    def build_ff(self, ffmodel, ff_inputs):
        return ffmodel.concat(list(ff_inputs), self.axis, name=self.name)


# --- op-layers backing flexflow.keras.backend (reference keras backend
# internal ops: gather, reduce-sum, rsqrt examples) ---------------------
class Gather(Layer):
    """torch.gather semantics along ``axis`` (reference gather example)."""

    def __init__(self, axis: int = 1, name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.axis = axis

    def compute_output_shape(self, input_shapes):
        return tuple(input_shapes[1])

    def build_ff(self, ffmodel, ff_inputs):
        return ffmodel.gather(ff_inputs[0], ff_inputs[1], self.axis,
                              name=self.name)


class ReduceSum(Layer):
    def __init__(self, axis, keepdims: bool = False,
                 name: Optional[str] = None, **kwargs):
        super().__init__(name=name, **kwargs)
        self.axes = [axis] if isinstance(axis, int) else list(axis)
        self.keepdims = keepdims

    def compute_output_shape(self, input_shapes):
        s = list(input_shapes[0])
        for a in sorted(self.axes, reverse=True):
            if self.keepdims:
                s[a] = 1
            else:
                del s[a]
        return tuple(s)

    def build_ff(self, ffmodel, ff_inputs):
        return ffmodel.reduce_sum(ff_inputs[0], self.axes,
                                  keepdims=self.keepdims, name=self.name)


class Rsqrt(Layer):
    def compute_output_shape(self, input_shapes):
        return tuple(input_shapes[0])

    def build_ff(self, ffmodel, ff_inputs):
        return ffmodel.rsqrt(ff_inputs[0], name=self.name)


# --- functional merge aliases (reference keras.layers.add/subtract/...) --
def add(inputs, **kwargs):
    return Add(**kwargs)(inputs)


def subtract(inputs, **kwargs):
    return Subtract(**kwargs)(inputs)


def multiply(inputs, **kwargs):
    return Multiply(**kwargs)(inputs)


def maximum(inputs, **kwargs):
    return Maximum(**kwargs)(inputs)


def minimum(inputs, **kwargs):
    return Minimum(**kwargs)(inputs)


def concatenate(inputs, axis: int = 1, **kwargs):
    return Concatenate(axis=axis, **kwargs)(inputs)


# tensor arithmetic sugar (`x + y` in the reference rsqrt example).
# Only tensor-tensor pairs are supported; a non-tensor operand returns
# NotImplemented so Python raises a clear TypeError instead of crashing
# deep inside layer building. No reflected ops: Python only consults
# them when the LEFT operand is not a KerasTensor, and that case is
# unsupported by design.
def _binary_sugar(layer_fn):
    def op(self, other):
        if not isinstance(other, KerasTensor):
            return NotImplemented
        return layer_fn([self, other])
    return op


KerasTensor.__add__ = _binary_sugar(add)
KerasTensor.__sub__ = _binary_sugar(subtract)
KerasTensor.__mul__ = _binary_sugar(multiply)
