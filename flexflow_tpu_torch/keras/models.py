"""Keras-compatible ``Model``/``Sequential`` on top of the port's FFModel
(counterpart of ``flexflow_tpu/keras/models.py``; reference
``python/flexflow/keras/models/``). ``compile`` lowers the Keras graph to
FFModel ops and compiles them on ``ffconfig.device``; a model built
without an ``ffconfig`` gets ``FFConfig()``, which is the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from flexflow_tpu_torch.config import FFConfig
from flexflow_tpu_torch.core.model import FFModel
from flexflow_tpu_torch.ffconst import DataType, LossType, MetricsType
from flexflow_tpu_torch.keras.layers import InputLayer, KerasTensor, Layer
from flexflow_tpu_torch.keras import optimizers as _opt
from flexflow_tpu_torch.training.optimizer import Optimizer as CoreOptimizer

_LOSSES = {
    "categorical_crossentropy": LossType.LOSS_CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy":
        LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
    "mse": LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE,
    "identity": LossType.LOSS_IDENTITY,
}

_METRICS = {
    "accuracy": MetricsType.METRICS_ACCURACY,
    "categorical_crossentropy": MetricsType.METRICS_CATEGORICAL_CROSSENTROPY,
    "sparse_categorical_crossentropy":
        MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY,
    "mean_squared_error": MetricsType.METRICS_MEAN_SQUARED_ERROR,
    "mse": MetricsType.METRICS_MEAN_SQUARED_ERROR,
    "root_mean_squared_error": MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR,
    "mean_absolute_error": MetricsType.METRICS_MEAN_ABSOLUTE_ERROR,
}

_NP_TO_FF_DTYPE = {
    "float32": DataType.DT_FLOAT,
    "int32": DataType.DT_INT32,
    "int64": DataType.DT_INT64,
}


class History:
    def __init__(self):
        self.history: Dict[str, List[float]] = {}

    def append(self, record: Dict[str, float]):
        for k, v in record.items():
            self.history.setdefault(k, []).append(v)


class BaseModel:
    """Shared compile/fit/evaluate (reference keras/models/base_model.py:31)."""

    def __init__(self, name: Optional[str] = None,
                 ffconfig: Optional[FFConfig] = None):
        self.name = name or type(self).__name__.lower()
        self._ffconfig = ffconfig
        self._ffmodel: Optional[FFModel] = None
        self._inputs: List[KerasTensor] = []
        self._outputs: List[KerasTensor] = []
        self._layers: List[Layer] = []
        self._optimizer = None
        self._loss = None
        self._metrics: List[str] = []

    # --- introspection ---------------------------------------------------
    @property
    def layers(self) -> List[Layer]:
        return [l for l in self._layers if not isinstance(l, InputLayer)]

    @property
    def input(self) -> KerasTensor:
        return self._inputs[0]

    @property
    def output(self) -> KerasTensor:
        return self._outputs[0]

    @property
    def ffmodel(self) -> Optional[FFModel]:
        return self._ffmodel

    @property
    def ffconfig(self) -> Optional[FFConfig]:
        return self._ffconfig

    @property
    def optimizer(self):
        return self._optimizer

    def __call__(self, inputs):
        """Use this model as a layer in another functional graph
        (reference func_cifar10_cnn_nested.py: ``model1(input_tensor)``).
        The model's layers are REWIRED onto the new input tensors — its
        own standalone graph is abandoned, matching the reference pattern
        where nested sub-models are built only to be composed."""
        ts = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
        if getattr(self, "_nested_used", False):
            raise NotImplementedError(
                f"{self.name}: model already composed into another graph — "
                f"sharing one sub-model across call sites (siamese weight "
                f"tying) is not supported; build a second sub-model")
        self._nested_used = True
        if not self._outputs:
            self._finalize_graph()
        if len(ts) != len(self._inputs):
            raise ValueError(f"{self.name}: expects {len(self._inputs)} "
                             f"inputs, got {len(ts)}")
        order = self._topo_layers()
        mapping = {id(o): n for o, n in zip(self._inputs, ts)}
        out_ids = [id(o) for o in self._outputs]
        for layer in order:
            if isinstance(layer, InputLayer):
                continue
            new_ins = [mapping[id(src)] for src in layer.inbound]
            old_out = layer.outbound
            layer.inbound, layer.outbound = [], []
            new_out = layer(new_ins if len(new_ins) > 1 else new_ins[0])
            for oo in old_out:
                mapping[id(oo)] = new_out
        outs = [mapping[i] for i in out_ids]
        return outs[0] if len(outs) == 1 else outs

    def get_layer(self, name: Optional[str] = None,
                  index: Optional[int] = None) -> Layer:
        if index is not None:
            return self.layers[index]
        for l in self.layers:
            if l.name == name:
                return l
        raise ValueError(f"no layer named {name!r}")

    def summary(self, print_fn=print):
        lines = [f'Model: "{self.name}"',
                 f"{'Layer (type)':<36}{'Output Shape':<24}{'Param #':<10}"]
        total = 0
        for l in self._layers:
            shape = l.output.shape if l.outbound else "?"
            n = l.count_params()
            total += n
            lines.append(f"{l.name + ' (' + type(l).__name__ + ')':<36}"
                         f"{str(shape):<24}{n:<10}")
        lines.append(f"Total params: {total}")
        out = "\n".join(lines)
        print_fn(out)
        return out

    # --- graph lowering --------------------------------------------------
    def _topo_layers(self) -> List[Layer]:
        """Topological order over the recorded KerasTensor graph."""
        order: List[Layer] = []
        seen = set()

        def visit(t: KerasTensor):
            l = t.layer
            if l is None or id(l) in seen:
                return
            for src in l.inbound:
                visit(src)
            seen.add(id(l))
            order.append(l)

        for out in self._outputs:
            visit(out)
        return order

    def _build_ff(self, batch_size: int) -> FFModel:
        ffmodel = FFModel(self._ffconfig)
        for t in self._inputs:
            dtype = _NP_TO_FF_DTYPE.get(t.dtype, DataType.DT_FLOAT)
            t.ff_tensor = ffmodel.create_tensor(
                [batch_size] + list(t.shape[1:]), dtype)
        for layer in self._topo_layers():
            if isinstance(layer, InputLayer):
                continue
            ff_ins = [src.ff_tensor for src in layer.inbound]
            layer.output.ff_tensor = layer.build_ff(ffmodel, ff_ins)
            layer._model = ffmodel
        return ffmodel

    def compile(self, optimizer=None, loss=None, metrics=None,
                batch_size: Optional[int] = None, **kwargs):
        """Lower the Keras graph to an FFModel and compile it for
        training (reference keras/models/base_model.py:128)."""
        if not self._outputs:
            self._finalize_graph()
        if self._ffconfig is None:
            self._ffconfig = FFConfig()
        if batch_size is not None:
            self._ffconfig.batch_size = batch_size
        self._optimizer = _opt.as_keras_optimizer(optimizer)
        if isinstance(loss, LossType):
            self._loss = loss
        elif hasattr(loss, "loss_type"):       # keras.losses.* instance
            self._loss = loss.loss_type
        else:
            self._loss = _LOSSES[loss]
        self._metrics = metrics or []

        def metric_type(m):
            if isinstance(m, MetricsType):
                return m
            if hasattr(m, "metrics_type"):     # keras.metrics.* instance
                return m.metrics_type
            return _METRICS[m]

        metric_types = [metric_type(m) for m in self._metrics]

        self._ffmodel = self._build_ff(self._ffconfig.batch_size)
        core_opt = self._optimizer.to_core(self._ffmodel)
        self._optimizer._core = core_opt
        self._ffmodel.compile(optimizer=core_opt, loss_type=self._loss,
                              metrics=metric_types)
        return self

    def _finalize_graph(self):
        raise NotImplementedError

    # --- training verbs --------------------------------------------------
    def fit(self, x=None, y=None, epochs: int = 1,
            batch_size: Optional[int] = None, callbacks=None,
            shuffle: bool = False, verbose: bool = True) -> History:
        if self._ffmodel is None:
            raise RuntimeError("compile() the model before fit()")
        callbacks = list(callbacks or [])
        for cb in callbacks:
            cb.set_model(self)
            cb.on_train_begin()
        history = History()
        for epoch in range(epochs):
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            rec = self._ffmodel.fit(x, y, batch_size=batch_size, epochs=1,
                                    shuffle=shuffle, initial_epoch=epoch)[0]
            rec = {k: v for k, v in rec.items() if k != "epoch"}
            history.append(rec)
            for cb in callbacks:
                cb.on_epoch_end(epoch, rec)
        for cb in callbacks:
            cb.on_train_end()
        return history

    def evaluate(self, x=None, y=None, batch_size: Optional[int] = None):
        return self._ffmodel.evaluate(x, y, batch_size=batch_size)

    def predict(self, x, batch_size: Optional[int] = None) -> np.ndarray:
        xs = x if isinstance(x, (list, tuple)) else [x]
        xs = [np.asarray(a) for a in xs]
        bs = self._ffconfig.batch_size
        n = xs[0].shape[0]
        outs = []
        for i in range(0, n - bs + 1, bs):
            outs.append(self._ffmodel.predict([a[i:i + bs] for a in xs]))
        rem = n % bs
        if rem:
            pad = [np.concatenate([a[n - rem:],
                                   np.repeat(a[-1:], bs - rem, axis=0)])
                   for a in xs]
            outs.append(self._ffmodel.predict(pad)[:rem])
        return np.concatenate(outs, axis=0)


class Model(BaseModel):
    """Functional-API model (reference keras/models/model.py)."""

    def __init__(self, inputs, outputs, name: Optional[str] = None,
                 ffconfig: Optional[FFConfig] = None):
        super().__init__(name=name, ffconfig=ffconfig)
        self._inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]
        self._outputs = list(outputs) if isinstance(outputs, (list, tuple)) \
            else [outputs]
        self._layers = self._topo_layers()

    def _finalize_graph(self):
        pass


class Sequential(BaseModel):
    """Linear stack of layers (reference keras/models/sequential.py)."""

    def __init__(self, layers: Optional[Sequence[Layer]] = None,
                 name: Optional[str] = None,
                 ffconfig: Optional[FFConfig] = None):
        super().__init__(name=name, ffconfig=ffconfig)
        self._pending: List[Layer] = []
        for l in layers or []:
            self.add(l)

    def add(self, layer: Layer):
        self._pending.append(layer)

    def pop(self):
        self._pending.pop()

    def _finalize_graph(self):
        if not self._pending:
            raise ValueError("Sequential model has no layers")
        first = self._pending[0]
        if isinstance(first, InputLayer):
            x = first.output
            rest = self._pending[1:]
        else:
            if first.input_shape_arg is None:
                raise ValueError("first layer needs input_shape=...")
            dtype = "int32" if type(first).__name__ == "Embedding" \
                else "float32"
            inp = InputLayer(shape=first.input_shape_arg, dtype=dtype)
            x = inp.output
            rest = self._pending
        self._inputs = [x]
        for layer in rest:
            x = layer(x)
        self._outputs = [x]
        self._layers = self._topo_layers()
