"""Keras optimizer wrappers (reference python/flexflow/keras/optimizers.py)."""

from __future__ import annotations

from flexflow_tpu_torch.training.optimizer import (
    AdamOptimizer,
    Optimizer as CoreOptimizer,
    SGDOptimizer,
)


class Optimizer:
    def __init__(self):
        self._core = None

    def to_core(self, ffmodel) -> CoreOptimizer:
        raise NotImplementedError

    @property
    def learning_rate(self) -> float:
        return self._core.lr if self._core is not None else self.lr

    def set_learning_rate(self, lr: float):
        self.lr = lr
        if self._core is not None:
            self._core.set_learning_rate(lr)


class SGD(Optimizer):
    def __init__(self, learning_rate: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        super().__init__()
        self.lr = learning_rate
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def to_core(self, ffmodel) -> CoreOptimizer:
        return SGDOptimizer(ffmodel, lr=self.lr, momentum=self.momentum,
                            nesterov=self.nesterov,
                            weight_decay=self.weight_decay)


class Adam(Optimizer):
    def __init__(self, learning_rate: float = 0.001, beta_1: float = 0.9,
                 beta_2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__()
        self.lr = learning_rate
        self.beta_1 = beta_1
        self.beta_2 = beta_2
        self.epsilon = epsilon
        self.weight_decay = weight_decay

    def to_core(self, ffmodel) -> CoreOptimizer:
        return AdamOptimizer(ffmodel, alpha=self.lr, beta1=self.beta_1,
                             beta2=self.beta_2, epsilon=self.epsilon,
                             weight_decay=self.weight_decay)


class _CoreWrapper(Optimizer):
    def __init__(self, core: CoreOptimizer):
        super().__init__()
        self._core_template = core
        self.lr = core.lr

    def to_core(self, ffmodel) -> CoreOptimizer:
        self._core_template.ffmodel = ffmodel
        return self._core_template


def as_keras_optimizer(opt) -> Optimizer:
    if opt is None:
        return SGD()
    if isinstance(opt, Optimizer):
        return opt
    if isinstance(opt, CoreOptimizer):
        return _CoreWrapper(opt)
    if isinstance(opt, str):
        name = opt.lower()
        if name == "sgd":
            return SGD()
        if name == "adam":
            return Adam()
    raise ValueError(f"unknown optimizer {opt!r}")
