"""Optimizers: SGD (momentum, nesterov, weight decay) and Adam
(counterpart of ``flexflow_tpu/training/optimizer.py``).

The state mirrors the JAX package's: ``step`` and ``lr`` as device
scalars, then the per-parameter slots (``velocity``; ``m`` and ``v``),
``{layer: {weight: tensor}}`` like the parameters. ``update_step``
updates parameters and state in place under ``torch.no_grad()`` with
the JAX package's arithmetic, operation for operation, and reads nothing
back to the host: Adam's bias correction comes from the device-side step
count, and ``set_learning_rate`` writes the device-side rate between
steps.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from flexflow_tpu_torch.ffconst import ParameterSyncType


def _leaves(params, grads):
    """(param, grad) pairs; a parameter no loss term reached gets a zero
    gradient, as ``jax.grad`` gives it."""
    for layer, lp in params.items():
        for w, p in lp.items():
            g = grads.get(layer, {}).get(w)
            yield layer, w, p, (torch.zeros_like(p) if g is None else g)


def _zeros_like(params):
    return {layer: {w: torch.zeros_like(p) for w, p in lp.items()}
            for layer, lp in params.items()}


class Optimizer:
    # the reference's gradient sync (the JAX package's default); the
    # port's data-parallel gradients are all-reduced over the process
    # group (parallel/placement.GradReducer) whatever it says
    sync_type = ParameterSyncType.NCCL

    def __init__(self, ffmodel=None):
        self.ffmodel = ffmodel

    def _scalars(self, params) -> Dict[str, Any]:
        dev = next((p.device for lp in params.values() for p in lp.values()),
                   getattr(self.ffmodel, "device", "cpu"))
        return {"step": torch.zeros((), dtype=torch.int32, device=dev),
                "lr": torch.tensor(self.lr, dtype=torch.float32,
                                   device=dev)}

    def init_state(self, params) -> Dict[str, Any]:
        raise NotImplementedError

    def update_step(self, params, grads, state):
        """One update of ``params`` and ``state`` in place."""
        raise NotImplementedError

    def set_learning_rate(self, lr: float):
        """The rate of the next steps (the reference's set_lr): written
        into the live device-side state when the model has one."""
        self.lr = lr
        m = self.ffmodel
        if m is not None and getattr(m, "opt_state", None) is not None \
                and "lr" in m.opt_state:
            m.opt_state["lr"].fill_(lr)


class SGDOptimizer(Optimizer):
    def __init__(self, ffmodel=None, lr: float = 0.01, momentum: float = 0.0,
                 nesterov: bool = False, weight_decay: float = 0.0):
        super().__init__(ffmodel)
        self.lr = lr
        self.momentum = momentum
        self.nesterov = nesterov
        self.weight_decay = weight_decay

    def init_state(self, params):
        state = self._scalars(params)
        if self.momentum != 0.0:
            state["velocity"] = _zeros_like(params)
        return state

    @torch.no_grad()
    def update_step(self, params, grads, state):
        lr, mu, wd = state["lr"], self.momentum, self.weight_decay
        for layer, w, p, g in _leaves(params, grads):
            if wd > 0.0:
                g = g + wd * p
            if mu == 0.0:
                p.sub_(lr * g)
                continue
            v = state["velocity"][layer][w]
            v.mul_(mu).add_(g)
            p.sub_(lr * (g + mu * v if self.nesterov else v))
        state["step"] += 1


class AdamOptimizer(Optimizer):
    """Adam with the reference's decayed step size alpha_t = lr *
    sqrt(1 - beta2^t) / (1 - beta1^t), t the step count."""

    def __init__(self, ffmodel=None, alpha: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, weight_decay: float = 0.0,
                 epsilon: float = 1e-8):
        super().__init__(ffmodel)
        self.lr = alpha
        self.beta1 = beta1
        self.beta2 = beta2
        self.weight_decay = weight_decay
        self.epsilon = epsilon

    def init_state(self, params):
        return dict(self._scalars(params), m=_zeros_like(params),
                    v=_zeros_like(params))

    @torch.no_grad()
    def update_step(self, params, grads, state):
        b1, b2, eps, wd = (self.beta1, self.beta2, self.epsilon,
                           self.weight_decay)
        state["step"] += 1
        t = state["step"].float()
        alpha_t = state["lr"] * torch.sqrt(1 - torch.pow(b2, t)) \
            / (1 - torch.pow(b1, t))
        for layer, w, p, g in _leaves(params, grads):
            if wd > 0.0:
                g = g + wd * p
            m = state["m"][layer][w].mul_(b1).add_((1 - b1) * g)
            v = state["v"][layer][w].mul_(b2).add_((1 - b2) * g.square())
            p.sub_(alpha_t * m / (v.sqrt() + eps))
