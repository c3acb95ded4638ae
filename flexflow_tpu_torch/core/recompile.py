"""Dynamic recompilation (counterpart of ``flexflow_tpu/core/recompile.py``;
the reference's RecompileState and ``FFModel::recompile_on_condition``,
model.cc:2791).

A user ``trigger_func`` is evaluated once a training iteration; when it
fires, ``alter_func`` changes the model (the MoE examples change a
capacity factor) and the model is compiled again with the same
optimizer, loss, metrics and mode. Every weight whose (layer, name,
shape, dtype) survives the change keeps its trained value; the others
are initialized afresh, as is the optimizer state.
"""

from __future__ import annotations

from typing import Callable

import torch


class RecompileState:
    def __init__(self, trigger_func: Callable[[], bool],
                 alter_func: Callable[["RecompileState"], None], ffmodel):
        self.trigger_func = trigger_func
        self.alter_func = alter_func
        self.ffmodel = ffmodel
        self.recompilations = 0

    def trigger(self) -> bool:
        return bool(self.trigger_func())

    def alter(self):
        self.alter_func(self)
        self.recompilations += 1


def recompile_on_condition(model, rs: RecompileState) -> bool:
    """Evaluate the trigger; when it fires, alter and compile ``model``
    again, keeping the surviving weights. Returns whether it fired."""
    if not rs.trigger():
        return False
    old = model.params or {}
    rs.alter()
    model.compile(optimizer=model.optimizer, loss_type=model.loss_type,
                  metrics=model.metrics, comp_mode=model.comp_mode)
    for lname, lp in model.params.items():
        for wname, w in lp.items():
            prev = old.get(lname, {}).get(wname)
            if (prev is not None and prev.shape == w.shape
                    and prev.dtype == w.dtype):
                with torch.no_grad():
                    w.copy_(prev)
    return True
