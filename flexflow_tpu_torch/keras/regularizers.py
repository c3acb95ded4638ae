"""Keras weight regularizers (reference python/flexflow/keras/regularizers.py).

Instances lower to ("l1"|"l2", coeff) attr pairs on the layer; the penalty
is traced into the training loss at compile (core/model.py reg_terms).
"""

from __future__ import annotations


class Regularizer:
    def to_attr(self):
        raise NotImplementedError


class L1(Regularizer):
    def __init__(self, l1: float = 0.01):
        self.l1 = l1

    def to_attr(self):
        return [("l1", self.l1)]


class L2(Regularizer):
    def __init__(self, l2: float = 0.01):
        self.l2 = l2

    def to_attr(self):
        return [("l2", self.l2)]


class L1L2(Regularizer):
    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1 = l1
        self.l2 = l2

    def to_attr(self):
        out = []
        if self.l1:
            out.append(("l1", self.l1))
        if self.l2:
            out.append(("l2", self.l2))
        return out


def l1(value: float = 0.01) -> L1:
    return L1(value)


def l2(value: float = 0.01) -> L2:
    return L2(value)


def l1_l2(l1: float = 0.01, l2: float = 0.01) -> L1L2:
    return L1L2(l1, l2)


def as_attr(reg):
    """None | Regularizer | ("l2", c) | [pairs] -> attr form."""
    if reg is None:
        return None
    if isinstance(reg, Regularizer):
        return reg.to_attr()
    return reg
