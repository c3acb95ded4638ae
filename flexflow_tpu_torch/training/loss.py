"""Loss functions (counterpart of ``flexflow_tpu/training/loss.py``):
scalar fp32 functions of the model's output that autograd
differentiates. When the final layer is a Softmax, the cross-entropies
take its pre-softmax logits through an fp32 ``log_softmax``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import LossType


def _log_probs(output, logits):
    if logits is not None:
        return F.log_softmax(logits, dim=-1, dtype=torch.float32)
    return torch.log(output.float().clamp(1e-30, 1.0))


def compute_loss(loss_type: LossType, output, label, *, logits=None):
    """output: the model's final output; logits: the values before a final
    Softmax, when there is one."""
    if loss_type == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
        lbl = label.reshape(label.shape[0], -1)[:, 0].long()
        logp = _log_probs(output, logits)
        return -logp.gather(-1, lbl[:, None]).mean()
    if loss_type == LossType.LOSS_CATEGORICAL_CROSSENTROPY:
        logp = _log_probs(output, logits)
        return -(label.float() * logp).sum(dim=-1).mean()
    if loss_type == LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE:
        d = output.float() - label.float()
        return d.square().sum(dim=tuple(range(1, d.dim()))).mean()
    if loss_type == LossType.LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE:
        d = output.float() - label.float()
        return d.square().sum()
    if loss_type == LossType.LOSS_IDENTITY:
        return output.float().mean()
    raise ValueError(loss_type)
