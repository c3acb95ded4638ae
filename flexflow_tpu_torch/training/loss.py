"""Loss functions (counterpart of ``flexflow_tpu/training/loss.py``):
scalar fp32 functions of the model's output that autograd
differentiates. When the final layer is a Softmax, the cross-entropies
take its pre-softmax logits through an fp32 ``log_softmax``. When a mesh
splits the batch, each rank passes its rows and ``batch=(psum, parts)``:
the loss is the whole batch's, the same on every rank."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import LossType


def _log_probs(output, logits):
    if logits is not None:
        return F.log_softmax(logits, dim=-1, dtype=torch.float32)
    return torch.log(output.float().clamp(1e-30, 1.0))


def compute_loss(loss_type: LossType, output, label, *, logits=None,
                 batch=None):
    """output: the model's final output; logits: the values before a final
    Softmax, when there is one. ``batch``: None, or ``(psum, parts)``
    when ``output`` and ``label`` are this rank's rows of a batch split
    in ``parts`` equal parts, ``psum`` summing a value over them."""
    if batch is None:
        mean, total = torch.mean, (lambda v: v)
    else:
        psum, parts = batch

        def mean(v):
            return psum(v.sum()) / (v.numel() * parts)

        total = psum
    if loss_type == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
        lbl = label.reshape(label.shape[0], -1)[:, 0].long()
        logp = _log_probs(output, logits)
        return -mean(logp.gather(-1, lbl[:, None]))
    if loss_type == LossType.LOSS_CATEGORICAL_CROSSENTROPY:
        logp = _log_probs(output, logits)
        return -mean((label.float() * logp).sum(dim=-1))
    if loss_type == LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE:
        d = output.float() - label.float()
        return mean(d.square().sum(dim=tuple(range(1, d.dim()))))
    if loss_type == LossType.LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE:
        d = output.float() - label.float()
        return total(d.square().sum())
    if loss_type == LossType.LOSS_IDENTITY:
        return mean(output.float())
    raise ValueError(loss_type)
