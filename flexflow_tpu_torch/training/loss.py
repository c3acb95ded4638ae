"""Loss functions (counterpart of ``flexflow_tpu/training/loss.py``):
scalar fp32 functions of the model's output that autograd
differentiates. When the final layer is a Softmax, the cross-entropies
take its pre-softmax logits through an fp32 ``log_softmax``. When a mesh
splits the batch, each rank passes its rows and ``batch=(psum, parts)``:
the loss is the whole batch's, the same on every rank. When a
tensor-parallel step leaves the output split over ``model`` on its class
(last) dim, as GSPMD leaves it in the JAX package's step, each rank
passes its columns and ``classes=(mesh, axis)``: the log-softmax takes
its max and its sum over the axis, a sparse label's probability is
picked on the rank that holds its column, and every sum over the
classes is added over the axis."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import LossType


class _SplitLogSoftmax(torch.autograd.Function):
    """fp32 ``log_softmax`` over the last dim of logits split there over
    ``axis``: the max and the exponentials' sum taken over the axis.
    Saves only its output, as ``F.log_softmax`` does (backward:
    ``g - exp(out) * sum(g)``, the sum added over the axis)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        from flexflow_tpu_torch.parallel.collectives import pmax, psum

        x = x.float()
        out = x - pmax(x.amax(dim=-1, keepdim=True), mesh, axis)
        s = psum(torch.exp(out).sum(dim=-1, keepdim=True), mesh, axis)
        out.sub_(torch.log(s))
        ctx.save_for_backward(out)
        ctx.args = (mesh, axis)
        return out

    @staticmethod
    def backward(ctx, g):
        from flexflow_tpu_torch.parallel.collectives import psum

        (out,) = ctx.saved_tensors
        mesh, axis = ctx.args
        total = psum(g.sum(dim=-1, keepdim=True), mesh, axis)
        return torch.exp(out).mul_(total).neg_().add_(g), None, None


def _log_probs(output, logits, classes=None):
    if logits is None:
        return torch.log(output.float().clamp(1e-30, 1.0))
    if classes is None:
        return F.log_softmax(logits, dim=-1, dtype=torch.float32)
    return _SplitLogSoftmax.apply(logits, *classes)


def compute_loss(loss_type: LossType, output, label, *, logits=None,
                 batch=None, classes=None):
    """output: the model's final output; logits: the values before a final
    Softmax, when there is one. ``batch``: None, or ``(psum, parts)``
    when ``output`` and ``label`` are this rank's rows of a batch split
    in ``parts`` equal parts, ``psum`` summing a value over them.
    ``classes``: None, or ``(mesh, axis)`` when ``output`` and
    ``logits`` are this rank's part of the last dim, split over ``axis``
    (``label`` stays whole there: a dense one is cut here)."""
    if batch is None:
        mean, total = torch.mean, (lambda v: v)
    else:
        psum, parts = batch

        def mean(v):
            return psum(v.sum()) / (v.numel() * parts)

        total = psum
    if classes is None:
        over, cut, n_cls = (lambda v: v), (lambda t: t), 1
    else:
        from flexflow_tpu_torch.parallel.collectives import \
            psum as psum_model

        mesh, axis = classes
        n_cls, i_cls = mesh.axis_size(axis), mesh.index(axis)

        def over(v):
            return psum_model(v, mesh, axis)

        def cut(t):
            return t.chunk(n_cls, dim=-1)[i_cls]
    if loss_type == LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY:
        lbl = label.reshape(label.shape[0], -1)[:, 0].long()
        logp = _log_probs(output, logits, classes)
        if classes is None:
            return -mean(logp.gather(-1, lbl[:, None]))
        # the rank that holds the label's column picks it
        cols = logp.shape[-1]
        mine = lbl - i_cls * cols
        hit = (mine >= 0) & (mine < cols)
        picked = logp.gather(-1, mine.clamp(0, cols - 1)[:, None])
        return -mean(over(torch.where(hit[:, None], picked,
                                      torch.zeros_like(picked))))
    if loss_type == LossType.LOSS_CATEGORICAL_CROSSENTROPY:
        logp = _log_probs(output, logits, classes)
        return -mean(over((cut(label).float() * logp).sum(dim=-1)))
    if loss_type == LossType.LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE:
        d = output.float() - cut(label).float()
        return mean(over(d.square().sum(dim=tuple(range(1, d.dim())))))
    if loss_type == LossType.LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE:
        d = output.float() - cut(label).float()
        return total(over(d.square().sum()))
    if loss_type == LossType.LOSS_IDENTITY:
        if classes is None:
            return mean(output.float())
        rows = over(output.float().sum(dim=-1))
        return mean(rows / (output.shape[-1] * n_cls))
    raise ValueError(loss_type)
