"""Metrics (counterpart of ``flexflow_tpu/training/metrics.py``): per-step
sums computed on the device, accumulated on the host by ``PerfMetrics``."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from flexflow_tpu_torch.ffconst import LossType, MetricsType

_LOSS_KEYS = ("cce_loss", "sparse_cce_loss", "mse_loss", "rmse_loss",
              "mae_loss")


@dataclasses.dataclass
class PerfMetrics:
    train_all: int = 0
    train_correct: int = 0
    cce_loss: float = 0.0
    sparse_cce_loss: float = 0.0
    mse_loss: float = 0.0
    rmse_loss: float = 0.0
    mae_loss: float = 0.0

    def update(self, step_metrics: Dict[str, float], batch_size: int):
        self.train_all += batch_size
        if "accuracy_correct" in step_metrics:
            self.train_correct += int(step_metrics["accuracy_correct"])
        for k in _LOSS_KEYS:
            if k in step_metrics:
                setattr(self, k, getattr(self, k) + float(step_metrics[k]))

    @property
    def accuracy(self) -> float:
        return self.train_correct / max(1, self.train_all)

    def report(self) -> str:
        parts = [f"train_all={self.train_all}"]
        if self.train_correct:
            parts.append(f"accuracy={100.0 * self.accuracy:.2f}%")
        for k in ("cce_loss", "sparse_cce_loss", "mse_loss"):
            v = getattr(self, k)
            if v:
                parts.append(f"{k}={v / max(1, self.train_all):.4f}")
        return " ".join(parts)


def _log_probs(output):
    return torch.log(output.float().clamp(1e-30, 1.0))


def compute_step_metrics(metrics: List[MetricsType], output, label,
                         loss_type: LossType) -> Dict[str, torch.Tensor]:
    """Per-batch metric values (summed over the batch, to be accumulated),
    as device scalars: the caller reads them when it reads the loss."""
    out: Dict[str, torch.Tensor] = {}
    sparse = label.dim() < output.dim() or label.shape[-1] == 1
    for m in metrics:
        if m == MetricsType.METRICS_ACCURACY:
            pred = output.argmax(dim=-1)
            if sparse:
                lbl = label.reshape(label.shape[0], -1)[:, 0].long()
            else:
                lbl = label.argmax(dim=-1)
            out["accuracy_correct"] = (pred == lbl).sum()
        elif m == MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY:
            lbl = label.reshape(label.shape[0], -1)[:, 0].long()
            out["sparse_cce_loss"] = -_log_probs(output).gather(
                -1, lbl[:, None]).sum()
        elif m == MetricsType.METRICS_CATEGORICAL_CROSSENTROPY:
            out["cce_loss"] = -(label.float() * _log_probs(output)).sum()
        elif m == MetricsType.METRICS_MEAN_SQUARED_ERROR:
            d = output.float() - label.float()
            out["mse_loss"] = d.square().mean(dim=-1).sum()
        elif m == MetricsType.METRICS_ROOT_MEAN_SQUARED_ERROR:
            d = output.float() - label.float()
            out["rmse_loss"] = d.square().mean(dim=-1).sqrt().sum()
        elif m == MetricsType.METRICS_MEAN_ABSOLUTE_ERROR:
            d = output.float() - label.float()
            out["mae_loss"] = d.abs().mean(dim=-1).sum()
    return out
