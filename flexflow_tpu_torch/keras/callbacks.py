"""Keras callbacks (reference python/flexflow/keras/callbacks.py)."""

from __future__ import annotations


class Callback:
    def __init__(self):
        self.model = None

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_batch_begin(self, batch, logs=None):
        pass

    def on_batch_end(self, batch, logs=None):
        pass


class LearningRateScheduler(Callback):
    """Per-epoch LR schedule (reference callbacks.py:49). The new rate is
    written into the live optimizer state on the model's device."""

    def __init__(self, schedule):
        super().__init__()
        self.schedule = schedule

    def on_epoch_begin(self, epoch, logs=None):
        lr = self.schedule(epoch)
        self.model.optimizer.set_learning_rate(lr)


class VerifyMetrics(Callback):
    """Assert final metric meets a threshold (reference callbacks.py:64)."""

    def __init__(self, accuracy_threshold: float = 0.0,
                 metric: str = "accuracy"):
        super().__init__()
        self.threshold = accuracy_threshold
        self.metric = metric
        self.last = None

    def on_epoch_end(self, epoch, logs=None):
        if logs and self.metric in logs:
            self.last = logs[self.metric]

    def on_train_end(self, logs=None):
        if self.last is not None and self.last < self.threshold:
            raise AssertionError(
                f"{self.metric}={self.last:.4f} below threshold "
                f"{self.threshold:.4f}")


class EpochVerifyMetrics(Callback):
    """Assert the metric meets a threshold every epoch
    (reference callbacks.py:75)."""

    def __init__(self, accuracy_threshold: float = 0.0,
                 metric: str = "accuracy"):
        super().__init__()
        self.threshold = accuracy_threshold
        self.metric = metric

    def on_epoch_end(self, epoch, logs=None):
        if logs and self.metric in logs:
            if logs[self.metric] < self.threshold:
                raise AssertionError(
                    f"epoch {epoch}: {self.metric}={logs[self.metric]:.4f} "
                    f"below threshold {self.threshold:.4f}")
