"""Data loading (counterpart of ``flexflow_tpu/training/dataloader.py``):
the dataset stays in host memory; each batch is copied to the model's
device. ``minibatches`` shuffles with numpy's ``default_rng(seed)``, as
the JAX package does, so one seed gives both packages one order."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class SingleDataLoader:
    def __init__(self, ffmodel, input_tensor, full_array: np.ndarray,
                 num_samples: Optional[int] = None, data_type=None):
        self.ffmodel = ffmodel
        self.input_tensor = input_tensor
        self.data = np.asarray(full_array)
        self.num_samples = num_samples or self.data.shape[0]
        self.batch_size = ffmodel.config.batch_size
        self.idx = 0

    @property
    def num_batches(self) -> int:
        return self.num_samples // self.batch_size

    def reset(self):
        self.idx = 0

    def state_dict(self):
        return {"idx": self.idx}

    def load_state_dict(self, state):
        self.idx = int(state.get("idx", 0))

    def next_batch(self, ffmodel=None) -> torch.Tensor:
        """The next batch as a tensor on the model's device, in the input
        tensor's dtype; wraps to the first batch after the last."""
        model = ffmodel or self.ffmodel
        lo = self.idx * self.batch_size
        hi = lo + self.batch_size
        if hi > self.num_samples:
            self.reset()
            lo, hi = 0, self.batch_size
        self.idx += 1
        return torch.as_tensor(self.data[lo:hi]).to(
            device=model.device, dtype=self.input_tensor.dtype.to_torch())


def minibatches(arrays, batch_size: int, *, shuffle: bool = False,
                seed: int = 0):
    """Yield tuples of aligned minibatches, dropping the ragged tail."""
    n = arrays[0].shape[0]
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    for i in range(n // batch_size):
        sel = order[i * batch_size:(i + 1) * batch_size]
        yield tuple(a[sel] for a in arrays)
