"""Batch descriptors for serving steps (counterpart of
``flexflow_tpu/serve/batch_config.py``).

The batch is request-slot major, as in the JAX package: ``tokens[R, Q]``
where ``Q`` is the step's token width (1 or the decode width for
decoding, the prefill chunk for prompt processing). Inactive slots and
padding positions are masked, never branched on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class GenerationConfig:
    """Sampling configuration. The slice serves greedy decoding (the
    default); ``do_sample`` and its temperature/top-p arrive with the
    Sampling op."""

    do_sample: bool = False


_FIELD_DTYPES = {"tokens": torch.int32, "positions": torch.int32,
                 "start_pos": torch.int32, "num_tokens": torch.int32,
                 "active": torch.bool}


@dataclasses.dataclass
class BatchMeta:
    """Per-step metadata.

    tokens:    int32[R, Q]  token ids to run this step
    positions: int32[R, Q]  absolute sequence position of each token
    start_pos: int32[R]     KV-cache depth of each slot before this step
    num_tokens:int32[R]     how many of the Q tokens are real (rest padding)
    active:    bool[R]      slot currently holds a request

    Fields may be numpy arrays (built on the host) or tensors; ``to``
    returns a copy whose fields are tensors on one device.
    """

    tokens: object
    positions: object
    start_pos: object
    num_tokens: object
    active: object

    def to(self, device) -> "BatchMeta":
        return BatchMeta(**{
            name: torch.as_tensor(getattr(self, name), dtype=dt,
                                  device=device)
            for name, dt in _FIELD_DTYPES.items()})


def make_batch_meta(max_requests: int, q_width: int,
                    tokens: Optional[np.ndarray] = None,
                    positions: Optional[np.ndarray] = None,
                    start_pos: Optional[np.ndarray] = None,
                    num_tokens: Optional[np.ndarray] = None,
                    active: Optional[np.ndarray] = None,
                    device="cpu") -> BatchMeta:
    """Host-side constructor with zero-filled defaults, moved to
    ``device``."""
    R, Q = max_requests, q_width

    def z(shape, dt):
        return np.zeros(shape, dtype=dt)

    return BatchMeta(
        tokens=tokens if tokens is not None else z((R, Q), np.int32),
        positions=positions if positions is not None else z((R, Q), np.int32),
        start_pos=start_pos if start_pos is not None else z((R,), np.int32),
        num_tokens=(num_tokens if num_tokens is not None
                    else z((R,), np.int32)),
        active=active if active is not None else z((R,), bool),
    ).to(device)
