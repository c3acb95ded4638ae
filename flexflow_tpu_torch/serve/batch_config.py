"""Batch descriptors for serving steps (counterpart of
``flexflow_tpu/serve/batch_config.py``).

The batch is request-slot major, as in the JAX package: ``tokens[R, Q]``
where ``Q`` is the step's token width (1 or the decode width for
decoding, the prefill chunk for prompt processing, the padded tree width
for verification). Inactive slots and padding positions are masked,
never branched on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class GenerationConfig:
    """Sampling and speculation policy. Greedy by default; ``do_sample``
    makes an incremental-decoding graph end in top-p Sampling at
    ``temperature`` and ``topp`` (speculation stays greedy: its verifier
    graph always ends in argmax). The ``spec_*`` knobs drive the adaptive
    speculation controller (serve/spec_controller.py), on by default: it
    tunes each request's draft depth from its observed acceptance and
    parks requests whose estimated speedup falls below incremental
    decoding. Tokens are the same either way; only the wall clock
    changes."""

    do_sample: bool = False
    temperature: float = 0.8
    topp: float = 0.6
    adaptive_spec: bool = True
    spec_depth: int = 0             # 0 = caller's depth / engine max
    min_spec_depth: int = 1
    spec_fallback_margin: float = 0.95   # park below this est. speedup
    spec_recover_margin: float = 1.05    # un-park above this (hysteresis)
    spec_probe_every: int = 4            # fallback blocks between probes
    spec_ewma_alpha: float = 0.4
    spec_draft_cost_ratio: float = 0.0   # 0 = estimate from param bytes


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
        return BatchMeta(**_fields_to(self, _FIELD_DTYPES, device))


_TREE_FIELD_DTYPES = {"tokens": torch.int32, "positions": torch.int32,
                      "parent": torch.int32, "ancestor": torch.bool,
                      "start_pos": torch.int32, "num_nodes": torch.int32,
                      "active": torch.bool}


@dataclasses.dataclass
class TreeBatchMeta:
    """Verification-step metadata (reference TreeVerifyBatchConfig).

    Queries are the nodes of a token tree, flattened per request slot.
    Node 0 is the root (the last committed token, re-fed for its logits);
    node i's parent is ``parent[r, i] < i``. Node i attends to the
    committed prefix plus its own ancestor chain.

    tokens:    int32[R, T]    tree node token ids
    positions: int32[R, T]    absolute position = start_pos + depth in tree
    parent:    int32[R, T]    parent node index within the tree (root: -1)
    ancestor:  bool[R, T, T]  ancestor[r, i, j]: node j is an ancestor of
                              node i, or j == i
    start_pos: int32[R]       committed KV depth before this step
    num_nodes: int32[R]       real tree nodes (the rest is padding)
    active:    bool[R]

    Node j's KV is staged at cache position ``start_pos + j``. Fields may
    be numpy arrays or tensors; ``to`` returns tensors on one device.
    """

    tokens: object
    positions: object
    parent: object
    ancestor: object
    start_pos: object
    num_nodes: object
    active: object

    def to(self, device) -> "TreeBatchMeta":
        return TreeBatchMeta(**_fields_to(self, _TREE_FIELD_DTYPES, device))


def _fields_to(meta, dtypes, device):
    return {name: torch.as_tensor(getattr(meta, name), dtype=dt,
                                  device=device)
            for name, dt in dtypes.items()}


def ancestor_mask_from_parents(parent: np.ndarray) -> np.ndarray:
    """[R, T] parent indices -> [R, T, T] ancestor-or-self boolean mask
    (host-side numpy; T is a speculation tree's size)."""
    R, T = parent.shape
    mask = np.zeros((R, T, T), dtype=bool)
    for r in range(R):
        for i in range(T):
            j = i
            while j >= 0:
                mask[r, i, j] = True
                j = parent[r, j]
    return mask


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
