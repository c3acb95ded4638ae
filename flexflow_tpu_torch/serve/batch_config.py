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
    changes.

    ``timeout_s`` is the default per-request wall-clock bound (0 = none)
    that ``LLM.generate`` applies when a call gives none (in the JAX
    package only its embedded C host applies it). ``prefix_cache`` arms the
    shared-prefix KV pool (serve/prefix_cache.py): admission-time
    longest-prefix match, grant-time KV install (those prefill tokens
    skipped), insert-on-finish; token-identical to the pool off.
    ``prefix_cache_tokens`` is its budget in tokens (0 = the default); the
    pool also holds a byte budget of its own (serve/prefix_cache.py)."""

    do_sample: bool = False
    temperature: float = 0.8
    topp: float = 0.6
    adaptive_spec: bool = True
    timeout_s: float = 0.0
    spec_depth: int = 0             # 0 = caller's depth / engine max
    min_spec_depth: int = 1
    spec_fallback_margin: float = 0.95   # park below this est. speedup
    spec_recover_margin: float = 1.05    # un-park above this (hysteresis)
    spec_probe_every: int = 4            # fallback blocks between probes
    spec_ewma_alpha: float = 0.4
    spec_draft_cost_ratio: float = 0.0   # 0 = estimate from param bytes
    prefix_cache: bool = False
    prefix_cache_tokens: int = 0


# Reference include/flexflow/batch_config.h:57-58 and :125-126 (the JAX
# package's constants; the port's shapes come from FFConfig)
MAX_NUM_REQUESTS = 64
MAX_NUM_TOKENS = 1024
MAX_BEAM_WIDTH = 1
MAX_BEAM_DEPTH = 8
# Reference request_manager.cc:1829 (depth-4 in-flight batch pipeline)
DEFAULT_PIPELINE_DEPTH = 4

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

    @property
    def q_width(self) -> int:
        return self.tokens.shape[1]

    @property
    def max_requests(self) -> int:
        return self.tokens.shape[0]


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

    @property
    def q_width(self) -> int:
        return self.tokens.shape[1]

    @property
    def max_requests(self) -> int:
        return self.tokens.shape[0]


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


# ----------------------------------------------------------------------
# A step program's meta: static device tensors (serve/inference_manager)
# ----------------------------------------------------------------------
def _step_fields(tree: bool, R: int, Q: int):
    """(state entry, meta field, dtype, shape) of a step's meta, the int32
    fields first: the block state of ``InferenceManager.step``'s programs
    names the token counts ``num`` and keeps ``active``, the entries a
    program's warm-up clears (``graphs.INACTIVE``)."""
    fields = [("tokens", "tokens", torch.int32, (R, Q)),
              ("positions", "positions", torch.int32, (R, Q)),
              ("start_pos", "start_pos", torch.int32, (R,))]
    if tree:
        fields += [("parent", "parent", torch.int32, (R, Q)),
                   ("num", "num_nodes", torch.int32, (R,)),
                   ("ancestor", "ancestor", torch.bool, (R, Q, Q))]
    else:
        fields.append(("num", "num_tokens", torch.int32, (R,)))
    fields.append(("active", "active", torch.bool, (R,)))
    return fields


def _field_bytes(dt, shape) -> int:
    return int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()


def step_state(tree: bool, R: int, Q: int, device) -> dict:
    """A step program's meta as device tensors: views of one byte buffer
    ``meta``, which ``load_step_meta`` fills with one copy a step."""
    fields = _step_fields(tree, R, Q)
    flat = torch.zeros(sum(_field_bytes(dt, sh) for _n, _f, dt, sh in fields),
                       dtype=torch.uint8, device=device)
    st, o = {"meta": flat}, 0
    for name, _f, dt, shape in fields:
        n = _field_bytes(dt, shape)
        st[name] = flat[o:o + n].view(dt).view(shape)
        o += n
    return st


def load_step_meta(st: dict, meta) -> None:
    """Copy ``meta`` (numpy arrays or tensors) into a step program's state:
    the host's fields packed into one buffer and copied with one
    asynchronous copy (pinned on the card), a device field copied on the
    device."""
    tree = hasattr(meta, "ancestor")
    R, Q = st["tokens"].shape
    buf = np.zeros(st["meta"].shape[0], np.uint8)
    on_device, o = [], 0
    for name, field, dt, shape in _step_fields(tree, R, Q):
        n = _field_bytes(dt, shape)
        v = getattr(meta, field)
        if isinstance(v, torch.Tensor) and v.device.type != "cpu":
            on_device.append((name, v))
        else:
            if isinstance(v, torch.Tensor):
                v = v.numpy()
            nd = np.bool_ if dt == torch.bool else np.int32
            buf[o:o + n].view(nd)[:] = np.asarray(v, nd).reshape(-1)
        o += n
    host = torch.from_numpy(buf)
    if st["meta"].is_cuda:
        st["meta"].copy_(host.pin_memory(), non_blocking=True)
    else:
        st["meta"].copy_(host)
    for name, v in on_device:
        st[name].copy_(v)


def step_meta(st: dict, tree: bool):
    """The BatchMeta (or TreeBatchMeta) over a step program's state."""
    R, Q = st["tokens"].shape
    return (TreeBatchMeta if tree else BatchMeta)(
        **{field: st[name] for name, field, _dt, _sh
           in _step_fields(tree, R, Q)})
