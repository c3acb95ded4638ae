"""Pipeline parallelism: the GPipe schedule over the ``pipe`` mesh axis
(counterpart of ``flexflow_tpu/parallel/pipeline.py``).

The L homogeneous blocks' weights are stacked on a leading layer dim and
each stage keeps its L/P contiguous blocks (``stack_stage_params``,
``shard_stacked_params``). The batch splits into M microbatches that
stream through the P stages on the classic M + P - 1 tick schedule: at
tick t stage s applies its blocks to microbatch t - s and hands the
activation to stage s + 1 by a point-to-point send (the JAX package's
``ppermute`` over ICI); the last stage's outputs are then broadcast to
every stage. ``gpipe`` is the schedule itself, shared with the serving
pipeline (``serve/pipeline_plan.run_pp_graph``), which also carries each
microbatch's KV-cache rows.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from flexflow_tpu_torch.parallel.collectives import (broadcast, recv_tensor,
                                                     send_tensor)
from flexflow_tpu_torch.quant import QuantizedWeight, is_quantized


def stack_stage_params(per_layer_params: List[Dict[str, Any]]
                       ) -> Dict[str, Any]:
    """Stack a list of alike per-block ``{name: leaf}`` dicts on a new
    leading layer dim. A quantized leaf stacks its payload and its scale
    (rows, dtype and qtype stay the block's)."""
    out: Dict[str, Any] = {}
    for name in per_layer_params[0]:
        leaves = [lp[name] for lp in per_layer_params]
        if is_quantized(leaves[0]):
            t = leaves[0]
            out[name] = QuantizedWeight(
                t.qtype, torch.stack([l.q for l in leaves]),
                torch.stack([l.scale for l in leaves]), t.rows, t.dtype)
        else:
            out[name] = torch.stack(leaves)
    return out


def _rows(leaf, lo, hi):
    if is_quantized(leaf):
        return QuantizedWeight(leaf.qtype, leaf.q[lo:hi].clone(),
                               leaf.scale[lo:hi].clone(), leaf.rows,
                               leaf.dtype)
    return leaf[lo:hi].clone()


def shard_stacked_params(params: Dict[str, Any], mesh,
                         axis: str = "pipe") -> Dict[str, Any]:
    """This stage's L/P contiguous layers of stacked params [L, ...]."""
    n = mesh.axis_size(axis)
    s = mesh.index(axis)
    out = {}
    for name, leaf in params.items():
        L = (leaf.q if is_quantized(leaf) else leaf).shape[0]
        if L % n:
            raise ValueError(f"{name}: {L} layers do not split over {n} "
                             "stages")
        out[name] = _rows(leaf, s * (L // n), (s + 1) * (L // n))
    return out


def block_slice(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of stacked params (views, no copy)."""
    out = {}
    for name, leaf in stacked.items():
        if is_quantized(leaf):
            out[name] = QuantizedWeight(leaf.qtype, leaf.q[i], leaf.scale[i],
                                        leaf.rows, leaf.dtype)
        else:
            out[name] = leaf[i]
    return out


def gpipe(mesh, num_microbatches: int, ingest: Callable[[int], Any],
          apply: Callable[[int, Any], Any], emit: Callable[[int, Any], None],
          device, axis: str = "pipe"):
    """Run the M + P - 1 tick schedule on this stage.

    ``ingest(mb)`` gives stage 0 microbatch mb; ``apply(mb, x)`` runs this
    stage's blocks; the last stage calls ``emit(mb, y)``. Between stages
    the activation travels by send/recv; a stage's receive waits for its
    predecessor's send of the same tick, and no stage sends backwards, so
    the chain never waits in a cycle."""
    P = mesh.axis_size(axis)
    s = mesh.index(axis)
    M = num_microbatches
    for t in range(M + P - 1):
        mb = t - s
        if not 0 <= mb < M:
            continue                      # this stage idles this tick
        if s == 0:
            x = ingest(mb)
        else:
            x = recv_tensor(mesh.rank_at(**{axis: s - 1}), device)
        y = apply(mb, x)
        if s < P - 1:
            send_tensor(y, mesh.rank_at(**{axis: s + 1}))
        else:
            emit(mb, y)


def pipeline_spmd(block_fn: Callable, mesh, num_microbatches: int,
                  axis: str = "pipe"):
    """A pipelined forward ``fn(local_params, x) -> y``.

    block_fn(params_i, x) -> x   one block on one microbatch
    local_params                 this stage's stacked leaves [L/P, ...]
    x                            [B, ...], the same on every stage;
                                 B % num_microbatches == 0

    Stage s processes microbatch t - s at tick t; the result, assembled
    on the last stage, is broadcast to every stage over the ``axis``
    group."""
    M = num_microbatches

    def fn(local_params, x):
        P = mesh.axis_size(axis)
        B = x.shape[0]
        if B % M:
            raise ValueError(f"batch {B} does not split into {M} "
                             "microbatches")
        mb = B // M
        first = next(iter(local_params.values()))
        L = (first.q if is_quantized(first) else first).shape[0]
        outs: List[Any] = [None] * M

        def apply(i, v):
            for layer in range(L):
                v = block_fn(block_slice(local_params, layer), v)
            return v

        def emit(i, y):
            outs[i] = y

        gpipe(mesh, M, lambda i: x[i * mb:(i + 1) * mb], apply, emit,
              x.device, axis)
        y = torch.cat(outs) if mesh.index(axis) == P - 1 else None
        if P == 1:
            return y
        last = mesh.rank_at(**{axis: P - 1})
        return broadcast(y, last, mesh.group(axis), device=x.device)

    return fn
