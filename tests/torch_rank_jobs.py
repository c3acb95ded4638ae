"""Jobs that the port's tests and ``chip_smoke.py`` run on the ranks of
``flexflow_tpu_torch.parallel.launch.run_ranks`` (target
``"tests/torch_rank_jobs.py:<job>"``): each function runs on every rank
of a process group and returns a JSON-able result. They import no jax.

* ``collectives``: every collective of ``parallel/collectives.py`` and
  the parallel-op nodes on rank-dependent inputs (the caller checks them
  against numpy);
* ``seq_attend``: ``seq_sharded_attend`` on inputs read from an ``.npz``
  (whole caches; each rank takes its rows), outputs written by rank 0;
* ``pipeline``: ``pipeline_spmd`` against the blocks applied in turn;
* ``ring``: ``ring_attention`` on each rank's sequence slice;
* ``cli``: the serve CLI's ``main`` on every rank;
* ``dead_peer``: a rank that dies before a collective (the launcher's
  failure path).

Serving itself runs ``flexflow_tpu_torch.parallel.rank_jobs:serve``.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch


def _mesh(payload):
    from flexflow_tpu_torch.config import FFConfig
    from flexflow_tpu_torch.parallel.mesh import make_mesh

    cfg = FFConfig(device=payload.get("device", "cpu"),
                   **payload.get("degrees", {}))
    return make_mesh(cfg)


def _dev(payload):
    d = payload.get("device", "cpu")
    if d.startswith("cuda"):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(d)


def collectives(payload) -> Dict[str, Any]:
    """x = rank * 10 + arange(4 * n) as float32 (n = the axis size)."""
    from flexflow_tpu_torch.parallel import collectives as C

    mesh = _mesh(payload)
    axis = payload["axis"]
    dev = _dev(payload)
    n = mesh.axis_size(axis)
    i = mesh.index(axis)
    x = (mesh.rank * 10 + torch.arange(4 * n, dtype=torch.float32)).to(dev)
    x2 = x.reshape(n, 4)
    out = {
        "rank": mesh.rank, "index": i, "n": n,
        "psum": C.psum(x, mesh, axis),
        "pmax": C.pmax(x, mesh, axis),
        "pmean": C.pmean(x, mesh, axis),
        "all_gather": C.all_gather(x2, mesh, axis, axis=1),
        "all_gather_stacked": C.all_gather(x, mesh, axis, tiled=False),
        "reduce_scatter": C.reduce_scatter(x, mesh, axis),
        "ppermute": C.ppermute_shift(x, mesh, axis, shift=1),
        "all_to_all": C.all_to_all(x2, mesh, axis, split_axis=0,
                                   concat_axis=1),
        "broadcast": C.broadcast(x if mesh.rank == 0 else None, 0,
                                 device=dev),
    }
    out.update(_parallel_ops(x, mesh, axis))
    if n > 1:
        nxt = mesh.rank_at(**{axis: (i + 1) % n})
        prv = mesh.rank_at(**{axis: (i - 1) % n})
        if i % 2 == 0:
            C.send_tensor(x, nxt)
            got = C.recv_tensor(prv, dev)
        else:
            got = C.recv_tensor(prv, dev)
            C.send_tensor(x, nxt)
        out["send_recv"] = got
    return {k: (v.cpu().tolist() if torch.is_tensor(v) else v)
            for k, v in out.items()}


def _parallel_ops(x, mesh, axis) -> Dict[str, Any]:
    """The parallel-op nodes (``parallel/ops.py``) on ``x`` over ``axis``."""
    from flexflow_tpu_torch.ffconst import OpType
    from flexflow_tpu_torch.ops.base import OpContext, get_op_impl

    ctx = OpContext(mesh=mesh)
    out = {}
    for name, op, attrs in [
            ("repartition", OpType.REPARTITION,
             dict(repartition_dim=0, axis_name=axis)),
            ("reduction", OpType.REDUCTION,
             dict(reduction_dim=0, axis_name=axis)),
            ("allreduce", OpType.ALLREDUCE,
             dict(op_type=OpType.ALLREDUCE, axis_name=axis)),
            ("replicate", OpType.REPLICATE,
             dict(op_type=OpType.REPLICATE))]:
        out["op_" + name] = get_op_impl(op).forward(attrs, {}, [x], ctx)[0]
    part = out["op_repartition"]
    out["op_combine"] = get_op_impl(OpType.COMBINE).forward(
        dict(combine_dim=0, axis_name=axis), {}, [part], ctx)[0]
    return out


def dead_peer(payload) -> Dict[str, Any]:
    """Rank 1 dies before the collective that rank 0 waits in."""
    import os

    import torch.distributed as dist

    if dist.get_rank() == 1:
        os._exit(3)
    t = torch.ones(4)
    dist.all_reduce(t)
    return {"rank": 0}


def ring(payload) -> Dict[str, Any]:
    """``ring_attention`` on this rank's sequence slice of whole q/k/v
    [b, s, h, d] (``.npz``), causal and not; the slices are gathered and
    rank 0 writes ``causal0``/``causal1`` to ``payload["out"]``."""
    from flexflow_tpu_torch.parallel.collectives import all_gather
    from flexflow_tpu_torch.parallel.ring_attention import ring_attention

    mesh = _mesh(payload)
    dev = _dev(payload)
    data = np.load(payload["inputs"])
    n, i = mesh.axis_size("seq"), mesh.index("seq")
    q, k, v = (torch.from_numpy(data[a]).to(dev) for a in "qkv")
    sl = q.shape[1] // n
    outs = {}
    for causal in (False, True):
        part = ring_attention(*(t[:, i * sl:(i + 1) * sl] for t in (q, k, v)),
                              mesh, causal=causal)
        outs[f"causal{int(causal)}"] = all_gather(
            part, mesh, "seq", axis=1).cpu().numpy()
    if mesh.rank == 0:
        np.savez(payload["out"], **outs)
    return {"rank": mesh.rank}


def cli(payload) -> Dict[str, Any]:
    """``python -m flexflow_tpu_torch.serve`` with ``payload["argv"]`` on
    this rank; returns what it printed."""
    import contextlib
    import io

    from flexflow_tpu_torch.serve.__main__ import main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(payload["argv"])
    return {"rc": rc, "stdout": out.getvalue()}


def seq_attend(payload) -> Dict[str, Any]:
    """Each case of the ``.npz`` (q, k, v, lengths, qpos and optional
    bias/alibi, whole) through ``seq_sharded_attend`` on this rank's
    rows; rank 0 writes ``out_<case>`` arrays to ``payload["out"]``."""
    from flexflow_tpu_torch.parallel.ring_attention import \
        seq_sharded_attend

    mesh = _mesh(payload)
    dev = _dev(payload)
    data = np.load(payload["inputs"])
    deg = mesh.axis_size("seq")
    i = mesh.index("seq")
    outs = {}
    for case in payload["cases"]:
        name, causal = case["name"], case["causal"]

        def arr(key):
            k = f"{name}_{key}"
            return torch.from_numpy(data[k]).to(dev) if k in data else None

        k, v, bias = arr("k"), arr("v"), arr("bias")
        S = k.shape[2]
        if S % deg == 0:
            SL = S // deg
            k, v = k[:, :, i * SL:(i + 1) * SL], v[:, :, i * SL:(i + 1) * SL]
            if bias is not None:
                bias = bias[..., i * SL:(i + 1) * SL]
        out = seq_sharded_attend(arr("q"), k, v, arr("lengths"), arr("qpos"),
                                 mesh, bias=bias, alibi=arr("alibi"),
                                 seq_len=S, causal=causal,
                                 qk_scale=case.get("scale"))
        outs[f"out_{name}"] = out.cpu().numpy()
    if mesh.rank == 0:
        np.savez(payload["out"], **outs)
    return {"rank": mesh.rank}


def pipeline(payload) -> Dict[str, Any]:
    """``pipeline_spmd`` over L tanh-affine blocks against the blocks
    applied in turn; returns the largest difference."""
    from flexflow_tpu_torch.parallel.pipeline import (pipeline_spmd,
                                                      shard_stacked_params)

    mesh = _mesh(payload)
    dev = _dev(payload)
    g = torch.Generator().manual_seed(0)
    L, E, B = payload["layers"], payload["width"], payload["batch"]
    w = torch.randn(L, E, E, generator=g) / math.sqrt(E)
    b = torch.randn(L, E, generator=g)
    x = torch.randn(B, E, generator=g)
    ref = x
    for layer in range(L):
        ref = torch.tanh(ref @ w[layer] + b[layer])
    local = shard_stacked_params({"w": w.to(dev), "b": b.to(dev)}, mesh)
    fn = pipeline_spmd(lambda p, v: torch.tanh(v @ p["w"] + p["b"]), mesh,
                       payload["microbatches"])
    y = fn(local, x.to(dev))
    return {"rank": mesh.rank,
            "max_err": float((y.cpu() - ref).abs().max())}
