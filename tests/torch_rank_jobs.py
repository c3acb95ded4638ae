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
* ``ring_grad``: the ring's q/k/v gradients of ``sum(out ** 2)``;
* ``cli``: the serve CLI's ``main`` on every rank;
* ``dead_peer``: a rank that dies before a collective (the launcher's
  failure path);
* ``branch_ops``: ``branch_parallel_apply`` and
  ``branch_data_parallel_apply`` against the branches applied in turn,
  outputs and gradients.

Serving itself runs ``flexflow_tpu_torch.parallel.rank_jobs:serve`` and
training ``...:train``, with the model builders below (``mlp``,
``bert``, ``experts_net``, ``moe_net``, ``cnn_bn``): each takes the
package (``ff``: either ``flexflow_tpu`` or ``flexflow_tpu_torch``) and
an ``FFConfig`` and returns the uncompiled model, so one builder makes
the JAX model and the port's alike.
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


def ring_grad(payload) -> Dict[str, Any]:
    """The gradients of ``sum(ring_attention(q, k, v) ** 2)`` (causal)
    with respect to this rank's slices of whole q/k/v from the ``.npz``;
    rank 0 writes the gathered ``dq``/``dk``/``dv`` to ``payload["out"]``."""
    from flexflow_tpu_torch.parallel.collectives import all_gather
    from flexflow_tpu_torch.parallel.ring_attention import ring_attention

    mesh = _mesh(payload)
    data = np.load(payload["inputs"])
    n, i = mesh.axis_size("seq"), mesh.index("seq")
    sl = data["q"].shape[1] // n
    q, k, v = (torch.from_numpy(data[a][:, i * sl:(i + 1) * sl].copy())
               .requires_grad_(True) for a in "qkv")
    (ring_attention(q, k, v, mesh, causal=True) ** 2).sum().backward()
    outs = {f"d{a}": all_gather(t.grad, mesh, "seq", axis=1).numpy()
            for a, t in zip("qkv", (q, k, v))}
    if mesh.rank == 0:
        np.savez(payload["out"], **outs)
    return {"rank": mesh.rank}


def branch_ops(payload) -> Dict[str, Any]:
    """The branch executors over ``data`` on rank-independent inputs: the
    largest absolute difference of the outputs, of ``x``'s gradient and
    of the parameters' gradients (summed over the axis, as the train
    step's reduction sums them) from the branches applied in turn."""
    from flexflow_tpu_torch.parallel.collectives import psum
    from flexflow_tpu_torch.parallel.ops import (branch_data_parallel_apply,
                                                 branch_parallel_apply)

    mesh = _mesh(payload)
    g = torch.Generator().manual_seed(0)
    x0 = torch.randn(8, 3, 4, 4, generator=g)
    outs_c = (2, 3, 1, 2)
    ws = [torch.randn(c, 3, generator=g) for c in outs_c]
    rs = [torch.randn(8, c, 4, 4, generator=g) for c in outs_c]

    def f(i):
        return lambda x, p=None: torch.einsum(
            "bchw,oc->bohw", x, (p or {"w": ws_[i]})["w"])

    errs: Dict[str, float] = {}
    for label, nb, allocs in (("data_nb2", 2, None), ("data_nb4", 4, None),
                              ("switch_nb4", 4, None),
                              ("switch_1_3", 2, [1, 3])):
        ws_ = [w.clone().requires_grad_(True) for w in ws[:nb]]
        x = x0.clone().requires_grad_(True)
        if label.startswith("data"):
            outs = branch_data_parallel_apply(
                mesh, "data", [f(i) for i in range(nb)],
                [{"w": w} for w in ws_], list(outs_c[:nb]), x)
        else:
            outs = branch_parallel_apply(
                mesh, "data", [f(i) for i in range(nb)], list(outs_c[:nb]),
                x, allocs=allocs)
        sum((o * r).sum() for o, r in zip(outs, rs)).backward()
        got = [o.detach() for o in outs]
        gx = x.grad.clone()
        # a rank that ran another branch made no gradient for this one
        gw = [psum(w.grad if w.grad is not None else torch.zeros_like(w),
                   mesh, "data") for w in ws_]
        wr = [w.clone().requires_grad_(True) for w in ws[:nb]]
        xr = x0.clone().requires_grad_(True)
        ref = [torch.einsum("bchw,oc->bohw", xr, w) for w in wr]
        sum((o * r).sum() for o, r in zip(ref, rs)).backward()
        errs[label] = max(
            max(float((a - b.detach()).abs().max()) for a, b in zip(got, ref)),
            float((gx - xr.grad).abs().max()),
            max(float((a - b.grad).abs().max()) for a, b in zip(gw, wr)))
    return {"rank": mesh.rank, "errs": errs}


# ----------------------------------------------------------------------
# model builders for the training jobs (ff: either package)
# ----------------------------------------------------------------------
def mlp(ff, config, d_in=32, hidden=64, classes=10):
    """``tests/test_sharding.py``'s MLP, with an L2 regularizer."""
    m = ff.FFModel(config)
    t = m.create_tensor([config.batch_size, d_in], ff.DataType.DT_FLOAT)
    h = m.dense(t, hidden, ff.ActiMode.AC_MODE_RELU,
                kernel_regularizer=("l2", 1e-3))
    h = m.dense(h, hidden, ff.ActiMode.AC_MODE_RELU)
    m.softmax(m.dense(h, classes))
    return m


def bert(ff, config, seq=8, hidden=32, heads=4, vocab=50, layers=2,
         dropout=0.0):
    """bench_train.py's encoder at a tiny width; ``dropout`` adds a
    dropout layer after the embedding and probability dropout in every
    attention."""
    b = config.batch_size
    m = ff.FFModel(config)
    tokens = m.create_tensor([b, seq], ff.DataType.DT_INT32)
    x = m.embedding(tokens, vocab, hidden, name="embed")
    if dropout:
        x = m.dropout(x, dropout, name="embed_drop")
    for i in range(layers):
        attn = m.multihead_attention(x, x, x, embed_dim=hidden,
                                     num_heads=heads, dropout=dropout,
                                     name=f"enc.{i}.attn")
        x = m.layer_norm(m.add(attn, x), axes=[-1], name=f"enc.{i}.ln1")
        h = m.dense(x, 4 * hidden, ff.ActiMode.AC_MODE_GELU,
                    name=f"enc.{i}.fc1")
        h = m.dense(h, hidden, name=f"enc.{i}.fc2")
        x = m.layer_norm(m.add(h, x), axes=[-1], name=f"enc.{i}.ln2")
    logits = m.dense(x, vocab, name="mlm_head")
    m.softmax(m.reshape(logits, [b * seq, vocab]))
    return m


def experts_net(ff, config, d=16, n=4, k=2, classes=5):
    """A softmax gate's top-k into one EXPERTS layer (bias, ReLU)."""
    m = ff.FFModel(config)
    t = m.create_tensor([config.batch_size, d], ff.DataType.DT_FLOAT)
    x = m.dense(t, d, ff.ActiMode.AC_MODE_RELU)
    vals, idx = m.top_k(m.softmax(m.dense(x, n)), k)
    y = m.experts(x, idx, vals, n, 0, d, activation=ff.ActiMode.AC_MODE_RELU,
                  use_bias=True)
    m.softmax(m.dense(m.add(y, x), classes))
    return m


def moe_net(ff, config, d=64, n=4, k=2, hidden=64, classes=10):
    """``examples/python/native/moe.py``'s classifier (the ``moe``
    composite: GROUP_BY, two denses a bucket, AGGREGATE)."""
    m = ff.FFModel(config)
    t = m.create_tensor([config.batch_size, d], ff.DataType.DT_FLOAT)
    x = m.dense(t, d, ff.ActiMode.AC_MODE_RELU)
    x = m.moe(x, num_exp=n, num_select=k, expert_hidden_size=hidden)
    m.softmax(m.dense(x, classes))
    return m


def cnn_bn(ff, config, img=8, classes=4):
    """Two convolutions with BatchNorm, an average pool and a head."""
    m = ff.FFModel(config)
    t = m.create_tensor([config.batch_size, 3, img, img],
                        ff.DataType.DT_FLOAT)
    x = m.batch_norm(m.conv2d(t, 8, 3, 3, 1, 1, 1, 1, use_bias=False))
    x = m.batch_norm(m.conv2d(x, 8, 3, 3, 2, 2, 1, 1, use_bias=False),
                     relu=False)
    x = m.pool2d(x, x.dims[2], x.dims[3], 1, 1, 0, 0, ff.PoolType.POOL_AVG)
    m.softmax(m.dense(m.flat(x), classes))
    return m


def inception(ff, config):
    """``tests/test_measured_ab.py``'s four-branch inception block (a
    stem conv, four conv branches joined by a channel concat, a dense
    head)."""
    m = ff.FFModel(config)
    t = m.create_tensor([config.batch_size, 32, 8, 8], ff.DataType.DT_FLOAT)
    x = m.conv2d(t, 32, 3, 3, 1, 1, 1, 1, ff.ActiMode.AC_MODE_RELU)
    b1 = m.conv2d(x, 16, 1, 1, 1, 1, 0, 0, ff.ActiMode.AC_MODE_RELU)
    b2 = m.conv2d(m.conv2d(x, 24, 1, 1, 1, 1, 0, 0), 32, 3, 3, 1, 1,
                  1, 1, ff.ActiMode.AC_MODE_RELU)
    b3 = m.conv2d(m.conv2d(x, 8, 1, 1, 1, 1, 0, 0), 16, 5, 5, 1, 1,
                  2, 2, ff.ActiMode.AC_MODE_RELU)
    b4 = m.conv2d(x, 16, 1, 1, 1, 1, 0, 0, ff.ActiMode.AC_MODE_RELU)
    m.softmax(m.dense(m.flat(m.concat([b1, b2, b3, b4], axis=1)), 10))
    return m
