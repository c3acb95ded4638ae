"""The port's parallel training against the JAX package's, on the CPU.

Tiny models (``tests/torch_rank_jobs.py``'s builders, built alike
through both packages) train 3 SGD steps with momentum at dp=2, tp=2,
sp=2, expert=2 and their products with dp=2, from the JAX model's
initial weights. The JAX side runs here on the conftest's 8 virtual
devices at the same degrees (``mesh_shape``); the port's ranks are
spawned gloo processes (``run_ranks`` with the ``train`` job of
``parallel/rank_jobs.py``), two launches for the module (2 and 4 ranks),
started before the JAX steps and read by many cases. Losses and the
parameters after the steps are held to ``tests/test_sharding.py:58``'s
bound, rtol 1e-5 and atol 1e-6. Models with dropout (whose draws cannot
match JAX's), and some products of degrees, are held to the port's own
one-rank run. The ring's q/k/v
gradients are held to JAX's at ``tests/test_ring_attention.py``'s
tolerance.
"""

import pathlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as jff
import flexflow_tpu_torch as tff
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.parallel import rank_jobs
from flexflow_tpu_torch.parallel.launch import load_target, run_ranks

JOB = str(pathlib.Path(__file__).with_name("torch_rank_jobs.py"))
TRAIN = "flexflow_tpu_torch.parallel.rank_jobs:train"
B, STEPS, SEED = 8, 3, 1
SGD = {"lr": 0.05, "momentum": 0.9}
TOL = dict(rtol=1e-5, atol=1e-6)

_AXIS = {"data_parallelism_degree": "data", "tensor_parallelism_degree":
         "model", "sequence_parallelism_degree": "seq",
         "expert_parallelism_degree": "expert"}
_ORDER = ("data", "expert", "seq", "model")


def _deg(**kw):
    return {f"{k}_parallelism_degree": v for k, v in kw.items()}


# name: (builder, port degrees, builder kwargs)
JAX_CASES = {
    "mlp_dp2": ("mlp", _deg(data=2), {}),
    "mlp_tp2": ("mlp", _deg(tensor=2), {}),
    "mlp_tp2dp2": ("mlp", _deg(data=2, tensor=2), {}),
    "bert_tp2": ("bert", _deg(tensor=2), {}),
    "bert_sp2": ("bert", _deg(sequence=2), {}),
    "bert_tp2dp2": ("bert", _deg(data=2, tensor=2), {}),
    "experts_ep2": ("experts_net", _deg(expert=2), {}),
    "moe_dp2": ("moe_net", _deg(data=2), {}),
    "cnn_dp2": ("cnn_bn", _deg(data=2), {}),
}
# the models with dropout (whose draws cannot match JAX's) and more
# products of degrees: against the port's own one-rank run, which
# tests/test_torch_training.py holds to JAX
PORT_CASES = {
    "bert_dp2": ("bert", _deg(data=2), {}),
    "bert_sp2dp2": ("bert", _deg(data=2, sequence=2), {}),
    "experts_ep2dp2": ("experts_net", _deg(data=2, expert=2), {}),
    "dropbert_dp2": ("bert", _deg(data=2), {"dropout": 0.1}),
    "dropbert_tp2": ("bert", _deg(tensor=2), {"dropout": 0.1}),
    "dropbert_sp2dp2": ("bert", _deg(data=2, sequence=2),
                        {"dropout": 0.1}),
}
CASES = {**JAX_CASES, **PORT_CASES}


def _world(degrees):
    return int(np.prod(list(degrees.values())))


def _data(kind, rng):
    if kind == "mlp":
        x = rng.standard_normal((STEPS, B, 32), dtype=np.float32)
        y = rng.integers(0, 10, (STEPS, B, 1))
    elif kind == "bert":
        x = rng.integers(0, 50, (STEPS, B, 8))
        y = rng.integers(0, 50, (STEPS, B * 8, 1))
    elif kind == "experts_net":
        x = rng.standard_normal((STEPS, B, 16), dtype=np.float32)
        y = rng.integers(0, 5, (STEPS, B, 1))
    elif kind == "moe_net":
        x = rng.standard_normal((STEPS, B, 64), dtype=np.float32)
        y = rng.integers(0, 10, (STEPS, B, 1))
    else:
        x = rng.standard_normal((STEPS, B, 3, 8, 8), dtype=np.float32)
        y = rng.integers(0, 4, (STEPS, B, 1))
    x = x.astype(np.int32) if x.dtype.kind == "i" else x
    return x, y.astype(np.int32)


def _jax_train(kind, kw, degrees, x, y):
    axes = [_AXIS[k] for k in degrees]
    names = tuple(a for a in _ORDER if a in axes)
    shape = tuple(degrees[k] for a in names for k in degrees
                  if _AXIS[k] == a)
    cfg = jff.FFConfig(batch_size=B, seed=SEED, mesh_shape=shape,
                       mesh_axis_names=names)
    m = load_target(f"{JOB}:{kind}")(jff, cfg, **kw)
    m.compile(optimizer=jff.SGDOptimizer(m, **SGD),
              loss_type=jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    assert dict(m.mesh.shape) == dict(zip(names, shape))
    losses = [m.train_one_batch([x[i]], y[i]) for i in range(STEPS)]
    params = {f"{ln}/{w}": np.asarray(a, np.float32)
              for ln, lp in m.params.items() for w, a in lp.items()}
    return losses, params


def _init_weights(kind, kw):
    """The JAX model's initial weights (one device), as port tensors."""
    m = load_target(f"{JOB}:{kind}")(jff, jff.FFConfig(batch_size=B,
                                                       seed=SEED), **kw)
    m.compile(optimizer=jff.SGDOptimizer(m, **SGD),
              loss_type=jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return params_from_jax({ln: {w: np.asarray(a) for w, a in lp.items()}
                            for ln, lp in m.params.items()})


def _run(name, work):
    kind, degrees, kw = CASES[name]
    return dict(name=name, builder=f"{JOB}:{kind}", builder_kw=kw,
                config=dict(batch_size=B, seed=SEED, **degrees),
                optimizer=["sgd", SGD], data=str(work / f"{kind}.npz"),
                weights=str(work / f"{kind}_{int(bool(kw))}.pt"),
                out=str(work / f"{name}.npz"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: (rank results, whole params after the steps, reference
    losses, reference params)}: the port's launches run on a thread while
    the JAX references train here."""
    work = tmp_path_factory.mktemp("ptrain")
    rng = np.random.default_rng(11)
    data = {}
    for kind in {c[0] for c in CASES.values()}:
        data[kind] = _data(kind, rng)
        np.savez(work / f"{kind}.npz", x0=data[kind][0], y=data[kind][1])
    for kind, kw in {(c[0], bool(c[2])): c[2] for c in CASES.values()
                     }.items():
        torch.save(_init_weights(kind[0], kw), work / f"{kind[0]}_"
                   f"{int(kind[1])}.pt")
    by_world = {}
    for name, (_k, degrees, _kw) in CASES.items():
        by_world.setdefault(_world(degrees), []).append(_run(name, work))
    ranks, errors = {}, []

    def launch():
        try:
            for world, rs in by_world.items():
                res = run_ranks(TRAIN, world, {"device": "cpu", "runs": rs},
                                workdir=work / f"w{world}", timeout=600)
                for i, r in enumerate(rs):
                    ranks[r["name"]] = [per[i] for per in res]
        except Exception as e:          # re-raised in the test thread
            errors.append(e)

    t = threading.Thread(target=launch)
    t.start()
    refs = {}
    for name, (kind, degrees, kw) in JAX_CASES.items():
        refs[name] = _jax_train(kind, kw, degrees, *data[kind])
    ones = {}           # one one-rank run for each model and its kwargs
    for name, (kind, degrees, kw) in PORT_CASES.items():
        key = (kind, tuple(sorted(kw.items())))
        if key not in ones:
            one = dict(_run(name, work), config=dict(batch_size=B,
                                                     seed=SEED),
                       out=str(work / f"{name}_one.npz"))
            res = rank_jobs.train({"device": "cpu", "runs": [one]})[0]
            ones[key] = (res["losses"], dict(np.load(one["out"])))
        refs[name] = ones[key]
    t.join()
    if errors:
        raise errors[0]
    return {name: (ranks[name], dict(np.load(work / f"{name}.npz")),
                   *refs[name]) for name in CASES}


@pytest.mark.parametrize("name", list(CASES))
def test_losses_match_reference(runs, name):
    """Each step's loss: the whole batch's, on rank 0, equal to JAX's at
    the same degrees (to the port's one rank for dropout models)."""
    ranks, _params, ref_losses, _ = runs[name]
    np.testing.assert_allclose(ranks[0]["losses"], ref_losses, **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_params_match_reference(runs, name):
    """The whole parameters after the steps (gathered over the mesh)."""
    _ranks, params, _l, ref = runs[name]
    assert set(params) == set(ref)
    for k in ref:
        np.testing.assert_allclose(params[k], ref[k], err_msg=k, **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_reads_the_same_losses(runs, name):
    ranks = runs[name][0]
    assert len(ranks) == _world(CASES[name][1])
    for r in ranks[1:]:
        assert r["losses"] == ranks[0]["losses"]
        assert r["mesh"] == ranks[0]["mesh"]


def test_grad_allreduce_bytes(runs):
    """dp=2 sums every gradient once a step (fp32); tp=2 and expert=2
    split no batch and sum none; sp=2 x dp=2 sums each over both."""
    n = sum(int(np.prod(a.shape)) for a in runs["mlp_dp2"][1].values())
    assert runs["mlp_dp2"][0][0]["allreduce_bytes"] == 4 * n
    assert runs["mlp_tp2"][0][0]["allreduce_bytes"] == 0
    assert runs["experts_ep2"][0][0]["allreduce_bytes"] == 0
    nb = sum(int(np.prod(a.shape)) for a in runs["bert_sp2"][1].values())
    assert runs["bert_sp2dp2"][0][0]["allreduce_bytes"] == 2 * 4 * nb


@pytest.fixture(scope="module")
def ring_grads(tmp_path_factory):
    from flexflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from flexflow_tpu.parallel.ring_attention import ring_attention

    rng = np.random.default_rng(2)
    b, s, h, kh, d = 1, 16, 4, 2, 8
    q, k, v = (rng.standard_normal((b, s, n, d), dtype=np.float32)
               for n in (h, kh, kh))
    out = {}
    for sp in (2, 4):
        work = tmp_path_factory.mktemp(f"ringgrad{sp}")
        np.savez(work / "in.npz", q=q, k=k, v=v)
        run_ranks(f"{JOB}:ring_grad", sp,
                  {"device": "cpu", "inputs": str(work / "in.npz"),
                   "out": str(work / "out.npz"),
                   "degrees": {"sequence_parallelism_degree": sp}},
                  workdir=work, timeout=120)
        jmesh = jax_make_mesh(jff.FFConfig(sequence_parallelism_degree=sp),
                              jax.devices()[:sp])
        grads = jax.jit(jax.grad(lambda *a: jnp.sum(ring_attention(
            *a, jmesh, causal=True) ** 2), argnums=(0, 1, 2)))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        out[sp] = (dict(np.load(work / "out.npz")),
                   dict(zip(("dq", "dk", "dv"), map(np.asarray, grads))))
    return out


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_gradients_match_jax(ring_grads, sp):
    port, ref = ring_grads[sp]
    for k in ("dq", "dk", "dv"):
        np.testing.assert_allclose(port[k], ref[k], rtol=2e-3, atol=2e-3,
                                   err_msg=k)


def test_mha_weight_shardings_match_jax():
    """The training MHA's weights split as the JAX package's at tp=2
    (columns of wq/wk/wv and their biases, rows of wo, bo whole)."""
    from flexflow_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from flexflow_tpu.parallel.spec import ShardingPolicy as JPolicy
    from flexflow_tpu_torch.parallel.mesh import make_mesh
    from flexflow_tpu_torch.parallel.spec import (ShardingPolicy,
                                                  layer_weight_shardings)

    deg = _deg(tensor=2)
    pm = load_target(f"{JOB}:bert")(tff, tff.FFConfig(
        batch_size=B, device="cpu", **deg))
    jm = load_target(f"{JOB}:bert")(jff, jff.FFConfig(batch_size=B, **deg))
    port = layer_weight_shardings(pm, ShardingPolicy(make_mesh(
        tff.FFConfig(device="cpu", **deg), 2)))
    jpol = JPolicy(jax_make_mesh(jff.FFConfig(**deg), jax.devices()[:2]))
    for jl, pl in zip(jm.layers, pm.layers):
        for w in jl.weights:
            want = tuple(jpol.weight_sharding(w.shape, w.sharding_dims,
                                              w.shard_multiples).spec)
            got = port[pl.name][w.name].spec
            assert tuple(a for a in got) + (None,) * (
                len(want) - len(got)) == want + (None,) * (
                len(got) - len(want)), (pl.name, w.name, got, want)


def test_placement_rules():
    """Where a split dim lands: elementwise and feature-wise ops keep it,
    a reshape that keeps each rank's run contiguous keeps it, one that
    merges a split dim into an earlier one (or a softmax over it)
    gathers."""
    from flexflow_tpu_torch.parallel.mesh import Mesh
    from flexflow_tpu_torch.parallel.placement import _out_dim

    mesh = Mesh((2, 2), ("data", "seq"))
    m = tff.FFModel(tff.FFConfig(batch_size=8, device="cpu"))
    t = m.create_tensor([8, 4, 6], tff.DataType.DT_FLOAT)
    flat = m.reshape(t, [32, 6]).owner_layer
    keep = m.reshape(t, [8, 4, 2, 3]).owner_layer
    sm = m.softmax(t, axis=1).owner_layer
    tr = m.transpose(t, [1, 0, 2]).owner_layer
    ln = m.dense(t, 5).owner_layer
    assert _out_dim(flat, 0, 0, "data", mesh, True) == 0
    assert _out_dim(flat, 0, 1, "seq", mesh, True) is None
    assert _out_dim(keep, 0, 1, "seq", mesh, True) == 1
    assert _out_dim(sm, 0, 1, "seq", mesh, True) is None
    assert _out_dim(tr, 0, 0, "data", mesh, True) == 1
    assert _out_dim(ln, 0, 1, "seq", mesh, True) == 1
    assert _out_dim(ln, 0, 2, "seq", mesh, True) is None


def test_pipeline_training_is_refused():
    m = tff.FFModel(tff.FFConfig(batch_size=8, device="cpu",
                                 pipeline_parallelism_degree=2))
    t = m.create_tensor([8, 4], tff.DataType.DT_FLOAT)
    m.softmax(m.dense(t, 3))
    with pytest.raises(NotImplementedError, match="trains over"):
        m.compile(optimizer=tff.SGDOptimizer(m, 0.1),
                  loss_type=tff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)


def test_from_args_degrees_and_expert_override():
    c = tff.FFConfig.from_args(["-dp", "2", "-tp", "2", "-sp", "2"],
                               expert_parallelism_degree=2, remat=True,
                               device="cpu")
    j = jff.FFConfig.from_args(["-dp", "2", "-tp", "2", "-sp", "2"])
    assert (c.data_parallelism_degree, c.tensor_parallelism_degree,
            c.sequence_parallelism_degree) == (
        j.data_parallelism_degree, j.tensor_parallelism_degree,
        j.sequence_parallelism_degree)
    assert c.expert_parallelism_degree == 2 and c.remat
    assert c.total_parallelism_degree == 16
