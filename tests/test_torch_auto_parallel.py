"""Executing searched strategies in the port (``parallel/placement.py``,
``FFModel.compile`` under ``auto_parallel``), on gloo ranks on the CPU.

* Every candidate form that ``search/pcg.py``'s ``add_*_candidates``
  emit runs: for each form, every node of a tiny BERT, a conv net with
  BatchNorm and an experts net that offers it takes it, on 4 ranks
  (``data`` x ``model``, and ``data`` x ``seq`` for the sequence forms),
  from one set of weights carried in whole. Each step's loss equals one
  rank's within 1e-5 (fp32), every rank reads it, and each rank's
  weights are the slices its ``weight_specs`` name.
* ``auto_parallel`` on an MLP at dp=2 and tp=2 (2 ranks) searches the
  JAX package's strategy and trains to the JAX package's searched
  model's losses, from the JAX model's initial weights; with
  ``search_mesh`` the mesh is laid with the degrees the search adopts.
* A spec the port cannot realise raises at compile, naming the layer.

The port's ranks are ``run_ranks`` launches of ``parallel/rank_jobs.py``'s
``train`` job on a thread, while the references train here.
"""

import pathlib
import threading

import numpy as np
import pytest
import torch

import flexflow_tpu as jff
import flexflow_tpu_torch as tff
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.parallel import rank_jobs
from flexflow_tpu_torch.parallel.launch import load_target, run_ranks
from flexflow_tpu_torch.parallel.mesh import Mesh
from flexflow_tpu_torch.parallel.placement import plan_strategy
from flexflow_tpu_torch.parallel.spec import ShardingPolicy
from flexflow_tpu_torch.search.pcg import PCG
from flexflow_tpu_torch.search.strategy import OpStrategy, Strategy

JOB = str(pathlib.Path(__file__).with_name("torch_rank_jobs.py"))
TRAIN = "flexflow_tpu_torch.parallel.rank_jobs:train"
B, STEPS = 8, 2
SGD = {"lr": 0.05}
TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_AXES = {"data": 2, "model": 2}
SEQ_AXES = {"data": 2, "seq": 2}
_DEG = {"data": "data_parallelism_degree",
        "model": "tensor_parallelism_degree",
        "seq": "sequence_parallelism_degree"}

# every name add_*_candidates can emit, with and without +dp
FORMS = ["tp-col", "tp-row", "attr-dim", "tp-heads", "tp-hidden",
         "tp-vocab", "conv-oc", "conv-sp", "ep", "seq"]
ALL_NAMES = {"replicate", "dp"} | {f + s for f in FORMS
                                   for s in ("", "+dp")}
# (model, candidate name, mesh axes): each name on a model that offers it
CASES = ([("bert", n, "model") for n in (
    "replicate", "dp", "tp-col", "tp-col+dp", "tp-row", "tp-row+dp",
    "attr-dim", "attr-dim+dp", "tp-heads", "tp-heads+dp", "tp-hidden",
    "tp-hidden+dp", "tp-vocab", "tp-vocab+dp", "seq", "seq+dp")]
    + [("bert", n, "seq") for n in ("seq", "seq+dp")]
    + [("cnn_bn", n, "model") for n in (
        "conv-oc", "conv-oc+dp", "conv-sp", "conv-sp+dp", "tp-row+dp")]
    + [("experts_net", n, "model") for n in ("ep", "ep+dp", "tp-col")])
CASE_IDS = [f"{k}:{n}:{a}" for k, n, a in CASES]


def _data(kind, rng):
    if kind == "bert":
        x = rng.integers(0, 50, (STEPS, B, 8)).astype(np.int32)
        y = rng.integers(0, 50, (STEPS, B * 8, 1))
    elif kind == "cnn_bn":
        x = rng.standard_normal((STEPS, B, 3, 8, 8), dtype=np.float32)
        y = rng.integers(0, 4, (STEPS, B, 1))
    elif kind == "experts_net":
        x = rng.standard_normal((STEPS, B, 16), dtype=np.float32)
        y = rng.integers(0, 5, (STEPS, B, 1))
    else:
        x = rng.standard_normal((STEPS, B, 32), dtype=np.float32)
        y = rng.integers(0, 10, (STEPS, B, 1))
    return x, y.astype(np.int32)


def _axes(name):
    return MODEL_AXES if name == "model" else SEQ_AXES


def _form_strategy(pcg, name, axes):
    """Every node that offers candidate ``name`` takes it."""
    st = Strategy()
    for node in pcg.nodes:
        for c in node.candidates(axes):
            if c.name == name:
                st.ops[node.name] = c
    return st


def _jax_weights(kind):
    m = load_target(f"{JOB}:{kind}")(jff, jff.FFConfig(batch_size=B))
    m.compile(optimizer=jff.SGDOptimizer(m, **SGD),
              loss_type=jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return params_from_jax({ln: {w: np.asarray(a) for w, a in lp.items()}
                            for ln, lp in m.params.items()})


def _jax_searched(deg, x, y):
    """The JAX package's MLP under auto_parallel at ``deg`` (one axis of
    2 devices): (losses, strategy JSON)."""
    (axis, n), = deg.items()
    cfg = jff.FFConfig(batch_size=B, auto_parallel=True, num_devices=n,
                       search_deadline_s=0, search_profile=False,
                       search_budget=4, mesh_shape=(n,),
                       mesh_axis_names=(axis,), **{_DEG[axis]: n})
    m = load_target(f"{JOB}:mlp")(jff, cfg)
    m.compile(optimizer=jff.SGDOptimizer(m, **SGD),
              loss_type=jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return ([m.train_one_batch([x[i]], y[i]) for i in range(STEPS)],
            m.strategy.to_json())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every launch's rank results, the one-rank references and the JAX
    package's searched MLPs."""
    work = tmp_path_factory.mktemp("autopar")
    rng = np.random.default_rng(5)
    data, strategies = {}, {}
    for kind in ("bert", "cnn_bn", "experts_net", "mlp"):
        data[kind] = _data(kind, rng)
        np.savez(work / f"{kind}.npz", x0=data[kind][0], y=data[kind][1])
        torch.save(_jax_weights(kind), work / f"{kind}.pt")
        probe = load_target(f"{JOB}:{kind}")(tff, tff.FFConfig(
            batch_size=B, device="cpu"))
        pcg = PCG.from_model(probe)
        for axes in ("model", "seq"):
            strategies[kind, axes] = pcg, {
                c.name for n in pcg.nodes for c in n.candidates(_axes(axes))}

    def base(kind, name):
        return dict(name=name, builder=f"{JOB}:{kind}",
                    optimizer=["sgd", SGD], data=str(work / f"{kind}.npz"),
                    weights=str(work / f"{kind}.pt"))

    forms = []
    for kind, name, axes in CASES:
        pcg = strategies[kind, axes][0]
        deg = {_DEG[a]: n for a, n in _axes(axes).items()}
        forms.append(dict(base(kind, f"{kind}:{name}:{axes}"),
                          config=dict(batch_size=B, **deg),
                          strategy=_form_strategy(pcg, name, _axes(axes))
                          .to_json()))
    search = dict(search_deadline_s=0, search_budget=4, auto_parallel=True)
    autos = [dict(base("mlp", "mlp_dp2"), config=dict(
                 batch_size=B, data_parallelism_degree=2, **search)),
             dict(base("mlp", "mlp_tp2"), config=dict(
                 batch_size=B, tensor_parallelism_degree=2, **search)),
             dict(base("bert", "bert_mesh"), config=dict(
                 batch_size=B, search_mesh=True, search_chip="h100-sxm",
                 **search))]
    out, errors = {}, []

    def launch():
        try:
            for world, rs in ((4, forms), (2, autos)):
                res = run_ranks(TRAIN, world, {"device": "cpu", "runs": rs},
                                workdir=work / f"w{world}", timeout=600)
                for i, r in enumerate(rs):
                    out[r["name"]] = [per[i] for per in res]
        except Exception as e:          # re-raised in the test thread
            errors.append(e)

    t = threading.Thread(target=launch)
    t.start()
    ones = {}
    for kind in ("bert", "cnn_bn", "experts_net"):
        one = dict(base(kind, kind), config=dict(batch_size=B))
        ones[kind] = rank_jobs.train({"device": "cpu",
                                      "runs": [one]})[0]["losses"]
    jax_refs = {name: _jax_searched({axis: 2}, *data["mlp"])
                for name, axis in (("mlp_dp2", "data"),
                                   ("mlp_tp2", "model"))}
    t.join()
    if errors:
        raise errors[0]
    return dict(out=out, ones=ones, jax=jax_refs, strategies=strategies)


def test_cases_cover_every_candidate_form(runs):
    """The cases run every name pcg.py's add_*_candidates emit, and each
    case's model offers it."""
    offered = runs["strategies"]
    assert {n for _k, n, _a in CASES} == ALL_NAMES
    for kind, name, axes in CASES:
        assert name in offered[kind, axes][1], (kind, name)


@pytest.mark.parametrize("case", CASE_IDS)
def test_candidate_form_losses_equal_one_rank(runs, case):
    kind = case.split(":")[0]
    ranks = runs["out"][case]
    np.testing.assert_allclose(ranks[0]["losses"], runs["ones"][kind],
                               **TOL)
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks[1:])


@pytest.mark.parametrize("case", CASE_IDS)
def test_weights_rest_as_their_specs_name(runs, case):
    """Each rank holds the slice of every weight its layer's
    weight_specs name (else the op's own split)."""
    kind, _name, axes = case.split(":")
    ranks = runs["out"][case]
    st = Strategy.from_json(ranks[0]["strategy"])
    pcg = runs["strategies"][kind, axes][0]
    sizes = _axes(axes)
    checked = 0
    for node in pcg.nodes:
        op = st.ops.get(node.name)
        if op is None:
            continue
        for w, shape in node.weight_shapes.items():
            spec = op.weight_specs.get(w, (None,) * len(shape))
            want = [d // sizes.get(a, 1) if a else d
                    for d, a in zip(shape, spec)]
            for r in ranks:
                assert r["weight_shapes"][f"{node.name}/{w}"] == want
            checked += 1
    assert checked


@pytest.mark.parametrize("name", ["mlp_dp2", "mlp_tp2"])
def test_auto_parallel_mlp_matches_jax(runs, name):
    """The search's strategy is the JAX package's, and the searched model
    trains to its losses."""
    ranks = runs["out"][name]
    losses, strategy = runs["jax"][name]
    assert ranks[0]["strategy"] == strategy
    np.testing.assert_allclose(ranks[0]["losses"], losses, **TOL)
    assert all(r["losses"] == ranks[0]["losses"] for r in ranks[1:])


def test_search_mesh_lays_the_adopted_degrees(runs):
    """With ``search_mesh`` the mesh is the factorization the search
    chose, and the losses are one rank's."""
    ranks = runs["out"]["bert_mesh"]
    st = Strategy.from_json(ranks[0]["strategy"])
    assert st.axis_degrees is not None
    want = {a: n for a, n in st.axis_degrees.items() if n > 1}
    assert ranks[0]["mesh"] == want and len(ranks) == 2
    np.testing.assert_allclose(ranks[0]["losses"], runs["ones"]["bert"],
                               **TOL)


def _planned(strategy, shape=(2, 2), names=("data", "model")):
    """``plan_strategy`` of the tiny BERT on a mesh of ``shape`` (no
    process group: the plan reads only the mesh's shape)."""
    m = load_target(f"{JOB}:bert")(tff, tff.FFConfig(batch_size=B,
                                                     device="cpu"))
    m.mesh = Mesh(shape, names)
    m.policy = ShardingPolicy(m.mesh)
    m.strategy = strategy
    return plan_strategy(m)


def _op(output=(None,), weights=None):
    return OpStrategy(input_specs=(), output_spec=output,
                      weight_specs=weights or {})


@pytest.mark.parametrize("layer,op,match", [
    ("enc.0.fc1", _op(("data", None, "modl")), "'enc.0.fc1'.*'modl'"),
    ("enc.0.fc1", _op(("data", "model", "model")), "uses an axis twice"),
    ("embed", _op(("data", None, None, None)), "more dims"),
    ("enc.0.attn", _op(weights={"wq": (None, "model", None)}),
     "'enc.0.attn'.*more dims"),
    ("enc.0.fc1", _op(weights={"bogus": (None,)}), "'bogus'"),
    ("no_such_layer", _op(), "'no_such_layer'"),
])
def test_unrealisable_specs_are_refused(layer, op, match):
    with pytest.raises(ValueError, match=match):
        _planned(Strategy(ops={layer: op}))


@pytest.mark.parametrize("layer,weights,attrs", [
    ("enc.0.fc2", {"kernel": ("model", None)}, {"row_parallel": True}),
    ("embed", {"weight": ("model", None)}, {"vocab_parallel": True}),
])
def test_row_forms_are_named_by_the_plan(layer, weights, attrs):
    """The plan names the row-parallel Linear and the vocab-parallel
    Embedding to their forwards; a row shard the plan did not name is
    a shape error in the forward, never a silent split."""
    plan = _planned(Strategy(ops={layer: _op(weights=weights)}))
    assert plan.attrs[layer] == attrs
    impl = tff.ops.base.get_op_impl(tff.OpType.LINEAR)
    ctx = tff.ops.base.OpContext(training=False, device="cpu")
    with pytest.raises(RuntimeError):
        impl.forward({"out_dim": 4, "use_bias": False},
                     {"kernel": torch.zeros(3, 4)}, [torch.zeros(2, 6)],
                     ctx)


def test_whole_head_units_refuse_a_split():
    """4 heads of 8 columns over a model axis of 8 would cut a head in
    two; a model axis of 3 cannot divide 32 columns at all."""
    with pytest.raises(ValueError, match="'enc.0.attn'.*cannot be "
                                         "realised"):
        _planned(Strategy(ops={"enc.0.attn": _op(
            weights={"wq": (None, "model")})}), shape=(8,),
            names=("model",))
    with pytest.raises(ValueError, match="'enc.0.attn'.*splits a dim"):
        _planned(Strategy(ops={"enc.0.attn": _op(
            weights={"wq": (None, "model")})}), shape=(3,),
            names=("model",))


def test_unrealisable_spec_raises_at_compile(tmp_path):
    """On ranks: compile refuses the spec, naming the layer, before any
    weight is made."""
    bad = Strategy(ops={"enc.0.fc2": _op((None, None, "modl"))})
    run = dict(name="bad", builder=f"{JOB}:bert",
               config=dict(batch_size=B, data_parallelism_degree=2),
               strategy=bad.to_json(), data="unused")
    with pytest.raises(RuntimeError, match="enc.0.fc2"):
        run_ranks(TRAIN, 2, {"device": "cpu", "runs": [run]},
                  workdir=tmp_path, timeout=120)
