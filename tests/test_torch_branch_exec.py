"""The branch plan (``core/branch_exec.py``) and the branch executors
(``parallel/ops.py`` ``branch_parallel_apply``,
``branch_data_parallel_apply``) of the port, on gloo ranks on the CPU.

The four-branch inception block of ``tests/test_measured_ab.py``
(``_inception``, batch 16) gets its branch strategy as
``test_branch_executor_numerics_match_plain`` builds it: ``CostModel(...,
branch_concurrency=True)``, ``UnitySearch.optimize_graph`` and
``expand_strategy``, on the ``"h100-sxm"`` machine model at ``data=4``
(under ``"cpu-sim"`` neither package's search splits the block). The
port's plan has the JAX package's regions for that strategy. On 4 ranks
each rank runs only its branch on its rows, and the losses and the
gradients equal the sequential walk's (one rank, and 4 ranks with no
strategy) within 1e-5. The executors alone match the branches applied in
turn, outputs and gradients, equal and unequal (1 + 3 ranks) splits.
"""

import pathlib

import numpy as np
import pytest
import torch

import flexflow_tpu as jff
from flexflow_tpu.core.branch_exec import \
    build_branch_plan as jbuild_branch_plan
import flexflow_tpu.search as jsearch
import flexflow_tpu_torch as tff
from flexflow_tpu_torch.core.branch_exec import build_branch_plan
from flexflow_tpu_torch.parallel import rank_jobs
from flexflow_tpu_torch.parallel.launch import load_target, run_ranks
from flexflow_tpu_torch.parallel.mesh import Mesh
from flexflow_tpu_torch.search import (CostModel, MachineModel, PCG,
                                       UnitySearch)
from flexflow_tpu_torch.search.graph_search import expand_strategy
from flexflow_tpu_torch.search.strategy import Strategy

JOB = str(pathlib.Path(__file__).with_name("torch_rank_jobs.py"))
TRAIN = "flexflow_tpu_torch.parallel.rank_jobs:train"
B, STEPS, SEED = 16, 3, 7
SGD = {"lr": 0.01}


def inception(ff, **kw):
    cfg = dict(batch_size=B, seed=SEED, **kw)
    if ff is tff:
        cfg["device"] = "cpu"
    return load_target(f"{JOB}:inception")(ff, ff.FFConfig(**cfg))


def branch_strategy(m):
    """The JAX test's construction, on the H100 machine model."""
    pcg = PCG.from_model(m)
    axes = {"data": 4, "model": 1}
    cm = CostModel(MachineModel.from_name("h100-sxm", 4), axes,
                   training=True, branch_concurrency=True)
    s = UnitySearch(pcg, cm, axes,
                    enable_substitutions=False).optimize_graph(pcg)
    assert sum(1 for st in s.ops.values() if st.branch) == 6
    return expand_strategy(pcg, s)


@pytest.fixture(scope="module")
def strategy():
    return branch_strategy(inception(tff))


def _region_view(plan):
    return [(r.join_layer_name, r.concat_axis, r.nb, r.out_channels,
             [[ly.name for ly in c] for c in r.chains])
            for r in plan.regions]


def _fake_mesh(model, shape=(4,), names=("data",)):
    model.mesh = Mesh(shape, names)
    return model


class _JaxDataMesh:
    """What the JAX plan reads of a mesh: a data axis of 4."""

    axis_names = ("data",)
    shape = {"data": 4}


def test_plan_equals_jax(strategy):
    """The same regions (join, branches' layers, widths) as the JAX
    package's plan for the same strategy at data=4."""
    jm = inception(jff, mesh_shape=(4,), mesh_axis_names=("data",))
    jm.strategy = jsearch.Strategy.from_json(strategy.to_json())
    jm.compile(optimizer=jff.SGDOptimizer(jm, **SGD),
               loss_type=jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    tm = _fake_mesh(inception(tff))
    tm.strategy = strategy
    plan = build_branch_plan(tm)
    assert plan is not None and len(plan.regions) == 1
    assert _region_view(plan) == _region_view(jm._branch_plan)
    assert plan.skip == jm._branch_plan.skip


def test_plan_declines_what_the_jax_plan_declines(strategy):
    """No plan without a strategy or a data axis of 2+, beside a model
    axis, or for an escaping branch intermediate (a second consumer
    outside the region), as in the JAX package."""
    m = _fake_mesh(inception(tff))
    assert build_branch_plan(m) is None
    m.strategy = strategy
    assert build_branch_plan(_fake_mesh(m, (1,))) is None
    assert build_branch_plan(_fake_mesh(m, (2, 2), ("data", "model"))) \
        is None
    m.mesh = None
    assert build_branch_plan(m) is None
    # an auxiliary head reading the first branch's output: both packages
    # decline the region
    for ff, plan_of in ((tff, build_branch_plan), (jff, jbuild_branch_plan)):
        aux = inception(ff)
        b1 = next(ly for ly in aux.layers if ly.name == "conv2d_1")
        aux.dense(aux.flat(b1.outputs[0]), 3)
        aux.strategy = (strategy if ff is tff
                        else jsearch.Strategy.from_json(strategy.to_json()))
        aux.mesh = _JaxDataMesh() if ff is jff else Mesh((4,), ("data",))
        aux.op_state = {}
        assert plan_of(aux) is None


@pytest.fixture(scope="module")
def trained(strategy, tmp_path_factory):
    """(one rank's, and 4 ranks' with and without the branch strategy)
    losses and last-step gradients, from the same weights and batches."""
    work = tmp_path_factory.mktemp("branch")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((STEPS, B, 32, 8, 8), dtype=np.float32)
    y = rng.integers(0, 10, (STEPS, B, 1)).astype(np.int32)
    np.savez(work / "d.npz", x0=x, y=y)
    m = inception(tff)
    m.compile(optimizer=tff.SGDOptimizer(m, **SGD),
              loss_type=tff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    torch.save({ln: {w: p.detach().clone() for w, p in lp.items()}
                for ln, lp in m.params.items()}, work / "w.pt")
    base = dict(builder=f"{JOB}:inception", optimizer=["sgd", SGD],
                data=str(work / "d.npz"), weights=str(work / "w.pt"))
    cfg = dict(batch_size=B, seed=SEED)
    runs = [dict(base, name="branch", strategy=strategy.to_json(),
                 config=dict(cfg, data_parallelism_degree=4),
                 grads_out=str(work / "branch.npz")),
            dict(base, name="plain", config=dict(
                cfg, data_parallelism_degree=4),
                grads_out=str(work / "plain.npz"))]
    res = run_ranks(TRAIN, 4, {"device": "cpu", "runs": runs},
                    workdir=work / "w", timeout=600)
    one = rank_jobs.train({"device": "cpu", "runs": [dict(
        base, name="one", config=cfg, grads_out=str(work / "one.npz"))]})[0]
    grads = {n: dict(np.load(work / f"{n}.npz"))
             for n in ("branch", "plain", "one")}
    return res, one, grads


def test_branch_region_runs_on_its_ranks(trained):
    res, _one, _g = trained           # res[rank][run]
    assert len(res) == 4
    assert [r["branch_regions"] for r in res[0]] == [1, 0]
    assert all(res[k][i]["losses"] == res[0][i]["losses"]
               for k in range(4) for i in range(2))


@pytest.mark.parametrize("run", [0, 1])
def test_losses_equal_the_sequential_walk(trained, run):
    res, one, _g = trained
    np.testing.assert_allclose(res[0][run]["losses"], one["losses"],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("run", ["branch", "plain"])
def test_gradients_equal_the_sequential_walk(trained, run):
    """Every parameter's last-step gradient, within 1e-5 of its largest
    magnitude."""
    grads = trained[2]
    assert set(grads[run]) == set(grads["one"]) and len(grads["one"]) == 16
    for k, ref in grads["one"].items():
        scale = max(float(np.abs(ref).max()), 1e-6)
        assert float(np.abs(grads[run][k] - ref).max()) <= 1e-5 * scale, k


def test_branch_executors_match_the_branches_in_turn(tmp_path):
    res = run_ranks(f"{JOB}:branch_ops", 4,
                    {"device": "cpu",
                     "degrees": {"data_parallelism_degree": 4}},
                    workdir=tmp_path, timeout=120)
    for r in res:
        assert set(r["errs"]) == {"data_nb2", "data_nb4", "switch_nb4",
                                  "switch_1_3"}
        assert max(r["errs"].values()) < 1e-5, r


def test_strategy_crosses_to_jax_unchanged(strategy):
    s = jsearch.Strategy.from_json(strategy.to_json())
    assert Strategy.from_json(s.to_json()).to_json() == strategy.to_json()
