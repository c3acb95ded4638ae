"""Where a tensor-parallel train step keeps its activations: the port's
placement against the one GSPMD gives the JAX package's step, on the CPU.

(a) For ``tests/torch_rank_jobs.py``'s tiny ``mlp`` and ``bert`` on a
``("model",) = (2,)`` and a ``("data", "model") = (2, 2)`` mesh, GSPMD's
spec of every layer output is read in a JAX train step
(``jax.debug.inspect_array_sharding``, called from the JAX package's
``FFModel._apply_layer`` patched for this test only), and the port's
``Walk.places`` for the same outputs must name the same ``{axis: dim}``.
(b) Each ``model``-split form (LayerNorm, RMSNorm, the softmax over the
split axis, the losses on a class-split output, the shard-saving
``gather_product``) against its whole version on 2 gloo ranks, forward
and gradients, at rtol 1e-5 and atol 1e-6. (c) At tp=2 a rank saves at
most 0.60 of the one-rank run's bytes for the backward of the tiny
``bert`` (``saved_tensors_hooks``). The same runs' loss, ``predict``
output (gathered whole) and ``evaluate`` loss and metrics equal one
rank's from the same seed.
"""

import pathlib
import threading

import jax
import numpy as np
import pytest

import flexflow_tpu as jff
import flexflow_tpu_torch as tff
from flexflow_tpu_torch.parallel.launch import load_target, run_ranks

JOB = str(pathlib.Path(__file__).with_name("torch_rank_jobs.py"))
B, SEED = 8, 1
TOL = dict(rtol=1e-5, atol=1e-6)
MESHES = {"tp2": {"tensor_parallelism_degree": 2},
          "tp2dp2": {"data_parallelism_degree": 2,
                     "tensor_parallelism_degree": 2}}
JAX_MESH = {"tp2": ((2,), ("model",)), "tp2dp2": ((2, 2), ("data", "model"))}
# the builders a mesh runs ("bertremat": bert under remat, held to one
# rank's bert)
KINDS = {"tp2": ("mlp", "bert", "bertremat"), "tp2dp2": ("mlp", "bert")}
CASES = [f"{kind}_{mesh}" for mesh in MESHES for kind in ("mlp", "bert")]
FORMS = ["layernorm", "rmsnorm", "softmax",
         "loss_sparse_categorical_crossentropy",
         "loss_categorical_crossentropy",
         "loss_mean_squared_error_avg_reduce",
         "loss_mean_squared_error_sum_reduce", "gather_product"]


def _batch(kind):
    rng = np.random.default_rng(5)
    if kind == "mlp":
        return (rng.standard_normal((B, 32), dtype=np.float32),
                rng.integers(0, 10, (B, 1)).astype(np.int32))
    return (rng.integers(0, 50, (B, 8)).astype(np.int32),
            rng.integers(0, 50, (B * 8, 1)).astype(np.int32))


def _run(kind, degrees):
    x, y = _batch(kind)
    remat = kind == "bertremat"
    return dict(builder=f"{JOB}:{'bert' if remat else kind}", config=dict(
        batch_size=B, seed=SEED, remat=remat, **degrees),
        optimizer=["sgd", {"lr": 0.05}],
        metrics=["METRICS_ACCURACY",
                 "METRICS_SPARSE_CATEGORICAL_CROSSENTROPY"],
        x=x.tolist(), x_dtype=str(x.dtype), y=y.tolist())


def _gspmd_places(kind, mesh, monkeypatch):
    """[[{axis: dim} of each output] of each layer] of one JAX train step
    of ``kind`` on ``mesh``, as GSPMD shards them."""
    from flexflow_tpu.core.model import FFModel

    got = {}
    orig = FFModel._apply_layer

    def probe(self, layer, params, values, ctx):
        orig(self, layer, params, values, ctx)
        for j, t in enumerate(layer.outputs):
            def keep(sharding, key=(layer.name, j)):
                got[key] = sharding
            jax.debug.inspect_array_sharding(values[t.tensor_id],
                                             callback=keep)

    monkeypatch.setattr(FFModel, "_apply_layer", probe)
    shape, names = JAX_MESH[mesh]
    m = load_target(f"{JOB}:{kind}")(jff, jff.FFConfig(
        batch_size=B, seed=SEED, mesh_shape=shape, mesh_axis_names=names))
    m.compile(optimizer=jff.SGDOptimizer(m, lr=0.05),
              loss_type=jff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    x, y = _batch(kind)
    m.train_one_batch([x], y)
    monkeypatch.undo()
    out = []
    for layer in m.layers:
        places = []
        for j in range(len(layer.outputs)):
            spec = got[(layer.name, j)].spec
            place = {}
            for d, axes in enumerate(spec):
                for a in (axes if isinstance(axes, tuple) else (axes,)):
                    if a is not None:
                        place[a] = d
            places.append(place)
        out.append(places)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's rank results (each case's placements, split forms'
    arrays, saved bytes, predict and evaluate) and the one-rank runs'
    (``tp_placement`` in this process, no mesh); the rank launches run on
    a thread meanwhile."""
    work = tmp_path_factory.mktemp("tpplace")
    forms = work / "forms.npz"
    ranks, errors = {}, []

    def launch():
        try:
            for mesh, degrees in MESHES.items():
                world = int(np.prod(list(degrees.values())))
                res = run_ranks(f"{JOB}:tp_placement", world, {
                    "device": "cpu",
                    "runs": [_run(k, degrees) for k in KINDS[mesh]]},
                    workdir=work / mesh, timeout=300)
                for j, kind in enumerate(KINDS[mesh]):
                    ranks[f"{kind}_{mesh}"] = [r[j] for r in res]
            run_ranks(f"{JOB}:split_forms", 2, {
                "device": "cpu", "out": str(forms),
                "degrees": MESHES["tp2"]}, workdir=work / "forms",
                timeout=300)
        except Exception as e:          # re-raised in the test thread
            errors.append(e)

    t = threading.Thread(target=launch)
    t.start()
    one = load_target(f"{JOB}:tp_placement")({
        "device": "cpu", "runs": [_run(k, {}) for k in ("mlp", "bert")]})
    t.join()
    if errors:
        raise errors[0]
    return ranks, dict(np.load(forms)), dict(zip(("mlp", "bert"), one))


@pytest.mark.parametrize("case", CASES)
def test_placement_equals_gspmd(runs, case, monkeypatch):
    """Every layer output of the port's step is split where GSPMD splits
    the JAX package's, on every rank."""
    kind, mesh = case.split("_")
    want = _gspmd_places(kind, mesh, monkeypatch)
    for r in runs[0][case]:
        got = r["places"]
        assert len(got) == len(want)
        for name, g, w in zip(r["layers"], got, want):
            assert g == w, name


@pytest.mark.parametrize("form", FORMS)
def test_split_form_matches_whole(runs, form):
    arrays = runs[1]
    keys = sorted(k[:-len("_split")] for k in arrays
                  if k.startswith(form + "_") and k.endswith("_split"))
    assert keys
    for k in keys:
        np.testing.assert_allclose(arrays[k + "_split"],
                                   arrays[k + "_whole"], err_msg=k, **TOL)


def test_saved_bytes_halve_at_tp2(runs):
    """A rank at tp=2 saves at most 0.60 of one rank's bytes for the
    backward of the tiny bert (before the split it saved every
    activation whole)."""
    ranks, _forms, one = runs
    for r in ranks["bert_tp2"]:
        assert r["saved_bytes"] <= 0.60 * one["bert"]["saved_bytes"], (
            r["saved_bytes"], one["bert"]["saved_bytes"])


@pytest.mark.parametrize("case", CASES + ["bertremat_tp2"])
def test_loss_predict_evaluate_equal_one_rank(runs, case):
    """The step's loss, ``predict`` (the whole output on every rank) and
    ``evaluate``'s loss and metrics (their classes gathered) at the
    mesh's degrees against one rank's (remat recomputes the split forms
    and their collectives in the backward)."""
    ref = runs[2][case.split("_")[0].replace("remat", "")]
    for r in runs[0][case]:
        np.testing.assert_allclose(r["loss"], ref["loss"], **TOL)
        np.testing.assert_allclose(r["predict"], ref["predict"], **TOL)
        assert set(r["evaluate"]) == set(ref["evaluate"])
        for k, v in ref["evaluate"].items():
            np.testing.assert_allclose(r["evaluate"][k], v, err_msg=k,
                                       **TOL)


def test_only_whole_weights_sum_over_model(runs):
    """At tp=2 the gradient sums over ``model`` move only the weights that
    rest whole and were cut to the rank's features: bert's LayerNorm
    gamma/beta and the MHA's bo (fp32); the mlp's column shards none."""
    ranks = runs[0]
    m = load_target(f"{JOB}:bert")(tff, tff.FFConfig(batch_size=B,
                                                     device="cpu"))
    n = 0
    for layer in m.layers:
        for w in layer.weights:
            if w.name in ("gamma", "beta", "bo"):
                n += int(np.prod(w.shape))
    assert ranks["bert_tp2"][0]["allreduce_bytes"] == 4 * n
    assert ranks["mlp_tp2"][0]["allreduce_bytes"] == 0
