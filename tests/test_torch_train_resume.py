"""Resumable training in the port, on the CPU: ``CheckpointManager``
(round trip, resume bit-equal to an uninterrupted run, ``max_to_keep``,
the save interval, a missing step raising), ``fit_with_recovery``
(resuming identically, refusing a checkpoint without an epoch), a tp=2
run's checkpoint restored at tp=1 and a tp=1 one at tp=2 (spawned gloo
ranks), ``remat`` bit-equal to no remat with dropout and BatchNorm, and
``recompile_on_condition`` keeping the weights that survive, mirroring
``tests/test_checkpoint.py`` and ``tests/test_aux.py:129-197``."""

import json
import pathlib

import numpy as np
import pytest
import torch

import flexflow_tpu_torch as ff
from flexflow_tpu_torch.core.recompile import RecompileState
from flexflow_tpu_torch.parallel import rank_jobs
from flexflow_tpu_torch.parallel.launch import load_target, run_ranks

JOB = str(pathlib.Path(__file__).with_name("torch_rank_jobs.py"))
B = 8


def _model(kind="mlp", remat=False, seed=7, **kw):
    """A compiled port model from the jobs' builders (Adam, accuracy)."""
    cfg = ff.FFConfig(batch_size=B, seed=seed, device="cpu", remat=remat)
    m = load_target(f"{JOB}:{kind}")(ff, cfg, **kw)
    m.compile(optimizer=ff.AdamOptimizer(m, alpha=1e-2),
              loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              metrics=[ff.MetricsType.METRICS_ACCURACY])
    return m


def _data(kind="mlp", n=6, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "mlp":
        x = rng.standard_normal((n * B, 32), dtype=np.float32)
        y = rng.integers(0, 10, (n * B, 1))
    elif kind == "bert":
        x = rng.integers(0, 50, (n * B, 8)).astype(np.int32)
        y = rng.integers(0, 50, (n * B, 8, 1))
    else:
        x = rng.standard_normal((n * B, 3, 8, 8), dtype=np.float32)
        y = rng.integers(0, 4, (n * B, 1))
    return x, y.astype(np.int32)


def _step(m, x, y, i):
    yb = y[i * B:(i + 1) * B]
    return m.train_one_batch([x[i * B:(i + 1) * B]],
                             yb.reshape(-1, 1) if yb.ndim == 3 else yb)


def _state(m):
    """Every parameter, optimizer slot and op-state tensor, copied."""
    out = {("p", ln, w): p.detach().clone() for ln, lp in m.params.items()
           for w, p in lp.items()}
    for k, v in m.opt_state.items():
        if isinstance(v, dict):
            out.update({("o", k, ln, w): t.clone() for ln, lp in v.items()
                        for w, t in lp.items()})
        else:
            out[("o", k)] = v.clone()
    out.update({("s", ln, k): v.clone() for ln, st in m.op_state.items()
                for k, v in st.items()})
    return out


def _assert_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("kind,kw", [("mlp", {}), ("cnn_bn", {}),
                                     ("bert", {"dropout": 0.1})])
def test_checkpoint_round_trip(tmp_path, kind, kw):
    x, y = _data(kind)
    m = _model(kind, **kw)
    for i in range(2):
        _step(m, x, y, i)
    mgr = ff.CheckpointManager(str(tmp_path / "ckpt"))
    assert mgr.save(2, m, dataloader_state={"idx": 2},
                    extra={"note": "unit"})
    assert mgr.latest_step() == 2 and mgr.all_steps() == [2]
    fresh = _model(kind, seed=99, **kw)
    meta = mgr.restore(fresh)
    assert meta == {"step": 2, "dataloader_state": {"idx": 2},
                    "extra": {"note": "unit"}}
    _assert_equal(_state(m), _state(fresh))
    assert torch.equal(m.generator.get_state(), fresh.generator.get_state())
    meta_file = json.loads((tmp_path / "ckpt" / "step_2" /
                            "meta.json").read_text())
    assert meta_file["step"] == 2
    mgr.close()


@pytest.mark.parametrize("kind,kw", [("mlp", {}), ("cnn_bn", {}),
                                     ("bert", {"dropout": 0.1})])
def test_resume_equivalence(tmp_path, kind, kw):
    """2 steps, save, restore into a fresh model, 2 more: bit-equal to 4
    steps straight (Adam state, BatchNorm statistics, dropout draws)."""
    x, y = _data(kind)
    full = _model(kind, **kw)
    want = [_step(full, x, y, i) for i in range(4)]
    a = _model(kind, **kw)
    got = [_step(a, x, y, i) for i in range(2)]
    mgr = ff.CheckpointManager(str(tmp_path / "ckpt"))
    mgr.save(2, a)
    b = _model(kind, seed=123, **kw)
    mgr.restore(b)
    got += [_step(b, x, y, i) for i in range(2, 4)]
    assert got == want
    _assert_equal(_state(full), _state(b))


def test_max_to_keep_and_interval(tmp_path):
    m = _model()
    mgr = ff.CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2,
                               save_interval_steps=2)
    assert not mgr.save(1, m)             # off the interval
    assert mgr.save(1, m, force=True)
    for s in (2, 3, 4):
        mgr.save(s, m, force=s == 3)
    assert mgr.all_steps() == [3, 4]
    assert not mgr.save(4, m)             # already there
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "step_3", "step_4"]


def test_restore_missing_raises(tmp_path):
    mgr = ff.CheckpointManager(str(tmp_path / "empty"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore(_model())
    mgr.save(1, _model())
    with pytest.raises(FileNotFoundError):
        mgr.restore(_model(), step=5)


def test_fit_with_recovery_resumes_identically(tmp_path):
    """A run cut after epoch 1 and started again ends where an unbroken
    run ends, bit for bit (shuffled epochs, Adam, the accuracy metric)."""
    from flexflow_tpu_torch.training.checkpoint import fit_with_recovery

    x, y = _data(n=4)
    whole = _model()
    hist = fit_with_recovery(whole, x, y, epochs=3, shuffle=True,
                             manager=ff.CheckpointManager(
                                 str(tmp_path / "a")))
    assert [h["epoch"] for h in hist] == [0, 1, 2]
    cut = _model()
    mgr = ff.CheckpointManager(str(tmp_path / "b"))
    fit_with_recovery(cut, x, y, epochs=2, shuffle=True, manager=mgr)
    again = _model()            # the seed also picks fit's shuffle order
    hist2 = fit_with_recovery(again, x, y, epochs=3, shuffle=True,
                              manager=mgr)
    assert [h["epoch"] for h in hist2] == [2]
    assert hist2[0]["loss"] == hist[2]["loss"]
    _assert_equal(_state(whole), _state(again))
    assert mgr.all_steps() == [0, 1, 2]


def test_fit_with_recovery_refuses_foreign_checkpoint(tmp_path):
    from flexflow_tpu_torch.training.checkpoint import fit_with_recovery

    x, y = _data(n=2)
    mgr = ff.CheckpointManager(str(tmp_path / "c"))
    mgr.save(7, _model())                     # no "epoch" in extra
    with pytest.raises(ValueError, match="epoch"):
        fit_with_recovery(_model(), x, y, epochs=2, manager=mgr)
    with pytest.raises(ValueError, match="save_every_epochs"):
        fit_with_recovery(_model(), x, y, epochs=2, manager=mgr,
                          save_every_epochs=0)


def test_npz_weights_still_round_trip(tmp_path):
    a, b = _model(), _model(seed=3)
    ff.save_weights_npz(str(tmp_path / "w.npz"), a)
    ff.load_weights_npz(str(tmp_path / "w.npz"), b)
    for ln, lp in a.params.items():
        for w, p in lp.items():
            assert torch.equal(p, b.params[ln][w])


# ----------------------------------------------------------------------
# checkpoints across degrees
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def across_degrees(tmp_path_factory):
    """One rank: 2 steps, checkpoint A. Two ranks at tp=2: restore A, 2
    steps, checkpoint B (whole params to an npz). One rank: restore B."""
    work = tmp_path_factory.mktemp("degrees")
    x, y = _data("bert", n=4, seed=4)
    np.savez(work / "d.npz", x0=x.reshape(4, B, 8),
             y=y.reshape(4, B * 8, 1))
    # SGD: attention's key bias has a zero gradient up to rounding, which
    # Adam would turn into full-size steps that differ with the order of
    # the ranks' sums
    run = dict(builder=f"{JOB}:bert", config=dict(batch_size=B, seed=7),
               optimizer=["sgd", {"lr": 0.05, "momentum": 0.9}],
               data=str(work / "d.npz"))
    one = rank_jobs.train({"device": "cpu", "runs": [dict(
        run, steps=2, save={"dir": str(work / "A"), "step": 2})]})[0]
    straight = rank_jobs.train({"device": "cpu", "runs": [dict(
        run, out=str(work / "straight.npz"))]})[0]
    two = run_ranks("flexflow_tpu_torch.parallel.rank_jobs:train", 2,
                    {"device": "cpu", "runs": [dict(
                        run, config=dict(run["config"],
                                         tensor_parallelism_degree=2),
                        restore=str(work / "A"), first_step=2, steps=2,
                        save={"dir": str(work / "B"), "step": 4},
                        out=str(work / "tp2.npz"))]},
                    workdir=work / "w", timeout=300)
    back = rank_jobs.build_trainer(run, torch.device("cpu"))
    meta = ff.CheckpointManager(str(work / "B")).restore(back)
    return (one, straight, two, back, meta, dict(np.load(work / "tp2.npz")),
            dict(np.load(work / "straight.npz")), work)


def test_tp2_checkpoint_restores_at_tp1(across_degrees):
    """The tp=2 ranks' checkpoint holds whole tensors: a one-rank model
    restores them bit for bit."""
    _one, _s, _two, back, meta, tp2, _w, _work = across_degrees
    assert meta["step"] == 4
    for ln, lp in back.params.items():
        for w, p in lp.items():
            np.testing.assert_array_equal(p.detach().numpy(), tp2[f"{ln}/{w}"])
    assert int(back.opt_state["step"]) == 4


def test_tp1_checkpoint_resumes_at_tp2(across_degrees):
    """Restored at tp=2 from the one-rank checkpoint, steps 3 and 4 give
    the losses and weights of the uninterrupted one-rank run (to the
    parallel runs' bound: the ranks sum in another order)."""
    one, straight, two, _b, _m, tp2, want, _work = across_degrees
    assert one["losses"] == straight["losses"][:2]
    for (r,) in two:
        np.testing.assert_allclose(r["losses"], straight["losses"][2:],
                                   rtol=1e-5, atol=1e-6)
    for k in want:
        np.testing.assert_allclose(tp2[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_tp2_checkpoint_slices_on_restore(across_degrees):
    """Every rank restored its own slice: a column-split kernel's whole
    width is twice the rank's."""
    work = across_degrees[-1]
    state = torch.load(work / "B" / "step_4" / "state.pt",
                       weights_only=False)
    kern = state["params"]["enc.0.fc1"]["kernel"]
    slot = state["opt_state"]["velocity"]["enc.0.attn"]["wq"]
    assert tuple(kern.shape) == (32, 128)
    assert tuple(slot.shape) == (32, 32)
    assert state["generator"].dtype == torch.uint8


# ----------------------------------------------------------------------
# remat and recompile
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind,kw", [("mlp", {}), ("cnn_bn", {}),
                                     ("bert", {"dropout": 0.1}),
                                     ("moe_net", {})])
def test_remat_is_bit_equal(kind, kw):
    """``remat=True`` (each layer recomputed in the backward, the dropout
    draws replayed, op state written once) gives the losses, parameters,
    optimizer state, running statistics and generator of ``remat=False``,
    bit for bit."""
    x, y = _data(kind, n=3)
    if kind == "moe_net":
        x = np.random.default_rng(1).standard_normal((3 * B, 64),
                                                     dtype=np.float32)
    a, b = _model(kind, **kw), _model(kind, remat=True, **kw)
    la = [_step(a, x, y, i) for i in range(3)]
    lb = [_step(b, x, y, i) for i in range(3)]
    assert la == lb
    _assert_equal(_state(a), _state(b))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_recompile_keeps_trained_weights():
    m = ff.FFModel(ff.FFConfig(batch_size=16, device="cpu"))
    t = m.create_tensor([16, 32], ff.DataType.DT_FLOAT)
    h = m.dense(t, 32, ff.ActiMode.AC_MODE_RELU, name="fc1")
    m.softmax(m.dense(h, 8, name="fc2"))
    m.compile(optimizer=ff.SGDOptimizer(m, lr=0.1),
              loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 32), dtype=np.float32)
    y = rng.integers(0, 8, (16, 1)).astype(np.int32)
    m.train_one_batch([x], y)
    before = m.get_parameter_by_key(("fc1", "kernel"))
    fired = []
    rs = RecompileState(lambda: True, lambda _rs: fired.append(1), m)
    assert m.recompile_on_condition(rs)
    assert fired == [1] and rs.recompilations == 1
    np.testing.assert_array_equal(m.get_parameter_by_key(("fc1", "kernel")),
                                  before)
    assert m.params["fc1"]["kernel"].requires_grad
    m.train_one_batch([x], y)                 # still trains
    assert not m.recompile_on_condition(RecompileState(
        lambda: False, lambda _rs: fired.append(1), m))
    assert fired == [1]


def test_recompile_reinitializes_changed_weights():
    """The alteration widens fc1: its kernel and bias and fc2's kernel
    change shape and start afresh; fc2's bias survives."""
    m = ff.FFModel(ff.FFConfig(batch_size=16, device="cpu"))
    t = m.create_tensor([16, 32], ff.DataType.DT_FLOAT)
    h = m.dense(t, 32, ff.ActiMode.AC_MODE_RELU, name="fc1")
    m.softmax(m.dense(h, 8, name="fc2"))
    m.compile(optimizer=ff.SGDOptimizer(m, lr=0.1),
              loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((16, 32), dtype=np.float32)
    y = rng.integers(0, 8, (16, 1)).astype(np.int32)
    m.train_one_batch([x], y)
    bias2 = m.get_parameter_by_key(("fc2", "bias"))

    def widen(rs):
        fc1, fc2 = m.layers[0], m.layers[1]
        fc1.attrs["out_dim"] = 48
        fc1.outputs[0].dims = (16, 48)
        from flexflow_tpu_torch.ops.base import get_op_impl

        for layer in (fc1, fc2):
            specs = [(i.dims, i.dtype) for i in layer.inputs]
            layer.weights = get_op_impl(layer.op_type).weight_specs(
                layer.attrs, specs)

    assert m.recompile_on_condition(RecompileState(lambda: True, widen, m))
    assert tuple(m.params["fc1"]["kernel"].shape) == (32, 48)
    np.testing.assert_array_equal(m.get_parameter_by_key(("fc2", "bias")),
                                  bias2)
    m.train_one_batch([x], y)


def test_cache_score_drives_recompile():
    """As ``tests/test_aux.py``'s: the Cache op's score over shifted
    batches fires a trigger."""
    m = ff.FFModel(ff.FFConfig(batch_size=8, device="cpu"))
    t = m.create_tensor([8, 16], ff.DataType.DT_FLOAT)
    h = m.cache(m.dense(t, 16, ff.ActiMode.AC_MODE_RELU, name="gate"),
                num_batches=1, name="gate_cache")
    m.softmax(m.dense(h, 4, name="head"))
    m.compile(optimizer=ff.SGDOptimizer(m, lr=0.0),
              loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((8, 16), dtype=np.float32)
    y = rng.integers(0, 4, (8, 1)).astype(np.int32)
    m.train_one_batch([a], y)
    m.train_one_batch([a], y)
    low = m.get_cache_score("gate_cache")
    assert low < 0.05
    m.train_one_batch([a * 3], y)
    high = m.get_cache_score("gate_cache")
    assert high > low
    fired = []
    assert m.recompile_on_condition(RecompileState(
        lambda: m.get_cache_score("gate_cache") > max(low, 0.05),
        lambda _rs: fired.append(True), m))
    assert fired == [True]
