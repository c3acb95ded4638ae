"""The port's training path against the JAX package's, on the CPU.

Tiny BERT (2 layers, hidden 64, 4 heads, seq 16, vocab 101) and tiny
ResNet (stem, max pool, 2 bottlenecks, 32x32, 10 classes) are built by the
same builder code through both packages (``ff`` is either module), the
JAX model's weights and op state carried across through ``convert.py``,
then trained side by side: three ``train_one_batch`` steps, ``evaluate``,
``predict`` and ``fit(epochs=2, shuffle=True)``. Batch 8, so a JAX mesh
over the conftest's 8 CPU devices can split it. Losses, optimizers and
metrics are held to the JAX functions on the same inputs, and the MLP
cases of ``tests/test_mnist_mlp.py`` run on the port alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as jff
import flexflow_tpu_torch as tff
from flexflow_tpu.training import dataloader as jdata
from flexflow_tpu.training import loss as jloss
from flexflow_tpu.training import metrics as jmetrics
from flexflow_tpu.training import optimizer as joptim
from flexflow_tpu_torch.convert import (load_op_state, load_params,
                                        params_from_jax)
from flexflow_tpu_torch.training import dataloader as tdata
from flexflow_tpu_torch.training import loss as tloss
from flexflow_tpu_torch.training import metrics as tmetrics

B, SEQ, HIDDEN, HEADS, VOCAB, LAYERS = 8, 16, 64, 4, 101, 2
IMG, CLASSES = 32, 10
STEPS = 3


def _config(ff, dtype):
    kw = {"device": "cpu"} if ff is tff else {}
    return ff.FFConfig(batch_size=B, compute_dtype=dtype, **kw)


def _compile(ff, m, lr):
    m.compile(optimizer=ff.SGDOptimizer(m, lr=lr, momentum=0.9,
                                        nesterov=True, weight_decay=1e-4),
              loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              metrics=[ff.MetricsType.METRICS_ACCURACY,
                       ff.MetricsType.METRICS_SPARSE_CATEGORICAL_CROSSENTROPY])
    return m


def build_bert(ff, dtype="float32"):
    """bench_train.py's encoder at a tiny width, with an L2 regularizer on
    each fc1."""
    m = ff.FFModel(_config(ff, dtype))
    tokens = m.create_tensor([B, SEQ], ff.DataType.DT_INT32)
    x = m.embedding(tokens, VOCAB, HIDDEN, name="embed")
    for i in range(LAYERS):
        attn = m.multihead_attention(x, x, x, embed_dim=HIDDEN,
                                     num_heads=HEADS, name=f"enc.{i}.attn")
        x = m.layer_norm(m.add(attn, x), axes=[-1], name=f"enc.{i}.ln1")
        h = m.dense(x, 4 * HIDDEN, ff.ActiMode.AC_MODE_GELU,
                    kernel_regularizer=("l2", 1e-3), name=f"enc.{i}.fc1")
        h = m.dense(h, HIDDEN, name=f"enc.{i}.fc2")
        x = m.layer_norm(m.add(h, x), axes=[-1], name=f"enc.{i}.ln2")
    logits = m.dense(x, VOCAB, name="mlm_head")
    m.softmax(m.reshape(logits, [B * SEQ, VOCAB]))
    return _compile(ff, m, lr=0.05)


def build_resnet(ff, dtype="float32"):
    """bench_train.py's ResNet layout cut to the stem, the max pool and two
    bottlenecks (the first with a projection shortcut)."""
    m = ff.FFModel(_config(ff, dtype))

    def conv(x, c, k, s, p):
        return m.conv2d(x, c, k, k, s, s, p, p, use_bias=False)

    def bottleneck(x, c_mid, stride):
        y = m.batch_norm(conv(x, c_mid, 1, 1, 0), relu=True)
        y = m.batch_norm(conv(y, c_mid, 3, stride, 1), relu=True)
        y = m.batch_norm(conv(y, 4 * c_mid, 1, 1, 0), relu=False)
        sc = x
        if stride != 1 or x.dims[1] != 4 * c_mid:
            sc = m.batch_norm(conv(x, 4 * c_mid, 1, stride, 0), relu=False)
        return m.relu(m.add(y, sc))

    t = m.create_tensor([B, 3, IMG, IMG], ff.DataType.DT_FLOAT)
    x = m.batch_norm(conv(t, 16, 7, 2, 3), relu=True)
    x = m.pool2d(x, 3, 3, 2, 2, 1, 1)
    x = bottleneck(x, 8, 1)
    x = bottleneck(x, 8, 1)
    x = m.pool2d(x, x.dims[2], x.dims[3], 1, 1, 0, 0, ff.PoolType.POOL_AVG)
    m.softmax(m.dense(m.flat(x), CLASSES))
    return _compile(ff, m, lr=0.05)


BUILDERS = {"bert": build_bert, "resnet": build_resnet}


def make_data(kind, n_batches, seed):
    rng = np.random.RandomState(seed)
    if kind == "bert":
        x = rng.randint(0, VOCAB, (n_batches * B, SEQ)).astype(np.int32)
        y = rng.randint(0, VOCAB, (n_batches * B * SEQ, 1)).astype(np.int32)
        return x, y.reshape(n_batches * B, SEQ, 1)
    x = rng.randn(n_batches * B, 3, IMG, IMG).astype(np.float32)
    y = rng.randint(0, CLASSES, (n_batches * B, 1)).astype(np.int32)
    return x, y


def _batch_labels(kind, y):
    """The label of one batch: BERT's [B, SEQ, 1] rows flatten to the
    [B * SEQ, 1] labels of its reshaped logits."""
    return y.reshape(-1, 1) if kind == "bert" else y


def twin(kind, dtype="float32"):
    """(JAX model, port model) built alike, the port holding the JAX
    model's weights and op state."""
    jm = BUILDERS[kind](jff, dtype)
    pm = BUILDERS[kind](tff, dtype)
    assert load_params(pm, params_from_jax(jm.params)) == sum(
        len(lp) for lp in jm.params.values())
    jstate = {k: {n: np.asarray(a) for n, a in v.items()}
              for k, v in jm.op_state.items()}
    assert load_op_state(pm, jstate) == (2 * len(jstate))
    return jm, pm


def _copy_np(a):
    """A copy: a CPU tensor's storage (and a donated JAX buffer) changes
    as training goes on."""
    return np.array(a.detach() if torch.is_tensor(a) else a, np.float32)


def _params_np(m):
    return {(layer, w): _copy_np(a)
            for layer, lp in m.params.items() for w, a in lp.items()}


def _state_np(m):
    return {(k, n): _copy_np(a)
            for k, v in m.op_state.items() for n, a in v.items()}


@pytest.fixture(scope="module", params=sorted(BUILDERS))
def trained(request):
    """Both models through STEPS train steps, evaluate, predict and
    fit(epochs=2, shuffle=True); returns what each package gave."""
    kind = request.param
    jm, pm = twin(kind)
    x, y = make_data(kind, STEPS, seed=1)
    out = {"kind": kind, "losses": ([], [])}
    for i in range(STEPS):
        bx, by = x[i * B:(i + 1) * B], _batch_labels(kind, y[i * B:(i + 1) * B])
        out["losses"][0].append(jm.train_one_batch([bx], by))
        out["losses"][1].append(pm.train_one_batch([bx], by))
    out["params"] = (_params_np(jm), _params_np(pm))
    out["state"] = (_state_np(jm), _state_np(pm))
    out["grads_on"] = {p.grad is not None for lp in pm.params.values()
                       for p in lp.values()}
    ex, ey = make_data(kind, 2, seed=2)
    out["predict"] = (np.asarray(jm.predict(ex[:B]), np.float32),
                      pm.predict(ex[:B]))
    if kind == "resnet":
        # evaluate and fit cut batch_size rows of the label, which BERT's
        # [B * SEQ, 1] label of a B-row batch does not fit (in either
        # package)
        out["evaluate"] = (jm.evaluate(x=ex, y=ey), pm.evaluate(x=ex, y=ey))
        fx, fy = make_data(kind, 3, seed=3)
        out["fit"] = (jm.fit(x=fx, y=fy, epochs=2, shuffle=True),
                      pm.fit(x=fx, y=fy, epochs=2, shuffle=True))
    return out


def test_train_steps_losses_match_jax(trained):
    jl, pl = trained["losses"]
    np.testing.assert_allclose(pl, jl, rtol=1e-5, atol=0)
    assert all(np.isfinite(pl))


def test_train_steps_params_match_jax(trained):
    jp, pp = trained["params"]
    assert jp.keys() == pp.keys()
    for k in jp:
        np.testing.assert_allclose(pp[k], jp[k], atol=1e-4, rtol=1e-4,
                                   err_msg=str(k))
    assert trained["grads_on"] == {True}


def test_train_steps_op_state_matches_jax(trained):
    js, ps = trained["state"]
    assert js.keys() == ps.keys()
    assert bool(js) == (trained["kind"] == "resnet")   # BN running stats
    for k in js:
        np.testing.assert_allclose(ps[k], js[k], atol=1e-5, rtol=1e-5,
                                   err_msg=str(k))


def test_predict_matches_jax(trained):
    jp, pp = trained["predict"]
    assert jp.shape == pp.shape
    np.testing.assert_allclose(pp, jp, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("trained", ["resnet"], indirect=True)
def test_evaluate_matches_jax(trained):
    je, pe = trained["evaluate"]
    assert je.keys() == pe.keys() == {"loss", "accuracy"}
    np.testing.assert_allclose(pe["loss"], je["loss"], rtol=1e-5)
    assert pe["accuracy"] == je["accuracy"]


@pytest.mark.parametrize("trained", ["resnet"], indirect=True)
def test_fit_shuffled_history_matches_jax(trained):
    jh, ph = trained["fit"]
    assert [h["epoch"] for h in ph] == [0, 1]
    for a, b in zip(jh, ph):
        assert a.keys() == b.keys()
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
        assert b["accuracy"] == a["accuracy"]


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_bf16_train_steps_match_jax(kind):
    """bf16 compute (weights fp32, their gradients fp32): three steps'
    losses within 2e-2 of the JAX package's."""
    jm, pm = twin(kind, "bfloat16")
    x, y = make_data(kind, STEPS, seed=4)
    for i in range(STEPS):
        bx, by = x[i * B:(i + 1) * B], _batch_labels(kind, y[i * B:(i + 1) * B])
        jl, pl = jm.train_one_batch([bx], by), pm.train_one_batch([bx], by)
        np.testing.assert_allclose(pl, jl, rtol=2e-2)
    for lp in pm.params.values():
        for p in lp.values():
            assert p.dtype == torch.float32 and p.grad.dtype == torch.float32


# ----------------------------------------------------------------------
# losses, metrics, optimizers and the data path against the JAX functions
# ----------------------------------------------------------------------
def _loss_inputs(rng, loss_type):
    logits = rng.randn(6, 5).astype(np.float32)
    out = np.asarray(jax.nn.softmax(jnp.asarray(logits)), np.float32)
    if loss_type == "LOSS_SPARSE_CATEGORICAL_CROSSENTROPY":
        label = rng.randint(0, 5, (6, 1)).astype(np.int32)
    elif loss_type == "LOSS_CATEGORICAL_CROSSENTROPY":
        label = np.eye(5, dtype=np.float32)[rng.randint(0, 5, 6)]
    else:
        label = rng.randn(6, 5).astype(np.float32)
    return logits, out, label


@pytest.mark.parametrize("loss_type", [t.name for t in tff.LossType])
@pytest.mark.parametrize("with_logits", [False, True])
def test_losses_match_jax(loss_type, with_logits):
    rng = np.random.RandomState(11)
    logits, out, label = _loss_inputs(rng, loss_type)
    jt, tt = getattr(jff.LossType, loss_type), getattr(tff.LossType,
                                                       loss_type)
    want = jloss.compute_loss(jt, jnp.asarray(out), jnp.asarray(label),
                              logits=jnp.asarray(logits) if with_logits
                              else None)
    got = tloss.compute_loss(tt, torch.tensor(out), torch.tensor(label),
                             logits=torch.tensor(logits) if with_logits
                             else None)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


@pytest.mark.parametrize("sparse", [True, False])
def test_step_metrics_and_perf_metrics_match_jax(sparse):
    rng = np.random.RandomState(12)
    kind = ("LOSS_SPARSE_CATEGORICAL_CROSSENTROPY" if sparse
            else "LOSS_CATEGORICAL_CROSSENTROPY")
    _, out, label = _loss_inputs(rng, kind)
    names = [t.name for t in tff.MetricsType
             if sparse or t.name != "METRICS_SPARSE_CATEGORICAL_CROSSENTROPY"]
    want = jmetrics.compute_step_metrics(
        [getattr(jff.MetricsType, n) for n in names], jnp.asarray(out),
        jnp.asarray(label), getattr(jff.LossType, kind))
    got = tmetrics.compute_step_metrics(
        [getattr(tff.MetricsType, n) for n in names], torch.tensor(out),
        torch.tensor(label), getattr(tff.LossType, kind))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    jp, tp = jmetrics.PerfMetrics(), tmetrics.PerfMetrics()
    for _ in range(2):
        jp.update({k: float(v) for k, v in want.items()}, 6)
        tp.update({k: float(v) for k, v in got.items()}, 6)
    assert tp.report() == jp.report() and tp.accuracy == jp.accuracy


OPTIMIZERS = {
    "sgd": ("SGDOptimizer", dict(lr=0.1)),
    "sgd_momentum": ("SGDOptimizer", dict(lr=0.1, momentum=0.9)),
    "sgd_nesterov_wd": ("SGDOptimizer", dict(lr=0.1, momentum=0.9,
                                             nesterov=True,
                                             weight_decay=0.01)),
    "adam": ("AdamOptimizer", dict(alpha=0.01)),
    "adam_wd": ("AdamOptimizer", dict(alpha=0.01, beta1=0.8, beta2=0.99,
                                      weight_decay=0.01, epsilon=1e-6)),
}


class _Holder:
    """A stand-in model for set_learning_rate to reach the state through."""
    opt_state = None


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_updates_match_jax(name):
    """Three updates of the same params and grads, the rate changed by
    set_learning_rate before the third: params and state to 1e-6."""
    cls, kw = OPTIMIZERS[name]
    rng = np.random.RandomState(13)
    p0 = {"a": {"kernel": rng.randn(4, 3).astype(np.float32),
                "bias": rng.randn(3).astype(np.float32)},
          "b": {"w": rng.randn(5).astype(np.float32)}}
    grads = [{k: {w: rng.randn(*a.shape).astype(np.float32)
                  for w, a in lp.items()} for k, lp in p0.items()}
             for _ in range(3)]
    jh, th = _Holder(), _Holder()
    jo, to = getattr(joptim, cls)(jh, **kw), getattr(tff, cls)(th, **kw)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = {k: {w: torch.tensor(a) for w, a in lp.items()}
          for k, lp in p0.items()}
    jh.opt_state, th.opt_state = jo.init_state(jp), to.init_state(tp)
    for i, g in enumerate(grads):
        if i == 2:
            jo.set_learning_rate(0.03)
            to.set_learning_rate(0.03)
        jp, jh.opt_state = jo.update_step(jp, jax.tree.map(jnp.asarray, g),
                                          jh.opt_state)
        to.update_step(tp, {k: {w: torch.tensor(a) for w, a in lp.items()}
                            for k, lp in g.items()}, th.opt_state)
    assert int(th.opt_state["step"]) == int(jh.opt_state["step"]) == 3
    assert th.opt_state["lr"].item() == pytest.approx(0.03)
    for k, lp in p0.items():
        for w in lp:
            np.testing.assert_allclose(tp[k][w].numpy(), np.asarray(jp[k][w]),
                                       atol=1e-6, rtol=1e-6)
            for slot in ("velocity", "m", "v"):
                if slot in jh.opt_state:
                    np.testing.assert_allclose(
                        th.opt_state[slot][k][w].numpy(),
                        np.asarray(jh.opt_state[slot][k][w]), atol=1e-6,
                        rtol=1e-6)


def test_minibatch_order_and_dataloader_match_jax():
    x = np.arange(40, dtype=np.float32).reshape(20, 2)
    y = np.arange(20, dtype=np.int32).reshape(20, 1)
    for seed in (0, 5):
        want = list(jdata.minibatches([x, y], 6, shuffle=True, seed=seed))
        got = list(tdata.minibatches([x, y], 6, shuffle=True, seed=seed))
        assert len(got) == len(want) == 3
        for (a, b), (c, d) in zip(got, want):
            assert np.array_equal(a, c) and np.array_equal(b, d)
    m = tff.FFModel(tff.FFConfig(batch_size=6, device="cpu"))
    t = m.create_tensor([6, 2], tff.DataType.DT_FLOAT)
    dl = tff.SingleDataLoader(m, t, x)
    assert dl.num_batches == 3
    seen = [dl.next_batch() for _ in range(4)]
    assert seen[0].dtype == torch.float32 and seen[0].device.type == "cpu"
    assert torch.equal(seen[3], seen[0])        # wraps after the last
    assert torch.equal(seen[1], torch.tensor(x[6:12]))


# ----------------------------------------------------------------------
# the port alone: tests/test_mnist_mlp.py's cases, compile modes, devices
# ----------------------------------------------------------------------
def make_synthetic_mnist(n=2048, d=784, classes=10, seed=0):
    rng = np.random.RandomState(seed)
    centers = rng.randn(classes, d).astype(np.float32) * 2.0
    y = rng.randint(0, classes, size=n)
    x = centers[y] + rng.randn(n, d).astype(np.float32)
    return x.astype(np.float32), y.reshape(-1, 1).astype(np.int32)


def build_mlp(batch=64, dropout=0.0, seed=0):
    m = tff.FFModel(tff.FFConfig(batch_size=batch, device="cpu", seed=seed))
    t = m.create_tensor([batch, 784], tff.DataType.DT_FLOAT)
    h = m.dense(t, 512, tff.ActiMode.AC_MODE_RELU)
    if dropout:
        h = m.dropout(h, rate=dropout)
    h = m.dense(h, 512, tff.ActiMode.AC_MODE_RELU)
    m.softmax(m.dense(h, 10))
    return m


def _sgd(m, lr=0.01):
    return m.compile(optimizer=tff.SGDOptimizer(m, lr=lr),
                     loss_type=tff.LossType.
                     LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                     metrics=[tff.MetricsType.METRICS_ACCURACY])


def test_mlp_trains_to_high_accuracy():
    m = _sgd(build_mlp())
    x, y = make_synthetic_mnist()
    history = m.fit(x=x, y=y, epochs=3)
    assert history[-1]["accuracy"] > 0.90, history
    res = m.evaluate(x=x[:256], y=y[:256])
    assert res["accuracy"] > 0.90 and np.isfinite(res["loss"])
    preds = m.predict(x[:64])
    assert preds.shape == (64, 10)
    np.testing.assert_allclose(preds.sum(-1), 1.0, rtol=1e-4)


def test_mlp_adam_loss_decreases():
    m = build_mlp()
    x, y = make_synthetic_mnist(n=512)
    m.compile(optimizer=tff.AdamOptimizer(m, alpha=0.001),
              loss_type=tff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              metrics=[tff.MetricsType.METRICS_ACCURACY])
    first = m.train_one_batch([x[:64]], y[:64])
    for i in range(1, 8):
        last = m.train_one_batch([x[64 * i:64 * (i + 1)]],
                                 y[64 * i:64 * (i + 1)])
    assert last < first


def test_train_batches_equal_sequential_steps_bit_for_bit():
    """K steps through train_batches give K train_one_batch calls' losses,
    metrics and weights exactly, with dropout drawing from the model's
    seeded generator."""
    x, y = make_synthetic_mnist(n=256)

    def run(block):
        m = _sgd(build_mlp(batch=32, dropout=0.3))
        losses = []
        if block:
            for i in range(0, 256, 128):
                losses += m.train_batches(
                    [np.stack([x[j:j + 32] for j in range(i, i + 128, 32)])],
                    np.stack([y[j:j + 32] for j in range(i, i + 128, 32)]))
        else:
            for i in range(0, 256, 32):
                losses.append(m.train_one_batch([x[i:i + 32]], y[i:i + 32]))
        return (losses, m._metrics_summary(),
                m.get_parameter_by_key(("linear", "kernel")))

    seq, blk = run(False), run(True)
    assert seq[0] == blk[0] and seq[1] == blk[1]
    assert np.array_equal(seq[2], blk[2])
    other = _sgd(build_mlp(batch=32, dropout=0.3, seed=1))
    assert other.train_one_batch([x[:32]], y[:32]) != seq[0][0]


def test_fit_steps_per_call_trains_and_handles_tail():
    x, y = make_synthetic_mnist(n=224)      # 7 batches of 32: tail of 1
    m = _sgd(build_mlp(batch=32))
    hist = m.fit(x=x, y=y, epochs=4, steps_per_call=3)
    assert hist[-1]["accuracy"] > 0.9
    assert m.perf_metrics.train_all == 224


def test_manual_verbs_run_one_train_step():
    x, y = make_synthetic_mnist(n=64)
    a, b = _sgd(build_mlp()), _sgd(build_mlp())
    want = a.train_one_batch([x], y)
    b.zero_gradients()
    b.forward([x])
    b.backward()
    assert b.update(y) == want
    np.testing.assert_array_equal(b.get_parameter_by_key(("linear", "bias")),
                                  a.get_parameter_by_key(("linear", "bias")))
    with pytest.raises(ValueError):
        b.update()


def test_compile_modes():
    """compile() alone is inference (the serving callers'); an optimizer,
    a loss or comp_mode=TRAINING compiles for training."""
    m = build_mlp().compile()
    assert m.comp_mode == tff.CompMode.COMP_MODE_INFERENCE
    assert not any(p.requires_grad for lp in m.params.values()
                   for p in lp.values())
    with pytest.raises(RuntimeError):
        m.train_one_batch([np.zeros((64, 784), np.float32)],
                          np.zeros((64, 1), np.int32))
    for kw in (dict(loss_type=tff.LossType.LOSS_IDENTITY),
               dict(comp_mode=tff.CompMode.COMP_MODE_TRAINING)):
        m = build_mlp().compile(**kw)
        assert m.comp_mode == tff.CompMode.COMP_MODE_TRAINING
        assert all(p.requires_grad for lp in m.params.values()
                   for p in lp.values())
    q = build_mlp()
    q.config.quantization_type = "int8"
    _sgd(q)                         # quantization at init is inference-only
    assert all(isinstance(p, torch.Tensor) and p.requires_grad
               for lp in q.params.values() for p in lp.values())


def test_uniform_initializer_range():
    g = torch.Generator().manual_seed(0)
    w = tff.UniformInitializer(min_value=-0.5, max_value=2.0)(
        g, (1000,), torch.float32, "cpu")
    assert w.min() >= -0.5 and w.max() < 2.0 and w.std() > 0.5


def test_training_model_needs_cuda_when_asked_for_it():
    """The default device is cuda and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        tff.FFModel(tff.FFConfig())
