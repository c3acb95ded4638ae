"""The port's Keras frontend (``flexflow_tpu_torch.keras``) against the JAX
package's (``flexflow_tpu.keras``), on the CPU.

Each model of the JAX package's Keras tests is built by both packages from
one builder (``k`` is either ``keras`` module); the port's layers take the
JAX layers' weights through ``get_weights``/``set_weights``, and ``fit``
histories and ``predict`` outputs are held to the JAX package's within
rtol 1e-5. The synthetic datasets are the JAX package's arrays, bit for
bit. Keras layer names come from a process-wide counter in each package,
so the two models' layers are paired by position, not by name.
"""

import numpy as np
import pytest

import flexflow_tpu.keras as jkeras
from flexflow_tpu.config import FFConfig as JFFConfig
import flexflow_tpu_torch.keras as tkeras
from flexflow_tpu_torch.config import FFConfig as TFFConfig
from flexflow_tpu_torch.keras.layers import _conv_padding

RTOL = 1e-5
B = 32


def config(k, **kw):
    if k is tkeras:
        return TFFConfig(batch_size=B, device="cpu", **kw)
    return JFFConfig(batch_size=B, **kw)


def mlp_data(n=128, din=20, classes=4, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(din, classes)
    x = rng.randn(n, din).astype(np.float32)
    y = np.argmax(x @ w + 0.1 * rng.randn(n, classes), axis=1)
    return x, y.reshape(-1, 1).astype(np.int32)


def seq_mlp(k, reg=None):
    m = k.models.Sequential(ffconfig=config(k))
    m.add(k.layers.Dense(64, activation="relu", input_shape=(20,),
                         kernel_regularizer=reg))
    m.add(k.layers.Dense(4, activation="softmax"))
    m.compile(optimizer=k.optimizers.SGD(learning_rate=0.1),
              loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    return m


def functional_merge(k):
    L = k.layers
    inp = L.Input(shape=(20,))
    a = L.Dense(32, activation="relu")(inp)
    b = L.Dense(32, activation="tanh")(inp)
    merged = L.Concatenate(axis=1)([a, b])
    summed = L.Add()([a, b])
    joined = L.Concatenate(axis=1)([merged, summed])
    out = L.Dense(4, activation="softmax")(joined)
    m = k.models.Model(inputs=inp, outputs=out, ffconfig=config(k))
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    return m


def cnn(k):
    """The JAX test's CNN without its Dropout (the two packages draw
    different masks)."""
    L = k.layers
    m = k.models.Sequential(ffconfig=config(k))
    m.add(L.Conv2D(8, (3, 3), strides=(1, 1), padding="valid",
                   activation="relu", input_shape=(1, 28, 28)))
    m.add(L.MaxPooling2D(pool_size=(2, 2)))
    m.add(L.Conv2D(16, (3, 3), activation="relu"))
    m.add(L.AveragePooling2D(pool_size=(2, 2)))
    m.add(L.Flatten())
    m.add(L.Dense(32, activation="relu"))
    m.add(L.Dense(10, activation="softmax"))
    m.compile(optimizer=k.optimizers.SGD(learning_rate=0.05),
              loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    return m


def embedding_reshape(k):
    L = k.layers
    m = k.models.Sequential(ffconfig=config(k))
    m.add(L.Embedding(50, 16, input_shape=(8,)))
    m.add(L.Reshape((16, 8)))
    m.add(L.Permute((2, 1)))
    m.add(L.Flatten())
    m.add(L.Dense(3, activation="softmax"))
    m.compile(optimizer="adam", loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    return m


def activations(k):
    L = k.layers
    inp = L.Input(shape=(20,))
    h = L.Activation("relu")(L.Dense(32)(inp))
    h = L.BatchNormalization()(L.Reshape((32, 1, 1))(h))
    out = L.Activation("softmax")(L.Dense(4)(L.Flatten()(h)))
    m = k.models.Model(inputs=inp, outputs=out, ffconfig=config(k))
    m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    return m


def backend_ops(k):
    """keras.backend's sum and rsqrt (the reduce_sum and rsqrt examples)
    on a Dense branch."""
    L = k.layers
    inp = L.Input(shape=(20,))
    h = L.Dense(8, activation="sigmoid")(inp)
    s = k.backend.sum(L.Reshape((2, 4))(h), axis=2, keepdims=False)
    r = k.backend.rsqrt(L.Dense(6, activation="sigmoid")(inp))
    out = L.Dense(4, activation="softmax")(L.Concatenate(axis=1)([s, r]))
    m = k.models.Model(inputs=inp, outputs=out, ffconfig=config(k))
    m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    return m


def data(name):
    if name == "cnn":
        (x, y), _ = jkeras.datasets.mnist.load_data(n_train=96, n_test=16)
        return ((x.astype(np.float32) / 255.0).reshape(-1, 1, 28, 28),
                y.reshape(-1, 1).astype(np.int32))
    if name == "embedding_reshape":
        rng = np.random.RandomState(0)
        x = rng.randint(0, 50, size=(64, 8)).astype(np.int32)
        return x, (x.sum(axis=1) % 3).reshape(-1, 1).astype(np.int32)
    return mlp_data()


MODELS = {"seq_mlp": seq_mlp, "functional_merge": functional_merge,
          "cnn": cnn, "embedding_reshape": embedding_reshape,
          "activations_batchnorm": activations, "backend_ops": backend_ops}


def twins(build):
    """(JAX model, port model) built alike, the port's layers holding the
    JAX layers' weights."""
    jm, tm = build(jkeras), build(tkeras)
    assert len(jm.layers) == len(tm.layers)
    for jl, tl in zip(jm.layers, tm.layers):
        assert type(jl).__name__ == type(tl).__name__
        tl.set_weights(jl.get_weights())
    return jm, tm


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fit_and_predict_match_jax(name):
    x, y = data(name)
    jm, tm = twins(MODELS[name])
    np.testing.assert_allclose(tm.predict(x[:40]),
                               np.asarray(jm.predict(x[:40])), rtol=RTOL,
                               atol=RTOL)
    jh, th = jm.fit(x, y, epochs=3), tm.fit(x, y, epochs=3)
    assert set(th.history) == set(jh.history)
    for key in jh.history:
        np.testing.assert_allclose(th.history[key], jh.history[key],
                                   rtol=RTOL, err_msg=key)
    assert th.history["loss"][-1] < th.history["loss"][0]
    got = tm.predict(x[:40])                # 40 = one batch and a tail
    assert got.shape == (40, tm.output.shape[-1])
    np.testing.assert_allclose(got, np.asarray(jm.predict(x[:40])),
                               rtol=RTOL, atol=RTOL)
    ev = {p: m.evaluate(x, y) for p, m in (("jax", jm), ("port", tm))}
    assert ev["port"]["loss"] == pytest.approx(ev["jax"]["loss"], rel=RTOL)


def test_dropout_model_trains():
    """The JAX test's CNN with its Dropout(0.1): the port's loss falls."""
    x, y = data("cnn")
    L = tkeras.layers
    m = tkeras.models.Sequential(ffconfig=config(tkeras))
    m.add(L.Conv2D(8, (3, 3), activation="relu", input_shape=(1, 28, 28)))
    m.add(L.MaxPooling2D(pool_size=(2, 2)))
    m.add(L.Flatten())
    m.add(L.Dropout(0.1))
    m.add(L.Dense(10, activation="softmax"))
    m.compile(optimizer=tkeras.optimizers.SGD(learning_rate=0.05),
              loss="sparse_categorical_crossentropy", metrics=["accuracy"])
    assert m.output.shape == (None, 10)
    hist = m.fit(x, y, epochs=3)
    assert hist.history["loss"][-1] < hist.history["loss"][0]


def test_callbacks_and_lr_schedule_match_jax():
    x, y = mlp_data()
    runs = {}
    for k, m in zip((jkeras, tkeras), twins(seq_mlp)):
        seen = []

        def schedule(epoch, seen=seen):
            seen.append(0.1 * 0.5 ** epoch)
            return seen[-1]

        cb = k.callbacks
        hist = m.fit(x, y, epochs=3, callbacks=[
            cb.LearningRateScheduler(schedule),
            cb.VerifyMetrics(accuracy_threshold=0.25),
            cb.EpochVerifyMetrics(accuracy_threshold=0.0)])
        runs[k] = (seen, hist.history,
                   float(m.ffmodel.opt_state["lr"]),
                   m.optimizer.learning_rate)
    assert runs[tkeras][0] == runs[jkeras][0] == [0.1, 0.05, 0.025]
    np.testing.assert_allclose(runs[tkeras][1]["loss"],
                               runs[jkeras][1]["loss"], rtol=RTOL)
    assert runs[tkeras][2] == pytest.approx(0.025)
    assert runs[tkeras][3] == runs[jkeras][3] == 0.025


@pytest.mark.parametrize("callback", ["VerifyMetrics", "EpochVerifyMetrics"])
def test_verify_callbacks_raise_below_threshold(callback):
    x, y = mlp_data()
    m = seq_mlp(tkeras)
    with pytest.raises(AssertionError, match="below threshold"):
        m.fit(x, y, epochs=1, callbacks=[
            getattr(tkeras.callbacks, callback)(accuracy_threshold=1.01)])


def test_get_set_weights_roundtrip():
    m = tkeras.models.Sequential(ffconfig=config(tkeras))
    d1 = tkeras.layers.Dense(16, activation="relu", input_shape=(20,))
    m.add(d1)
    m.add(tkeras.layers.Dense(4, activation="softmax"))
    m.compile(optimizer="sgd", loss="sparse_categorical_crossentropy",
              metrics=["accuracy"])
    w = d1.get_weights()
    assert w[0].shape == (20, 16) and w[1].shape == (16,)
    new_kernel = np.arange(20 * 16, dtype=np.float32).reshape(20, 16)
    d1.set_weights([new_kernel, w[1]])
    np.testing.assert_array_equal(d1.get_weights()[0], new_kernel)
    assert d1.count_params() == 20 * 16 + 16
    text = m.summary(print_fn=lambda s: None)
    assert "Total params: 404" in text and "dense" in text
    with pytest.raises(ValueError, match="expected 2 arrays"):
        d1.set_weights([new_kernel])


def test_kernel_regularizer_matches_jax():
    """The L2 penalty enters the loss: from the same weights, a model with
    it and one without differ by exactly the penalty, and the port's
    losses are the JAX package's; a zero L1L2 is a no-op and a bad kind
    raises."""
    x, y = mlp_data()
    lam = 0.05
    jm, tm = twins(lambda k: seq_mlp(k, k.regularizers.l2(lam)))
    plain = {}
    for k in (jkeras, tkeras):
        plain[k] = seq_mlp(k)
        for jl, pl in zip(jm.layers, plain[k].layers):
            pl.set_weights(jl.get_weights())
    w = jm.layers[0].get_weights()[0].astype(np.float64)
    losses = {name: [float(m.ffmodel.train_one_batch([x[:B]], y[:B]))
                     for m in pair]
              for name, pair in (("l2", (jm, tm)),
                                 ("plain", (plain[jkeras], plain[tkeras])))}
    for name, (jl, tl) in losses.items():
        assert tl == pytest.approx(jl, rel=RTOL), name
    np.testing.assert_allclose(losses["l2"][1] - losses["plain"][1],
                               lam * np.sum(w ** 2), rtol=1e-4)
    seq_mlp(tkeras, tkeras.regularizers.L1L2())
    with pytest.raises(ValueError, match="unknown regularizer"):
        seq_mlp(tkeras, [("l3", 0.1)])


def test_default_config_is_the_card():
    """A model built without an ffconfig compiles on ``FFConfig()``: the
    card, which this CPU host lacks."""
    m = tkeras.models.Sequential()
    m.add(tkeras.layers.Dense(4, input_shape=(20,)))
    with pytest.raises(RuntimeError, match="cuda"):
        m.compile(optimizer="sgd", loss="mse")
    assert m.ffconfig.device == "cuda"


@pytest.mark.parametrize("name,kw", [
    ("mnist", dict(n_train=64, n_test=16)),
    ("cifar10", dict(n_train=32, n_test=8)),
    ("cifar100", dict(label_mode="fine", n_train=32, n_test=8)),
    ("cifar100", dict(label_mode="coarse", n_train=32, n_test=8)),
    ("reuters", dict(n_train=16, n_test=4, num_words=200, maxlen=20))])
def test_datasets_equal_jax(name, kw):
    (txs, tys), (txt, tyt) = getattr(tkeras.datasets, name).load_data(**kw)
    (jxs, jys), (jxt, jyt) = getattr(jkeras.datasets, name).load_data(**kw)
    for got, want in ((txs, jxs), (tys, jys), (txt, jxt), (tyt, jyt)):
        assert got.dtype == want.dtype and got.shape == want.shape
        if got.dtype == object:
            assert [list(a) for a in got] == [list(a) for a in want]
        else:
            np.testing.assert_array_equal(got, want)


def test_preprocessing_and_utils_equal_jax():
    seqs = [[1, 2], [3, 4, 5, 6], [7]]
    for kw in ({"maxlen": 3}, {"maxlen": 3, "padding": "post"},
               {"maxlen": 2, "truncating": "post"}, {}):
        np.testing.assert_array_equal(
            tkeras.preprocessing.sequence.pad_sequences(seqs, **kw),
            jkeras.preprocessing.sequence.pad_sequences(seqs, **kw))
    np.testing.assert_array_equal(
        tkeras.preprocessing.sequence.pad_sequences([[1, 2], [3, 4, 5, 6]],
                                                    maxlen=3),
        [[0, 1, 2], [4, 5, 6]])
    np.testing.assert_array_equal(
        tkeras.utils.to_categorical([0, 2, 1], num_classes=3),
        jkeras.utils.to_categorical([0, 2, 1], num_classes=3))


def test_same_padding_semantics():
    assert _conv_padding("same", 3, 3, 1, 1, 8, 8) == (1, 1)
    assert _conv_padding("same", 2, 2, 2, 2, 8, 8) == (0, 0)
    with pytest.raises(NotImplementedError, match="asymmetric"):
        _conv_padding("same", 3, 3, 2, 2, 224, 224)


@pytest.mark.parametrize("name", ["DefaultInitializer", "Zeros", "Constant",
                                  "GlorotUniform", "RandomUniform",
                                  "RandomNormal"])
def test_initializers_lower_as_jax(name):
    """Each Keras initializer lowers to the core initializer of the same
    name and fields; the core constructors take the JAX arguments."""
    import inspect

    args = {"Constant": (0.5,), "GlorotUniform": (7,),
            "RandomUniform": (-0.1, 0.2, 3),
            "RandomNormal": (0.1, 0.3, 4)}.get(name, ())
    got = getattr(tkeras.initializers, name)(*args).to_core()
    want = getattr(jkeras.initializers, name)(*args).to_core()
    assert type(got).__name__ == type(want).__name__
    if want is not None:
        assert vars(got) == vars(want)
        assert list(inspect.signature(type(got)).parameters) == \
            list(inspect.signature(type(want)).parameters)


def test_conv_kernel_glorot_counts_the_receptive_field():
    """A conv kernel [O, I, kh, kw] is drawn from U(-a, a) with a =
    sqrt(6 / ((I + O) kh kw)), the JAX package's bound."""
    import torch

    from flexflow_tpu_torch.core.initializer import GlorotUniformInitializer

    a = float(np.sqrt(6.0 / ((8 + 16) * 9)))
    w = GlorotUniformInitializer()(torch.Generator().manual_seed(0),
                                   (16, 8, 3, 3), torch.float32, "cpu")
    assert float(w.abs().max()) <= a
    assert float(w.abs().max()) > 0.95 * a
    assert float(w.std()) == pytest.approx(a / np.sqrt(3.0), rel=0.1)
