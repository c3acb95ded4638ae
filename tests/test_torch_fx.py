"""The port's torch.fx frontend (``flexflow_tpu_torch.torch``) against the
JAX package's (``flexflow_tpu.torch``), on the CPU.

Each module of the JAX package's fx tests is traced by both packages: the
IR is the same JSON lines, record for record. The port's FFModel, with
``copy_weights``, gives the module's own fp32 forward and the JAX model's
within rtol 1e-5 (atol 1e-5 of the output's largest magnitude, for the
entries near zero). With the JAX model's parameters carried across
(``convert.params_from_jax``), ``fit`` gives the JAX package's losses
within rtol 1e-5. An IR file written by either package loads in the
other. The tiny mT5 runs through HuggingFace's tracer where
``transformers`` imports.
"""

import sys

import numpy as np
import pytest
import torch
import torch.nn as nn

import flexflow_tpu as jff
from flexflow_tpu.torch import PyTorchModel as JPyTorchModel
from flexflow_tpu.torch import file_to_ff as jfile_to_ff
import flexflow_tpu_torch as tff
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.torch import PyTorchModel, file_to_ff

RTOL = 1e-5


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


# ----------------------------------------------------------------------
# the JAX package's fx test modules
# ----------------------------------------------------------------------
class MLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(20, 32)
        self.act = nn.ReLU()
        self.fc2 = nn.Linear(32, 8)
        self.sm = nn.Softmax(dim=-1)

    def forward(self, x):
        return self.sm(self.fc2(self.act(self.fc1(x))))


class CNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 4, 3)
        self.pool = nn.MaxPool2d(2)
        self.flatten = nn.Flatten()
        self.fc = nn.Linear(4 * 13 * 13, 6)

    def forward(self, x):
        x = torch.relu(self.conv1(x))
        x = self.pool(x)
        x = self.flatten(x)
        return self.fc(x)


class GroupedConv(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(8, 16, 3, groups=4, padding=1)

    def forward(self, x):
        return torch.relu(self.conv(x))


class ResidualBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(16, 16)
        self.ln = nn.LayerNorm(16)

    def forward(self, x):
        h = self.fc1(x) + x
        h = self.ln(h) * 2.0
        return h.relu()


class ReversedScalars(nn.Module):
    def forward(self, x):
        return 2.0 / (1.0 - torch.sigmoid(x))


class BertPooler(nn.Module):
    def __init__(self):
        super().__init__()
        self.emb = nn.Embedding(100, 32)
        self.ln = nn.LayerNorm(32)
        self.fc = nn.Linear(64, 8)

    def forward(self, ids):
        x = self.ln(self.emb(ids))
        cls = x[:, 0]
        pooled = x.mean(dim=1)
        z = torch.cat([cls, pooled], dim=-1)
        z = z.unsqueeze(1).squeeze(1)
        return torch.softmax(self.fc(z), dim=-1)


class MhaTupleIndex(nn.Module):
    def __init__(self):
        super().__init__()
        self.mha = nn.MultiheadAttention(16, 4, batch_first=True)
        self.fc = nn.Linear(16, 4)

    def forward(self, x):
        out, _ = self.mha(x, x, x)
        return self.fc(out.mean(1, True)).squeeze(dim=1)


class EdgeSemantics(nn.Module):
    def forward(self, x):
        a = x.softmax(1)
        b = a.squeeze(dim=1)
        return b.mean(-1, True).squeeze(2)


class CatPositionalDim(nn.Module):
    def forward(self, x):
        return torch.cat([x, torch.relu(x)], 1)


class NameCollision(nn.Module):
    def __init__(self):
        super().__init__()
        self.x = nn.Linear(4, 4)

    def forward(self, x):
        return self.x(x) + x


class Encoder(nn.Module):
    """A BERT encoder layer (embedding, batch-first MHA, post-LN residuals,
    GELU MLP) with the CLS row through a Linear head."""

    def __init__(self, vocab=50, hidden=32, heads=4):
        super().__init__()
        self.emb = nn.Embedding(vocab, hidden)
        self.mha = nn.MultiheadAttention(hidden, heads, batch_first=True)
        self.ln1 = nn.LayerNorm(hidden)
        self.fc1 = nn.Linear(hidden, 2 * hidden)
        self.act = nn.GELU()
        self.fc2 = nn.Linear(2 * hidden, hidden)
        self.ln2 = nn.LayerNorm(hidden)
        self.head = nn.Linear(hidden, 5)

    def forward(self, ids):
        x = self.emb(ids)
        a, _ = self.mha(x, x, x)
        x = self.ln1(x + a)
        x = self.ln2(x + self.fc2(self.act(self.fc1(x))))
        return self.head(x[:, 0])


def sequential():
    return nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))


# name: (module factory, input shape, int input vocab or None)
CASES = {
    "mlp": (MLP, (16, 20), None),
    "cnn": (CNN, (8, 1, 28, 28), None),
    "grouped_conv": (GroupedConv, (4, 8, 10, 10), None),
    "residual_scalar_layernorm": (ResidualBlock, (8, 16), None),
    "reversed_scalars": (ReversedScalars, (8, 16), None),
    "bert_pooler": (BertPooler, (8, 12), 100),
    "mha_tuple_getitem": (MhaTupleIndex, (4, 6, 16), None),
    "positional_softmax_noop_squeeze": (EdgeSemantics, (4, 3, 4), None),
    "cat_positional_dim": (CatPositionalDim, (4, 8), None),
    "sequential_integer_children": (sequential, (4, 8), None),
    "name_collides_with_forward_arg": (NameCollision, (4, 4), None),
    "encoder_mha": (Encoder, (4, 10), 50),
}
# copy_weights of the JAX package stops at an MHA's out_proj (a Linear
# with no layer of its own); the port copies the attention's weights
NO_JAX_COPY = {"mha_tuple_getitem", "encoder_mha"}


def make(case, seed=0):
    factory, shape, vocab = CASES[case]
    torch.manual_seed(seed)
    module = factory().eval()
    rng = np.random.RandomState(seed)
    if vocab:
        x = rng.randint(0, vocab, shape).astype(np.int32)
    else:
        x = rng.randn(*shape).astype(np.float32)
    return module, x


def module_forward(module, x):
    t = torch.from_numpy(x.astype(np.int64) if x.dtype == np.int32 else x)
    with torch.no_grad():
        return module(t).numpy()


def build(ff, pm, x, **config):
    if ff is tff:
        config["device"] = "cpu"
    m = ff.FFModel(ff.FFConfig(batch_size=x.shape[0], **config))
    dt = ff.DataType.DT_INT32 if x.dtype == np.int32 \
        else ff.DataType.DT_FLOAT
    t = m.create_tensor(list(x.shape), dt)
    outs = pm.torch_to_ff(m, [t])
    assert len(outs) == 1
    return m, outs


def ir_lines(pm):
    return [n.to_json() for n in pm.to_ir()]


# ----------------------------------------------------------------------
# the IR
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(CASES))
def test_ir_equals_jax(case):
    module, _ = make(case)
    assert ir_lines(PyTorchModel(module)) == ir_lines(JPyTorchModel(module))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_ir_file_loads_in_the_other_package(tmp_path, writer):
    """A file written by ``torch_to_file`` in one package builds in the
    other the layers the writer builds from its own trace, and with the
    same weights gives the same outputs."""
    module, x = make("cnn", seed=3)
    pkgs = {"port": (tff, PyTorchModel, file_to_ff),
            "jax": (jff, JPyTorchModel, jfile_to_ff)}
    path = tmp_path / "cnn.ir"
    pkgs[writer][1](module).torch_to_file(str(path))
    models = {}
    for name, (ff, cls, load) in pkgs.items():
        cfg = {"device": "cpu"} if ff is tff else {}
        m = ff.FFModel(ff.FFConfig(batch_size=x.shape[0], **cfg))
        t = m.create_tensor(list(x.shape), ff.DataType.DT_FLOAT)
        outs = (cls(module).torch_to_ff(m, [t]) if name == writer
                else load(str(path), m, [t]))
        assert outs[0].dims == (x.shape[0], 6)
        m.compile()
        cls(module).copy_weights(m)
        models[name] = m
    assert [(l.name, l.op_type.name, l.outputs[0].dims)
            for l in models["port"].layers] == \
        [(l.name, l.op_type.name, l.outputs[0].dims)
         for l in models["jax"].layers]
    close(models["port"].predict(x), np.asarray(models["jax"].predict(x)))


# ----------------------------------------------------------------------
# forwards with copy_weights
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_module_and_jax(case):
    module, x = make(case, seed=1)
    want = module_forward(module, x)
    pm = PyTorchModel(module)
    m, outs = build(tff, pm, x)
    assert outs[0].dims == want.shape
    m.compile()
    pm.copy_weights(m)
    got = m.predict(x)
    close(got, want)
    if case in NO_JAX_COPY:
        return
    jpm = JPyTorchModel(module)
    jm, _ = build(jff, jpm, x)
    jm.compile()
    jpm.copy_weights(jm)
    close(got, np.asarray(jm.predict(x)))


def test_jax_copy_weights_stops_at_mha_out_proj():
    """Why NO_JAX_COPY: the JAX package's copy walks into the attention's
    out_proj, which has no layer of its own."""
    module, x = make("mha_tuple_getitem")
    jpm = JPyTorchModel(module)
    jm, _ = build(jff, jpm, x)
    jm.compile()
    with pytest.raises(KeyError, match="mha_out_proj"):
        jpm.copy_weights(jm)


def test_copy_weights_takes_bf16_and_keeps_the_model_dtype():
    """Parameters copy as tensors: a bf16 module copies into the fp32
    model without a numpy round trip (numpy has no bfloat16)."""
    module, x = make("mlp", seed=2)
    module = module.to(torch.bfloat16)
    pm = PyTorchModel(module)
    m, _ = build(tff, pm, x)
    m.compile()
    pm.copy_weights(m)
    assert m.params["fc1"]["kernel"].dtype == torch.float32
    np.testing.assert_array_equal(
        m.get_parameter_by_key(("fc1", "kernel")),
        module.fc1.weight.detach().float().T.numpy())
    np.testing.assert_array_equal(
        m.get_parameter_by_key(("fc2", "bias")),
        module.fc2.bias.detach().float().numpy())


def test_out_of_range_index_raises_at_build():
    class Bad(nn.Module):
        def forward(self, x):
            return x[:, 50]

    m = tff.FFModel(tff.FFConfig(batch_size=2, device="cpu"))
    t = m.create_tensor([2, 12, 4], tff.DataType.DT_FLOAT)
    with pytest.raises(IndexError, match="squeeze dim"):
        PyTorchModel(Bad()).torch_to_ff(m, [t])


def test_mha_batch_first_false_rejected():
    """The [S, B, E] default layout would swap batch and sequence against
    the batch-first builder: both packages refuse it."""
    class DefaultMHA(nn.Module):
        def __init__(self):
            super().__init__()
            self.mha = nn.MultiheadAttention(16, 4)

        def forward(self, x):
            out, _ = self.mha(x, x, x)
            return out

    for cls in (PyTorchModel, JPyTorchModel):
        with pytest.raises(NotImplementedError, match="batch_first"):
            cls(DefaultMHA()).to_ir()


def test_slice_op_semantics():
    """The builder the getitem lowering emits, against numpy and the JAX
    package."""
    x = np.random.RandomState(0).randn(4, 6, 8).astype(np.float32)
    outs = []
    for ff in (jff, tff):
        cfg = {"device": "cpu"} if ff is tff else {}
        m = ff.FFModel(ff.FFConfig(batch_size=4, **cfg))
        t = m.create_tensor([4, 6, 8], ff.DataType.DT_FLOAT)
        s = m.slice_tensor(t, [None, 1, 2], [None, 4, -1])
        assert s.dims == (4, 3, 5)
        c = m.slice_tensor(t, [None, 0, None], [None, 1, None],
                           squeeze_dims=[1])
        m.concat([m.flat(s), c], axis=1)
        m.compile()
        outs.append(np.asarray(m.predict(x)))
    want = np.concatenate([x[:, 1:4, 2:-1].reshape(4, -1), x[:, 0, :]],
                          axis=1)
    np.testing.assert_array_equal(outs[1], want)
    np.testing.assert_array_equal(outs[1], outs[0])


# ----------------------------------------------------------------------
# training with the JAX model's parameters carried across
# ----------------------------------------------------------------------
def _fit_twins(case, head_softmax, epochs, lr, seed):
    module, x1 = make(case, seed=seed)
    rng = np.random.RandomState(seed)
    n = 4 * x1.shape[0]
    x = (rng.randn(n, *x1.shape[1:]).astype(np.float32)
         if x1.dtype == np.float32 else
         rng.randint(0, CASES[case][2], (n,) + x1.shape[1:]).astype(np.int32))
    classes = module_forward(module, x1).shape[-1]
    y = rng.randint(0, classes, (n, 1)).astype(np.int32)
    models = {}
    for ff, cls in ((jff, JPyTorchModel), (tff, PyTorchModel)):
        m, outs = build(ff, cls(module), x1)
        if head_softmax:
            m.softmax(outs[0])
        m.compile(optimizer=ff.SGDOptimizer(m, lr=lr),
                  loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                  metrics=[ff.MetricsType.METRICS_ACCURACY])
        models[ff] = m
    load_params(models[tff], params_from_jax(models[jff].params))
    return {ff: m.fit(x, y, epochs=epochs) for ff, m in models.items()}


@pytest.mark.parametrize("case,head_softmax", [
    ("mlp", False), ("cnn", True), ("sequential_integer_children", True),
    ("bert_pooler", False), ("residual_scalar_layernorm", True)])
def test_fit_losses_match_jax(case, head_softmax):
    hists = _fit_twins(case, head_softmax, epochs=3, lr=0.1, seed=4)
    jl = [h["loss"] for h in hists[jff]]
    tl = [h["loss"] for h in hists[tff]]
    np.testing.assert_allclose(tl, jl, rtol=RTOL)
    assert [h["accuracy"] for h in hists[tff]] == pytest.approx(
        [h["accuracy"] for h in hists[jff]], abs=1e-6)


def test_translated_mlp_learns():
    """The JAX test's learnable task: the translated MLP's loss falls."""
    rng = np.random.RandomState(0)
    w = rng.randn(20, 4)
    x = rng.randn(256, 20).astype(np.float32)
    y = np.argmax(x @ w, axis=1).reshape(-1, 1).astype(np.int32)
    pm = PyTorchModel(MLP())
    m = tff.FFModel(tff.FFConfig(batch_size=32, device="cpu"))
    t = m.create_tensor([32, 20], tff.DataType.DT_FLOAT)
    pm.torch_to_ff(m, [t])
    m.compile(optimizer=tff.SGDOptimizer(m, lr=0.1),
              loss_type=tff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
              metrics=[tff.MetricsType.METRICS_ACCURACY])
    hist = m.fit(x, y, epochs=6)
    assert hist[-1]["loss"] < hist[0]["loss"]


# ----------------------------------------------------------------------
# mT5 through HuggingFace's tracer
# ----------------------------------------------------------------------
B, S_ENC, S_DEC, MT5_VOCAB = 2, 10, 8, 250
MT5_INPUTS = ["input_ids", "attention_mask", "decoder_input_ids"]


@pytest.fixture(scope="module")
def tiny_mt5():
    pytest.importorskip("transformers")
    from transformers import MT5Config, MT5ForConditionalGeneration

    torch.manual_seed(0)
    cfg = MT5Config(vocab_size=MT5_VOCAB, d_model=64, d_kv=16, d_ff=128,
                    num_layers=2, num_decoder_layers=2, num_heads=4,
                    decoder_start_token_id=0, dropout_rate=0.0)
    m = MT5ForConditionalGeneration(cfg)
    m.eval()
    return m


def _mt5_pm(cls, mt5):
    return cls(mt5, is_hf_model=True, batch_size=B, input_names=MT5_INPUTS,
               seq_length=(S_ENC, S_DEC))


def _mt5_model(ff, pm=None, path=None):
    cfg = {"device": "cpu"} if ff is tff else {}
    fm = ff.FFModel(ff.FFConfig(batch_size=B, **cfg))
    ins = [fm.create_tensor([B, S_ENC], ff.DataType.DT_INT32),
           fm.create_tensor([B, S_ENC], ff.DataType.DT_INT32),
           fm.create_tensor([B, S_DEC], ff.DataType.DT_INT32)]
    load = file_to_ff if ff is tff else jfile_to_ff
    outs = (pm.torch_to_ff(fm, ins) if path is None
            else load(str(path), fm, ins))
    assert len(outs) == 1 and outs[0].dims == (B, S_DEC, MT5_VOCAB)
    fm.softmax(fm.reshape(outs[0], [B * S_DEC, MT5_VOCAB]))
    return fm


def _mt5_batch(seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, MT5_VOCAB, size=(B, S_ENC)).astype(np.int32),
            np.ones((B, S_ENC), np.int32),
            rng.randint(1, MT5_VOCAB, size=(B, S_DEC)).astype(np.int32)]


def test_mt5_ir_equals_jax_and_loads_in_the_port(tiny_mt5, tmp_path):
    jpm = _mt5_pm(JPyTorchModel, tiny_mt5)
    pm = _mt5_pm(PyTorchModel, tiny_mt5)
    assert ir_lines(pm) == ir_lines(jpm)
    path = tmp_path / "mt5.ir"
    jpm.torch_to_file(str(path))
    _mt5_model(tff, path=path)


def test_mt5_forward_matches_torch(tiny_mt5):
    pm = _mt5_pm(PyTorchModel, tiny_mt5)
    fm = _mt5_model(tff, pm)
    fm.compile()
    pm.copy_weights(fm)
    ids, mask, dec = _mt5_batch(0)
    with torch.no_grad():
        logits = tiny_mt5(input_ids=torch.tensor(ids, dtype=torch.long),
                          attention_mask=torch.tensor(mask,
                                                      dtype=torch.long),
                          decoder_input_ids=torch.tensor(
                              dec, dtype=torch.long)).logits
    want = torch.softmax(logits, dim=-1).numpy().reshape(B * S_DEC,
                                                         MT5_VOCAB)
    close(fm.predict([ids, mask, dec]), want)


def test_mt5_train_steps_match_jax(tiny_mt5):
    """Three SGD steps from the JAX model's parameters (the free-standing
    T5LayerNorm WEIGHT parameters among them) give the JAX losses, and
    the layer-norm weights move."""
    models = {}
    for ff, cls in ((jff, JPyTorchModel), (tff, PyTorchModel)):
        fm = _mt5_model(ff, _mt5_pm(cls, tiny_mt5))
        fm.compile(optimizer=ff.SGDOptimizer(fm, lr=0.1),
                   loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
        models[ff] = fm
    load_params(models[tff], params_from_jax(models[jff].params))
    ln = sorted(n for n in models[tff].params if "layer_norm" in n)
    assert ln, "no free-standing T5LayerNorm parameter translated"
    before = models[tff].get_parameter_by_key((ln[0], "weight"))
    xs = _mt5_batch(1)
    labels = np.random.RandomState(1).randint(
        0, MT5_VOCAB, (B * S_DEC, 1)).astype(np.int32)
    losses = {ff: [float(m.train_one_batch(xs, labels)) for _ in range(3)]
              for ff, m in models.items()}
    np.testing.assert_allclose(losses[tff], losses[jff], rtol=RTOL)
    assert not np.allclose(before,
                           models[tff].get_parameter_by_key((ln[0],
                                                             "weight")))


# ----------------------------------------------------------------------
# the package attribute ``torch``
# ----------------------------------------------------------------------
def test_torch_subpackage_does_not_shadow_pytorch():
    """Importing the frontend sets ``flexflow_tpu_torch.torch`` to the
    subpackage; ``import torch`` in every port module still gives
    PyTorch."""
    import flexflow_tpu_torch
    import flexflow_tpu_torch.torch.model as fxmodel

    assert fxmodel.torch is sys.modules["torch"]
    assert flexflow_tpu_torch.torch.__name__ == "flexflow_tpu_torch.torch"
    for name, mod in list(sys.modules.items()):
        if name.startswith("flexflow_tpu_torch") and \
                "torch" in vars(mod) and name != "flexflow_tpu_torch":
            assert mod.torch is sys.modules["torch"], name
