"""The port's native C graph builder (``flexflow_tpu_torch.native.
graph_builder`` over ``native/src/graph_builder.cpp``) against the JAX
package's binding of the same C source, on the CPU.

Graphs described through the ``ffgb_*`` ABI serialize to the same IR text
in both packages (where the JAX package's library loads: it builds
without a lock, beside other test processes, and falls back to None on a
failed build). Built on the port's FFModel through its fx frontend's
``ir_to_ff``, and on the JAX package's from the same IR text, with the
JAX model's parameters carried across, they train with the JAX package's
losses within rtol 1e-5. Bad node ids and bad arguments raise, and a
library that cannot build raises ``NativeBuildError``.
"""

import numpy as np
import pytest

import flexflow_tpu as jff
from flexflow_tpu.native.graph_builder import \
    NativeGraphBuilder as JNativeGraphBuilder
from flexflow_tpu.torch.model import IRNode as JIRNode
from flexflow_tpu.torch.model import file_to_ff as jfile_to_ff
from flexflow_tpu.torch.model import ir_to_ff as jir_to_ff
import flexflow_tpu_torch as tff
from flexflow_tpu_torch import native
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.native.graph_builder import NativeGraphBuilder
from flexflow_tpu_torch.torch.model import file_to_ff

RTOL = 1e-5
B = 8


def jax_builder():
    try:
        return JNativeGraphBuilder()
    except RuntimeError as e:
        pytest.skip(f"the JAX package's native library did not load: {e}")


def transformer_block(gb):
    """``tests/test_native.py``'s encoder block from C: embedding -> MHA
    -> residual layer_norm -> GELU MLP -> rms_norm -> scalar -> mean ->
    head."""
    toks = gb.input(0)
    h = gb.embedding(toks, 64, 32, name="embed")
    a = gb.multihead_attention(h, h, h, 32, 4, name="attn")
    h = gb.layer_norm(gb.binary(h, a, "add"), [32], name="ln1")
    f = gb.unary(gb.dense(h, 64, name="up"), "gelu")
    h = gb.rms_norm(gb.binary(h, gb.dense(f, 32, name="down"), "add"),
                    eps=1e-6, name="rn")
    h = gb.scalar(h, "multiply", 0.5, name="halve")
    h = gb.mean(h, [1], name="pool")
    gb.output([gb.softmax(gb.dense(h, 4, name="head"))])
    return gb


def residual_mlp(gb):
    """``tests/test_native.py``'s first graph: a residual MLP."""
    x = gb.input(0)
    h = gb.unary(gb.dense(x, 32, name="fc1"), "relu")
    s = gb.binary(h, gb.dense(h, 32, name="fc2"), "add")
    gb.output([gb.softmax(gb.dense(s, 4, name="head"))])
    return gb


def conv_net(gb):
    x = gb.input(0)
    c = gb.conv2d(x, 8, 3, 3, 1, 1, 1, 1, name="conv")
    p = gb.pool2d(gb.unary(c, "relu"), 2, 2, 2, 2)
    b = gb.batch_norm(p, name="bn")
    f = gb.unary(gb.transpose(b, [0, 1, 3, 2], name="tr"), "flat")
    d = gb.dropout(gb.cast(f, "float32"), 0.0, name="drop")
    cat = gb.concat([d, d], 1, name="cat")
    r = gb.reshape(cat, [4, 256], name="rs")
    gb.output([gb.softmax(gb.dense(r, 10))])
    return gb


GRAPHS = {"transformer_block": (transformer_block, [B, 6], "int"),
          "residual_mlp": (residual_mlp, [B, 16], "float"),
          "conv_net": (conv_net, [4, 3, 8, 8], "float")}


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_ir_text_equals_jax(name):
    describe = GRAPHS[name][0]
    text = describe(NativeGraphBuilder()).serialize()
    assert text == describe(jax_builder()).serialize()
    assert text.splitlines()[-1].startswith('{"op": "output"')


def _built(ff, name, gb):
    """The C-built graph on ``ff``'s FFModel: the port's through
    ``build_on``, the JAX package's through its ``ir_to_ff`` on the same
    IR text."""
    _, shape, kind = GRAPHS[name]
    cfg = {"device": "cpu"} if ff is tff else {}
    m = ff.FFModel(ff.FFConfig(batch_size=shape[0], **cfg))
    dt = ff.DataType.DT_INT32 if kind == "int" else ff.DataType.DT_FLOAT
    t = m.create_tensor(shape, dt)
    if ff is tff:
        outs = gb.build_on(m, [t])
    else:
        outs = jir_to_ff([JIRNode.from_json(line)
                          for line in gb.serialize().splitlines()], m, [t])
    m.compile(optimizer=ff.SGDOptimizer(m, lr=0.05),
              loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return m, outs


@pytest.mark.parametrize("name", ["transformer_block", "residual_mlp"])
def test_trains_with_the_jax_losses(name):
    gb = GRAPHS[name][0](NativeGraphBuilder())
    jm, _ = _built(jff, name, gb)
    tm, outs = _built(tff, name, gb)
    assert outs[0].dims == (B, 4)
    load_params(tm, params_from_jax(jm.params))
    rng = np.random.RandomState(0)
    shape = GRAPHS[name][1]
    xs = (rng.randint(0, 64, size=shape).astype(np.int32)
          if GRAPHS[name][2] == "int"
          else rng.randn(*shape).astype(np.float32))
    ys = rng.randint(0, 4, size=(B, 1)).astype(np.int32)
    losses = {m: [float(m.train_one_batch([xs], ys)) for _ in range(6)]
              for m in (jm, tm)}
    np.testing.assert_allclose(losses[tm], losses[jm], rtol=RTOL)
    assert np.isfinite(losses[tm]).all() and losses[tm][-1] < losses[tm][0]


def test_saved_graph_loads_in_both_packages(tmp_path):
    gb = conv_net(NativeGraphBuilder())
    path = tmp_path / "cnet.ir"
    gb.save(str(path))
    assert path.read_text() == gb.serialize()
    for ff, load in ((tff, file_to_ff), (jff, jfile_to_ff)):
        cfg = {"device": "cpu"} if ff is tff else {}
        m = ff.FFModel(ff.FFConfig(batch_size=4, **cfg))
        t = m.create_tensor([4, 3, 8, 8], ff.DataType.DT_FLOAT)
        assert load(str(path), m, [t])[0].dims == (4, 10)


@pytest.mark.parametrize("bad", [
    "unknown_node_id", "unknown_unary", "heads_do_not_divide",
    "unknown_scalar_op", "not_a_permutation", "unsupported_cast",
    "output_twice"])
def test_rejects_bad_ids_and_arguments(bad):
    gb = NativeGraphBuilder()
    x = gb.input(0)
    calls = {
        "unknown_node_id": lambda: gb.dense(99, 8),
        "unknown_unary": lambda: gb.unary(x, "not_an_op"),
        "heads_do_not_divide": lambda: gb.multihead_attention(x, x, x, 33,
                                                              4),
        "unknown_scalar_op": lambda: gb.scalar(x, "power", 2.0),
        "not_a_permutation": lambda: gb.transpose(x, [0, 0]),
        "unsupported_cast": lambda: gb.cast(x, "complex64"),
        "output_twice": lambda: (gb.output([x]), gb.output([x])),
    }
    with pytest.raises(ValueError):
        calls[bad]()
    if bad != "output_twice":
        assert gb.cast(gb.transpose(x, [1, 0]), "float32") >= 0


def test_serialize_without_output_raises():
    gb = NativeGraphBuilder()
    gb.dense(gb.input(0), 4)
    with pytest.raises(ValueError, match="no output"):
        gb.serialize()


def test_missing_compiler_raises(tmp_path, monkeypatch):
    """No Python fallback: a library that cannot build raises with the
    compiler's complaint."""
    monkeypatch.setattr(native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError, match="no-such-g"):
        NativeGraphBuilder()


def test_the_library_builds_the_graph_builder_source():
    assert any(p.endswith("graph_builder.cpp")
               for p in native.native_sources())
