"""The port's ONNX frontend (``flexflow_tpu_torch.onnx``) against the JAX
package's (``flexflow_tpu.onnx``), on the CPU.

The port's codec is a copy of the JAX package's: the encoder writes the
same bytes and the decoder reads them back. ``ONNXModel.apply`` plus
``import_initializers`` on the port gives the JAX model's outputs and
training losses within rtol 1e-5 (atol 1e-5 of the output's largest
magnitude), for the MLP, CNN and residual net of ``examples/python/onnx``
and for a small ResNet block in ResNet-50's vocabulary (BatchNormalization,
padded MaxPool, GlobalAveragePool, a ``transB`` Gemm).
"""

import importlib.util
import pathlib

import numpy as np
import pytest

import flexflow_tpu as jff
from flexflow_tpu.onnx import ONNXModel as JONNXModel
from flexflow_tpu.onnx import proto as JP
import flexflow_tpu_torch as tff
from flexflow_tpu_torch.onnx import ONNXModel, load_model
from flexflow_tpu_torch.onnx import proto as P

REPO = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-5


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def example(name):
    """A module of examples/python/onnx (each builds its graph with the
    JAX package's codec, which the port's equals byte for byte)."""
    path = REPO / "examples" / "python" / "onnx" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"onnx_ex_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resnet_block(codec, rng, B):
    """Conv-BN-ReLU, a padded 3x3/2 max pool, a bottleneck with a
    projection shortcut, global average pool and a transB Gemm head."""
    def w(*s):
        return (rng.randn(*s) * 0.2).astype(np.float32)

    def bn(c, tag):
        return {f"{tag}_s": np.ones(c, np.float32),
                f"{tag}_b": np.zeros(c, np.float32),
                f"{tag}_m": np.zeros(c, np.float32),
                f"{tag}_v": np.ones(c, np.float32)}

    def bn_node(x, y, tag):
        return codec.encode_node(
            "BatchNormalization",
            [x, f"{tag}_s", f"{tag}_b", f"{tag}_m", f"{tag}_v"], [y],
            name=tag, epsilon=1e-5)

    def conv(x, y, k, tag, stride, pad):
        return codec.encode_node("Conv", [x, k], [y], name=tag,
                                 kernel_shape=[3, 3] if pad else [1, 1],
                                 strides=[stride, stride],
                                 pads=[pad] * 4, group=1)

    init = {"k0": w(8, 3, 3, 3), "k1": w(4, 8, 1, 1), "k2": w(4, 4, 3, 3),
            "k3": w(16, 4, 1, 1), "ksc": w(16, 8, 1, 1), "fc": w(10, 16),
            "fcb": w(10)}
    for tag, c in (("bn0", 8), ("bn1", 4), ("bn2", 4), ("bn3", 16),
                   ("bnsc", 16)):
        init.update(bn(c, tag))
    nodes = [conv("x", "c0", "k0", "conv0", 2, 1), bn_node("c0", "b0", "bn0"),
             codec.encode_node("Relu", ["b0"], ["r0"], name="relu0"),
             codec.encode_node("MaxPool", ["r0"], ["p0"], name="pool0",
                               kernel_shape=[3, 3], strides=[2, 2],
                               pads=[1, 1, 1, 1]),
             conv("p0", "c1", "k1", "conv1", 1, 0), bn_node("c1", "b1", "bn1"),
             codec.encode_node("Relu", ["b1"], ["r1"], name="relu1"),
             conv("r1", "c2", "k2", "conv2", 1, 1), bn_node("c2", "b2", "bn2"),
             codec.encode_node("Relu", ["b2"], ["r2"], name="relu2"),
             conv("r2", "c3", "k3", "conv3", 1, 0), bn_node("c3", "b3", "bn3"),
             conv("p0", "csc", "ksc", "convsc", 1, 0),
             bn_node("csc", "bsc", "bnsc"),
             codec.encode_node("Add", ["b3", "bsc"], ["s"], name="add"),
             codec.encode_node("Relu", ["s"], ["rs"], name="relu3"),
             codec.encode_node("GlobalAveragePool", ["rs"], ["g"],
                               name="gap"),
             codec.encode_node("Flatten", ["g"], ["f"], name="flat"),
             codec.encode_node("Gemm", ["f", "fc", "fcb"], ["o"], name="fc",
                               transB=1),
             codec.encode_node("Softmax", ["o"], ["y"], name="sm", axis=-1)]
    return codec.encode_model(
        nodes, inputs=[codec.encode_value_info("x", [B, 3, 16, 16])],
        outputs=[codec.encode_value_info("y", [B, 10])],
        initializers=init)


# name: (bytes of the model from a seeded rng, input shape, classes)
def model_bytes(name, codec, B, seed=0):
    rng = np.random.RandomState(seed)
    if name == "mlp":
        ex = example("mnist_mlp_onnx")
        ex.P = codec
        return ex.make_onnx_mlp(rng), (B, 784), 10
    if name in ("cnn", "residual"):
        ex = example("cifar10_cnn_onnx" if name == "cnn" else "resnet_onnx")
        ex.P = codec
        return ex.make_model(rng, B), (B, 3, 32, 32), 10
    return resnet_block(codec, rng, B), (B, 3, 16, 16), 10


MODELS = ["mlp", "cnn", "residual", "resnet_block"]


@pytest.mark.parametrize("name", MODELS)
def test_encoder_writes_the_jax_bytes(name):
    B = 64 if name == "mlp" else 8
    assert model_bytes(name, P, B)[0] == model_bytes(name, JP, B)[0]


def test_attributes_and_dtypes_encode_as_jax():
    """Every attribute kind the encoder writes (int, float, string, int
    and float lists, tensor) and the initializer dtypes."""
    inits = {"f": np.arange(6, dtype=np.float32).reshape(2, 3),
             "i": np.arange(4, dtype=np.int64),
             "h": np.ones((2, 2), np.float16)}
    for codec in (P, JP):
        nodes = [codec.encode_node("Foo", ["x", "f"], ["y", "z"], name="n",
                                   i=3, fl=0.5, s=b"VALID", ints=[1, -2],
                                   floats=[0.25, 1.5]),
                 codec.encode_node("Constant", [], ["c"], name="k",
                                   value=np.array([1.0, 2.0], np.float32))]
        blob = codec.encode_model(
            nodes, inputs=[codec.encode_value_info("x", [2, 3])],
            outputs=[codec.encode_value_info("y", [2, 3])],
            initializers=inits)
        if codec is P:
            mine = blob
    assert mine == blob
    g = load_model(mine)
    assert [n.op_type for n in g.nodes] == ["Foo", "Constant"]
    a = g.nodes[0].attrs
    assert (a["i"], a["fl"], a["s"], list(a["ints"])) == (3, 0.5, b"VALID",
                                                          [1, -2])
    np.testing.assert_allclose(a["floats"], [0.25, 1.5])
    for k, v in inits.items():
        assert g.initializers[k].dtype == v.dtype
        np.testing.assert_array_equal(g.initializers[k], v)
    np.testing.assert_array_equal(g.nodes[1].attrs["value"], [1.0, 2.0])


def test_codec_roundtrip_from_a_file(tmp_path):
    blob, _, _ = model_bytes("mlp", P, 16)
    path = tmp_path / "mlp.onnx"
    path.write_bytes(blob)
    g = load_model(str(path))
    jg = JP.load_model(str(path))
    assert [n.op_type for n in g.nodes] == ["Gemm", "Relu", "Gemm",
                                            "Softmax"]
    assert [n.op_type for n in g.nodes] == [n.op_type for n in jg.nodes]
    for k in jg.initializers:
        np.testing.assert_array_equal(g.initializers[k], jg.initializers[k])
    assert g.inputs[0].name == "x" and g.inputs[0].shape == [64, 784]
    assert g.nodes[0].attrs["transB"] == 0 and g.nodes[3].attrs["axis"] == -1


def _imported(ff, blob, shape, training):
    cfg = {"device": "cpu"} if ff is tff else {}
    m = ff.FFModel(ff.FFConfig(batch_size=shape[0], **cfg))
    t = m.create_tensor(list(shape), ff.DataType.DT_FLOAT)
    om = (ONNXModel if ff is tff else JONNXModel)(blob)
    assert len(om.apply(m, {"x": t})) == 1
    if training:
        m.compile(optimizer=ff.SGDOptimizer(m, lr=0.05),
                  loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    else:
        m.compile()
    om.import_initializers(m)
    return m


@pytest.mark.parametrize("name", MODELS)
def test_imported_model_matches_jax(name):
    """Outputs from the initializers alone, then two SGD epochs: the JAX
    model's within rtol 1e-5 (BatchNorm at its initial scale and bias in
    both packages, in training mode while fitting)."""
    B = 8
    blob, shape, classes = model_bytes(name, P, B)
    rng = np.random.RandomState(1)
    x = rng.randn(4 * B, *shape[1:]).astype(np.float32)
    y = rng.randint(0, classes, (4 * B, 1)).astype(np.int32)
    got = _imported(tff, blob, (B,) + shape[1:], False).predict(x[:B])
    close(got, _imported(jff, blob, (B,) + shape[1:], False).predict(x[:B]))
    hist = {ff: [h["loss"] for h in _imported(
        ff, blob, (B,) + shape[1:], True).fit(x, y, epochs=2)]
        for ff in (jff, tff)}
    np.testing.assert_allclose(hist[tff], hist[jff], rtol=RTOL)


def test_elementwise_split_transpose():
    nodes = [P.encode_node("Split", ["x"], ["a", "b"], name="split1",
                           axis=1, split=[6, 6]),
             P.encode_node("Add", ["a", "b"], ["s"], name="add1"),
             P.encode_node("Mul", ["s", "s"], ["m"], name="mul1"),
             P.encode_node("Transpose", ["m"], ["y"], name="tr1",
                           perm=[1, 0])]
    blob = P.encode_model(nodes, inputs=[P.encode_value_info("x", [8, 12])],
                          outputs=[P.encode_value_info("y", [6, 8])],
                          initializers={})
    x = np.random.RandomState(3).randn(8, 12).astype(np.float32)
    got = _imported(tff, blob, (8, 12), False).predict(x)
    np.testing.assert_allclose(got, ((x[:, :6] + x[:, 6:]) ** 2).T,
                               rtol=1e-6, atol=1e-6)


def _pool_model(auto_pad=None, pads=None, op="MaxPool"):
    kw = {"kernel_shape": [3, 3] if op == "Conv" else [2, 2],
          "strides": [1, 1] if op == "Conv" else [2, 2]}
    if auto_pad is not None:
        kw["auto_pad"] = auto_pad
    if pads is not None:
        kw["pads"] = pads
    ins = ["x", "wc"] if op == "Conv" else ["x"]
    init = {"wc": np.zeros((2, 1, 3, 3), np.float32)} if op == "Conv" else {}
    return P.encode_model([P.encode_node(op, ins, ["y"], name="p", **kw)],
                          inputs=[P.encode_value_info("x", [1, 1, 8, 8])],
                          outputs=[P.encode_value_info("y", [1, 1, 4, 4])],
                          initializers=init)


@pytest.mark.parametrize("case", ["asymmetric_pads", "same_upper"])
def test_unrepresentable_padding_raises(case):
    """The symmetric-(ph, pw) builder cannot express these: both raise, as
    in the JAX package, instead of shifting every window."""
    blob, match = ((_pool_model(pads=[1, 1, 0, 0], op="Conv"), "asymmetric")
                   if case == "asymmetric_pads"
                   else (_pool_model(auto_pad=b"SAME_UPPER"), "SAME_UPPER"))
    m = tff.FFModel(tff.FFConfig(batch_size=1, device="cpu"))
    t = m.create_tensor([1, 1, 8, 8], tff.DataType.DT_FLOAT)
    with pytest.raises(NotImplementedError, match=match):
        ONNXModel(blob).apply(m, {"x": t})


def test_auto_pad_valid_is_no_padding():
    m = tff.FFModel(tff.FFConfig(batch_size=1, device="cpu"))
    t = m.create_tensor([1, 1, 8, 8], tff.DataType.DT_FLOAT)
    (out,) = ONNXModel(_pool_model(auto_pad=b"VALID")).apply(m, {"x": t})
    assert out.dims == (1, 1, 4, 4)
