"""The ops and builders this slice adds to the port, against the JAX
package's, on the CPU: the MoE ops (``make_dispatch``, GROUP_BY with its
capacity rounding, AGGREGATE and AGG_SPEC, EXPERTS with bias and
activation), BATCH_MATMUL, the constants ops (CONSTANT, WEIGHT, WHERE,
COMPARE, BROADCAST_TO), CACHE's staleness score, and every new
``FFModel`` builder in a model of each package trained a step from the
same weights. Forward outputs and gradients (``jax.grad`` against
autograd on the same numpy inputs) to rtol 1e-5."""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as jff
import flexflow_tpu_torch as tff
from flexflow_tpu.ops import base as jbase
from flexflow_tpu.ops import constants as jconst
from flexflow_tpu.ops import matmul as jmatmul
from flexflow_tpu.ops import moe as jmoe
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.ffconst import OpType
from flexflow_tpu_torch.ops import base as tbase
from flexflow_tpu_torch.ops import constants as tconst
from flexflow_tpu_torch.ops import matmul as tmatmul
from flexflow_tpu_torch.ops import moe as tmoe

TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a, grad=False):
    t = torch.tensor(np.asarray(a))
    return t.requires_grad_(grad) if grad else t


def _both(jop, top, attrs_j, attrs_t, params, inputs, float_in, seed=0):
    """Forward of each package's op on the same numpy params and inputs,
    and the gradients of ``sum(out * g)`` (a fixed random g) with
    respect to the params and the inputs listed in ``float_in``."""
    jctx, tctx = jbase.OpContext(), tbase.OpContext()

    def jf(p, xs):
        full = list(inputs)
        for i, x in zip(float_in, xs):
            full[i] = x
        return jop.forward(attrs_j, p, [jnp.asarray(a) for a in full], jctx)

    jouts = jf({k: jnp.asarray(v) for k, v in params.items()},
               [inputs[i] for i in float_in])
    rng = np.random.default_rng(seed)
    gs = [rng.standard_normal(np.shape(o)).astype(np.float32)
          for o in jouts]
    jgrads = jax.grad(lambda p, xs: sum(
        jnp.sum(o * g) for o, g in zip(jf(p, xs), gs)), argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in params.items()},
        [jnp.asarray(inputs[i]) for i in float_in])
    tp = {k: _t(v, True) for k, v in params.items()}
    tin = [_t(a, i in float_in) for i, a in enumerate(inputs)]
    touts = top.forward(attrs_t, tp, tin, tctx)
    sum((o * torch.tensor(g)).sum() for o, g in zip(touts, gs)).backward()
    for jo, to in zip(jouts, touts):
        np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **TOL)
    for k in params:
        np.testing.assert_allclose(tp[k].grad.numpy(),
                                   np.asarray(jgrads[0][k]), err_msg=k,
                                   **TOL)
    for i, jg in zip(float_in, jgrads[1]):
        np.testing.assert_allclose(tin[i].grad.numpy(), np.asarray(jg),
                                   err_msg=f"input {i}", **TOL)
    return touts


@pytest.mark.parametrize("T,k,E,cap", [(8, 2, 4, 4), (8, 2, 4, 2),
                                       (5, 1, 3, 1), (16, 3, 4, 5)])
def test_make_dispatch_matches_jax(T, k, E, cap):
    """First-come placement up to the capacity, choices past it dropped."""
    assign = np.random.default_rng(T + k).integers(0, E, (T, k))
    want = np.asarray(jmoe.make_dispatch(jnp.asarray(assign), E, cap))
    got = tmoe.make_dispatch(torch.tensor(assign), E, cap).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.sum() <= E * cap


@pytest.mark.parametrize("alpha,k,T,n", [(1.0, 2, 8, 4), (2.0, 2, 8, 4),
                                         (1.3, 2, 7, 4), (0.1, 1, 5, 8),
                                         (2.5, 3, 10, 6), (1.0, 1, 3, 7)])
def test_group_by_capacity_rounding(alpha, k, T, n):
    attrs = dict(n=n, k=k, alpha=alpha)
    assert tmoe.GroupBy._capacity(attrs, T) == jmoe.GroupBy._capacity(
        attrs, T) == int(max(1, alpha * k * T / n))


def test_group_by_forward_and_grad():
    rng = np.random.default_rng(1)
    data = rng.standard_normal((8, 6)).astype(np.float32)
    assign = rng.integers(0, 4, (8, 2)).astype(np.int32)
    attrs = dict(n=4, k=2, alpha=1.5)
    outs = _both(jmoe.GroupBy, tmoe.GroupBy, attrs, attrs, {},
                 [data, assign], [0])
    assert len(outs) == 4 and tuple(outs[0].shape) == (
        tmoe.GroupBy._capacity(attrs, 8), 6)


@pytest.mark.parametrize("op", ["AGGREGATE", "AGG_SPEC"])
def test_aggregate_forward_and_grad(op):
    rng = np.random.default_rng(2)
    preds = rng.random((8, 2)).astype(np.float32)
    assign = rng.integers(0, 4, (8, 2)).astype(np.int32)
    exps = [rng.standard_normal((3, 5)).astype(np.float32)
            for _ in range(4)]
    jop = {"AGGREGATE": jmoe.Aggregate, "AGG_SPEC": jmoe.AggregateSpec}[op]
    top = {"AGGREGATE": tmoe.Aggregate, "AGG_SPEC": tmoe.AggregateSpec}[op]
    _both(jop, top, dict(n=4), dict(n=4), {}, [preds, assign] + exps,
          [0, 2, 3, 4, 5])


@pytest.mark.parametrize("bias,act", [(False, "AC_MODE_NONE"),
                                      (True, "AC_MODE_RELU"),
                                      (True, "AC_MODE_GELU")])
def test_experts_forward_and_grad(bias, act):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((6, 5)).astype(np.float32)
    idx = rng.integers(0, 4, (6, 2)).astype(np.int32)
    gates = rng.random((6, 2)).astype(np.float32)
    params = {"kernel": rng.standard_normal((4, 5, 7)).astype(np.float32)}
    if bias:
        params["bias"] = rng.standard_normal((4, 7)).astype(np.float32)

    def attrs(ff):
        return dict(num_experts=4, experts_start_idx=0,
                    experts_output_dim_size=7, use_bias=bias,
                    activation=ff.ActiMode[act])

    _both(jmoe.Experts, tmoe.Experts, attrs(jff), attrs(tff), params,
          [x, idx, gates], [0, 2])


def test_experts_start_index_skips_other_experts():
    """Indices outside [start, start + n) select nothing (JAX's one_hot)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 3)).astype(np.float32)
    idx = np.array([[0, 5], [2, 3], [4, 1], [6, 2]], np.int32)
    gates = rng.random((4, 2)).astype(np.float32)
    k = rng.standard_normal((4, 3, 2)).astype(np.float32)
    attrs = dict(num_experts=4, experts_start_idx=2,
                 experts_output_dim_size=2)
    want = jmoe.Experts.forward(attrs, {"kernel": jnp.asarray(k)},
                                [jnp.asarray(a) for a in (x, idx, gates)],
                                jbase.OpContext())[0]
    got = tmoe.Experts.forward(attrs, {"kernel": _t(k)},
                               [_t(a) for a in (x, idx, gates)],
                               tbase.OpContext())[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape_a,shape_b", [((3, 4, 5), (3, 5, 2)),
                                             ((2, 3, 4, 6), (2, 3, 6, 5))])
def test_batch_matmul_forward_and_grad(shape_a, shape_b):
    rng = np.random.default_rng(5)
    a = rng.standard_normal(shape_a).astype(np.float32)
    b = rng.standard_normal(shape_b).astype(np.float32)
    _both(jmatmul.BatchMatmul, tmatmul.BatchMatmul, {}, {}, {}, [a, b],
          [0, 1])
    assert tmatmul.BatchMatmul.infer_output_specs(
        {}, [(shape_a, tff.DataType.DT_FLOAT),
             (shape_b, tff.DataType.DT_FLOAT)])[0][0] == \
        shape_a[:-1] + shape_b[-1:]


def test_where_compare_broadcast_forward_and_grad():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 4)).astype(np.float32)
    y = rng.standard_normal((3, 4)).astype(np.float32)
    for cmp in ("eq", "ne", "lt", "le", "gt", "ge"):
        j = jconst.Compare.forward(dict(cmp=cmp), {}, [jnp.asarray(x),
                                                       jnp.asarray(y)],
                                   None)[0]
        t = tconst.Compare.forward(dict(cmp=cmp), {}, [_t(x), _t(y)],
                                   None)[0]
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        j = jconst.Compare.forward(dict(cmp=cmp, scalar=0.25), {},
                                   [jnp.asarray(x)], None)[0]
        t = tconst.Compare.forward(dict(cmp=cmp, scalar=0.25), {}, [_t(x)],
                                   None)[0]
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    cond = x > y
    _both(jconst.Where, tconst.Where, {}, {}, {}, [cond, x, y], [1, 2])
    row = rng.standard_normal((1, 4)).astype(np.float32)
    _both(jconst.BroadcastTo, tconst.BroadcastTo, dict(shape=[3, 4]),
          dict(shape=[3, 4]), {}, [row], [0])


def test_constant_and_weight_ops():
    value = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    attrs = dict(value=value.tolist(), dtype="float32", shape=[2, 3])
    got = tconst.Constant.forward(attrs, {}, [], tbase.OpContext())[0]
    want = jconst.Constant.forward(attrs, {}, [], jbase.OpContext())[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    w = dict(shape=[2, 3], dtype="float32", init=0.5)
    (spec,) = tconst.WeightParam.weight_specs(w, [])
    (jspec,) = jconst.WeightParam.weight_specs(w, [])
    assert (spec.name, tuple(spec.shape)) == (jspec.name, tuple(jspec.shape))
    init = spec.initializer(torch.Generator(), (2, 3), torch.float32, "cpu")
    assert torch.equal(init, torch.full((2, 3), 0.5))


def _cache_scores(ff, batches):
    kw = {"device": "cpu"} if ff is tff else {}
    m = ff.FFModel(ff.FFConfig(batch_size=8, **kw))
    t = m.create_tensor([8, 16], ff.DataType.DT_FLOAT)
    x = m.dense(t, 16, ff.ActiMode.AC_MODE_RELU, name="gate")
    x = m.cache(x, num_batches=2, name="gate_cache")
    m.softmax(m.dense(x, 4, name="head"))
    m.compile(optimizer=ff.SGDOptimizer(m, lr=0.0),
              loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return m


def test_cache_score_matches_jax():
    """The staleness score after each batch: 0 while the ring warms up,
    then the mean relative change against the slot's cached batch."""
    rng = np.random.default_rng(7)
    xs = [rng.standard_normal((8, 16)).astype(np.float32) * s
          for s in (1, 1, 1, 3, 1)]
    xs[2] = xs[0]
    y = rng.integers(0, 4, (8, 1)).astype(np.int32)
    jm, tm = _cache_scores(jff, xs), _cache_scores(tff, xs)
    load_params(tm, params_from_jax({ln: {w: np.asarray(a)
                                          for w, a in lp.items()}
                                     for ln, lp in jm.params.items()}))
    got, want = [], []
    for x in xs:
        jm.train_one_batch([x], y)
        tm.train_one_batch([x], y)
        want.append(jm.get_cache_score("gate_cache"))
        got.append(tm.get_cache_score("gate_cache"))
    assert want[:2] == [0.0, 0.0] and got[:2] == [0.0, 0.0]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[2] < 1e-6 < got[3]
    with pytest.raises(KeyError):
        tm.get_cache_score("head")


# ----------------------------------------------------------------------
# the new builders, in one model of each package
# ----------------------------------------------------------------------
def _builders_model(ff):
    """Every builder this slice adds, on one graph: batch_matmul, mean,
    reduce_mean, reduce_sum, gather, reverse, slice_tensor, squeeze,
    unsqueeze, where, compare, broadcast_to, constant_tensor, parameter,
    experts, moe (top_k, group_by, aggregate) and aggregate_spec."""
    kw = {"device": "cpu"} if ff is tff else {}
    m = ff.FFModel(ff.FFConfig(batch_size=4, seed=3, **kw))
    x = m.create_tensor([4, 3, 8], ff.DataType.DT_FLOAT)
    idx = m.create_tensor([4, 3, 8], ff.DataType.DT_INT32)
    h = m.dense(x, 8, ff.ActiMode.AC_MODE_TANH)
    att = m.batch_matmul(h, m.transpose(h, [0, 2, 1]))        # [4, 3, 3]
    att = m.reduce_sum(att, [2], keepdims=True)                # [4, 3, 1]
    h = m.add(h, m.broadcast_to(att, [4, 3, 8]))
    h = m.multiply(h, m.parameter([8], init=0.5))
    h = m.add(h, m.constant_tensor(np.linspace(-1, 1, 8,
                                               dtype=np.float32)))
    h = m.where(m.compare(h, 0.0, "gt"), h, m.scalar_multiply(h, 0.1))
    h = m.add(h, m.reverse(h, 1))
    h = m.add(h, m.gather(h, idx, 2))
    first = m.squeeze(m.slice_tensor(h, [None, 0, None], [None, 1, None]),
                      1)                                       # [4, 8]
    pooled = m.add(m.mean(h, [1]), m.reduce_mean(
        m.unsqueeze(first, 1), [1]))                           # [4, 8]
    vals, assign = m.top_k(m.softmax(m.dense(pooled, 4)), 2)
    e = m.experts(pooled, assign, vals, 4, 0, 8, use_bias=True,
                  activation=ff.ActiMode.AC_MODE_RELU)
    mo = m.moe(pooled, 4, 2, 8)
    buckets = m.group_by(pooled, assign, 4, 1.0)
    spec = m.aggregate_spec(vals, assign, [m.dense(b, 8) for b in buckets],
                            4)
    out = m.add(m.add(e, mo), spec)
    m.softmax(m.dense(out, 5))
    m.compile(optimizer=ff.SGDOptimizer(m, lr=0.1),
              loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    return m


def _jax_grads(jm, xs, y):
    """``jax.grad`` of the JAX model's training loss (its train step's
    forward, without the update) at its current parameters."""
    from flexflow_tpu.ops.base import OpContext
    from flexflow_tpu.training.loss import compute_loss

    feeds = jm._feeds_from_arrays(xs)
    label = jnp.asarray(y)

    def loss(p):
        ctx = OpContext(training=True, rng=None, compute_dtype=jnp.float32,
                        mesh=jm.mesh, config=jm.config)
        values, _ = jm._run_graph(p, feeds, ctx, jm.op_state)
        return compute_loss(jm.loss_type,
                            values[jm._final_tensor.tensor_id], label,
                            logits=values[jm._logits_tensor.tensor_id])

    return jax.jit(jax.grad(loss))(jm.params)


@pytest.fixture(scope="module")
def builders_pair():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 3, 8)).astype(np.float32)
    idx = rng.integers(0, 8, (4, 3, 8)).astype(np.int32)
    y = rng.integers(0, 5, (4, 1)).astype(np.int32)
    jm, tm = _builders_model(jff), _builders_model(tff)
    load_params(tm, params_from_jax({ln: {w: np.asarray(a)
                                          for w, a in lp.items()}
                                     for ln, lp in jm.params.items()}))
    fwd = (np.asarray(jm.predict([x, idx])), tm.predict([x, idx]))
    jgrads = _jax_grads(jm, [x, idx], y)
    loss = (jm.train_one_batch([x, idx], y), tm.train_one_batch([x, idx], y))
    grads = ({(ln, w): np.asarray(a) for ln, lp in jgrads.items()
              for w, a in lp.items()},
             {(ln, w): p.grad.numpy() for ln, lp in tm.params.items()
              for w, p in lp.items()})
    return jm, tm, fwd, loss, grads


def test_builders_layers_match_jax(builders_pair):
    jm, tm = builders_pair[:2]
    assert [(lay.name, lay.op_type.name, [tuple(t.dims)
                                          for t in lay.outputs])
            for lay in tm.layers] == [
        (lay.name, lay.op_type.name, [tuple(t.dims) for t in lay.outputs])
        for lay in jm.layers]
    assert sorted(tm.get_layers()) == sorted(jm.get_layers())
    assert tm.get_output_tensor().dims == jm.get_output_tensor().dims
    h = tm.get_parameter_tensor("weight", "weight")
    assert h.is_weight and h.shape == (8,)
    np.testing.assert_array_equal(h.get_weights(),
                                  tm.get_parameter_by_key(("weight",
                                                           "weight")))
    with pytest.raises(KeyError):
        tm.get_parameter_tensor("weight", "kernel")


def test_builders_forward_matches_jax(builders_pair):
    want, got = builders_pair[2]
    np.testing.assert_allclose(got, want, **TOL)


def test_builders_gradients_match_jax(builders_pair):
    """A train step's loss and every parameter's gradient (through each
    new op) against ``jax.grad`` of the JAX model's loss; a gradient that
    sums many terms is held to 1e-6 of its largest element (float32 sums
    in another order), every other element to rtol 1e-5."""
    (jl, tl), (jg, tg) = builders_pair[3], builders_pair[4]
    np.testing.assert_allclose(tl, jl, **TOL)
    assert set(jg) == set(tg)
    for k in jg:
        scale = max(1.0, float(np.abs(jg[k]).max()))
        np.testing.assert_allclose(tg[k], jg[k], rtol=1e-5,
                                   atol=1e-6 * scale, err_msg=str(k))


def test_new_op_types_share_the_jax_names():
    for name in ("WEIGHT", "CONSTANT", "WHERE", "COMPARE", "BROADCAST_TO",
                 "BATCH_MATMUL", "GROUP_BY", "AGGREGATE", "AGG_SPEC",
                 "EXPERTS", "CACHE"):
        assert OpType[name].name == jff.OpType[name].name
        assert tbase.get_op_impl(OpType[name]) is not None


def test_public_model_methods_match_jax():
    """Every public FFModel method of the JAX package is in the port (the
    dot export, the last one, came with the frontends)."""
    public = {n for n in dir(jff.FFModel) if not n.startswith("_")}
    missing = public - {n for n in dir(tff.FFModel) if not n.startswith("_")}
    assert missing == set(), missing


_NEW_MODULES = ["ops/moe.py", "ops/matmul.py", "ops/constants.py",
                "ops/cache.py", "core/recompile.py", "parallel/placement.py",
                "training/checkpoint.py", "parallel/rank_jobs.py"]


@pytest.mark.parametrize("rel", _NEW_MODULES)
def test_new_modules_import_no_jax(rel):
    root = pathlib.Path(__file__).resolve().parents[1] / "flexflow_tpu_torch"
    for node in ast.walk(ast.parse((root / rel).read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in ("jax", "jaxlib",
                                              "flexflow_tpu"), (rel, name)
