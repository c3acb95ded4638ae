"""The port's training ops against the JAX package's, on the CPU: the same
numpy inputs and weights through both, fp32. Forward to 1e-5; gradients of
``sum(out * r)`` with respect to every input and weight (``jax.grad``
against autograd) to 1e-4. Dropout's draws cannot match JAX's, so it is
held to its own statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.ffconst import ActiMode as JActiMode
from flexflow_tpu.ffconst import DataType as JDataType
from flexflow_tpu.ffconst import PoolType as JPoolType
from flexflow_tpu.ops import attention as jattn
from flexflow_tpu.ops import conv as jconv
from flexflow_tpu.ops import norm as jnorm
from flexflow_tpu.ops import softmax as jsoftmax
from flexflow_tpu.ops.base import OpContext as JOpContext
from flexflow_tpu_torch.ffconst import ActiMode, DataType, PoolType
from flexflow_tpu_torch.ops import attention as tattn
from flexflow_tpu_torch.ops import conv as tconv
from flexflow_tpu_torch.ops import dropout as tdropout
from flexflow_tpu_torch.ops import norm as tnorm
from flexflow_tpu_torch.ops import softmax as tsoftmax
from flexflow_tpu_torch.ops.base import OpContext as TOpContext

FWD_TOL, GRAD_TOL = 1e-5, 1e-4


def _weights(jop, attrs, in_shapes, rng):
    """Random fp32 weights of the JAX op's specs; the port's specs must
    name the same weights at the same shapes."""
    jspecs = jop.weight_specs(attrs, [(s, JDataType.DT_FLOAT)
                                      for s in in_shapes])
    return {w.name: (0.3 * rng.randn(*w.shape)).astype(np.float32)
            for w in jspecs}


def _port_specs(top, attrs, in_shapes):
    return {w.name: tuple(w.shape) for w in top.weight_specs(
        attrs, [(s, DataType.DT_FLOAT) for s in in_shapes])}


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol, err_msg=what)


def check_op(jop, top, jattrs, tattrs, xs, ws, seed=0):
    """Forward and gradient parity of one op (no op state)."""
    def jf(jx, jw):
        return jop.forward(jattrs, jw, jx, JOpContext())[0]

    jx = [jnp.asarray(a) for a in xs]
    jw = {k: jnp.asarray(v) for k, v in ws.items()}
    jy = jax.jit(jf)(jx, jw)
    r = np.random.RandomState(seed + 1).randn(*jy.shape).astype(np.float32)
    jgx, jgw = jax.jit(jax.grad(lambda a, b: jnp.sum(jf(a, b) * r),
                                argnums=(0, 1)))(jx, jw)

    tx = [torch.tensor(a, requires_grad=True) for a in xs]
    tw = {k: torch.tensor(v, requires_grad=True) for k, v in ws.items()}
    ty = top.forward(tattrs, tw, tx, TOpContext())[0]
    assert tuple(ty.shape) == tuple(jy.shape)
    _close(ty.detach(), jy, FWD_TOL, "forward")
    (ty * torch.tensor(r)).sum().backward()
    for i, (t, g) in enumerate(zip(tx, jgx)):
        _close(t.grad, g, GRAD_TOL, f"d input {i}")
    for k in ws:
        _close(tw[k].grad, jgw[k], GRAD_TOL, f"d {k}")


# (name, embed, heads, kdim, vdim, q/k/v input widths, seq q/k, attrs)
MHA_CASES = {
    "plain": (32, 4, 0, 0, (32, 32, 32), (6, 6), {}),
    "no_bias": (32, 4, 0, 0, (32, 32, 32), (6, 6), {"bias": False}),
    "causal": (32, 4, 0, 0, (32, 32, 32), (6, 6), {"causal": True}),
    "causal_cross": (32, 4, 0, 0, (32, 32, 32), (4, 7), {"causal": True}),
    "bias_kv": (32, 4, 0, 0, (32, 32, 32), (6, 6), {"add_bias_kv": True}),
    "zero_attn": (32, 4, 0, 0, (32, 32, 32), (6, 6),
                  {"add_zero_attn": True}),
    "bias_kv_zero_attn_causal": (32, 4, 0, 0, (32, 32, 32), (5, 5),
                                 {"add_bias_kv": True,
                                  "add_zero_attn": True, "causal": True}),
    "kdim_vdim": (32, 4, 48, 48, (32, 24, 40), (6, 9), {}),
    # eval: probability dropout is off
    "dropout_eval": (32, 4, 0, 0, (32, 32, 32), (6, 6), {"dropout": 0.3}),
}


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_multihead_attention_matches_jax(case):
    embed, heads, kdim, vdim, widths, (sq, sk), extra = MHA_CASES[case]
    attrs = dict(embed_dim=embed, num_heads=heads, kdim=kdim or embed,
                 vdim=vdim or embed, **extra)
    rng = np.random.RandomState(3)
    shapes = [(2, sq, widths[0]), (2, sk, widths[1]), (2, sk, widths[2])]
    xs = [rng.randn(*s).astype(np.float32) for s in shapes]
    ws = _weights(jattn.MultiHeadAttention, attrs, shapes, rng)
    assert _port_specs(tattn.MultiHeadAttention, attrs, shapes) == {
        k: v.shape for k, v in ws.items()}
    check_op(jattn.MultiHeadAttention, tattn.MultiHeadAttention, attrs,
             attrs, xs, ws)


def test_mha_bf16_activations_keep_fp32_scores():
    """A bf16 activation against fp32 weights runs its products in fp32
    (JAX's promotion) and returns the probabilities to bf16: the port's
    output is the JAX package's to bf16 precision, in fp32."""
    attrs = dict(embed_dim=32, num_heads=4, kdim=32, vdim=32)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 32).astype(np.float32)
    ws = _weights(jattn.MultiHeadAttention, attrs, [x.shape] * 3, rng)
    jx = jnp.asarray(x, jnp.bfloat16)
    jy = jattn.MultiHeadAttention.forward(
        attrs, {k: jnp.asarray(v) for k, v in ws.items()}, [jx] * 3,
        JOpContext())[0]
    tx = torch.tensor(x).to(torch.bfloat16)
    ty = tattn.MultiHeadAttention.forward(
        attrs, {k: torch.tensor(v) for k, v in ws.items()}, [tx] * 3,
        TOpContext())[0]
    assert ty.dtype == torch.float32 and jy.dtype == jnp.float32
    _close(ty, jy, 1e-2, "bf16 mha")


def test_mha_probability_dropout_draws_from_the_generator():
    """Training with prob dropout: the output differs from eval's and
    repeats bit for bit on a generator seeded alike; the keep mask keeps
    1 - rate of its draws."""
    attrs = dict(embed_dim=16, num_heads=2, kdim=16, vdim=16, dropout=0.5,
                 bias=False)
    rng = np.random.RandomState(5)
    x = torch.tensor(rng.randn(4, 32, 16).astype(np.float32))
    ws = {k: torch.tensor(v) for k, v in _weights(
        jattn.MultiHeadAttention, attrs, [tuple(x.shape)] * 3, rng).items()}

    def run(training, seed=0):
        g = torch.Generator().manual_seed(seed)
        ctx = TOpContext(training=training, generator=g)
        return tattn.MultiHeadAttention.forward(attrs, ws, [x] * 3, ctx)[0]

    assert not torch.equal(run(True), run(False))
    assert torch.equal(run(True, 7), run(True, 7))
    assert not torch.equal(run(True, 7), run(True, 8))
    g = torch.Generator().manual_seed(0)
    m = TOpContext(generator=g).keep_mask((200_000,), 0.5, "cpu")
    assert abs(m.float().mean().item() - 0.5) < 0.01


def test_softmax_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.randn(3, 5, 11).astype(np.float32)
    for axis in (-1, 1):
        check_op(jsoftmax.Softmax, tsoftmax.Softmax, {"axis": axis},
                 {"axis": axis}, [x], {})


def _conv_attrs(out, k, s, p, groups, bias, act):
    base = dict(out_channels=out, kernel_h=k, kernel_w=k, stride_h=s,
                stride_w=s, padding_h=p, padding_w=p, groups=groups,
                use_bias=bias)
    return (dict(base, activation=getattr(JActiMode, act)),
            dict(base, activation=getattr(ActiMode, act)))


CONV_CASES = {
    # the case JAX routes through its space-to-depth stem rewrite
    "stem_3ch_stride2": ((2, 3, 16, 16), 8, 7, 2, 3, 1, False, "AC_MODE_NONE"),
    "groups_bias_relu": ((2, 8, 9, 9), 12, 3, 1, 1, 4, True, "AC_MODE_RELU"),
    "stride2_1x1_tanh": ((2, 6, 10, 10), 4, 1, 2, 0, 1, True,
                         "AC_MODE_TANH"),
}


@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv2d_matches_jax(case):
    shape, out, k, s, p, groups, bias, act = CONV_CASES[case]
    jattrs, tattrs = _conv_attrs(out, k, s, p, groups, bias, act)
    if case.startswith("stem"):
        assert jconv._wants_space_to_depth(jattrs, np.zeros(shape))
    rng = np.random.RandomState(7)
    x = rng.randn(*shape).astype(np.float32)
    ws = _weights(jconv.Conv2D, jattrs, [shape], rng)
    assert _port_specs(tconv.Conv2D, tattrs, [shape]) == {
        k_: v.shape for k_, v in ws.items()}
    out_spec = tconv.Conv2D.infer_output_specs(
        tattrs, [(shape, DataType.DT_FLOAT)])[0][0]
    assert out_spec == jconv.Conv2D.infer_output_specs(
        jattrs, [(shape, JDataType.DT_FLOAT)])[0][0]
    check_op(jconv.Conv2D, tconv.Conv2D, jattrs, tattrs, [x], ws)


@pytest.mark.parametrize("pool,k,s,p", [("POOL_MAX", 3, 2, 1),
                                        ("POOL_AVG", 3, 2, 1),
                                        ("POOL_AVG", 2, 1, 1),
                                        ("POOL_AVG", 5, 5, 0)])
def test_pool2d_matches_jax(pool, k, s, p):
    base = dict(kernel_h=k, kernel_w=k, stride_h=s, stride_w=s, padding_h=p,
                padding_w=p)
    jattrs = dict(base, pool_type=getattr(JPoolType, pool),
                  activation=JActiMode.AC_MODE_NONE)
    tattrs = dict(base, pool_type=getattr(PoolType, pool),
                  activation=ActiMode.AC_MODE_NONE)
    x = np.random.RandomState(8).randn(2, 3, 10, 10).astype(np.float32)
    check_op(jconv.Pool2D, tconv.Pool2D, jattrs, tattrs, [x], {})


@pytest.mark.parametrize("relu,shape", [(True, (4, 6, 5, 5)),
                                        (False, (8, 5))])
def test_batch_norm_train_then_eval_matches_jax(relu, shape):
    """Two train forwards (batch statistics about the running mean; the
    running pair updated with the biased variance), then eval on the
    running statistics: outputs, gradients and the state agree."""
    attrs = {"relu": relu}
    rng = np.random.RandomState(9)
    c = shape[1]
    ws = {"scale": (1 + 0.2 * rng.randn(c)).astype(np.float32),
          "bias": (0.2 * rng.randn(c)).astype(np.float32)}
    assert _port_specs(tnorm.BatchNorm, attrs, [shape]) == {
        k: v.shape for k, v in ws.items()}
    jst = jnorm.BatchNorm.init_state(attrs, [(shape, JDataType.DT_FLOAT)])
    tst = tnorm.BatchNorm.init_state(attrs, [(shape, DataType.DT_FLOAT)],
                                     "cpu")
    for step in range(3):
        training = step < 2
        # a shifted mean: the one-pass statistics about the running mean
        x = (3.0 + 2.0 * rng.randn(*shape)).astype(np.float32)
        r = rng.randn(*shape).astype(np.float32)

        def jf(jx, jw, out_state=None):
            ctx = JOpContext(training=training, layer_name="bn",
                             state_in={"bn": jst})
            y = jnorm.BatchNorm.forward(attrs, jw, [jx], ctx)[0]
            if out_state is not None:
                out_state.update(ctx.state_out.get("bn", {}))
            return y

        jw = {k: jnp.asarray(v) for k, v in ws.items()}
        new_jst = {}
        jy = jf(jnp.asarray(x), jw, new_jst)
        jgx, jgw = jax.grad(lambda a, b: jnp.sum(jf(a, b) * r),
                            argnums=(0, 1))(jnp.asarray(x), jw)

        tx = torch.tensor(x, requires_grad=True)
        tw = {k: torch.tensor(v, requires_grad=True) for k, v in ws.items()}
        ctx = TOpContext(training=training, layer_name="bn",
                         state_in={"bn": tst})
        ty = tnorm.BatchNorm.forward(attrs, tw, [tx], ctx)[0]
        _close(ty.detach(), jy, FWD_TOL, f"forward step {step}")
        (ty * torch.tensor(r)).sum().backward()
        _close(tx.grad, jgx, GRAD_TOL, f"dx step {step}")
        for k in ws:
            _close(tw[k].grad, jgw[k], GRAD_TOL, f"d {k} step {step}")
        if training:
            tst = ctx.state_out["bn"]
            assert not tst["running_mean"].requires_grad
            jst = new_jst
        else:
            assert "bn" not in ctx.state_out
        for k in ("running_mean", "running_var"):
            _close(tst[k], jst[k], FWD_TOL, f"{k} step {step}")


def test_dropout_statistics_and_identity():
    """Identity in eval, at rate 0 and without a generator; in training
    about ``rate`` of the elements are zero and the rest are x / keep;
    one seed repeats its draws."""
    x = torch.randn(400, 500)
    attrs = {"rate": 0.3}
    fwd = tdropout.Dropout.forward
    assert fwd(attrs, {}, [x], TOpContext())[0] is x
    g = torch.Generator().manual_seed(1)
    assert fwd({"rate": 0.0}, {}, [x],
               TOpContext(training=True, generator=g))[0] is x
    assert fwd(attrs, {}, [x], TOpContext(training=True))[0] is x
    y = fwd(attrs, {}, [x], TOpContext(training=True, generator=g))[0]
    zero = y == 0
    assert abs(zero.float().mean().item() - 0.3) < 0.005
    torch.testing.assert_close(y[~zero], x[~zero] / 0.7, rtol=0, atol=0)
    again = fwd(attrs, {}, [x], TOpContext(
        training=True, generator=torch.Generator().manual_seed(1)))[0]
    assert torch.equal(y, again)
