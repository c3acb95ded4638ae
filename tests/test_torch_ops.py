"""Port ops vs the JAX package's ops, on the CPU: the same numpy inputs
through both. fp32 tolerances are 1e-5 unless stated; KV appends must be
exact."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from flexflow_tpu.ffconst import DataType as JDataType
from flexflow_tpu.ops import embedding as jemb
from flexflow_tpu.ops import inc_attention as jia
from flexflow_tpu.ops import linear as jlin
from flexflow_tpu.ops import norm as jnorm
from flexflow_tpu.ops.base import OpContext as JOpContext
from flexflow_tpu_torch.ops import embedding as temb
from flexflow_tpu_torch.ops import inc_attention as tia
from flexflow_tpu_torch.ops import linear as tlin
from flexflow_tpu_torch.ops import norm as tnorm
from flexflow_tpu_torch.ops.base import OpContext as TOpContext


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not torch.is_tensor(x) \
        else x.float().numpy()


def _rng(seed=0):
    return np.random.RandomState(seed)


def test_rotary_matches_jax():
    rng = _rng(1)
    pos = rng.randint(0, 200, (3, 5)).astype(np.int32)
    x = rng.randn(3, 5, 4, 64).astype(np.float32)
    jc, js = jia.rotary_cos_sin(jnp.asarray(pos), 64, 10000.0, jnp.float32)
    tc, ts = tia.rotary_cos_sin(torch.tensor(pos), 64, 10000.0,
                                torch.float32)
    np.testing.assert_allclose(_np(tc), _np(jc), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(ts), _np(js), atol=1e-5, rtol=1e-5)
    jy = jia.apply_rotary(jnp.asarray(x), jc, js)
    ty = tia.apply_rotary(torch.tensor(x), tc, ts)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(_np(tia.alibi_slopes(12)),
                               _np(jia.alibi_slopes(12)), rtol=1e-6)


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
def test_rms_norm_and_residual_match_jax(dtype, tol):
    rng = _rng(2)
    x = rng.randn(2, 3, 64).astype(np.float32)
    res = rng.randn(2, 3, 64).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    attrs = {"eps": 1e-5}
    jx, jr, jw = (jnp.asarray(a, jd) for a in (x, res, w))
    tx, tr, tw = (torch.tensor(a).to(td) for a in (x, res, w))
    jy = jnorm.RMSNorm.forward(attrs, {"weight": jw}, [jx], None)[0]
    ty = tnorm.RMSNorm.forward(attrs, {"weight": tw}, [tx], None)[0]
    assert ty.dtype == td
    np.testing.assert_allclose(_np(ty), _np(jy), atol=tol, rtol=tol)
    jadd, jn = jnorm.ResidualRMSNorm.forward(attrs, {"weight": jw},
                                             [jx, jr], None)
    tadd, tn = tnorm.ResidualRMSNorm.forward(attrs, {"weight": tw},
                                             [tx, tr], None)
    np.testing.assert_allclose(_np(tadd), _np(jadd), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(tn), _np(jn), atol=tol, rtol=tol)


def test_swiglu_matches_jax():
    rng = _rng(3)
    a, b = (rng.randn(2, 3, 32).astype(np.float32) for _ in range(2))
    jy = jnorm.SigmoidSiluMulti.forward({}, {}, [jnp.asarray(a),
                                                 jnp.asarray(b)], None)[0]
    ty = tnorm.SigmoidSiluMulti.forward({}, {}, [torch.tensor(a),
                                                 torch.tensor(b)], None)[0]
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-5, rtol=1e-5)


def test_embedding_matches_jax():
    rng = _rng(4)
    table = rng.randn(50, 16).astype(np.float32)
    ids = rng.randint(0, 50, (3, 4)).astype(np.int32)
    attrs = {"num_entries": 50, "out_dim": 16}
    jy = jemb.Embedding.forward(attrs, {"weight": jnp.asarray(table)},
                                [jnp.asarray(ids)], None)[0]
    ty = temb.Embedding.forward(attrs, {"weight": torch.tensor(table)},
                                [torch.tensor(ids)], None)[0]
    np.testing.assert_array_equal(_np(ty), _np(jy))


@pytest.mark.parametrize("keep_f32", [False, True])
def test_linear_keep_f32_logits_matches_jax(keep_f32):
    """bf16 operands; with keep_f32_logits the result is the fp32
    accumulator (compared to 1e-5), else bf16 (compared to 1e-2)."""
    rng = _rng(5)
    x = rng.randn(2, 3, 64).astype(np.float32)
    w = (0.1 * rng.randn(64, 96)).astype(np.float32)
    attrs = {"out_dim": 96, "use_bias": False, "keep_f32_logits": keep_f32}
    jy = jlin.Linear.forward(
        attrs, {"kernel": jnp.asarray(w, jnp.bfloat16)},
        [jnp.asarray(x, jnp.bfloat16)],
        JOpContext(compute_dtype=jnp.bfloat16))[0]
    ty = tlin.Linear.forward(
        attrs, {"kernel": torch.tensor(w).to(torch.bfloat16)},
        [torch.tensor(x).to(torch.bfloat16)],
        TOpContext(compute_dtype=torch.bfloat16))[0]
    want = torch.float32 if keep_f32 else torch.bfloat16
    assert ty.dtype == want and str(jy.dtype) == str(want).split(".")[1]
    tol = 1e-5 if keep_f32 else 1e-2
    np.testing.assert_allclose(_np(ty), _np(jy), atol=tol, rtol=tol)
    # the Linear's output spec says what its forward emits
    from flexflow_tpu_torch.ffconst import DataType

    shape, dt = tlin.Linear.infer_output_specs(
        attrs, [((2, 3, 64), DataType.DT_BFLOAT16)])[0]
    assert shape == (2, 3, 96) and dt.to_torch() == want


@pytest.mark.parametrize("kind", ["append_kv", "append_kv_stacked",
                                  "append_kv_contiguous"])
def test_kv_appends_match_jax(kind):
    """In-place appends of the port equal the JAX scatters exactly:
    padding tokens, inactive rows and columns past the cache end drop."""
    rng = _rng(6)
    L, R, KH, S, D, Q = 3, 4, 2, 16, 8, 3
    stack = rng.randn(L, R, KH, S, D).astype(np.float32)
    new = rng.randn(R, Q, KH, D).astype(np.float32)
    start = np.array([0, 5, 14, 2], np.int32)      # row 2 runs past S
    num = np.array([3, 1, 3, 2], np.int32)
    active = np.array([True, True, True, False])
    if kind == "append_kv_contiguous":
        start = np.array([0, 5, 13, 2], np.int32)   # in bounds, as promised
    tstack = torch.tensor(stack)
    jargs = (jnp.asarray(start), jnp.asarray(num), jnp.asarray(active))
    targs = (torch.tensor(start), torch.tensor(num), torch.tensor(active))
    if kind == "append_kv":
        want = jia.append_kv(jnp.asarray(stack[1]), jnp.asarray(new), *jargs)
        got = tia.append_kv(tstack[1], torch.tensor(new), *targs)
        assert got.data_ptr() == tstack[1].data_ptr()     # in place
        np.testing.assert_array_equal(_np(tstack[1]), _np(want))
        return
    if kind == "append_kv_stacked":
        want = jia.append_kv_stacked(jnp.asarray(stack), 1, jnp.asarray(new),
                                     *jargs)
        got = tia.append_kv_stacked(tstack, 1, torch.tensor(new), *targs)
    else:
        want = jia.append_kv_contiguous(jnp.asarray(stack), 1,
                                        jnp.asarray(new), jargs[0], jargs[2])
        got = tia.append_kv_contiguous(tstack, 1, torch.tensor(new),
                                       targs[0], targs[2])
    assert got is tstack
    np.testing.assert_array_equal(_np(tstack), _np(want))


def test_datatype_maps_to_torch():
    from flexflow_tpu_torch.ffconst import DataType

    assert DataType.DT_BFLOAT16.to_torch() == torch.bfloat16
    assert DataType.DT_FLOAT.to_torch() == torch.float32
    assert DataType.from_torch(torch.int32) == DataType.DT_INT32
    assert {d.name for d in DataType} == {d.name for d in JDataType}
