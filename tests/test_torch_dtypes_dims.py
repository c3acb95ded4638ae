"""The port's fp16 serving and its padded-head-dim cache layout against the
JAX package, on the CPU; and K3's split plan.

Same numpy inputs through both packages:

* the port's serving attention (``ops/inc_attention._attend``, the prefill
  and fused-decode paths) on a cache padded the way the card pads it
  (``cache_head_dim``: D = 16 -> 64, D = 80 -> 128) against the JAX
  package's ``reference_attend`` on the unpadded arrays, fp32, max abs
  error <= 1e-5 (only the summation order over the zero columns differs);
* a tiny LLaMA (``tests/conftest.py``'s geometry: hidden 64, 4 heads of 16)
  served by the port with the padded cache layout forced on the CPU
  against the JAX package's tokens (identical);
* the same with head dim 320 (hidden 640, 2 heads), on the 512-wide
  cache the card's wide kernels serve (identical);
* the same tiny LLaMA in fp16 (weights, activations, cache) through the
  port's plain path against the JAX package in fp16: identical tokens, or
  a difference at a stated near-tie of the JAX logits;
* ``kernel_serves``: the card serves a cache when the one predicate the
  kernel wrapper checks takes its dtype and (padded) head dim;
* K3's split plan: a function of (K, N, SM count) only, at most one
  cluster of 8 splits, every K chunk in exactly one split.

The CUDA kernels themselves run only on the card (``chip_smoke.py``
phase 3).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.ffconst import DataType as JDataType
from flexflow_tpu.ffconst import InferenceMode as JMode
from flexflow_tpu.kernels.attention import reference_attend as jax_attend
from flexflow_tpu.models.llama import LLAMAConfig as JLlamaConfig
from flexflow_tpu.models.llama import create_llama_model as jax_create_llama
from flexflow_tpu.serve.request_manager import RequestManager as JRM
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.ffconst import DataType, InferenceMode
from flexflow_tpu_torch.kernels import attention as tatt
from flexflow_tpu_torch.kernels.qmatmul import BK, split_plan
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.ops import inc_attention as tia
from flexflow_tpu_torch.serve.inference_manager import kernel_serves
from flexflow_tpu_torch.serve.request_manager import RequestManager

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
REQS = [([5, 9, 23, 44], 12), ([7, 3, 11], 12)]


# ----------------------------------------------------------------------
# 1. attention on a padded cache
# ----------------------------------------------------------------------
def _attn_inputs(D, R=3, Q=5, H=4, KH=2, S=96, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(R, Q, H, D).astype(np.float32)
    k = rng.randn(R, KH, S, D).astype(np.float32)
    v = rng.randn(R, KH, S, D).astype(np.float32)
    lengths = np.array([40, 96, 7], np.int32)
    qpos = (lengths[:, None] - Q + np.arange(Q)[None]).astype(np.int32)
    return q, k, v, lengths, qpos


@pytest.mark.parametrize("D, Dp", [(16, 64), (80, 128)])
def test_padded_cache_layout(D, Dp):
    """The card's cache head dim for D, and the CPU's exact one."""
    assert tia.cache_head_dim(D, pad=True) == Dp
    assert tia.cache_head_dim(D, pad=False) == D
    assert tatt.padded_head_dim(Dp) == Dp
    assert tatt.padded_head_dim(300) == 512   # the wide kernels' layout
    attrs = dict(max_requests=2, max_seq_length=32, num_kv_heads=2,
                 head_dim=D, cache_dtype="float32")
    st = tia._init_kv_state(attrs, [], "cpu")
    assert st["k_cache"].shape == (2, 2, 32, D)


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("D", [16, 80])
def test_attend_on_padded_cache_matches_jax(D, mode):
    """``_attend`` over a cache padded to the card's layout (q and the new
    K/V zero-padded, the output sliced back, the scale 1/sqrt(D)) against
    the JAX package's reference on the unpadded arrays: fp32, max abs
    error <= 1e-5."""
    q, k, v, lengths, qpos = _attn_inputs(D)
    Dp = tia.cache_head_dim(D, pad=True)
    attrs = dict(head_dim=D, num_q_heads=4, num_kv_heads=2)
    kp = tia.pad_head_dim(torch.tensor(k), Dp)
    vp = tia.pad_head_dim(torch.tensor(v), Dp)
    if mode == "prefill":
        out = tia._attend(attrs, torch.tensor(q), kp, vp,
                          torch.tensor(lengths), torch.tensor(qpos),
                          torch.float32, None)
        want = jax_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(lengths), jnp.asarray(qpos))
    else:
        rng = np.random.RandomState(1)
        kn = rng.randn(3, 1, 2, D).astype(np.float32)
        vn = rng.randn(3, 1, 2, D).astype(np.float32)
        appos = (lengths - 1).astype(np.int32)
        q1 = q[:, :1]
        out, kc, vc = tia._attend(
            attrs, torch.tensor(q1), kp, vp, torch.tensor(lengths),
            torch.tensor(appos[:, None]), torch.float32, None,
            append_kv=(torch.tensor(kn), torch.tensor(vn),
                       torch.tensor(appos)))
        assert kc.shape[-1] == Dp and bool((kc[..., D:] == 0).all())
        k2, v2 = k.copy(), v.copy()
        for r in range(3):
            k2[r, :, appos[r]] = kn[r, 0]
            v2[r, :, appos[r]] = vn[r, 0]
        np.testing.assert_array_equal(kc[..., :D].numpy(), k2)
        want = jax_attend(jnp.asarray(q1), jnp.asarray(k2), jnp.asarray(v2),
                          jnp.asarray(lengths), jnp.asarray(appos[:, None]))
    assert out.shape[-1] == 4 * D
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


# ----------------------------------------------------------------------
# 2. tiny LLaMA: padded cache forced on the CPU, and fp16
# ----------------------------------------------------------------------
_models = {}


def _pair(dtype, padded=False, monkeypatch=None, **geometry):
    """The tiny LLaMA in both packages with the JAX package's weights;
    ``padded`` allocates the port's cache in the card's padded layout;
    ``geometry`` overrides fields of TINY."""
    key = (dtype, padded, tuple(sorted(geometry.items())))
    if key not in _models:
        tiny = dict(TINY, **geometry)
        serve = dict(max_requests_per_batch=2, max_sequence_length=64,
                     max_tokens_per_batch=16, kv_cache_dtype=dtype, seed=0)
        jm = ff.FFModel(ff.FFConfig(use_native_scheduler=False,
                                    compute_dtype=dtype, **serve))
        jax_create_llama(jm, JLlamaConfig(**tiny),
                         mode=JMode.INC_DECODING_MODE,
                         data_type=JDataType(dtype))
        jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
        pm = fft.FFModel(fft.FFConfig(device="cpu", compute_dtype=dtype,
                                      **serve))
        create_llama_model(pm, LLAMAConfig(**tiny),
                           mode=InferenceMode.INC_DECODING_MODE,
                           data_type=DataType(dtype))
        if padded:
            monkeypatch.setattr(tia, "cache_head_dim",
                                lambda D, pad: tatt.padded_head_dim(D))
        pm.compile()
        load_params(pm, params_from_jax(jm.params))
        _models[key] = (jm, pm)
    return _models[key]


def _gen(rm, run):
    guids = [rm.register_new_request(p, max_new_tokens=n) for p, n in REQS]
    run(rm)
    return [rm.results[g].output_tokens for g in guids]


def test_tiny_llama_on_padded_cache_matches_jax(monkeypatch):
    """Head dim 16 served from a cache padded to 64 (the card's layout,
    forced on the CPU): the JAX package's tokens, exactly (fp32)."""
    jm, pm = _pair("float32", padded=True, monkeypatch=monkeypatch)
    assert pm.op_state["kv_cache"]["k"].shape[-1] == 64
    jout = _gen(JRM(), lambda rm: rm.generate_incr_decoding(jm))
    tout = _gen(RequestManager(), lambda rm: rm.generate_incr_decoding(pm))
    assert tout == jout
    assert all(len(t) == n for t, (_, n) in zip(tout, REQS))


def test_tiny_llama_head_dim_320_on_padded_cache_matches_jax(monkeypatch):
    """Head dim 320 (2 heads, 1 kv head) served from a cache padded to 512
    (the wide kernels' layout on the card, forced on the CPU): the JAX
    package's tokens, exactly (fp32)."""
    jm, pm = _pair("float32", padded=True, monkeypatch=monkeypatch,
                   hidden_size=640, num_attention_heads=2,
                   num_key_value_heads=1)
    assert pm.op_state["kv_cache"]["k"].shape[-1] == 512
    jout = _gen(JRM(), lambda rm: rm.generate_incr_decoding(jm))
    tout = _gen(RequestManager(), lambda rm: rm.generate_incr_decoding(pm))
    assert tout == jout
    assert all(len(t) == n for t, (_, n) in zip(tout, REQS))


def _logit_gap(jm, seq):
    """The JAX verifier's top-2 logit gap after ``seq`` (one fp32 forward
    of the sequence through the JAX package's own serving step)."""
    from flexflow_tpu.ops.base import OpContext
    from flexflow_tpu.serve.batch_config import make_batch_meta

    R, Q = jm.config.max_requests_per_batch, len(seq)
    tokens = np.zeros((R, Q), np.int32)
    tokens[0] = seq
    num = np.zeros((R,), np.int32)
    num[0] = Q
    meta = make_batch_meta(R, Q, tokens=tokens,
                           positions=np.tile(np.arange(Q, dtype=np.int32),
                                             (R, 1)),
                           num_tokens=num, active=num > 0)
    head = next(layer for layer in jm.layers if layer.name == "lm_head")
    values, _ = jm._run_graph(jm.params, {jm.input_tensors[0].tensor_id:
                                          jnp.asarray(meta.tokens)},
                              OpContext(compute_dtype=jnp.float32,
                                        batch_config=meta),
                              jm.op_state)
    top = np.sort(np.asarray(values[head.outputs[0].tensor_id],
                             np.float32)[0, Q - 1])
    return float(top[-1] - top[-2])


def test_tiny_llama_fp16_matches_jax():
    """fp16 weights, activations and cache through the port's plain path
    and through the JAX package: the same tokens, or a first difference
    where the JAX logits' top-2 gap is a near-tie (< 2e-2, fp16's spacing
    at the logits' size times the rounding steps of two layers)."""
    jm, pm = _pair("float16")
    assert pm.op_state["kv_cache"]["k"].dtype == torch.float16
    jout = _gen(JRM(), lambda rm: rm.generate_incr_decoding(jm))
    tout = _gen(RequestManager(), lambda rm: rm.generate_incr_decoding(pm))
    assert all(len(t) == n for t, (_, n) in zip(tout, REQS))
    for (p, _), a, b in zip(REQS, tout, jout):
        if a != b:
            j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
            assert _logit_gap(jm, p + b[:j]) < 2e-2, (j, a, b)


# ----------------------------------------------------------------------
# 3. kernel_serves and the wrapper's predicate
# ----------------------------------------------------------------------
class _Meta:
    def __init__(self, caches):
        self.op_state = {"kv_cache": {"k": caches[0], "v": caches[0]}}


@pytest.mark.parametrize("dtype, D, want", [
    (torch.float16, 64, True), (torch.bfloat16, 256, True),
    (torch.float32, 128, True), (torch.float16, 80, False),
    (torch.float64, 64, False), (torch.bfloat16, 512, True),
    (torch.float32, 768, True), (torch.bfloat16, 320, False)])
def test_kernel_serves_asks_the_wrapper_predicate(dtype, D, want):
    """``kernel_serves`` answers from ``kernel_takes`` on each cache as
    allocated: a device, a dtype and a (padded) head dim; never on the
    CPU. The meta tensors carry the shape and dtype without memory."""
    cache = torch.empty((2, 2, 2, 32, D), dtype=dtype, device="meta")
    assert tatt.kernel_takes("cuda", 32, D, dtype) is want
    assert tatt.kernel_takes("cpu", 32, D, dtype) is False
    assert kernel_serves(_Meta([cache])) is False     # not on the card
    m = _Meta([cache])
    m.op_state["kv_cache"]["k"] = _Cuda(cache)
    assert kernel_serves(m) is want


class _Cuda:
    """A cache's shape and dtype, as if it lay on the card."""

    def __init__(self, t):
        self.shape, self.dtype = t.shape, t.dtype
        self.device = torch.device("cuda")


# ----------------------------------------------------------------------
# 4. K3's split plan
# ----------------------------------------------------------------------
@pytest.mark.parametrize("K, N", [(4096, 4096), (4096, 11008), (11008, 4096),
                                  (4096, 32000), (4096, 12288), (4096, 22016),
                                  (4095, 1000), (64, 128), (300, 4096)])
@pytest.mark.parametrize("sms", [132, 114, 16])
def test_split_plan_is_one_cluster_covering_k_once(K, N, sms):
    """The plan's splits form one thread-block cluster (at most 8, and the
    cluster is exactly the splits, so its size divides their count), no
    split is empty, every BK chunk of K lies in exactly one split, and
    the plan takes no M: the same plan serves every batch size."""
    splits, cps = split_plan(K, N, sms)
    chunks = -(-K // BK)
    assert 1 <= splits <= 8
    owner = [c // cps for c in range(chunks)]
    assert sorted(set(owner)) == list(range(splits))
    assert all(owner.count(s) >= 1 for s in range(splits))
    assert list(inspect.signature(split_plan).parameters) == ["K", "N",
                                                              "sms"]
