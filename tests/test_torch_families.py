"""The port's OPT, Falcon, MPT and StarCoder against the JAX package, on
the CPU.

Every new op (LayerNorm and the residual LayerNorms, the unary, binary,
``Pow`` and scalar ops) is run through both packages' op
implementations on the same seeded inputs: fp32 to 1e-6, bf16 to 2e-2.
Each family (Falcon in its three block layouts) is built at the
``checkpoint_store.TINY_CONFIGS`` geometry (2 request slots, a 64-position
fp32 cache) in both packages, the JAX model's weights crossing through
``params_from_jax``: prefill and decode logits agree to 1e-5, and
``LLM.generate`` on the JAX model's HF state dict (the fused qkv layouts
included) gives identical greedy tokens. SpecInfer (the chain engine and
the fused tree engine) gives incremental decoding's tokens and the JAX
package's for OPT (learned positions, offset 2, at tree positions) and
MPT (ALiBi under the tree bias); int8 Falcon with 64-column k/v
projections gives the JAX package's int8 tokens. The JAX side runs its
CPU path (plain attention, no Pallas).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.ffconst import InferenceMode as JMode
from flexflow_tpu.ffconst import OpType as JOpType
from flexflow_tpu.models import FAMILIES as JFAMILIES
from flexflow_tpu.models.checkpoint_store import \
    export_hf_state_dict as jax_export
from flexflow_tpu.models.checkpoint_store import \
    hf_config_dict as jax_hf_config
from flexflow_tpu.ops.base import OpContext as JOpContext
from flexflow_tpu.ops.base import get_op_impl as jax_op
from flexflow_tpu.serve.api import LLM as JLLM
from flexflow_tpu.serve.api import SSM as JSSM
from flexflow_tpu.serve.batch_config import make_batch_meta as jax_meta
from flexflow_tpu.serve.engine import build_feeds as jax_feeds
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.ffconst import InferenceMode, OpType
from flexflow_tpu_torch.models import FAMILIES, family_for_hf_config
from flexflow_tpu_torch.models.checkpoint_store import TINY_CONFIGS
from flexflow_tpu_torch.ops.base import OpContext, get_op_impl
from flexflow_tpu_torch.serve.batch_config import make_batch_meta
from flexflow_tpu_torch.serve.engine import build_feeds
from flexflow_tpu_torch.serve.request_manager import RequestManager

R, S = 2, 64
SERVE = dict(max_requests_per_batch=R, max_sequence_length=S,
             max_tokens_per_batch=16, seed=0, kv_cache_dtype="float32")
LLM_KW = dict(max_requests_per_batch=R, max_seq_length=S,
              max_tokens_per_batch=16, kv_cache_dtype="float32")
PROMPTS = [list(range(1, 21)), [3, 4], [7, 8, 9], [100, 5, 17, 42]]
# variant -> (family, config overrides on TINY_CONFIGS)
VARIANTS = {
    "opt": ("opt", {}),
    "falcon-parallel": ("falcon", {}),
    "falcon-sequential": ("falcon", dict(parallel_attn=False, bias=True)),
    "falcon-newarch": ("falcon", dict(new_decoder_architecture=True,
                                      num_kv_heads=2)),
    "mpt": ("mpt", {}),
    "gpt_bigcode": ("gpt_bigcode", {}),
}
TOL = {"float32": 1e-6, "bfloat16": 2e-2}


# ----------------------------------------------------------------------
# 1. ops
# ----------------------------------------------------------------------
def _draw(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x, dtype=getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _run_op(name, attrs, n_in, params, dtype, seed=0, shape=(3, 5, 64),
            positive=False):
    """One op through both packages on the same seeded inputs; returns
    (jax outputs, port outputs) as fp32 numpy."""
    rng = np.random.default_rng(seed)
    ins = [_draw(rng, shape, dtype) for _ in range(n_in)]
    if positive:
        ins = [(jnp.abs(j) + 0.5, t.abs() + 0.5) for j, t in ins]
    jp = {k: _draw(rng, (shape[-1],), dtype)[0] for k in params}
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        getattr(torch, dtype)) for k, v in jp.items()}
    jattrs = dict(attrs, op_type=getattr(JOpType, name))
    tattrs = dict(attrs, op_type=getattr(OpType, name))
    jout = jax_op(jattrs["op_type"]).forward(
        jattrs, jp, [j for j, _ in ins], JOpContext())
    tout = get_op_impl(tattrs["op_type"]).forward(
        tattrs, tp, [t for _, t in ins], OpContext())
    return ([np.asarray(o, np.float32) for o in jout],
            [o.float().numpy() for o in tout])


OP_CASES = {
    "layernorm": ("LAYERNORM", dict(axes=(-1,), eps=1e-5), 1,
                  ("gamma", "beta")),
    "layernorm-gamma-only": ("LAYERNORM", dict(axes=(-1,), eps=1e-5,
                                               use_bias=False), 1,
                             ("gamma",)),
    "layernorm-no-affine": ("LAYERNORM", dict(axes=(-1,), eps=1e-5,
                                              elementwise_affine=False), 1,
                            ()),
    "residual-layernorm": ("RESIDUAL_LAYERNORM", dict(axes=(2,)), 2,
                           ("gamma", "beta")),
    "residual-layernorm-two": ("RESIDUAL_LAYERNORM", dict(axes=(2,)), 3,
                               ("gamma",)),
    "add-bias-residual-layernorm": ("ADD_BIAS_RESIDUAL_LAYERNORM",
                                    dict(axes=(2,)), 2,
                                    ("attn_bias", "gamma", "beta")),
    "gelu-exact": ("GELU", {}, 1, ()),
    "gelu-tanh": ("GELU", dict(approximate=True), 1, ()),
    "relu": ("RELU", {}, 1, ()),
    "sigmoid": ("SIGMOID", {}, 1, ()),
    "tanh": ("TANH", {}, 1, ()),
    "elu": ("ELU", {}, 1, ()),
    "exp": ("EXP", {}, 1, ()),
    "sin-cos": ("SIN", {}, 1, ()),
    "identity": ("IDENTITY", {}, 1, ()),
    "pow": ("POW", dict(exponent=3.0), 1, ()),
    "scalar-multiply": ("SCALAR_MULTIPLY", dict(scalar=0.7), 1, ()),
    "scalar-true-div": ("SCALAR_TRUE_DIV", dict(scalar=3.0), 1, ()),
}
BINARY = ("EW_SUB", "EW_MUL", "EW_MAX", "EW_MIN")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(OP_CASES))
def test_op_matches_jax(case, dtype):
    name, attrs, n_in, params = OP_CASES[case]
    jout, tout = _run_op(name, attrs, n_in, params, dtype)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        np.testing.assert_allclose(t, j, atol=TOL[dtype], rtol=TOL[dtype])
    if case == "sin-cos":
        jout, tout = _run_op("COS", attrs, 1, (), dtype)
        np.testing.assert_allclose(tout[0], jout[0], atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_binary_and_positive_ops_match_jax(dtype):
    for name in BINARY:
        jout, tout = _run_op(name, {}, 2, (), dtype, seed=1)
        np.testing.assert_allclose(tout[0], jout[0], atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=name)
    for name in ("EW_DIV", "RSQRT"):   # operands away from 0
        n = 2 if name == "EW_DIV" else 1
        jout, tout = _run_op(name, {}, n, (), dtype, seed=2, positive=True)
        np.testing.assert_allclose(tout[0], jout[0], atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=name)
    # broadcasting: [3, 5, 64] - [64]
    rng = np.random.default_rng(3)
    a, b = _draw(rng, (3, 5, 64), dtype), _draw(rng, (64,), dtype)
    jout = jax_op(JOpType.EW_SUB).forward(
        {"op_type": JOpType.EW_SUB}, {}, [a[0], b[0]], JOpContext())
    tout = get_op_impl(OpType.EW_SUB).forward(
        {"op_type": OpType.EW_SUB}, {}, [a[1], b[1]], OpContext())
    np.testing.assert_allclose(tout[0].float().numpy(),
                               np.asarray(jout[0], np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    spec = get_op_impl(OpType.EW_SUB).infer_output_specs(
        {}, [((3, 5, 64), None), ((64,), None)])
    assert spec[0][0] == (3, 5, 64)


def test_layernorm_weights_and_builders():
    """Weight specs as the JAX package's (none without affine, gamma only
    without bias, attn_bias first), and the builders record the ops."""
    for attrs, names in ((dict(axes=(-1,)), ["gamma", "beta"]),
                         (dict(axes=(-1,), use_bias=False), ["gamma"]),
                         (dict(axes=(-1,), elementwise_affine=False), [])):
        spec = [((2, 64), fft.DataType.DT_FLOAT)]
        ws = get_op_impl(OpType.LAYERNORM).weight_specs(attrs, spec)
        assert [w.name for w in ws] == names
        assert all(tuple(w.shape) == (64,) for w in ws)
    ws = get_op_impl(OpType.ADD_BIAS_RESIDUAL_LAYERNORM).weight_specs(
        dict(axes=(1,)), [((2, 64), fft.DataType.DT_FLOAT)] * 2)
    assert [w.name for w in ws] == ["attn_bias", "gamma", "beta"]
    m = fft.FFModel(fft.FFConfig(device="cpu"))
    x = m.create_tensor([2, 64])
    added, normed = m.residual_layer_norm(x, x, axes=[-1])
    assert m.layers[-1].attrs["axes"] == (1,)
    for b in ("relu", "sigmoid", "tanh", "elu", "identity", "exp", "sin",
              "cos", "rsqrt"):
        assert getattr(m, b)(x).dims == (2, 64)
    assert m.gelu(x, approximate=True).owner_layer.attrs["approximate"]
    for b in ("subtract", "multiply", "divide", "max", "min"):
        assert getattr(m, b)(x, normed).dims == (2, 64)
    assert m.pow(x, 2.0).dims == m.scalar_add(x, 1.0).dims == (2, 64)


# ----------------------------------------------------------------------
# 2. the families, built once per module
# ----------------------------------------------------------------------
_models = {}


def _config(variant, **extra):
    family, over = VARIANTS[variant]
    return family, {**TINY_CONFIGS[family], **over, **extra}


def _pair(variant, mode=InferenceMode.INC_DECODING_MODE, **extra):
    """(jax model, port model with the same weights, family, config)."""
    key = (variant, mode, tuple(sorted(extra.items())))
    if key not in _models:
        family, cfg = _config(variant, **extra)
        jfam, fam = JFAMILIES[family], FAMILIES[family]
        jm = ff.FFModel(ff.FFConfig(use_native_scheduler=False, **SERVE))
        jfam.build(jm, jfam.config_cls(**cfg), mode=JMode(mode.value))
        jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
        pm = fft.FFModel(fft.FFConfig(device="cpu", **SERVE))
        fam.build(pm, fam.config_cls(**cfg), mode=mode)
        pm.compile()
        load_params(pm, params_from_jax(
            {layer: {w: np.asarray(a) for w, a in lp.items()}
             for layer, lp in jm.params.items()}))
        _models[key] = (jm, pm, family, jfam.config_cls(**cfg))
    return _models[key]


def _logits_tid(model):
    return next(layer for layer in model.layers
                if layer.name == "lm_head").outputs[0].tensor_id


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_prefill_and_decode_logits_match_jax(variant):
    """A chunked prefill (K1's plain path) and a decode step (K2's), fed
    through both packages' ``build_feeds`` (the position input at the
    family's offset); logits and the KV caches to 1e-5."""
    jm, pm, _, _ = _pair(variant)
    assert set(pm.params) == set(jm.params)
    for layer, lp in jm.params.items():
        assert {w: tuple(a.shape) for w, a in lp.items()} == \
            {w: tuple(t.shape) for w, t in pm.params[layer].items()}
    Q = 8
    toks = np.zeros((R, Q), np.int32)
    toks[0, :5] = [5, 9, 33, 2, 7]
    toks[1, :3] = [11, 12, 13]
    num = np.array([5, 3], np.int32)
    prefill = dict(tokens=toks, positions=np.tile(np.arange(Q, dtype=np.int32),
                                                  (R, 1)),
                   start_pos=np.zeros(R, np.int32), num_tokens=num,
                   active=np.ones(R, bool))
    decode = dict(tokens=np.array([[4], [6]], np.int32),
                  positions=num[:, None].copy(), start_pos=num.copy(),
                  num_tokens=np.ones(R, np.int32), active=np.ones(R, bool))
    jstate = jm.op_state
    tstate = {n: {k: t.clone() for k, t in st.items()}
              for n, st in pm.op_state.items()}
    for step, contiguous in ((prefill, False), (decode, True)):
        q = step["tokens"].shape[1]
        jmeta = jax_meta(R, q, **step)
        jctx = JOpContext(compute_dtype=jnp.float32, batch_config=jmeta,
                          mesh=jm.mesh, config=jm.config)
        jctx.kv_contiguous = contiguous
        jvals, jstate = jm._run_graph(jm.params, jax_feeds(jm, jmeta), jctx,
                                      jstate)
        tmeta = make_batch_meta(R, q, **step)
        tvals, tstate = pm._run_graph(
            pm.params, build_feeds(pm, tmeta),
            OpContext(compute_dtype=torch.float32, batch_config=tmeta,
                      kv_contiguous=contiguous), tstate)
        real = np.arange(q)[None, :] < step["num_tokens"][:, None]
        np.testing.assert_allclose(
            tvals[_logits_tid(pm)].numpy()[real],
            np.asarray(jvals[_logits_tid(jm)])[real], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tstate["kv_cache"]["k"].numpy(),
                               np.asarray(jstate["kv_cache"]["k"]),
                               atol=1e-5, rtol=1e-5)


def _hf(variant, **extra):
    """(HF config dict, HF state dict) of the JAX model's weights, in the
    genuine HF layout (fused qkv where the family fuses)."""
    jm, _, family, cfg = _pair(variant, **extra)
    return (jax_hf_config(family, cfg),
            {k: np.array(v) for k, v in jax_export(jm, family, cfg).items()})


def _tokens(results):
    return [r.output_tokens for r in results]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_llm_generate_identical_tokens(variant):
    """``LLM((hf_config, state_dict))`` in both packages: more prompts
    than slots, a prompt longer than the prefill chunk."""
    hf, sd = _hf(variant)
    jres = JLLM((hf, dict(sd))).compile(use_native_scheduler=False,
                                        **LLM_KW).generate(PROMPTS, 12)
    tllm = fft.LLM((hf, dict(sd))).compile(device="cpu", **LLM_KW)
    tres = tllm.generate(PROMPTS, max_new_tokens=12)
    assert _tokens(tres) == _tokens(jres)
    assert all(len(t) == 12 for t in _tokens(tres))
    if variant == "opt":
        assert tllm.ffmodel.position_offset == 2
        assert tllm.ffmodel._position_rows == TINY_CONFIGS["opt"][
            "max_position_embeddings"] + 2


@pytest.mark.parametrize("engine", ["chain", "tree"])
@pytest.mark.parametrize("variant", ["opt", "mpt"])
def test_spec_infer_matches_incr_and_jax(variant, engine):
    """SpecInfer with a 1-layer draft (the verifier's first layer: both
    packages seed weights by name), depth 4, the controller off: the
    port's tokens equal its incremental decoding's and the JAX package's.
    ``tree`` runs the fused tree engine, whose verify pass feeds tree
    positions (OPT: + 2) and, for MPT, ALiBi beside the tree bias."""
    from flexflow_tpu.serve.batch_config import GenerationConfig as JGen
    from flexflow_tpu.serve.request_manager import RequestManager as JRM
    from flexflow_tpu_torch.serve.batch_config import GenerationConfig

    jv, tv, _, _ = _pair(variant, InferenceMode.TREE_VERIFY_MODE)
    layers = {"opt": "num_hidden_layers", "mpt": "n_layers"}[variant]
    jd, td, _, _ = _pair(variant, InferenceMode.BEAM_SEARCH_MODE,
                         **{layers: 1})
    reqs = [([5, 9, 23, 44], 14), ([7, 3, 11], 14), (list(range(1, 21)), 10)]

    def gen(rm, run):
        guids = [rm.register_new_request(p, max_new_tokens=n)
                 for p, n in reqs]
        run(rm)
        return [rm.results[g].output_tokens for g in guids]

    def spec(rm, llm, ssm, gc):
        if engine == "tree":
            return rm._generate_spec_tree_fused(llm, [ssm], spec_depth=4,
                                                generation_config=gc)
        return rm.generate_spec_infer(llm, [ssm], spec_depth=4,
                                      generation_config=gc)

    incr = gen(RequestManager(), lambda rm: rm.generate_incr_decoding(tv))
    tout = gen(RequestManager(), lambda rm: spec(
        rm, tv, td, GenerationConfig(adaptive_spec=False)))
    jout = gen(JRM(), lambda rm: spec(rm, jv, jd,
                                      JGen(adaptive_spec=False)))
    assert tout == incr
    assert tout == jout
    assert [len(t) for t in tout] == [n for _, n in reqs]


def test_llm_with_ssm_generate_matches_jax_for_starcoder():
    """``LLM(...).compile(ssms=[SSM(...)])`` on StarCoder (multi-query,
    learned positions + 0) in both packages."""
    hf, sd = _hf("gpt_bigcode")
    hf_d = dict(hf, n_layer=1)
    sd_d = {k: v for k, v in sd.items() if ".h.1." not in k}
    jllm = JLLM((hf, dict(sd))).compile(
        ssms=[JSSM((hf_d, dict(sd_d)))], use_native_scheduler=False,
        **LLM_KW)
    tllm = fft.LLM((hf, dict(sd))).compile(
        ssms=[fft.SSM((hf_d, dict(sd_d)))], device="cpu", **LLM_KW)
    assert (_tokens(tllm.generate(PROMPTS[:3], max_new_tokens=10))
            == _tokens(jllm.generate(PROMPTS[:3], max_new_tokens=10)))


def test_falcon_int8_with_64_column_kv_leaves_matches_jax():
    """Falcon at head dim 64 with one KV head: ``wk``/``wv`` are [256, 64]
    and quantize (min dim 64) in both packages, bit for bit; int8 tokens
    through ``LLM.compile(quantization_type="int8")`` equal the JAX
    package's."""
    extra = dict(hidden_size=256)
    hf, sd = _hf("falcon-parallel", **extra)
    jllm = JLLM((hf, dict(sd))).compile(use_native_scheduler=False,
                                        quantization_type="int8", **LLM_KW)
    tllm = fft.LLM((hf, dict(sd))).compile(device="cpu",
                                           quantization_type="int8", **LLM_KW)
    wk = tllm.ffmodel.params["h.0.self_attention"]["wk"]
    jwk = jllm.ffmodel.params["h.0.self_attention"]["wk"]
    assert wk.shape == (256, 64) and wk.qtype == "int8"
    np.testing.assert_array_equal(wk.q.numpy(), np.asarray(jwk.q))
    np.testing.assert_array_equal(wk.scale.numpy(), np.asarray(jwk.scale))
    assert (_tokens(tllm.generate(PROMPTS, max_new_tokens=12))
            == _tokens(jllm.generate(PROMPTS, max_new_tokens=12)))


@pytest.mark.parametrize("alias", sorted(JFAMILIES))
def test_family_for_hf_config_every_alias(alias):
    fam = family_for_hf_config({"model_type": alias})
    assert fam.name == JFAMILIES[alias].name
    assert fam.config_cls.__name__ == JFAMILIES[alias].config_cls.__name__
    assert set(FAMILIES) == set(JFAMILIES)
    with pytest.raises(ValueError, match="unsupported model_type"):
        family_for_hf_config({"model_type": "gpt2"})


def test_positions_clamped_into_the_table():
    """Padding tokens of a width-8 decode near the cache end and positions
    of inactive rows fall outside OPT's 66-row table: the feed clamps them
    (a CUDA gather would stop the process); real rows are unchanged."""
    _, pm, _, _ = _pair("opt")
    rows = pm._position_rows
    pos = torch.tensor([[60, 61, 62, 63, 64, 65, 66, 67], [-3] * 8],
                       dtype=torch.int32)
    meta = make_batch_meta(R, 8, positions=pos.numpy())
    fed = build_feeds(pm, meta)[pm.position_input_tensor.tensor_id]
    assert fed.max().item() == rows - 1 and fed.min().item() == 0
    assert fed[0, :4].tolist() == [62, 63, 64, 65]
