"""The port's serving GEMM fusion (``serve/gemm_fusion.py``), on the CPU.

Mirrors ``tests/test_gemm_fusion.py``: the fused qkv and SwiGLU gate|up
GEMMs are a pure program transformation (the tokens of the unfused
graph, which are the JAX package's for the same weights), the rewrite
refuses graphs it cannot fuse safely, it is gated by ``enable_fusion``
and off by default, and ``get/set_parameter_by_key`` keep serving the
pre-fusion names on plain and quantized leaves. A tiny LLaMA (vocab 128,
hidden 128, intermediate 96, 2 layers, 4 heads; 2 request slots, fp32
KV cache); and the other four families (multi-query Falcon, OPT, MPT and
StarCoder at ``checkpoint_store.TINY_CONFIGS``), whose qkv fuses, each
against the JAX package's tokens.
"""

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.ffconst import InferenceMode as JMode
from flexflow_tpu.models.llama import LLAMAConfig as JLlamaConfig
from flexflow_tpu.models.llama import create_llama_model as jax_create_llama
from flexflow_tpu.serve.request_manager import RequestManager as JRM
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.ffconst import DataType, InferenceMode, OpType
from flexflow_tpu_torch.models.llama import (LLAMAConfig, create_llama_model,
                                             hf_weight_map)
from flexflow_tpu_torch.quant import is_quantized
from flexflow_tpu_torch.serve.batch_config import GenerationConfig
from flexflow_tpu_torch.serve.request_manager import RequestManager

PROMPT = [5, 9, 23, 7]
SERVE = dict(max_requests_per_batch=2, max_sequence_length=64,
             max_tokens_per_batch=16, kv_cache_dtype="float32")


def _tiny(kv_heads=2):
    return dict(vocab_size=128, hidden_size=128, intermediate_size=96,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=kv_heads, max_position_embeddings=64)


def _build(quant=None, fusion=True, kv_heads=2, mode=None, seed=3,
           enable=True):
    m = fft.FFModel(fft.FFConfig(device="cpu", quantization_type=quant,
                                 enable_fusion=enable, gemm_fusion=fusion,
                                 seed=seed, **SERVE))
    create_llama_model(m, LLAMAConfig(**_tiny(kv_heads)),
                       mode=mode or InferenceMode.INC_DECODING_MODE)
    m.compile()
    return m


def _gen(m):
    rm = RequestManager()
    g = rm.register_new_request(list(PROMPT), max_new_tokens=6)
    rm.generate_incr_decoding(m)
    return rm.results[g].output_tokens


_jax = {}


def _jax_model(quant, kv_heads):
    """The JAX package's unfused model and its tokens, built once each."""
    key = (quant, kv_heads)
    if key not in _jax:
        jm = ff.FFModel(ff.FFConfig(use_native_scheduler=False,
                                    quantization_type=quant, seed=3,
                                    **SERVE))
        jax_create_llama(jm, JLlamaConfig(**_tiny(kv_heads)),
                         mode=JMode.INC_DECODING_MODE)
        jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
        rm = JRM()
        rm.register_new_request(list(PROMPT), max_new_tokens=6)
        _jax[key] = (jm, rm.generate_incr_decoding(jm)[0].output_tokens)
    return _jax[key]


@pytest.mark.parametrize("kv_heads", [4, 2, 1])      # MHA, GQA, MQA
@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_fused_tokens_match_unfused_and_jax(quant, kv_heads):
    """Fused == unfused == the JAX package's tokens for the same weights;
    the fused qkv slices honour KH != H widths (MQA: H*D vs D vs D). A
    quantized MQA layer keeps its [128, 32] wk/wv in float (below the
    64-wide quantization floor): mixed leaves are not fused."""
    jm, jtok = _jax_model(quant, kv_heads)
    models = []
    for fusion in (False, True):
        m = _build(quant, fusion, kv_heads)
        load_params(m, params_from_jax(jm.params))
        models.append(m)
    base, fused = _gen(models[0]), _gen(models[1])   # IFM applies fusion
    assert base == jtok
    assert fused == base
    m = models[1]
    lp = m.params["layers.0.self_attn"]
    if quant and 32 * kv_heads < 64:
        assert "wq" in lp and "wqkv" not in lp
    else:
        assert "wqkv" in lp and "wq" not in lp
        assert lp["wqkv"].shape == (128, 128 + 2 * 32 * kv_heads)
        assert is_quantized(lp["wqkv"]) == bool(quant)
    names = [ly.name for ly in m.layers]
    assert "layers.0.mlp.gate_proj|up_proj" in names
    assert "layers.0.mlp.gate_proj" not in m.params
    assert "layers.0.mlp.up_proj" not in m.params
    ssm = next(ly for ly in m.layers
               if ly.op_type == OpType.SIGMOID_SILU_MULTI)
    assert ssm.attrs.get("packed") and len(ssm.inputs) == 1


@pytest.mark.parametrize("enable, gemm", [(True, False), (False, True)])
def test_fusion_is_gated(enable, gemm):
    """gemm_fusion is an explicit opt-in, and enable_fusion=False gates it
    even with gemm_fusion=True."""
    m = _build(fusion=gemm, enable=enable)
    _gen(m)
    m.finalize_gemm_fusion()
    assert "wq" in m.params["layers.0.self_attn"]
    assert "layers.0.mlp.gate_proj" in m.params


def test_gemm_fusion_defaults_off():
    cfg = fft.FFConfig(device="cpu")
    assert cfg.enable_fusion and not cfg.gemm_fusion
    m = fft.FFModel(cfg)
    create_llama_model(m, LLAMAConfig(**_tiny()))
    m.compile()
    m.finalize_gemm_fusion()
    assert "wq" in m.params["layers.0.self_attn"]


def _attn_model(fusion, bias=True):
    """A one-attention-layer serving graph whose qkv projections carry
    biases (OPT/StarCoder-style), with random biases."""
    m = fft.FFModel(fft.FFConfig(device="cpu", gemm_fusion=fusion, seed=5,
                                 **SERVE))
    t = m.create_tensor([2, 1], DataType.DT_INT32)
    h = m.embedding(t, 128, 64, name="embed_tokens")
    a = m.inc_multiquery_self_attention(h, 64, 4, 4, bias=bias,
                                        apply_rotary_embedding=True,
                                        name="layers.0.self_attn")
    m.argmax(m.dense(m.add(h, a), 128, use_bias=False, keep_f32_logits=True,
                     name="lm_head"))
    m.compile()
    rng = np.random.RandomState(0)
    for b in ("bq", "bk", "bv", "bo"):
        if b in m.params["layers.0.self_attn"]:
            m.set_parameter_by_key(("layers.0.self_attn", b),
                                   0.5 * rng.randn(64).astype(np.float32))
    return m


def test_qkv_bias_concat():
    base = _gen(_attn_model(False))
    m = _attn_model(True)
    assert _gen(m) == base
    lp = m.params["layers.0.self_attn"]
    assert "bqkv" in lp and "bq" not in lp and "bo" in lp


def test_partial_qkv_bias_set_is_not_fused():
    m = _attn_model(True)
    del m.params["layers.0.self_attn"]["bv"]
    m.finalize_gemm_fusion()
    lp = m.params["layers.0.self_attn"]
    assert "wq" in lp and "wqkv" not in lp and "bq" in lp


def test_swiglu_fusion_skips_shared_gate_output():
    """If the gate tensor has a second consumer, the MLP pair must not
    fuse (the rewrite would orphan that consumer's input)."""
    m = fft.FFModel(fft.FFConfig(device="cpu", gemm_fusion=True))
    t = m.create_tensor([2, 8], DataType.DT_FLOAT)
    g = m.dense(t, 8, use_bias=False, name="gate")
    u = m.dense(t, 8, use_bias=False, name="up")
    s = m.sigmoid_silu_multi(g, u)
    m.add(s, g)                       # second consumer of the gate output
    m.compile()
    m.finalize_gemm_fusion()
    assert "gate" in m.params and "up" in m.params


@pytest.mark.parametrize("quant", [None, "int8", "int4"])
def test_fused_param_accessors_roundtrip(quant):
    """get/set_parameter_by_key keep serving the pre-fusion names by
    slicing / splicing the fused leaves; a quantized leaf re-quantizes
    only the touched columns."""
    m = _build(quant, True)
    _gen(m)                                   # applies fusion
    akey = ("layers.0.self_attn", "wq")
    w = m.get_parameter_by_key(akey)
    assert w.shape == (128, 128)
    wk_before = m.get_parameter_by_key(("layers.0.self_attn", "wk"))
    new = np.full_like(w, 0.01)
    m.set_parameter_by_key(akey, new)
    tol = dict(rtol=0.02, atol=1e-4) if quant else dict(rtol=1e-6)
    np.testing.assert_allclose(m.get_parameter_by_key(akey), new, **tol)
    np.testing.assert_array_equal(                 # neighbours untouched
        m.get_parameter_by_key(("layers.0.self_attn", "wk")), wk_before)
    gkey = ("layers.0.mlp.gate_proj", "kernel")
    g = m.get_parameter_by_key(gkey)
    assert g.shape == (128, 96)
    up_before = m.get_parameter_by_key(("layers.0.mlp.up_proj", "kernel"))
    m.set_parameter_by_key(gkey, np.full_like(g, 0.02))
    np.testing.assert_allclose(m.get_parameter_by_key(gkey),
                               np.full_like(g, 0.02), **tol)
    np.testing.assert_array_equal(
        m.get_parameter_by_key(("layers.0.mlp.up_proj", "kernel")),
        up_before)
    with pytest.raises(ValueError):
        m.set_parameter_by_key(akey, np.zeros(128, np.float32))


def test_fused_accessors_on_undotted_names():
    m = fft.FFModel(fft.FFConfig(device="cpu", gemm_fusion=True))
    t = m.create_tensor([2, 64], DataType.DT_FLOAT)
    g = m.dense(t, 64, use_bias=False, name="gate")
    u = m.dense(t, 64, use_bias=False, name="up")
    s = m.sigmoid_silu_multi(g, u)
    m.dense(s, 8, use_bias=False)
    m.compile()
    m.finalize_gemm_fusion()
    assert "gate" not in m.params and "gate|up" in m.params
    w = m.get_parameter_by_key(("up", "kernel"))
    assert w.shape == (64, 64)
    new = np.full_like(w, 0.03)
    m.set_parameter_by_key(("up", "kernel"), new)
    np.testing.assert_allclose(m.get_parameter_by_key(("up", "kernel")),
                               new, rtol=1e-6)


def test_finalize_before_compile_does_not_latch():
    m = fft.FFModel(fft.FFConfig(device="cpu", gemm_fusion=True, **SERVE))
    create_llama_model(m, LLAMAConfig(**_tiny()))
    m.finalize_gemm_fusion()                  # pre-compile: decides nothing
    m.compile()
    m.finalize_gemm_fusion()
    assert "wqkv" in m.params["layers.0.self_attn"]


def test_recompile_after_fusion_is_consistent():
    """compile() after fusion re-initializes a (E, 2I) fused kernel that
    matches the packed SigmoidSiluMulti, and generation runs."""
    m = _build(fusion=True)
    _gen(m)
    m.compile()
    assert m.params["layers.0.mlp.gate_proj|up_proj"]["kernel"].shape == (
        128, 192)
    assert len(_gen(m)) == 6


@pytest.mark.parametrize("quant", [None, "int8"])
def test_spec_infer_fused_matches_incr(quant):
    """The spec engines fuse verifier and draft alike; spec tokens equal
    incremental decoding's on the fused verifier."""
    incr = _gen(_build(quant, True, mode=InferenceMode.TREE_VERIFY_MODE))
    llm = _build(quant, True, mode=InferenceMode.TREE_VERIFY_MODE)
    ssm = _build(quant, True, mode=InferenceMode.BEAM_SEARCH_MODE)
    rm = RequestManager()
    g = rm.register_new_request(list(PROMPT), max_new_tokens=6)
    rm.generate_spec_infer(llm, [ssm], spec_depth=3,
                           generation_config=GenerationConfig(
                               adaptive_spec=False))
    assert rm.results[g].output_tokens == incr
    for model in (llm, ssm):
        assert "wqkv" in model.params["layers.0.self_attn"]


def test_llm_compile_fuses_verifier_and_drafts():
    """``LLM.compile(gemm_fusion=True, quantization_type="int8")`` fuses
    the verifier and its draft after loading; the spec tokens equal the
    unfused incremental ones."""
    cfg = dict(model_type="llama", **_tiny())
    src = _build(fusion=False)
    sd = {}
    for key, (layer, w, tr) in hf_weight_map(LLAMAConfig(**_tiny())).items():
        a = torch.tensor(src.get_parameter_by_key((layer, w)))
        sd[key] = a.T if tr else a
    kw = dict(max_requests_per_batch=2, max_seq_length=64,
              max_tokens_per_batch=16, kv_cache_dtype="float32",
              device="cpu", quantization_type="int8")
    plain = fft.LLM((cfg, dict(sd))).compile(**kw)
    fused = fft.LLM((cfg, dict(sd))).compile(
        gemm_fusion=True, ssms=[fft.SSM((cfg, dict(sd)))], **kw)
    for m in (fused.ffmodel, fused.ssms[0].ffmodel):
        assert "wqkv" in m.params["layers.0.self_attn"]
        assert is_quantized(m.params["layers.0.self_attn"]["wqkv"])
    assert "wq" in plain.ffmodel.params["layers.0.self_attn"]
    prompts = [[5, 9, 23, 44], [7, 3, 11]]
    want = [r.output_tokens for r in plain.generate(prompts, 8)]
    assert [r.output_tokens for r in fused.generate(prompts, 8)] == want


# the four other families at checkpoint_store.TINY_CONFIGS (Falcon's
# TINY geometry is multi-query: one KV head), each fused against the
# JAX package's unfused tokens for the same weights
FAMILY_CASES = ["falcon", "opt", "mpt", "gpt_bigcode"]


@pytest.mark.parametrize("family", FAMILY_CASES)
def test_fused_families_match_jax(family):
    from flexflow_tpu.models import FAMILIES as JFAMILIES
    from flexflow_tpu_torch.models import FAMILIES
    from flexflow_tpu_torch.models.checkpoint_store import TINY_CONFIGS

    jfam, fam = JFAMILIES[family], FAMILIES[family]
    cfg = TINY_CONFIGS[family]
    serve = dict(SERVE, max_sequence_length=48)
    jm = ff.FFModel(ff.FFConfig(use_native_scheduler=False, seed=3, **serve))
    jfam.build(jm, jfam.config_cls(**cfg), mode=JMode.INC_DECODING_MODE)
    jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
    rm = JRM()
    rm.register_new_request(list(PROMPT), max_new_tokens=6)
    jtok = rm.generate_incr_decoding(jm)[0].output_tokens
    m = fft.FFModel(fft.FFConfig(device="cpu", gemm_fusion=True, **serve))
    fam.build(m, fam.config_cls(**cfg), mode=InferenceMode.INC_DECODING_MODE)
    m.compile()
    load_params(m, params_from_jax(
        {ly: {w: np.asarray(a) for w, a in lp.items()}
         for ly, lp in jm.params.items()}))
    assert _gen(m) == jtok and len(jtok) == 6
    attn = [lp for lp in m.params.values() if "wqkv" in lp]
    assert attn and not any("wq" in lp for lp in m.params.values())
    if family == "falcon":     # multi-query: q is H*D wide, k and v D
        E = cfg["hidden_size"]
        D = E // cfg["num_attention_heads"]
        assert attn[0]["wqkv"].shape == (E, E + 2 * D)
