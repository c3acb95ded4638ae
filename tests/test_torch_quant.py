"""The port's weight-only int8/int4 quantization against the JAX package,
on the CPU.

Same numpy inputs through ``flexflow_tpu.quant`` and
``flexflow_tpu_torch.quant``: the quantized payload and scale bit for bit
(fp32 and bf16 weights, odd row counts, a zero column), dequantization,
the packed-row gather, and ``qmatmul`` on plain/int8/int4 weights with
bf16 and fp32 operands and an fp32 result (1e-6 in fp32, 1e-2 in bf16,
relative to the largest |value|). Then a tiny LLaMA (vocab 128, hidden
128, 2 layers, 4/2 heads: every matmul weight is eligible) quantized in
the JAX package, carried across by ``convert.py`` and served by both
packages: incremental decoding, the chain engine and the tree engine give
the same tokens. K3 itself runs only on the card
(``test_cuda_qmatmul_matches_plain``; ``chip_smoke.py`` phase 3 runs the
full set); on the CPU the wrapper takes its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu import quant as jq
from flexflow_tpu.ffconst import InferenceMode as JMode
from flexflow_tpu.models.llama import LLAMAConfig as JLlamaConfig
from flexflow_tpu.models.llama import create_llama_model as jax_create_llama
from flexflow_tpu.serve import spec_controller as jsc
from flexflow_tpu.serve.api import LLM as JLLM
from flexflow_tpu.serve.batch_config import GenerationConfig as JGen
from flexflow_tpu.serve.request_manager import RequestManager as JRM
import flexflow_tpu_torch as fft
from flexflow_tpu_torch import kernels
from flexflow_tpu_torch import quant as tq
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.ffconst import DataType, InferenceMode
from flexflow_tpu_torch.kernels.qmatmul import qmatmul_plain, split_plan
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.serve import spec_controller as tsc
from flexflow_tpu_torch.serve.batch_config import GenerationConfig
from flexflow_tpu_torch.serve.request_manager import RequestManager

TINY = dict(vocab_size=128, hidden_size=128, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
SERVE = dict(max_requests_per_batch=2, max_sequence_length=64,
             max_tokens_per_batch=16, kv_cache_dtype="float32", seed=0)
TOL = {"float32": 1e-6, "bfloat16": 1e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                      dtype=np.float32)


def _weight(rows, cols, dtype, seed=0):
    """The same weight in both packages (a zero column included)."""
    w = np.random.RandomState(seed).randn(rows, cols).astype(np.float32)
    w[:, 3] = 0.0
    return (jnp.asarray(w).astype(_JDT[dtype]),
            torch.tensor(w).to(_TDT[dtype]))


def _close(got, want, dtype):
    got, want = _np32(got), _np32(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0,
                               atol=TOL[dtype])


# ----------------------------------------------------------------------
# 1. the quantization scheme, bit for bit
# ----------------------------------------------------------------------
@pytest.mark.parametrize("rows", [128, 127])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qtype", ["int8", "int4"])
def test_quantize_array_bit_equal_to_jax(qtype, dtype, rows):
    jw, tw = _weight(rows, 72, dtype)
    jl, tl = jq.quantize_array(jw, qtype), tq.quantize_array(tw, qtype)
    assert tl.q.dtype == torch.int8 and tl.scale.dtype == torch.float32
    np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
    np.testing.assert_array_equal(tl.scale.numpy(), np.asarray(jl.scale))
    assert (tl.rows, tl.dtype, tl.qtype) == (jl.rows, jl.dtype, jl.qtype)
    assert tl.shape == tuple(jl.shape) and tl.nbytes == jl.nbytes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qtype", ["int8", "int4"])
def test_dequantize_and_qtake_match_jax(qtype, dtype):
    jw, tw = _weight(31, 80, dtype, seed=1)
    jl, tl = jq.quantize_array(jw, qtype), tq.quantize_array(tw, qtype)
    got = tq.dequantize_array(tl)
    assert got.dtype == _TDT[dtype]
    _close(got, jq.dequantize_array(jl), dtype)
    ids = np.random.RandomState(2).randint(0, 31, size=(4, 5)).astype(
        np.int32)
    got = tq.qtake(tl, torch.tensor(ids))
    assert got.shape == (4, 5, 80) and got.dtype == _TDT[dtype]
    _close(got, jq.qtake(jl, jnp.asarray(ids)), dtype)
    # a gather of the dequantized table, bit for bit
    assert torch.equal(got, tq.dequantize_array(tl)[torch.tensor(ids).long()])


# (compute dtype, out dtype): bf16 operands, bf16 operands with the fp32
# accumulator kept (the logits head), fp32
MODES = {"bf16": ("bfloat16", None), "bf16-f32out": ("bfloat16", "float32"),
         "fp32": ("float32", None)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("kind", ["plain", "int8", "int4"])
def test_qmatmul_matches_jax(kind, mode):
    cd, od = MODES[mode]
    jw, tw = _weight(65, 96, cd, seed=3)        # odd K: int4's padded row
    x = np.random.RandomState(4).randn(2, 3, 65).astype(np.float32)
    if kind != "plain":
        jw, tw = jq.quantize_array(jw, kind), tq.quantize_array(tw, kind)
    jy = jq.qmatmul(jnp.asarray(x), jw, compute_dtype=_JDT[cd],
                    out_dtype=_JDT[od] if od else None)
    ty = tq.qmatmul(torch.tensor(x), tw, compute_dtype=_TDT[cd],
                    out_dtype=_TDT[od] if od else None)
    assert ty.shape == (2, 3, 96)
    assert str(ty.dtype).replace("torch.", "") == (od or cd)
    _close(ty, jy, od or cd)


@pytest.mark.parametrize("qtype", ["int8", "int4"])
def test_qmatmul_plain_is_the_cpu_path(qtype):
    """On CPU tensors quant.qmatmul is K3's plain version, unchanged, and
    counts no plain call on the card."""
    _, tw = _weight(67, 40, "bfloat16", seed=5)
    leaf = tq.quantize_array(tw, qtype)
    x = torch.tensor(np.random.RandomState(6).randn(5, 67).astype(np.float32))
    kernels.reset_counts()
    for cd, od in ((torch.bfloat16, torch.float32),
                   (torch.bfloat16, torch.bfloat16),
                   (torch.float32, torch.float32)):
        assert torch.equal(tq.qmatmul(x, leaf, cd, od),
                           qmatmul_plain(x, leaf, cd, od))
    assert kernels.counts["qmatmul"] == kernels.counts[
        "qmatmul_plain_cuda"] == 0


def test_split_plan_depends_on_k_n_and_sms_only():
    """The split plan covers K with no empty split, keeps within 1.5
    blocks an SM and within one thread-block cluster (8), and splits K
    where the 128-column N tiles alone leave SMs idle (the 7B
    projections' plans on 132 SMs)."""
    for K, N in ((4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
                 (4096, 12288), (4096, 22016), (4095, 1000), (64, 128)):
        splits, cps = split_plan(K, N, 132)
        chunks = -(-K // 64)
        assert splits * cps >= chunks > (splits - 1) * cps
        assert splits <= 8
        assert splits == 1 or -(-N // 128) * splits <= 3 * 132 // 2
    assert split_plan(4096, 4096, 132) == (6, 11)
    assert split_plan(11008, 4096, 132) == (6, 29)
    assert split_plan(4096, 11008, 132) == (2, 32)
    assert split_plan(4096, 32000, 132) == (1, 64)
    assert split_plan(64, 128, 132) == (1, 1)


def test_quantize_params_selects_eligible():
    """Mirrors tests/test_quantization.py: eligible 2-D matmul weights of
    at least 64 in both dims, nothing else."""
    rng = np.random.RandomState(2)
    params = {
        "dense_0": {"kernel": rng.randn(128, 128).astype(np.float32),
                    "bias": rng.randn(128).astype(np.float32)},
        "norm_0": {"gamma": rng.randn(128).astype(np.float32)},
        "small": {"kernel": rng.randn(4, 4).astype(np.float32)},
        "ids": {"kernel": np.arange(128 * 64).reshape(128, 64)},
    }
    jout = jq.quantize_params(params, "int8")
    tout = tq.quantize_params(
        {l: {w: torch.tensor(a) for w, a in lp.items()}
         for l, lp in params.items()}, "int8")
    for layer, lp in params.items():
        for w in lp:
            assert tq.is_quantized(tout[layer][w]) == jq.is_quantized(
                jout[layer][w]), (layer, w)
    assert tq.is_quantized(tout["dense_0"]["kernel"])
    assert tq.quantized_nbytes(tout) == jq.quantized_nbytes(jout)


def test_qtype_names_config_and_int4_dtype():
    for spec, want in (("int8", "int8"), ("Q8", "int8"), (4, "int4"),
                       (" int4 ", "int4"), (None, None), ("bf16", None),
                       ("off", None)):
        assert tq.normalize_qtype(spec) == jq.normalize_qtype(spec) == want
        assert fft.FFConfig(device="cpu",
                            quantization_type=spec).quantization_type == want
    with pytest.raises(ValueError):
        tq.normalize_qtype("int3")
    cfg = fft.FFConfig(device="cpu")
    assert cfg.enable_fusion and not cfg.gemm_fusion
    assert cfg.quantization_type is None
    with pytest.raises(ValueError, match="QuantizedWeight"):
        DataType.DT_INT4.to_torch()


# ----------------------------------------------------------------------
# 2. a quantized tiny LLaMA in both packages
# ----------------------------------------------------------------------
_models = {}


def _pair(qtype, mode, layers=2):
    """(JAX model quantized at compile, port model loaded from it), built
    once each."""
    key = (qtype, mode, layers)
    if key not in _models:
        tiny = {**TINY, "num_hidden_layers": layers}
        jm = ff.FFModel(ff.FFConfig(use_native_scheduler=False,
                                    quantization_type=qtype, **SERVE))
        jax_create_llama(jm, JLlamaConfig(**tiny), mode=JMode(mode.value))
        jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
        pm = fft.FFModel(fft.FFConfig(device="cpu", quantization_type=qtype,
                                      **SERVE))
        create_llama_model(pm, LLAMAConfig(**tiny), mode=mode)
        pm.compile()
        load_params(pm, params_from_jax(jm.params))
        _models[key] = (jm, pm)
    return _models[key]


@pytest.mark.parametrize("qtype", ["int8", "int4"])
def test_quantized_leaves_cross_unchanged(qtype):
    """Every matmul weight is quantized at compile in both packages, and
    convert.py carries the JAX payload and scale across bit for bit."""
    jm, pm = _pair(qtype, InferenceMode.INC_DECODING_MODE)
    n = 0
    for layer, lp in jm.params.items():
        for w, leaf in lp.items():
            tleaf = pm.params[layer][w]
            assert tq.is_quantized(tleaf) == jq.is_quantized(leaf), (layer, w)
            if jq.is_quantized(leaf):
                np.testing.assert_array_equal(tleaf.q.numpy(),
                                              np.asarray(leaf.q))
                np.testing.assert_array_equal(tleaf.scale.numpy(),
                                              np.asarray(leaf.scale))
                n += 1
    assert n == 2 + 7 * TINY["num_hidden_layers"]   # embedding + lm_head
    # get dequantizes, set re-quantizes (in place), as in the JAX package
    key = ("layers.0.mlp.down_proj", "kernel")
    np.testing.assert_allclose(
        pm.get_parameter_by_key(key),
        np.asarray(jq.dequantize_array(jm.params[key[0]][key[1]])),
        rtol=0, atol=1e-7)


def _gen(rm, reqs, run):
    guids = [rm.register_new_request(p, max_new_tokens=n) for p, n in reqs]
    run(rm)
    return [rm.results[g].output_tokens for g in guids]


REQS = [([5, 9, 23, 44], 10), ([7, 3, 11], 10)]


@pytest.mark.parametrize("path", ["incr", "chain", "tree"])
@pytest.mark.parametrize("qtype", ["int8", "int4"])
def test_quantized_llama_tokens_match_jax(qtype, path):
    """Incremental decoding, the chain engine (1 draft, CPU routing) and
    the fused tree engine, controller off, with a 1-layer truncated draft
    (the JAX package seeds each weight by name: the verifier's first
    layer, embedding and head): the JAX package's tokens, and spec equal
    to incremental."""
    if path == "incr":
        jm, pm = _pair(qtype, InferenceMode.INC_DECODING_MODE)
        jout = _gen(JRM(), REQS, lambda rm: rm.generate_incr_decoding(jm))
        tout = _gen(RequestManager(), REQS,
                    lambda rm: rm.generate_incr_decoding(pm))
        assert tout == jout
        assert all(len(t) == n for t, (_, n) in zip(tout, REQS))
        return
    jllm, tllm = _pair(qtype, InferenceMode.TREE_VERIFY_MODE)
    jd, td = _pair(qtype, InferenceMode.BEAM_SEARCH_MODE, layers=1)
    incr = _gen(RequestManager(), REQS,
                lambda rm: rm.generate_incr_decoding(tllm))

    def spec(rm_cls, llm, ssm, gc):
        def run(rm):
            if path == "tree":
                return rm._generate_spec_tree_fused(
                    llm, [ssm], spec_depth=3, generation_config=gc)
            return rm.generate_spec_infer(llm, [ssm], spec_depth=3,
                                          generation_config=gc)
        return _gen(rm_cls(), REQS, run)

    jout = spec(JRM, jllm, jd, JGen(adaptive_spec=False))
    tout = spec(RequestManager, tllm, td, GenerationConfig(
        adaptive_spec=False))
    assert tout == jout
    assert tout == incr


def test_draft_cost_ratio_counts_payload_and_scale():
    """An int8 verifier/draft pair: the controller's draft cost ratio is
    the JAX package's (parameter bytes = payload + scale, not the float
    weights')."""
    jllm, tllm = _pair("int8", InferenceMode.TREE_VERIFY_MODE)
    jd, td = _pair("int8", InferenceMode.BEAM_SEARCH_MODE, layers=1)
    got = tsc.estimate_draft_cost_ratio(tllm, [td])
    assert got == jsc.estimate_draft_cost_ratio(jllm, [jd])
    dense = sum(int(np.prod(t.shape)) * 4 for lp in tllm.params.values()
                for t in lp.values())
    assert tq.quantized_nbytes(tllm.params) < dense / 3


def _hf(seed=3):
    cfg = dict(model_type="llama", **TINY)
    rng = np.random.RandomState(seed)
    E, I, V = TINY["hidden_size"], TINY["intermediate_size"], \
        TINY["vocab_size"]
    kv = E // TINY["num_attention_heads"] * TINY["num_key_value_heads"]
    sd = {"model.embed_tokens.weight": rng.randn(V, E),
          "model.norm.weight": 1 + 0.1 * rng.randn(E),
          "lm_head.weight": 0.2 * rng.randn(V, E)}
    for i in range(TINY["num_hidden_layers"]):
        p = f"model.layers.{i}."
        for name, shape in (("self_attn.q_proj", (E, E)),
                            ("self_attn.k_proj", (kv, E)),
                            ("self_attn.v_proj", (kv, E)),
                            ("self_attn.o_proj", (E, E)),
                            ("mlp.gate_proj", (I, E)), ("mlp.up_proj", (I, E)),
                            ("mlp.down_proj", (E, I))):
            sd[p + name + ".weight"] = 0.2 * rng.randn(*shape)
        sd[p + "input_layernorm.weight"] = 1 + 0.1 * rng.randn(E)
        sd[p + "post_attention_layernorm.weight"] = 1 + 0.1 * rng.randn(E)
    return cfg, {k: v.astype(np.float32) for k, v in sd.items()}


@pytest.mark.parametrize("qtype", ["int8", "int4"])
def test_llm_compile_quantization_type_matches_jax(qtype):
    """``LLM.compile(quantization_type=...)`` in both packages from one HF
    state dict: the loaded weights are quantized alike, and the tokens
    agree."""
    cfg, sd = _hf()
    kw = dict(max_requests_per_batch=2, max_seq_length=64,
              max_tokens_per_batch=16, kv_cache_dtype="float32",
              quantization_type=qtype)
    jllm = JLLM((cfg, dict(sd))).compile(use_native_scheduler=False, **kw)
    tllm = fft.LLM((cfg, dict(sd))).compile(device="cpu", **kw)
    leaf = tllm.ffmodel.params["layers.1.self_attn"]["wk"]
    jleaf = jllm.ffmodel.params["layers.1.self_attn"]["wk"]
    assert tq.is_quantized(leaf) and leaf.qtype == qtype
    np.testing.assert_array_equal(leaf.q.numpy(), np.asarray(jleaf.q))
    prompts = [[5, 9, 23, 44], [7, 3, 11], [100, 2]]
    jres = jllm.generate(prompts, max_new_tokens=8)
    tres = tllm.generate(prompts, max_new_tokens=8)
    assert [r.output_tokens for r in tres] == [r.output_tokens for r in jres]


# ----------------------------------------------------------------------
# 3. K3 on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("qtype", ["int8", "int4"])
def test_cuda_qmatmul_matches_plain(cuda_device, qtype):
    """On a card: K3 against its plain version (bf16 and fp32 operands,
    bf16 and fp32 results, an odd K and an N that is not a multiple of
    the tile), and a row's bits the same at M = 64, 8 and 1."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for K, N in ((4096, 4096), (1023, 1000)):
        w = torch.randn((K, N), generator=g, device=cuda_device) * 0.02
        leaf = tq.quantize_array(w.to(torch.bfloat16), qtype)
        for cd, od, tol in ((torch.bfloat16, torch.bfloat16, 1e-2),
                            (torch.bfloat16, torch.float32, 1e-5),
                            (torch.float32, torch.float32, 1e-5)):
            x = torch.randn((64, K), generator=g, device=cuda_device).to(cd)
            y = tq.qmatmul(x, leaf, cd, od)
            ref = qmatmul_plain(x, leaf, cd, od)
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            assert err <= tol * float(ref.float().abs().max())
            assert torch.equal(y[:8], tq.qmatmul(x[:8].contiguous(), leaf,
                                                 cd, od))
            assert torch.equal(y[7:8], tq.qmatmul(x[7:8].contiguous(), leaf,
                                                  cd, od))
