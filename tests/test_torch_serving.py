"""The port's serving slice against the JAX package, on the CPU.

A tiny LLaMA (vocab 128, hidden 64, 2 layers, 4/2 heads; 2 request slots,
a 64-position fp32 KV cache) is built in both packages, with the JAX
model's weights copied into the port through ``params_from_jax``. Prefill
and decode logits must agree to 1e-5, and greedy generation must give
identical tokens, through ``RequestManager.generate_incr_decoding`` (the
JAX side on its pure-Python scheduler) and through ``LLM.generate``.
Also guarded here: the port imports neither jax nor flexflow_tpu, its
default device is CUDA, and that device raises where CUDA is missing.
"""

import ast
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.models.llama import LLAMAConfig as JLlamaConfig
from flexflow_tpu.models.llama import create_llama_model as jax_create_llama
from flexflow_tpu.ops.base import OpContext as JOpContext
from flexflow_tpu.serve.api import LLM as JLLM
from flexflow_tpu.serve.batch_config import make_batch_meta as jax_meta
from flexflow_tpu.serve.request_manager import RequestManager as JRM
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.ops.base import OpContext
from flexflow_tpu_torch.serve.batch_config import make_batch_meta
from flexflow_tpu_torch.serve.request_manager import RequestManager

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
SERVE = dict(max_requests_per_batch=2, max_sequence_length=64,
             max_tokens_per_batch=16, seed=0, kv_cache_dtype="float32")
PROMPTS = [list(range(1, 21)), [3, 4], [7, 8, 9], [100, 5, 17, 42]]

_models = {}


def _pair(decode_width=0):
    """(jax model, port model with the same weights), built once each."""
    if decode_width not in _models:
        jm = ff.FFModel(ff.FFConfig(use_native_scheduler=False,
                                    decode_width=decode_width, **SERVE))
        jax_create_llama(jm, JLlamaConfig(**TINY))
        jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
        pm = fft.FFModel(fft.FFConfig(device="cpu",
                                      decode_width=decode_width, **SERVE))
        create_llama_model(pm, LLAMAConfig(**TINY))
        pm.compile()
        load_params(pm, params_from_jax(
            {layer: {w: np.asarray(a) for w, a in lp.items()}
             for layer, lp in jm.params.items()}))
        _models[decode_width] = (jm, pm)
    return _models[decode_width]


def _logits_tid(model):
    return next(layer for layer in model.layers
                if layer.name == "lm_head").outputs[0].tensor_id


def test_params_line_up_by_name_and_shape():
    jm, pm = _pair()
    assert set(pm.params) == set(jm.params)
    for layer, lp in jm.params.items():
        assert {w: tuple(a.shape) for w, a in lp.items()} == \
            {w: tuple(t.shape) for w, t in pm.params[layer].items()}
    # the stacked [L, R, KH, S, D] cache, exactly head_dim wide
    assert tuple(pm.op_state["kv_cache"]["k"].shape) == (2, 2, 2, 64, 16)


def test_prefill_and_decode_logits_match_jax():
    """One chunked-prefill step (appended KV, K1's plain path), then one
    decode step (the fused append, K2's plain path); logits to 1e-5."""
    jm, pm = _pair()
    R, Q = 2, 8
    toks = np.zeros((R, Q), np.int32)
    toks[0, :5] = [5, 9, 33, 2, 7]
    toks[1, :3] = [11, 12, 13]
    num = np.array([5, 3], np.int32)
    pos = np.tile(np.arange(Q, dtype=np.int32), (R, 1))
    meta = dict(tokens=toks, positions=pos, start_pos=np.zeros(R, np.int32),
                num_tokens=num, active=np.ones(R, bool))
    jstate = jm.op_state
    tstate = {n: {k: t.clone() for k, t in st.items()}
              for n, st in pm.op_state.items()}
    for step, contiguous in ((meta, False), (dict(
            tokens=np.array([[4], [6]], np.int32),
            positions=num[:, None].copy(), start_pos=num.copy(),
            num_tokens=np.ones(R, np.int32), active=np.ones(R, bool)), True)):
        q = step["tokens"].shape[1]
        jctx = JOpContext(compute_dtype=jnp.float32,
                          batch_config=jax_meta(R, q, **step),
                          mesh=jm.mesh, config=jm.config)
        jctx.kv_contiguous = contiguous
        jvals, jstate = jm._run_graph(
            jm.params, {jm.input_tensors[0].tensor_id:
                        jnp.asarray(step["tokens"])}, jctx, jstate)
        tmeta = make_batch_meta(R, q, **step)
        tvals, tstate = pm._run_graph(
            pm.params, {pm.input_tensors[0].tensor_id: tmeta.tokens},
            OpContext(compute_dtype=torch.float32, batch_config=tmeta,
                      kv_contiguous=contiguous), tstate)
        jl = np.asarray(jvals[_logits_tid(jm)])
        tl = tvals[_logits_tid(pm)].numpy()
        real = np.arange(q)[None, :] < step["num_tokens"][:, None]
        assert tl.dtype == np.float32
        np.testing.assert_allclose(tl[real], jl[real], atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tstate["kv_cache"]["k"].numpy(),
                               np.asarray(jstate["kv_cache"]["k"]),
                               atol=1e-5, rtol=1e-5)


def _generate(rm_cls, model, eos=None, limits=()):
    rm = rm_cls()
    rm.eos_token_id = eos
    guids = [rm.register_new_request(p, max_new_tokens=12,
                                     max_sequence_length=lim)
             for p, lim in zip(PROMPTS, list(limits) + [0] * len(PROMPTS))]
    rm.generate_incr_decoding(model)
    return [(rm.results[g].output_tokens, rm.results[g].status)
            for g in guids]


@pytest.mark.parametrize("decode_width", [0, 8])
def test_generate_incr_decoding_identical_tokens(decode_width):
    """More requests than slots, a prompt longer than the prefill chunk,
    a per-request length limit and EOS; decode width 1 (the CPU's auto
    width) and the verify width 8."""
    jm, pm = _pair(decode_width)
    want_width = decode_width or 1
    jout = _generate(JRM, jm, limits=(0, 9))
    tout = _generate(RequestManager, pm, limits=(0, 9))
    assert pm._inference_manager.decode_width == want_width
    assert tout == jout
    assert len(tout[1][0]) == 9 - 2 and len(tout[0][0]) == 12
    eos = jout[2][0][3]          # stop request 2 at its 4th token
    jout = _generate(JRM, jm, eos=eos)
    tout = _generate(RequestManager, pm, eos=eos)
    assert tout == jout and tout[2][0][-1] == eos and len(tout[2][0]) <= 4


def _hf_pair():
    cfg = dict(model_type="llama", **TINY)
    rng = np.random.RandomState(3)
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


def test_llm_generate_from_hf_pair_identical_tokens():
    cfg, sd = _hf_pair()
    kw = dict(max_requests_per_batch=2, max_seq_length=64,
              max_tokens_per_batch=16, kv_cache_dtype="float32")
    jllm = JLLM((cfg, dict(sd))).compile(use_native_scheduler=False, **kw)
    tllm = fft.LLM((cfg, dict(sd))).compile(device="cpu", **kw)
    jres = jllm.generate(PROMPTS[:3], max_new_tokens=10)
    tres = tllm.generate(PROMPTS[:3], max_new_tokens=10)
    assert [r.output_tokens for r in tres] == [r.output_tokens for r in jres]
    one = tllm.generate(PROMPTS[1], max_new_tokens=4)
    assert one.output_tokens == tres[1].output_tokens[:4]
    np.testing.assert_allclose(
        tllm.ffmodel.get_parameter_by_key(("layers.1.self_attn", "wq")),
        sd["model.layers.1.self_attn.q_proj.weight"].T)


# ----------------------------------------------------------------------
# guards
# ----------------------------------------------------------------------
def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib") or top == "flexflow_tpu"


def test_port_sources_import_no_jax_and_no_flexflow_tpu():
    files = sorted((REPO / "flexflow_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    # the online-serving modules are among them
    port = REPO / "flexflow_tpu_torch"
    for rel in ("serve/admission.py", "serve/prefix_cache.py",
                "serve/loadgen.py", "telemetry/__init__.py",
                "telemetry/metrics.py", "telemetry/slo.py"):
        assert port / rel in files, rel
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.relative_to(REPO)}: {n}" for n in names
                    if _forbidden(n)]
    assert not bad, bad


def test_port_import_loads_no_jax():
    code = ("import sys, flexflow_tpu_torch, flexflow_tpu_torch.convert, "
            "flexflow_tpu_torch.kernels.build, flexflow_tpu_torch.serve; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flexflow_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.strip()
    assert out == "[]"


def test_default_device_is_cuda_and_raises_without_cuda(monkeypatch):
    assert fft.FFConfig().device == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        fft.FFModel(fft.FFConfig())
    with pytest.raises(RuntimeError, match="cuda"):
        fft.LLM(_hf_pair()).compile(max_requests_per_batch=1)


def test_chip_smoke_alone_fails_without_result(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and '"ok"' not in p.stdout
    # and in the checkout on a machine without CUDA
    if not torch.cuda.is_available():
        p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
        assert p.returncode != 0 and '"ok"' not in p.stdout
