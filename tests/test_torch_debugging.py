"""The port's ``inference_debugging`` dumps and trace tooling against the
JAX package, on the CPU.

A tiny LLaMA (vocab 128, hidden 64, 2 layers, 2 request slots, a
64-position fp32 cache) serves two prompts for one prefill step and one
decode step in both packages, on the same weights, with per-op dumps on:
the step directories, files and keys are the same, and
``compare_dumps(jax_dir, port_dir)`` finds no op above rtol 1e-4. The
debugging routes (speculation on the host tree path, gemm fusion off)
and ``tools/trace_report`` over the tiny spec pair's spans close it.
"""

import os

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu import telemetry as jtel
from flexflow_tpu.ffconst import InferenceMode as JMode
from flexflow_tpu.models.llama import LLAMAConfig as JLlamaConfig
from flexflow_tpu.models.llama import create_llama_model as jax_create_llama
from flexflow_tpu.serve.batch_config import GenerationConfig as JGenCfg
from flexflow_tpu.serve.request_manager import RequestManager as JRM
from flexflow_tpu.utils.debugging import compare_dumps as jax_compare
import flexflow_tpu_torch as fft
from flexflow_tpu_torch import telemetry as ttel
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.ffconst import InferenceMode
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.serve.batch_config import GenerationConfig
from flexflow_tpu_torch.serve.gemm_fusion import fusion_eligible
from flexflow_tpu_torch.serve.request_manager import RequestManager
from flexflow_tpu_torch.tools import trace_report as ttr
from flexflow_tpu_torch.utils.debugging import compare_dumps, worst_op

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
SERVE = dict(max_requests_per_batch=2, max_sequence_length=64,
             max_tokens_per_batch=16, seed=0, kv_cache_dtype="float32")
PROMPTS = [[5, 9, 23, 7], [11, 3, 19]]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax(mode=JMode.INC_DECODING_MODE, debugging=False, layers=2, seed=0):
    jm = ff.FFModel(ff.FFConfig(use_native_scheduler=False,
                                inference_debugging=debugging,
                                **dict(SERVE, seed=seed)))
    jax_create_llama(jm, JLlamaConfig(**dict(TINY, num_hidden_layers=layers)),
                     mode=mode)
    jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
    return jm


def _port(jm, mode=InferenceMode.INC_DECODING_MODE, layers=2, **cfg):
    m = fft.FFModel(fft.FFConfig(device="cpu", **{**SERVE, **cfg}))
    create_llama_model(m, LLAMAConfig(**dict(TINY, num_hidden_layers=layers)),
                       mode=mode)
    m.compile()
    load_params(m, params_from_jax(
        {ly: {w: np.asarray(a) for w, a in lp.items()}
         for ly, lp in jm.params.items()}))
    return m


def _run(rm, model, n=1):
    guids = [rm.register_new_request(p, max_new_tokens=n) for p in PROMPTS]
    rm.generate_incr_decoding(model)
    return [rm.results[g].output_tokens for g in guids]


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """(jax dump dir, port dump dir, jax tokens, port tokens, port tokens
    with dumps off) of one prefill and one decode step."""
    root = tmp_path_factory.mktemp("dumps")
    jm = _jax(debugging=True)
    cwd = os.getcwd()
    os.chdir(root)          # the JAX package dumps to ./inference_tensors
    try:
        jtoks = _run(JRM(), jm)
    finally:
        os.chdir(cwd)
    pm = _port(jm, inference_debugging=True)
    rm = RequestManager()
    rm._ifm(pm).debug_dir = str(root / "port")
    ptoks = _run(rm, pm)
    plain = _run(RequestManager(), _port(jm))
    return (str(root / "inference_tensors"), str(root / "port"), jtoks,
            ptoks, plain)


def test_dump_layout_matches_jax(dumps):
    jdir, pdir, jtoks, ptoks, plain = dumps
    assert ptoks == jtoks == plain and all(len(t) == 1 for t in ptoks)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == \
        ["step_0", "step_1"]
    for step in ("step_0", "step_1"):
        files = sorted(os.listdir(os.path.join(pdir, step)))
        assert files == sorted(os.listdir(os.path.join(jdir, step)))
        assert files[0] == "000_embed_tokens.npz"
        for f in files:
            with np.load(os.path.join(pdir, step, f)) as a, \
                    np.load(os.path.join(jdir, step, f)) as b:
                assert sorted(a.files) == sorted(b.files), f
                assert {k: a[k].shape for k in a.files} == \
                    {k: b[k].shape for k in b.files}, f
    with np.load(os.path.join(pdir, "step_0",
                              "002_layers.0.self_attn.npz")) as a:
        assert {"input_0", "weight_wq", "weight_wo", "output_0"} <= \
            set(a.files)


def test_compare_dumps_finds_no_op_above_tolerance(dumps):
    jdir, pdir = dumps[:2]
    assert compare_dumps(jdir, pdir, rtol=1e-4) == []
    for step in ("step_0", "step_1"):
        assert jax_compare(os.path.join(jdir, step),
                           os.path.join(pdir, step), rtol=1e-4) == []
    f, key, err, rel = worst_op(jdir, pdir)
    assert key.startswith("output_") and rel < 1e-4


def test_compare_dumps_reports_a_difference(dumps, tmp_path):
    import shutil

    jdir, pdir = dumps[:2]
    bad = str(tmp_path / "bad")
    shutil.copytree(pdir, bad)
    path = os.path.join(bad, "step_1", "002_layers.0.self_attn.npz")
    with np.load(path) as a:
        blob = {k: a[k] for k in a.files}
    blob["output_0"] = blob["output_0"] + 1e-2
    np.savez(path, **blob)
    assert compare_dumps(jdir, bad) == [
        (os.path.join("step_1", "002_layers.0.self_attn.npz"), "output_0",
         pytest.approx(1e-2, rel=1e-3))]


def test_debugging_routes(tmp_path, monkeypatch):
    """Under ``inference_debugging``: two drafts take the host tree path,
    one beam draft too, one greedy draft the chain engine (as in the JAX
    package); each gives incremental decoding's tokens, the draft steps
    are dumped; gemm fusion stays off."""
    monkeypatch.chdir(tmp_path)
    jm = _jax()
    want = _run(JRM(), jm, n=6)
    verifier = _port(jm, InferenceMode.TREE_VERIFY_MODE,
                     inference_debugging=True)
    beam = InferenceMode.BEAM_SEARCH_MODE
    drafts = [_port(_jax(JMode.BEAM_SEARCH_MODE, layers=1, seed=s), beam,
                    layers=1, inference_debugging=True) for s in (3, 4)]
    beams = [_port(_jax(JMode.BEAM_SEARCH_MODE, layers=1, seed=3), beam,
                   layers=1, inference_debugging=True, max_beam_width=2)]
    calls = []

    class SpyRM(RequestManager):
        def _generate_spec_tree_host(self, *a, **kw):
            calls.append("host")
            return super()._generate_spec_tree_host(*a, **kw)

        def _generate_spec_chain(self, *a, **kw):
            calls.append("chain")
            return super()._generate_spec_chain(*a, **kw)

        def _generate_spec_tree_fused(self, *a, **kw):
            calls.append("fused")
            return super()._generate_spec_tree_fused(*a, **kw)

    for ssms, route in ((drafts, "host"), (beams, "host"),
                        (drafts[:1], "chain")):
        rm = SpyRM()
        guids = [rm.register_new_request(p, max_new_tokens=6)
                 for p in PROMPTS]
        rm.generate_spec_infer(verifier, ssms, spec_depth=2,
                               generation_config=GenerationConfig(
                                   adaptive_spec=False))
        assert calls[-1] == route
        assert [rm.results[g].output_tokens for g in guids] == want
    steps = os.listdir(os.path.join(tmp_path, "inference_tensors"))
    assert len(steps) > 4
    fused = _port(jm, inference_debugging=True, gemm_fusion=True)
    assert not fusion_eligible(fused)
    RequestManager._ifm(fused)
    assert "wq" in fused.params["layers.0.self_attn"]
    assert fusion_eligible(_port(jm, gemm_fusion=True))


def _normalized(report):
    """A trace report without its times, ids and time-sorted orders."""
    reqs = sorted(
        (r["status"], r["failovers"], r["preemptions"], r["output_tokens"],
         r["pids"], tuple((s["name"], s["pid"]) for s in r["critical_path"]))
        for r in report["requests"])
    return (report["n_requests"], report["n_failed_over"],
            report["n_preempted"], reqs,
            sorted(s["name"] for s in report["slowest_spans"]))


def test_trace_report_matches_jax(tiny_spec_pair, tmp_path):
    """``trace_report`` over the port's spans of the tiny spec pair gives
    the JAX package's report over its own, times set aside."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_trace_report", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "trace_report.py"))
    jtr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtr)
    jllm, jssm = tiny_spec_pair
    pllm = _port(jllm, InferenceMode.TREE_VERIFY_MODE)
    pssm = _port(jssm, InferenceMode.BEAM_SEARCH_MODE)
    reports = []
    for tel_mod, rm_cls, gcfg, llm, ssm, tr in (
            (ttel, RequestManager, GenerationConfig, pllm, pssm, ttr),
            (jtel, JRM, JGenCfg, jllm, jssm, jtr)):
        path = str(tmp_path / f"{tr.__name__}.jsonl")
        tel = tel_mod.enable_telemetry(trace_path=path)
        try:
            rm = rm_cls()
            for p in PROMPTS:
                rm.register_new_request(p, max_new_tokens=6)
            rm.generate_spec_infer(llm, [ssm], spec_depth=2,
                                   generation_config=gcfg(
                                       adaptive_spec=False))
            tel.tracer.flush()
        finally:
            tel_mod.disable_telemetry()
        reports.append(tr.trace_report(tr.load_trace(path)))
    assert _normalized(reports[0]) == _normalized(reports[1])
    assert reports[0]["n_requests"] == 2
    assert "ms" in ttr.format_report(reports[0])
