"""The port's C serving ABI (``ffsv_*``) on the CPU.

``flexflow_tpu_torch/native/csrc/serve_c.cpp`` is built into the port's
own serve library and driven through ctypes in this process (``ffsv_init``
finds the interpreter running and imports ``flexflow_tpu_torch.serve.
capi_host`` into it), with ``FFSV_DEVICE=cpu`` selecting the CPU: config
creation and flags, a tiny LLaMA (vocab 128, hidden 64, 2 layers) built
from a JSON spec, requests, generation, speculation, text prompts and the
metrics snapshot. Its tokens are held against the port's Python path on
the same spec and against the JAX package's on the same weights. The
unchanged ``examples/c/incr_decoding.c``, compiled against the port's
library, runs as a C process.
"""

import ctypes
import json
import os
import subprocess
import sys
import sysconfig

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.models.llama import LLAMAConfig as JLlamaConfig
from flexflow_tpu.models.llama import create_llama_model as jax_create_llama
from flexflow_tpu.serve.request_manager import RequestManager as JRM
from flexflow_tpu.training.checkpoint import \
    save_weights_npz as jax_save_npz
import flexflow_tpu_torch as fft
from flexflow_tpu_torch import native
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.serve import capi_host
from flexflow_tpu_torch.serve.request_manager import RequestManager
from flexflow_tpu_torch.telemetry import disable_telemetry, enable_telemetry
from test_torch_native import _toy_vocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
SERVE = dict(max_requests_per_batch=2, max_sequence_length=64,
             max_tokens_per_batch=16, kv_cache_dtype="float32")
PROMPT = [5, 9, 23]


def _spec(**extra):
    return json.dumps({"family": "llama", "mode": "inc",
                       "model_config": TINY, **extra}).encode()


@pytest.fixture(scope="module")
def lib():
    c = ctypes
    path = native.build_serve_library()
    os.environ["FFSV_DEVICE"] = "cpu"
    lib = c.PyDLL(path)      # PyDLL: the calls hold the GIL
    lib.ffsv_init.restype = c.c_int
    lib.ffsv_init.argtypes = [c.c_char_p]
    lib.ffsv_last_error.restype = c.c_char_p
    for fn in ("ffsv_config_create", "ffsv_llm_create", "ffsv_spec_create",
               "ffsv_config_get", "ffsv_metrics_dump",
               "ffsv_get_output_text", "ffsv_config_parse_args"):
        getattr(lib, fn).restype = c.c_void_p
    lib.ffsv_config_set.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p]
    lib.ffsv_config_get.argtypes = [c.c_void_p, c.c_char_p]
    lib.ffsv_config_parse_args.argtypes = [c.c_int,
                                           c.POINTER(c.c_char_p)]
    lib.ffsv_llm_create.argtypes = [c.c_void_p, c.c_char_p]
    lib.ffsv_spec_create.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p]
    for fn in ("ffsv_register_request", "ffsv_register_request_timeout",
               "ffsv_register_request_text"):
        getattr(lib, fn).restype = c.c_long
    lib.ffsv_register_request.argtypes = [c.c_void_p, c.POINTER(c.c_int32),
                                          c.c_int, c.c_int]
    lib.ffsv_register_request_timeout.argtypes = [
        c.c_void_p, c.POINTER(c.c_int32), c.c_int, c.c_int, c.c_double]
    lib.ffsv_register_request_text.argtypes = [c.c_void_p, c.c_char_p,
                                               c.c_int]
    lib.ffsv_register_bpe_tokenizer.argtypes = [c.c_void_p, c.c_char_p,
                                                c.c_char_p]
    lib.ffsv_generate.argtypes = [c.c_void_p]
    lib.ffsv_generate_spec.argtypes = [c.c_void_p, c.c_int]
    lib.ffsv_get_output.argtypes = [c.c_void_p, c.c_long,
                                    c.POINTER(c.c_int32), c.c_int]
    lib.ffsv_get_output_text.argtypes = [c.c_void_p, c.c_long]
    lib.ffsv_request_status.argtypes = [c.c_void_p, c.c_long]
    lib.ffsv_request_cancel.argtypes = [c.c_void_p, c.c_long]
    lib.ffsv_metrics_dump.argtypes = [c.c_char_p]
    lib.ffsv_release.argtypes = [c.c_void_p]
    assert lib.ffsv_init(REPO.encode()) == 0, lib.ffsv_last_error()
    assert capi_host._DEVICE == "cpu"
    yield lib
    os.environ.pop("FFSV_DEVICE", None)


_free = ctypes.CDLL(None).free
_free.argtypes = [ctypes.c_void_p]


def _string(ptr) -> str:
    """A malloc'd C string returned by the ABI, freed."""
    assert ptr
    s = ctypes.string_at(ptr).decode()
    _free(ptr)
    return s


def _config(lib, **fields):
    cfg = lib.ffsv_config_create()
    assert cfg, lib.ffsv_last_error()
    for k, v in {**SERVE, **fields}.items():
        assert lib.ffsv_config_set(cfg, k.encode(), str(v).encode()) == 0, k
    return cfg


def _generate(lib, llm, prompts, n, spec_depth=0):
    guids = []
    for p in prompts:
        arr = (ctypes.c_int32 * len(p))(*p)
        guids.append(lib.ffsv_register_request(llm, arr, len(p), n))
        assert guids[-1] >= 0, lib.ffsv_last_error()
    got = (lib.ffsv_generate_spec(llm, spec_depth) if spec_depth
           else lib.ffsv_generate(llm))
    assert got == len(prompts), lib.ffsv_last_error()
    out = []
    for g in guids:
        buf = (ctypes.c_int32 * 64)()
        k = lib.ffsv_get_output(llm, g, buf, 64)
        assert k >= 0, lib.ffsv_last_error()
        out.append(list(buf[:k]))
    return out, guids


def _port_tokens(prompts, n, weights=None):
    m = fft.FFModel(fft.FFConfig(device="cpu", **SERVE))
    create_llama_model(m, LLAMAConfig(**TINY))
    m.compile()
    if weights:
        from flexflow_tpu_torch.training.checkpoint import load_weights_npz

        load_weights_npz(weights, m)
    rm = RequestManager()
    guids = [rm.register_new_request(p, max_new_tokens=n) for p in prompts]
    rm.generate_incr_decoding(m)
    return [rm.results[g].output_tokens for g in guids]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_round_trip_matches_port_and_jax(lib, tmp_path):
    """The ffsv round trip gives the port's Python path's tokens on the
    same spec (seeded init), and the JAX package's on the JAX model's
    weights (``weights_npz``)."""
    cfg = _config(lib)
    llm = lib.ffsv_llm_create(cfg, _spec())
    assert llm, lib.ffsv_last_error()
    prompts = [PROMPT, [11, 42, 3, 8]]
    got, guids = _generate(lib, llm, prompts, 6)
    assert got == _port_tokens(prompts, 6)
    assert [lib.ffsv_request_status(llm, g) for g in guids] == [0, 0]
    assert lib.ffsv_request_status(llm, 123) == -1
    host = ctypes.cast(ctypes.c_void_p(llm), ctypes.py_object).value
    assert host.model.config.device == "cpu"
    assert host.model.config.use_native_scheduler

    jm = ff.FFModel(ff.FFConfig(use_native_scheduler=False, seed=5, **SERVE))
    jax_create_llama(jm, JLlamaConfig(**TINY))
    jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
    npz = str(tmp_path / "w.npz")
    jax_save_npz(npz, jm)
    rm = JRM()
    jg = [rm.register_new_request(p, max_new_tokens=6) for p in prompts]
    rm.generate_incr_decoding(jm)
    want = [rm.results[g].output_tokens for g in jg]
    llm2 = lib.ffsv_llm_create(cfg, _spec(weights_npz=npz))
    assert llm2, lib.ffsv_last_error()
    assert _generate(lib, llm2, prompts, 6)[0] == want
    assert _port_tokens(prompts, 6, weights=npz) == want
    for h in (llm, llm2, cfg):
        lib.ffsv_release(h)


def test_cancel_timeout_and_status(lib):
    cfg = _config(lib)
    llm = lib.ffsv_llm_create(cfg, _spec())
    arr = (ctypes.c_int32 * 3)(*PROMPT)
    g_ok = lib.ffsv_register_request(llm, arr, 3, 4)
    g_cx = lib.ffsv_register_request(llm, arr, 3, 4)
    g_to = lib.ffsv_register_request_timeout(llm, arr, 3, 4, 1e-9)
    assert lib.ffsv_request_status(llm, g_cx) == 4      # registered
    assert lib.ffsv_request_cancel(llm, g_cx) == 1
    assert lib.ffsv_generate(llm) == 3, lib.ffsv_last_error()
    assert [lib.ffsv_request_status(llm, g) for g in (g_ok, g_cx, g_to)] \
        == [0, 2, 1]
    assert lib.ffsv_request_cancel(llm, g_ok) == 0
    lib.ffsv_release(llm)
    lib.ffsv_release(cfg)


def test_spec_surface(lib):
    cfg = _config(lib)
    pair = lib.ffsv_spec_create(cfg, _spec(), _spec(model_config=dict(
        TINY, num_hidden_layers=1)))
    assert pair, lib.ffsv_last_error()
    assert lib.ffsv_generate_spec(pair, 0) == -1
    assert b"spec_depth" in lib.ffsv_last_error()
    got, _ = _generate(lib, pair, [PROMPT], 6, spec_depth=2)
    # speculation is greedy: the verifier's incremental tokens
    assert got == _port_tokens([PROMPT], 6)
    lib.ffsv_release(pair)
    lib.ffsv_release(cfg)


def test_config_surface_and_metrics(lib):
    cfg = _config(lib)
    # a typo'd boolean is rejected, not stored as False
    assert lib.ffsv_config_set(cfg, b"use_native_scheduler", b"ture") == -1
    assert lib.ffsv_config_set(cfg, b"no_such_field", b"1") == -1
    assert lib.ffsv_config_set(cfg, b"inference_debugging", b"off") == 0
    assert _string(lib.ffsv_config_get(cfg, b"max_sequence_length")) == "64"
    assert _string(lib.ffsv_config_get(cfg, b"device")) == "cpu"
    argv = (ctypes.c_char_p * 3)(b"--8bit-quantization", b"-b", b"4")
    parsed = lib.ffsv_config_parse_args(3, argv)
    assert parsed, lib.ffsv_last_error()
    assert _string(lib.ffsv_config_get(parsed, b"quantization_type")) \
        == "int8"
    assert _string(lib.ffsv_config_get(parsed, b"batch_size")) == "4"
    bad = (ctypes.c_char_p * 2)(b"-tp", b"2")
    assert not lib.ffsv_config_parse_args(2, bad)
    assert b"ROADMAP" in lib.ffsv_last_error()

    assert _string(lib.ffsv_metrics_dump(b"json")) == "{}"
    llm = lib.ffsv_llm_create(cfg, _spec())
    enable_telemetry()
    try:
        _generate(lib, llm, [PROMPT], 2)
        prom = _string(lib.ffsv_metrics_dump(b"prometheus"))
        assert "ffsv_requests_total 1" in prom
        snap = json.loads(_string(lib.ffsv_metrics_dump(b"json")))
        assert snap["ffsv_tokens_generated_total"]["value"] == 2
        assert not lib.ffsv_metrics_dump(b"bogus")
        assert b"metrics format" in lib.ffsv_last_error()
    finally:
        disable_telemetry()
    for h in (llm, parsed, cfg):
        lib.ffsv_release(h)


def test_text_prompts(lib, tmp_path):
    """``ffsv_register_bpe_tokenizer`` attaches the native BPE: a text
    request's output comes back as the decode of its tokens."""
    from flexflow_tpu_torch.native.tokenizer import BPETokenizer

    vocab, merges = _toy_vocab()
    vp, mp = tmp_path / "vocab.json", tmp_path / "merges.txt"
    vp.write_text(json.dumps(vocab), encoding="utf-8")
    mp.write_text("\n".join(f"{a} {b}" for a, b in merges),
                  encoding="utf-8")
    cfg = _config(lib)
    llm = lib.ffsv_llm_create(cfg, _spec(model_config=dict(
        TINY, vocab_size=512)))
    assert llm, lib.ffsv_last_error()
    assert lib.ffsv_register_bpe_tokenizer(llm, str(vp).encode(),
                                           str(mp).encode()) == len(vocab)
    g = lib.ffsv_register_request_text(llm, b"hello world", 5)
    assert g >= 0, lib.ffsv_last_error()
    assert lib.ffsv_generate(llm) == 1, lib.ffsv_last_error()
    buf = (ctypes.c_int32 * 16)()
    n = lib.ffsv_get_output(llm, g, buf, 16)
    text = _string(lib.ffsv_get_output_text(llm, g))
    assert n == 5
    assert text == BPETokenizer(vocab=vocab, merges=merges).decode(
        list(buf[:n]))
    assert not lib.ffsv_get_output_text(llm, 999999)
    lib.ffsv_release(llm)
    lib.ffsv_release(cfg)


def test_device_variable_is_checked(monkeypatch):
    monkeypatch.setenv("FFSV_DEVICE", "tpu")
    with pytest.raises(ValueError, match="FFSV_DEVICE"):
        capi_host.host_init()
    monkeypatch.setenv("FFSV_DEVICE", "cpu")
    assert capi_host.host_init() == 0 and capi_host._DEVICE == "cpu"


def test_c_example_runs_against_the_port(lib, tmp_path):
    """The unchanged ``examples/c/incr_decoding.c``, compiled against the
    port's serve library and libpython, serves on the CPU in a C process
    and prints the port's Python path's tokens."""
    _inc, link = native.python_build_flags()
    exe = str(tmp_path / "incr_decoding")
    subprocess.run(["cc", os.path.join(REPO, "examples", "c",
                                       "incr_decoding.c"),
                    "-L" + native.BUILD_DIR, "-lflexflow_tpu_torch_serve",
                    *link, "-o", exe], check=True, timeout=120)
    env = dict(os.environ, FFSV_DEVICE="cpu",
               PYTHONPATH=os.pathsep.join(p for p in sys.path if p),
               LD_LIBRARY_PATH=os.pathsep.join(
                   [native.BUILD_DIR, sysconfig.get_config_var("LIBDIR")]))
    out = subprocess.run([exe, REPO], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "C incr_decoding OK" in out.stdout
    toks = [[int(t) for t in line.split("->")[1].split()]
            for line in out.stdout.splitlines() if "->" in line]
    m = fft.FFModel(fft.FFConfig(device="cpu", max_sequence_length=64,
                                 max_tokens_per_batch=16,
                                 kv_cache_dtype="float32"))
    create_llama_model(m, LLAMAConfig(**TINY))
    m.compile()
    rm = RequestManager()
    guids = [rm.register_new_request(p, max_new_tokens=6)
             for p in ([5, 9, 23, 7], [11, 42, 3])]
    rm.generate_incr_decoding(m)
    assert toks == [rm.results[g].output_tokens for g in guids]
