"""The port's front door against the JAX package, on the CPU: ``LLM``
from an in-memory ``transformers`` model and from its ``save_pretrained``
directory (one file and sharded), text in and out through a directory's
``tokenizer.model``, the ``output_file`` log, ``FFConfig.from_args`` and
the flat npz weights across the packages.

The model is a tiny ``LlamaForCausalLM`` built from a config with a
seeded init (vocab 512, hidden 64, 2 layers, 4 heads on 2 KV heads), no
download; its tokenizer is a synthetic SentencePiece model of about 300
pieces. Both packages serve it with 2 request slots and a 64-position
fp32 cache.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

import flexflow_tpu as ff
from flexflow_tpu.serve.api import LLM as JLLM
from flexflow_tpu.training.checkpoint import \
    load_weights_npz as jax_load_npz
from flexflow_tpu.training.checkpoint import \
    save_weights_npz as jax_save_npz
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.models import checkpoint_store as cs
from flexflow_tpu_torch.ops.base import OpContext
from flexflow_tpu_torch.serve.batch_config import make_batch_meta
from flexflow_tpu_torch.serve.engine import build_feeds
from flexflow_tpu_torch.training.checkpoint import (load_weights_npz,
                                                    save_weights_npz)
from test_torch_native import make_sp_model

LLM_KW = dict(max_requests_per_batch=2, max_seq_length=64,
              max_tokens_per_batch=16, kv_cache_dtype="float32")
PROMPTS = [[5, 9, 23, 44], [100, 3, 17], [7] * 9]
TEXTS = ["the quick brown fox", "hello world, très bien"]
NEW = 8


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hf_llama():
    torch.manual_seed(0)
    m = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, tie_word_embeddings=False))
    m.eval()
    return m


@pytest.fixture(scope="module")
def dirs(hf_llama, tmp_path_factory):
    """{"single": one model.safetensors, "sharded": shards + index, both
    with a synthetic tokenizer.model}."""
    out = {}
    for name, shard in (("single", "50MB"), ("sharded", "200KB")):
        d = str(tmp_path_factory.mktemp(name))
        hf_llama.save_pretrained(d, max_shard_size=shard)
        with open(os.path.join(d, "tokenizer.model"), "wb") as f:
            f.write(make_sp_model(1, n_words=40))
        out[name] = d
    assert os.path.exists(os.path.join(out["single"], cs.SAFETENSORS_NAME))
    assert os.path.exists(os.path.join(out["sharded"], cs.SAFETENSORS_INDEX))
    assert len([f for f in os.listdir(out["sharded"])
                if f.endswith(".safetensors")]) >= 2
    return out


@pytest.fixture(scope="module")
def jax_tokens(hf_llama):
    jllm = JLLM(hf_llama).compile(use_native_scheduler=False, **LLM_KW)
    return [r.output_tokens for r in jllm.generate(PROMPTS,
                                                   max_new_tokens=NEW)]


def _port(src, **kw):
    return fft.LLM(src, **kw).compile(device="cpu", **LLM_KW)


def test_in_memory_transformers_model(hf_llama, jax_tokens):
    llm = _port(hf_llama)
    assert llm.tokenizer is None
    res = llm.generate(PROMPTS, max_new_tokens=NEW)
    assert [r.output_tokens for r in res] == jax_tokens
    assert all(len(t) == NEW for t in jax_tokens)


@pytest.mark.parametrize("layout", ["single", "sharded"])
def test_local_directory(dirs, layout, jax_tokens):
    """``LLM(dir)`` reads the directory without ``transformers`` and gives
    the tokens of the in-memory model and of the JAX package's
    ``LLM(dir)``."""
    llm = _port(dirs[layout])
    assert llm.checkpoint_dir == dirs[layout]
    res = llm.generate(PROMPTS, max_new_tokens=NEW)
    assert [r.output_tokens for r in res] == jax_tokens
    jllm = JLLM(dirs[layout]).compile(use_native_scheduler=False, **LLM_KW)
    assert [r.output_tokens for r in jllm.generate(
        PROMPTS, max_new_tokens=NEW)] == jax_tokens


def test_prefill_logits_match_transformers(hf_llama):
    prompt = [3, 17, 42, 99, 7, 55]
    with torch.no_grad():
        want = hf_llama(torch.tensor([prompt])).logits[0].numpy()
    m = _port(hf_llama).ffmodel
    R, Q = 2, len(prompt)
    tokens = np.zeros((R, Q), np.int32)
    tokens[0] = prompt
    meta = make_batch_meta(
        R, Q, tokens=tokens, positions=np.tile(np.arange(Q, dtype=np.int32),
                                               (R, 1)),
        num_tokens=np.array([Q, 0], np.int32),
        active=np.array([True, False]))
    vals, _ = m._run_graph(m.params, build_feeds(m, meta),
                           OpContext(compute_dtype=torch.float32,
                                     batch_config=meta), m.op_state)
    tid = next(ly for ly in m.layers if ly.name == "lm_head").outputs[0]
    got = vals[tid.tensor_id].numpy()[0]
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


def _strip_guids(path):
    with open(path) as f:
        return re.sub(r"guid\(\d+\)", "guid()", f.read())


def test_text_prompts_and_output_file(dirs, tmp_path):
    """A directory's tokenizer.model serves text prompts on the native
    SentencePiece tokenizer: the port's and the JAX package's ``LLM(dir)``
    give the same tokens and text, and ``output_file`` the same records
    (guids aside)."""
    from flexflow_tpu_torch.native.sp_tokenizer import \
        SentencePieceTokenizer

    pout, jout = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    llm = _port(dirs["single"], output_file=pout)
    assert isinstance(llm.tokenizer, SentencePieceTokenizer)
    jllm = JLLM(dirs["single"], output_file=jout).compile(
        use_native_scheduler=False, **LLM_KW)
    res = llm.generate(TEXTS, max_new_tokens=NEW)
    jres = jllm.generate(TEXTS, max_new_tokens=NEW)
    assert [r.input_tokens for r in res] == [r.input_tokens for r in jres]
    assert [r.output_tokens for r in res] == [r.output_tokens for r in jres]
    assert [r.output_text for r in res] == [r.output_text for r in jres]
    assert [r.input_text for r in res] == TEXTS
    assert _strip_guids(pout) == _strip_guids(jout)
    assert _strip_guids(pout).count("output: ") == len(TEXTS)


def test_non_directory_string_raises(tmp_path):
    with pytest.raises(ValueError, match="not a local model directory"):
        fft.LLM("some-org/some-model")
    with pytest.raises(ValueError):
        fft.LLM(str(tmp_path / "missing"))
    with pytest.raises(TypeError):
        fft.LLM(42)


@pytest.mark.parametrize("argv", [
    [],
    ["-b", "16", "-e", "3", "--seed", "7", "--no-fusion"],
    ["--8bit-quantization", "--inference-debugging", "--lr", "0.1",
     "-ll:gpu", "1", "--budget", "5", "--unknown-flag"],
    ["--4bit-quantization", "--fusion", "-dp", "1", "-tp", "1"],
])
def test_from_args_matches_jax(argv):
    j = ff.FFConfig.from_args(argv)
    p = fft.FFConfig.from_args(argv, device="cpu")
    shared = ("batch_size", "epochs", "enable_fusion", "quantization_type",
              "inference_debugging", "seed")
    assert {k: getattr(p, k) for k in shared} == \
        {k: getattr(j, k) for k in shared}
    assert p.device == "cpu" and p.use_native_scheduler and p.use_kernels


@pytest.mark.parametrize("argv", [["-tp", "2"], ["-pp", "2"], ["-sp", "4"],
                                  ["--offload"]])
def test_from_args_rejects_unported_features(argv):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fft.FFConfig.from_args(argv)


def test_npz_weights_cross_both_ways(hf_llama, jax_tokens, tmp_path):
    """``save_weights_npz`` of either package loads in the other and the
    tokens follow the weights."""
    jllm = JLLM(hf_llama).compile(use_native_scheduler=False, **LLM_KW)
    path = str(tmp_path / "jax.npz")
    jax_save_npz(path, jllm.ffmodel)
    torch.manual_seed(1)
    other = transformers.LlamaForCausalLM(hf_llama.config)
    llm = _port(other)
    assert [r.output_tokens for r in llm.generate(
        PROMPTS, max_new_tokens=NEW)] != jax_tokens
    load_weights_npz(path, llm.ffmodel)
    assert [r.output_tokens for r in llm.generate(
        PROMPTS, max_new_tokens=NEW)] == jax_tokens

    pllm = _port(hf_llama)
    ppath = str(tmp_path / "port.npz")
    save_weights_npz(ppath, pllm.ffmodel)
    with np.load(ppath) as a, np.load(path) as b:
        assert sorted(a.files) == sorted(b.files)
    j2 = JLLM(other).compile(use_native_scheduler=False, **LLM_KW)
    jax_load_npz(ppath, j2.ffmodel)
    assert [r.output_tokens for r in j2.generate(
        PROMPTS, max_new_tokens=NEW)] == jax_tokens
    with pytest.raises(KeyError):
        np.savez(str(tmp_path / "empty.npz"), x=np.zeros(1))
        load_weights_npz(str(tmp_path / "empty.npz"), pllm.ffmodel)


def test_checkpoint_store_reads_shards(dirs):
    cfg, sd = cs.load_checkpoint(dirs["sharded"])
    cfg1, sd1 = cs.load_checkpoint(dirs["single"])
    assert cfg["model_type"] == "llama" and sorted(sd) == sorted(sd1)
    assert all(np.array_equal(sd[k], sd1[k]) for k in sd)
    with open(os.path.join(dirs["sharded"], cs.SAFETENSORS_INDEX)) as f:
        assert set(json.load(f)["weight_map"]) == set(sd)


def test_cli_takes_text_and_id_prompts(dirs, tmp_path, capsys):
    """``python -m flexflow_tpu_torch.serve --model DIR``: a prompt of
    comma-separated integers is token ids, any other prompt text through
    the directory's tokenizer; a directory without a tokenizer file gets
    none (``transformers`` installed or not)."""
    import shutil

    from flexflow_tpu_torch.serve.__main__ import main

    assert main(["--model", dirs["single"], "--device", "cpu",
                 "--prompt", TEXTS[0], "--prompt", "5,9,23,44",
                 "--max-new-tokens", "6", "--max-requests-per-batch", "2",
                 "--max-seq-length", "64"]) == 0
    out = capsys.readouterr().out
    cli = [json.loads(line.split("output=", 1)[1])
           for line in out.splitlines() if line.startswith("guid=")]
    llm = fft.LLM(dirs["single"]).compile(
        device="cpu", max_requests_per_batch=2, max_seq_length=64,
        max_tokens_per_batch=64)
    want = [r.output_tokens for r in llm.generate(
        [TEXTS[0], [5, 9, 23, 44]], max_new_tokens=6)]
    assert cli == want and out.count("  text: ") == 2
    bare = str(tmp_path / "bare")
    shutil.copytree(dirs["single"], bare)
    os.remove(os.path.join(bare, "tokenizer.model"))
    assert fft.LLM(bare).tokenizer is None
    with pytest.raises(SystemExit):
        main(["--model", bare, "--device", "cpu", "--prompt", "hello"])
