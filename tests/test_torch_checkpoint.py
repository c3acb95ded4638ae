"""HF-layout checkpoints across the two packages, on the CPU.

The port's ``models/checkpoint_store.py`` writes the JAX package's format
byte for byte: the same weights saved by both packages give identical
``config.json`` and weights files, as safetensors and as
``pytorch_model.bin``. A checkpoint written by either package cold-starts
in the other through ``LLM.from_checkpoint`` with identical greedy tokens,
for every family at the ``TINY_CONFIGS`` geometry; quantize-on-load int8
gives the in-memory int8 build's tokens; and the port's CLI saves and
describes a checkpoint.
"""

import json
import os

import numpy as np
import pytest

import flexflow_tpu as ff
from flexflow_tpu.ffconst import InferenceMode as JMode
from flexflow_tpu.models import FAMILIES as JFAMILIES
from flexflow_tpu.models import checkpoint_store as jcs
from flexflow_tpu.serve.api import LLM as JLLM
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.models import FAMILIES
from flexflow_tpu_torch.models import checkpoint_store as cs

FAMILY_NAMES = sorted(cs.TINY_CONFIGS)
LLM_KW = dict(max_requests_per_batch=2, max_seq_length=64,
              max_tokens_per_batch=16, kv_cache_dtype="float32")
PROMPTS = [[3, 5, 7], list(range(1, 21)), [100, 5, 17, 42]]
NEW = 10

_dirs = {}


def _jax_ckpt(family, tmp_path_factory):
    """A checkpoint written by the JAX package's save_tiny_checkpoint,
    once per family."""
    if family not in _dirs:
        d = str(tmp_path_factory.mktemp(f"jax_{family}"))
        jcs.save_tiny_checkpoint(family, d, seed=0)
        _dirs[family] = d
    return _dirs[family]


def _tokens(llm):
    return [r.output_tokens for r in llm.generate(PROMPTS,
                                                  max_new_tokens=NEW)]


def _jax_tokens(d, **kw):
    return _tokens(JLLM.from_checkpoint(d, **kw).compile(
        use_native_scheduler=False, **LLM_KW))


def _port_tokens(d, **kw):
    llm = fft.LLM.from_checkpoint(d, **kw)
    assert llm.checkpoint_dir == d
    return _tokens(llm.compile(device="cpu", **LLM_KW))


@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_jax_checkpoint_cold_starts_in_port(family, tmp_path_factory):
    d = _jax_ckpt(family, tmp_path_factory)
    tout = _port_tokens(d)
    assert tout == _jax_tokens(d)
    assert all(len(t) == NEW for t in tout)


@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_port_checkpoint_cold_starts_in_jax(family, tmp_path):
    """The port's save_tiny_checkpoint (its own seeded weights, built on
    the CPU) loads in the JAX package with the port's tokens."""
    man = cs.save_tiny_checkpoint(family, str(tmp_path), seed=5,
                                  device="cpu")
    assert man["model_type"] == FAMILIES[family].name
    assert _jax_tokens(str(tmp_path)) == _port_tokens(str(tmp_path))


@pytest.mark.parametrize("fmt", ["safetensors", "pytorch-bin"])
@pytest.mark.parametrize("family", FAMILY_NAMES)
def test_save_checkpoint_same_bytes_as_jax(family, fmt, tmp_path):
    """The JAX model's weights, saved by both packages: identical files."""
    jfam = JFAMILIES[family]
    mcfg = jfam.config_cls(**jcs.TINY_CONFIGS[family])
    serve = dict(max_requests_per_batch=2, max_sequence_length=64,
                 max_tokens_per_batch=16, seed=3, kv_cache_dtype="float32")
    jm = ff.FFModel(ff.FFConfig(**serve))
    jfam.build(jm, mcfg, mode=JMode.INC_DECODING_MODE)
    jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
    fam = FAMILIES[family]
    pcfg = fam.config_cls(**cs.TINY_CONFIGS[family])
    pm = fft.FFModel(fft.FFConfig(device="cpu", **serve))
    fam.build(pm, pcfg)
    pm.compile()
    load_params(pm, params_from_jax(
        {layer: {w: np.asarray(a) for w, a in lp.items()}
         for layer, lp in jm.params.items()}))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jman = jcs.save_checkpoint(jm, family, mcfg, str(jdir), fmt=fmt)
    tman = cs.save_checkpoint(pm, family, pcfg, str(tdir), fmt=fmt)
    assert tman == jman
    for name in (cs.CONFIG_NAME, tman["weights_file"]):
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes(), name


@pytest.mark.parametrize("family", ["falcon", "gpt_bigcode", "opt"])
def test_quantize_on_load_int8_matches_in_memory_build(family,
                                                       tmp_path_factory):
    """``from_checkpoint(quantize="int8")`` gives the tokens of the same
    weights built in memory and compiled with int8 weights, and the JAX
    package's quantize-on-load tokens."""
    d = _jax_ckpt(family, tmp_path_factory)
    cfg, sd = cs.load_checkpoint(d)
    mem = fft.LLM((cfg, sd)).compile(device="cpu", quantization_type="int8",
                                     **LLM_KW)
    assert any(getattr(w, "qtype", None) == "int8"
               for lp in mem.ffmodel.params.values() for w in lp.values())
    tout = _port_tokens(d, quantize="int8")
    assert tout == _tokens(mem)
    assert tout == _jax_tokens(d, quantize="int8")


def test_checkpoint_store_cli(tmp_path, capsys):
    out = str(tmp_path / "ckpt")
    assert cs.main(["save", "--family", "mpt", "--out", out,
                    "--format", "pytorch-bin", "--device", "cpu"]) == 0
    assert cs.main(["info", out]) == 0
    saved, info = [json.loads(line)
                   for line in capsys.readouterr().out.splitlines()]
    assert saved["model_type"] == info["model_type"] == "mpt"
    assert info["n_tensors"] == saved["n_tensors"] > 0
    assert os.path.isfile(os.path.join(out, cs.PYTORCH_NAME))
    # the JAX package reads what the port wrote
    jcfg, jsd = jcs.load_checkpoint(out)
    cfg, sd = cs.load_checkpoint(out)
    assert jcfg == cfg and sorted(jsd) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], jsd[k])
    with pytest.raises(FileNotFoundError):
        cs.load_checkpoint(str(tmp_path))
