"""The JAX package's serving entry points (``inference/python``) run
against the port on the CPU, one process a script, through the
``flexflow_tpu`` -> ``flexflow_tpu_torch`` alias of
``torch_example_run.py``. Also the two names those scripts and the
training examples stop on without the port's counterparts:
``FFConfig``'s stored ``--lr``/``--wd`` and ``serve.init``, against the
JAX package's."""

import json
import re

import pytest

import flexflow_tpu as jff
import flexflow_tpu.serve as jserve
import flexflow_tpu_torch as tff
import flexflow_tpu_torch.serve as tserve
from torch_example_run import Prefetcher, scripts

SCRIPTS = scripts("inference/python")
_RUNS = Prefetcher(SCRIPTS)
_TOKENS = re.compile(r"output_tokens=(\[[0-9, ]*\])")


def test_matrix_is_whole():
    assert SCRIPTS == ["inference/python/incr_decoding.py",
                       "inference/python/spec_infer.py"]


@pytest.fixture
def no_init_defaults():
    yield
    jserve.init()
    tserve.init()


@pytest.mark.parametrize("script", SCRIPTS)
def test_example_runs_on_port(script):
    proc = _RUNS.result(script)
    assert proc.returncode == 0, proc.stdout[-4000:]
    # the scripts' three prompts, --max-new-tokens 4 each
    outs = [json.loads(t) for t in _TOKENS.findall(proc.stdout)]
    assert [len(t) for t in outs] == [4, 4, 4], proc.stdout[-4000:]


def test_report_line_names_no_jax_package_module():
    """``--report`` (what ``chip_smoke.py`` phase 13f reads on the card):
    one ``PORT_RUN`` line with the launch counts and shapes, all zero and
    empty on the CPU, and no ``flexflow_tpu`` module but the port's."""
    import os
    import subprocess
    import sys

    import torch_example_run as runner

    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, runner.__file__, "--report", SCRIPTS[0],
         "--max-new-tokens", "2"], cwd=runner.ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stdout[-4000:]
    lines = [x for x in proc.stdout.splitlines()
             if x.startswith("PORT_RUN ")]
    assert len(lines) == 1, proc.stdout[-4000:]
    run = json.loads(lines[0].split(" ", 1)[1])
    assert set(run["counts"]) >= {"flash_attend", "flash_attend_append",
                                  "qmatmul"}
    assert not any(run["counts"].values()) and run["shapes"] == {}
    # this box's transformers may import jax itself; no JAX-package module
    assert not [m for m in run["foreign"] if m.split(".")[0] != "jax"]
    assert [len(json.loads(t)) for t in _TOKENS.findall(proc.stdout)] == \
        [2, 2, 2]


@pytest.mark.parametrize("argv", [
    [], ["--lr", "0.05", "--wd", "0.001"],
    ["--learning-rate", "0.2", "--weight-decay", "0", "--profiling"]])
def test_from_args_stores_what_jax_stores(argv):
    j = jff.FFConfig.from_args(argv)
    t = tff.FFConfig.from_args(argv, device="cpu")
    for field in ("learning_rate", "weight_decay", "profiling", "iterations",
                  "benchmarking", "computation_mode", "param_dtype",
                  "workers_per_node", "perform_fusion_checks",
                  "log_instance_creation"):
        assert getattr(t, field) == getattr(j, field), field


@pytest.mark.parametrize("kwargs", [
    {},
    {"num_gpus": 2, "memory_per_gpu": 14000, "zero_copy_memory_per_node":
     30000, "num_cpus": 4, "legion_utility_processors": 4,
     "use_4bit_quantization": False, "use_8bit_quantization": True,
     "offload": True, "fusion": False, "seed": 3, "not_a_field": 1},
    {"use_4bit_quantization": True, "offload": False,
     "max_beam_width": 2, "profiling": True}])
def test_serve_init_stores_what_jax_stores(kwargs, no_init_defaults):
    cfg = {"telemetry": False} if kwargs else None
    assert tserve.init(cfg, **kwargs) == jserve.init(cfg, **kwargs)


def test_serve_init_reaches_every_later_llm(no_init_defaults):
    import torch
    import transformers

    torch.manual_seed(0)
    hf = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=64, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=2,
        max_position_embeddings=64))
    tserve.init({"device": "cpu"}, use_8bit_quantization=True,
                fusion=False)
    llm = tserve.LLM(hf).compile(max_seq_length=32, max_tokens_per_batch=8)
    cfg = llm.ffmodel.config
    assert (cfg.device, cfg.quantization_type, cfg.enable_fusion) == \
        ("cpu", "int8", False)
    # compile's own keywords win over init's
    llm = tserve.LLM(hf).compile(max_seq_length=32, max_tokens_per_batch=8,
                                 quantization_type=None)
    assert llm.ffmodel.config.quantization_type is None
