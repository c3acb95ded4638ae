"""Parallel serving: the port's ranks against the JAX package at the same
degrees, on the CPU.

``test_serving_pp.py``'s TINY4 LLaMA (4 layers, 4/2 heads, fp32 caches
and weights; 2 request slots) is built once in the JAX package; its
weights cross to the port through ``params_from_jax`` and each rank keeps
its slice through ``shard_params`` (``parallel/rank_jobs.serve``). The
port's ranks are spawned gloo processes; the JAX runs use the 8 virtual
CPU devices. Greedy tokens must be identical: incremental decoding at
tp=2, pp=2, (tp, pp)=(2, 2), pp=4, sp=2 and tp=4 (whose 4 ranks do not
divide the 2 KV heads), SpecInfer at tp=2 and pp=2, int8 at tp=2 and
pp=2. Every rank must read the same tokens, and each
holds only its share of the KV caches and weights. Each launch is made
once per module and read by many cases.
"""

import pathlib

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.ffconst import InferenceMode
from flexflow_tpu.models.llama import LLAMAConfig as JLlamaConfig
from flexflow_tpu.models.llama import create_llama_model as jax_create_llama
from flexflow_tpu.serve.request_manager import RequestManager as JRM
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.parallel.launch import run_ranks
from flexflow_tpu_torch.serve.pipeline_plan import build_pipeline_plan

TINY4 = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128)
SERVE = dict(max_requests_per_batch=2, max_sequence_length=64,
             max_tokens_per_batch=16, seed=0, kv_cache_dtype="float32")
PROMPTS = [[5, 9, 23, 44], [7, 3]]
JOB = "flexflow_tpu_torch.parallel.rank_jobs:serve"
TEST_JOBS = str(pathlib.Path(__file__).with_name("torch_rank_jobs.py"))

DEGREES = {"tp2": dict(tensor_parallelism_degree=2),
           "pp2": dict(pipeline_parallelism_degree=2),
           "tp2pp2": dict(tensor_parallelism_degree=2,
                          pipeline_parallelism_degree=2),
           "pp4": dict(pipeline_parallelism_degree=4),
           # KH = 2 over 4 ranks: wk/wv and the cache stay whole, the
           # query heads are gathered for attention
           "tp4": dict(tensor_parallelism_degree=4),
           "sp2": dict(sequence_parallelism_degree=2)}
SPEC_AND_INT8 = ("tp2", "pp2")


def _jax_model(mode, quant=None, **deg):
    m = ff.FFModel(ff.FFConfig(use_native_scheduler=False,
                               quantization_type=quant, **SERVE, **deg))
    jax_create_llama(m, JLlamaConfig(**TINY4), mode=mode)
    m.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
    return m


def _jax_tokens(kind, **deg):
    rm = JRM()
    max_new = 12 if kind == "spec" else 8
    for p in PROMPTS:
        rm.register_new_request(p, max_new_tokens=max_new)
    if kind == "spec":
        llm = _jax_model(InferenceMode.TREE_VERIFY_MODE, **deg)
        ssm = _jax_model(InferenceMode.BEAM_SEARCH_MODE, **deg)
        res = rm.generate_spec_infer(llm, [ssm], spec_depth=3)
    else:
        m = _jax_model(InferenceMode.INC_DECODING_MODE,
                       quant="int8" if kind == "int8" else None, **deg)
        res = rm.generate_incr_decoding(m)
    by = {tuple(r.input_tokens): list(r.output_tokens) for r in res}
    return [by[tuple(p)] for p in PROMPTS]


def _save(jm, path):
    torch.save(params_from_jax({layer: {w: (a if hasattr(a, "q")
                                            else np.asarray(a))
                                        for w, a in lp.items()}
                                for layer, lp in jm.params.items()}), path)
    return str(path)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """The single-device JAX models' weights (a model's weights do not
    depend on its degrees: each is drawn from the seed and its name)."""
    d = tmp_path_factory.mktemp("weights")
    return {
        "fp32": _save(_jax_model(InferenceMode.INC_DECODING_MODE),
                      d / "fp32.pt"),
        "tree": _save(_jax_model(InferenceMode.TREE_VERIFY_MODE),
                      d / "tree.pt"),
        "beam": _save(_jax_model(InferenceMode.BEAM_SEARCH_MODE),
                      d / "beam.pt"),
        "int8": _save(_jax_model(InferenceMode.INC_DECODING_MODE,
                                 quant="int8"), d / "int8.pt"),
    }


def _runs(name, weights):
    deg = DEGREES[name]
    runs = [dict(name="incr", model=TINY4, config=dict(SERVE, **deg),
                 weights=weights["fp32"], prompts=PROMPTS, max_new=8)]
    if name in SPEC_AND_INT8:
        runs.append(dict(name="spec", model=TINY4,
                         config=dict(SERVE, **deg), weights=weights["tree"],
                         draft=dict(model=TINY4, weights=weights["beam"]),
                         spec_depth=3, prompts=PROMPTS, max_new=12))
        runs.append(dict(name="int8", model=TINY4,
                         config=dict(SERVE, quantization_type="int8", **deg),
                         weights=weights["int8"], prompts=PROMPTS,
                         max_new=8))
    return runs


@pytest.fixture(scope="module")
def port_runs(weights, tmp_path_factory):
    """{degrees name: [rank][run]} from one launch per degrees."""
    out = {}
    for name, deg in DEGREES.items():
        n = int(np.prod(list(deg.values())))
        out[name] = run_ranks(JOB, n, {"device": "cpu",
                                       "runs": _runs(name, weights)},
                              workdir=tmp_path_factory.mktemp(name),
                              timeout=240)
    return out


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    for name, deg in DEGREES.items():
        out[(name, "incr")] = _jax_tokens("incr", **deg)
        if name in SPEC_AND_INT8:
            out[(name, "spec")] = _jax_tokens("spec", **deg)
            out[(name, "int8")] = _jax_tokens("int8", **deg)
    return out


def _port(port_runs, name, kind):
    ranks = port_runs[name]
    i = [r["name"] for r in ranks[0]].index(kind)
    return [rank[i] for rank in ranks]


@pytest.mark.parametrize("name", list(DEGREES))
def test_incr_tokens_match_jax(port_runs, jax_runs, name):
    for res in _port(port_runs, name, "incr"):
        assert res["tokens"] == jax_runs[(name, "incr")], (name, res["rank"])


@pytest.mark.parametrize("name", SPEC_AND_INT8)
def test_spec_infer_tokens_match_jax(port_runs, jax_runs, name):
    for res in _port(port_runs, name, "spec"):
        assert res["tokens"] == jax_runs[(name, "spec")], (name, res["rank"])


@pytest.mark.parametrize("name", SPEC_AND_INT8)
def test_int8_tokens_match_jax(port_runs, jax_runs, name):
    for res in _port(port_runs, name, "int8"):
        assert res["tokens"] == jax_runs[(name, "int8")], (name, res["rank"])


def test_unsharded_jax_matches_sharded_jax(jax_runs):
    """The JAX references agree with one another across degrees, so the
    port's tokens are the single-device tokens too."""
    base = jax_runs[("tp2", "incr")]
    for name in DEGREES:
        assert jax_runs[(name, "incr")] == base, name


@pytest.mark.parametrize("name,mesh,kv,wq,wo", [
    # kv_cache [L(stage), R, KH, S, D]; wq [E, H*D]; wo [H*D, E]
    ("tp2", {"model": 2}, [4, 2, 1, 64, 16], [64, 32], [32, 64]),
    ("pp2", {"pipe": 2}, [2, 2, 2, 64, 16], [64, 64], [64, 64]),
    ("tp2pp2", {"pipe": 2, "model": 2}, [2, 2, 1, 64, 16], [64, 32],
     [32, 64]),
    ("pp4", {"pipe": 4}, [1, 2, 2, 64, 16], [64, 64], [64, 64]),
    ("tp4", {"model": 4}, [4, 2, 2, 64, 16], [64, 16], [16, 64]),
    ("sp2", {"seq": 2}, [4, 2, 2, 32, 16], [64, 64], [64, 64]),
])
def test_each_rank_holds_its_share(port_runs, name, mesh, kv, wq, wo):
    for res in _port(port_runs, name, "incr"):
        assert res["mesh"] == mesh
        sh = res["shapes"]
        assert sh["kv_cache"] == kv and sh["wq"] == wq and sh["wo"] == wo


@pytest.mark.parametrize("name", ["pp2", "pp4", "tp2pp2"])
def test_pipeline_stages_hold_pre_and_post(port_runs, name):
    """The embedding lives on the first stage, the head on the last."""
    ranks = _port(port_runs, name, "incr")
    P = ranks[0]["mesh"]["pipe"]
    tp = ranks[0]["mesh"].get("model", 1)
    for res in ranks:
        stage = res["rank"] // tp
        assert ("lm_head" in res["shapes"]) == (stage == P - 1), res


def _port_model(layers=4, max_requests=2, **kw):
    m = fft.FFModel(fft.FFConfig(device="cpu", max_requests_per_batch=
                                 max_requests, max_sequence_length=32,
                                 kv_cache_dtype="float32", **kw))
    create_llama_model(m, LLAMAConfig(**dict(TINY4,
                                             num_hidden_layers=layers)))
    m.compile()
    return m


def test_pipeline_plan_refusals():
    """Both packages refuse a graph with no repeated block and a block
    count the degree does not divide."""
    from flexflow_tpu.serve.pipeline_plan import \
        build_pipeline_plan as jax_plan

    m = fft.FFModel(fft.FFConfig(device="cpu", max_requests_per_batch=2,
                                 max_sequence_length=32,
                                 kv_cache_dtype="float32"))
    t = m.create_tensor([2, 1], fft.DataType.DT_INT32)
    x = m.embedding(t, 64, 32)
    x = m.inc_multihead_self_attention(x, 32, 4, name="only_attn")
    m.argmax(m.dense(x, 64, name="head"))
    m.compile()
    jm = ff.FFModel(ff.FFConfig(max_requests_per_batch=2,
                                max_sequence_length=32,
                                kv_cache_dtype="float32"))
    jt = jm.create_tensor([2, 1], ff.DataType.DT_INT32)
    jx = jm.embedding(jt, 64, 32)
    jx = jm.inc_multihead_self_attention(jx, 32, 4, name="only_attn")
    jm.argmax(jm.dense(jx, 64, name="head"))
    jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
    assert build_pipeline_plan(m, 2) is None and jax_plan(jm, 2) is None
    four = _port_model()
    assert build_pipeline_plan(four, 3) is None
    plan = build_pipeline_plan(four, 2)
    assert plan is not None and plan.num_blocks == 4
    assert [len(b) for b in plan.stage_blocks(1)] == \
        [len(plan.template)] * 2
    assert plan.block_exit_tids[:-1] == plan.block_entry_tids[1:]


def test_pipeline_plan_warns_degenerate_microbatches():
    from flexflow_tpu_torch.serve.pipeline_plan import microbatch_count

    m = _port_model(max_requests=7)
    with pytest.warns(UserWarning, match="degenerate"):
        build_pipeline_plan(m, 2)
    assert microbatch_count(7, 2) == 1 and microbatch_count(6, 4) == 3
    assert microbatch_count(8, 2) == 2


def test_compile_refuses_indivisible_layers_on_ranks(tmp_path):
    """pp=3 over a 4-layer graph fails on every rank with the planner's
    message, within the launch's timeout."""
    run = dict(name="x", model=TINY4,
               config=dict(SERVE, pipeline_parallelism_degree=3),
               prompts=PROMPTS, max_new=2)
    with pytest.raises(RuntimeError, match="pipeline_parallelism_degree"):
        run_ranks(JOB, 3, {"device": "cpu", "runs": [run]},
                  workdir=tmp_path, timeout=120)


def test_serve_cli_on_ranks(tmp_path):
    """The serve CLI with -tp 2 on two ranks prints, on rank 0 only, the
    tokens the single-process CLI prints."""
    import contextlib
    import io

    from flexflow_tpu_torch.serve.__main__ import main

    argv = ["--device", "cpu", "--max-new-tokens", "4", "--prompt",
            "1,5,9", "--prompt", "3,4"]
    single = io.StringIO()
    with contextlib.redirect_stdout(single):
        assert main(argv) == 0
    ranks = run_ranks(f"{TEST_JOBS}:cli", 2,
                      {"device": "cpu", "argv": argv + ["-tp", "2"]},
                      workdir=tmp_path, timeout=240)
    assert [r["rc"] for r in ranks] == [0, 0] and ranks[1]["stdout"] == ""

    def outputs(text):
        # the tokens of each "guid=<n> output=[...]" line (guids count
        # per process)
        return [line.split(" output=", 1)[1] for line in text.splitlines()
                if line.startswith("guid=")]

    assert outputs(ranks[0]["stdout"]) == outputs(single.getvalue())
    assert len(outputs(single.getvalue())) == 2
