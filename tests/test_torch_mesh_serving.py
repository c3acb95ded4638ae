"""The shared-prefix pool and searched or assigned strategies on the
parallel serving mesh: the port's ranks against the JAX package at the
same degrees, on the CPU.

``test_torch_parallel_serving.py``'s TINY4 LLaMA (fp32 caches, 2 request
slots), its weights crossing from the JAX package, one ``run_ranks``
launch per mesh. The pool: 8 prompts behind one 36-token prefix at tp=2,
pp=2 and sp=2 (at sp=2 the padded prefix crosses into the second rank's
rows), tokens equal to the JAX package's with its pool on and to the
port's with the pool off, hit tokens equal on every rank and to the JAX
package's. Strategies at tp=2, fp32 and int8: two assigned ``Strategy``s
(loaded on the JAX side with ``Strategy.from_json`` before compile) and
the port's own search under ``auto_parallel``, tokens equal to the JAX
package's under the same strategy and to one rank's; each rank's
quantized slices equal the matching slice of the whole quantized weight;
an int4 row split that would cut a packed pair is refused, naming the
layer.
"""

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.ffconst import InferenceMode
from flexflow_tpu.models.llama import LLAMAConfig as JLlamaConfig
from flexflow_tpu.models.llama import create_llama_model as jax_create_llama
from flexflow_tpu.search.strategy import Strategy as JStrategy
from flexflow_tpu.serve.batch_config import GenerationConfig as JGC
from flexflow_tpu.serve.request_manager import RequestManager as JRM
import flexflow_tpu_torch as tff
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.parallel.launch import run_ranks
from flexflow_tpu_torch.parallel.mesh import Mesh
from flexflow_tpu_torch.parallel.placement import plan_strategy
from flexflow_tpu_torch.parallel.spec import ShardingPolicy
from flexflow_tpu_torch.search.strategy import OpStrategy, Strategy

TINY4 = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128)
SERVE = dict(max_requests_per_batch=2, max_sequence_length=64,
             max_tokens_per_batch=16, seed=0, kv_cache_dtype="float32")
JOB = "flexflow_tpu_torch.parallel.rank_jobs:serve"

# a system prompt in front of each user turn
PREFIX = [int(t) for t in np.random.RandomState(7).randint(1, 128, 36)]
POOL_PROMPTS = [PREFIX + [3 + i, 90 - 5 * i] for i in range(8)]
POOL_NEW = 4
POOL_DEGREES = {"tp2": dict(tensor_parallelism_degree=2),
                "pp2": dict(pipeline_parallelism_degree=2),
                "sp2": dict(sequence_parallelism_degree=2)}

PROMPTS = [[5, 9, 23, 44], [7, 3]]
NEW = 8
TP2 = dict(tensor_parallelism_degree=2)


def _op(output, **weights):
    return OpStrategy(input_specs=(), output_spec=tuple(output),
                      weight_specs={w: tuple(s) for w, s in weights.items()},
                      name="assigned")


# (i) moves quantized weights off the serving ops' own layout: lm_head's
# kernel in row shards with its output vocabulary-split, a down_proj in
# row shards, an attention's wo whole at rest, a gate_proj whole with its
# output split; (ii) whole attention projections at rest, a
# vocabulary-split embedding table, an up_proj's output split
STRATEGIES = {
    "rows": Strategy(ops={
        "lm_head": _op((None, None, "model"), kernel=("model", None)),
        "layers.0.mlp.down_proj": _op((None, None, None),
                                      kernel=("model", None)),
        "layers.1.self_attn": _op((None, None, "model"), wo=(None, None)),
        "layers.0.mlp.gate_proj": _op((None, None, "model"),
                                      kernel=(None, None))}),
    "heads": Strategy(ops={
        "layers.2.self_attn": _op((None, None, None), wq=(None, None),
                                  wk=(None, None), wv=(None, None)),
        "embed_tokens": _op((None, None, "model"),
                            weight=("model", None)),
        "layers.3.mlp.up_proj": _op((None, None, "model"))}),
}
# the quantized leaves whose slices are checked, with their rest spec
SLICED = {"lm_head": ("kernel", ("model", None)),
          "layers.0.mlp.down_proj": ("kernel", ("model", None)),
          "layers.1.self_attn": ("wo", (None, None)),
          "layers.0.mlp.up_proj": ("kernel", (None, "model"))}


def _jax_model(mode, quant=None, strategy=None, **deg):
    m = ff.FFModel(ff.FFConfig(use_native_scheduler=False,
                               quantization_type=quant, **SERVE, **deg))
    jax_create_llama(m, JLlamaConfig(**TINY4), mode=mode)
    if strategy is not None:
        m.strategy = JStrategy.from_json(strategy.to_json())
    m.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
    return m


def _jax_generate(m, prompts, max_new, pool=False):
    rm = JRM()
    for p in prompts:
        rm.register_new_request(p, max_new_tokens=max_new)
    res = rm.generate_incr_decoding(m, generation_config=JGC(
        prefix_cache=pool))
    by = {tuple(r.input_tokens): list(r.output_tokens) for r in res}
    return ([by[tuple(p)] for p in prompts],
            sum(r.prefix_hit_tokens for r in res))


def _save(jm, path):
    torch.save(params_from_jax({layer: {w: (a if hasattr(a, "q")
                                            else np.asarray(a))
                                        for w, a in lp.items()}
                                for layer, lp in jm.params.items()}), path)
    return str(path)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    inc = InferenceMode.INC_DECODING_MODE
    return {None: _save(_jax_model(inc), d / "fp32.pt"),
            "int8": _save(_jax_model(inc, quant="int8"), d / "int8.pt")}


def _run(name, weights, prompts, max_new, quant=None, **extra):
    config = dict(SERVE, quantization_type=quant,
                  **extra.pop("config", TP2))
    return dict(name=name, model=TINY4, config=config,
                weights=weights[quant], prompts=prompts, max_new=max_new,
                **extra)


@pytest.fixture(scope="module")
def port_runs(weights, tmp_path_factory):
    """{mesh: [rank][run]}: the pool on and off at each degree, then every
    strategy case at tp=2 in one launch."""
    out = {}
    for name, deg in POOL_DEGREES.items():
        runs = [_run(f"pool-{on}", weights, POOL_PROMPTS, POOL_NEW,
                     config=deg, prefix_cache=on) for on in (False, True)]
        out[name] = run_ranks(JOB, 2, {"device": "cpu", "runs": runs},
                              workdir=tmp_path_factory.mktemp(name),
                              timeout=240)
    saved = tmp_path_factory.mktemp("slices")
    runs = []
    for quant in (None, "int8"):
        for sname, st in STRATEGIES.items():
            runs.append(_run(f"{sname}-{quant}", weights, PROMPTS, NEW,
                             quant, strategy=st.to_json(),
                             save_params=(str(saved / "rank{rank}.pt")
                                          if (sname, quant)
                                          == ("rows", "int8") else None)))
        runs.append(_run(f"auto-{quant}", weights, PROMPTS, NEW, quant,
                         config=dict(TP2, auto_parallel=True)))
    out["strategies"] = run_ranks(JOB, 2, {"device": "cpu", "runs": runs},
                                  workdir=tmp_path_factory.mktemp("tp2"),
                                  timeout=300)
    out["saved"] = saved
    return out


def _port(ranks, kind):
    i = [r["name"] for r in ranks[0]].index(kind)
    return [rank[i] for rank in ranks]


@pytest.fixture(scope="module")
def jax_runs():
    out = {}
    inc = InferenceMode.INC_DECODING_MODE
    for name, deg in POOL_DEGREES.items():
        out[("pool", name)] = _jax_generate(_jax_model(inc, **deg),
                                            POOL_PROMPTS, POOL_NEW,
                                            pool=True)
    for quant in (None, "int8"):
        out[("one", quant)] = _jax_generate(_jax_model(inc, quant=quant),
                                            PROMPTS, NEW)[0]
        for sname, st in STRATEGIES.items():
            out[(sname, quant)] = _jax_generate(
                _jax_model(inc, quant=quant, strategy=st, **TP2),
                PROMPTS, NEW)[0]
    return out


@pytest.mark.parametrize("name", list(POOL_DEGREES))
def test_pool_tokens_match_jax_and_pool_off(port_runs, jax_runs, name):
    jax_tokens, jax_hits = jax_runs[("pool", name)]
    off = _port(port_runs[name], "pool-False")
    on = _port(port_runs[name], "pool-True")
    for res_on, res_off in zip(on, off):
        assert res_on["tokens"] == jax_tokens, (name, res_on["rank"])
        assert res_on["tokens"] == res_off["tokens"], (name, res_on["rank"])
    hits = {r["prefix_hit_tokens"][0] for r in on}
    assert hits == {jax_hits} and jax_hits > 0, (hits, jax_hits)
    assert all(r["prefix_hit_tokens"] == [0] for r in off)


@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("sname", list(STRATEGIES))
def test_assigned_strategy_tokens_match_jax(port_runs, jax_runs, sname,
                                            quant):
    ranks = _port(port_runs["strategies"], f"{sname}-{quant}")
    for res in ranks:
        assert res["tokens"] == jax_runs[(sname, quant)], res["rank"]
        assert res["tokens"] == jax_runs[("one", quant)], res["rank"]
        assert Strategy.from_json(res["strategy"]).ops.keys() == \
            STRATEGIES[sname].ops.keys()


@pytest.mark.parametrize("quant", [None, "int8"])
def test_auto_parallel_serving_runs(port_runs, jax_runs, quant):
    ranks = _port(port_runs["strategies"], f"auto-{quant}")
    assert ranks[0]["strategy"] is not None
    for res in ranks:
        assert res["strategy"] == ranks[0]["strategy"]
        assert res["tokens"] == jax_runs[("one", quant)], res["rank"]


@pytest.mark.parametrize("quant", [None, "int8"])
def test_each_rank_holds_less_than_one_rank(port_runs, weights, quant):
    """Under either strategy a rank holds fewer weight bytes than the
    whole model, the same on both ranks."""
    from flexflow_tpu_torch.quant import quantized_nbytes

    whole = quantized_nbytes(torch.load(weights[quant], weights_only=False))
    for sname in STRATEGIES:
        ranks = _port(port_runs["strategies"], f"{sname}-{quant}")
        assert len({r["weight_bytes"] for r in ranks}) == 1, sname
        assert 0 < ranks[0]["weight_bytes"] < whole, sname


def test_quantized_slices_are_slices_of_the_whole(port_runs, weights):
    whole = torch.load(weights["int8"], weights_only=False)
    for rank in range(2):
        held = torch.load(str(port_runs["saved"] / f"rank{rank}.pt"),
                          weights_only=False)
        for layer, (w, spec) in SLICED.items():
            full, got = whole[layer][w], held[layer][w]
            q, scale = full.q, full.scale
            if spec[0] == "model":
                n = q.shape[0] // 2
                q = q[rank * n:(rank + 1) * n]
            if spec[1] == "model":
                n = q.shape[1] // 2
                q, scale = (q[:, rank * n:(rank + 1) * n],
                            scale[rank * n:(rank + 1) * n])
            assert torch.equal(got.q, q), (layer, rank)
            assert torch.equal(got.scale, scale), (layer, rank)
            assert got.rows == q.shape[0] and got.qtype == "int8"


def _planned(strategy, quant, **model_kw):
    m = tff.FFModel(tff.FFConfig(device="cpu", quantization_type=quant,
                                 **SERVE))
    create_llama_model(m, LLAMAConfig(**dict(TINY4, **model_kw)))
    m.comp_mode = tff.CompMode.COMP_MODE_INFERENCE
    m.mesh = Mesh((2,), ("model",))
    m.policy = ShardingPolicy(m.mesh)
    m.strategy = strategy
    return plan_strategy(m)


def test_int4_row_split_that_cuts_a_pair_is_refused():
    # down_proj's kernel has 130 rows: halves of 65 would split a pair
    bad = Strategy(ops={"layers.1.mlp.down_proj": _op(
        (None, None, None), kernel=("model", None))})
    with pytest.raises(ValueError, match="'layers.1.mlp.down_proj'.*int4"):
        _planned(bad, "int4", intermediate_size=130)
    # int8 rows have no pairs, and 128 rows halve into even chunks
    assert _planned(bad, "int8", intermediate_size=130) is not None
    assert _planned(bad, "int4") is not None


def test_serving_attention_keeps_its_own_layout_in_the_plan():
    plan = _planned(STRATEGIES["heads"], None)
    moves = plan.weights["layers.2.self_attn"]
    assert moves["wq"] == ((None, None), (None, "model"))
    assert moves["wk"] == ((None, None), (None, "model"))
    assert plan.attrs["embed_tokens"] == {"vocab_parallel": True}
    assert plan.outputs == {"embed_tokens": (None, None, "model"),
                            "layers.3.mlp.up_proj": (None, None, "model")}


def test_constrain_places_a_value_at_a_spec():
    """``ShardingPolicy.constrain`` (the JAX policy's counterpart): a
    whole value split where the spec names an axis that divides its dim;
    axes the mesh lacks, or that do not divide, leave the dim whole."""
    x = torch.arange(24.0).reshape(4, 6)
    for rank in range(2):
        pol = ShardingPolicy(Mesh((2,), ("model",), rank=rank))
        got = pol.constrain(x, (None, "model"))
        assert torch.equal(got, x[:, 3 * rank:3 * rank + 3])
        assert pol.constrain(x, ("data", None)) is x
        assert pol.constrain(torch.zeros(3, 5), ("model", "model")).shape \
            == (3, 5)
        assert pol.constrain(got, (None, "model"), src=(None, "model")) \
            is got
