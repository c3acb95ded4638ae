"""Where a tensor-parallel serving forward keeps its activations: the
port's placement against the one GSPMD gives the JAX package's serving
forward, on the CPU.

(a) GSPMD's spec of every layer output of the JAX package's serving
forward (a prompt prefill and decode steps) is read with
``jax.debug.inspect_array_sharding``, called from the JAX package's
``FFModel._apply_layer`` patched for this test only, for
``test_torch_parallel_serving.py``'s TINY4 LLaMA at tp=2 and tp=4, its
tree-verify LLM of a SpecInfer run at tp=2, its top-p sampling head
(``do_sample``, temperature 0.7) at tp=2, the two assigned strategies
of ``test_torch_mesh_serving.py`` at tp=2, and the four other families
(``checkpoint_store.TINY_CONFIGS``) at tp=2. The port's ranks
(``rank_jobs.serve``, one ``run_ranks`` launch a mesh, the JAX weights
crossing through ``params_from_jax``) report each layer output's
``{axis: dim}`` of their first prefill (``forward_probe``): it must equal
GSPMD's, every output split over ``model`` on its last dim and the
head's tokens (ArgMax or Sampling) whole. The sampled run draws from
each package's own generator, so its tokens are held against the port's
one-rank run under the same seed, not the JAX package's. At tp2pp2 each rank's stage is held to the tp=2 specs. The
beam-mode draft of the SpecInfer run goes through no ``_apply_layer``
in the JAX package that the probe sees (its draft steps run inside the
fused engine's loop), so GSPMD reports nothing for it and the draft is
held by the run's tokens only.
(b) The split ArgMax on 2 gloo ranks against ``torch.argmax`` of the
whole logits: random logits, a tie inside one shard, ties across the
shards (the lower index wins), all-equal rows.
(c) At tp=2 a rank holds at most 0.55 of the one-rank run's layer-output
bytes after the TINY4 prefill (at tp=4, 0.30), and its collectives over
``model`` move fewer bytes than the parent tree's forward did; a decode
step runs the count of them the split gives.
(d) The families' tokens at tp=2 equal the JAX package's at tp=2 with the
same weights; an output spec that names no axis leaves the value split,
in a serving forward and in a train step, as in the JAX package.
"""

import pathlib
import threading
import types

import jax
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
import flexflow_tpu_torch as tff
from flexflow_tpu.ffconst import InferenceMode as JMode
from flexflow_tpu.models import FAMILIES as JFAMILIES
from flexflow_tpu.search.strategy import Strategy as JStrategy
from flexflow_tpu.serve.request_manager import RequestManager as JRM
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models.checkpoint_store import TINY_CONFIGS
from flexflow_tpu_torch.parallel.launch import load_target, run_ranks
from flexflow_tpu_torch.parallel.mesh import Mesh
from flexflow_tpu_torch.parallel.placement import Walk
from flexflow_tpu_torch.parallel.rank_jobs import axis_bytes
from flexflow_tpu_torch.parallel.spec import ShardingPolicy
from flexflow_tpu_torch.search.strategy import OpStrategy, Strategy

TINY4 = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
             num_hidden_layers=4, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128)
SERVE = dict(max_requests_per_batch=2, max_sequence_length=64,
             max_tokens_per_batch=16, seed=0, kv_cache_dtype="float32")
PROMPTS = [[5, 9, 23, 44], [7, 3]]
NEW, SPEC_NEW = 4, 6
SAMPLE = dict(do_sample=True, temperature=0.7, topp=0.9)
JOB = "flexflow_tpu_torch.parallel.rank_jobs:serve"
TEST_JOBS = str(pathlib.Path(__file__).with_name("torch_rank_jobs.py"))
TP2 = dict(tensor_parallelism_degree=2)
MESHES = {"tp2": TP2, "tp4": dict(tensor_parallelism_degree=4),
          "tp2pp2": dict(tensor_parallelism_degree=2,
                         pipeline_parallelism_degree=2)}
FAMILIES = ("opt", "falcon", "mpt", "gpt_bigcode")


def _op(output, **weights):
    return OpStrategy(input_specs=(), output_spec=tuple(output),
                      weight_specs={w: tuple(s) for w, s in weights.items()},
                      name="assigned")


# test_torch_mesh_serving.py's: "rows" moves lm_head and a down_proj to
# row shards (the down_proj's output spec names no axis), "heads" rests
# an attention's projections whole (its output spec names no axis) and
# splits the embedding table by the vocabulary
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
# the parent tree's model-axis bytes of the TINY4 prefill at tp=2, per
# token (fp32): the embedding's gathered columns (H/2), each layer's
# attention output all-reduced (H) and its gate, up and down columns
# gathered (2 I/2 + H/2), the logits' columns gathered (V/2):
# 32 + 4 (64 + 128 + 32) + 64 = 992 values, 3968 bytes
PARENT_MODEL_BYTES_PER_TOKEN = 4 * (32 + 4 * (64 + 128 + 32) + 64)
# a forward's collectives over ``model`` at tp=2 (TINY4, 4 layers): each
# layer's two RMSNorm statistics psums, the attention input's gather,
# wo's reduce-scatter, one gather shared by gate and up, down's input
# gather; the final norm's psum, lm_head's input gather and the ArgMax's
# all-gather. The parent tree ran 4 * 4 + 2 = 18 (the embedding's columns
# gathered, each layer's attention psum and its gate, up and down columns
# gathered, the logits' columns gathered): a decode step, whose time
# follows its count of collectives more than their bytes, runs 1.5 times
# as many
SPLIT_MODEL_CALLS = 4 * 6 + 3
# the one-rank run's layer-output bytes a rank may hold at the degree
SHARE = {"tp2": 0.55, "tp4": 0.30}


def _place(sharding):
    """{axis: dim} of a JAX sharding's spec."""
    place = {}
    for d, axes in enumerate(sharding.spec):
        for a in (axes if isinstance(axes, tuple) else (axes,)):
            if a is not None:
                place[a] = d
    return place


class Probe:
    """GSPMD's placement of every layer output of the JAX package's
    serving forwards while ``active``: ``specs[id(model)][layer] =
    {(output, {axis: dim}) ...}`` over every forward traced."""

    def __init__(self):
        self.specs = {}

    def active(self, mp):
        from flexflow_tpu.core.model import FFModel

        orig = FFModel._apply_layer
        specs = self.specs

        def probe(model, layer, params, values, ctx):
            orig(model, layer, params, values, ctx)
            for j, t in enumerate(layer.outputs):
                def keep(sharding, key=(id(model), layer.name, j)):
                    specs.setdefault(key[0], {}).setdefault(
                        key[1], set()).add(
                            (key[2], tuple(sorted(_place(sharding)
                                                  .items()))))
                jax.debug.inspect_array_sharding(values[t.tensor_id],
                                                 callback=keep)

        mp.setattr(FFModel, "_apply_layer", probe)

    def places(self, model):
        """{layer: [{axis: dim} of each output]}; raises if a layer's
        outputs were placed differently in two forwards."""
        out = {}
        for name, got in self.specs.get(id(model), {}).items():
            by_output = {}
            for j, place in got:
                assert by_output.setdefault(j, place) == place, (name, got)
            out[name] = [dict(by_output[j]) for j in sorted(by_output)]
        return out


def _jax_llama(mode, strategy=None, generation=None, **deg):
    from flexflow_tpu.models.llama import LLAMAConfig, create_llama_model
    from flexflow_tpu.serve.batch_config import GenerationConfig

    m = ff.FFModel(ff.FFConfig(use_native_scheduler=False, **SERVE, **deg))
    create_llama_model(m, LLAMAConfig(**TINY4), mode=mode,
                       generation_config=GenerationConfig(
                           **(generation or {})))
    if strategy is not None:
        m.strategy = JStrategy.from_json(strategy.to_json())
    m.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
    return m


def _jax_family(family, **deg):
    fam = JFAMILIES[family]
    m = ff.FFModel(ff.FFConfig(use_native_scheduler=False, **SERVE, **deg))
    fam.build(m, fam.config_cls(**TINY_CONFIGS[family]),
              mode=JMode.INC_DECODING_MODE)
    m.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
    return m


def _jax_generate(m, ssm=None):
    rm = JRM()
    for p in PROMPTS:
        rm.register_new_request(p, max_new_tokens=SPEC_NEW if ssm else NEW)
    if ssm is None:
        res = rm.generate_incr_decoding(m)
    else:
        res = rm.generate_spec_infer(m, [ssm], spec_depth=3)
    by = {tuple(r.input_tokens): list(r.output_tokens) for r in res}
    return [by[tuple(p)] for p in PROMPTS]


def _save(jm, path):
    torch.save(params_from_jax({layer: {w: np.asarray(a)
                                        for w, a in lp.items()}
                                for layer, lp in jm.params.items()}), path)
    return str(path)


def _runs(mesh, w):
    cfg = dict(SERVE, **MESHES[mesh])
    runs = [dict(name="incr", model=TINY4, config=cfg, weights=w["incr"],
                 prompts=PROMPTS, max_new=NEW)]
    if mesh != "tp2":
        return runs
    runs.append(dict(name="sample", model=TINY4, config=cfg,
                     weights=w["incr"], generation=SAMPLE,
                     prompts=PROMPTS, max_new=NEW))
    runs.append(dict(name="spec", model=TINY4, config=cfg,
                     weights=w["tree"],
                     draft=dict(model=TINY4, weights=w["beam"]),
                     spec_depth=3, prompts=PROMPTS, max_new=SPEC_NEW))
    for name, st in STRATEGIES.items():
        runs.append(dict(name=name, model=TINY4, config=cfg,
                         weights=w["incr"], strategy=st.to_json(),
                         prompts=PROMPTS, max_new=NEW))
    for family in FAMILIES:
        runs.append(dict(name=family, family=family,
                         model=TINY_CONFIGS[family], config=cfg,
                         weights=w[family], prompts=PROMPTS, max_new=NEW))
    return runs


TRAIN_B = 8


def _train_strategy(package):
    """A strategy whose only op is the first dense layer of ``package``'s
    ``mlp`` (the packages name it differently), its output spec naming
    no axis."""
    m = load_target(f"{TEST_JOBS}:mlp")(package, package.FFConfig(
        batch_size=TRAIN_B, **({"device": "cpu"} if package is tff else {})))
    return Strategy(ops={m.layers[0].name: _op((None, None))})


def _train_batch():
    rng = np.random.default_rng(5)
    return (rng.standard_normal((TRAIN_B, 32), dtype=np.float32),
            rng.integers(0, 10, (TRAIN_B, 1)).astype(np.int32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(port rank results {mesh: [rank][run]}, the one-rank run, the
    split ArgMax results, the train-step placements, JAX {run: (tokens,
    places)}): the JAX models are built first, their weights written,
    then the rank launches run on a thread while JAX generates under the
    probe."""
    work = tmp_path_factory.mktemp("servplace")
    probe = Probe()
    inc = JMode.INC_DECODING_MODE
    jm = {"incr": _jax_llama(inc, **TP2),
          "tp4": _jax_llama(inc, **MESHES["tp4"]),
          "tree": _jax_llama(JMode.TREE_VERIFY_MODE, **TP2),
          "beam": _jax_llama(JMode.BEAM_SEARCH_MODE, **TP2)}
    jm["sample"] = _jax_llama(inc, generation=SAMPLE, **TP2)
    for name, st in STRATEGIES.items():
        jm[name] = _jax_llama(inc, strategy=st, **TP2)
    for family in FAMILIES:
        jm[family] = _jax_family(family, **TP2)
    w = {k: _save(jm[k], work / f"{k}.pt")
         for k in ("incr", "tree", "beam") + FAMILIES}
    port, errors = {}, []
    x, y = _train_batch()
    train_run = dict(builder=f"{TEST_JOBS}:mlp",
                     config=dict(batch_size=TRAIN_B, seed=1, **TP2),
                     strategy=_train_strategy(tff).to_json(),
                     optimizer=["sgd", {"lr": 0.05}], x=x.tolist(),
                     x_dtype="float32", y=y.tolist())

    def launch():
        try:
            for mesh, deg in MESHES.items():
                n = int(np.prod(list(deg.values())))
                port[mesh] = run_ranks(JOB, n, {
                    "device": "cpu", "runs": _runs(mesh, w)},
                    workdir=work / mesh, timeout=240)
            port["argmax"] = run_ranks(
                f"{TEST_JOBS}:split_argmax", 2,
                {"device": "cpu", "degrees": TP2},
                workdir=work / "argmax", timeout=120)
            port["train"] = run_ranks(
                f"{TEST_JOBS}:tp_placement", 2,
                {"device": "cpu", "runs": [train_run]},
                workdir=work / "train", timeout=120)
            port["one"] = {r["name"]: r for r in load_target(JOB)({
                "device": "cpu", "runs": [
                    dict(name="incr", model=TINY4, config=SERVE,
                         weights=w["incr"], prompts=PROMPTS, max_new=NEW),
                    dict(name="sample", model=TINY4, config=SERVE,
                         weights=w["incr"], generation=SAMPLE,
                         prompts=PROMPTS, max_new=NEW)]})}
        except Exception as e:          # re-raised in the test thread
            errors.append(e)

    t = threading.Thread(target=launch)
    t.start()
    jax_out = {}
    with pytest.MonkeyPatch.context() as mp:
        probe.active(mp)
        for name in ("incr", "tp4", "sample", *STRATEGIES, *FAMILIES):
            jax_out[name] = (_jax_generate(jm[name]), probe.places(jm[name]))
        jax_out["spec"] = (_jax_generate(jm["tree"], jm["beam"]),
                           probe.places(jm["tree"]))
        jax_out["draft"] = probe.places(jm["beam"])
        jax_out["train"] = _jax_train_places(probe, mp)
    t.join()
    if errors:
        raise errors[0]
    return port, jax_out


def _jax_train_places(probe, mp):
    """GSPMD's placement of the layer outputs of one JAX train step of
    ``mlp`` at tp=2 under ``TRAIN_STRATEGY``."""
    m = load_target(f"{TEST_JOBS}:mlp")(ff, ff.FFConfig(
        batch_size=TRAIN_B, seed=1, mesh_shape=(2,),
        mesh_axis_names=("model",)))
    m.strategy = JStrategy.from_json(_train_strategy(ff).to_json())
    assert m.layers[0].name in m.strategy.ops
    m.compile(optimizer=ff.SGDOptimizer(m, lr=0.05),
              loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    x, y = _train_batch()
    m.train_one_batch([x], y)
    return [probe.places(m)[layer.name] for layer in m.layers]


def _port(port, mesh, name):
    i = [r["name"] for r in port[mesh][0]].index(name)
    return [rank[i] for rank in port[mesh]]


# (mesh, run): the port's ranks against GSPMD's places of the JAX run
PLACE_CASES = [("tp2", "incr"), ("tp4", "tp4"), ("tp2", "spec"),
               ("tp2", "sample"), ("tp2", "rows"), ("tp2", "heads")] + [
    ("tp2", family) for family in FAMILIES]


@pytest.mark.parametrize("mesh,name", PLACE_CASES)
def test_layer_outputs_placed_as_gspmd(runs, mesh, name):
    """Every layer output the port's ranks report of their prefill is
    placed where GSPMD places the JAX package's: split over ``model`` on
    its last dim, the head's tokens (ArgMax or Sampling) whole."""
    port, jax_out = runs
    want = jax_out[name][1]
    head = "sampling" if name == "sample" else "argmax"
    assert want and all(
        places == [{"model": 2}] for layer, places in want.items()
        if layer != head), want
    assert want[head] == [{}]
    for r in _port(port, mesh, "incr" if name == "tp4" else name):
        assert r["places"] == want, (name, r["rank"])


def test_pipeline_stages_placed_as_gspmd(runs):
    """At tp2pp2 each rank reports its stage's layers (the embedding on
    the first, the head on the last), each placed as GSPMD places it at
    tp=2, and every rank reads the tokens of the JAX run."""
    port, jax_out = runs
    tokens, want = jax_out["incr"]
    seen = set()
    for r in _port(port, "tp2pp2", "incr"):
        assert r["tokens"] == tokens, r["rank"]
        assert r["places"], r["rank"]
        for layer, places in r["places"].items():
            assert places == want[layer], (layer, r["rank"])
        seen |= set(r["places"])
    assert seen == set(want)


def test_beam_draft_reports_nothing_to_the_probe(runs):
    """The draft's steps are invisible to the probe in the JAX package;
    it is held by the SpecInfer run's tokens (test_tokens_match_jax)."""
    assert runs[1]["draft"] == {}


@pytest.mark.parametrize("mesh,name", [("tp2", "incr"), ("tp4", "tp4"),
                                       ("tp2", "spec"), ("tp2", "rows"),
                                       ("tp2", "heads")]
                         + [("tp2", f) for f in FAMILIES])
def test_tokens_match_jax(runs, mesh, name):
    port, jax_out = runs
    for r in _port(port, mesh, "incr" if name == "tp4" else name):
        assert r["tokens"] == jax_out[name][0], (name, r["rank"])


def test_sampled_tokens_match_one_rank(runs):
    """The top-p head at tp=2 (its logits gathered for Sampling) draws
    the one-rank run's tokens under the same seed, and they are not the
    greedy ones."""
    one = runs[0]["one"]
    assert one["sample"]["tokens"] != one["incr"]["tokens"]
    for r in _port(runs[0], "tp2", "sample"):
        assert r["tokens"] == one["sample"]["tokens"], r["rank"]


@pytest.mark.parametrize("case", ["random", "tie_inside_shard",
                                  "tie_across_shards", "all_equal"])
def test_split_argmax_equals_whole_argmax(runs, case):
    for r in runs[0]["argmax"]:
        assert r[case]["split"] == r[case]["whole"], case


@pytest.mark.parametrize("mesh", list(SHARE))
def test_layer_output_bytes_split(runs, mesh):
    """A rank holds at most SHARE of the one-rank run's layer-output bytes
    when the prefill returns (whole on every rank before the split)."""
    port = runs[0]
    one = port["one"]["incr"]["prefill"]["layer_output_bytes"]
    for r in _port(port, mesh, "incr"):
        got = r["prefill"]["layer_output_bytes"]
        assert got <= SHARE[mesh] * one, (mesh, r["rank"], got, one)


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_model_collective_bytes_below_parent(runs, step):
    """The tp=2 forward's collectives over ``model`` move fewer bytes than
    the parent tree's did for the same tokens (PARENT_MODEL_BYTES_PER_
    TOKEN: 3968 bytes a token, 63488 for the 2 x 8 prefill)."""
    for r in _port(runs[0], "tp2", "incr"):
        rec = r[step]
        tokens = rec["tokens"][0] * rec["tokens"][1]
        got = axis_bytes(rec["moved"], "model")
        assert 0 < got < PARENT_MODEL_BYTES_PER_TOKEN * tokens, (step, rec)


@pytest.mark.parametrize("step", ["prefill", "decode"])
def test_model_collective_calls(runs, step):
    """The tp=2 forward runs SPLIT_MODEL_CALLS collectives over
    ``model``, the same for the prefill and a decode step."""
    for r in _port(runs[0], "tp2", "incr"):
        assert axis_bytes(r[step]["calls"], "model") == SPLIT_MODEL_CALLS, \
            (step, r[step]["calls"])


def test_all_none_spec_keeps_a_serving_value_split(runs):
    """The strategies' outputs whose spec names no axis (a row-sharded
    down_proj, an attention with whole projections at rest) stay split,
    as GSPMD keeps them."""
    port, jax_out = runs
    for name, layer in (("rows", "layers.0.mlp.down_proj"),
                        ("heads", "layers.2.self_attn")):
        assert jax_out[name][1][layer] == [{"model": 2}]
        for r in _port(port, "tp2", name):
            assert r["places"][layer] == [{"model": 2}], (name, r["rank"])


def test_all_none_spec_keeps_a_train_value_split(runs):
    """In a train step too (``Walk.places`` of the tp_placement job)."""
    port, jax_out = runs
    want = jax_out["train"]
    assert want[0] == [{"model": 1}]
    for rank in port["train"]:
        assert rank[0]["places"] == want, rank[0]["rank"]


def test_all_none_spec_constrains_nothing():
    """``Walk.place_output`` and ``ShardingPolicy.constrain`` leave a
    split value where it is for a spec that names no axis of the
    mesh."""
    layer = types.SimpleNamespace(
        outputs=[types.SimpleNamespace(tensor_id=7)])
    for rank in range(2):
        mesh = Mesh((2,), ("model",), rank=rank)
        x = torch.arange(24.0).reshape(2, 4, 3)
        walk = Walk(mesh, False, features=True, serving=True)
        walk.places[7] = {"model": 2}
        values = {7: x}
        walk.place_output(layer, values, (None, None, None))
        assert values[7] is x and walk.places[7] == {"model": 2}
        pol = ShardingPolicy(mesh)
        assert pol.constrain(x, (None, None, None),
                             src=(None, None, "model")) is x
        assert pol.constrain(x, ("data", None, None),
                             src=(None, None, "model")) is x
