"""The port's speculative inference against the JAX package, on the CPU.

Tiny LLaMAs (vocab 128, hidden 64, 2 layers, 4/2 heads; 2 request slots,
a 64- or 32-position fp32 KV cache) are built in both packages; the JAX
model's weights reach the port through ``params_from_jax``. The JAX side
runs its CPU path (plain attention, no Pallas). Draft models: ``same``
shares the verifier's weights (seed 0), ``trunc`` is its 1-layer
truncation (the JAX package seeds each weight by its name, so seed 0
gives the verifier's own embedding, first layer and head), others are
unrelated seeds.

Covered: the ancestor mask; the tree attention op after a prefill; both
engines' ``run_block`` packed contract and committed KV, static and
adaptive; ``generate_spec_infer`` end to end in the scenarios of
``tests/test_serving.py`` (tokens equal to the JAX package's and to the
port's own incremental decoding); the controller's cost model and its
park-on-zero-acceptance path; ``LLM(...).compile(ssms=[SSM(...)])``; and
the engine routing rule, beam widths included (beam drafting itself is
``tests/test_torch_beam.py``'s).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.ffconst import InferenceMode as JMode
from flexflow_tpu.models.llama import LLAMAConfig as JLlamaConfig
from flexflow_tpu.models.llama import create_llama_model as jax_create_llama
from flexflow_tpu.ops.base import OpContext as JOpContext
from flexflow_tpu.serve import batch_config as jbc
from flexflow_tpu.serve import spec_controller as jsc
from flexflow_tpu.serve.api import LLM as JLLM
from flexflow_tpu.serve.api import SSM as JSSM
from flexflow_tpu.serve.engine import MultiSpecEngine as JMultiSpecEngine
from flexflow_tpu.serve.engine import SpecChainEngine as JSpecChainEngine
from flexflow_tpu.serve.inference_manager import \
    InferenceManager as JInferenceManager
from flexflow_tpu.serve.request_manager import RequestManager as JRM
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.ffconst import InferenceMode
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.ops.base import OpContext
from flexflow_tpu_torch.serve import batch_config as tbc
from flexflow_tpu_torch.serve import request_manager as trm
from flexflow_tpu_torch.serve import spec_controller as tsc
from flexflow_tpu_torch.serve.engine import MultiSpecEngine, SpecChainEngine
from flexflow_tpu_torch.serve.inference_manager import InferenceManager
from flexflow_tpu_torch.serve.request_manager import RequestManager

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
R = 2
STATIC = dict(adaptive_spec=False)
# draft name -> (seed, layers)
DRAFTS = {"same": (0, 2), "trunc": (0, 1), "div": (123, 2), "s7": (7, 2),
          "s3": (3, 2), "adv": (99, 1)}

_models = {}


def _pair(mode, seed=0, S=64, layers=2):
    """(jax model, port model with the same weights), built once each."""
    key = (mode, seed, S, layers)
    if key not in _models:
        tiny = {**TINY, "num_hidden_layers": layers}
        serve = dict(max_requests_per_batch=R, max_sequence_length=S,
                     max_tokens_per_batch=16, seed=seed,
                     kv_cache_dtype="float32")
        jm = ff.FFModel(ff.FFConfig(use_native_scheduler=False, **serve))
        jax_create_llama(jm, JLlamaConfig(**tiny), mode=JMode(mode.value))
        jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
        pm = fft.FFModel(fft.FFConfig(device="cpu", **serve))
        create_llama_model(pm, LLAMAConfig(**tiny), mode=mode)
        pm.compile()
        load_params(pm, params_from_jax(
            {layer: {w: np.asarray(a) for w, a in lp.items()}
             for layer, lp in jm.params.items()}))
        _models[key] = (jm, pm)
    return _models[key]


def _verifier(S=64):
    return _pair(InferenceMode.TREE_VERIFY_MODE, 0, S)


def _draft(name, S=64):
    seed, layers = DRAFTS[name]
    return _pair(InferenceMode.BEAM_SEARCH_MODE, seed, S, layers)


# ----------------------------------------------------------------------
# 1. ancestor mask
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ancestor_mask_matches_jax(seed):
    rng = np.random.RandomState(seed)
    T = 9
    parent = np.full((3, T), -1, np.int32)
    for i in range(1, T):
        parent[:, i] = rng.randint(0, i, size=3)
    np.testing.assert_array_equal(tbc.ancestor_mask_from_parents(parent),
                                  jbc.ancestor_mask_from_parents(parent))


# ----------------------------------------------------------------------
# 2. the tree attention op
# ----------------------------------------------------------------------
def _logits_tid(model):
    return next(layer for layer in model.layers
                if layer.name == "lm_head").outputs[0].tensor_id


def _run_both(jm, pm, jstate, tstate, jmeta, tmeta, contiguous):
    jctx = JOpContext(compute_dtype=jnp.float32, batch_config=jmeta,
                      mesh=jm.mesh, config=jm.config)
    jctx.kv_contiguous = contiguous
    jvals, jstate = jm._run_graph(
        jm.params, {jm.input_tensors[0].tensor_id: jmeta.tokens}, jctx,
        jstate)
    tvals, tstate = pm._run_graph(
        pm.params, {pm.input_tensors[0].tensor_id: tmeta.tokens},
        OpContext(compute_dtype=torch.float32, batch_config=tmeta,
                  kv_contiguous=contiguous), tstate)
    return (np.asarray(jvals[_logits_tid(jm)]),
            tvals[_logits_tid(pm)].numpy(), jstate, tstate)


@pytest.mark.parametrize("contiguous", [False, True])
def test_tree_attention_after_prefill_matches_jax(contiguous):
    """A chunked prefill, then one verify step over a branchy 8-node tree
    (row 1 has 5 real nodes and 3 padding nodes): logits of the real
    nodes and the staged KV to 1e-5."""
    jm, pm = _verifier()
    rng = np.random.RandomState(4)
    num = np.array([6, 3], np.int32)
    toks = np.zeros((R, 8), np.int32)
    toks[0, :6] = rng.randint(1, 128, 6)
    toks[1, :3] = rng.randint(1, 128, 3)
    prefill = dict(tokens=toks,
                   positions=np.tile(np.arange(8, dtype=np.int32), (R, 1)),
                   start_pos=np.zeros(R, np.int32), num_tokens=num,
                   active=np.ones(R, bool))
    tstate = {n: {k: t.clone() for k, t in st.items()}
              for n, st in pm.op_state.items()}
    _, _, jstate, tstate = _run_both(
        jm, pm, jm.op_state, tstate, jbc.make_batch_meta(R, 8, **prefill),
        tbc.make_batch_meta(R, 8, **prefill), False)

    parent = np.array([[-1, 0, 0, 1, 1, 2, 3, 3],
                       [-1, 0, 1, 0, 3, -1, -1, -1]], np.int32)
    depth = np.zeros_like(parent)
    for i in range(1, 8):
        depth[:, i] = np.where(parent[:, i] >= 0,
                               depth[np.arange(R), parent[:, i].clip(0)] + 1,
                               0)
    nodes = np.array([8, 5], np.int32)
    tree = dict(tokens=rng.randint(1, 128, (R, 8)).astype(np.int32),
                positions=(num[:, None] + depth).astype(np.int32),
                parent=parent,
                ancestor=jbc.ancestor_mask_from_parents(parent),
                start_pos=num, num_nodes=nodes, active=np.ones(R, bool))
    jl, tl, jstate, tstate = _run_both(
        jm, pm, jstate, tstate,
        jbc.TreeBatchMeta(**{k: jnp.asarray(v) for k, v in tree.items()}),
        tbc.TreeBatchMeta(**tree).to("cpu"), contiguous)
    real = np.arange(8)[None, :] < nodes[:, None]
    np.testing.assert_allclose(tl[real], jl[real], atol=1e-5, rtol=1e-5)
    for name in ("k", "v"):
        jc = np.asarray(jstate["kv_cache"][name])
        tc = tstate["kv_cache"][name].numpy()
        for r in range(R):
            n = num[r] + nodes[r]
            np.testing.assert_allclose(tc[:, r, :, :n], jc[:, r, :, :n],
                                       atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------------------
# 3. the engines' run_block
# ----------------------------------------------------------------------
ENGINES = {"chain": ["trunc"], "tree B=1": ["trunc"],
           "tree B=2": ["div", "trunc"]}


def _prefill(jm, pm, prompts):
    toks = np.zeros((R, 8), np.int32)
    num = np.zeros(R, np.int32)
    for r, p in enumerate(prompts):
        toks[r, :len(p) - 1] = p[:-1]
        num[r] = len(p) - 1
    meta = dict(tokens=toks,
                positions=np.tile(np.arange(8, dtype=np.int32), (R, 1)),
                start_pos=np.zeros(R, np.int32), num_tokens=num,
                active=np.ones(R, bool))
    JInferenceManager(jm).step(jbc.make_batch_meta(R, 8, **meta),
                               want_output=False)
    InferenceManager(pm).step(tbc.make_batch_meta(R, 8, **meta),
                              want_output=False)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_run_block_matches_jax(engine, adaptive):
    """Same packed (tokens, n_acc, depth_used) as the JAX engine and the
    same committed verifier KV (1e-5), with a static depth and with an
    adaptive depth vector; row 1's smaller budget ends it early, so
    later rounds run with an inactive row."""
    jllm, tllm = _verifier()
    drafts = [_draft(n) for n in ENGINES[engine]]
    prompts = [[5, 9, 23, 44, 17], [7, 3, 11]]
    for jm, pm in [(jllm, tllm)] + drafts:
        _prefill(jm, pm, prompts)
    depth, rounds = 4, 6
    if engine == "chain":
        jeng = JSpecChainEngine(jllm, drafts[0][0], depth, max_rounds=rounds)
        teng = SpecChainEngine(tllm, drafts[0][1], depth, max_rounds=rounds)
    else:
        jeng = JMultiSpecEngine(jllm, [j for j, _ in drafts], depth,
                                max_rounds=rounds)
        teng = MultiSpecEngine(tllm, [t for _, t in drafts], depth,
                               max_rounds=rounds)
    args = (np.array([p[-1] for p in prompts], np.int32),
            np.array([len(p) - 1 for p in prompts], np.int32),
            np.ones(R, bool), rounds, np.array([14, 5], np.int32))
    kw = dict(depth=np.array([2, 4], np.int32), min_depth=1) if adaptive \
        else {}
    ja, jn, jd = jeng.run_block(*args, **kw)
    ta, tn, td = teng.run_block(*args, **kw)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(td, jd)
    ran = jn >= 0
    assert ran[:, 0].all() and not ran[1].all()       # row 1 ran out
    np.testing.assert_array_equal(ta[ran], ja[ran])
    assert teng.rounds_run == int(ran.any(0).sum())
    committed = args[1] + (jn + 1).clip(min=0).sum(1)
    for name in ("k", "v"):
        jc = np.asarray(jllm.op_state["kv_cache"][name])
        tc = tllm.op_state["kv_cache"][name].numpy()
        for r in range(R):
            np.testing.assert_allclose(tc[:, r, :, :committed[r]],
                                       jc[:, r, :, :committed[r]],
                                       atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B, depth, width", [(1, 1, 8), (1, 7, 8), (1, 8, 16),
                                             (2, 3, 8), (2, 4, 16)])
def test_tree_width_rounds_up_to_the_decode_width(B, depth, width):
    """One draft up to depth 7 verifies at the incremental decode's width
    (the card's bitwise spec == incr rests on the shared shapes); the
    engine's live mask and the host's room gate both reserve it."""
    _, tllm = _verifier()
    eng = MultiSpecEngine(tllm, [_draft("trunc")[1]] * B, depth)
    assert eng.tree_width == width
    assert InferenceManager(tllm).decode_width == 1   # the CPU: width 1
    assert trm.kernel_serves(tllm) is False


# ----------------------------------------------------------------------
# 4. generate_spec_infer end to end
# ----------------------------------------------------------------------
# name -> (cache length, [(prompt, max_new_tokens)], drafts, depth)
E2E = {
    # test_serving.py:122, a draft with the verifier's weights
    "same-weight draft": (64, [([5, 9, 23, 44], 12), ([7, 3, 11], 12)],
                          ["same"], 4),
    # :145, a divergent draft
    "divergent draft": (64, [([5, 9, 23, 44], 10)], ["div"], 4),
    # :212, one request too cramped to draft beside a roomy one
    "cramped and roomy": (32, [(list(range(1, 28)), 8), ([5, 9, 23], 12)],
                          ["same"], 4),
    # :242, EOS accepted mid-round and the token budget
    "eos and budget": (64, [([5, 9, 23, 44], 7)], ["same"], 4),
    # :263, two drafts: a real token tree and the KV commit
    "multi-ssm tree": (64, [([5, 9, 23, 44], 10), ([2, 8], 10)],
                       ["same", "s7"], 3),
    # :285, two drafts near the cache end
    "multi-ssm near the limit": (32, [(list(range(1, 26)), 20)],
                                 ["s3", "same"], 4),
    # :526, a prompt between the unpadded and padded tree windows
    "multi-ssm draftable window": (32, [(list(range(1, 19)), 10)],
                                   ["same", "s7"], 4),
    # :549, the single-SSM tree path called directly
    "single-ssm tree path": (64, [([5, 9, 23, 44], 12), ([7, 3, 11], 12)],
                             ["same"], 4),
}


def _gen(rm, reqs, run):
    guids = [rm.register_new_request(p, max_new_tokens=n) for p, n in reqs]
    run(rm)
    return [rm.results[g].output_tokens for g in guids]


@pytest.mark.parametrize("case", list(E2E))
def test_generate_spec_infer_matches_jax_and_incr(case):
    """With the controller off, so that every case runs the engines (with
    it on, a draft as large as its verifier parks at once)."""
    S, reqs, names, depth = E2E[case]
    jllm, tllm = _verifier(S)
    drafts = [_draft(n, S) for n in names]
    eos = None
    if case == "eos and budget":
        eos = _gen(RequestManager(), reqs,
                   lambda rm: rm.generate_incr_decoding(tllm))[0][3]
    incr = _gen(RequestManager(eos_token_id=eos), reqs,
                lambda rm: rm.generate_incr_decoding(tllm))
    if eos is not None:
        assert len(incr[0]) < reqs[0][1] and incr[0][-1] == eos
    direct = case == "single-ssm tree path"

    def spec(rm_cls, llm, ssms, gc):
        def run(rm):
            if direct:
                return rm._generate_spec_tree_fused(
                    llm, ssms, spec_depth=depth, generation_config=gc)
            return rm.generate_spec_infer(llm, ssms, spec_depth=depth,
                                          generation_config=gc)
        return _gen(rm_cls(eos_token_id=eos), reqs, run)

    jout = spec(JRM, jllm, [j for j, _ in drafts],
                jbc.GenerationConfig(**STATIC))
    tout = spec(RequestManager, tllm, [t for _, t in drafts],
                tbc.GenerationConfig(**STATIC))
    assert tout == jout
    assert tout == incr
    assert [len(t) for t in tout] == [len(t) for t in incr]


# ----------------------------------------------------------------------
# 5. the controller
# ----------------------------------------------------------------------
def test_controller_cost_model_matches_jax():
    for p in np.linspace(0.0, 1.0, 11):
        for d in range(1, 9):
            assert (tsc.expected_tokens_per_round(p, d)
                    == jsc.expected_tokens_per_round(p, d))
            for ratio in (0.02, 0.1, 0.5, 1.0):
                assert tsc.round_cost(d, ratio) == jsc.round_cost(d, ratio)
                assert (tsc.speedup_estimate(p, d, ratio)
                        == jsc.speedup_estimate(p, d, ratio))
                assert (tsc.best_depth(p, 1, d, ratio)
                        == jsc.best_depth(p, 1, d, ratio))
    trace = [(4, 4), (4, 2), (3, 0), (2, 0), (1, 0), (1, 1), (2, 2), (3, 3)]
    for ratio in (0.1, 0.4, 1.0):
        kw = dict(min_depth=1, max_depth=8, draft_cost_ratio=ratio,
                  ewma_alpha=0.5, probe_every=2)
        assert ([dataclass_tuple(s) for s in tsc.depth_schedule(
            trace, tsc.ControllerPolicy(**kw))]
            == [dataclass_tuple(s) for s in jsc.depth_schedule(
                trace, jsc.ControllerPolicy(**kw))])
    (jllm, tllm), (jssm, tssm) = _verifier(), _draft("trunc")
    assert (tsc.estimate_draft_cost_ratio(tllm, [tssm])
            == jsc.estimate_draft_cost_ratio(jllm, [jssm]))


def dataclass_tuple(st):
    return (st.acceptance, st.depth, st.fallback, st.fallback_blocks,
            st.fallback_entries)


def test_zero_acceptance_draft_parks_on_fallback_decode(monkeypatch):
    """test_spec_controller.py:214 in the port: a cheap 1-layer draft with
    unrelated weights accepts nothing; the controller parks both
    requests, most tokens come through ``_fallback_decode``, and the
    output equals incremental decoding."""
    _, tllm = _verifier()
    _, adv = _draft("adv")
    reqs = [([5, 9, 23, 44], 40), ([7, 3, 11], 40)]
    incr = _gen(RequestManager(), reqs,
                lambda rm: rm.generate_incr_decoding(tllm))
    decoded = []
    orig = RequestManager._fallback_decode

    def spy(self, llm_ifm, reqs_, *a):
        decoded.append(orig(self, llm_ifm, reqs_, *a) * len(reqs_))
        return decoded[-1] // len(reqs_)

    monkeypatch.setattr(RequestManager, "_fallback_decode", spy)
    rm = RequestManager()
    out = _gen(rm, reqs, lambda rm: rm.generate_spec_infer(tllm, [adv]))
    assert out == incr and all(len(t) == 40 for t in out)
    assert rm.spec_stats["parked"] >= 2
    assert rm.spec_stats["rounds"] <= 20
    assert sum(decoded) >= 40


# ----------------------------------------------------------------------
# 6. the LLM API with draft models
# ----------------------------------------------------------------------
def _hf_pair(seed=3):
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


def test_llm_with_ssm_generate_matches_jax():
    cfg, sd = _hf_pair()
    kw = dict(max_requests_per_batch=2, max_seq_length=64,
              max_tokens_per_batch=16, kv_cache_dtype="float32")
    prompts = [[5, 9, 23, 44], [7, 3, 11], [100, 2]]
    jllm = JLLM((cfg, dict(sd))).compile(
        ssms=[JSSM((cfg, dict(sd)))], use_native_scheduler=False, **kw)
    tllm = fft.LLM((cfg, dict(sd))).compile(
        ssms=[fft.SSM((cfg, dict(sd)))], device="cpu", **kw)
    assert tllm.ffmodel.layers[2].op_type.name == \
        "TREE_INC_MULTIHEAD_SELF_ATTENTION"
    assert tllm.ssms[0].ffmodel.layers[2].op_type.name == \
        "SPEC_INC_MULTIHEAD_SELF_ATTENTION"
    jres = jllm.generate(prompts, max_new_tokens=10)
    tres = tllm.generate(prompts, max_new_tokens=10)
    assert [r.output_tokens for r in tres] == [r.output_tokens for r in jres]
    assert all(len(r.output_tokens) == 10 for r in tres)


# ----------------------------------------------------------------------
# 7. engine routing
# ----------------------------------------------------------------------
def test_single_ssm_routing_and_beam_width_raises(monkeypatch):
    """Width 1: one draft -> the chain engine on the CPU, the fused tree
    engine where the kernel serves; several -> the fused tree engine.
    Width 2 (a beam-mode draft built at max_beam_width 2, whose graph
    ends in the packed top-2 head): one draft -> the beam engine through
    _generate_spec_chain, several -> the host tree path. A width the
    drafts were not built with raises ValueError."""
    _, tllm = _verifier()
    _, ssm = _draft("trunc")
    taken = []
    for name in ("_generate_spec_chain", "_generate_spec_tree_fused",
                 "_generate_spec_tree_host"):
        monkeypatch.setattr(
            RequestManager, name,
            lambda self, *a, _n=name, **k: taken.append(
                (_n, k.get("beam_width", 1))))
    rm = RequestManager()
    rm.generate_spec_infer(tllm, [ssm])
    assert taken == [("_generate_spec_chain", 1)]       # the CPU: chain
    monkeypatch.setattr(trm, "kernel_serves", lambda model: True)
    rm.generate_spec_infer(tllm, [ssm])
    rm.generate_spec_infer(tllm, [ssm, ssm])
    assert taken[1:] == [("_generate_spec_tree_fused", 1)] * 2
    m = fft.FFModel(fft.FFConfig(device="cpu", max_beam_width=2))
    create_llama_model(m, LLAMAConfig(**TINY),
                       mode=InferenceMode.BEAM_SEARCH_MODE)
    assert m.layers[-1].op_type == fft.OpType.CONCAT
    assert m.layers[-1].outputs[0].dims[-1] == 4
    del taken[:]
    rm.generate_spec_infer(tllm, [m], beam_width=2)
    rm.generate_spec_infer(tllm, [m, m])
    assert taken == [("_generate_spec_chain", 2),
                     ("_generate_spec_tree_host", 2)]
    with pytest.raises(ValueError, match="max_beam_width"):
        rm.generate_spec_infer(tllm, [ssm], beam_width=2)
