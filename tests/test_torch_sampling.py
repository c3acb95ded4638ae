"""The port's top-p sampling and its selection heads against the JAX
package, on the CPU.

The two packages draw from different generators (a ``torch.Generator``
here, a JAX PRNG key there), so tokens are compared only where the draw
is forced (top-p 1e-9 keeps one token) and otherwise by what a draw may
be (never outside the nucleus) and by distribution: the empirical
distributions of 2000 draws in each package over the same ``[4, 32]``
logits must agree to a total variation under 0.08 on every row. With
at most 32 outcomes a row, two 2000-draw samples of one distribution
land about 0.02-0.05 apart; 0.08 still catches a wrong temperature or a
nucleus one token too wide.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.ffconst import InferenceMode as JMode
from flexflow_tpu.models.llama import LLAMAConfig as JLlamaConfig
from flexflow_tpu.models.llama import create_llama_model as jax_create_llama
from flexflow_tpu.ops import sampling_ops as jsamp
from flexflow_tpu.serve import batch_config as jbc
from flexflow_tpu.serve.request_manager import RequestManager as JRM
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.ffconst import InferenceMode, OpType
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.ops import sampling_ops as tsamp
from flexflow_tpu_torch.ops.base import OpContext
from flexflow_tpu_torch.serve import batch_config as tbc
from flexflow_tpu_torch.serve.request_manager import RequestManager

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
SERVE = dict(max_requests_per_batch=2, max_sequence_length=64,
             max_tokens_per_batch=16, kv_cache_dtype="float32")
PROMPTS = [([5, 9, 23, 44], 12), ([7, 3, 11], 12)]
N_DRAWS, TV_LIMIT = 2000, 0.08


def _logits(seed=0):
    """[4, 32] logits; row 3 has a three-way tie at its maximum."""
    x = 2.0 * np.random.RandomState(seed).randn(4, 32).astype(np.float32)
    x[3, [4, 9, 20]] = x[3].max() + 1.0
    return x


def _draws(logits, top_p, temperature, n=N_DRAWS, seed=0):
    """(jax draws, port draws), int arrays [n, *logits.shape[:-1]]."""
    tiled = np.broadcast_to(logits, (n,) + logits.shape)
    j = jsamp.top_p_sampling(jnp.asarray(tiled), jax.random.PRNGKey(seed),
                             top_p, temperature)
    g = torch.Generator().manual_seed(seed)
    t = tsamp.top_p_sampling(torch.as_tensor(np.ascontiguousarray(tiled)),
                             g, top_p, temperature)
    return np.asarray(j), t.numpy()


def _nucleus(logits, top_p, temperature):
    """Per row, the set of tokens a top-p draw may return (the JAX rule:
    keep while the preceding cumulative mass is below top_p)."""
    z = logits / temperature
    p = np.exp(z - z.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    out = []
    for row in p:
        order = np.argsort(-row, kind="stable")
        cum = np.cumsum(row[order])
        out.append(set(order[(cum - row[order]) < top_p].tolist()))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_top_p_tiny_equals_argmax_in_both(seed):
    """top_p 1e-9 at temperature 1.0 keeps only the most probable token
    (the lower index on ties), so every draw is the argmax."""
    x = _logits(seed)
    j, t = _draws(x, 1e-9, 1.0, n=16, seed=seed)
    want = np.broadcast_to(np.argmax(x, -1), j.shape)
    np.testing.assert_array_equal(j, want)
    np.testing.assert_array_equal(t, want)
    assert want[0, 3] == 4


def test_draws_stay_in_the_nucleus_in_both():
    x = _logits(2)
    j, t = _draws(x, 0.5, 0.8)
    for r, allowed in enumerate(_nucleus(x, 0.5, 0.8)):
        assert set(np.unique(j[:, r])) <= allowed
        assert set(np.unique(t[:, r])) <= allowed
        assert len(set(np.unique(t[:, r]))) == len(allowed)


def test_sample_distributions_agree_with_jax():
    x = _logits(3)
    j, t = _draws(x, 0.9, 0.8)
    V = x.shape[-1]
    for r in range(x.shape[0]):
        pj = np.bincount(j[:, r], minlength=V) / N_DRAWS
        pt = np.bincount(t[:, r], minlength=V) / N_DRAWS
        tv = 0.5 * np.abs(pj - pt).sum()
        assert tv < TV_LIMIT, (r, tv)


@pytest.mark.parametrize("op", ["argmax beam variant", "beam_top_k"])
def test_selection_heads_match_jax(op):
    x = np.round(np.random.RandomState(4).randn(2, 3, 5).astype(np.float32),
                 1)
    if op == "argmax beam variant":
        attrs, jcls, tcls = dict(beam_search=True), jsamp.ArgMax, tsamp.ArgMax
    else:
        attrs, jcls, tcls = (dict(max_beam_width=4), jsamp.BeamTopK,
                             tsamp.BeamTopK)
    jout = jcls.forward(attrs, {}, [jnp.asarray(x)], None)
    tout = tcls.forward(attrs, {}, [torch.as_tensor(x)], None)
    assert len(tout) == len(jout) == len(tcls.infer_output_specs(
        attrs, [(x.shape, None)]))
    for j, t in zip(jout, tout):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ----------------------------------------------------------------------
# sampled serving
# ----------------------------------------------------------------------
def _port_model(mode=InferenceMode.INC_DECODING_MODE, seed=0, gc=None):
    m = fft.FFModel(fft.FFConfig(device="cpu", seed=seed, **SERVE))
    create_llama_model(m, LLAMAConfig(**TINY), mode=mode,
                       generation_config=gc)
    return m.compile()


def _gen(rm, run, reqs=PROMPTS):
    guids = [rm.register_new_request(p, max_new_tokens=n) for p, n in reqs]
    run(rm)
    return [rm.results[g].output_tokens for g in guids]


def test_sampled_decoding_is_reproducible_under_one_seed():
    """Two models built with the same seed (weights and generator) give
    the same sampled tokens; reseeding one model's generator repeats its
    draws; the draws are not the greedy tokens."""
    gc = tbc.GenerationConfig(do_sample=True, topp=0.9, temperature=1.0)
    a, b = _port_model(gc=gc), _port_model(gc=gc)
    assert a.layers[-1].op_type == OpType.SAMPLING
    ta = _gen(RequestManager(), lambda rm: rm.generate_incr_decoding(a))
    tb = _gen(RequestManager(), lambda rm: rm.generate_incr_decoding(b))
    assert ta == tb and all(len(t) == 12 for t in ta)
    b._inference_manager.generator.manual_seed(b.config.seed)
    assert _gen(RequestManager(),
                lambda rm: rm.generate_incr_decoding(b)) == ta
    greedy = _gen(RequestManager(),
                  lambda rm: rm.generate_incr_decoding(_port_model()))
    assert ta != greedy


def test_top_p_tiny_decoding_equals_greedy_and_jax():
    """A sampled graph at top_p 1e-9 and temperature 1.0 decodes the
    greedy tokens, in the port and in the JAX package (same weights)."""
    gc = dict(do_sample=True, topp=1e-9, temperature=1.0)
    jm = ff.FFModel(ff.FFConfig(use_native_scheduler=False, seed=0, **SERVE))
    jax_create_llama(jm, JLlamaConfig(**TINY), mode=JMode.INC_DECODING_MODE,
                     generation_config=jbc.GenerationConfig(**gc))
    jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
    pm = _port_model(gc=tbc.GenerationConfig(**gc))
    greedy = _port_model()
    for m in (pm, greedy):
        load_params(m, params_from_jax(
            {layer: {w: np.asarray(a) for w, a in lp.items()}
             for layer, lp in jm.params.items()}))
    jout = _gen(JRM(), lambda rm: rm.generate_incr_decoding(jm))
    tout = _gen(RequestManager(), lambda rm: rm.generate_incr_decoding(pm))
    want = _gen(RequestManager(),
                lambda rm: rm.generate_incr_decoding(greedy))
    assert tout == jout == want


def test_sampling_op_draws_from_the_context_generator():
    """The Sampling op advances ``OpContext.generator``; without one it
    draws as the JAX package does without a key (one fixed stream)."""
    x = torch.as_tensor(_logits(5))
    attrs = dict(top_p=0.95, temperature=1.0)
    g = torch.Generator().manual_seed(3)
    first = [tsamp.Sampling.forward(attrs, {}, [x], OpContext(generator=g))[0]
             for _ in range(8)]
    assert len({tuple(t.tolist()) for t in first}) > 1
    g.manual_seed(3)
    again = [tsamp.Sampling.forward(attrs, {}, [x], OpContext(generator=g))[0]
             for _ in range(8)]
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    none = [tsamp.Sampling.forward(attrs, {}, [x], OpContext())[0]
            for _ in range(2)]
    assert torch.equal(none[0], none[1]) and none[0].dtype == torch.int32


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


def test_llm_generate_samples():
    """LLM.generate with GenerationConfig(do_sample=True) reaches the
    sampled graph and returns full-length, in-vocabulary tokens."""
    cfg, sd = _hf_pair()
    llm = fft.LLM((cfg, sd)).compile(
        generation_config=fft.GenerationConfig(do_sample=True),
        max_requests_per_batch=2, max_seq_length=64, max_tokens_per_batch=16,
        kv_cache_dtype="float32", device="cpu")
    assert llm.ffmodel.layers[-1].op_type == OpType.SAMPLING
    res = llm.generate([[5, 9, 23, 44], [7, 3, 11], [100, 2]],
                       max_new_tokens=10)
    assert all(len(r.output_tokens) == 10 for r in res)
    assert all(0 <= t < TINY["vocab_size"] for r in res
               for t in r.output_tokens)


def test_spec_infer_with_do_sample_stays_greedy_like_jax():
    """generate_spec_infer ignores do_sample (its verifier ends in
    argmax), in both packages: the greedy spec tokens."""
    serve = dict(SERVE, seed=0)
    models = {}
    for mode, layers in ((InferenceMode.TREE_VERIFY_MODE, 2),
                         (InferenceMode.BEAM_SEARCH_MODE, 1)):
        tiny = dict(TINY, num_hidden_layers=layers)
        jm = ff.FFModel(ff.FFConfig(use_native_scheduler=False, **serve))
        jax_create_llama(jm, JLlamaConfig(**tiny), mode=JMode(mode.value))
        jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
        pm = fft.FFModel(fft.FFConfig(device="cpu", **serve))
        create_llama_model(pm, LLAMAConfig(**tiny), mode=mode)
        pm.compile()
        load_params(pm, params_from_jax(
            {layer: {w: np.asarray(a) for w, a in lp.items()}
             for layer, lp in jm.params.items()}))
        models[mode] = (jm, pm)
    (jllm, tllm), (jssm, tssm) = models.values()
    sample = dict(do_sample=True, adaptive_spec=False)
    jout = _gen(JRM(), lambda rm: rm.generate_spec_infer(
        jllm, [jssm], spec_depth=3,
        generation_config=jbc.GenerationConfig(**sample)))
    tout = _gen(RequestManager(), lambda rm: rm.generate_spec_infer(
        tllm, [tssm], spec_depth=3,
        generation_config=tbc.GenerationConfig(**sample)))
    greedy = _gen(RequestManager(), lambda rm: rm.generate_spec_infer(
        tllm, [tssm], spec_depth=3,
        generation_config=tbc.GenerationConfig(adaptive_spec=False)))
    assert tout == jout == greedy
    assert tout == _gen(RequestManager(),
                        lambda rm: rm.generate_incr_decoding(tllm))
