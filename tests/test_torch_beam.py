"""The port's beam drafting, host tree path and shape/reduction ops
against the JAX package, on the CPU.

Tiny LLaMAs (vocab 128, hidden 64, 4/2 heads; 2 request slots, a
64-position fp32 KV cache), built in both packages with the JAX model's
weights carried over through ``params_from_jax``; the JAX side runs its
CPU path (plain attention, no Pallas). Verifier: 2 layers, seed 0.
Beam drafts (``BEAM_SEARCH_MODE`` at ``max_beam_width`` 2, whose graph
ends in the packed [top-2 probs, top-2 ids] head): ``trunc`` is the
verifier's 1-layer truncation (the JAX package seeds each weight by its
name), ``s7`` a 2-layer draft of seed 7. Chain drafts (width 1) of the
same names serve the host path at width 1.

Tolerances: ids, tokens, data movement and the committed KV exact;
probabilities 1e-6; logits and staged KV 2e-5.
"""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.ffconst import InferenceMode as JMode
from flexflow_tpu.models.llama import LLAMAConfig as JLlamaConfig
from flexflow_tpu.models.llama import create_llama_model as jax_create_llama
from flexflow_tpu.ops import reduction_ops as jred
from flexflow_tpu.ops import shape_ops as jshape
from flexflow_tpu.ops.base import OpContext as JOpContext
from flexflow_tpu.ops.inc_attention import commit_tree_kv as jax_commit
from flexflow_tpu.serve import batch_config as jbc
from flexflow_tpu.serve.engine import BeamSpecEngine as JBeamSpecEngine
from flexflow_tpu.serve.inference_manager import \
    InferenceManager as JInferenceManager
from flexflow_tpu.serve.request_manager import Request as JRequest
from flexflow_tpu.serve.request_manager import RequestManager as JRM
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.ffconst import DataType, InferenceMode, OpType
from flexflow_tpu_torch.models.llama import (LLAMAConfig, create_llama_model,
                                             hf_weight_map)
from flexflow_tpu_torch.ops import reduction_ops as tred
from flexflow_tpu_torch.ops import shape_ops as tshape
from flexflow_tpu_torch.ops.base import OpContext
from flexflow_tpu_torch.ops.inc_attention import commit_tree_kv
from flexflow_tpu_torch.serve import batch_config as tbc
from flexflow_tpu_torch.serve.engine import BeamSpecEngine
from flexflow_tpu_torch.serve.inference_manager import InferenceManager
from flexflow_tpu_torch.serve.request_manager import Request, RequestManager

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
R, S = 2, 64
STATIC = dict(adaptive_spec=False)
DRAFTS = {"trunc": (0, 1), "s7": (7, 2)}     # name -> (seed, layers)
PROMPTS = [([5, 9, 23, 44], 12), ([7, 3, 11], 12)]

_models = {}


def _pair(mode, seed=0, layers=2, width=1):
    """(jax model, port model with the same weights), built once each."""
    key = (mode, seed, layers, width)
    if key not in _models:
        tiny = {**TINY, "num_hidden_layers": layers}
        serve = dict(max_requests_per_batch=R, max_sequence_length=S,
                     max_tokens_per_batch=16, seed=seed,
                     kv_cache_dtype="float32", max_beam_width=width)
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


def _verifier():
    return _pair(InferenceMode.TREE_VERIFY_MODE)


def _draft(name, width=2):
    seed, layers = DRAFTS[name]
    return _pair(InferenceMode.BEAM_SEARCH_MODE, seed, layers, width)


def _gen(rm, run, reqs=PROMPTS):
    guids = [rm.register_new_request(p, max_new_tokens=n) for p, n in reqs]
    run(rm)
    return [rm.results[g].output_tokens for g in guids]


_incr = {}


def _incr_tokens():
    """The port's incremental tokens of PROMPTS on the verifier."""
    if "t" not in _incr:
        _incr["t"] = _gen(RequestManager(),
                          lambda rm: rm.generate_incr_decoding(_verifier()[1]))
    return _incr["t"]


# ----------------------------------------------------------------------
# 1. shape and reduction ops
# ----------------------------------------------------------------------
def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# name -> (op class name, attrs, input arrays)
OPS = {
    "concat": ("Concat", dict(axis=1), [_x((2, 3, 4)), _x((2, 5, 4), 1)]),
    "split": ("Split", dict(axis=2, sizes=[1, 3, 2]), [_x((2, 3, 6))]),
    "reshape": ("Reshape", dict(shape=(3, -1)), [_x((2, 3, 4))]),
    "transpose": ("Transpose", dict(perm=(2, 0, 1)), [_x((2, 3, 4))]),
    "reverse": ("Reverse", dict(axis=1), [_x((2, 3, 4))]),
    "flat": ("Flat", {}, [_x((2, 3, 4))]),
    "cast": ("Cast", dict(dtype="DT_INT32"), [_x((2, 3, 4)) * 50]),
    "slice": ("Slice", dict(starts=(None, 1, -3), ends=(None, 2, None),
                            squeeze_dims=(1,)), [_x((2, 3, 4))]),
    "reduce_sum": ("Reduce", dict(op_type="REDUCE_SUM", axes=(0, 2),
                                  keepdims=True), [_x((2, 3, 4))]),
    "reduce_mean": ("Reduce", dict(op_type="REDUCE_MEAN", axes=(-1,)),
                    [_x((2, 3, 4))]),
    "mean": ("Mean", dict(dims=(1,), keepdims=False), [_x((2, 3, 4))]),
    "gather": ("Gather", dict(dim=1),
               [_x((2, 5, 4)),
                np.random.RandomState(3).randint(0, 5, (2, 3, 4))]),
    "top_k": ("TopK", dict(k=3), [np.round(_x((3, 7)), 1)]),
    "arg_top_k": ("ArgTopK", dict(k=3), [np.round(_x((3, 7)), 1)]),
    "arg_top_k probs": ("ArgTopK", dict(k=4, speculative_decoding=True),
                        [_x((2, 3, 9)) * 3]),
}


def _attrs(attrs, enum_mod):
    out = dict(attrs)
    if "op_type" in out:
        out["op_type"] = enum_mod.OpType[out["op_type"]]
    if "dtype" in out:
        out["dtype"] = enum_mod.DataType[out["dtype"]]
    return out


@pytest.mark.parametrize("name", list(OPS))
def test_shape_and_reduction_ops_match_jax(name):
    cls, attrs, xs = OPS[name]
    jmod = jshape if hasattr(jshape, cls) else jred
    tmod = tshape if hasattr(tshape, cls) else tred
    jout = getattr(jmod, cls).forward(_attrs(attrs, ff), {},
                                      [jnp.asarray(x) for x in xs], None)
    tout = getattr(tmod, cls).forward(_attrs(attrs, fft), {},
                                      [torch.as_tensor(x) for x in xs], None)
    specs = getattr(tmod, cls).infer_output_specs(
        _attrs(attrs, fft), [(x.shape, DataType.DT_FLOAT) for x in xs])
    assert len(jout) == len(tout) == len(specs)
    for j, t, (shape, dt) in zip(jout, tout, specs):
        j = np.asarray(j)
        t = t.numpy()
        assert t.shape == j.shape == tuple(shape)
        assert t.dtype == j.dtype, (t.dtype, j.dtype)
        if np.issubdtype(j.dtype, np.integer) or cls in (
                "Concat", "Split", "Reshape", "Transpose", "Reverse", "Flat",
                "Slice", "Gather", "TopK"):
            np.testing.assert_array_equal(t, j)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


# FFModel method -> (args after the input tensor, kwargs)
GRAPH_OPS = {
    "concat": None,
    "split": (([2, 4],), dict(axis=2)),
    "reshape": (((3, 12),), {}),
    "transpose": (((1, 2, 0),), {}),
    "cast": ((None,), {}),
    "top_k": ((2,), {}),
    "arg_top_k": ((2,), dict(speculative_decoding=True)),
    "beam_top_k": ((), dict(max_beam_width=4)),
}


@pytest.mark.parametrize("name", list(GRAPH_OPS))
def test_graph_methods_match_jax(name):
    """Each FFModel method records the JAX package's layer: the same output dims
    and dtypes, and the same values through ``_run_graph``."""
    x = np.round(_x((2, 3, 6), 9), 1)
    outs = []
    for pkg, mk, run in ((ff, lambda: ff.FFModel(ff.FFConfig(
            use_native_scheduler=False)), jnp.asarray),
            (fft, lambda: fft.FFModel(fft.FFConfig(device="cpu")),
             torch.as_tensor)):
        m = mk()
        t = m.create_tensor([2, 3, 6], pkg.DataType.DT_FLOAT)
        if name == "concat":
            out = m.concat([t, t], axis=1)
        else:
            args, kw = GRAPH_OPS[name]
            args = tuple(pkg.DataType.DT_INT32 if a is None else a
                         for a in args)
            out = getattr(m, name)(t, *args, **kw)
        out = out if isinstance(out, list) else [out]
        ctx = (JOpContext(compute_dtype=jnp.float32) if pkg is ff
               else OpContext(compute_dtype=torch.float32))
        values, _ = m._run_graph({}, {t.tensor_id: run(x)}, ctx, {})
        outs.append([(o.dims, o.dtype.name, np.asarray(values[o.tensor_id]))
                     for o in out])
    assert len(outs[0]) == len(outs[1])
    for (jd, jt, jv), (td, tt, tv) in zip(*outs):
        assert (tuple(td), tt) == (tuple(jd), jt) and tv.shape == tuple(td)
        np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=1e-6)


def test_arg_top_k_and_select_ties_go_to_the_lower_index():
    """Equal scores, including candidates clamped to log(1e-20), keep
    their index order in ArgTopK and in the beam engine's top-W select,
    in both packages."""
    x = np.array([[0.5, 2.0, 2.0, -1.0, 2.0, 0.0],
                  [1.0, 1.0, 1.0, 1.0, 1.0, 1.0]], np.float32)
    attrs = dict(k=3, speculative_decoding=True)
    jp, ji = jred.ArgTopK.forward(attrs, {}, [jnp.asarray(x)], None)
    tp, ti = tred.ArgTopK.forward(attrs, {}, [torch.as_tensor(x)], None)
    np.testing.assert_array_equal(ti.numpy(), [[1, 2, 4], [0, 1, 2]])
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6)
    floor = float(np.log(np.float32(1e-20)))
    cand = np.array([[-1.0, -0.5, -0.5, -0.5], [floor] * 4,
                     [floor, -3.0, floor, floor]], np.float32)
    ids = np.arange(12, dtype=np.float32).reshape(3, 4) + 100
    par = np.tile(np.array([1, 1, 2, 2], np.int32), (3, 1))
    eng = types.SimpleNamespace(width=2)
    jc, jt, jpar = JBeamSpecEngine._select(
        eng, jnp.asarray(cand), jnp.asarray(ids), jnp.asarray(par))
    tc, tt, tpar = BeamSpecEngine._select(
        eng, torch.as_tensor(cand), torch.as_tensor(ids),
        torch.as_tensor(par))
    np.testing.assert_array_equal(tt.numpy(), [[101, 102], [104, 105],
                                               [109, 108]])
    for t, j in ((tc, jc), (tt, jt), (tpar, jpar)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# ----------------------------------------------------------------------
# 2. the beam draft's packed head, and the Inc op on a tree
# ----------------------------------------------------------------------
def _prefill_meta(prompts, Q=8):
    toks = np.zeros((R, Q), np.int32)
    num = np.zeros(R, np.int32)
    for r, p in enumerate(prompts):
        toks[r, :len(p) - 1] = p[:-1]
        num[r] = len(p) - 1
    return dict(tokens=toks,
                positions=np.tile(np.arange(Q, dtype=np.int32), (R, 1)),
                start_pos=np.zeros(R, np.int32), num_tokens=num,
                active=np.ones(R, bool))


def test_packed_beam_head_matches_jax():
    """A prefill step of the width-2 beam draft: [R, Q, 4] fp32 = top-2
    probabilities (1e-6) and top-2 ids (exact) in both packages."""
    jm, pm = _draft("s7")
    assert pm.layers[-1].op_type == OpType.CONCAT
    meta = _prefill_meta([[5, 9, 23, 44, 17, 2, 8, 8, 1], [7, 3, 11]])
    jo = np.asarray(JInferenceManager(jm).step(jbc.make_batch_meta(
        R, 8, **meta)))
    to = InferenceManager(pm).step(tbc.make_batch_meta(R, 8, **meta))
    assert to.shape == jo.shape == (R, 8, 4) and to.dtype == np.float32
    real = np.arange(8)[None, :] < meta["num_tokens"][:, None]
    np.testing.assert_array_equal(to[real][:, 2:], jo[real][:, 2:])
    np.testing.assert_allclose(to[real][:, :2], jo[real][:, :2], rtol=1e-6,
                               atol=1e-6)


def test_packed_beam_head_stays_fp32_in_a_bf16_model():
    """Ids above 256 are not exact in bf16: in a bf16 model (vocab 1000)
    the packed head keeps fp32, and its ids are the top-2 of the fp32
    logits."""
    m = fft.FFModel(fft.FFConfig(device="cpu", max_requests_per_batch=R,
                                 max_sequence_length=32,
                                 max_tokens_per_batch=16,
                                 compute_dtype="bfloat16", max_beam_width=2))
    create_llama_model(m, LLAMAConfig(**{**TINY, "vocab_size": 1000,
                                         "num_hidden_layers": 1}),
                       mode=InferenceMode.BEAM_SEARCH_MODE,
                       data_type=DataType.DT_BFLOAT16)
    m.compile()
    meta = tbc.make_batch_meta(R, 8, **_prefill_meta([[5, 900, 700, 3],
                                                      [999, 3]]))
    values, _ = m._run_graph(m.params,
                             {m.input_tensors[0].tensor_id: meta.tokens},
                             OpContext(compute_dtype=torch.bfloat16,
                                       batch_config=meta), m.op_state)
    out = values[m._final_tensor.tensor_id]
    logits = values[next(layer for layer in m.layers
                         if layer.name == "lm_head").outputs[0].tensor_id]
    assert out.dtype == logits.dtype == torch.float32
    want = torch.sort(logits, dim=-1, descending=True, stable=True).indices[
        ..., :2]
    np.testing.assert_array_equal(out[..., 2:].numpy(),
                                  want.numpy().astype(np.float32))
    assert (want > 256).any()


def _logits_tid(model):
    return next(layer for layer in model.layers
                if layer.name == "lm_head").outputs[0].tensor_id


@pytest.mark.parametrize("contiguous", [False, True])
def test_inc_attention_on_a_tree_matches_jax(contiguous):
    """The draft's incremental attention op given a TreeBatchMeta (the
    beam draft staging its frontier) after a prefill: logits of the real
    nodes and the staged KV to 2e-5."""
    jm, pm = _draft("s7")
    assert pm.layers[2].op_type == OpType.SPEC_INC_MULTIHEAD_SELF_ATTENTION
    meta = _prefill_meta([[5, 9, 23, 44, 17, 2, 8], [7, 3, 11, 4]])
    JInferenceManager(jm).step(jbc.make_batch_meta(R, 8, **meta),
                               want_output=False)
    InferenceManager(pm).step(tbc.make_batch_meta(R, 8, **meta),
                              want_output=False)
    start = meta["num_tokens"]
    parent = np.array([[-1, 0, 0, 1, 2, 3, 3, -1],
                       [-1, 0, 0, 2, -1, -1, -1, -1]], np.int32)
    nodes = np.array([7, 4], np.int32)
    depth = np.zeros_like(parent)
    for i in range(1, 8):
        depth[:, i] = np.where(parent[:, i] >= 0,
                               depth[np.arange(R), parent[:, i].clip(0)] + 1,
                               0)
    tree = dict(tokens=np.random.RandomState(5).randint(1, 128, (R, 8))
                .astype(np.int32),
                positions=(start[:, None] + depth).astype(np.int32),
                parent=parent,
                ancestor=jbc.ancestor_mask_from_parents(parent),
                start_pos=start, num_nodes=nodes, active=np.ones(R, bool))
    jctx = JOpContext(compute_dtype=jnp.float32, batch_config=jbc.TreeBatchMeta(
        **{k: jnp.asarray(v) for k, v in tree.items()}), mesh=jm.mesh,
        config=jm.config)
    jctx.kv_contiguous = contiguous
    tmeta = tbc.TreeBatchMeta(**tree).to("cpu")
    jv, jstate = jm._run_graph(
        jm.params, {jm.input_tensors[0].tensor_id: jctx.batch_config.tokens},
        jctx, jm.op_state)
    tv, tstate = pm._run_graph(
        pm.params, {pm.input_tensors[0].tensor_id: tmeta.tokens},
        OpContext(compute_dtype=torch.float32, batch_config=tmeta,
                  kv_contiguous=contiguous), pm.op_state)
    real = np.arange(8)[None, :] < nodes[:, None]
    np.testing.assert_allclose(tv[_logits_tid(pm)].numpy()[real],
                               np.asarray(jv[_logits_tid(jm)])[real],
                               atol=2e-5, rtol=2e-5)
    for name in ("k", "v"):
        jc = np.asarray(jstate["kv_cache"][name])
        tc = tstate["kv_cache"][name].numpy()
        for r in range(R):
            n = start[r] + nodes[r]
            np.testing.assert_allclose(tc[:, r, :, :n], jc[:, r, :, :n],
                                       atol=2e-5, rtol=2e-5)


# ----------------------------------------------------------------------
# 3. commit_tree_kv
# ----------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["per-layer", "stacked"])
def test_commit_tree_kv_matches_jax(layout):
    """Rows: a plain commit; num_commit 0; inactive; a source at the cache
    end; destinations past the end (dropped) with a source past it
    (clipped). Exact."""
    Sx, C = 16, 4
    rng = np.random.RandomState(8)
    shape = (3, 5, 2, Sx, 4) if layout == "stacked" else (5, 2, Sx, 4)
    names = ("k", "v") if layout == "stacked" else ("k_cache", "v_cache")
    key = "kv_cache" if layout == "stacked" else "layers.0.self_attn"
    state = {key: {n: rng.randn(*shape).astype(np.float32) for n in names},
             "other": {"x": np.zeros(3, np.float32)}}
    src = np.array([[0, 2, 3, 5], [1, 2, 3, 4], [0, 1, 2, 3],
                    [1, 2, 3, 3], [0, 1, 5, 6]], np.int32)
    ncommit = np.array([3, 0, 2, 3, 3], np.int32)
    start = np.array([2, 4, 6, 12, 14], np.int32)
    active = np.array([True, True, False, True, True])
    jout = jax_commit({k: {n: jnp.asarray(a) for n, a in st.items()}
                       for k, st in state.items()},
                      jnp.asarray(src), jnp.asarray(ncommit),
                      jnp.asarray(start), jnp.asarray(active))
    tstate = {k: {n: torch.as_tensor(a.copy()) for n, a in st.items()}
              for k, st in state.items()}
    tout = commit_tree_kv(tstate, torch.as_tensor(src),
                          torch.as_tensor(ncommit), torch.as_tensor(start),
                          torch.as_tensor(active))
    assert tout is tstate
    for n in names:
        np.testing.assert_array_equal(tout[key][n].numpy(),
                                      np.asarray(jout[key][n]))
        assert not np.array_equal(tout[key][n].numpy(), state[key][n])


# ----------------------------------------------------------------------
# 4. the beam engine's run_block
# ----------------------------------------------------------------------
_jax_engines = {}


@pytest.mark.parametrize("adaptive", [False, True])
def test_beam_run_block_matches_jax(adaptive):
    """Same packed (tokens, n_acc, depth used) as the JAX BeamSpecEngine
    at width 2, depth 3, and the same committed verifier KV (2e-5);
    row 1's smaller budget ends it early. Adaptive: a depth vector, and
    with it rounds that skip beam levels."""
    jllm, tllm = _verifier()
    jssm, tssm = _draft("trunc")
    prompts = [[5, 9, 23, 44, 17], [7, 3, 11]]
    for jm, pm in ((jllm, tllm), (jssm, tssm)):
        meta = _prefill_meta(prompts)
        JInferenceManager(jm).step(jbc.make_batch_meta(R, 8, **meta),
                                   want_output=False)
        InferenceManager(pm).step(tbc.make_batch_meta(R, 8, **meta),
                                  want_output=False)
    depth, rounds = 3, 6
    if "beam" not in _jax_engines:
        _jax_engines["beam"] = JBeamSpecEngine(jllm, jssm, depth, 2,
                                               max_rounds=rounds)
    jeng = _jax_engines["beam"]
    teng = BeamSpecEngine(tllm, tssm, depth, 2, max_rounds=rounds)
    assert teng.tree_width == jeng.tree_width == 8
    args = (np.array([p[-1] for p in prompts], np.int32),
            np.array([len(p) - 1 for p in prompts], np.int32),
            np.ones(R, bool), rounds, np.array([14, 5], np.int32))
    kw = dict(depth=np.array([1, 3], np.int32), min_depth=1) if adaptive \
        else {}
    ja, jn, jd = jeng.run_block(*args, **kw)
    ta, tn, td = teng.run_block(*args, **kw)
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(td, jd)
    ran = jn >= 0
    assert ran[:, 0].all() and not ran[1].all()
    for r, k in zip(*np.nonzero(ran)):
        n = jn[r, k]
        np.testing.assert_array_equal(ta[r, k, :n + 1], ja[r, k, :n + 1])
    assert teng.rounds_run == int(ran.any(0).sum())
    # each round stages the levels below its deepest live depth bound
    want_levels = sum(max(int(td[r, k]) for r in range(R) if ran[r, k]) - 1
                      for k in range(rounds) if ran[:, k].any())
    assert teng.levels_run == want_levels
    committed = args[1] + (jn + 1).clip(min=0).sum(1)
    for name in ("k", "v"):
        jc = np.asarray(jllm.op_state["kv_cache"][name])
        tc = tllm.op_state["kv_cache"][name].numpy()
        for r in range(R):
            np.testing.assert_allclose(tc[:, r, :, :committed[r]],
                                       jc[:, r, :, :committed[r]],
                                       atol=2e-5, rtol=2e-5)


# ----------------------------------------------------------------------
# 5. beam serving end to end
# ----------------------------------------------------------------------
def test_beam_spec_infer_matches_jax_and_incr():
    """generate_spec_infer(spec_depth=3, beam_width=2) through the fused
    beam engine: the JAX package's tokens and the port's incremental
    tokens."""
    (jllm, tllm), (jssm, tssm) = _verifier(), _draft("trunc")
    gc = dict(STATIC)
    jout = _gen(JRM(), lambda rm: rm.generate_spec_infer(
        jllm, [jssm], spec_depth=3, beam_width=2,
        generation_config=jbc.GenerationConfig(**gc)))
    tout = _gen(RequestManager(), lambda rm: rm.generate_spec_infer(
        tllm, [tssm], spec_depth=3, beam_width=2,
        generation_config=tbc.GenerationConfig(**gc)))
    assert tout == jout == _incr_tokens()
    assert tllm._beam_engine.levels_run > 0


def test_draft_beams_match_jax_and_diverge():
    """_draft_beams on the same draft cache state returns the JAX
    package's beam paths, and the two beams differ for some request."""
    jm, pm = _draft("s7")
    prompts = [[5, 9, 23, 44, 17], [7, 3, 11]]
    meta = _prefill_meta(prompts)
    JInferenceManager(jm).step(jbc.make_batch_meta(R, 8, **meta),
                               want_output=False)
    InferenceManager(pm).step(tbc.make_batch_meta(R, 8, **meta),
                              want_output=False)

    def live(cls):
        return [cls(guid=i, prompt_tokens=p, slot=i,
                    ssm_cache_depth={0: len(p) - 1})
                for i, p in enumerate(prompts)]

    jl, tl = live(JRequest), live(Request)
    jchains = JRM()._draft_beams(JInferenceManager(jm), 0, jl, R, 3, 2)
    tchains = RequestManager()._draft_beams(InferenceManager(pm), 0, tl, R,
                                            3, 2)
    assert tchains == jchains
    assert [r.ssm_cache_depth for r in tl] == [r.ssm_cache_depth for r in jl]
    assert any(tchains[0][s] != tchains[1][s] for s in range(R))
    assert all(len(c[s]) == 3 for c in tchains for s in range(R))


# path name -> (draft names, beam width, run(rm, llm, ssms))
PATHS = {
    "fused beam, one draft": (["trunc"], 2, lambda rm, llm, ssms:
                              rm.generate_spec_infer(
                                  llm, ssms, spec_depth=3, beam_width=2)),
    "host beams, one draft": (["trunc"], 2, lambda rm, llm, ssms:
                              rm._generate_spec_tree_host(
                                  llm, ssms, spec_depth=3, beam_width=2)),
    "host beams, two drafts": (["trunc", "s7"], 2, lambda rm, llm, ssms:
                               rm.generate_spec_infer(llm, ssms,
                                                      spec_depth=3)),
    "host chains, two drafts": (["trunc", "s7"], 1, lambda rm, llm, ssms:
                                rm._generate_spec_tree_host(
                                    llm, ssms, spec_depth=3, beam_width=1)),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_beam_paths_match_jax_and_incr(path):
    """The fused beam engine, the host tree path with beam drafts (one
    and two drafts: merged trees, commit_tree_kv) and with chain drafts
    (_draft_chains): each gives the JAX package's tokens on the same path
    and the port's incremental tokens; the host path's rounds equal its
    verify passes."""
    names, width, run = PATHS[path]
    jllm, tllm = _verifier()
    drafts = [_draft(n, width) for n in names]
    calls = []
    orig = RequestManager._verify_and_commit

    def spy(self, *a):
        calls.append(1)
        return orig(self, *a)

    RequestManager._verify_and_commit = spy
    try:
        rm = RequestManager()
        tout = _gen(rm, lambda rm: run(rm, tllm, [t for _, t in drafts]))
    finally:
        RequestManager._verify_and_commit = orig
    jout = _gen(JRM(), lambda rm: run(rm, jllm, [j for j, _ in drafts]))
    assert tout == jout == _incr_tokens()
    assert all(len(t) == 12 for t in tout)
    assert rm.spec_stats["rounds"] == len(calls)
    if path.startswith("host"):
        assert calls and rm.spec_stats["committed"] >= 24


def test_beam_width_mismatch_raises_value_error():
    (jllm, tllm), (jssm, tssm) = _verifier(), _draft("trunc")
    for rm_cls, llm, ssm in ((JRM, jllm, jssm), (RequestManager, tllm, tssm)):
        rm = rm_cls()
        rm.register_new_request([5, 9], max_new_tokens=4)
        with pytest.raises(ValueError, match="max_beam_width"):
            rm.generate_spec_infer(llm, [ssm], spec_depth=3, beam_width=1)
    with pytest.raises(ValueError, match="max_beam_width"):
        RequestManager().generate_spec_infer(
            tllm, [tssm, _draft("s7", 1)[1]], spec_depth=3)


def test_beam_adaptive_equals_static():
    """The controller on (its depth schedule and parks, scaled by the
    beam width) changes the rounds, never the tokens."""
    (_, tllm), (_, tssm) = _verifier(), _draft("trunc")
    outs, rounds = [], []
    for gc in (tbc.GenerationConfig(**STATIC),
               tbc.GenerationConfig(spec_draft_cost_ratio=0.05)):
        rm = RequestManager()
        outs.append(_gen(rm, lambda rm: rm.generate_spec_infer(
            tllm, [tssm], spec_depth=3, beam_width=2, generation_config=gc),
            [(p, 20) for p, _ in PROMPTS]))
        rounds.append(rm.spec_stats["rounds"])
    assert outs[0] == outs[1]
    assert [t[:12] for t in outs[0]] == _incr_tokens()
    assert all(rounds)


def test_llm_generate_with_beam_draft_matches_jax():
    """LLM(...).compile(ssms=[SSM(...)], max_beam_width=2): the draft is
    built as a width-2 beam draft and LLM.generate drafts beams through
    the beam engine, giving the JAX package's tokens."""
    from flexflow_tpu.serve.api import LLM as JLLM
    from flexflow_tpu.serve.api import SSM as JSSM

    cfg = dict(model_type="llama", **TINY)
    jm, _ = _verifier()
    sd = {}
    for key, (layer, w, tr) in hf_weight_map(LLAMAConfig(**TINY)).items():
        a = np.array(jm.params[layer][w])
        sd[key] = a.T if tr else a
    cfg_d = dict(cfg, num_hidden_layers=1)
    sd_d = {k: v for k, v in sd.items() if ".layers.1." not in k}
    kw = dict(generation_config=None, max_requests_per_batch=R,
              max_seq_length=S, max_tokens_per_batch=16,
              kv_cache_dtype="float32", max_beam_width=2)
    gen = dict(spec_depth=3, adaptive_spec=False)
    jllm = JLLM((cfg, dict(sd))).compile(
        **dict(kw, generation_config=jbc.GenerationConfig(**gen)),
        ssms=[JSSM((cfg_d, dict(sd_d)))], use_native_scheduler=False)
    tllm = fft.LLM((cfg, dict(sd))).compile(
        **dict(kw, generation_config=tbc.GenerationConfig(**gen)),
        ssms=[fft.SSM((cfg_d, dict(sd_d)))], device="cpu")
    assert tllm.ssms[0].ffmodel.layers[-1].op_type == OpType.CONCAT
    prompts = [p for p, _ in PROMPTS] + [[100, 2]]
    jres = jllm.generate(prompts, max_new_tokens=12)
    tres = tllm.generate(prompts, max_new_tokens=12)
    assert [r.output_tokens for r in tres] == [r.output_tokens for r in jres]
    assert [r.output_tokens for r in tres[:2]] == _incr_tokens()
    assert tllm.ffmodel._beam_engine.rounds_run > 0
