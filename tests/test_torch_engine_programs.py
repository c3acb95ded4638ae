"""The engines' compiled programs (``serve/graphs.py``) against the JAX
engines' jit accounting, on the CPU.

On the CPU a program is its stages called directly; what the card
captures as CUDA graphs is the same functions, so these tests pin what
both share:

* (a) the JAX ``test_adaptive_mixed_batch_compiles_once_per_engine``
  through both packages on the tiny spec pair's weights: the same
  tokens, one build of the chain and of the tree engine in each, equal
  compile counters, and a second mixed batch that builds nothing;
* (b) a second build (the same engine over models of another R) counts
  one retrace and one ``retrace`` flight record in both packages;
* (c) every program body (the decode step at widths 1 and 8, greedy and
  sampled, the chain, tree at B = 1 and 2 and beam engines' stages, and
  an offloaded verifier's prefill steps, decode block and chain stages)
  makes no host read: ``nonzero``, ``item`` and ``_local_scalar_dense``
  raise under a dispatch mode, but in the kernels' plain versions,
  which never run on the card;
* (d) the sync-free ``commit_tree_kv`` bit for bit against the JAX
  package's in fp32;
* (e) offloading weights after a build drops the programs: the next
  block builds again, with the same tokens;
* (f) the launch tally: a launch during a build leaves ``kernels.counts``
  as it was, and each run of the program adds it once.
"""

import contextlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import flexflow_tpu as ff
from flexflow_tpu.ffconst import InferenceMode as JMode
from flexflow_tpu.models.llama import LLAMAConfig as JLlamaConfig
from flexflow_tpu.models.llama import create_llama_model as jax_create_llama
from flexflow_tpu.ops.inc_attention import commit_tree_kv as jax_commit
from flexflow_tpu.serve.batch_config import GenerationConfig as JGenCfg
from flexflow_tpu.serve.engine import SpecChainEngine as JSpecChainEngine
from flexflow_tpu.serve.request_manager import RequestManager as JRM
from flexflow_tpu.telemetry import ServingTelemetry as JTel
import flexflow_tpu_torch as fft
from flexflow_tpu_torch import kernels
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.ffconst import InferenceMode
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.ops.inc_attention import commit_tree_kv
from flexflow_tpu_torch.serve import graphs
from flexflow_tpu_torch.serve.batch_config import GenerationConfig
from flexflow_tpu_torch.serve.engine import (BeamSpecEngine, MultiSpecEngine,
                                             SpecChainEngine,
                                             make_decode_block)
from flexflow_tpu_torch.serve.request_manager import RequestManager
from flexflow_tpu_torch.telemetry import ServingTelemetry

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
SERVE = dict(max_requests_per_batch=2, max_sequence_length=64,
             max_tokens_per_batch=16, seed=0, kv_cache_dtype="float32")
PROMPTS = [[5, 9, 23, 44], [7, 3, 11], [2, 4], [9, 1, 6, 12, 3]]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port_model(mode, weights=None, layers=2, beam_width=1, gc=None, **kw):
    """A tiny port LLaMA on the CPU, with ``weights`` (a JAX model's
    params) carried across when given."""
    pm = fft.FFModel(fft.FFConfig(device="cpu", **dict(SERVE, **kw),
                                  max_beam_width=beam_width))
    create_llama_model(pm, LLAMAConfig(**dict(TINY, num_hidden_layers=layers)),
                       mode=mode, generation_config=gc)
    pm.compile()
    if weights is not None:
        load_params(pm, params_from_jax(
            {layer: {w: np.asarray(a) for w, a in lp.items()}
             for layer, lp in weights.items()}))
    return pm


def _jax_model(mode, **kw):
    jm = ff.FFModel(ff.FFConfig(**dict(SERVE, **kw)))
    jax_create_llama(jm, JLlamaConfig(**TINY), mode=mode)
    jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
    return jm


@pytest.fixture(scope="module")
def port_pair(tiny_spec_pair):
    """The port's verify/draft pair on the tiny spec pair's weights."""
    jllm, jssm = tiny_spec_pair
    return (_port_model(InferenceMode.TREE_VERIFY_MODE, jllm.params),
            _port_model(InferenceMode.BEAM_SEARCH_MODE, jssm.params))


# ----------------------------------------------------------------------
# (a) an adaptive mixed batch builds each engine once, in both packages
# ----------------------------------------------------------------------
def _mixed_batches(rm_cls, gc_cls, tel, llm, ssm):
    """The JAX test's three batches: chain engine, tree engine, chain
    engine again. Returns (tokens of each batch, chain builds, tree
    builds, cache misses after the second batch)."""
    def gc():
        # margin 0: the cost model would park this same-size draft pair
        # on incremental decoding, which never runs the spec block
        return gc_cls(adaptive_spec=True, spec_fallback_margin=0.0,
                      spec_recover_margin=0.1)

    def run(prompts, budgets, fn):
        rm = rm_cls(telemetry=tel)
        for p, n in zip(prompts, budgets):
            rm.register_new_request(p, max_new_tokens=n)
        return [r.output_tokens for r in fn(rm)]

    out = [run(PROMPTS, [6 + 2 * i for i in range(4)],
               lambda rm: rm.generate_spec_infer(llm, [ssm], spec_depth=3,
                                                 generation_config=gc()))]
    chain_builds = [llm._chain_engine._trace_count]
    out.append(run(PROMPTS[:2], [6, 6],
                   lambda rm: rm._generate_spec_tree_fused(
                       llm, [ssm], spec_depth=3, generation_config=gc())))
    misses = tel.registry.get("ffsv_jit_cache_misses_total").value
    out.append(run(PROMPTS[:3], [5, 5, 5],
                   lambda rm: rm.generate_spec_infer(llm, [ssm], spec_depth=3,
                                                     generation_config=gc())))
    chain_builds.append(llm._chain_engine._trace_count)
    return out, chain_builds, llm._multi_engine._trace_count, misses


def test_adaptive_mixed_batch_builds_once_per_engine(tiny_spec_pair,
                                                     port_pair):
    jllm, jssm = tiny_spec_pair
    pllm, pssm = port_pair
    for m in (jllm, pllm):      # engines built afresh in both packages
        m._chain_engine = m._multi_engine = None
    jtel, ttel = JTel(), ServingTelemetry()
    jout, jchain, jmulti, jmiss = _mixed_batches(JRM, JGenCfg, jtel, jllm,
                                                 jssm)
    tout, tchain, tmulti, tmiss = _mixed_batches(RequestManager,
                                                 GenerationConfig, ttel,
                                                 pllm, pssm)
    assert tout == jout
    assert tchain == jchain == [1, 1] and tmulti == jmulti == 1
    names = ("ffsv_jit_cache_misses_total", "ffsv_engine_retraces_total")
    counters = [[t.registry.get(n).value for n in names]
                for t in (ttel, jtel)]
    assert counters[0] == counters[1] == [2, 0]
    # the third batch reported no new build
    assert tmiss == jmiss == 2


# ----------------------------------------------------------------------
# (b) a build at another R is a retrace in both packages
# ----------------------------------------------------------------------
def test_second_build_counts_one_retrace(tiny_spec_pair, port_pair):
    jllm, jssm = tiny_spec_pair
    pllm, pssm = port_pair
    # the same weights at R = 3
    jm3 = [_jax_model(m, max_requests_per_batch=3)
           for m in (JMode.TREE_VERIFY_MODE, JMode.BEAM_SEARCH_MODE)]
    pm3 = [_port_model(m, j.params, max_requests_per_batch=3)
           for m, j in zip((InferenceMode.TREE_VERIFY_MODE,
                            InferenceMode.BEAM_SEARCH_MODE), jm3)]
    results = []
    for cls, tel, (llm, ssm), (llm3, ssm3) in (
            (JSpecChainEngine, JTel(), (jllm, jssm), jm3),
            (SpecChainEngine, ServingTelemetry(), (pllm, pssm), pm3)):
        eng = cls(llm, ssm, depth=1, max_rounds=1)
        eng.telemetry = tel
        for R in (2, 3):
            eng.run_block(np.arange(1, R + 1, dtype=np.int32),
                          np.full(R, 4, np.int32), np.ones(R, bool), 1)
            eng.llm, eng.ssm = llm3, ssm3
        retraces = [e for e in tel.flight.events() if e["kind"] == "retrace"]
        results.append((eng._trace_count,
                        tel.registry.get("ffsv_jit_cache_misses_total").value,
                        tel.registry.get("ffsv_engine_retraces_total").value,
                        [(e["engine"], e["traces"]) for e in retraces]))
    assert results[0] == results[1] == (2, 2, 1, [("SpecChainEngine", 2)])


# ----------------------------------------------------------------------
# (c) no program body reads the host
# ----------------------------------------------------------------------
_HOST_READS = {torch.ops.aten.nonzero, torch.ops.aten._local_scalar_dense,
               torch.ops.aten.item}
# the kernels' plain versions: the CPU's stand-ins, never run on the card
_PLAIN = {"append_at", "reference_attend", "split_attend",
          "partials_reference", "qmatmul_plain"}


class _NoHostRead(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in _HOST_READS:
            f = sys._getframe(1)
            while f is not None and f.f_code.co_name not in _PLAIN:
                f = f.f_back
            if f is None:
                raise AssertionError(f"{func} in a program body")
        return func(*args, **(kwargs or {}))


@pytest.fixture
def no_host_read(monkeypatch):
    """Every stage a ProgramSet runs runs under ``_NoHostRead``; the
    host's own reads between stages (the round depth, the readback) are
    outside it. Yields the names of the stages run."""
    ran = []
    run = graphs.ProgramSet.run

    def checked(self, name):
        ran.append(name)
        with _NoHostRead():
            run(self, name)

    monkeypatch.setattr(graphs.ProgramSet, "run", checked)
    return ran


def _block_args(R=2):
    return (np.array([5, 7], np.int32)[:R], np.array([3, 2], np.int32)[:R],
            np.ones(R, bool), 3, np.array([9, 4], np.int32)[:R])


@pytest.mark.parametrize("width, sampled", [(1, False), (8, False),
                                            (1, True)])
def test_decode_step_program_reads_no_host(no_host_read, width, sampled):
    gc = GenerationConfig(do_sample=True, topp=0.9) if sampled else None
    m = _port_model(InferenceMode.INC_DECODING_MODE, gc=gc)
    gen = torch.Generator().manual_seed(0)
    blk = make_decode_block(m, torch.float32, 4, width=width)
    toks, _, last = blk(m.params, m.op_state, torch.tensor([5, 7]),
                        torch.tensor([3, 2]), torch.tensor([True, True]), 3,
                        gen)
    assert no_host_read == ["step"] * 3
    assert toks.shape == (2, 4) and (toks[:, 3] == 0).all()
    assert torch.equal(toks[:, 2], last)


@pytest.mark.parametrize("engine", ["chain", "tree B=1", "tree B=2", "beam"])
def test_spec_program_bodies_read_no_host(no_host_read, port_pair, engine):
    pllm, pssm = port_pair
    if engine == "chain":
        eng = SpecChainEngine(pllm, pssm, depth=3, max_rounds=3)
    elif engine == "beam":
        draft = _port_model(InferenceMode.BEAM_SEARCH_MODE, layers=1,
                            beam_width=2)
        eng = BeamSpecEngine(pllm, draft, depth=3, width=2, max_rounds=3)
    else:
        drafts = [pssm] + ([_port_model(InferenceMode.BEAM_SEARCH_MODE,
                                        layers=1)]
                           if engine == "tree B=2" else [])
        eng = MultiSpecEngine(pllm, drafts, depth=3, max_rounds=3)
    _toks, n_acc, _d = eng.run_block(*_block_args(),
                                     depth=np.array([3, 2], np.int32))
    assert eng._trace_count == 1 and eng.rounds_run > 0
    assert (n_acc[:, 0] >= 0).all()
    stages = set(eng._stages())
    assert "verify" in no_host_read and set(no_host_read) <= stages


@pytest.mark.parametrize("path", ["incremental", "spec chain"])
def test_offloaded_program_bodies_read_no_host(no_host_read, tiny_spec_pair,
                                               port_pair, path):
    """An offloaded verifier's programs (its prefill steps, the decode
    block or the chain engine's stages) read no host and give the tokens
    of the same verifier without offload."""
    ssm = port_pair[1]

    def run(llm):
        rm = RequestManager()
        for p in PROMPTS[:2]:
            rm.register_new_request(p, max_new_tokens=6)
        if path == "incremental":
            res = rm.generate_incr_decoding(llm)
        else:
            res = rm.generate_spec_infer(llm, [ssm], spec_depth=2,
                                         generation_config=GenerationConfig(
                                             adaptive_spec=False))
        return [r.output_tokens for r in res]

    ref = run(_port_model(InferenceMode.TREE_VERIFY_MODE,
                          tiny_spec_pair[0].params))
    llm = _port_model(InferenceMode.TREE_VERIFY_MODE, tiny_spec_pair[0].params)
    assert llm.offload_weights(min_bytes=1024) > 0
    del no_host_read[:]
    assert run(llm) == ref
    assert "step" in no_host_read
    if path == "spec chain":
        assert "verify" in no_host_read and "draft" in no_host_read


# ----------------------------------------------------------------------
# (d) commit_tree_kv, sync-free, against the JAX package's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("stacked", [True, False])
def test_commit_tree_kv_matches_jax(stacked):
    rng = np.random.RandomState(7)
    L, R, KH, S, D, C = 2, 5, 2, 16, 4, 4
    k = rng.randn(L, R, KH, S, D).astype(np.float32)
    v = rng.randn(L, R, KH, S, D).astype(np.float32)
    # rows: a full commit; none; an inactive row; destinations past the
    # end (start S-2: columns 2-3 dropped); start S-3 with all four
    # committed, whose dropped column clamps onto column 2's valid slot
    src = np.array([[1, 2, 3, 4], [2, 3, 4, 5], [1, 2, 3, 4],
                    [0, 1, 2, 3], [3, 2, 1, 0]], np.int32)
    num = np.array([4, 0, 3, 4, 4], np.int32)
    start = np.array([3, 5, 2, S - 2, S - 3], np.int32)
    active = np.array([True, True, False, True, True])

    def state(pkg_k, pkg_v):
        if stacked:
            return {"kv_cache": {"k": pkg_k, "v": pkg_v}}
        return {f"layer{i}": {"k_cache": pkg_k[i], "v_cache": pkg_v[i]}
                for i in range(L)}

    jst = jax_commit(state(jnp.asarray(k), jnp.asarray(v)), jnp.asarray(src),
                     jnp.asarray(num), jnp.asarray(start),
                     jnp.asarray(active))
    tk, tv = torch.from_numpy(k.copy()), torch.from_numpy(v.copy())
    with _NoHostRead():
        tst = commit_tree_kv(state(tk, tv), torch.from_numpy(src),
                             torch.from_numpy(num), torch.from_numpy(start),
                             torch.from_numpy(active))
    for name in jst:
        for j, t in zip(jst[name].values(), tst[name].values()):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the move happened: row 0's committed slots hold its sources
    np.testing.assert_array_equal(tk[:, 0, :, 3:7].numpy(), k[:, 0, :, 4:8])
    np.testing.assert_array_equal(tk[:, 2].numpy(), k[:, 2])


# ----------------------------------------------------------------------
# (e) offloading after a build rebuilds
# ----------------------------------------------------------------------
def test_offload_after_build_rebuilds(tiny_spec_pair, port_pair):
    # a verifier of its own (its weights are paged); the pair's draft
    llm = _port_model(InferenceMode.TREE_VERIFY_MODE, tiny_spec_pair[0].params)
    ssm = port_pair[1]

    def run(fn):
        rm = RequestManager()
        for p in PROMPTS[:2]:
            rm.register_new_request(p, max_new_tokens=6)
        return [r.output_tokens for r in fn(rm)]

    def spec(rm):
        return rm.generate_spec_infer(llm, [ssm], spec_depth=2,
                                      generation_config=GenerationConfig(
                                          adaptive_spec=False))

    def incr(rm):
        return rm.generate_incr_decoding(llm)

    before = [run(spec), run(incr)]
    chain, block = llm._chain_engine, llm._inference_manager._decode_block
    assert (chain._trace_count, block.program._trace_count) == (1, 1)
    assert llm.offload_weights(min_bytes=1024) > 0
    assert [run(spec), run(incr)] == before
    assert (chain._trace_count, block.program._trace_count) == (2, 2)


# ----------------------------------------------------------------------
# (f) the launch tally of a build and of each run
# ----------------------------------------------------------------------
class _FakeGraph:
    """Stands in for torch.cuda.CUDAGraph on the CPU: a capture runs the
    stage's Python (as a real capture does, launching nothing), a replay
    runs nothing."""

    def register_generator_state(self, gen):
        pass

    def replay(self):
        pass

    def reset(self):
        pass


class _FakeStream:
    def wait_stream(self, other):
        pass


def test_build_tallies_launches_and_runs_add_them(monkeypatch):
    for name, value in (
            ("CUDAGraph", _FakeGraph), ("Stream", lambda dev: _FakeStream()),
            ("current_stream", lambda dev: _FakeStream()),
            ("stream", lambda s: contextlib.nullcontext()),
            ("graph", lambda g, **kw: contextlib.nullcontext()),
            ("synchronize", lambda dev=None: None),
            ("graph_pool_handle", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)
    calls = []

    def stage(st, gen):
        # a stub launch: what a kernel wrapper does where it launches
        kernels.bump("flash_attend_append")
        kernels.note_shape("flash_attend_append", ("stub",))
        calls.append(int(st["active"].sum()))
        st["i"] += 1

    kernels.reset_counts()
    st = {"active": torch.ones(2, dtype=torch.bool),
          "i": torch.zeros(1, dtype=torch.long)}
    progs = graphs.ProgramSet({"step": stage}, st, capture=True)
    # the warm-up (every row inactive, on a scratch state) and the capture
    # ran the stage; neither moved the counts
    assert calls == [0, 2] and int(st["i"]) == 1
    assert kernels.counts["flash_attend_append"] == 0
    with kernels.record_shapes() as shapes:
        for n in (1, 2, 3):
            progs.run("step")
            assert kernels.counts["flash_attend_append"] == n
    assert shapes == {"flash_attend_append": {("stub",)}}
    assert calls == [0, 2]                  # a replay runs no Python
    assert sum(kernels.counts.values()) == 3
    kernels.reset_counts()
