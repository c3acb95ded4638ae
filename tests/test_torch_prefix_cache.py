"""The port's shared-prefix KV pool against the JAX package's, on the CPU.

* the radix trie, refcounts and token-budget LRU: one operation sequence on
  a fake clock gives the same matches, refcounts, evictions and counters;
* KV segments: extract and install in both of the port's cache layouts
  (per-layer ``[R, KH, S, Dc]`` and the stacked ``[L, R, KH, S, Dc]``) at
  a prefix length that is not a multiple of the 8-position pad, equal to
  the JAX package's segments, installed in place; a segment never
  crosses layouts, head dims or dtypes;
* token identity with the pool cold and warm on the incremental, chain and
  fused tree loops: the tokens and ``prefix_hit_tokens`` of the JAX
  package's incremental loop with its pool (speculation is greedy, so its
  tokens are the verifier's incremental tokens);
* a preemption whose victim re-installs its pooled prefix, and eviction
  under a pool budget too small for every prompt.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.ffconst import InferenceMode as JMode
from flexflow_tpu.models.llama import LLAMAConfig as JLlamaConfig
from flexflow_tpu.models.llama import create_llama_model as jax_create_llama
from flexflow_tpu.serve import prefix_cache as jpc
from flexflow_tpu.serve.batch_config import GenerationConfig as JGC
from flexflow_tpu.serve.request_manager import RequestManager as JRM
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.ffconst import InferenceMode
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.serve import prefix_cache as tpc
from flexflow_tpu_torch.serve.batch_config import GenerationConfig
from flexflow_tpu_torch.serve.loadgen import EngineHandle
from flexflow_tpu_torch.serve.request_manager import RequestManager

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
SERVE = dict(max_requests_per_batch=2, max_sequence_length=64,
             max_tokens_per_batch=16, seed=0, kv_cache_dtype="float32")
# a 12-token system prompt three prompts share: 12 and 14 are not
# multiples of the 8-position pad, so installs leave stale pad positions
SHARED = [3, 14, 15, 9, 2, 6, 5, 35, 8, 97, 93, 23]
P0 = SHARED + [7, 8]           # warms the pool (the full 14-token prompt)
PA = SHARED + [9, 10]          # diverges at depth 12: radix partial match
PB = P0 + [40, 41]             # extends P0's stored prompt: full match
NEW = 24
WAIT = 60.0


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny models need no more: the suite runs in parallel workers on
    shared cores, beside wall-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


# ----------------------------------------------------------------------
# 1. the trie, refcounts and LRU
# ----------------------------------------------------------------------
def _trie_log(pcm):
    clk = FakeClock()
    pc = pcm.PrefixCache(max_tokens=12, clock=clk)
    seg = {"llm": "segment"}
    log, held = [], {}

    def snap(tag, x=None):
        log.append((tag, x, pc.hits, pc.misses, pc.evictions,
                    pc.shared_tokens_total, pc.pool_tokens, len(pc),
                    sorted((e.tokens, e.refs, e.last_used)
                           for e in pc._entries)))

    for op in (("insert", [1, 2, 3, 4]), ("match", [1, 2, 3, 4, 9]),
               ("match", [1, 2, 3, 4]), ("match", [1, 2, 99, 100]),
               ("match", [1, 99, 98]), ("match", [7]), ("tick", 1.0),
               ("insert", [5, 6, 7, 8]), ("insert", [1, 2, 3, 4]),
               ("would", [5, 6, 7, 8]), ("would", [5, 6, 7]),
               ("would", [9]), ("tick", 1.0), ("insert", [9, 10, 11, 12]),
               ("release", [1, 2, 3, 4, 9]), ("release", [1, 2, 3, 4]),
               ("release", [1, 2, 99, 100]), ("tick", 1.0),
               ("match", [5, 6, 7, 8, 1]), ("match", [9, 10, 11, 5]),
               ("insert", [20, 21, 22, 23, 24, 25]),
               ("tick", 1.0), ("insert", [30, 31, 32, 33]),
               ("release", [5, 6, 7, 8, 1]), ("release", [9, 10, 11, 5]),
               ("tick", 1.0), ("insert", [40, 41, 42, 43, 44]),
               ("insert", list(range(50, 64)))):
        kind, arg = op
        if kind == "insert":
            entry, n_ev = pc.insert(arg, seg)
            snap(kind, (entry.tokens if entry else None, n_ev))
        elif kind == "match":
            shared, entry = pc.match(arg)
            held[tuple(arg)] = entry
            snap(kind, (shared, entry.tokens if entry else None))
        elif kind == "release":
            if held.get(tuple(arg)) is not None:
                pc.release(held[tuple(arg)])
            snap(kind)
        elif kind == "would":
            snap(kind, pc.would_store(arg))
        else:
            clk.t += arg
    return log


def test_trie_refcount_lru_sequence_matches_jax():
    tlog, jlog = _trie_log(tpc), _trie_log(jpc)
    assert tlog == jlog
    # the sequence evicted, ran over budget under live references, and
    # refused an over-budget prompt
    assert tlog[-1][4] >= 2
    assert any(entry[6] > 12 for entry in tlog)
    assert tlog[-1][1] == (None, 0)


# ----------------------------------------------------------------------
# 2. KV segments in both layouts
# ----------------------------------------------------------------------
def _states(R=2, KH=2, S=24, D=16, L=3, seed=0):
    rng = np.random.default_rng(seed)
    arrs = {"attn0": {"k_cache": rng.normal(size=(R, KH, S, D)),
                      "v_cache": rng.normal(size=(R, KH, S, D))},
            "kv_cache": {"k": rng.normal(size=(L, R, KH, S, D)),
                         "v": rng.normal(size=(L, R, KH, S, D))}}
    arrs = {n: {k: a.astype(np.float32) for k, a in st.items()}
            for n, st in arrs.items()}
    port = {n: {k: torch.tensor(a) for k, a in st.items()}
            for n, st in arrs.items()}
    port["other"] = 3                                # not a KV cache
    jax = {n: {k: jnp.asarray(a) for k, a in st.items()}
           for n, st in arrs.items()}
    return port, jax


@pytest.mark.parametrize("length", [5, 13])
def test_segment_roundtrip_both_layouts_matches_jax(length):
    src, jsrc = _states()
    segs = tpc.extract_prefix_kv(src, slot=0, length=length)
    jsegs = jpc.extract_prefix_kv(jsrc, slot=0, length=length)
    P = -(-length // 8) * 8
    assert set(segs) == set(jsegs) == {"attn0", "kv_cache"}
    for name in segs:
        for k in ("k", "v"):
            assert segs[name][k].shape[-2] == P
            np.testing.assert_array_equal(segs[name][k].numpy(),
                                          np.asarray(jsegs[name][k]))
    # the segments are copies: a later write to the slot leaves them
    src["kv_cache"]["k"][:, 0] += 1.0
    np.testing.assert_array_equal(segs["kv_cache"]["k"].numpy(),
                                  np.asarray(jsegs["kv_cache"]["k"]))
    dst, jdst = _states(seed=1)
    keep = {n: {k: (t, t.data_ptr()) for k, t in st.items()}
            for n, st in dst.items() if isinstance(st, dict)}
    assert tpc.prefix_compatible(dst, segs, length)
    assert jpc.prefix_compatible(jdst, jsegs, length)
    out = tpc.install_prefix_kv(dst, 1, segs, length)
    jout = jpc.install_prefix_kv(jdst, 1, jsegs, length)
    for name, st in keep.items():
        for k, (t, ptr) in st.items():
            # in place: the same tensor objects at the same addresses
            assert out[name][k] is t and t.data_ptr() == ptr
            np.testing.assert_array_equal(t.numpy(), np.asarray(
                jout[name][k]))


def test_segments_never_cross_layouts_dims_or_dtypes():
    src, _ = _states()
    segs = tpc.extract_prefix_kv(src, slot=0, length=13)
    per_layer = {"attn0": segs["attn0"]}
    stacked = {"kv_cache": segs["kv_cache"]}
    only_stacked, _ = _states()
    del only_stacked["attn0"]
    assert tpc.prefix_compatible(only_stacked, stacked, 13)
    # a per-layer segment does not go into a stacked cache
    assert not tpc.prefix_compatible(only_stacked,
                                     {"kv_cache": per_layer["attn0"]}, 13)
    # the card's padded cache head dim against the CPU's exact one
    padded, _ = _states(D=64)
    del padded["attn0"]
    assert not tpc.prefix_compatible(padded, stacked, 13)
    half = {"kv_cache": {k: t.half() for k, t in stacked["kv_cache"].items()}}
    assert not tpc.prefix_compatible(only_stacked, half, 13)
    assert not tpc.prefix_compatible(only_stacked, stacked, 24)  # 16 held
    assert tpc.extract_prefix_kv(only_stacked, 0, 25) is None
    assert tpc.segment_nbytes(stacked) == 2 * 3 * 2 * 16 * 16 * 4


# ----------------------------------------------------------------------
# 3. token identity, cold and warm, on the tiny LLaMA
# ----------------------------------------------------------------------
def _port(mode, params=None, seed=0, layers=2):
    m = fft.FFModel(fft.FFConfig(device="cpu", **dict(SERVE, seed=seed)))
    create_llama_model(m, LLAMAConfig(**dict(TINY,
                                             num_hidden_layers=layers)),
                       mode=mode)
    m.compile()
    if params is not None:
        load_params(m, params_from_jax(params))
    return m


@pytest.fixture(scope="module")
def models():
    jm = ff.FFModel(ff.FFConfig(use_native_scheduler=False, **SERVE))
    jax_create_llama(jm, JLlamaConfig(**TINY), mode=JMode.INC_DECODING_MODE)
    jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
    beam = InferenceMode.BEAM_SEARCH_MODE
    return dict(jax=jm,
                incr=_port(InferenceMode.INC_DECODING_MODE, jm.params),
                verifier=_port(InferenceMode.TREE_VERIFY_MODE, jm.params),
                drafts=[_port(beam, seed=7, layers=1), _port(beam, seed=3)])


def _warm_runs(rm, run, gc):
    """P0 alone (pools its prompt), then PA and PB together; returns
    {prompt: (tokens, prefix_hit_tokens)} and the pool."""
    g0 = rm.register_new_request(P0, max_new_tokens=NEW)
    run(rm, gc)
    ga = rm.register_new_request(PA, max_new_tokens=NEW)
    gb = rm.register_new_request(PB, max_new_tokens=NEW)
    run(rm, gc)
    out = {tuple(p): (rm.results[g].output_tokens,
                      rm.results[g].prefix_hit_tokens)
           for p, g in ((P0, g0), (PA, ga), (PB, gb))}
    assert all(rm.results[g].status == "ok" for g in (g0, ga, gb))
    return out, rm.prefix_cache


@pytest.fixture(scope="module")
def jax_warm(models):
    gc = JGC(prefix_cache=True, prefix_cache_tokens=4096)
    out, pc = _warm_runs(JRM(), lambda rm, g: rm.generate_incr_decoding(
        models["jax"], generation_config=g), gc)
    return out, (pc.hits, pc.misses, pc.shared_tokens_total,
                 pc.pool_tokens, len(pc))


PATHS = {
    "incr": lambda m: lambda rm, gc: rm.generate_incr_decoding(
        m["incr"], generation_config=gc),
    "chain": lambda m: lambda rm, gc: rm.generate_spec_infer(
        m["verifier"], m["drafts"][:1], spec_depth=3, generation_config=gc),
    "tree": lambda m: lambda rm, gc: rm.generate_spec_infer(
        m["verifier"], m["drafts"], spec_depth=3, generation_config=gc),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_cold_and_warm_tokens_match_jax(models, jax_warm, path):
    run = PATHS[path](models)
    cold, _ = _warm_runs(RequestManager(), run, None)
    gc = GenerationConfig(prefix_cache=True, prefix_cache_tokens=4096)
    warm, pc = _warm_runs(RequestManager(), run, gc)
    jout, jcounts = jax_warm
    assert warm == jout
    assert {p: t for p, (t, _) in cold.items()} == \
        {p: t for p, (t, _) in jout.items()}
    assert all(hit == 0 for _, hit in cold.values())
    assert warm[tuple(PA)][1] == len(SHARED)
    assert warm[tuple(PB)][1] == len(P0)
    assert (pc.hits, pc.misses, pc.shared_tokens_total, pc.pool_tokens,
            len(pc)) == jcounts
    # every terminal path released its pool reference
    assert all(e.refs == 0 for e in pc._entries)
    # the verifier's segments pooled (a draft's only where its cache
    # covered the whole prompt: the controller may park it)
    keys = set(pc._entries[0].segments)
    assert "llm" in keys and keys <= {"llm", "ssm0", "ssm1"}


class HookedRM(RequestManager):
    """Calls ``hook(rm, active)`` at the top of every loop turn."""

    def __init__(self, hook):
        super().__init__()
        self.hook = hook

    def _reap_expired(self, active, max_seq, done, ctrl=None):
        self.hook(self, active)
        return super()._reap_expired(active, max_seq, done, ctrl)


def test_preemption_reinstalls_the_pooled_prefix(models, jax_warm):
    """A priority-1 arrival preempts one of two running requests that hold
    pooled prefixes; the victim's re-grant installs its prefix again, and
    both give the JAX package's tokens and hit counts."""
    jout, _ = jax_warm
    ready, c_in = threading.Event(), threading.Event()

    def wait_for_c(rm_, active):
        if not ready.is_set() and all(
                r is not None and r.prompt_tokens != P0
                and r.num_generated > 0 for r in active):
            ready.set()
            c_in.wait(WAIT)

    gc = GenerationConfig(prefix_cache=True, prefix_cache_tokens=4096)
    handle = EngineHandle(models["incr"], rm=HookedRM(wait_for_c),
                          generation_config=gc)
    try:
        handle.start_server()
        srv, rm = handle._server, handle.rm
        g0, ev0 = srv.submit([P0], NEW, 0)
        assert ev0.wait(WAIT) and len(rm.prefix_cache) == 1
        gA, evA = srv.submit([PA], NEW, 0)
        gB, evB = srv.submit([PB], NEW, 0)
        assert ready.wait(WAIT)
        gC, evC = srv.submit([[11, 3, 19]], 2, 0, priority=1,
                             timeout_s=WAIT)
        with srv._work:
            rm.inflight[gC[0]].arrival_s -= 2 * WAIT
        c_in.set()
        assert evC.wait(WAIT) and evA.wait(WAIT) and evB.wait(WAIT)
        ra, rb = rm.results[gA[0]], rm.results[gB[0]]
        assert rm.results[gC[0]].status == "ok"
        assert ra.preemptions + rb.preemptions == 1
        assert (ra.output_tokens, ra.prefix_hit_tokens) == jout[tuple(PA)]
        assert (rb.output_tokens, rb.prefix_hit_tokens) == jout[tuple(PB)]
    finally:
        c_in.set()
        handle.stop_server(flush_timeout_s=WAIT)
    assert not rm.pending and not rm.inflight


def test_eviction_under_pressure_matches_jax(models):
    """A 16-token budget cannot hold every finished prompt: entries are
    evicted while live references protect the ones in use, and the
    tokens, hits and eviction counts equal the JAX package's."""
    def run(rm, engine, gc):
        out, pc = _warm_runs(rm, engine, gc)
        return out, (pc.evictions, pc.pool_tokens, len(pc),
                     sorted(e.tokens for e in pc._entries))

    tout, tstate = run(RequestManager(), PATHS["incr"](models),
                       GenerationConfig(prefix_cache=True,
                                        prefix_cache_tokens=16))
    jout, jstate = run(JRM(), lambda rm, g: rm.generate_incr_decoding(
        models["jax"], generation_config=g),
        JGC(prefix_cache=True, prefix_cache_tokens=16))
    assert tout == jout and tstate == jstate
    assert tstate[0] >= 1


def test_byte_budget_holds_under_eviction(models, monkeypatch):
    """The pool's byte budget: eviction keeps the pooled bytes within it
    while the token budget alone would keep every prompt; an entry larger
    than the budget is not pooled. The default budget is a share of the
    device memory free at the first insert, and none on the host (the JAX
    package's token budget alone)."""
    per_pos = 2 * 2 * 2 * 16 * 4          # layers x K,V x kv heads x D x 4 B
    budget = per_pos * 24                  # the 16-position P0 and one 8
    rm = RequestManager()
    rm.prefix_cache = tpc.PrefixCache(max_tokens=4096, max_bytes=budget)
    gc = GenerationConfig(prefix_cache=True)
    seen = []
    for p in (P0, [60, 61, 62], [70, 71, 72, 73], PB):
        g = rm.register_new_request(p, max_new_tokens=4)
        rm.generate_incr_decoding(models["incr"], generation_config=gc)
        assert rm.results[g].status == "ok"
        pc = rm.prefix_cache
        assert pc.pool_bytes() <= budget
        assert pc.pool_bytes() == sum(e.nbytes for e in pc._entries)
        seen.append(sorted(e.tokens for e in pc._entries))
    # 16 + 8 positions fit; each later insert evicts the least recent
    a, b, c = tuple(P0), (60, 61, 62), (70, 71, 72, 73)
    assert seen == [[a], sorted([a, b]), sorted([b, c]),
                    sorted([c, tuple(PB)])]
    assert pc.max_bytes == budget and pc.evictions == 2
    # a prompt whose segment exceeds the budget is not pooled
    small = tpc.PrefixCache(max_bytes=per_pos * 8)
    segs = tpc.extract_prefix_kv(_states()[0], slot=0, length=13)
    assert tpc.segment_nbytes(segs) > per_pos * 8
    assert small.insert(list(range(13)), {"llm": segs}) == (None, 0)
    assert len(small) == 0 and small.pool_bytes() == 0
    # the default: a share of the free device memory, none on the host
    assert tpc.default_byte_budget(torch.device("cpu")) == 0
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (40 << 30, 80 << 30))
    assert tpc.default_byte_budget(torch.device("cuda", 0)) == int(
        (40 << 30) * tpc.DEFAULT_POOL_MEMORY_FRACTION)
    host = tpc.PrefixCache()
    host.insert(list(range(13)), {"llm": segs})
    assert host.max_bytes == 0 and len(host) == 1
