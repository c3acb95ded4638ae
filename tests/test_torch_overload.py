"""The port's request lifecycle against the JAX package, on the CPU:
cancellation, deadlines, preemption, the background server's fault
containment and flush, and concurrent submitters.

The tiny LLaMA (vocab 128, hidden 64, 2 layers, 2 request slots, a
64-position fp32 cache) is built in the JAX package; the port's
incremental model and tree verifier take its weights
(``params_from_jax``), so every scheduler path's tokens can be held
against the JAX package's incremental decoding (speculation is greedy:
its tokens are the verifier's incremental tokens). Drafts are the port's
own (any draft gives the verifier's tokens).

Nothing here rests on a sleep: a test that needs the serving loop at a
given point hooks the top of the loop's turn (``_reap_expired``, which
every scheduler path calls first) and synchronises on events, and every
wait is bounded.
"""

import threading
import time

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.ffconst import InferenceMode as JMode
from flexflow_tpu.models.llama import LLAMAConfig as JLlamaConfig
from flexflow_tpu.models.llama import create_llama_model as jax_create_llama
from flexflow_tpu.serve.api import LLM as JLLM
from flexflow_tpu.serve.request_manager import RequestManager as JRM
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.ffconst import InferenceMode
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.serve.loadgen import EngineHandle
from flexflow_tpu_torch.serve.request_manager import RequestManager

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
SERVE = dict(max_requests_per_batch=2, max_sequence_length=64,
             max_tokens_per_batch=16, seed=0, kv_cache_dtype="float32")
PROMPT_A = [5, 9, 23, 7]
PROMPT_B = [11, 3, 19]
WAIT = 60.0      # bound on every wait


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny models need no more: the suite runs in parallel workers on
    shared cores, beside wall-clock tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _port(mode, params=None, seed=0, layers=2, width=1):
    m = fft.FFModel(fft.FFConfig(device="cpu", **dict(
        SERVE, seed=seed, max_beam_width=width)))
    create_llama_model(m, LLAMAConfig(**dict(TINY,
                                             num_hidden_layers=layers)),
                       mode=mode)
    m.compile()
    if params is not None:
        load_params(m, params_from_jax(params))
    return m


@pytest.fixture(scope="module")
def models():
    """JAX incremental model; the port's incremental model, verifier,
    two chain drafts and two beam drafts."""
    jm = ff.FFModel(ff.FFConfig(use_native_scheduler=False, **SERVE))
    jax_create_llama(jm, JLlamaConfig(**TINY), mode=JMode.INC_DECODING_MODE)
    jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
    beam = InferenceMode.BEAM_SEARCH_MODE
    return dict(
        jax=jm,
        incr=_port(InferenceMode.INC_DECODING_MODE, jm.params),
        verifier=_port(InferenceMode.TREE_VERIFY_MODE, jm.params),
        drafts=[_port(beam, seed=7, layers=1), _port(beam, seed=3)],
        beams=[_port(beam, seed=7, layers=1, width=2),
               _port(beam, seed=3, layers=1, width=2)])


def _jax_tokens(models, prompts, n):
    rm = JRM()
    guids = [rm.register_new_request(p, max_new_tokens=n) for p in prompts]
    rm.generate_incr_decoding(models["jax"])
    return [rm.results[g].output_tokens for g in guids]


PATHS = {
    "incr": lambda m, rm: rm.generate_incr_decoding(m["incr"]),
    "chain": lambda m, rm: rm.generate_spec_infer(m["verifier"],
                                                  m["drafts"][:1]),
    "tree": lambda m, rm: rm.generate_spec_infer(m["verifier"],
                                                 m["drafts"]),
    "host_tree": lambda m, rm: rm.generate_spec_infer(m["verifier"],
                                                      m["beams"]),
}


class HookedRM(RequestManager):
    """A RequestManager that calls ``hook(rm, active)`` at the top of
    every scheduler-loop turn, on the loop's thread."""

    def __init__(self, hook=None):
        super().__init__()
        self.hook = hook

    def _reap_expired(self, active, max_seq, done, ctrl=None):
        if self.hook is not None:
            self.hook(self, active)
        return super()._reap_expired(active, max_seq, done, ctrl)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_cancel_before_loop_all_paths(models, path):
    """A request cancelled before its loop resolves as ``cancelled`` with
    no output on every scheduler path; the co-registered request gives
    the JAX package's tokens."""
    rm = RequestManager()
    rm.max_spec_depth = 2
    g_ok = rm.register_new_request(PROMPT_A, max_new_tokens=6)
    g_cx = rm.register_new_request(PROMPT_B, max_new_tokens=6)
    assert rm.cancel(g_cx) is True
    assert rm.cancel(424242) is False          # unknown guid
    PATHS[path](models, rm)
    ok, cx = rm.results[g_ok], rm.results[g_cx]
    assert ok.status == "ok"
    assert ok.output_tokens == _jax_tokens(models, [PROMPT_A], 6)[0]
    assert cx.status == "cancelled" and cx.cancelled and not cx.timed_out
    assert cx.output_tokens == []
    assert rm.cancel(g_cx) is False            # already finished
    assert not rm.pending and not rm.inflight


@pytest.mark.parametrize("path", ["incr", "chain"])
def test_timeout_resolves_with_partial_tokens(models, path):
    """A deadline that has passed at arrival resolves ``timed_out`` with
    no tokens; one that passes mid-generation resolves with the tokens
    generated so far, a prefix of the JAX package's."""
    rm = RequestManager()
    rm.max_spec_depth = 2
    g_ok = rm.register_new_request(PROMPT_A, max_new_tokens=3)
    g_to = rm.register_new_request(PROMPT_B, max_new_tokens=3,
                                   timeout_s=-1.0)   # expired on arrival
    PATHS[path](models, rm)
    res = rm.results[g_to]
    assert res.status == "timed_out" and res.timed_out and not res.cancelled
    assert res.output_tokens == []
    assert rm.results[g_ok].status == "ok"

    def expire_once_started(rm_, active):
        # the clock passes the deadline once the request has tokens
        for req in active:
            if req is not None and req.num_generated > 0:
                req.deadline_s = time.perf_counter() - 1e-3

    hrm = HookedRM(expire_once_started)
    hrm.max_spec_depth = 2
    g_mid = hrm.register_new_request(PROMPT_A, max_new_tokens=48,
                                     timeout_s=3600.0)
    PATHS[path](models, hrm)
    res = hrm.results[g_mid]
    assert res.status == "timed_out"
    assert 0 < len(res.output_tokens) < 48
    want = _jax_tokens(models, [PROMPT_A], 48)[0]
    assert res.output_tokens == want[:len(res.output_tokens)]
    assert not hrm.pending and not hrm.inflight


def test_midstream_cancel_through_the_server(models):
    """``LLM.cancel`` semantics through the background server: a request
    cancelled after its first tokens resolves ``cancelled`` with them."""
    started, go = threading.Event(), threading.Event()

    def pause_once_started(rm_, active):
        if not started.is_set() and any(
                r is not None and r.num_generated > 0 for r in active):
            started.set()
            go.wait(WAIT)

    handle = EngineHandle(models["verifier"], ssms=models["drafts"][:1],
                          rm=HookedRM(pause_once_started), spec_depth=2)
    try:
        handle.start_server()
        guids, ev = handle._server.submit([PROMPT_A], 48, 0)
        assert started.wait(WAIT)
        assert handle.rm.cancel(guids[0]) is True
        go.set()
        assert ev.wait(WAIT)
        res = handle.rm.results[guids[0]]
        assert res.status == "cancelled" and res.cancelled
        assert 0 < len(res.output_tokens) < 48
        want = _jax_tokens(models, [PROMPT_A], 48)[0]
        assert res.output_tokens == want[:len(res.output_tokens)]
    finally:
        go.set()
        handle.stop_server(flush_timeout_s=WAIT)
    assert not handle.rm.pending and not handle.rm.inflight


@pytest.mark.parametrize("path", ["incr", "chain"])
def test_preemption_requeues_with_identical_tokens(models, path):
    """A priority-1 arrival whose deadline is at risk evicts a running
    priority-0 request; the victim is re-queued and re-prefilled, and
    both priority-0 requests give the JAX package's tokens."""
    ref = _jax_tokens(models, [PROMPT_A, PROMPT_B], 24)
    both_running, c_in = threading.Event(), threading.Event()

    def wait_for_c(rm_, active):
        if not both_running.is_set() and all(
                r is not None and r.num_generated > 0 for r in active):
            both_running.set()
            c_in.wait(WAIT)

    ssms = models["drafts"][:1] if path == "chain" else ()
    handle = EngineHandle(models["verifier" if ssms else "incr"], ssms=ssms,
                          rm=HookedRM(wait_for_c), spec_depth=2)
    try:
        handle.start_server()
        srv, rm = handle._server, handle.rm
        gA, evA = srv.submit([PROMPT_A], 24, 0)
        gB, evB = srv.submit([PROMPT_B], 24, 0)
        assert both_running.wait(WAIT)
        # a high-priority arrival with most of its deadline budget burned
        # upstream: its arrival shifted into the past makes the at-risk
        # predicate hold with the whole real deadline left
        gC, evC = srv.submit([PROMPT_B], 2, 0, priority=1, timeout_s=WAIT)
        with srv._work:
            rm.inflight[gC[0]].arrival_s -= 2 * WAIT
        c_in.set()
        assert evC.wait(WAIT) and evA.wait(WAIT) and evB.wait(WAIT)
        resA, resB, resC = (rm.results[g[0]] for g in (gA, gB, gC))
        assert resC.status == "ok" and len(resC.output_tokens) == 2
        assert resA.preemptions + resB.preemptions == 1
        assert [resA.output_tokens, resB.output_tokens] == ref
        assert resA.status == "ok" and resB.status == "ok"
    finally:
        c_in.set()
        handle.stop_server(flush_timeout_s=WAIT)
    assert not rm.pending and not rm.inflight


class InjectedFault(RuntimeError):
    pass


def test_server_fault_fails_every_future_and_restarts(models):
    """A loop error fails the in-flight and the queued requests with
    status ``error``, closes the door, and a restarted server on the same
    manager serves again."""
    armed = {"on": True}

    def fault(rm_, active):
        if armed["on"] and any(r is not None for r in active):
            armed["on"] = False
            raise InjectedFault("injected")

    handle = EngineHandle(models["incr"], rm=HookedRM(fault))
    try:
        handle.start_server()
        srv = handle._server
        # two requests take the slots, the third queues; the fault comes
        # at the first turn that finds requests in flight
        guids, ev = srv.submit([PROMPT_A, PROMPT_B, PROMPT_A], 40, 0)
        assert ev.wait(WAIT)
        srv._thread.join(WAIT)
        assert not srv._thread.is_alive()
        assert isinstance(srv._error, InjectedFault)
        for g in guids:
            res = handle.rm.results[g]
            assert res.status == "error" and "InjectedFault" in res.error
            assert len(res.output_tokens) < 40
        with pytest.raises(RuntimeError):
            srv.submit([PROMPT_A], 4, 0)
    finally:
        handle.stop_server(flush_timeout_s=WAIT)
    assert not handle.rm.pending and not handle.rm.inflight
    try:
        handle.start_server()
        guids, ev = handle._server.submit([PROMPT_A], 4, 0)
        assert ev.wait(WAIT)
        res = handle.rm.results[guids[0]]
        assert res.status == "ok"
        assert res.output_tokens == _jax_tokens(models, [PROMPT_A], 4)[0]
    finally:
        handle.stop_server(flush_timeout_s=WAIT)


def test_stop_server_flush_timeout_resolves_every_waiter(models):
    """``stop_server(flush_timeout_s)`` with work in flight: once the
    flush window closes, the stragglers are cancelled and every waiter
    resolves. The loop is held at a turn until the cancellation comes,
    so the request cannot finish inside the window."""
    cancelled, holding = threading.Event(), threading.Event()

    class CancelSignals(HookedRM):
        def cancel(self, guid):
            out = super().cancel(guid)
            cancelled.set()
            return out

    def hold(rm_, active):
        if any(r is not None and r.num_generated > 0 for r in active):
            holding.set()
            cancelled.wait(WAIT)

    handle = EngineHandle(models["incr"], rm=CancelSignals(hold))
    handle.start_server()
    srv = handle._server
    guids, ev = srv.submit([[7, 3]], 56, 0)
    assert holding.wait(WAIT)
    t0 = time.perf_counter()
    handle.stop_server(flush_timeout_s=0.5)
    assert time.perf_counter() - t0 < WAIT
    assert ev.is_set() and handle._server is None
    assert not srv._thread.is_alive()
    res = handle.rm.results[guids[0]]
    assert res.status == "cancelled" and 0 < len(res.output_tokens) < 56
    assert not handle.rm.pending and not handle.rm.inflight


def test_restart_right_after_a_flush_timeout(models, monkeypatch):
    """A stop whose straggler outlives the wait for its block keeps the
    server attached: ``start_server`` refuses and submissions raise, so no
    second loop ever shares the manager and its in-place caches. Once the
    old thread ends, a restart at once serves the JAX package's tokens."""
    from flexflow_tpu_torch.serve import api

    monkeypatch.setattr(api, "STRAGGLER_JOIN_S", 0.2)
    holding, release = threading.Event(), threading.Event()

    def hold(rm_, active):
        if not release.is_set() and any(
                r is not None and r.num_generated > 0 for r in active):
            holding.set()
            release.wait(WAIT)

    handle = EngineHandle(models["incr"], rm=HookedRM(hold))
    handle.start_server()
    old = handle._server
    try:
        guids, ev = old.submit([[7, 3]], 56, 0)
        assert holding.wait(WAIT)
        handle.stop_server(flush_timeout_s=0.1)
        assert ev.is_set() and old._thread.is_alive()
        assert handle._server is old
        with pytest.raises(RuntimeError):
            handle.start_server()
        with pytest.raises(RuntimeError):
            old.submit([PROMPT_A], 4, 0)
        assert handle._server is old
    finally:
        release.set()
    monkeypatch.setattr(api, "STRAGGLER_JOIN_S", WAIT)
    try:
        # joins the old thread (it reaps the cancellation and ends), then
        # starts a new one
        handle.start_server()
        assert not old._thread.is_alive() and handle._server is not old
        assert handle.rm.results[guids[0]].status == "cancelled"
        g, ev = handle._server.submit([PROMPT_A], 4, 0)
        assert ev.wait(WAIT)
        res = handle.rm.results[g[0]]
        assert res.status == "ok"
        assert res.output_tokens == _jax_tokens(models, [PROMPT_A], 4)[0]
    finally:
        handle.stop_server(flush_timeout_s=WAIT)
    assert handle._server is None
    assert not handle.rm.pending and not handle.rm.inflight


def _hf_pair():
    """An HF-layout tiny LLaMA (config dict, state dict) for ``LLM``."""
    cfg = dict(model_type="llama", **TINY)
    rng = np.random.RandomState(3)
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
                            ("mlp.gate_proj", (I, E)),
                            ("mlp.up_proj", (I, E)),
                            ("mlp.down_proj", (E, I))):
            sd[p + name + ".weight"] = 0.2 * rng.randn(*shape)
        sd[p + "input_layernorm.weight"] = 1 + 0.1 * rng.randn(E)
        sd[p + "post_attention_layernorm.weight"] = 1 + 0.1 * rng.randn(E)
    return cfg, {k: v.astype(np.float32) for k, v in sd.items()}


def test_concurrent_submitters_match_offline_and_jax():
    """Four threads call ``LLM.generate`` on one running server: each
    gets the tokens of the port's offline ``generate`` and of the JAX
    package's ``LLM.generate`` for its prompt."""
    cfg, sd = _hf_pair()
    kw = dict(max_requests_per_batch=2, max_seq_length=64,
              max_tokens_per_batch=16, kv_cache_dtype="float32")
    prompts = [list(range(1, 13)), [3, 4], [7, 8, 9], [100, 5, 17, 42],
               [9, 9, 2], [60, 61, 62, 63, 64]]
    jres = JLLM((cfg, dict(sd))).compile(use_native_scheduler=False,
                                         **kw).generate(prompts,
                                                        max_new_tokens=9)
    llm = fft.LLM((cfg, dict(sd))).compile(device="cpu", **kw)
    offline = llm.generate(prompts, max_new_tokens=9)
    out, errors = {}, []

    def submit(i):
        try:
            for p in prompts[i::4]:
                out[tuple(p)] = llm.generate(p, max_new_tokens=9,
                                             tenant=f"t{i}")
        except Exception as e:      # surfaced by the assertion below
            errors.append(e)

    llm.start_server()
    try:
        threads = [threading.Thread(target=submit, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
        assert not any(t.is_alive() for t in threads) and not errors
    finally:
        llm.stop_server(flush_timeout_s=WAIT)
    for p, off, j in zip(prompts, offline, jres):
        res = out[tuple(p)]
        assert res.status == "ok"
        assert res.output_tokens == off.output_tokens == j.output_tokens
    assert not llm.rm.pending and not llm.rm.inflight


def test_generation_config_timeout_is_generate_default():
    """``GenerationConfig.timeout_s`` bounds every ``LLM.generate`` call
    that gives no ``timeout_s`` of its own."""
    cfg, sd = _hf_pair()
    llm = fft.LLM((cfg, dict(sd))).compile(
        device="cpu", generation_config=fft.GenerationConfig(timeout_s=1e-9),
        max_requests_per_batch=2, max_seq_length=64,
        max_tokens_per_batch=16, kv_cache_dtype="float32")
    res = llm.generate([3, 4, 5], max_new_tokens=4)
    assert res.status == "timed_out" and res.output_tokens == []
    res = llm.generate([3, 4, 5], max_new_tokens=4, timeout_s=WAIT)
    assert res.status == "ok" and len(res.output_tokens) == 4
