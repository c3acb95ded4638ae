"""The port's admission controller, load generator and SLO monitor against
the JAX package's, on the CPU.

* ``AdmissionController``: one accept / reject / retry-after sequence on a
  fake clock (queue depth, per-tenant token buckets, the estimated-wait
  bound, windowed queue waits ageing out) gives the same outcomes, hints
  and stats in both packages;
* ``build_schedule``: the same seeds give the same schedules (Poisson and
  fixed-rate arrivals, weighted tenants, the shared-prefix mix);
* ``summarize``, ``find_knee`` and ``replay_records(...).report()`` on the
  same synthetic records give equal dicts;
* ``LoadRunner`` end to end through the port's background server on the
  tiny LLaMA gives the JAX package's offline incremental tokens for every
  scheduled prompt.
"""

import dataclasses

import numpy as np
import pytest
import torch

import flexflow_tpu as ff
from flexflow_tpu.ffconst import InferenceMode as JMode
from flexflow_tpu.models.llama import LLAMAConfig as JLlamaConfig
from flexflow_tpu.models.llama import create_llama_model as jax_create_llama
from flexflow_tpu.serve import admission as jadm
from flexflow_tpu.serve import loadgen as jlg
from flexflow_tpu.serve.request_manager import RequestManager as JRM
from flexflow_tpu.telemetry import slo as jslo
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.ffconst import InferenceMode
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.serve import admission as tadm
from flexflow_tpu_torch.serve import loadgen as tlg
from flexflow_tpu_torch.telemetry import slo as tslo

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)


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
# 1. admission control on a fake clock
# ----------------------------------------------------------------------
# (op, args): ("admit", tenant, depth, n) | ("wait", seconds) |
# ("advance", seconds)
OPS = [("admit", "t", 0, 1), ("admit", "t", 3, 1), ("admit", "t", 4, 1),
       ("admit", "t", 2, 3), ("wait", 0.2), ("wait", 0.4), ("wait", 1.0),
       ("admit", "t", 4, 1), ("admit", "a", 0, 1), ("admit", "a", 0, 1),
       ("admit", "a", 0, 1), ("advance", 0.5), ("admit", "a", 0, 1),
       ("advance", 0.5), ("admit", "a", 0, 1), ("admit", "z", 0, 1),
       ("admit", "z", 0, 1), ("admit", "t", 1, 1), ("wait", 3.0),
       ("wait", 2.5), ("admit", "t", 0, 1), ("advance", 120.0),
       ("admit", "t", 0, 1), ("admit", "b", 9, 1), ("admit", "b", 0, 2)]


def _drive(adm, clock_kw=0.0):
    clk = FakeClock(clock_kw)
    pol = adm.AdmissionPolicy(max_queue_depth=4, min_retry_after_s=0.05,
                              max_estimated_wait_s=2.0,
                              tenant_rates={"a": (1.0, 2.0),
                                            "b": (1.0, 1.0)},
                              default_rate=(10.0, 1.0))
    ctrl = adm.AdmissionController(pol, clock=clk)
    log = []
    for op in OPS:
        if op[0] == "admit":
            try:
                ctrl.admit(op[1], op[2], n=op[3])
                log.append(("ok",))
            except adm.RejectedError as e:
                log.append((e.reason, e.tenant, e.queue_depth,
                            round(e.retry_after_s, 9)))
        elif op[0] == "wait":
            ctrl.observe_queue_wait(op[1])
            log.append(("p99", round(ctrl.queue_wait_p99(), 9)))
        else:
            clk.t += op[1]
    return log, ctrl.stats()


def test_admission_sequence_matches_jax():
    tlog, tstats = _drive(tadm)
    jlog, jstats = _drive(jadm)
    assert tlog == jlog
    assert tstats == jstats
    # the sequence reaches every kind of rejection
    reasons = {entry[0] for entry in tlog}
    assert {"ok", "queue_full", "tenant_rate", "wait_bound"} <= reasons


# ----------------------------------------------------------------------
# 2. schedules
# ----------------------------------------------------------------------
def _spec(lg, **kw):
    tenants = (lg.TenantSpec("premium", weight=1.0, deadline_s=1.5,
                             priority=1),
               lg.TenantSpec("besteffort", weight=2.0, timeout_s=3.0))
    return lg.WorkloadSpec(prompt_lens=(4, 8, 16), prompt_weights=(1, 2, 1),
                           output_lens=(8, 32), tenants=tenants, **kw)


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("process", ["poisson", "uniform"])
@pytest.mark.parametrize("prefix", [(0, 0), (2, 96), (3, 13)])
def test_build_schedule_matches_jax(seed, process, prefix):
    kw = dict(shared_prefix_groups=prefix[0], shared_prefix_len=prefix[1])
    t = tlg.build_schedule(_spec(tlg, **kw), 24, 3.5, seed, process)
    j = jlg.build_schedule(_spec(jlg, **kw), 24, 3.5, seed, process)
    assert [dataclasses.asdict(r) for r in t] == \
        [dataclasses.asdict(r) for r in j]
    if prefix[0]:
        heads = {tuple(r.prompt[:prefix[1]]) for r in t}
        assert len(heads) <= prefix[0]


# ----------------------------------------------------------------------
# 3. summarize, find_knee, the SLO report
# ----------------------------------------------------------------------
STATUSES = ("ok", "ok", "ok", "timed_out", "ok", "rejected", "cancelled",
            "ok", "error", "ok")


def _records(lg, n=40, seed=3):
    rng = np.random.RandomState(seed)
    recs = []
    for i in range(n):
        status = STATUSES[i % len(STATUSES)]
        lat = float(rng.uniform(0.1, 3.0)) if status != "rejected" else 0.0
        recs.append(lg.RequestRecord(
            idx=i, tenant=("premium" if i % 3 == 0 else "besteffort"),
            scheduled_s=0.25 * i, submitted_s=0.25 * i + 0.01,
            prompt_tokens=int(rng.randint(4, 40)),
            output_tokens=(int(rng.randint(1, 64))
                           if status != "rejected" else 0),
            latency_s=lat, ttft_s=lat * 0.3, queue_wait_s=lat * 0.1,
            prefill_s=lat * 0.2,
            deadline_s=(1.5 if i % 3 == 0 else None), status=status,
            prefix_hit_tokens=int(rng.randint(0, 4))))
    return recs


def test_summarize_knee_and_slo_report_match_jax():
    trec, jrec = _records(tlg), _records(jlg)
    kw = dict(duration_s=12.5, offered_rps=3.2, n_scheduled=42)
    assert tlg.summarize(trec, **kw) == jlg.summarize(jrec, **kw)
    assert tlg.summarize(trec) == jlg.summarize(jrec)
    steps = [tlg.summarize(trec[:k], offered_rps=0.5 * k)
             for k in (10, 20, 30, 40)]
    for bound in (None, 0.5, 5.0):
        assert tlg.find_knee(steps, bound) == jlg.find_knee(steps, bound)
    for policy in (None, dict(availability_target=0.95, latency_slo_s=2.0,
                              count_deadline_miss=True, fast_window_s=2.0,
                              slow_window_s=6.0)):
        tp = None if policy is None else tslo.SLOPolicy(**policy)
        jp = None if policy is None else jslo.SLOPolicy(**policy)
        assert (tslo.replay_records(trec, policy=tp).report()
                == jslo.replay_records(jrec, policy=jp).report())


# ----------------------------------------------------------------------
# 4. LoadRunner end to end on the tiny LLaMA
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def tiny_pair():
    serve = dict(max_requests_per_batch=2, max_sequence_length=64,
                 max_tokens_per_batch=16, seed=0, kv_cache_dtype="float32")
    jm = ff.FFModel(ff.FFConfig(use_native_scheduler=False, **serve))
    jax_create_llama(jm, JLlamaConfig(**TINY),
                     mode=JMode.INC_DECODING_MODE)
    jm.compile(comp_mode=ff.CompMode.COMP_MODE_INFERENCE)
    pm = fft.FFModel(fft.FFConfig(device="cpu", **serve))
    create_llama_model(pm, LLAMAConfig(**TINY),
                       mode=InferenceMode.INC_DECODING_MODE)
    pm.compile()
    load_params(pm, params_from_jax(jm.params))
    return jm, pm


def test_load_runner_tokens_match_jax_offline(tiny_pair):
    jm, pm = tiny_pair
    spec = tlg.WorkloadSpec(prompt_lens=(3, 6), output_lens=(4, 7))
    schedule = tlg.build_schedule(spec, 6, 200.0, seed=5)
    handle = tlg.EngineHandle(pm)
    try:
        records = tlg.LoadRunner(handle).run(schedule, timeout_s=120.0)
    finally:
        handle.stop_server(flush_timeout_s=60.0)
    assert handle._server is None
    assert [r.idx for r in records] == list(range(6))
    assert all(r.status == "ok" for r in records)
    rep = tlg.summarize(records, n_scheduled=len(schedule))
    assert rep["resolved_fraction"] == 1.0 and rep["n_ok"] == 6
    port = {tuple(res.input_tokens): res.output_tokens
            for res in handle.rm.results.values()}
    jrm = JRM()
    guids = [jrm.register_new_request(r.prompt,
                                      max_new_tokens=r.max_new_tokens)
             for r in schedule]
    jrm.generate_incr_decoding(jm)
    for r, g in zip(schedule, guids):
        assert port[tuple(r.prompt)] == jrm.results[g].output_tokens
        assert len(port[tuple(r.prompt)]) == r.max_new_tokens
    assert not handle.rm.pending and not handle.rm.inflight
