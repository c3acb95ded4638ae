"""The port's serving fleet against the JAX package's, on the CPU.

* ``attribute_failover_wait`` and ``summarize``'s failover counts on a
  fake clock equal the JAX package's;
* ``FaultInjector``: the same counter-driven fault sequence in both
  packages; ``check_invariants`` finds a leaked request;
* a ``ReplicaPool`` of 2 replicas cold-started from a tiny checkpoint
  (``checkpoint_replica_factory(..., device="cpu")``) behind a
  ``FleetTelemetry``: a ``FaultInjector`` crash mid-run fails requests
  over with the tokens of an undisturbed engine and of the JAX package's
  ``LLM.from_checkpoint``, every request resolves, the crash leaves a
  loadable incident report, an alert fires, the dead replica respawns,
  and ``spike_run`` scales up with no alert in its steady base, ending
  with ``check_invariants == []``;
* the CLI ``python -m flexflow_tpu_torch.serve`` (a checkpoint, the
  built-in pair) and the two tools with ``--device cpu``.

Nothing here sleeps for timing: every wait is bounded (an event, a
condition with a timeout, a join with a timeout).
"""

import ast
import gc
import json

import numpy as np
import pytest
import torch

from flexflow_tpu.serve import faultinject as jfi
from flexflow_tpu.serve import loadgen as jlg
from flexflow_tpu.serve.api import LLM as JLLM
from flexflow_tpu.telemetry import flight_recorder as jfr
import flexflow_tpu_torch as fft
from flexflow_tpu_torch.models import checkpoint_store as cs
from flexflow_tpu_torch.serve import faultinject as tfi
from flexflow_tpu_torch.serve import loadgen as tlg
from flexflow_tpu_torch.serve.replica import (ReplicaPool,
                                              checkpoint_replica_factory,
                                              failover_run, spike_run)
from flexflow_tpu_torch.serve.request_manager import RequestManager
from flexflow_tpu_torch import telemetry as ttel
from flexflow_tpu_torch.telemetry import flight_recorder as tfr
from flexflow_tpu_torch.telemetry.fleet import FleetTelemetry
from flexflow_tpu_torch.telemetry.slo import SLOPolicy

LLM_KW = dict(max_requests_per_batch=2, max_seq_length=64,
              max_tokens_per_batch=16, kv_cache_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _no_live_fleet_after():
    """The module leaves no live fleet behind: a ``FleetTelemetry`` stays
    in the telemetry's fleet set while anything references it, and every
    later metrics dump in this process would merge its histograms."""
    yield
    gc.collect()
    assert len(ttel._fleet_set()) == 0
    assert ttel.get_telemetry() is None


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("fleet_ckpt"))
    cs.save_tiny_checkpoint("llama", d, seed=0, device="cpu")
    return d


# ----------------------------------------------------------------------
# 1. failover accounting on a fake clock
# ----------------------------------------------------------------------
@pytest.mark.parametrize("case", [(2.5, 0.9, 0.3, 0.1), (1.0, 1.2, 0.0, 0.2),
                                  (0.4, 0.4, 0.4, 0.0), (3.0, 0.5, 0.1)])
def test_attribute_failover_wait_matches_jax(case):
    t = tlg.attribute_failover_wait(*case)
    assert t == jlg.attribute_failover_wait(*case)
    qw, ttft = t
    assert qw >= 0 and ttft >= qw


def _records(lg):
    """Records on a fake clock: every third request failed over once or
    twice, its pool latency split by attribute_failover_wait."""
    rng = np.random.RandomState(4)
    recs = []
    for i in range(24):
        fo = (i % 3 == 0) + (i % 9 == 0)
        lat, qw, pre = (float(rng.uniform(0.2, 2.0)),
                        float(rng.uniform(0.0, 0.1)),
                        float(rng.uniform(0.01, 0.05)))
        pool_lat = lat + (0.7 * fo)
        if fo:
            qw, ttft = lg.attribute_failover_wait(pool_lat, lat, qw, pre)
            lat = pool_lat
        else:
            ttft = qw + pre
        recs.append(lg.RequestRecord(
            idx=i, tenant="default", scheduled_s=0.125 * i,
            submitted_s=0.125 * i, prompt_tokens=8, output_tokens=24,
            latency_s=lat, ttft_s=ttft, queue_wait_s=qw, prefill_s=pre,
            deadline_s=1.0, status="ok" if i != 5 else "error",
            failovers=int(fo)))
    return recs


def test_summarize_failover_counts_match_jax():
    t = tlg.summarize(_records(tlg), offered_rps=8.0, n_scheduled=24)
    j = jlg.summarize(_records(jlg), offered_rps=8.0, n_scheduled=24)
    assert t == j
    assert t["n_failed_over"] == 8 and t["failovers_total"] == 11


# ----------------------------------------------------------------------
# 2. the fault injector and the leak audit
# ----------------------------------------------------------------------
class _FakeIFM:
    def step(self, *a, **k):
        return "step"

    def decode_block(self, *a, **k):
        return "block"


class _FakeModel:
    def __init__(self):
        self._inference_manager = _FakeIFM()


@pytest.mark.parametrize("kw", [dict(error_every=3, max_errors=2),
                                dict(error_every=4, stall_every=2,
                                     stall_s=0.0, max_errors=1)])
def test_fault_injector_matches_jax(kw):
    def drive(fi_mod):
        inj = fi_mod.FaultInjector(**kw)
        model = _FakeModel()
        inj.install(model)
        ifm = model._inference_manager
        out = []
        for i in range(12):
            try:
                out.append((ifm.step if i % 2 else ifm.decode_block)())
            except fi_mod.EngineFault as e:
                out.append(str(e))
        inj.uninstall()
        out.append(ifm.step())
        return out, (inj.n_calls, inj.n_errors, inj.n_stalls)

    assert drive(tfi) == drive(jfi)


def test_check_invariants_finds_a_leak():
    handle = tlg.EngineHandle.__new__(tlg.EngineHandle)
    handle.rm = RequestManager()
    handle._server = None
    assert tfi.check_invariants(handle) == []
    handle.rm.register_new_request([1, 2, 3], max_new_tokens=2)
    problems = tfi.check_invariants(handle)
    assert len(problems) == 2 and "pending" in problems[0]


# ----------------------------------------------------------------------
# 3. the replica pool: crash, failover, respawn, scale-up
# ----------------------------------------------------------------------
SPEC = dict(prompt_lens=(4, 8), output_lens=(24, 32), vocab_size=128)
POLICY = dict(fast_burn_threshold=6.0, slow_burn_threshold=3.0)


def _offline(llm_or_handle, prompts, n_new):
    rm = RequestManager()
    guids = [rm.register_new_request(list(p), max_new_tokens=n)
             for p, n in zip(prompts, n_new)]
    rm.generate_incr_decoding(llm_or_handle.ffmodel)
    return [rm.results[g].output_tokens for g in guids]


def test_pool_failover_respawn_and_spike(ckpt, tmp_path):
    spec = tlg.WorkloadSpec(
        tenants=(tlg.TenantSpec("default", 1.0, deadline_s=1.0),), **SPEC)
    fleet = FleetTelemetry(trace_dir=str(tmp_path / "obs"))
    factory = checkpoint_replica_factory(ckpt, slots=2, max_seq=64,
                                         device="cpu")
    pool = ReplicaPool(factory, n_replicas=2, telemetry=fleet)
    pool.start_server()
    try:
        fo = failover_run(pool, spec, rate_rps=8.0, n_requests=12, seed=0,
                          crash_after=6, timeout_s=120.0,
                          slo_policy=SLOPolicy(**POLICY))
        assert fo["resolved_fraction"] == 1.0
        assert fo["n_failed_over"] >= 1 and fo["alerts_fired"] >= 1
        assert fo["injector"]["n_errors"] == 1
        assert fo["report"]["n_ok"] == 12
        # the failed-over requests' tokens: an undisturbed engine's and
        # the JAX package's, for the same checkpoint
        res = [r for r in pool.rm.results.values()]
        prompts = [r.input_tokens for r in res]
        n_new = [len(r.output_tokens) for r in res]
        got = [r.output_tokens for r in res]
        assert got == _offline(factory(99), prompts, n_new)
        jllm = JLLM.from_checkpoint(ckpt).compile(use_native_scheduler=False,
                                                 **LLM_KW)
        jout = jllm.generate(prompts, max_new_tokens=max(n_new))
        assert got == [jr.output_tokens[:n] for jr, n in zip(jout, n_new)]
        assert all(r.trace_id for r in res)
        assert {r.failovers for r in res} >= {0, 1}
        # the crash's incident report loads in both packages
        (report,) = pool.incident_reports
        for loader in (tfr.load_incident_report, jfr.load_incident_report):
            header, events = loader(report)
            assert header["replica"] == 0 and "EngineFault" in header["error"]
            assert events
        # the stitched trace: one pid row group per replica
        trace = fleet.stitch_chrome_trace()
        assert {e["pid"] for e in trace} == {1, 2}
        # the dead replica respawns from the checkpoint
        with pool._work:
            assert pool._work.wait_for(lambda: pool.n_alive() == 2,
                                       timeout=120.0)
        assert len(pool.stats()["cold_starts_s"]) == 3
        sp = spike_run(pool, spec, base_rps=4.0, spike_multiple=16.0,
                       n_base=8, n_spike=16, seed=1, timeout_s=120.0,
                       scale_threshold=1, scale_consecutive=1,
                       slo_policy=SLOPolicy(**POLICY))
        assert sp["scaled_up"] and sp["n_replicas_after"] == 3
        assert sp["slo"]["base"]["alerts_fired"] == 0
        assert sp["base"]["resolved_fraction"] == 1.0
        assert sp["spike"]["resolved_fraction"] == 1.0
        fleet_snap = json.loads(fleet.to_json())
        assert fleet_snap["fleet"]["ffsv_failovers_total"]["value"] == \
            fo["failovers_total"]
        assert 'ffsv_requests_finished_total{replica="0"}' in \
            fleet.to_prometheus()
    finally:
        pool.stop_server(flush_timeout_s=60.0)
        fleet.close()
    assert tfi.check_invariants(pool) == []


# ----------------------------------------------------------------------
# 4. the CLI and the tools
# ----------------------------------------------------------------------
def _cli_tokens(out):
    return [ast.literal_eval(line.split("output=", 1)[1])
            for line in out.splitlines() if line.startswith("guid=")]


def test_serve_cli_checkpoint_matches_in_process(ckpt, tmp_path, capsys):
    from flexflow_tpu_torch.serve.__main__ import main

    log = str(tmp_path / "out.txt")
    assert main(["--model", ckpt, "--device", "cpu", "--prompt", "3,5,7",
                 "--prompt", "100,5,17,42", "--max-new-tokens", "9",
                 "--max-requests-per-batch", "2", "--8bit-quantization",
                 "--output-file", log]) == 0
    cli = _cli_tokens(capsys.readouterr().out)
    llm = fft.LLM.from_checkpoint(ckpt).compile(
        device="cpu", max_requests_per_batch=2, max_seq_length=256,
        max_tokens_per_batch=64, quantization_type="int8")
    want = [r.output_tokens for r in llm.generate([[3, 5, 7],
                                                   [100, 5, 17, 42]],
                                                  max_new_tokens=9)]
    assert cli == want and all(len(t) == 9 for t in cli)
    with open(log) as f:
        assert f.read().count("output: ") == 2


def test_serve_cli_builtin_pair(capsys):
    from flexflow_tpu_torch.serve.__main__ import main

    assert main(["--device", "cpu", "--max-new-tokens", "6"]) == 0
    incr = _cli_tokens(capsys.readouterr().out)
    assert main(["--device", "cpu", "--max-new-tokens", "6",
                 "--ssm-model", "builtin"]) == 0
    out = capsys.readouterr().out
    assert "[speculative]" in out
    assert _cli_tokens(out) == incr and [len(t) for t in incr] == [6, 6]
    with pytest.raises(SystemExit):
        main(["--device", "cpu", "--ssm-model", "some/dir"])


def test_loadtest_and_faulttest_tools(tmp_path, capsys):
    from flexflow_tpu_torch.telemetry import disable_telemetry
    from flexflow_tpu_torch.tools import faulttest, loadtest

    out = str(tmp_path / "sweep.json")
    try:
        assert loadtest.main(["--device", "cpu", "--rate", "40",
                              "--steps", "2", "--requests", "3",
                              "--metrics-port", "0", "--json", out]) == 0
        with open(out) as f:
            sweep = json.load(f)
        assert len(sweep["steps"]) == 2
        assert all(s["n_ok"] == 3 for s in sweep["steps"])
        assert loadtest.main(["--device", "cpu", "--spike", "--replicas",
                              "2", "--crash-after", "6", "--rate", "8",
                              "--requests", "4", "--checkpoint-dir",
                              str(tmp_path / "ck")]) == 0
        text = capsys.readouterr().out
        assert "resolved 1.000" in text and "scaled_up=" in text
    finally:
        disable_telemetry()
    assert faulttest.main(["--device", "cpu", "--requests", "6",
                           "--json", str(tmp_path / "chaos.json")]) == 0
    with open(tmp_path / "chaos.json") as f:
        chaos = json.load(f)
    assert chaos["problems"] == [] and chaos["resolved_fraction"] == 1.0
