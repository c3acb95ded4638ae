"""The port's serving telemetry against the JAX package's, on the CPU.

* the registry: one seeded sequence of observations (counters, gauges,
  bucketed and windowed histograms on an injected clock, merges) gives
  equal ``snapshot()``s and byte-equal ``to_prometheus()`` text in both
  packages, and so does the whole ``ServingTelemetry`` hook vocabulary;
* instrument math, the span tracer's lifecycle and Chrome export, and
  the ``/metrics`` endpoint on an ephemeral port (a taken port raises);
* the JAX package's speculative-decode telemetry test on the
  ``conftest.tiny_spec_pair`` weights carried across
  (``convert.params_from_jax``): with telemetry on in both packages and
  the static policy, the same integer counters, histogram counts and
  span sequence (timestamps aside), with the JAX test's exact values;
* every scheduler loop of the port (incremental, chain, two-draft tree,
  beam engine, host tree with two beam drafts) gives the same tokens with
  telemetry on as off, and consistent counters;
* the disabled path records nothing; ``FFConfig.telemetry`` through
  ``LLM.compile`` and ``LLM.start_metrics_server``;
* a flight-recorder incident report dumped by either package loads in
  the other.
"""

import json
import socket
import urllib.request

import numpy as np
import pytest
import torch

from flexflow_tpu import telemetry as jtel
from flexflow_tpu.serve.batch_config import GenerationConfig as JGenCfg
from flexflow_tpu.serve.request_manager import RequestManager as JRM
from flexflow_tpu.telemetry import flight_recorder as jfr
from flexflow_tpu.telemetry import metrics as jmet
import flexflow_tpu_torch as fft
from flexflow_tpu_torch import telemetry as ttel
from flexflow_tpu_torch.convert import load_params, params_from_jax
from flexflow_tpu_torch.ffconst import InferenceMode
from flexflow_tpu_torch.models.llama import LLAMAConfig, create_llama_model
from flexflow_tpu_torch.serve import loadgen as tlg
from flexflow_tpu_torch.serve.batch_config import GenerationConfig
from flexflow_tpu_torch.serve.request_manager import RequestManager
from flexflow_tpu_torch.telemetry import flight_recorder as tfr
from flexflow_tpu_torch.telemetry import metrics as tmet

TINY = dict(vocab_size=128, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128)
SERVE = dict(max_requests_per_batch=2, max_sequence_length=64,
             max_tokens_per_batch=16, seed=0, kv_cache_dtype="float32")
PROMPTS = [[5, 9, 23, 44], [7, 3, 11]]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tiny models need no more: the suite runs in parallel workers on
    shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _telemetry_off():
    """Every test starts and ends with both packages' telemetry off."""
    ttel.disable_telemetry()
    jtel.disable_telemetry()
    yield
    ttel.disable_telemetry()
    jtel.disable_telemetry()


# ----------------------------------------------------------------------
# 1. the registry, observation for observation
# ----------------------------------------------------------------------
def _feed(met, base):
    """One seeded observation sequence into a fresh registry of ``met``
    (either package's metrics module); returns (registry, windowed
    percentile dicts at three injected instants, merged registry)."""
    rng = np.random.RandomState(11)
    reg = met.MetricsRegistry()
    c = reg.counter("ffsv_requests_total", "requests admitted")
    g = reg.gauge("ffsv_queue_depth", "queue depth")
    lat = reg.histogram("ffsv_request_latency_seconds", "latency",
                        window_s=5.0)
    acc = reg.histogram("ffsv_acceptance_length", "accepted",
                        buckets=met.COUNT_BUCKETS)
    occ = reg.histogram("ffsv_batch_occupancy", "occupancy",
                        buckets=met.FRACTION_BUCKETS)
    big = reg.histogram("big_seconds", "", window_s=1e9)
    for i in range(200):
        c.inc(int(rng.randint(1, 4)))
        g.set(float(rng.randint(0, 9)))
        v = float(rng.exponential(0.3))
        lat.observe(v, at=base + 0.05 * i)
        acc.observe(int(rng.randint(0, 9)))
        occ.observe(float(rng.uniform()))
        big.observe(float(rng.uniform(0, 200)), at=base + i)
    wins = [lat.windowed_percentiles((50, 90, 99), now=base + t)
            for t in (3.0, 9.95, 40.0)]
    other = met.MetricsRegistry()
    other.counter("ffsv_requests_total", "requests admitted").inc(5)
    h = other.histogram("ffsv_request_latency_seconds", "latency",
                        window_s=5.0)
    for i in range(30):
        h.observe(0.01 * i, at=base + 0.1 * i)
    merged = met.MetricsRegistry.merge([reg, other])
    return reg, wins, merged


def test_registry_export_matches_jax():
    import time

    base = time.monotonic()   # windows hold everything at export time
    treg, twins, tmerged = _feed(tmet, base)
    jreg, jwins, jmerged = _feed(jmet, base)
    assert twins == jwins
    assert twins[0]["count"] > 0 and twins[2]["count"] == 0
    for t, j in ((treg, jreg), (tmerged, jmerged)):
        assert t.snapshot() == j.snapshot()
        assert t.to_prometheus() == j.to_prometheus()
        assert t.to_json() == j.to_json()
    text = treg.to_prometheus()
    assert 'ffsv_request_latency_seconds_window{quantile="0.5"}' in text
    assert 'big_seconds_bucket{le="+Inf"} 200' in text
    for name in ("ffsv_acceptance_length", "big_seconds"):
        for q in (1, 50, 99, 100):
            assert treg.get(name).percentile(q) == jreg.get(name).percentile(q)


def _hooks(mod):
    """The whole ServingTelemetry hook vocabulary, one fixed call
    sequence, on a fresh instance of ``mod``'s class."""
    tel = mod.ServingTelemetry()
    tel.note_admission(7, 4, 6, trace_id="t-x")
    tel.note_admission(8, 3, 6)
    tel.note_slot_grant(7, 0)
    tel.note_batch(pending=1, live=1, slots=2, kv_fraction=0.1)
    tel.record_prefill(0.004, 7, [(7, 0, 4), (8, 0, 3)])
    tel.record_decode_block(0.02, 4, 2, guids=(7, 8))
    n_acc = np.array([[2, 1, -1], [0, 2, 2]])
    tel.record_spec_block(0.03, n_acc, 3, 4,
                          depths=np.array([[3, 3, -1], [2, 3, 3]]))
    tel.note_spec_controller(0.6, 1, 1)
    tel.note_rejected("besteffort", "queue_full", 5)
    tel.note_preempted(8)
    tel.note_prefix_lookup(0, 0)
    tel.note_prefix_lookup(13, 21)
    tel.note_prefix_store(2, 40)
    tel.note_failover(8, 0, 1, trace_id="t-y")
    tel.note_finish(7, 6, 0.5, 0.1, queue_wait_s=0.02, prefill_s=0.08)
    tel.note_finish(8, 2, 0.7, 0.3, status="timed_out", preemptions=1)
    tel.note_finish(9, 0, 0.2, 0.0, status="cancelled")
    return tel


def test_hook_vocabulary_matches_jax():
    """Equal hook calls: byte-equal Prometheus text (every ``ffsv_`` name
    and help string), equal snapshots, the same flight-recorder events."""
    t, j = _hooks(ttel), _hooks(jtel)
    assert t.registry.to_prometheus() == j.registry.to_prometheus()
    assert t.registry.snapshot() == j.registry.snapshot()
    names = set(t.registry.snapshot())
    assert {"ffsv_jit_cache_misses_total", "ffsv_engine_retraces_total",
            "ffsv_failovers_total", "ffsv_prefix_pool_tokens"} <= names
    assert t.registry.get("ffsv_spec_rounds_total").value == 5

    def strip(evs):
        return [{k: v for k, v in e.items() if k != "t_s"} for e in evs]

    assert strip(t.flight.events()) == strip(j.flight.events())
    assert ([(e["name"], e["tid"]) for e in t.tracer.events]
            == [(e["name"], e["tid"]) for e in j.tracer.events])


def test_counter_gauge_histogram_math():
    reg = tmet.MetricsRegistry()
    c = reg.counter("reqs", "requests")
    c.inc()
    c.inc(2)
    assert c.value == 3
    assert reg.counter("reqs") is c
    g = reg.gauge("depth")
    g.set(7)
    assert g.value == 7
    h = reg.histogram("lat", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v)
    assert h.count == 4 and h.sum == pytest.approx(55.55)
    assert h.snapshot()["buckets"] == [[0.1, 1], [1.0, 2], [10.0, 3],
                                       ["+Inf", 4]]
    h2 = reg.histogram("pct", buckets=(1e9,))
    h2.observe_many(range(1, 101))
    assert h2.percentile(50) == pytest.approx(50.5)
    assert h2.percentile(99) == pytest.approx(99.01)
    with pytest.raises(TypeError):
        reg.counter("lat")
    with pytest.raises(ValueError):
        other = tmet.MetricsRegistry()
        other.histogram("lat", buckets=(1.0,))
        tmet.MetricsRegistry.merge([reg, other])


# ----------------------------------------------------------------------
# 2. span tracer and the /metrics endpoint
# ----------------------------------------------------------------------
def test_span_tracer_lifecycle(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tr = ttel.SpanTracer(path)
    tr.admission(42, prompt_tokens=4, max_new_tokens=8, trace_id="t-1")
    t0 = tr._t0
    tr.prefill(42, start_pos=0, n_tokens=3, ts_s=t0 + 0.001, dur_s=0.002)
    tr.decode_round(42, 0, n_accepted=2, committed=3, block_t0=t0 + 0.004,
                    block_dur=0.01, rounds_in_block=2)
    tr.finish(42, output_tokens=8, latency_s=0.02, ttft_s=0.005)
    tr.close()
    evs = ttel.load_jsonl(path)
    assert [e["name"] for e in evs] == ["clock_sync", "admission",
                                       "prefill", "decode_round", "finish"]
    assert all(e["tid"] == 42 for e in evs[1:])
    assert all(e["args"]["trace_id"] == "t-1" for e in evs[1:])
    assert evs[2]["ph"] == "X" and evs[2]["dur"] == pytest.approx(2000, abs=1)
    assert evs[3]["dur"] == pytest.approx(5000, abs=1)
    chrome = str(tmp_path / "trace.json")
    tr.export_chrome_trace(chrome)
    with open(chrome) as f:
        doc = json.load(f)
    assert [e["name"] for e in doc["traceEvents"]] == [e["name"] for e in evs]
    # the JAX package's loader reads the port's JSONL
    assert jtel.load_jsonl(path) == evs
    # two tracers stitched: one pid row group each, on a common clock
    a = ttel.SpanTracer(pid=1, process_name="replica 0")
    b = ttel.SpanTracer(pid=2, process_name="replica 1")
    a.admission(1, 2, 2)
    b.admission(1, 2, 2)
    merged = ttel.stitch_chrome_trace([a, b])
    assert {e["pid"] for e in merged} == {1, 2}
    assert ttel.mint_trace_id() != ttel.mint_trace_id()


def test_metrics_http_endpoint():
    reg = tmet.MetricsRegistry()
    reg.counter("ffsv_requests_total").inc(5)
    srv = tmet.MetricsHTTPServer(lambda: reg, port=0)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        text = urllib.request.urlopen(base + "/metrics",
                                      timeout=30).read().decode()
        assert "ffsv_requests_total 5" in text
        snap = json.loads(urllib.request.urlopen(
            base + "/metrics.json", timeout=30).read().decode())
        assert snap["ffsv_requests_total"]["value"] == 5
        # a port that is taken raises: no silent second endpoint
        with pytest.raises(OSError):
            tmet.MetricsHTTPServer(lambda: reg, port=srv.port)
    finally:
        srv.stop()


# ----------------------------------------------------------------------
# 3. the JAX package's speculative-decode telemetry test, both packages
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def port_pair(tiny_spec_pair):
    """The port's verify/draft pair on the tiny spec pair's weights."""
    jllm, jssm = tiny_spec_pair
    out = []
    for jm, mode in ((jllm, InferenceMode.TREE_VERIFY_MODE),
                     (jssm, InferenceMode.BEAM_SEARCH_MODE)):
        pm = fft.FFModel(fft.FFConfig(device="cpu", **SERVE))
        create_llama_model(pm, LLAMAConfig(**TINY), mode=mode)
        pm.compile()
        load_params(pm, params_from_jax(
            {layer: {w: np.asarray(a) for w, a in lp.items()}
             for layer, lp in jm.params.items()}))
        out.append(pm)
    return out


def _spec_run(tel_mod, rm_cls, gen_cfg, llm, ssm, trace):
    tel = tel_mod.enable_telemetry(trace_path=trace)
    try:
        rm = rm_cls()
        for p in PROMPTS:
            rm.register_new_request(p, max_new_tokens=6)
        results = rm.generate_spec_infer(
            llm, [ssm], spec_depth=2,
            generation_config=gen_cfg(adaptive_spec=False))
        snap = tel.registry.snapshot()
    finally:
        tel_mod.disable_telemetry()
    return results, snap, tel_mod.load_jsonl(trace)


def _integers(snap):
    """Every counter and gauge value, and every histogram's count (the
    timing-independent part of a snapshot)."""
    return {k: (m["value"] if "value" in m else m["count"])
            for k, m in snap.items()
            if not k.endswith("_seconds") or m["type"] == "histogram"}


def _spans(evs):
    """Span names, request tracks numbered by first appearance, and args
    without times or minted ids."""
    order = {}
    out = []
    for e in evs[1:]:
        tid = order.setdefault(e["tid"], len(order))
        args = {k: v for k, v in e.get("args", {}).items()
                if k not in ("latency_s", "ttft_s", "trace_id",
                             "request_guid")}
        out.append((e["name"], e["ph"], tid, args))
    return out


def test_spec_decode_telemetry_matches_jax(tiny_spec_pair, port_pair,
                                          tmp_path):
    jllm, jssm = tiny_spec_pair
    pllm, pssm = port_pair
    tres, tsnap, tevs = _spec_run(ttel, RequestManager, GenerationConfig,
                                  pllm, pssm, str(tmp_path / "t.jsonl"))
    jres, jsnap, jevs = _spec_run(jtel, JRM, JGenCfg, jllm, jssm,
                                  str(tmp_path / "j.jsonl"))
    assert ([r.output_tokens for r in tres]
            == [r.output_tokens for r in jres])
    # the JAX engines count their block compiles; the port compiles none
    compiles = ("ffsv_jit_cache_misses_total", "ffsv_engine_retraces_total")
    tint, jint = _integers(tsnap), _integers(jsnap)
    assert [tint.pop(k) for k in compiles] == [0, 0]
    for k in compiles:
        jint.pop(k)
    assert tint == jint
    assert _spans(tevs) == _spans(jevs)
    # the JAX test's exact values: full acceptance at depth 2, 3 tokens a
    # round, two rounds a request
    acc = tsnap["ffsv_acceptance_length"]
    assert acc["count"] == 4 and acc["sum"] == 8
    tpr = tsnap["ffsv_tokens_per_round"]
    assert tpr["count"] == 4 and tpr["sum"] == 12
    assert tsnap["ffsv_spec_rounds_total"]["value"] == 4
    assert tsnap["ffsv_tokens_generated_total"]["value"] == 12
    assert tsnap["ffsv_prefill_tokens_total"]["value"] == 10
    assert tsnap["ffsv_requests_finished_total"]["value"] == 2
    assert tsnap["ffsv_batch_occupancy"]["percentiles"]["p50"] == 1.0
    assert tsnap["ffsv_per_token_latency_seconds"]["count"] == 2
    rounds = [e for e in tevs if e["name"] == "decode_round"]
    assert len(rounds) == 4
    assert all(e["args"]["n_accepted"] == 2 for e in rounds)
    assert {e["tid"] for e in rounds} == {r.guid for r in tres}
    assert all(e["args"]["trace_id"].startswith("t-") for e in rounds)
    assert all(r.trace_id and r.ttft_s == pytest.approx(
        r.queue_wait_s + r.prefill_s) for r in tres)


# ----------------------------------------------------------------------
# 4. every loop: telemetry on gives the tokens of telemetry off
# ----------------------------------------------------------------------
def _model(mode, layers=2, **kw):
    pm = fft.FFModel(fft.FFConfig(device="cpu", **{**SERVE, **kw}))
    create_llama_model(pm, LLAMAConfig(**{**TINY,
                                          "num_hidden_layers": layers}),
                       mode=mode)
    return pm.compile()


@pytest.fixture(scope="module")
def loops():
    """Per path: (llm, drafts). The drafts are 1-layer truncations on
    other seeds, so rounds accept partially."""
    V, B = InferenceMode.TREE_VERIFY_MODE, InferenceMode.BEAM_SEARCH_MODE
    verifier = _model(V)
    return {
        "incr": (_model(InferenceMode.INC_DECODING_MODE), []),
        "chain": (verifier, [_model(B, 1, seed=3)]),
        "tree2": (verifier, [_model(B, 1, seed=3), _model(B, 1, seed=4)]),
        "beam": (verifier, [_model(B, 1, seed=3, max_beam_width=2)]),
        "host2": (verifier, [_model(B, 1, seed=3, max_beam_width=2),
                             _model(B, 1, seed=4, max_beam_width=2)]),
    }


def _serve(llm, drafts, adaptive, tel=None):
    rm = RequestManager(telemetry=tel)
    for p in PROMPTS + [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12]]:
        rm.register_new_request(p, max_new_tokens=9)
    if drafts:
        res = rm.generate_spec_infer(
            llm, drafts, spec_depth=3,
            generation_config=GenerationConfig(adaptive_spec=adaptive))
    else:
        res = rm.generate_incr_decoding(llm)
    return {tuple(r.input_tokens): r.output_tokens for r in res}, rm


@pytest.mark.parametrize("path", ["incr", "chain", "chain_adaptive",
                                  "tree2", "beam", "host2"])
def test_telemetry_on_gives_the_same_tokens(loops, path):
    adaptive = path.endswith("_adaptive")
    llm, drafts = loops[path.replace("_adaptive", "")]
    off, _ = _serve(llm, drafts, adaptive)
    tel = ttel.ServingTelemetry()          # explicit: the global stays off
    on, rm = _serve(llm, drafts, adaptive, tel)
    assert ttel.get_telemetry() is None
    assert on == off
    reg = tel.registry
    assert reg.get("ffsv_requests_total").value == 3
    assert reg.get("ffsv_requests_finished_total").value == 3
    assert reg.get("ffsv_tokens_generated_total").value == \
        sum(len(t) for t in on.values())
    assert reg.get("ffsv_prefill_step_seconds").count > 0
    assert reg.get("ffsv_prefill_tokens_total").value >= sum(
        len(p) - 1 for p in on)
    names = [e["name"] for e in tel.tracer.events]
    assert names.count("admission") == names.count("finish") == 3
    rounds = reg.get("ffsv_spec_rounds_total").value
    if path == "incr":
        assert rounds == 0 and reg.get("ffsv_decode_block_seconds").count
        return
    if adaptive:
        # the controller's parks reach the counter, tick by tick
        assert reg.get("ffsv_spec_fallback_total").value == \
            rm.spec_stats["parked"]
    else:
        assert rounds > 0
    assert reg.get("ffsv_acceptance_length").count == rounds
    assert reg.get("ffsv_tokens_per_round").count == rounds
    if path == "host2":
        # a verify step is one round of every live request; the host path
        # emits no fused-block round spans
        assert 0 < reg.get("ffsv_spec_block_seconds").count <= rounds
        assert names.count("decode_round") == 0
    else:
        assert names.count("decode_round") == rounds
        assert reg.get("ffsv_spec_block_seconds").count > 0


def test_disabled_path_records_nothing(port_pair):
    llm, ssm = port_pair
    assert ttel.get_telemetry() is None
    rm = RequestManager()
    rm.register_new_request([5, 9, 23, 44], max_new_tokens=6)
    (res,) = rm.generate_spec_infer(llm, [ssm], spec_depth=2)
    assert ttel.get_telemetry() is None
    assert len(res.output_tokens) == 6 and res.latency_s > 0
    assert res.trace_id.startswith("t-")
    tel = ttel.enable_telemetry()
    snap = tel.registry.snapshot()
    assert all(m.get("value", 0) == 0 and m.get("count", 0) == 0
               for m in snap.values())
    assert len(tel.tracer.events) == 1
    assert tel.flight.events() == []


def test_config_telemetry_and_metrics_server(tmp_path):
    """``FFConfig.telemetry`` enables the global telemetry at compile, its
    trace path gets the spans, and ``start_metrics_server`` serves them."""
    from flexflow_tpu_torch.models import checkpoint_store as cs

    d = str(tmp_path / "ckpt")
    cs.save_tiny_checkpoint("llama", d, seed=0, device="cpu")
    trace = str(tmp_path / "spans.jsonl")
    llm = fft.LLM.from_checkpoint(d).compile(
        device="cpu", telemetry=True, telemetry_trace_path=trace,
        max_requests_per_batch=2, max_seq_length=64,
        max_tokens_per_batch=16, kv_cache_dtype="float32")
    tel = ttel.get_telemetry()
    assert tel is not None
    res = llm.generate(PROMPTS, max_new_tokens=5)
    srv = llm.start_metrics_server(port=0)
    try:
        text = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=30
        ).read().decode()
    finally:
        llm.stop_metrics_server()
    assert "ffsv_requests_finished_total 2" in text
    assert "ffsv_tokens_generated_total 10" in text
    assert [len(r.output_tokens) for r in res] == [5, 5]
    # the load runner carries each request's trace id into its record
    schedule = tlg.build_schedule(tlg.WorkloadSpec(prompt_lens=(3,),
                                                   output_lens=(4,)),
                                  3, 100.0, seed=2)
    try:
        records = tlg.LoadRunner(llm).run(schedule, timeout_s=120.0)
    finally:
        llm.stop_server(flush_timeout_s=60.0)
    assert all(r.status == "ok" for r in records)
    tel.tracer.flush()
    evs = ttel.load_jsonl(trace)
    names = [e["name"] for e in evs]
    assert names.count("finish") == 5 and "decode_block" in names
    finish_ids = {e["args"]["trace_id"] for e in evs
                  if e["name"] == "finish"}
    assert {r.trace_id for r in records} <= finish_ids
    # the endpoint is gone with stop_metrics_server
    with socket.socket() as s:
        assert s.connect_ex(("127.0.0.1", srv.port)) != 0


def test_profiling_helpers(tmp_path):
    """``device_fence`` does nothing to CPU tensors and returns its
    argument; ``profiler_trace`` writes a loadable Chrome trace."""
    from flexflow_tpu_torch.utils.profiling import (device_fence,
                                                    profiler_trace)

    state = {"attn": {"k": torch.zeros(2, 3)}, "rows": [torch.ones(1)]}
    assert device_fence(state) is state
    path = str(tmp_path / "prof.json")
    with profiler_trace(path) as prof:
        torch.ones(64, 64).sum()
    assert prof.key_averages()
    with open(path) as f:
        assert "traceEvents" in json.load(f)


# ----------------------------------------------------------------------
# 5. flight-recorder reports across the packages
# ----------------------------------------------------------------------
@pytest.mark.parametrize("writer,reader", [(tfr, jfr), (jfr, tfr)])
def test_incident_report_loads_in_the_other_package(writer, reader,
                                                    tmp_path):
    clock = iter(range(100)).__next__
    fr = writer.FlightRecorder(capacity=3, clock=lambda: float(clock()))
    for i in range(5):
        fr.record("round", guid=i, n_acc=i % 3)
    path = fr.dump(str(tmp_path / "incident.jsonl"),
                   header={"replica": 1, "error": "EngineFault: x"})
    header, events = reader.load_incident_report(path)
    assert header["kind"] == "incident" and header["replica"] == 1
    assert header["n_events"] == 3
    assert [e["guid"] for e in events] == [2, 3, 4]
    with open(path, "a") as f:
        f.write(json.dumps({"kind": "round"}) + "\n")
    with pytest.raises(ValueError):
        reader.load_incident_report(path)
