"""Closed-loop load harness CLI: drive the serving stack with seeded
arrival-driven traffic and print the live-SLO knee sweep (counterpart of
the repository's ``tools/loadtest.py``; ``--device`` picks the card, the
default, or the CPU).

Builds a tiny or small-geometry LLaMA serving model (seeded weights),
replays a seeded Poisson (or fixed-rate) schedule per offered-load step
through the background-server submission queue, and prints per step:
offered vs achieved req/s, throughput and goodput tokens/s, TTFT /
request-latency p50/p99, and the queue-wait vs service decomposition —
then the saturation knee (max sustained req/s under the TTFT p99 bound).

Examples::

    python -m flexflow_tpu_torch.tools.loadtest --seed 0 --rate 4 --steps 3
    python -m flexflow_tpu_torch.tools.loadtest --rate 2 --steps 4 \
        --step-mult 2 --requests 16 --deadline 5 --p99-bound 2.0 --spec
    python -m flexflow_tpu_torch.tools.loadtest --rate 8 --steps 3 \
        --closed 8 --json out.json --device cpu
    python -m flexflow_tpu_torch.tools.loadtest --rate 8 --metrics-port 9600
    python -m flexflow_tpu_torch.tools.loadtest --spike --replicas 2 \
        --crash-after 6 --quantize int8

``--metrics-port`` starts the /metrics endpoint during the run so a
scraper (or curl) can watch the sliding-window SLO summaries move under
load — the live view the whole-run report below aggregates.
"""

import argparse
import json
import os
import sys
import time

GEOMETRIES = {
    # name: (vocab, hidden, inter, layers, heads, kv_heads, max_seq)
    "tiny": (128, 64, 128, 2, 4, 2, 64),
    "small": (512, 128, 256, 4, 4, 4, 256),
}


def build_handle(args):
    """(EngineHandle, vocab) of the ``--geometry`` LLaMA on ``--device``,
    its weights drawn from ``--seed``; with ``--spec`` a 1-layer draft
    on the verifier's tensors."""
    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.ffconst import InferenceMode
    from flexflow_tpu_torch.models.llama import (LLAMAConfig,
                                                 create_llama_model)
    from flexflow_tpu_torch.serve.loadgen import EngineHandle

    vocab, hidden, inter, layers, heads, kv, max_seq = GEOMETRIES[args.geometry]
    mcfg = LLAMAConfig(vocab_size=vocab, hidden_size=hidden,
                       intermediate_size=inter, num_hidden_layers=layers,
                       num_attention_heads=heads, num_key_value_heads=kv,
                       max_position_embeddings=max_seq)
    cfg = ff.FFConfig(device=args.device,
                      max_requests_per_batch=args.slots,
                      max_sequence_length=max_seq,
                      max_tokens_per_batch=4 * args.slots,
                      seed=args.seed, kv_cache_dtype="float32")

    def build(mode, n_layers=None):
        mc = mcfg if n_layers is None else LLAMAConfig(
            **{**mcfg.__dict__, "num_hidden_layers": n_layers})
        m = ff.FFModel(cfg)
        create_llama_model(m, mc, mode=mode)
        return m.compile()

    if args.spec:
        llm = build(InferenceMode.TREE_VERIFY_MODE)
        ssm = build(InferenceMode.BEAM_SEARCH_MODE, n_layers=1)
        for lname, lp in ssm.params.items():
            if lname in llm.params:
                for w in lp:
                    ssm.params[lname][w] = llm.params[lname][w]
        return EngineHandle(llm, ssms=[ssm], spec_depth=args.spec_depth), vocab
    return EngineHandle(build(InferenceMode.INC_DECODING_MODE)), vocab


def _write_fleet_checkpoint(args):
    """Build one model at the CLI geometry and save it as the fleet's
    HF-layout disk checkpoint (reused if the dir already holds one)."""
    import tempfile

    from flexflow_tpu_torch.models.checkpoint_store import (CONFIG_NAME,
                                                            save_checkpoint)

    ckpt = args.checkpoint_dir or tempfile.mkdtemp(prefix="fleet_ckpt_")
    if os.path.exists(os.path.join(ckpt, CONFIG_NAME)):
        return ckpt
    import flexflow_tpu_torch as ff
    from flexflow_tpu_torch.ffconst import InferenceMode
    from flexflow_tpu_torch.models.llama import (LLAMAConfig,
                                                 create_llama_model)

    vocab, hidden, inter, layers, heads, kv, max_seq = \
        GEOMETRIES[args.geometry]
    mcfg = LLAMAConfig(vocab_size=vocab, hidden_size=hidden,
                       intermediate_size=inter, num_hidden_layers=layers,
                       num_attention_heads=heads, num_key_value_heads=kv,
                       max_position_embeddings=max_seq)
    cfg = ff.FFConfig(device=args.device, max_requests_per_batch=2,
                      max_sequence_length=max_seq, max_tokens_per_batch=16,
                      seed=args.seed, kv_cache_dtype="float32")
    model = ff.FFModel(cfg)
    create_llama_model(model, mcfg, mode=InferenceMode.INC_DECODING_MODE)
    model.compile()
    save_checkpoint(model, "llama", mcfg, ckpt)
    return ckpt


def _spike_main(args, tenants):
    """--spike: checkpoint -> pool -> (optional crash) -> base/spike run
    with the queue-triggered autoscaler."""
    from flexflow_tpu_torch.serve.loadgen import WorkloadSpec
    from flexflow_tpu_torch.serve.replica import (
        ReplicaPool, checkpoint_replica_factory, failover_run, spike_run)

    vocab, _, _, _, _, _, max_seq = GEOMETRIES[args.geometry]
    t0 = time.perf_counter()
    ckpt = _write_fleet_checkpoint(args)
    print(f"# fleet checkpoint at {ckpt} "
          f"({time.perf_counter() - t0:.1f}s)", file=sys.stderr)
    spec = WorkloadSpec(
        prompt_lens=tuple(int(x) for x in args.prompt_lens.split(",")),
        output_lens=tuple(int(x) for x in args.output_lens.split(",")),
        tenants=tenants, vocab_size=vocab)
    factory = checkpoint_replica_factory(ckpt, slots=args.slots,
                                         max_seq=max_seq,
                                         quantize=args.quantize,
                                         seed_base=7000 + args.seed,
                                         device=args.device)
    pool = ReplicaPool(factory, n_replicas=args.replicas)
    t0 = time.perf_counter()
    pool.start_server()
    starts = pool.stats()["cold_starts_s"]
    print(f"# pool up: {args.replicas} replica(s) in "
          f"{time.perf_counter() - t0:.1f}s, cold starts {starts}",
          file=sys.stderr)
    out = {"checkpoint_dir": ckpt, "quantize": args.quantize,
           "initial_cold_starts_s": starts}
    try:
        if args.crash_after > 0:
            fo = failover_run(pool, spec, rate_rps=args.rate,
                              n_requests=args.requests, seed=args.seed,
                              crash_after=args.crash_after,
                              process=args.arrivals,
                              timeout_s=args.timeout)
            out["failover"] = fo
            print(f"crash: replica 0 after {args.crash_after} calls -> "
                  f"resolved {fo['resolved_fraction']:.3f}, "
                  f"{fo['n_failed_over']} failed over "
                  f"({fo['failovers_total']} re-dispatches), recovery "
                  f"{fo['failover_recovery_s']}s, respawn cold start "
                  f"{fo['cold_start_s']}s")
        sp = spike_run(pool, spec, base_rps=args.rate,
                       spike_multiple=args.spike_mult,
                       n_base=args.requests, n_spike=2 * args.requests,
                       seed=args.seed, process=args.arrivals,
                       timeout_s=args.timeout)
        out["spike"] = sp
        print(f"spike: {sp['base_rps']:.2f} -> {sp['spike_rps']:.2f} req/s; "
              f"scaled_up={sp['scaled_up']} "
              f"(trigger at {sp['scale_trigger_s']}s, outstanding >= "
              f"{sp['scale_threshold']}), cold_start_s={sp['cold_start_s']}, "
              f"slo_violation_s={sp['slo_violation_s']}")
        print(f"spike phase: resolved {sp['spike']['resolved_fraction']:.3f}, "
              f"lat p99 {sp['spike']['latency_p99_s']}s, replicas "
              f"{sp['n_replicas_before']} -> {sp['n_replicas_after']}")
    finally:
        pool.stop_server()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
        print(f"# wrote {args.json}", file=sys.stderr)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="closed-loop serving load harness with SLO knee sweep")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rate", type=float, default=4.0,
                    help="offered load of the FIRST step (req/s)")
    ap.add_argument("--steps", type=int, default=3,
                    help="number of offered-load steps")
    ap.add_argument("--step-mult", type=float, default=2.0,
                    help="rate multiplier between steps")
    ap.add_argument("--requests", type=int, default=8,
                    help="requests per step")
    ap.add_argument("--arrivals", choices=("poisson", "uniform"),
                    default="poisson")
    ap.add_argument("--closed", type=int, default=None, metavar="K",
                    help="closed-loop concurrency cap (default: open loop)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request completion deadline (s) for goodput")
    ap.add_argument("--p99-bound", type=float, default=5.0,
                    help="TTFT p99 bound (s) defining the knee")
    ap.add_argument("--geometry", choices=sorted(GEOMETRIES), default="tiny")
    ap.add_argument("--slots", type=int, default=4,
                    help="max_requests_per_batch")
    ap.add_argument("--spec", action="store_true",
                    help="serve speculatively (1-layer truncation draft)")
    ap.add_argument("--spec-depth", type=int, default=2)
    ap.add_argument("--prompt-lens", default="4,8,16")
    ap.add_argument("--output-lens", default="4,8,16")
    ap.add_argument("--tenants", default="default:1",
                    help="comma list of name:weight[:deadline_s[:priority]]")
    ap.add_argument("--overload", action="store_true",
                    help="after the sweep, drive the engine at "
                         "--overload-mult x the measured knee behind a "
                         "bounded admission policy and print the "
                         "shed/goodput table")
    ap.add_argument("--overload-mult", type=float, default=2.0)
    ap.add_argument("--spike", action="store_true",
                    help="fleet mode: serve a replica pool "
                         "cold-started from a disk checkpoint, optionally "
                         "crash one replica mid-run (--crash-after), then "
                         "drive a base->spike traffic step; an autoscaler "
                         "spins up a replica at the MEASURED cold-start "
                         "delay and the report shows cold_start_s + "
                         "SLO-violation-seconds during scale-out")
    ap.add_argument("--replicas", type=int, default=1,
                    help="initial pool size for --spike")
    ap.add_argument("--spike-mult", type=float, default=8.0,
                    help="spike rate = --rate x this")
    ap.add_argument("--quantize", default=None,
                    help="quantize-on-load for --spike replicas "
                         "(int8 | int4)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="reuse/write the fleet checkpoint here "
                         "(default: a temp dir)")
    ap.add_argument("--crash-after", type=int, default=0, metavar="N",
                    help="with --spike: before the spike, crash replica 0 "
                         "on its N-th engine call and report the failover "
                         "(0 = no crash)")
    ap.add_argument("--overload-requests", type=int, default=None,
                    help="requests in the overload run (default: "
                         "2 x --requests)")
    ap.add_argument("--queue-cap", type=int, default=None,
                    help="admission max_queue_depth for the overload run "
                         "(default: 4 x slots)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the sweep result as JSON")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="expose /metrics (live sliding-window SLOs) "
                         "during the run")
    args = ap.parse_args(argv)

    from flexflow_tpu_torch.serve.loadgen import (TenantSpec, WorkloadSpec,
                                                  format_report, sweep)
    from flexflow_tpu_torch.telemetry import ensure_telemetry

    tel = ensure_telemetry()
    srv = None
    if args.metrics_port is not None:
        from flexflow_tpu_torch.telemetry import MetricsHTTPServer

        srv = MetricsHTTPServer(lambda: tel.registry, port=args.metrics_port)
        print(f"# /metrics on http://{srv.host}:{srv.port}/metrics",
              file=sys.stderr)

    tenants = []
    for part in args.tenants.split(","):
        bits = part.split(":")
        tenants.append(TenantSpec(
            name=bits[0], weight=float(bits[1]) if len(bits) > 1 else 1.0,
            deadline_s=float(bits[2]) if len(bits) > 2 else args.deadline,
            priority=int(bits[3]) if len(bits) > 3 else 0))

    if args.spike:
        spec_tenants = tuple(tenants)
        try:
            return _spike_main(args, spec_tenants)
        finally:
            if srv is not None:
                srv.stop()

    t0 = time.perf_counter()
    handle, vocab = build_handle(args)
    print(f"# model built in {time.perf_counter() - t0:.1f}s "
          f"({args.geometry}, {'spec' if args.spec else 'incr'})",
          file=sys.stderr)
    spec = WorkloadSpec(
        prompt_lens=tuple(int(x) for x in args.prompt_lens.split(",")),
        output_lens=tuple(int(x) for x in args.output_lens.split(",")),
        tenants=tuple(tenants), vocab_size=vocab)
    rates = [args.rate * args.step_mult ** i for i in range(args.steps)]
    overload = None
    try:
        result = sweep(handle, spec, rates, args.requests, seed=args.seed,
                       process=args.arrivals,
                       closed_concurrency=args.closed,
                       p99_ttft_bound_s=args.p99_bound,
                       timeout_s=args.timeout)
        if args.overload:
            from flexflow_tpu_torch.serve.admission import AdmissionPolicy
            from flexflow_tpu_torch.serve.loadgen import overload_run

            knee = result.get("knee_rps") or rates[0]
            policy = AdmissionPolicy(
                max_queue_depth=(args.queue_cap if args.queue_cap
                                 is not None else 4 * args.slots))
            overload = overload_run(
                handle, spec, knee, multiple=args.overload_mult,
                n_requests=args.overload_requests or 2 * args.requests,
                seed=args.seed, process=args.arrivals,
                timeout_s=args.timeout, admission=policy)
    finally:
        handle.stop_server()
        if srv is not None:
            srv.stop()
    print(format_report(result))
    if result["steps"] and "per_tenant" in result["steps"][-1]:
        print("per-tenant (last step): "
              + json.dumps(result["steps"][-1]["per_tenant"]))
    if overload is not None:
        rep = overload["report"]
        print(f"overload: {overload['offered_rps']:.2f} req/s "
              f"({overload['offered_multiple']:.1f}x knee "
              f"{overload['knee_rps']:.2f}) -> priority goodput "
              f"{overload['priority_goodput']:.3f} "
              f"(tenants {overload['priority_tenants']}), "
              f"resolved {overload['resolved_fraction']:.3f}, "
              f"best-effort shed {overload['besteffort_shed_fraction']:.3f}")
        print(f"overload mix: ok={rep['n_ok']} rejected={rep['n_rejected']} "
              f"timed_out={rep['n_timed_out']} "
              f"cancelled={rep['n_cancelled']} errors={rep['n_errors']}; "
              f"admission {json.dumps(overload['admission'])}")
        if "per_tenant" in rep:
            print("overload per-tenant: " + json.dumps(rep["per_tenant"]))
    if args.json:
        out = dict(result)
        if overload is not None:
            out["overload"] = overload
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
        print(f"# wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
