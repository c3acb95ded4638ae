"""Fault-injection harness CLI: prove the serving stack's failure paths
(counterpart of the repository's ``tools/faulttest.py``; ``--device``
picks the card, the default, or the CPU).

Builds the same tiny/small serving model as ``tools/loadtest.py``, then
runs the seeded chaos harness (``serve/faultinject.py``):
injected engine-step exceptions (with automatic server restart), step
stalls long enough to trip request timeouts, queue-full bursts against a
bounded admission policy, and mid-stream cancellations — and checks the
invariant that every submitted future resolves within a bounded wall
clock with no leaked slots or waiters.

Exit status is 0 only when the invariant held (``problems`` empty).

Examples::

    python -m flexflow_tpu_torch.tools.faulttest --requests 16
    python -m flexflow_tpu_torch.tools.faulttest --error-every 7 \
        --max-errors 2 --spec
    python -m flexflow_tpu_torch.tools.faulttest --stall-every 3 \
        --stall 0.05 --timeout-fraction 0.5 --queue-cap 4 --device cpu
"""

import argparse
import json
import sys

from flexflow_tpu_torch.tools.loadtest import GEOMETRIES, build_handle


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="seeded fault-injection harness for the serving stack")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new-tokens", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=4)
    ap.add_argument("--geometry", choices=sorted(GEOMETRIES), default="tiny")
    ap.add_argument("--slots", type=int, default=4,
                    help="max_requests_per_batch")
    ap.add_argument("--spec", action="store_true",
                    help="serve speculatively (1-layer truncation draft)")
    ap.add_argument("--spec-depth", type=int, default=2)
    ap.add_argument("--error-every", type=int, default=5,
                    help="raise an injected EngineFault every N device "
                         "calls (0 = never)")
    ap.add_argument("--max-errors", type=int, default=1)
    ap.add_argument("--stall-every", type=int, default=0,
                    help="stall every N device calls (0 = never)")
    ap.add_argument("--stall", type=float, default=0.02,
                    help="stall duration (s)")
    ap.add_argument("--cancel-fraction", type=float, default=0.25)
    ap.add_argument("--timeout-fraction", type=float, default=0.25)
    ap.add_argument("--timeout", type=float, default=0.05,
                    help="per-request timeout_s for the timeout subset")
    ap.add_argument("--queue-cap", type=int, default=None,
                    help="bound the admission queue (drives queue-full "
                         "burst rejections)")
    ap.add_argument("--bound", type=float, default=120.0,
                    help="wall-clock bound every future must resolve in")
    ap.add_argument("--no-restart", action="store_true",
                    help="do not restart the server after a fault")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the card) or cpu")
    ap.add_argument("--json", default=None, metavar="PATH")
    args = ap.parse_args(argv)

    from flexflow_tpu_torch.serve.admission import AdmissionPolicy
    from flexflow_tpu_torch.serve.faultinject import FaultInjector, run_chaos

    handle, vocab = build_handle(args)
    injector = FaultInjector(error_every=args.error_every,
                             stall_every=args.stall_every,
                             stall_s=args.stall,
                             max_errors=args.max_errors)
    injector.install(handle.ffmodel)
    for ssm in handle.ssms:
        injector.install(ssm.ffmodel)
    admission = (AdmissionPolicy(max_queue_depth=args.queue_cap)
                 if args.queue_cap is not None else None)
    report = run_chaos(handle, n_requests=args.requests, seed=args.seed,
                       injector=injector, prompt_len=args.prompt_len,
                       max_new_tokens=args.max_new_tokens, vocab=vocab,
                       cancel_fraction=args.cancel_fraction,
                       timeout_fraction=args.timeout_fraction,
                       timeout_s=args.timeout, admission=admission,
                       resolve_bound_s=args.bound,
                       restart_on_fault=not args.no_restart)
    print(json.dumps(report, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
        print(f"# wrote {args.json}", file=sys.stderr)
    if report["problems"]:
        print("FAULT INVARIANT VIOLATED:", "; ".join(report["problems"]),
              file=sys.stderr)
        return 1
    print(f"# ok: {report['n_requests']} futures resolved "
          f"({report['statuses']}), {report['restarts']} restart(s), "
          f"{report['wall_s']}s", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
