"""Measured searched-vs-DP A/B: the wall-clock check on the Unity search
(counterpart of ``flexflow_tpu/search/measure.py``).

The search's "advantage" numbers are analytic (its own cost model grading
its own homework). This module closes the loop the way the reference's
headline does (Unity OSDI'22 reports MEASURED speedup, README.md:68): it
compiles the SAME model under (a) the searched strategy, (b) forced pure
data-parallelism, and (c) a sequence-only search (nonsequence splits
disabled), runs real train steps over the process group's ranks (every
rank calls these functions, as it calls ``compile``), and reports
wall-clock seconds per step next to the analytic costs.

Timing: ``train_one_batch`` returns ``float(loss)``, a host readback of
the loss, which is the fence. Per-step times are min-of-reps over a timed
block of steps after warmup.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple


def wallclock_train(build_model: Callable[[], object], strategy, xs, ys,
                    steps: int = 6, reps: int = 3, lr: float = 0.01
                    ) -> Tuple[float, object]:
    """Compile ``build_model()`` under a FORCED ``strategy`` (no search)
    and wall-clock ``steps`` train steps, ``reps`` times, returning
    (best seconds/step, model). ``strategy=None`` compiles whatever the
    model's config dictates (its degrees' default layout)."""
    import flexflow_tpu_torch as ff

    model = build_model()
    model.config.auto_parallel = False   # the strategy is given, not searched
    model.strategy = strategy            # compile adopts strategy.axis_degrees
    model.compile(
        optimizer=ff.SGDOptimizer(model, lr),
        loss_type=ff.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY)
    for _ in range(2):                   # compile + warm
        model.train_one_batch([x for x in xs], ys)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(steps):
            model.train_one_batch([x for x in xs], ys)
        best = min(best, (time.perf_counter() - t0) / steps)
    return best, model


def searched_vs_dp_wallclock(build_model: Callable[[], object], xs, ys,
                             chip: str = "h100-sxm",
                             num_devices: Optional[int] = None,
                             steps: int = 6, reps: int = 3,
                             variants: Tuple[str, ...] = ("searched", "dp",
                                                          "seq_only")
                             ) -> Dict[str, Dict[str, float]]:
    """The A/B: analytic cost AND measured wall-clock for each variant.

    Variants:
      searched — the full Unity search (nonsequence splits included)
      dp       — forced canonical pure data-parallelism over ALL devices
      seq_only — the search with nonsequence (branch) splits disabled

    Returns {variant: {"analytic": s, "wallclock": s}}. The strategies
    are chosen under the ``chip`` analytic machine model but EXECUTED on
    the process group's ranks, whatever devices they run on: ranks that
    share one card (or the CPU) give a structural check (does the searched
    placement run at all, and no slower than DP?), not a parallel speed."""
    from flexflow_tpu_torch.search.graph_search import (
        data_parallel_model_strategy, optimize_model)

    out: Dict[str, Dict[str, float]] = {}
    for variant in variants:
        probe = build_model()
        n = (num_devices if num_devices is not None
             else probe.config.resolve_num_devices())
        if variant == "dp":
            strat = data_parallel_model_strategy(probe, chip=chip,
                                                 num_devices=n)
            if strat is None:
                raise ValueError(
                    f"no canonical DP strategy for this model over {n} "
                    "devices (batch dim not divisible) — the A/B has no "
                    "meaningful DP baseline")

            def build_dp():
                m = build_model()
                # pure DP uses the whole device set on the data axis
                m.config.data_parallelism_degree = n
                m.config.tensor_parallelism_degree = 1
                m.config.expert_parallelism_degree = 1
                return m

            builder = build_dp
        else:
            # the searched variant gets the FULL Unity space, including
            # the mesh factorization (so it can pick pure DP when DP is
            # genuinely best instead of losing inside a pinned dp x tp)
            strat = optimize_model(
                probe, chip=chip, num_devices=n,
                enable_nonsequence=(variant == "searched"),
                search_mesh=True)
            builder = build_model
        sec, _model = wallclock_train(builder, strat, xs, ys,
                                      steps=steps, reps=reps)
        out[variant] = {"analytic": float(strat.cost) if strat else -1.0,
                        "wallclock": sec}
    return out


def format_ab(name: str, res: Dict[str, Dict[str, float]]) -> str:
    """One printable line: measured ratios next to analytic ones."""
    parts = [name]
    for v, d in res.items():
        parts.append(f"{v}: analytic={d['analytic']:.3e}s "
                     f"wallclock={d['wallclock'] * 1e3:.1f}ms")
    if "dp" in res and "searched" in res:
        aa = res["dp"]["analytic"] / max(res["searched"]["analytic"], 1e-30)
        ww = res["dp"]["wallclock"] / max(res["searched"]["wallclock"], 1e-30)
        parts.append(f"advantage analytic={aa:.2f}x MEASURED={ww:.2f}x")
    return " | ".join(parts)
