"""Metric helpers of the port's telemetry (counterpart of
``flexflow_tpu/telemetry/metrics.py``): only ``percentile`` so far, which
the admission controller and the load generator share."""

from __future__ import annotations

import math
from typing import Sequence


def percentile(sorted_values: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile of an ASCENDING-sorted sequence
    (q in [0, 100]). Returns nan on empty input."""
    n = len(sorted_values)
    if n == 0:
        return float("nan")
    if n == 1:
        return float(sorted_values[0])
    pos = (q / 100.0) * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_values[lo] * (1 - frac) + sorted_values[hi] * frac)
