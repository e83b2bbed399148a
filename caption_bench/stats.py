"""The benchmark's statistics: nearest-rank percentiles, whole-window rates
and the quartile spread that bounds are set from."""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least q% of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    ordered = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def rate(count: float, seconds: float) -> float:
    """Work completed in a window over the window's seconds."""
    if seconds <= 0:
        raise ValueError("a window of no length")
    return count / seconds


def spread(values: Sequence[float]) -> float:
    """Distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``, its default method)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
