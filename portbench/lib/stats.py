"""Order statistics of the benchmark's end-to-end and per-layer metrics.

Every percentile is taken over all the samples given (every request or
step of a window), never over medians of groups."""

from __future__ import annotations

import math
import statistics


def percentile(values, q: float) -> float | None:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    two nearest order statistics (numpy's default, ``method="linear"``);
    None for no values."""
    xs = sorted(values)
    if not xs:
        return None
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile {q} outside 0..100")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return float(xs[lo] + (xs[hi] - xs[lo]) * (pos - lo))


def median(values) -> float | None:
    return percentile(values, 50.0)


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of
    the median (``statistics.quantiles(values, n=4)``, its default
    exclusive method): how the bounds of ``BENCHMARK.json`` were set."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
