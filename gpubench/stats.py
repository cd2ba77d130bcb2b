"""The arithmetic of the end-to-end metrics: one rate over a whole window,
and a percentile over every sample."""
from __future__ import annotations

import math
from typing import Sequence


def rate(amount: float, seconds: float) -> float:
    """amount / seconds: one rate over the whole window, never a median of
    pieces."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s")
    return amount / seconds


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 <= q <= 100) of every value, interpolated
    linearly between order statistics (position q / 100 * (N - 1))."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    pos = q / 100.0 * (len(xs) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mean(values: Sequence[float]) -> float:
    if not values:
        raise ValueError("no values")
    return sum(values) / len(values)
