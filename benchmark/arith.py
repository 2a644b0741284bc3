"""Rates and tails, each over every request of the window."""

from __future__ import annotations

import math


def rate(count: int, seconds: float) -> float | None:
    """Requests completed per second of the whole window."""
    if seconds <= 0 or count <= 0:
        return None
    return count / seconds


def percentile(values, q: float) -> float | None:
    """The nearest-rank q-th percentile (0 < q <= 100): the smallest
    value with at least q% of all values at or below it."""
    vals = sorted(values)
    if not vals:
        return None
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]
