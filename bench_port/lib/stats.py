"""Statistics over a window's samples."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q <= 100) by nearest rank over every value:
    the smallest value with at least q% of the values at or below it."""
    ordered = sorted(values)
    if not ordered:
        raise ValueError("percentile of no values")
    rank = max(1, math.ceil(q / 100.0 * len(ordered)))
    return ordered[rank - 1]


def mean(values) -> float:
    values = list(values)
    if not values:
        raise ValueError("mean of no values")
    return sum(values) / len(values)
