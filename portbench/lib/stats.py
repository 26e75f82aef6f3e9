"""The statistics of the end-to-end metrics."""

from __future__ import annotations

import math
from typing import Sequence, Tuple


def p95(values: Sequence[float]) -> float:
    """The 95th percentile by nearest rank: the ceil(0.95 n)-th smallest."""
    if not values:
        raise ValueError("p95 of no values")
    ordered = sorted(values)
    return ordered[max(1, math.ceil(0.95 * len(ordered))) - 1]


def rate(items: float, spans: Sequence[Tuple[float, float]]) -> float:
    """Items completed per second over the time from the first start to the
    last completion of the (start, end) spans."""
    if not spans:
        raise ValueError("a rate over no spans")
    return items / (max(e for _, e in spans) - min(s for s, _ in spans))
