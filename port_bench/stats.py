"""Arithmetic of the end-to-end numbers: step intervals, percentiles and
window rates."""

from __future__ import annotations

import statistics
from typing import List, Sequence


def intervals(start_ms: float, ends_ms: Sequence[float]) -> List[float]:
    """Step times: from the window's start to the first step's end, then
    between consecutive step ends."""
    out, prev = [], start_ms
    for t in ends_ms:
        out.append(t - prev)
        prev = t
    return out


def percentile(values: Sequence[float], pct: int) -> float:
    """The ``pct``-th percentile, interpolated between the two nearest
    ranks (``statistics.quantiles``' inclusive method)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=100, method="inclusive")[pct - 1]


def rate(units: float, window_ms: float) -> float:
    """Units per second of a window of ``window_ms``."""
    return units / (window_ms / 1e3)
