"""The arithmetic of the end-to-end metrics: whole-export window rates,
nearest-rank percentiles, and the preview's block clock."""

from __future__ import annotations

import math


def percentile(values, p: float) -> float:
    """The nearest-rank ``p``-th percentile: the smallest value with at least
    ``p`` % of the values at or below it."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(math.ceil(p / 100.0 * len(v)), 1) - 1]


def median(values) -> float:
    v = sorted(values)
    n = len(v)
    if not n:
        raise ValueError("no values")
    return v[n // 2] if n % 2 else 0.5 * (v[n // 2 - 1] + v[n // 2])


def window_rate(units) -> float:
    """Audio seconds of whole units per second of the window: from the
    first unit's start to the last unit's end (``units``: objects with
    ``start``, ``end`` and ``audio_seconds``, in order)."""
    if not units:
        raise ValueError("no units in the window")
    span = units[-1].end - units[0].start
    return sum(u.audio_seconds for u in units) / span


def next_issue(t0: float, period: float, returned: float) -> float:
    """The block clock: the first period boundary after ``returned``, on
    the grid ``t0 + k * period``. A pull that returns within its period is
    followed by the next boundary; one that overruns skips the boundaries
    it missed, as an audio callback does."""
    return t0 + (math.floor((returned - t0) / period) + 1) * period
