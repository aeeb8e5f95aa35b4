"""End-to-end arithmetic over a window's timeline of calls.

A call is (start_s, end_s, items) on the host clock: items are frames for
inference and samples for training. A rate is all the items over all the
window (the first call's start to the last call's end), so a stall
anywhere in the window lowers it; a percentile is over every call's
latency, each call's own items counted once per call.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

Call = Tuple[float, float, int]


def window_s(calls: Sequence[Call]) -> float:
    return calls[-1][1] - calls[0][0]


def rate(calls: Sequence[Call]) -> float:
    """Items per second over the whole window."""
    return sum(c[2] for c in calls) / window_s(calls)


def latencies_ms(calls: Sequence[Call]) -> List[float]:
    return [(e - s) * 1e3 for s, e, _ in calls]


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0-100) with linear interpolation between
    closest ranks (numpy's default rule)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
