"""Rate and percentile arithmetic over the load generator's records.

A record is (rid, audio seconds, due, sent, done, status, text) on
CLOCK_MONOTONIC.  A request belongs to the window when its response was
read inside it; its latency runs from its due time (in a closed loop, the
time its client sent it) to then.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

Record = Tuple[str, float, float, float, float, int, str]


def in_window(records: Sequence[Record], t0: float, t1: float) -> List[Record]:
    return [r for r in records if t0 <= r[4] <= t1]


def audio_rate(records: Sequence[Record], t0: float, t1: float) -> float:
    """Seconds of audio in every request answered inside [t0, t1] over the
    window's seconds: all the work over all the time."""
    done = [r for r in in_window(records, t0, t1) if r[5] == 200]
    return sum(r[1] for r in done) / (t1 - t0)


def latencies(records: Sequence[Record], t0: float, t1: float) -> List[float]:
    return sorted(r[4] - r[2] for r in in_window(records, t0, t1))


def percentile(values: Sequence[float], q: float) -> float:
    """The nearest-rank percentile: the smallest value with at least a
    share q of the values at or below it."""
    if not values:
        raise ValueError("no values")
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def beyond(n: int, q: float) -> int:
    """How many of n samples lie beyond the nearest-rank q percentile."""
    return n - max(1, math.ceil(q * n))
