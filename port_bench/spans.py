"""The program's own spans (whisper_tpu_torch/runtime/trace.py) in a run's
window.  The program records them while a `torch.profiler` session runs,
which a traced run starts, on CLOCK_MONOTONIC: the clock of `run.t0` and
`run.t1` (time.monotonic()) and of the device trace's alignment.  A
program without the tracer, or a window without a span, gives nothing, and
each reader then returns None."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Tuple


def recorded() -> list:
    """Every span the program recorded ([] for a program without them)."""
    try:
        from whisper_tpu_torch.runtime import trace
    except ImportError:
        return []
    return trace.snapshot()


def _ns(run) -> Tuple[int, int]:
    return int(run.t0 * 1e9), int(run.t1 * 1e9)


def ended(run, name: str) -> list:
    """The spans of `name` that end inside [run.t0, run.t1]."""
    a, b = _ns(run)
    return [s for s in recorded() if s.name == name and a <= s.t1 <= b]


def mean_ms(run, name: str) -> Optional[float]:
    """Mean duration of the spans of `name` ended in the window, in ms."""
    sel = ended(run, name)
    return sum(s.t1 - s.t0 for s in sel) / len(sel) / 1e6 if sel else None


def children(spans: Iterable) -> Dict[int, list]:
    """{parent sid: its child spans}."""
    out = defaultdict(list)
    for s in spans:
        if s.parent:
            out[s.parent].append(s)
    return out


def union_ns(intervals: Iterable[Tuple[int, int]], a: int, b: int) -> int:
    """Length of the union of the intervals, clipped to [a, b]."""
    total, reach = 0, a
    for s, e in sorted((max(s, a), min(e, b)) for s, e in intervals):
        if e <= reach:
            continue
        total += e - max(s, reach)
        reach = e
    return total


def self_ns(span, kids: List) -> int:
    """A span's duration less the part of it its children cover."""
    return (span.t1 - span.t0) - union_ns(((c.t0, c.t1) for c in kids), span.t0, span.t1)


def covered_share(run, name: str) -> Optional[float]:
    """Share of [run.t0, run.t1] covered by the spans of `name` that
    overlap it, or None when none does."""
    a, b = _ns(run)
    sel = [(s.t0, s.t1) for s in recorded() if s.name == name and s.t1 > a and s.t0 < b]
    return union_ns(sel, a, b) / (b - a) if sel else None
