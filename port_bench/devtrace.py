"""The device trace of a traced run: `torch.profiler` with CUDA activity
alone (CUPTI records every kernel, copy and set, graph replays' kernels
included), reduced to intervals on the host's CLOCK_MONOTONIC.

Two marker kernels (`torch.cuda._sleep`) launched on an idle device at
known host times, one at each end of the window, give the offset between
the trace's clock and the host's at each end (the two drift apart by tens
of ppm); the spans the probe recorded then map onto the trace.  Busy
time is the union of the device intervals; a span's device time is the
part of that union inside the span.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

MARK_CYCLES = 2000


def start():
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def marker() -> Tuple[int, int]:
    """Launch a marker kernel on an idle device: (its host launch time on
    CLOCK_MONOTONIC, the same instant on the epoch clock), ns."""
    from whisper_tpu_torch.decoding.graphs import DEVICE_LOCK

    with DEVICE_LOCK:
        torch.cuda.synchronize()
        t, e = time.monotonic_ns(), time.time_ns()
        torch.cuda._sleep(MARK_CYCLES)
        torch.cuda.synchronize()
    return t, e


def _device_events(prof) -> List[Tuple[int, int, str]]:
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != torch.autograd.DeviceType.CUDA:
            continue
        st = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
        du = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
        out.append((int(st), int(st + du), e.name()))
    return out


def union(st: np.ndarray, en: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Merged, sorted intervals covering the given ones."""
    if len(st) == 0:
        return st, en
    o = np.argsort(st, kind="stable")
    st, en = st[o], en[o]
    reach = np.maximum.accumulate(en)
    new = np.r_[True, st[1:] > reach[:-1]]
    idx = np.flatnonzero(new)
    return st[idx], np.maximum.reduceat(en, idx)


def covered(u_st: np.ndarray, u_en: np.ndarray, a: float, b: float) -> float:
    """Length of the union's part inside [a, b]."""
    cum = np.r_[0, np.cumsum(u_en - u_st)]
    i = int(np.searchsorted(u_en, a, side="right"))
    j = int(np.searchsorted(u_st, b, side="left"))
    if i >= j:
        return 0.0
    return float(cum[j] - cum[i] - max(0, a - u_st[i]) - max(0, u_en[j - 1] - b))


@dataclass
class Trace:
    busy_s: float
    window_s: float
    span_device_s: Dict[str, float]       # device time inside spans, by kind
    span_count: Dict[str, int]            # spans inside the window, by kind
    decode_windows: List[list]            # per decode span in the window: its windows
    device_ops: List[list]                # [[name, seconds]] top 10
    idle_gaps: List[list]                 # [[what the host did, seconds]] top 10
    drift_us: float                       # marker offsets' disagreement
    n_events: int


def reduce(prof, marker0, marker1, spans) -> Optional[Trace]:
    """The trace of the window between the two markers (`marker()`'s
    values), or None when the trace holds no device event.  Without both
    marker kernels in the trace (CUPTI can drop records), the epoch clock
    read beside them stands in for the trace's (the profiler's timestamps
    are epoch ns)."""
    ev = _device_events(prof)
    if not ev:
        return None
    (mark0, epoch0), (mark1, epoch1) = marker0, marker1
    marks = sorted(s for s, _, n in ev if "spin" in n)
    if len(marks) >= 2:
        off0, off1 = marks[0] - mark0, marks[-1] - mark1
    else:
        print(f"trace: {len(marks)} marker kernels of 2 found; aligned by the epoch clock",
              file=sys.stderr)
        off0, off1 = epoch0 - mark0, epoch1 - mark1
    w0, w1 = mark0 + off0, mark1 + off1

    def to_trace(t: float) -> float:
        """A host time on the trace's clock: the offset moves linearly
        between the two markers (the clocks drift by tens of ppm)."""
        return t + off0 + (t - mark0) * (off1 - off0) / (mark1 - mark0)

    st = np.array([s for s, _, _ in ev], np.int64)
    en = np.array([e for _, e, _ in ev], np.int64)
    keep = (en > w0) & (st < w1)
    st, en = np.clip(st[keep], w0, w1), np.clip(en[keep], w0, w1)
    names = [n for (_, _, n), k in zip(ev, keep) if k]
    u_st, u_en = union(st, en)
    busy = float((u_en - u_st).sum())

    per_name = defaultdict(float)
    for s, e, n in zip(st, en, names):
        per_name[n] += e - s
    device_ops = [[n[:160], t / 1e9] for n, t in
                  sorted(per_name.items(), key=lambda kv: -kv[1])[:10]]

    span_s, span_n, dec = defaultdict(float), defaultdict(int), []
    in_window = []
    for kind, a, b, info in spans:
        a, b = to_trace(a), to_trace(b)
        if b <= w0 or a >= w1:
            continue
        in_window.append((kind, a, b))
        span_s[kind] += covered(u_st, u_en, max(a, w0), min(b, w1)) / 1e9
        span_n[kind] += 1
        if kind == "decode" and info is not None:
            dec.append(info)

    gaps = np.r_[u_st, w1] - np.r_[w0, u_en]
    g_st = np.r_[w0, u_en]
    top = np.argsort(-gaps)[:10]
    idle = []
    for k in top:
        if gaps[k] <= 0:
            continue
        mid = g_st[k] + gaps[k] / 2
        kinds = sorted({kind for kind, a, b in in_window if a <= mid <= b})
        idle.append(["+".join(kinds) if kinds else "between transcriptions (HTTP, WAV, client)",
                     float(gaps[k]) / 1e9])
    return Trace(busy_s=busy / 1e9, window_s=(w1 - w0) / 1e9, span_device_s=dict(span_s),
                 span_count=dict(span_n), decode_windows=dec, device_ops=device_ops,
                 idle_gaps=idle, drift_us=(off1 - off0) / 1e3, n_events=len(ev))
