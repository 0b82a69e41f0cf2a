"""Energy-based VAD + high-pass filter used by stream/command modes
(reference: examples/common.cpp:598-646)."""

from __future__ import annotations

import math

import numpy as np

SAMPLE_RATE = 16000


def high_pass_filter(data: np.ndarray, cutoff: float,
                     sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """First-order IIR high-pass, y[i] = a*(y[i-1] + x[i] - x[i-1])."""
    rc = 1.0 / (2.0 * math.pi * cutoff)
    dt = 1.0 / sample_rate
    alpha = dt / (rc + dt)
    x = np.asarray(data, np.float32)
    if len(x) == 0:
        return x
    # y[i] = alpha*y[i-1] + alpha*(x[i]-x[i-1]) — scan form; vectorized via
    # the standard recursive filter identity: y = alpha^i * cumulative form.
    # For exactness with the C loop we run lfilter-style with numpy:
    d = np.empty_like(x)
    d[0] = x[0]
    d[1:] = alpha * (x[1:] - x[:-1])
    # y[i] = alpha*y[i-1] + d[i]  (i >= 1), y[0] = x[0]
    y = np.empty_like(x)
    y[0] = x[0]
    # exact sequential recurrence via scaling trick is numerically unstable
    # for long buffers (alpha^-i overflows); buffers here are <= 30 s so a
    # chunked loop is fine and exact.
    acc = y[0]
    for i in range(1, len(x)):
        acc = alpha * acc + d[i]
        y[i] = acc
    return y


def vad_simple(pcm: np.ndarray, sample_rate: int, last_ms: int,
               vad_thold: float, freq_thold: float,
               verbose: bool = False) -> bool:
    """True when the last `last_ms` is quiet relative to the whole buffer
    (speech just ended) — examples/common.cpp:610-646."""
    n = len(pcm)
    n_last = sample_rate * last_ms // 1000
    if n_last >= n:
        return False
    x = np.asarray(pcm, np.float32)
    if freq_thold > 0.0:
        x = high_pass_filter(x, freq_thold, sample_rate)
    energy_all = float(np.abs(x).mean())
    energy_last = float(np.abs(x[n - n_last:]).mean())
    if verbose:
        print(f"vad_simple: energy_all: {energy_all:f}, energy_last: "
              f"{energy_last:f}, vad_thold: {vad_thold:f}, freq_thold: "
              f"{freq_thold:f}")
    return energy_last <= vad_thold * energy_all
