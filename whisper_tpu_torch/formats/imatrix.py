"""Importance-matrix (imatrix) file format + activation collector.

The IQ1/IQ2/IQ3 quantizers weight their codebook searches by per-input-
channel activation statistics.  The file format here is the llama.cpp
legacy imatrix binary (examples/imatrix — the de-facto ecosystem format,
readable by llama-quantize):

    i32 n_entries
    per entry: i32 name_len, name bytes,
               i32 ncall, i32 nval, f32 values[nval]
    i32 last_call, i32 input_len, input_desc bytes

`values` are SUMS of squared activations per input column; consumers
divide by ncall (our requant passes values/ncall ratios straight through —
the quantizers only use relative weights, and ggml_quantize_chunk receives
exactly `values/ncall` from llama-quantize, so we do the same division in
`load_imatrix`).

Capture: `Collector` + `model.CapturedWeight` wrap the matmul weights of
an EAGER forward pass (tools/make_imatrix.py) — the TPU-native analogue of
llama.cpp's eval-callback capture.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Dict

import numpy as np


def save_imatrix(path: str, sums: Dict[str, np.ndarray],
                 ncalls: Dict[str, int], input_desc: str = "") -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(sums)))
        last_call = 0
        for name, vals in sums.items():
            nb = name.encode("utf-8")
            vals = np.asarray(vals, np.float32)
            nc = int(ncalls.get(name, 1))
            last_call = max(last_call, nc)
            f.write(struct.pack("<i", len(nb)))
            f.write(nb)
            f.write(struct.pack("<ii", nc, vals.size))
            f.write(vals.astype("<f4").tobytes())
        db = input_desc.encode("utf-8")
        f.write(struct.pack("<i", last_call))
        f.write(struct.pack("<i", len(db)))
        f.write(db)


def load_imatrix(path: str) -> Dict[str, np.ndarray]:
    """Returns {tensor name -> mean squared activation per column}
    (values / ncall — what ggml_quantize_chunk receives)."""
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        (n_entries,) = struct.unpack("<i", f.read(4))
        for _ in range(n_entries):
            (ln,) = struct.unpack("<i", f.read(4))
            name = f.read(ln).decode("utf-8")
            ncall, nval = struct.unpack("<ii", f.read(8))
            vals = np.frombuffer(f.read(4 * nval), "<f4").astype(np.float32)
            out[name] = vals / np.float32(max(1, ncall))
    return out


class Collector:
    """Accumulates per-column sum-of-squares of matmul inputs."""

    def __init__(self):
        self.sums: Dict[str, np.ndarray] = {}
        self.ncalls: Dict[str, int] = {}

    def add(self, names, x) -> None:
        """`x`: the activation feeding a weight matmul, last dim = in
        channels; `names`: the file tensor name(s) sharing that input
        (the fused q/k/v projections read the same activation)."""
        xs = np.asarray(x, np.float32).reshape(-1, np.asarray(x).shape[-1])
        ss = (xs * xs).sum(axis=0)
        for name in ([names] if isinstance(names, str) else names):
            if name in self.sums:
                self.sums[name] += ss
            else:
                self.sums[name] = ss.copy()
            self.ncalls[name] = self.ncalls.get(name, 0) + xs.shape[0]
