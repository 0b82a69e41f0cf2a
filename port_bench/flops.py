"""Operations and bytes that a window's inputs need, from the
configuration's widths, and the H100's published peaks.

Counts follow what the algorithm needs, not what an implementation runs:
weights are read once per call at their stored q5_0 size (22 bytes a
block of 32), the caches at the configuration's f16, and the decoder
counts the rows of real prompt tokens and the steps of the tokens chosen
(a window's last chosen token needs no decode after it), never padding,
bucket rows, finished lanes or steps run past a window's end.

`hp` holds the ggml header fields (model_file.hparams).
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

PEAK_FLOPS = 989e12     # bf16 dense, NVIDIA H100 SXM data sheet
PEAK_BYTES = 3.35e12    # HBM3, same sheet
Q5_0 = 22 / 32          # bytes a weight
F16 = 2


def encoder_flops(hp) -> float:
    """One 30 s window: the conv stem, every block, and the decoder's
    cross-attention K and V projections of the window's output (the
    program computes them with the encode, in one span)."""
    n, S, m = hp["n_audio_ctx"], hp["n_audio_state"], hp["n_mels"]
    conv = 2 * (2 * n) * S * (3 * m) + 2 * n * S * (3 * S)
    block = 2 * n * S * (3 * S + S + 8 * S) + 2 * 2 * n * n * S
    cross = hp["n_text_layer"] * 2 * (2 * n * S * hp["n_text_state"])
    return float(conv + hp["n_audio_layer"] * block + cross)


def encoder_bytes(hp) -> float:
    n, S, T = hp["n_audio_ctx"], hp["n_audio_state"], hp["n_text_state"]
    weights = (hp["n_audio_layer"] * 12 * S * S + hp["n_text_layer"] * 2 * S * T) * Q5_0
    conv = (3 * S * hp["n_mels"] + 3 * S * S) * F16
    io = hp["n_mels"] * 2 * n * 4 + hp["n_text_layer"] * 2 * n * T * F16
    return float(weights + conv + io)


def encoder_bound_s(hp) -> float:
    return max(encoder_flops(hp) / PEAK_FLOPS, encoder_bytes(hp) / PEAK_BYTES)


def row_flops(hp, ctx: int) -> float:
    """One decoder token row attending `ctx` cached positions."""
    S, L = hp["n_text_state"], hp["n_text_layer"]
    per_layer = 28 * S * S + 4 * S * ctx + 4 * S * hp["n_audio_ctx"]
    return float(L * per_layer + 2 * S * hp["n_vocab"])


def weight_bytes(hp) -> float:
    S = hp["n_text_state"]
    return (hp["n_text_layer"] * 14 * S * S + hp["n_vocab"] * S) * Q5_0


def _kv_bytes(hp, ctx: int) -> float:
    """The cross K/V a window's rows read and its self K/V cache."""
    S, L = hp["n_text_state"], hp["n_text_layer"]
    return L * 2 * (hp["n_audio_ctx"] + ctx) * S * F16


def pass_bound_s(hp, rows: Iterable[Tuple[int, int]]) -> float:
    """One decoder call over windows given as (rows, context at the last
    row): the larger of its operations and its bytes over the peaks."""
    rows = list(rows)
    fl = sum(sum(row_flops(hp, c - r + 1 + i) for i in range(r)) for r, c in rows)
    by = weight_bytes(hp) + sum(_kv_bytes(hp, c) for _, c in rows)
    return max(fl / PEAK_FLOPS, by / PEAK_BYTES)


def group_bound_s(hp, windows: Sequence[Tuple[int, int]]) -> float:
    """A window-decode call of windows (prompt length, tokens chosen): the
    prompt pass, then one step per chosen token but the last over the
    windows still decoding."""
    t = pass_bound_s(hp, [(p, p) for p, _ in windows])
    for s in range(max((n for _, n in windows), default=0) - 1):
        live = [(1, p + s + 1) for p, n in windows if n - 1 > s]
        t += pass_bound_s(hp, live)
    return t


def decoder_flops(hp, windows: Sequence[Tuple[int, int]]) -> float:
    """Useful operations of windows given as (prompt length, tokens chosen)."""
    return float(sum(sum(row_flops(hp, i + 1) for i in range(p + max(n - 1, 0)))
                     for p, n in windows))
