"""DTW token-level timestamps from cross-attention alignment heads.

Port of whisper_tpu/decoding/dtw.py.  Reference: per-model alignment-head
tables (src/whisper.cpp:384-410), decoder re-run saving cross-attn softmax
weights of selected heads (:2727-2742), median filter (:8968-9001), DTW +
backtrace (:8878-8962), and the entry point
`whisper_exp_compute_token_level_timestamps_dtw` (:9003-9165).

One full-sequence causal decoder pass (`_alignment_weights_all`) returns
the softmax cross-attention weights of every layer; the selected (layer,
head) planes are gathered on the host.  With packed weights (the card's
default) the pass reads each layer's planes as `decode_step` does, so its
six matmuls per layer go through `_mm` on `QWeightT`: the bare streaming
dequant kernel (ops/qmm.py `qmmt`, csrc/qmmt.cu) at T = the window's token
count, with the bias added after, as the JAX package orders them.  DTW
itself is O(N*M) host numpy, a copy of the JAX module's.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.whisper import model as M
from ..models.whisper.hparams import WhisperHParams
from ..ops.qmm import QWeight, embed_lookup
from .graphs import DEVICE_LOCK

# alignment-head presets (src/whisper.cpp:384-397), keyed by model name
AHEADS_PRESETS: Dict[str, Tuple[Tuple[int, int], ...]] = {
    "tiny.en": ((1, 0), (2, 0), (2, 5), (3, 0), (3, 1), (3, 2), (3, 3), (3, 4)),
    "tiny": ((2, 2), (3, 0), (3, 2), (3, 3), (3, 4), (3, 5)),
    "base.en": ((3, 3), (4, 7), (5, 1), (5, 5), (5, 7)),
    "base": ((3, 1), (4, 2), (4, 3), (4, 7), (5, 1), (5, 2), (5, 4), (5, 6)),
    "small.en": ((6, 6), (7, 0), (7, 3), (7, 8), (8, 2), (8, 5), (8, 7),
                 (9, 0), (9, 4), (9, 8), (9, 10), (10, 0), (10, 1), (10, 2),
                 (10, 3), (10, 6), (10, 11), (11, 2), (11, 4)),
    "small": ((5, 3), (5, 9), (8, 0), (8, 4), (8, 7), (8, 8), (9, 0), (9, 7),
              (9, 9), (10, 5)),
    "medium.en": ((11, 4), (14, 1), (14, 12), (14, 14), (15, 4), (16, 0),
                  (16, 4), (16, 9), (17, 12), (17, 14), (18, 7), (18, 10),
                  (18, 15), (20, 0), (20, 3), (20, 9), (20, 14), (21, 12)),
    "medium": ((13, 15), (15, 4), (15, 15), (16, 1), (20, 0), (23, 4)),
    "large-v1": ((9, 19), (11, 2), (11, 4), (11, 17), (22, 7), (22, 11),
                 (22, 17), (23, 2), (23, 15)),
    "large-v2": ((10, 12), (13, 17), (16, 11), (16, 12), (16, 13), (17, 15),
                 (17, 16), (18, 4), (18, 11), (18, 19), (19, 11), (21, 2),
                 (21, 3), (22, 3), (22, 9), (22, 12), (23, 5), (23, 7),
                 (23, 13), (25, 5), (26, 1), (26, 12), (27, 15)),
    "large-v3": ((7, 0), (10, 17), (12, 18), (13, 12), (16, 1), (17, 14),
                 (19, 11), (21, 4), (24, 1), (25, 6)),
    "large-v3-turbo": ((2, 4), (2, 11), (3, 3), (3, 6), (3, 11), (3, 14)),
}


def resolve_aheads(hp: WhisperHParams, preset: str = "auto",
                   n_top_most: int = 0,
                   custom: Optional[Sequence[Tuple[int, int]]] = None
                   ) -> List[Tuple[int, int]]:
    """Map a preset name / N_TOP_MOST / custom list to (layer, head) pairs
    (aheads_masks_init, src/whisper.cpp:1160-1283)."""
    if custom:
        heads = list(custom)
    elif n_top_most > 0:
        heads = [(l, h)
                 for l in range(hp.n_text_layer - n_top_most, hp.n_text_layer)
                 for h in range(hp.n_text_head)]
    else:
        name = hp.model_name if preset == "auto" else preset
        if name not in AHEADS_PRESETS:
            raise ValueError(
                f"no alignment-head preset for model '{name}' "
                f"(use n_top_most or custom heads for non-standard models)")
        heads = list(AHEADS_PRESETS[name])
    for l, h in heads:
        if not (0 <= l < hp.n_text_layer and 0 <= h < hp.n_text_head):
            raise ValueError(
                f"invalid alignment head (layer {l}, head {h}) for a model "
                f"with {hp.n_text_layer} layers / {hp.n_text_head} heads")
    return heads


def _alignment_weights_all(params, tokens: torch.Tensor, positions: torch.Tensor,
                           xk, xv, hp: WhisperHParams, dtype=torch.float32
                           ) -> torch.Tensor:
    """Full-sequence decoder pass returning cross-attn softmax weights of
    every layer: (n_layer, n_head, n_tokens, n_audio_ctx).  Dense stacked
    leaves, or each layer's packed planes (`blocks_packed`) where the
    context installed them."""
    dec = params["dec"]
    n_tok = tokens.shape[0]
    n_head = hp.n_text_head
    n_state = hp.n_text_state
    eps = hp.eps

    tok_embd = dec["tok_embd"]
    emb = (embed_lookup(tok_embd, tokens) if isinstance(tok_embd, QWeight)
           else tok_embd[tokens])
    x = (emb + dec["pos_embd"][positions]).float()[None]    # (1, T, S)

    i = torch.arange(n_tok, device=tokens.device)
    mask = torch.where(i[None, :] <= i[:, None], 0.0, -torch.inf
                       ).float()[None, None]                 # (1, 1, T, T)

    blocks_packed = dec.get("blocks_packed")
    weights = []
    for l in range(hp.n_text_layer):
        blk = M._layer(dec["blocks"], l)
        if blocks_packed is not None:
            blk.update(blocks_packed[l])
        cxk = xk[l] if not isinstance(xk, M.XK8) else M.XK8(xk.codes[l], xk.scale[l])
        cxv = xv[l] if not isinstance(xv, M.XK8) else M.XK8(xv.codes[l], xv.scale[l])

        h = M.layer_norm(x, blk["attn_ln_w"], blk["attn_ln_b"], eps)
        qkv = M._mm(h, blk["qkv_w"], dtype) + blk["qkv_b"]
        q = qkv[..., :n_state]
        k = qkv[..., n_state:2 * n_state]
        v = qkv[..., 2 * n_state:]
        out = M.attention(M._split_heads(q, n_head), M._split_heads(k, n_head),
                          M._split_heads(v, n_head), mask, dtype)
        x = x + M._mm(M._merge_heads(out), blk["o_w"], dtype) + blk["o_b"]

        h = M.layer_norm(x, blk["xattn_ln_w"], blk["xattn_ln_b"], eps)
        q = M._mm(h, blk["xq_w"], dtype) + blk["xq_b"]
        qh = M._split_heads(q, n_head)          # (1, H, T, d)
        out, probs = M.cross_attend(qh, cxk, cxv, dtype, return_probs=True)
        x = x + M._mm(M._merge_heads(out), blk["xo_w"], dtype) + blk["xo_b"]

        h = M.layer_norm(x, blk["mlp_ln_w"], blk["mlp_ln_b"], eps)
        h = M._gelu(M._mm(h, blk["mlp0_w"], dtype) + blk["mlp0_b"])
        x = x + M._mm(h, blk["mlp1_w"], dtype) + blk["mlp1_b"]
        weights.append(probs[0])
    return torch.stack(weights)  # (n_layer, H, T, n_audio)


def median_filter_reflect(x: np.ndarray, width: int) -> np.ndarray:
    """Median over the last axis with reflect padding (:8968-9001)."""
    assert width % 2 == 1
    half = width // 2
    n = x.shape[-1]
    idx = np.arange(-half, n + half)
    idx = np.where(idx < 0, -idx, idx)
    idx = np.where(idx >= n, 2 * (n - 1) - idx, idx)
    padded = x[..., idx]
    windows = np.lib.stride_tricks.sliding_window_view(padded, width, axis=-1)
    return np.median(windows, axis=-1).astype(x.dtype)


def dtw_and_backtrace(x: np.ndarray) -> np.ndarray:
    """Monotonic DTW over cost matrix x (N tokens, M audio) with backtrace;
    returns alignment pairs [2, n_steps] (:8878-8962).  Tie-breaking matches
    the reference's strict-< comparisons exactly."""
    N, M = x.shape
    cost = np.full((N + 1, M + 1), np.inf, np.float32)
    trace = np.full((N + 1, M + 1), -1, np.int32)
    cost[0, 0] = 0.0
    for j in range(1, M + 1):
        for i in range(1, N + 1):
            c0 = cost[i - 1, j - 1]
            c1 = cost[i - 1, j]
            c2 = cost[i, j - 1]
            if c0 < c1 and c0 < c2:
                c, t = c0, 0
            elif c1 < c0 and c1 < c2:
                c, t = c1, 1
            else:
                c, t = c2, 2
            cost[i, j] = x[i - 1, j - 1] + c
            trace[i, j] = t

    trace[0, :] = 2
    trace[:, 0] = 1
    bt: List[Tuple[int, int]] = []
    i, j = N, M
    while i > 0 or j > 0:
        bt.append((i - 1, j - 1))
        t = trace[i, j]
        if t == 0:
            i -= 1
            j -= 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    bt.reverse()
    return np.asarray(bt, np.int32).T  # [2, steps]


def compute_token_level_timestamps_dtw(ctx, params, result_all,
                                       i_segment: int, n_segments: int,
                                       seek: int, n_frames: int,
                                       medfilt_width: int = 7) -> None:
    """whisper_exp_compute_token_level_timestamps_dtw (src/whisper.cpp:9003).

    Sets `t_dtw` (10 ms ticks) on the text tokens of segments
    [i_segment, i_segment + n_segments).
    """
    vocab = ctx.vocab
    hp = ctx.hp
    aheads = ctx.dtw_aheads
    if not aheads or ctx.is_empty:
        return

    # sot + [lang] + notimestamps + text tokens + eot (:9033-9054)
    tokens: List[int] = [vocab.token_sot]
    if vocab.is_multilingual:
        tokens.append(vocab.lang_token(ctx.lang_id))
    sot_len = len(tokens)
    tokens.append(vocab.token_not)
    for s in result_all[i_segment:i_segment + n_segments]:
        tokens.extend(t.id for t in s.tokens if t.id < vocab.token_eot)
    tokens.append(vocab.token_eot)

    n_audio_tokens = n_frames // 2
    t0 = time.perf_counter()
    with DEVICE_LOCK:
        toks = torch.tensor(tokens, dtype=torch.int64, device=ctx.device)
        pos = torch.arange(len(tokens), device=ctx.device)
        weights_all = _alignment_weights_all(
            ctx.params, toks, pos, ctx.xk, ctx.xv, hp=hp, dtype=ctx.compute_dtype)
        w_np = weights_all.cpu().numpy().astype(np.float32)
    ctx.timings.t_dtw_us += int((time.perf_counter() - t0) * 1e6)
    ctx.timings.n_dtw += 1

    # select alignment heads -> (n_sel, n_tokens, n_audio_tokens)
    sel = np.stack([w_np[l, h, :, :n_audio_tokens] for (l, h) in aheads])

    # normalize over the TEXT-token axis (ggml_norm over ne[0], :9103-9106)
    mean = sel.mean(axis=1, keepdims=True)
    var = sel.var(axis=1, keepdims=True)
    sel = (sel - mean) / np.sqrt(var + 1e-9)

    # median filter over the audio axis, mean over heads, negate (:9108-9122)
    sel = median_filter_reflect(sel, medfilt_width)
    matrix = -sel.mean(axis=0)  # (n_tokens, n_audio_tokens)

    # drop SOT sequence and EOT (:9124-9127)
    matrix = matrix[sot_len:len(tokens) - 1]

    alignment = dtw_and_backtrace(matrix)

    # place timestamps: first audio index where the token index advances
    # (:9135-9160)
    last_v = 0
    seg_i = i_segment
    tok_j = 0

    def advance():
        nonlocal seg_i, tok_j
        tok_j += 1
        while (seg_i < len(result_all) and
               tok_j >= len(result_all[seg_i].tokens)):
            seg_i += 1
            tok_j = 0

    for k in range(alignment.shape[1]):
        v = int(alignment[0, k])
        if v != last_v:
            time_index = int(alignment[1, k])
            timestamp = time_index * 2 + seek  # 20 ms per audio token
            last_v = v
            # skip non-text tokens
            while (seg_i < len(result_all) and
                   result_all[seg_i].tokens[tok_j].id >= vocab.token_eot):
                advance()
            if seg_i >= len(result_all):
                break
            result_all[seg_i].tokens[tok_j].t_dtw = timestamp
            advance()
