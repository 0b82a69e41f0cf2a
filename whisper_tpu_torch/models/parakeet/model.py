"""Parakeet FastConformer-TDT forward passes in PyTorch.

Port of whisper_tpu/models/parakeet/model.py (reference graphs:
parakeet_build_graph_encode, src/parakeet.cpp:1525-1972; the LSTM layer
:2144-2240, the prediction network :2242-2300, the joint :2302-2358).

Every function takes a leading batch axis: the JAX package runs one
utterance per call and vmaps for a batch, here one call carries B
utterances of one padded length (B = 1 for `full()`).  The same ops in the
same order as the JAX functions:

  * the conv-subsampling stem as NCHW convolutions, flattened to
    [T', C*F'] with F innermost;
  * relative-position attention with the pad/reshape Transformer-XL skew
    (no gather), and past LOCAL_ATTN_THRESHOLD frames the banded +-128
    chunked attention with the flatten-skew band extraction and scatter;
  * packed conformer weights (`PQW`) dequantized as codes*scales(+mins)
    and multiplied with `F.linear`, as the JAX package's XLA-fused dequant;
  * the LSTM gates packed [i, f, o, g] with the folded bias, not
    `nn.LSTM`'s [i, f, g, o].

The products are torch's own (cuBLAS and cuDNN on the card): the JAX path
reaches no Pallas kernel.  Callers on the card hold decoding/graphs.py
DEVICE_LOCK and full_f32, so the f32 path stays IEEE f32 (cuDNN's
convolutions would otherwise take TF32).
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from .hparams import LOCAL_ATTN_THRESHOLD, LOCAL_ATTN_WINDOW, ParakeetHParams

MASK_VALUE = -1e30


class PQW(NamedTuple):
    """Packed conformer weight (load.build_packed_overlay): codes in file
    orientation (out, in), per-block scales (out, in//B) and, for affine
    K-quant formats, per-block mins.  Stacked over layers as installed;
    `layer_params` takes one layer's planes."""

    codes: torch.Tensor
    scales: torch.Tensor
    mins: Optional[torch.Tensor] = None


def _pmm(x, w, dtype=torch.float32):
    """x @ W^T for a dense (out, in) weight or a PQW packed plane; the
    plane is dequantized to a dense `dtype` weight at every call."""
    if isinstance(w, PQW):
        out, nb = w.scales.shape
        grain = w.codes.shape[-1] // nb
        wd = (w.codes.to(dtype).reshape(out, nb, grain)
              * w.scales.to(dtype)[..., None])
        if w.mins is not None:
            wd = wd + w.mins.to(dtype)[..., None]
        return F.linear(x, wd.reshape(out, -1))
    return F.linear(x, w.to(dtype))


def _ln(x, w, b, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


# --------------------------------------------------------------------------
# conv subsampling stem (src/parakeet.cpp:1545-1599)
# --------------------------------------------------------------------------

def pre_encode(pre: Dict[str, Any], mel: torch.Tensor, hp: ParakeetHParams,
               dtype=torch.float32) -> torch.Tensor:
    """mel: (B, n_time, n_mels) -> (B, n_frames, n_state).

    NCHW with H=time, W=freq; three stride-2 stages: full 3x3 conv, then
    two (depthwise 3x3 stride 2 -> pointwise 1x1) pairs, relu after each
    stage; flatten (C, F) with F innermost; linear to n_state.
    """
    x = mel.to(dtype)[:, None, :, :]  # [B, 1, T, F]
    ch = hp.n_subsampling_channels

    def conv(x, i, stride, pad, groups=1):
        return F.conv2d(x, pre[f"conv{i}_w"].to(dtype), pre[f"conv{i}_b"].to(dtype),
                        stride=stride, padding=pad, groups=groups)

    x = torch.relu(conv(x, 0, 2, 1))
    x = conv(x, 2, 2, 1, groups=ch)
    x = torch.relu(conv(x, 3, 1, 0))
    x = conv(x, 5, 2, 1, groups=ch)
    x = torch.relu(conv(x, 6, 1, 0))

    # [B, C, T', F'] -> [B, T', C*F'] with F' innermost (ggml permute+reshape,
    # src/parakeet.cpp:1586-1596)
    x = x.permute(0, 2, 1, 3)
    x = x.reshape(x.shape[0], x.shape[1], -1)
    return _pmm(x, pre["out_w"], dtype) + pre["out_b"].to(dtype)


# --------------------------------------------------------------------------
# relative positional encoding (src/parakeet.cpp:2063-2092, 1629-1645)
# --------------------------------------------------------------------------

def _pos_embedding(window_size: int, max_rel: int, n_state: int, dtype,
                   device=None):
    """pos_emb[w] for relative positions max_rel, max_rel-1, ..., -(max_rel);
    interleaved (sin, cos) pairs along the state dim."""
    d_half = n_state // 2
    k = torch.arange(d_half, dtype=torch.float32, device=device)
    freqs = torch.exp(-(2.0 * k) * math.log(10000.0) / n_state)
    rel = max_rel - torch.arange(window_size, dtype=torch.float32, device=device)
    theta = rel[:, None] * freqs[None, :]  # [w, d_half]
    emb = torch.stack([torch.sin(theta), torch.cos(theta)], dim=-1)
    return emb.reshape(window_size, n_state).to(dtype)


def _heads(x, w, n_head, dtype):
    B, T, S = x.shape
    return _pmm(x, w, dtype).reshape(B, T, n_head, S // n_head)


def _rel_attention_global(x, layer, n_head: int, mask_1d, dtype=torch.float32,
                          pos_emb=None):
    """Full rel-pos MHA (src/parakeet.cpp:1808-1900).

    x: [B, T, S]; mask_1d: [B, T] additive key mask (0 valid / -1e30 pad);
    pos_emb: [2T-1, S] (computed here when not given).
    """
    B, T, S = x.shape
    d_head = S // n_head
    scale = 1.0 / math.sqrt(d_head)

    q = _heads(x, layer["attn_q_w"], n_head, dtype)
    k = _heads(x, layer["attn_k_w"], n_head, dtype)
    v = _heads(x, layer["attn_v_w"], n_head, dtype)

    window = 2 * T - 1
    if pos_emb is None:
        pos_emb = _pos_embedding(window, T - 1, S, dtype, x.device)
    pos = _pmm(pos_emb, layer["attn_pos_w"], dtype).reshape(window, n_head, d_head)

    q_u = q + layer["pos_bias_u"].to(dtype)  # [B, T, h, d]
    q_v = q + layer["pos_bias_v"].to(dtype)

    content = q_u.transpose(1, 2) @ k.permute(0, 2, 3, 1)      # [B, h, T, T]
    rel = q_v.transpose(1, 2) @ pos.permute(1, 2, 0)           # [B, h, T, 2T-1]

    # Transformer-XL shift: score[q, k] = rel[q, T-1 - q + k], via the
    # classic pad/reshape skew (pure data movement)
    rel_shifted = F.pad(rel, (1, 0))                            # [B, h, T, 2T]
    rel_shifted = rel_shifted.reshape(B, n_head, 2 * T, T)[:, :, 1:, :]
    rel_shifted = rel_shifted.reshape(B, n_head, T, 2 * T - 1)[..., :T]

    scores = (content + rel_shifted) * scale + mask_1d[:, None, None, :]
    probs = torch.softmax(scores, dim=-1)
    out = (probs @ v.transpose(1, 2)).transpose(1, 2).reshape(B, T, S)
    return _pmm(out, layer["attn_out_w"], dtype)


def _rel_attention_local(x, layer, n_head: int, valid_1d, dtype=torch.float32,
                         pos_emb=None):
    """Banded local attention, window +-LOCAL_ATTN_WINDOW
    (src/parakeet.cpp:1694-1806).

    valid_1d: [B, T] boolean key validity. Chunked scheme: queries in groups
    of C = 2W; each group's keys span [g*C - W, g*C + C + W) (C + 2W keys);
    the band (q's window) is extracted from the dense chunk scores by the
    flatten-skew, softmaxed over the window, and scattered back by the same
    skew for the value matmul.
    """
    B, T, S = x.shape
    d_head = S // n_head
    W = LOCAL_ATTN_WINDOW
    C = 2 * W                      # chunk (att_left + att_right)
    win = 2 * W + 1                # window_size
    n_kv = C + win - 1             # keys per chunk (= C + 2W)
    scale = 1.0 / math.sqrt(d_head)
    h = n_head

    n_group = (T + C - 1) // C
    Tp = n_group * C

    q = _heads(x, layer["attn_q_w"], n_head, dtype)
    k = _heads(x, layer["attn_k_w"], n_head, dtype)
    v = _heads(x, layer["attn_v_w"], n_head, dtype)

    if pos_emb is None:
        pos_emb = _pos_embedding(win, W, S, dtype, x.device)
    pos = _pmm(pos_emb, layer["attn_pos_w"], dtype).reshape(win, n_head, d_head)

    q_u = q + layer["pos_bias_u"].to(dtype)
    q_v = q + layer["pos_bias_v"].to(dtype)

    # rel-pos scores: [B, h, T, win]
    rel = q_v.transpose(1, 2) @ pos.permute(1, 2, 0)

    # pad queries to groups, pad keys by W on both sides
    q_u = F.pad(q_u, (0, 0, 0, 0, 0, Tp - T))
    kp = F.pad(k, (0, 0, 0, 0, W, W + (Tp - T)))
    vp = F.pad(v, (0, 0, 0, 0, W, W + (Tp - T)))

    # per-group key/value chunks, rows g*C .. g*C + n_kv: [B, g, h, d, n_kv]
    k_chunk = kp.unfold(1, n_kv, C)
    v_chunk = vp.unfold(1, n_kv, C)
    q_g = q_u.reshape(B, n_group, C, h, d_head)

    dense = q_g.permute(0, 3, 1, 2, 4) @ k_chunk.permute(0, 2, 1, 3, 4)  # [B, h, g, C, n_kv]

    # band extraction: band[q, w] = dense[q, q + w], w in [0, win), via the
    # flatten-skew (row q starts at q*(n_kv+1) in the padded flat view)
    band = dense.reshape(B, h, n_group, C * n_kv)
    band = F.pad(band, (0, C))
    band = band.reshape(B, h, n_group, C, n_kv + 1)[..., :win]
    band = band.reshape(B, h, Tp, win)[:, :, :T, :]

    scores = (band + rel) * scale

    # key validity mask: key = q - W + w
    keys = (torch.arange(T, device=x.device)[:, None] - W
            + torch.arange(win, device=x.device)[None, :])
    inside = (keys >= 0) & (keys < T)
    ok = inside[None] & valid_1d[:, keys.clamp(0, T - 1)]        # [B, T, win]
    scores = torch.where(ok[:, None], scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1)

    # scatter the band back to the dense chunk layout by the flatten-skew:
    # pad rows to win + C, flatten, trim, reshape -> row q shifted right by q
    pb = F.pad(probs, (0, 0, 0, Tp - T))
    pb = pb.reshape(B, h, n_group, C, win)
    pb = F.pad(pb, (0, n_kv + 1 - win))
    pb = pb.reshape(B, h, n_group, C * (n_kv + 1))[..., :C * n_kv]
    pdense = pb.reshape(B, h, n_group, C, n_kv)

    out = pdense @ v_chunk.permute(0, 2, 1, 4, 3)                 # [B, h, g, C, d]
    out = out.permute(0, 2, 3, 1, 4).reshape(B, Tp, S)[:, :T]
    return _pmm(out, layer["attn_out_w"], dtype)


# --------------------------------------------------------------------------
# conformer block (src/parakeet.cpp:1647-1965)
# --------------------------------------------------------------------------

def _conv_module(x, layer, hp: ParakeetHParams, dtype=torch.float32):
    B, T, S = x.shape
    cur = _ln(x, layer["norm_conv_w"].to(dtype), layer["norm_conv_b"].to(dtype), hp.eps)
    cur = _pmm(cur, layer["conv_pw1_w"], dtype)  # [B, T, 2S]
    cur = cur[..., :S] * torch.sigmoid(cur[..., S:])

    # depthwise 1d conv, 'same' symmetric padding, summed tap by tap in the
    # JAX package's order (ggml pad/roll/pad + ssm_conv)
    pad = (hp.n_conv_kernel - 1) // 2
    padded = F.pad(cur, (0, 0, pad, pad))
    k = layer["conv_dw_w"].to(dtype)  # [S, kernel]
    acc = padded[:, 0:T, :] * k[:, 0]
    for j in range(1, hp.n_conv_kernel):
        acc = acc + padded[:, j:j + T, :] * k[:, j]

    # batch-norm inference: (x - mean) / sqrt(var) * w + b — no eps
    # (src/parakeet.cpp:1940-1945)
    cur = (acc - layer["conv_bn_mean"].to(dtype)) / torch.sqrt(
        layer["conv_bn_var"].to(dtype))
    cur = cur * layer["conv_bn_w"].to(dtype) + layer["conv_bn_b"].to(dtype)
    cur = F.silu(cur)
    return _pmm(cur, layer["conv_pw2_w"], dtype)


def _ffn(x, norm_w, norm_b, lin1, lin2, eps, dtype=torch.float32):
    cur = _ln(x, norm_w.to(dtype), norm_b.to(dtype), eps)
    cur = F.silu(_pmm(cur, lin1, dtype))
    return _pmm(cur, lin2, dtype)


def conformer_block(x, layer, hp: ParakeetHParams, mask_or_valid, local: bool,
                    dtype=torch.float32, pos_emb=None):
    fc = 0.5
    x = x + fc * _ffn(x, layer["norm_ff1_w"], layer["norm_ff1_b"],
                      layer["ff1_lin1_w"], layer["ff1_lin2_w"], hp.eps, dtype)
    cur = _ln(x, layer["norm_attn_w"].to(dtype), layer["norm_attn_b"].to(dtype), hp.eps)
    attend = _rel_attention_local if local else _rel_attention_global
    x = x + attend(cur, layer, hp.n_audio_head, mask_or_valid, dtype, pos_emb)
    x = x + _conv_module(x, layer, hp, dtype)
    x = x + fc * _ffn(x, layer["norm_ff2_w"], layer["norm_ff2_b"],
                      layer["ff2_lin1_w"], layer["ff2_lin2_w"], hp.eps, dtype)
    return _ln(x, layer["norm_out_w"].to(dtype), layer["norm_out_b"].to(dtype), hp.eps)


def layer_params(layers: Dict[str, Any], il: int) -> Dict[str, Any]:
    """Layer il of the stacked per-layer tree (views, dense or PQW)."""
    return {k: (PQW(*(None if a is None else a[il] for a in v)) if isinstance(v, PQW)
                else v[il]) for k, v in layers.items()}


def encode(params: Dict[str, Any], mel: torch.Tensor, n_len_org,
           hp: ParakeetHParams, dtype=torch.float32) -> torch.Tensor:
    """Full encoder: mel (B, n_time, n_mels) -> (B, n_frames, n_state).

    n_len_org: each row's original (unpadded) mel frame count (an int for
    all rows, or a sequence of B); keys beyond ceil(n_len_org / subsampling)
    are masked (src/parakeet.cpp:2016-2042).  The 24 layers run as a Python
    loop, as the JAX package's unrolled default.
    """
    x = pre_encode(params["pre"], mel, hp, dtype)
    B, T, S = x.shape
    dev = x.device
    n_len = torch.as_tensor(n_len_org, dtype=torch.long).reshape(-1).expand(B)
    n_real = ((n_len + hp.subsampling_factor - 1) // hp.subsampling_factor).to(dev)
    valid = torch.arange(T, device=dev)[None, :] < n_real[:, None]

    local = T > LOCAL_ATTN_THRESHOLD
    if local:
        mask_or_valid = valid
        pos_emb = _pos_embedding(2 * LOCAL_ATTN_WINDOW + 1, LOCAL_ATTN_WINDOW, S,
                                 dtype, dev)
    else:
        mask_or_valid = torch.where(valid, 0.0, MASK_VALUE).to(dtype)
        pos_emb = _pos_embedding(2 * T - 1, T - 1, S, dtype, dev)

    for il in range(params["layers"]["norm_out_w"].shape[0]):
        x = conformer_block(x, layer_params(params["layers"], il), hp,
                            mask_or_valid, local, dtype, pos_emb)
    return x


# --------------------------------------------------------------------------
# prediction network + joint (src/parakeet.cpp:2144-2358)
# --------------------------------------------------------------------------

def lstm_predict(pred: Dict[str, torch.Tensor], joint: Dict[str, torch.Tensor],
                 token, h, c, hp: ParakeetHParams, dtype=torch.float32):
    """One prediction-network step for `token` (B,) long.

    h, c: [B, n_pred_layers, n_pred_dim]. Gates are packed [i, f, o, g]
    (reordered at conversion, models/convert-parakeet-to-ggml.py:300-309);
    bias is the folded ih+hh sum.  Returns (pred_out [B, D], h', c').
    """
    D = hp.n_pred_dim
    x = pred["embed_w"].to(dtype).index_select(0, token)

    hs, cs = [], []
    for il in range(hp.n_pred_layers):
        gates = (F.linear(x, pred["lstm_ih_w"][il].to(dtype))
                 + F.linear(h[:, il], pred["lstm_hh_w"][il].to(dtype))
                 + pred["lstm_b_h"][il].to(dtype))
        i_t = torch.sigmoid(gates[:, 0 * D:1 * D])
        f_t = torch.sigmoid(gates[:, 1 * D:2 * D])
        o_t = torch.sigmoid(gates[:, 2 * D:3 * D])
        g_t = torch.tanh(gates[:, 3 * D:4 * D])
        c_new = f_t * c[:, il] + i_t * g_t
        h_new = o_t * torch.tanh(c_new)
        hs.append(h_new)
        cs.append(c_new)
        x = h_new

    pred_out = F.linear(x, joint["pred_w"].to(dtype)) + joint["pred_b"].to(dtype)
    return pred_out, torch.stack(hs, dim=1), torch.stack(cs, dim=1)


def joint_logits(joint: Dict[str, torch.Tensor], enc_t: torch.Tensor,
                 pred_out: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """logits over vocab + blank + durations (src/parakeet.cpp:2302-2352).
    enc_t: [B, n_state], pred_out: [B, n_pred_dim]."""
    enc = F.linear(enc_t, joint["enc_w"].to(dtype)) + joint["enc_b"].to(dtype)
    h = torch.relu(enc + pred_out)
    return F.linear(h, joint["net_w"].to(dtype)) + joint["net_b"].to(dtype)
