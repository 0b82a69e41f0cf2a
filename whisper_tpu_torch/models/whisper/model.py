"""Whisper encoder/decoder as plain PyTorch functions on tensors.

Port of whisper_tpu/models/whisper/model.py.  Parameters are the same
nested dictionaries (models/whisper/convert.py), weights are (in, out) so a
projection is `x @ w`, q/k/v are one fused (S, 3S) projection, and the
decoder's self-attention cache is head-major (L, B, H, 2, C, d).

`dtype` is the matmul input precision: every product rounds its operands to
`dtype` and accumulates and returns f32, as the JAX package's
`preferred_element_type=f32` dots do (bf16 on the card, f32 for exactness on
the CPU).  Hand-written kernels carry the hot paths (ops/qmm.py,
ops/enc_attn.py, ops/attention.py, ops/decode_attn.py), on the routes the
JAX package picks (WTPU_ENC_ATTN, WTPU_DECODE_ATTN, `set_flash_enabled`);
everything else is plain tensor code, as it is plain XLA in the JAX package.

`parity=True` is the JAX package's ggml-CPU parity mode
(precision="ggml_cpu_f16", runtime/context.py): f16 operands, f16 caches,
the f16 GELU table and, for quantized files, the reference's Q8_0
activation rows with integer block dots (`QWGGML`, `_mm_ggml_q`).  On the
card its products must run without TF32 or reduced-precision reductions
(decoding/graphs.py `full_f32`, which the context and the window decoder
enter).

One deliberate difference from the JAX package: `decode_step` writes the new
K/V column into the cache IN PLACE (the JAX functions are pure and return a
new cache), which saves a cache copy per step.

Tensor parallelism (`tp=`, a torch.distributed process group; None: one
device): the parameters are this rank's part of the spec table
(parallel/sharding.py `shard_params`), so every function runs on the
rank's H/tp heads, and the collectives GSPMD inserts in the JAX package
are written here: an all-reduce (sum) after each row-parallel product
(encoder o and mlp1; decoder o, xo and mlp1), with the replicated bias and
the residual added after it, and an all-reduce (max) of the q8 self-KV
cache's per-row amax, which spans every head (`_quantize_rows`).  After
the last reduce x is the same on every rank, and the token embedding is
replicated, so every rank computes the full logits with no collective.
Attention routes are chosen on the rank's own heads (`_enc_attn_route`):
rank-local attention is the single-device function on H/tp heads.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ...ops import attention as flash
from ...ops import decode_attn, enc_attn
from ...ops.qmm import (QWeight, QWeightT, embed_lookup, qmm_auto, qmmt_auto,
                        qmmt_fused_auto)
from ...parallel.mesh import all_reduce_max, all_reduce_sum, group_size
from .hparams import WhisperHParams


def _gelu(x: torch.Tensor, parity: bool = False) -> torch.Tensor:
    # ggml_gelu is the tanh approximation (ggml/src/ggml-cpu/ops.cpp GELU LUT)
    if parity:
        # GGML_GELU_FP16 table emulation (ggml/src/ggml-cpu/vec.h:987-1001):
        # y = f16(gelu(f32(f16(x)))) with hard 0/x clamps outside [-10, 10]
        y = F.gelu(x.half().float(), approximate="tanh").half().float()
        return torch.where(x <= -10.0, 0.0, torch.where(x >= 10.0, x, y))
    return F.gelu(x, approximate="tanh")


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * w + b


def matmul_f32(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    """a @ b (broadcasting leading dims) with both operands rounded to
    `dtype`, f32 accumulation and an f32 result."""
    if dtype == torch.float32:
        return torch.matmul(a.float(), b.float())
    a, b = a.to(dtype), b.to(dtype)
    if a.device.type != "cuda":
        # dtype-rounded operands multiply exactly in f32
        return torch.matmul(a.float(), b.float())
    # cuBLAS with dtype operands and an f32 output
    if b.ndim == 2:
        y = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return y.reshape(*a.shape[:-1], b.shape[-1])
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    y = torch.bmm(a3, b3, out_dtype=torch.float32)
    return y.reshape(*batch, a.shape[-2], b.shape[-1])


class CapturedWeight:
    """Imatrix-capture wrapper (formats/imatrix.py, cli/make_imatrix.py):
    records the matmul input's per-column activation statistics under the
    weight's file tensor name(s), then computes normally.  Eager only: the
    collector is a host-side side effect that a captured CUDA graph would
    drop, as a jit trace drops it in the JAX package."""

    def __init__(self, names, w, collector):
        self.names = names
        self.w = w
        self.collector = collector

    def __getitem__(self, l):
        """Stacked (L, ...) weights slice per layer; `names` is then a
        per-layer list."""
        return CapturedWeight(self.names[l], self.w[l], self.collector)

    @property
    def T(self):  # the logits head transposes the token embedding
        return CapturedWeight(self.names, self.w.T, self.collector)


class QWGGML(NamedTuple):
    """ggml-CPU-parity quantized weight: centred integer codes in FILE
    orientation (out, in) held as exact f32 integers, and per-32-block f32
    scales (f16-exact values).  `_mm` reproduces ggml's quantized mul_mat
    from these (`_mm_ggml_q`)."""

    codes: torch.Tensor   # (out, in) f32 integer codes
    scales: torch.Tensor  # (out, in // 32) f32


def _round_half_away(v: torch.Tensor) -> torch.Tensor:
    # C roundf(): halves round away from zero (torch.round is half-to-even)
    return torch.sign(v) * torch.floor(v.abs() + 0.5)


# the most bytes one (n_blocks, rows, out) f32 block-dot chunk may take
_GGML_Q_PART_BYTES = 256 << 20


def _q8_0_rows(x: torch.Tensor):
    """Activation rows (..., K) as ggml's Q8_0 blocks (quantize_row_q8_0_ref):
    codes (..., K // 32, 32) as exact f32 integers and the block scales
    f32(f16(d)) (..., K // 32), with d = amax/127, id = 1/d taken before
    the f16 rounding of d, and C roundf codes.

    Every step is an IEEE operation of its own, since a half-way point
    decides a code: `d` divides by a tensor, as PyTorch's CUDA division by
    a Python scalar multiplies by its reciprocal instead."""
    xb = x.float().unflatten(-1, (-1, 32))
    amax = xb.abs().amax(-1)
    d = amax / torch.full_like(amax, 127.0)
    idd = torch.where(d > 0, torch.ones_like(d) / torch.where(d == 0, 1.0, d), 0.0)
    return _round_half_away(xb * idd[..., None]), d.half().float()


def _mm_ggml_q(x: torch.Tensor, w: QWGGML) -> torch.Tensor:
    """ggml CPU quantized mul_mat: activation rows quantize to Q8_0
    (`_q8_0_rows`), then per-32-block INTEGER dots, exact in f32
    (|sumi| < 2^24), scaled by f32(f16(d_w)) * f32(f16(d_x)) and summed
    over the blocks in f32 (ggml/src/ggml-cpu/quants.c
    ggml_vec_dot_q5_0_q8_0_generic), in the JAX package's association.

    The block dots run over row chunks so that no (n_blocks, rows, out)
    intermediate passes _GGML_Q_PART_BYTES (1500 encoder rows x 5120
    outputs x 40 blocks would take 1.2 GB at once)."""
    out_dim, in_dim = w.codes.shape
    nb = in_dim // 32
    lead = x.shape[:-1]
    q, dx = _q8_0_rows(x.reshape(-1, in_dim))
    q = q.transpose(0, 1)                                         # (nb, rows, 32)
    dx = dx.T[..., None]                                          # (nb, rows, 1)
    wc = w.codes.reshape(out_dim, nb, 32).permute(1, 2, 0)        # (nb, 32, out)
    ws = w.scales.T[:, None, :]                                   # (nb, 1, out)
    step = max(1, _GGML_Q_PART_BYTES // (4 * nb * out_dim))
    y = torch.cat([(torch.bmm(q[:, r:r + step], wc) * ws * dx[:, r:r + step]).sum(0)
                   for r in range(0, q.shape[1], step)])
    return y.reshape(*lead, out_dim)


def _mm(x: torch.Tensor, w, dtype) -> torch.Tensor:
    """x @ w with f32 accumulation; operands rounded to `dtype`.  A QWeightT
    goes through the streaming dequant kernel (ops/qmm.py qmmt); a QWeight
    ((out, in) planes) through `qmm_auto` (dequantized in `dtype`, as the
    JAX package's); a QWGGML takes the parity
    mode's integer block dots.  A CapturedWeight hands x to its collector
    first."""
    if isinstance(w, CapturedWeight):
        w.collector.add(w.names, x)
        return _mm(x, w.w, dtype)
    if isinstance(w, QWGGML):
        return _mm_ggml_q(x, w)
    if isinstance(w, QWeightT):
        return qmmt_auto(x, w, dtype)
    if isinstance(w, QWeight):
        return qmm_auto(x, w, dtype)
    return matmul_f32(x, w, dtype)


def _mm_fused(x: torch.Tensor, w, dtype, *, ln=None, bias=None, res=None,
              act=None, eps: float = 1e-5, parity: bool = False) -> torch.Tensor:
    """act(LN(x) @ w + bias) + res — ONE kernel launch for a packed QWeightT
    (ops/qmm.py qmmt_fused); otherwise the reference op sequence."""
    if isinstance(w, QWeightT):
        return qmmt_fused_auto(x, w, dtype, ln=ln, bias=bias, residual=res,
                               act=act, eps=eps)
    h = layer_norm(x, ln[0], ln[1], eps) if ln is not None else x
    y = _mm(h, w, dtype)
    if bias is not None:
        y = y + bias
    if act == "gelu":
        y = _gelu(y, parity)
    if res is not None:
        y = y + res
    return y


def _row_parallel(h: torch.Tensor, w, bias, res: torch.Tensor, dtype, tp) -> torch.Tensor:
    """h @ w + bias + res for a row-parallel projection: one fused call
    without tp; with tp the rank's partial product summed over the group
    first, then the replicated bias and the residual, once each (the dense
    `_mm_fused`'s order: product, bias, residual)."""
    if tp is None:
        return _mm_fused(h, w, dtype, bias=bias, res=res)
    return all_reduce_sum(_mm(h, w, dtype), tp) + bias + res


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    """(..., T, n_state) -> (..., n_head, T, d_head)"""
    *lead, t, n_state = x.shape
    return x.reshape(*lead, t, n_head, n_state // n_head).transpose(-2, -3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(..., n_head, T, d_head) -> (..., T, n_state)"""
    x = x.transpose(-2, -3)
    *lead, t, h, d = x.shape
    return x.reshape(*lead, t, h * d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor], dtype,
              scale: Optional[float] = None) -> torch.Tensor:
    """q:(...,H,Tq,d) k,v:(...,H,Tk,d) mask additive f32 or None.  `scale`
    overrides 1/sqrt(d) (the parity decode pre-scales q and k by d^-0.25
    each and passes 1.0)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = matmul_f32(q, k.transpose(-1, -2), dtype) * scale
    if mask is not None:
        scores = scores + mask
    probs = torch.softmax(scores, dim=-1)
    return matmul_f32(probs, v, dtype)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _conv1d(x: torch.Tensor, w: torch.Tensor, stride: int, dtype) -> torch.Tensor:
    """(C, W) * (O, C, 3), padding 1 -> (W_out, O): im2col + one matmul,
    so the conv has the same operand rounding and f32 accumulation as every
    other product (no TF32 convolution path is involved)."""
    cols = F.pad(x, (1, 1)).unfold(1, w.shape[-1], stride)   # (C, W_out, 3)
    cols = cols.permute(1, 0, 2).reshape(cols.shape[1], -1)   # (W_out, C*3)
    return matmul_f32(cols, w.reshape(w.shape[0], -1).T, dtype)


def conv_stem(enc_params: Dict[str, Any], mel: torch.Tensor, dtype,
              parity: bool = False) -> torch.Tensor:
    """2x conv1d + GELU (whisper_build_graph_conv, src/whisper.cpp:2009-2021).

    mel: (n_mels, 2*n_ctx) -> (n_ctx, n_state).  parity: dtype f16 (the
    im2col product rounds the conv inputs to f16 as ggml's im2col does)
    and GELU through the f16 table."""
    x = _gelu(_conv1d(mel, enc_params["conv1_w"], 1, dtype)
              + enc_params["conv1_b"], parity)               # (W, S)
    return _gelu(_conv1d(x.T, enc_params["conv2_w"], 2, dtype)
                 + enc_params["conv2_b"], parity)


def _segment_mask(t_pad: int, true_len: int, device) -> torch.Tensor:
    """Additive (1, T, T) mask splitting rows [0,true_len) and the junk
    pad rows into two attention segments."""
    real = torch.arange(t_pad, device=device) < true_len
    allow = real[:, None] == real[None, :]
    return torch.where(allow, 0.0, -1e9).float()[None]


def _enc_attn_route(dtype, t_pad: int, n_head: int, d_head: int) -> str:
    """The graph the encoder's self-attention takes, chosen as the JAX
    package chooses it (whisper_tpu/models/whisper/model.py _encoder_block):
    the fused-QKV kernel ("qkv") for bf16 encodes over a 512-padded stream
    with 64- or 128-wide heads that pair into 128 lanes, when
    WTPU_ENC_ATTN allows it; else the flash kernel ("flash") when
    `use_flash` holds; else the plain graph ("plain").  Each is the user's
    choice of graph, never a fallback for a kernel that fails."""
    if (enc_attn.use_kernel() and dtype == torch.bfloat16 and t_pad % 512 == 0
            and d_head in (64, 128) and n_head % max(1, 128 // d_head) == 0):
        return "qkv"
    if flash.use_flash(t_pad, dtype):
        return "flash"
    return "plain"


def _encoder_block(x: torch.Tensor, blk: Dict[str, torch.Tensor], n_head: int,
                   eps: float, dtype, true_len: Optional[int] = None,
                   parity: bool = False, tp=None) -> torch.Tensor:
    """One pre-LN transformer block; rows true_len.. are junk padding kept
    in their own attention segment.  parity: the reference's non-flash
    attention, which casts K and V to f16 and so rounds Q and the softmax
    probabilities to f16 at its two products: the plain graph at dtype f16
    (src/whisper.cpp:2170-2193), never a kernel.  tp: n_head is the
    rank's own head count, and the row-parallel products are summed over
    the group before their biases."""
    h = layer_norm(x, blk["attn_ln_w"], blk["attn_ln_b"], eps)
    qkv = _mm(h, blk["qkv_w"], dtype) + blk["qkv_b"]
    n_state = qkv.shape[-1] // 3          # the rank's q (k, v) width
    t_pad = qkv.shape[-2]
    route = "parity" if parity else _enc_attn_route(dtype, t_pad, n_head,
                                                    n_state // n_head)
    if route == "qkv":
        merged = enc_attn.self_attention_qkv(
            qkv, n_head, true_len=true_len if true_len is not None else t_pad)
    else:
        qh, kh, vh = (_split_heads(qkv[..., i * n_state:(i + 1) * n_state],
                                   n_head) for i in range(3))
        if route == "flash":
            out = flash.flash_self_attention(qh, kh, vh, true_len=true_len)
        else:
            m = (_segment_mask(t_pad, true_len, x.device)
                 if true_len is not None else None)
            out = attention(qh, kh, vh, m,
                            torch.float16 if route == "parity" else dtype)
        merged = _merge_heads(out)
    x = x + all_reduce_sum(_mm(merged, blk["o_w"], dtype), tp) + blk["o_b"]
    h = layer_norm(x, blk["mlp_ln_w"], blk["mlp_ln_b"], eps)
    h = _gelu(_mm(h, blk["mlp0_w"], dtype) + blk["mlp0_b"], parity)
    return x + all_reduce_sum(_mm(h, blk["mlp1_w"], dtype), tp) + blk["mlp1_b"]


def _at(v, l: int):
    """Layer l of a stacked (L, ...) leaf: a tensor, or the planes of a
    stacked QWGGML (the JAX package's tree_map over the pytree)."""
    return QWGGML(v.codes[l], v.scales[l]) if isinstance(v, QWGGML) else v[l]


def _layer(blocks: Dict[str, Any], l: int) -> Dict[str, Any]:
    return {k: _at(v, l) for k, v in blocks.items()}


def encode(params: Dict[str, Any], mel: torch.Tensor, hp: WhisperHParams,
           dtype=torch.bfloat16, pad_to: Optional[int] = None,
           parity: bool = False, tp=None) -> torch.Tensor:
    """mel (n_mels, 2*n_ctx) -> encoder embeddings (n_ctx, n_state).

    Padded residency: when the flash route is on (`use_flash`), the
    residual stream is padded ONCE to a multiple of 512 (1500 -> 1536) for
    the whole block stack and sliced back before ln_post; the pad rows are
    their own attention segment, so real rows are unaffected.  With flash
    off (-nfa) the stream stays unpadded, as in the JAX package, and so it
    does in the parity mode, which never takes a kernel.  `pad_to` forces a
    padded length.  tp: `params` is this rank's part (module docstring); the
    result is the full (n_ctx, n_state) on every rank."""
    enc = params["enc"]
    x = conv_stem(enc, mel, dtype, parity)
    n_ctx = x.shape[0]
    x = x + enc["pos_embd"][:n_ctx]
    t_pad = pad_to
    if t_pad is None and not parity and flash.use_flash(n_ctx, dtype):
        t_pad = flash._round_up(max(n_ctx, 512), 512)
    true_len = None
    if t_pad is not None and t_pad > n_ctx:
        x = F.pad(x, (0, 0, 0, t_pad - n_ctx))
        true_len = n_ctx
    for l in range(hp.n_audio_layer):
        x = _encoder_block(x, _layer(enc["blocks"], l), hp.n_audio_head // group_size(tp),
                           hp.eps, dtype, true_len=true_len, parity=parity, tp=tp)
    return layer_norm(x[:n_ctx], enc["ln_post_w"], enc["ln_post_b"], hp.eps)


class XK8(NamedTuple):
    """INT8 cross-attention K or V plane: codes (..., H, Tc, d) int8 with a
    per-(head, position) scale (..., H, Tc) f32 that factors out of both
    cross-attention products."""

    codes: torch.Tensor
    scale: torch.Tensor


def _quantize_rows(x: torch.Tensor, tp=None):
    """(..., S) -> (codes int8, scale (...) f32); per-row symmetric.  tp:
    x holds this rank's columns of each row, and the row's amax is the max
    over the group, so the codes and scales are the unsharded ones."""
    x32 = x.float()
    scale = all_reduce_max(x32.abs().amax(-1), tp) / 127.0
    inv = torch.where(scale > 0, 1.0 / torch.where(scale == 0, 1.0, scale), 0.0)
    codes = torch.clamp(torch.round(x32 * inv[..., None]), -127, 127).to(torch.int8)
    return codes, scale


def compute_cross_kv(params: Dict[str, Any], enc_out: torch.Tensor,
                     hp: WhisperHParams, dtype=torch.bfloat16, itype: str = "f16",
                     parity: bool = False, tp=None):
    """Cross-attention K/V for every decoder layer, (n_text_layer, n_head,
    n_audio_ctx, d_head): dense f32 (itype='f16') or XK8 planes ('q8').

    parity: K pre-scaled by d^-0.25 (the reference scales before its f16
    kv_cross store, src/whisper.cpp:2304-2314) and both planes stored as
    f16, whatever `itype`.  tp: this rank's H/tp heads; an XK8 plane's
    scale is per (head, position), so it needs no collective."""
    blocks = params["dec"]["blocks"]
    n_head = hp.n_text_head // group_size(tp)
    ks, vs = [], []
    for l in range(hp.n_text_layer):
        ks.append(_split_heads(_mm(enc_out, _at(blocks["xk_w"], l), dtype), n_head))
        vs.append(_split_heads(_mm(enc_out, _at(blocks["xv_w"], l), dtype)
                               + blocks["xv_b"][l], n_head))
    xk, xv = torch.stack(ks), torch.stack(vs)
    if parity:
        d_head = hp.n_text_state // hp.n_text_head
        return (xk * float(d_head) ** -0.25).half(), xv.half()
    if itype == "q8":
        return XK8(*_quantize_rows(xk)), XK8(*_quantize_rows(xv))
    return xk, xv


def cross_attend(qh: torch.Tensor, ck, cv, dtype, group: int = 1,
                 return_probs: bool = False, scale: Optional[float] = None):
    """Cross-attention of qh (..., H, Tq, d) against dense (..., H, Tc, d)
    or XK8 planes; every encoder position is visible.  return_probs: also
    the softmax weights (..., H, Tq, Tc), for DTW (decoding/dtw.py; one
    window, group 1).

    group > 1: qh is (W * group, H, Tq, d), rows window-major, and ck/cv
    hold one plane per window, (W, H, Tc, d).  A window's lanes share its
    planes: their queries fold into the query axis, (W, H, group * Tq, d),
    so the planes are read once per window and never copied per lane (the
    JAX package broadcasts them over a lane axis, model.py xkv_group).

    `scale` overrides 1/sqrt(d): the parity mode stores K pre-scaled by
    d^-0.25 and applies the second d^-0.25 on the scores (soft_max_ext's
    scale, src/whisper.cpp:2723)."""
    if group > 1:
        R, H, T, d = qh.shape
        q = qh.reshape(R // group, group, H, T, d).transpose(1, 2)
        out = cross_attend(q.reshape(R // group, H, group * T, d), ck, cv, dtype,
                           scale=scale)
        return out.reshape(R // group, H, group, T, d).transpose(1, 2).reshape(R, H, T, d)
    if scale is None:
        scale = 1.0 / math.sqrt(qh.shape[-1])
    if isinstance(ck, XK8):
        scores = matmul_f32(qh, ck.codes.transpose(-1, -2), dtype)
        scores = scores * ck.scale.unsqueeze(-2) * scale
        probs = torch.softmax(scores, dim=-1)
        out = matmul_f32(probs * cv.scale.unsqueeze(-2), cv.codes, dtype)
    else:
        scores = matmul_f32(qh, ck.transpose(-1, -2), dtype) * scale
        probs = torch.softmax(scores, dim=-1)
        out = matmul_f32(probs, cv, dtype)
    return (out, probs) if return_probs else out


# ---------------------------------------------------------------------------
# Decoder with a static-shape beam KV cache
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Self-attention cache, head-major: kv (L, B, H, 2, C, d), K at
    [..., 0, :, :] and V at [..., 1, :, :]."""

    kv: torch.Tensor

    def reorder(self, beam_idx: torch.Tensor) -> "KVCache":
        """Beam reshuffle: gather along the beam axis."""
        return KVCache(self.kv[:, beam_idx])


class KVCache8(NamedTuple):
    """INT8 self-attention cache: codes kv (L, B, H, 2, C, d) int8 and
    per-position scales (L, B, 2, C) f32 ([..., 0, :] = K, [..., 1, :] = V)."""

    kv: torch.Tensor
    scale: torch.Tensor

    def reorder(self, beam_idx: torch.Tensor) -> "KVCache8":
        return KVCache8(self.kv[:, beam_idx], self.scale[:, beam_idx])


def new_cache(hp: WhisperHParams, n_beam: int, dtype=torch.float32,
              itype: str = "f16", device="cpu", n_cells: Optional[int] = None,
              tp=None):
    """kv_self allocation; itype 'f16' (dense, `dtype` storage) or 'q8'.
    `n_cells` (default n_text_ctx): the natively batched window decoder
    allocates prompt_bucket + n_max cells (decoding/device_loop.py).  tp:
    this rank's H/tp heads (the q8 scales stay whole: they are per row)."""
    h = hp.n_text_head // group_size(tp)
    c = n_cells or hp.n_text_ctx
    shape = (hp.n_text_layer, n_beam, h, 2, c, hp.n_text_state // hp.n_text_head)
    if itype == "q8":
        return KVCache8(torch.zeros(shape, dtype=torch.int8, device=device),
                        torch.zeros((hp.n_text_layer, n_beam, 2, c),
                                    dtype=torch.float32, device=device))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device))


def attn_ctx_buckets(n_ctx: int, n_buckets: int = 4) -> Tuple[int, ...]:
    """Static self-attention context sizes: quarters of n_ctx rounded up to
    128 (8 below 256), deduped, ending at n_ctx.  (128, 256, 384, 448) for
    the whisper family."""
    g = 128 if n_ctx >= 256 else 8
    return tuple(sorted({min(-(-(n_ctx * (k + 1) // n_buckets) // g) * g, n_ctx)
                         for k in range(n_buckets)}))


def decode_mask(kv_head, n_tok: int, A: int, device, attn_mask=None):
    """decode_step's additive self-attention mask over the first A cells,
    (1, 1, n_tok, A), or (B, 1, n_tok, A) with a per-row `attn_mask`:
    causal from the write head `kv_head`, plus `attn_mask`'s first A cells."""
    j = torch.arange(A, device=device)[None, None, :]
    i = torch.arange(n_tok, device=device)[None, :, None]
    mask = torch.where(j < kv_head + i + 1, 0.0, -math.inf).float()[:, None]
    return mask if attn_mask is None else mask + attn_mask[..., :A]


def decode_step(params: Dict[str, Any], tokens: torch.Tensor,
                positions: torch.Tensor, kv_head: int, cache, xk, xv,
                hp: WhisperHParams, dtype=torch.bfloat16, attn_mask=None,
                attn_ctx: Optional[int] = None, xkv_group: int = 1,
                parity: bool = False, tp=None):
    """One batched decoder forward over all lanes (whisper_build_graph_decoder,
    src/whisper.cpp:2464-2842).

    tokens, positions: (n_beam, n_tok) int64; kv_head: cache write offset,
    a host int or a 0-d int64 tensor on the device (the window loop's
    captured step, as the JAX package's traced kv_head); both give the same
    result.  Only the first `attn_ctx` cache cells are read; the caller
    promises kv_head + n_tok <= attn_ctx.  The cell count C comes from the
    cache (the natively batched window decoder allocates more than
    n_text_ctx).  attn_mask: optional extra additive per-row mask, (B, 1,
    n_tok, C) or (B, 1, 1, C): the left-pad cells of a natively batched
    window (decoding/device_loop.py); it reaches K3 through its mask.
    xkv_group > 1: rows are windows of xkv_group lanes, window-major, and
    xk/xv hold one cross-K/V per window, (L, W, H, Tc, d), which the lanes
    share (`cross_attend`).  Returns (logits (n_beam, n_tok, n_vocab) f32,
    the cache updated in place).

    parity: the ggml-CPU f16 emulation (dtype f16, an f16 cache): q and the
    new K column are pre-scaled by d^-0.25 before their f16 roundings, as
    ggml scales Kcur before its cpy into the f16 kv_self
    (src/whisper.cpp:2549-2565), so self-attention runs at scale 1;
    cross-attention K arrives pre-scaled (compute_cross_kv) and takes the
    second d^-0.25 on its scores; GELU goes through the f16 table; a
    QWGGML token embedding feeds the lookup and the logits head.

    tp: `params`, the cache and xk/xv hold this rank's H/tp heads (module
    docstring); the logits are the full ones on every rank."""
    dec = params["dec"]
    n_beam, n_tok = tokens.shape
    d_head = hp.n_text_state // hp.n_text_head
    n_head = hp.n_text_head // group_size(tp)
    n_state = n_head * d_head                 # the rank's q (k, v) width
    n_ctx = cache.kv.shape[-2]
    eps = hp.eps
    device = tokens.device

    tok_embd = dec["tok_embd"]
    if isinstance(tok_embd, CapturedWeight):
        # imatrix capture wraps the logits head's use; the embedding lookup
        # reads the inner tensor
        emb = tok_embd.w[tokens]
    elif isinstance(tok_embd, QWGGML):
        # ggml get_rows dequantizes the quantized embedding rows exactly:
        # code * f32(f16(d)) per 32-block
        rows, scl = tok_embd.codes[tokens], tok_embd.scales[tokens]
        emb = (rows.unflatten(-1, (scl.shape[-1], 32)) * scl[..., None]).flatten(-2)
    elif isinstance(tok_embd, QWeight):
        emb = embed_lookup(tok_embd, tokens)
    else:
        emb = tok_embd[tokens]
    x = (emb + dec["pos_embd"][positions]).float()
    kq_scale = float(d_head) ** -0.25

    A = n_ctx if attn_ctx is None else min(attn_ctx, n_ctx)
    mask = decode_mask(kv_head, n_tok, A, device, attn_mask)
    is_q8 = isinstance(cache, KVCache8)
    # q8 cache: the kernel K3, unless WTPU_DECODE_ATTN=xla (which -nfa sets)
    # asks for the dequantize-and-attend graph, as in the JAX package
    use_dattn = is_q8 and decode_attn.use_kernel()
    if use_dattn:
        kmask = mask[:, 0].expand(n_beam, n_tok, A).contiguous()
    # a write past the last cell lands on the last n_tok cells, as JAX's
    # dynamic_update_slice clamps its start index
    cells = torch.arange(n_tok, device=device)
    cells = cells + (torch.clamp(kv_head, max=n_ctx - n_tok) if torch.is_tensor(kv_head)
                     else min(kv_head, n_ctx - n_tok))

    def to_col(kv2d):  # (B, T, 2, S) -> (B, H, 2, T, d)
        return kv2d.reshape(n_beam, n_tok, 2, n_head, d_head).permute(0, 3, 2, 1, 4)

    blocks_packed = dec.get("blocks_packed")
    for l in range(hp.n_text_layer):
        blk = _layer(dec["blocks"], l)
        if blocks_packed is not None:
            blk.update(blocks_packed[l])
        cxk = xk[l] if not isinstance(xk, XK8) else XK8(xk.codes[l], xk.scale[l])
        cxv = xv[l] if not isinstance(xv, XK8) else XK8(xv.codes[l], xv.scale[l])

        qkv = _mm_fused(x, blk["qkv_w"], dtype,
                        ln=(blk["attn_ln_w"], blk["attn_ln_b"]),
                        bias=blk["qkv_b"], eps=eps)
        q = qkv[..., :n_state]
        kv2 = qkv[..., n_state:].reshape(n_beam, n_tok, 2, n_state)
        if parity:
            # K scaled before the f16 cache store, q before its f16 product
            q = q * kq_scale
            kv2 = torch.stack((kv2[:, :, 0] * kq_scale, kv2[:, :, 1]), 2)
        qh = _split_heads(q, n_head)
        if is_q8:
            codes, sc = _quantize_rows(kv2, tp)             # (B,T,2,S), (B,T,2)
            cache.kv[l].index_copy_(3, cells, to_col(codes))
            cache.scale[l].index_copy_(2, cells, sc.transpose(1, 2))
            if use_dattn:
                out = decode_attn.self_attend_q8(cache.kv, cache.scale, qh, kmask,
                                                 l=l, attn_ctx=A, dtype=dtype)
            else:
                s_l = cache.scale[l]                        # (B, 2, C)
                kh = cache.kv[l, :, :, 0, :A]               # (B, H, A, d) int8
                vh = cache.kv[l, :, :, 1, :A]
                scores = matmul_f32(qh, kh.transpose(-1, -2), dtype)
                scores = (scores * s_l[:, None, None, 0, :A]
                          / math.sqrt(d_head) + mask)
                probs = torch.softmax(scores.float(), dim=-1)
                out = matmul_f32(probs * s_l[:, None, None, 1, :A], vh, dtype)
        else:
            cache.kv[l].index_copy_(3, cells, to_col(kv2).to(cache.kv.dtype))
            kv_l = cache.kv[l]
            out = attention(qh, kv_l[:, :, 0, :A], kv_l[:, :, 1, :A], mask, dtype,
                            scale=1.0 if parity else None)
        x = _row_parallel(_merge_heads(out), blk["o_w"], blk["o_b"], x, dtype, tp)
        q = _mm_fused(x, blk["xq_w"], dtype,
                      ln=(blk["xattn_ln_w"], blk["xattn_ln_b"]),
                      bias=blk["xq_b"], eps=eps)
        out = cross_attend(_split_heads(q, n_head), cxk, cxv, dtype, group=xkv_group,
                           scale=kq_scale if parity else None)
        x = _row_parallel(_merge_heads(out), blk["xo_w"], blk["xo_b"], x, dtype, tp)
        h = _mm_fused(x, blk["mlp0_w"], dtype,
                      ln=(blk["mlp_ln_w"], blk["mlp_ln_b"]),
                      bias=blk["mlp0_b"], act="gelu", eps=eps, parity=parity)
        x = _row_parallel(h, blk["mlp1_w"], blk["mlp1_b"], x, dtype, tp)

    if isinstance(tok_embd, QWeight) and dec.get("tok_embd_t") is not None:
        # logits head on the transposed planes, final layer norm as prologue
        logits = _mm_fused(x, dec["tok_embd_t"], dtype,
                           ln=(dec["ln_w"], dec["ln_b"]), eps=eps)
    else:
        x = layer_norm(x, dec["ln_w"], dec["ln_b"], eps)
        if isinstance(tok_embd, (QWGGML, QWeight)):
            logits = _mm(x, tok_embd, dtype)       # file orientation (V, S)
        else:
            logits = _mm(x, tok_embd.T, dtype)
    return logits.float(), cache


def decode_step_bucketed(params: Dict[str, Any], tokens: torch.Tensor,
                         positions: torch.Tensor, kv_head, cache, xk, xv,
                         hp: WhisperHParams, dtype=torch.bfloat16, attn_mask=None,
                         xkv_group: int = 1, n_buckets: int = 4, parity: bool = False,
                         tp=None):
    """decode_step over the smallest `attn_ctx_buckets` context at or above
    the occupancy kv_head + n_tok (the last bucket past it).  Cells from the
    occupancy on are unwritten and masked, so the result is the full-context
    step's but for the reduction order over fewer cells; on the card the q8
    cache's K3 launches at that context (A < n_text_ctx).

    kv_head: a host int, or a 0-d tensor that is read back once (the JAX
    function switches on the traced value; here the bucket is a host
    choice), so a tensor cannot be passed under CUDA graph capture: the
    window loop captures one graph per bucket segment instead
    (decoding/device_loop.py)."""
    if torch.is_tensor(kv_head):
        if kv_head.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode_step_bucketed reads kv_head back to the host, "
                               "which a CUDA graph capture cannot do; pass a host int")
        kv_head = int(kv_head)
    sizes = attn_ctx_buckets(hp.n_text_ctx, n_buckets)
    occ = kv_head + tokens.shape[1]
    a = next((s for s in sizes if s >= occ), sizes[-1])
    return decode_step(params, tokens, positions, kv_head, cache, xk, xv, hp, dtype=dtype,
                       attn_mask=attn_mask, attn_ctx=a, xkv_group=xkv_group,
                       parity=parity, tp=tp)
