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

One deliberate difference from the JAX package: `decode_step` writes the new
K/V column into the cache IN PLACE (the JAX functions are pure and return a
new cache), which saves a cache copy per step.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ...ops import attention as flash
from ...ops import decode_attn, enc_attn
from ...ops.qmm import QWeight, QWeightT, embed_lookup, qmmt_auto, qmmt_fused_auto
from .hparams import WhisperHParams


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # ggml_gelu is the tanh approximation (ggml/src/ggml-cpu/ops.cpp GELU LUT)
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
    """The JAX package's imatrix capture shim (tools/make_imatrix.py): not
    ported, so building one raises."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "imatrix capture (CapturedWeight) is not ported to whisper_tpu_torch")


def _dequant(qw: QWeight) -> torch.Tensor:
    """(R, K) f32 from packed planes."""
    qk = qw.codes.shape[-1] // qw.scales.shape[-1]
    w = qw.codes.float() * torch.repeat_interleave(qw.scales, qk, dim=-1)
    if qw.mins is not None:
        w = w + torch.repeat_interleave(qw.mins, qk, dim=-1)
    return w


def _mm(x: torch.Tensor, w, dtype) -> torch.Tensor:
    """x @ w with f32 accumulation; operands rounded to `dtype`.  A QWeightT
    goes through the streaming dequant kernel (ops/qmm.py qmmt); a QWeight
    ((out, in) planes) is dequantized first."""
    if isinstance(w, QWeightT):
        return qmmt_auto(x, w, dtype)
    if isinstance(w, QWeight):
        return matmul_f32(x, _dequant(w).T, dtype)
    return matmul_f32(x, w, dtype)


def _mm_fused(x: torch.Tensor, w, dtype, *, ln=None, bias=None, res=None,
              act=None, eps: float = 1e-5) -> torch.Tensor:
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
        y = _gelu(y)
    if res is not None:
        y = y + res
    return y


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
              mask: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """q:(...,H,Tq,d) k,v:(...,H,Tk,d) mask additive f32 or None."""
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


def conv_stem(enc_params: Dict[str, Any], mel: torch.Tensor, dtype) -> torch.Tensor:
    """2x conv1d + GELU (whisper_build_graph_conv, src/whisper.cpp:2009-2021).

    mel: (n_mels, 2*n_ctx) -> (n_ctx, n_state)"""
    x = _gelu(_conv1d(mel, enc_params["conv1_w"], 1, dtype)
              + enc_params["conv1_b"])                       # (W, S)
    return _gelu(_conv1d(x.T, enc_params["conv2_w"], 2, dtype)
                 + enc_params["conv2_b"])


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
                   eps: float, dtype, true_len: Optional[int] = None) -> torch.Tensor:
    """One pre-LN transformer block; rows true_len.. are junk padding kept
    in their own attention segment."""
    h = layer_norm(x, blk["attn_ln_w"], blk["attn_ln_b"], eps)
    n_state = x.shape[-1]
    qkv = _mm(h, blk["qkv_w"], dtype) + blk["qkv_b"]
    t_pad = qkv.shape[-2]
    route = _enc_attn_route(dtype, t_pad, n_head, n_state // n_head)
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
            out = attention(qh, kh, vh, m, dtype)
        merged = _merge_heads(out)
    x = x + _mm(merged, blk["o_w"], dtype) + blk["o_b"]
    h = layer_norm(x, blk["mlp_ln_w"], blk["mlp_ln_b"], eps)
    h = _gelu(_mm(h, blk["mlp0_w"], dtype) + blk["mlp0_b"])
    return x + _mm(h, blk["mlp1_w"], dtype) + blk["mlp1_b"]


def _layer(blocks: Dict[str, Any], l: int) -> Dict[str, Any]:
    return {k: v[l] for k, v in blocks.items()}


def encode(params: Dict[str, Any], mel: torch.Tensor, hp: WhisperHParams,
           dtype=torch.bfloat16, pad_to: Optional[int] = None) -> torch.Tensor:
    """mel (n_mels, 2*n_ctx) -> encoder embeddings (n_ctx, n_state).

    Padded residency: when the flash route is on (`use_flash`), the
    residual stream is padded ONCE to a multiple of 512 (1500 -> 1536) for
    the whole block stack and sliced back before ln_post; the pad rows are
    their own attention segment, so real rows are unaffected.  With flash
    off (-nfa) the stream stays unpadded, as in the JAX package.  `pad_to`
    forces a padded length."""
    enc = params["enc"]
    x = conv_stem(enc, mel, dtype)
    n_ctx = x.shape[0]
    x = x + enc["pos_embd"][:n_ctx]
    tp = pad_to
    if tp is None and flash.use_flash(n_ctx, dtype):
        tp = flash._round_up(max(n_ctx, 512), 512)
    true_len = None
    if tp is not None and tp > n_ctx:
        x = F.pad(x, (0, 0, 0, tp - n_ctx))
        true_len = n_ctx
    for l in range(hp.n_audio_layer):
        x = _encoder_block(x, _layer(enc["blocks"], l), hp.n_audio_head, hp.eps,
                           dtype, true_len=true_len)
    return layer_norm(x[:n_ctx], enc["ln_post_w"], enc["ln_post_b"], hp.eps)


class XK8(NamedTuple):
    """INT8 cross-attention K or V plane: codes (..., H, Tc, d) int8 with a
    per-(head, position) scale (..., H, Tc) f32 that factors out of both
    cross-attention products."""

    codes: torch.Tensor
    scale: torch.Tensor


def _quantize_rows(x: torch.Tensor):
    """(..., S) -> (codes int8, scale (...) f32); per-row symmetric."""
    x32 = x.float()
    scale = x32.abs().amax(-1) / 127.0
    inv = torch.where(scale > 0, 1.0 / torch.where(scale == 0, 1.0, scale), 0.0)
    codes = torch.clamp(torch.round(x32 * inv[..., None]), -127, 127).to(torch.int8)
    return codes, scale


def compute_cross_kv(params: Dict[str, Any], enc_out: torch.Tensor,
                     hp: WhisperHParams, dtype=torch.bfloat16, itype: str = "f16"):
    """Cross-attention K/V for every decoder layer, (n_text_layer, n_head,
    n_audio_ctx, d_head): dense f32 (itype='f16') or XK8 planes ('q8')."""
    blocks = params["dec"]["blocks"]
    ks, vs = [], []
    for l in range(hp.n_text_layer):
        ks.append(_split_heads(_mm(enc_out, blocks["xk_w"][l], dtype), hp.n_text_head))
        vs.append(_split_heads(_mm(enc_out, blocks["xv_w"][l], dtype)
                               + blocks["xv_b"][l], hp.n_text_head))
    xk, xv = torch.stack(ks), torch.stack(vs)
    if itype == "q8":
        return XK8(*_quantize_rows(xk)), XK8(*_quantize_rows(xv))
    return xk, xv


def cross_attend(qh: torch.Tensor, ck, cv, dtype) -> torch.Tensor:
    """Cross-attention of qh (..., H, Tq, d) against dense (H, Tc, d) or
    XK8 planes; every encoder position is visible."""
    scale = 1.0 / math.sqrt(qh.shape[-1])
    if isinstance(ck, XK8):
        scores = matmul_f32(qh, ck.codes.transpose(-1, -2), dtype)
        scores = scores * ck.scale.unsqueeze(-2) * scale
        probs = torch.softmax(scores, dim=-1)
        return matmul_f32(probs * cv.scale.unsqueeze(-2), cv.codes, dtype)
    scores = matmul_f32(qh, ck.transpose(-1, -2), dtype) * scale
    return matmul_f32(torch.softmax(scores, dim=-1), cv, dtype)


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
              itype: str = "f16", device="cpu"):
    """kv_self allocation; itype 'f16' (dense, `dtype` storage) or 'q8'."""
    h = hp.n_text_head
    c = hp.n_text_ctx
    shape = (hp.n_text_layer, n_beam, h, 2, c, hp.n_text_state // h)
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


def decode_step(params: Dict[str, Any], tokens: torch.Tensor,
                positions: torch.Tensor, kv_head: int, cache, xk, xv,
                hp: WhisperHParams, dtype=torch.bfloat16, attn_mask=None,
                attn_ctx: Optional[int] = None):
    """One batched decoder forward over all lanes (whisper_build_graph_decoder,
    src/whisper.cpp:2464-2842).

    tokens, positions: (n_beam, n_tok) int64; kv_head: cache write offset
    (host int).  Only the first `attn_ctx` cache cells are read; the caller
    promises kv_head + n_tok <= attn_ctx.  attn_mask: optional extra
    additive (B, 1, 1, C) mask.  Returns (logits (n_beam, n_tok, n_vocab)
    f32, the cache updated in place)."""
    dec = params["dec"]
    n_beam, n_tok = tokens.shape
    n_head = hp.n_text_head
    n_state = hp.n_text_state
    d_head = n_state // n_head
    n_ctx = cache.kv.shape[-2]
    eps = hp.eps
    device = tokens.device

    tok_embd = dec["tok_embd"]
    emb = embed_lookup(tok_embd, tokens) if isinstance(tok_embd, QWeight) \
        else tok_embd[tokens]
    x = (emb + dec["pos_embd"][positions]).float()

    A = n_ctx if attn_ctx is None else min(attn_ctx, n_ctx)
    j = torch.arange(A, device=device)[None, None, :]
    i = torch.arange(n_tok, device=device)[None, :, None]
    mask = torch.where(j < kv_head + i + 1, 0.0, -math.inf).float()[:, None]  # (1,1,T,A)
    if attn_mask is not None:
        mask = mask + attn_mask[..., :A]
    is_q8 = isinstance(cache, KVCache8)
    # q8 cache: the kernel K3, unless WTPU_DECODE_ATTN=xla (which -nfa sets)
    # asks for the dequantize-and-attend graph, as in the JAX package
    use_dattn = is_q8 and decode_attn.use_kernel()
    if use_dattn:
        kmask = mask[:, 0].expand(n_beam, n_tok, A).contiguous()
    # a write past the last cell lands on the last n_tok cells, as JAX's
    # dynamic_update_slice clamps its start index
    start = min(kv_head, n_ctx - n_tok)

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
        qh = _split_heads(qkv[..., :n_state], n_head)
        kv2 = qkv[..., n_state:].reshape(n_beam, n_tok, 2, n_state)
        if is_q8:
            codes, sc = _quantize_rows(kv2)                 # (B,T,2,S), (B,T,2)
            cache.kv[l, :, :, :, start:start + n_tok] = to_col(codes)
            cache.scale[l, :, :, start:start + n_tok] = sc.transpose(1, 2)
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
            cache.kv[l, :, :, :, start:start + n_tok] = to_col(kv2).to(cache.kv.dtype)
            kv_l = cache.kv[l]
            out = attention(qh, kv_l[:, :, 0, :A], kv_l[:, :, 1, :A], mask, dtype)
        x = _mm_fused(_merge_heads(out), blk["o_w"], dtype, bias=blk["o_b"], res=x)
        q = _mm_fused(x, blk["xq_w"], dtype,
                      ln=(blk["xattn_ln_w"], blk["xattn_ln_b"]),
                      bias=blk["xq_b"], eps=eps)
        out = cross_attend(_split_heads(q, n_head), cxk, cxv, dtype)
        x = _mm_fused(_merge_heads(out), blk["xo_w"], dtype, bias=blk["xo_b"], res=x)
        h = _mm_fused(x, blk["mlp0_w"], dtype,
                      ln=(blk["mlp_ln_w"], blk["mlp_ln_b"]),
                      bias=blk["mlp0_b"], act="gelu", eps=eps)
        x = _mm_fused(h, blk["mlp1_w"], dtype, bias=blk["mlp1_b"], res=x)

    if isinstance(tok_embd, QWeight) and dec.get("tok_embd_t") is not None:
        # logits head on the transposed planes, final layer norm as prologue
        logits = _mm_fused(x, dec["tok_embd_t"], dtype,
                           ln=(dec["ln_w"], dec["ln_b"]), eps=eps)
    else:
        x = layer_norm(x, dec["ln_w"], dec["ln_b"], eps)
        w = _dequant(tok_embd) if isinstance(tok_embd, QWeight) else tok_embd
        logits = _mm(x, w.T, dtype)
    return logits.float(), cache
