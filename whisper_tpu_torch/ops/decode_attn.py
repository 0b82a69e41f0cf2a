"""Decode-step self-attention over the stacked int8 KV cache.

Port of whisper_tpu/ops/decode_attn.py.  The per-position scales factor out
of both products (scores = (q @ codes^T) * scale_j, out = (probs * scale_j)
@ codes), so the attention reads the int8 cache directly and never writes a
dequantized form.  On a CUDA tensor `self_attend_q8` launches the Hopper
kernel of csrc/decode_attn.cu; on a CPU tensor it runs
`self_attend_q8_plain`.
"""

from __future__ import annotations

import math
import os

import torch


def use_kernel() -> bool:
    """Route decode_step's q8 self-attention through this kernel?

    WTPU_DECODE_ATTN (auto|pallas|xla), as in the JAX package: `xla` (which
    -nfa sets) takes the dequantize-and-attend graph instead; `auto` and
    `pallas` take the kernel (the JAX package's `auto` means a real TPU;
    here it is the card, or the kernel's plain version on a CPU tensor)."""
    return os.environ.get("WTPU_DECODE_ATTN", "auto") != "xla"


def self_attend_q8_plain(kv: torch.Tensor, scale: torch.Tensor,
                         qh: torch.Tensor, mask: torch.Tensor, *, l: int,
                         attn_ctx: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of `self_attend_q8`, with the TPU kernel's
    arithmetic: f32 scores of the dtype-rounded q against the codes, scaled
    by s_k / sqrt(d), additive mask, f32 softmax, (p * s_v) rounded to
    dtype, f32 product with the value codes."""
    A = attn_ctx
    d = qh.shape[-1]
    k = kv[l, :, :, 0, :A].float()                        # (B, H, A, d)
    v = kv[l, :, :, 1, :A].float()
    sk = scale[l, :, 0, :A]                               # (B, A)
    sv = scale[l, :, 1, :A]
    q = qh.to(dtype).float()                              # (B, H, G, d)
    scores = torch.matmul(q, k.transpose(-1, -2))         # (B, H, G, A)
    scores = scores * sk[:, None, None, :] * (1.0 / math.sqrt(d)) + mask[:, None]
    p = torch.softmax(scores, dim=-1)
    p = (p * sv[:, None, None, :]).to(dtype).float()
    return torch.matmul(p, v)


def self_attend_q8(kv: torch.Tensor, scale: torch.Tensor, qh: torch.Tensor,
                   mask: torch.Tensor, *, l: int, attn_ctx: int,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """Decode-step self-attention for layer `l` against the stacked cache.

    kv    (L, B, H, 2, C, d) int8   — KVCache8.kv (K at [..., 0, :, :])
    scale (L, B, 2, C) f32          — KVCache8.scale
    qh    (B, H, G, d)              — this step's queries
    mask  (B, G, A) f32             — additive, truncated to A = attn_ctx
    Returns (B, H, G, d) f32.
    """
    L, B, H, two, C, d = kv.shape
    G = qh.shape[2]
    A = attn_ctx
    if tuple(mask.shape) != (B, G, A):
        raise ValueError(f"self_attend_q8: mask {tuple(mask.shape)} != {(B, G, A)}")
    if kv.device.type == "cpu":
        return self_attend_q8_plain(kv, scale, qh, mask, l=l, attn_ctx=A,
                                    dtype=dtype)
    from . import _cuda
    from .qmm import _check

    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"self_attend_q8: compute dtype {dtype} not supported")
    if two != 2 or d % 16 or 128 % d or not (1 <= A <= C) or not (0 <= l < L):
        raise ValueError(f"self_attend_q8: bad shapes kv{tuple(kv.shape)} "
                         f"A={A} l={l}")
    q = qh.to(dtype).contiguous()
    _check("kv", kv, torch.int8, (L, B, H, 2, C, d))
    _check("scale", scale, torch.float32, (L, B, 2, C))
    _check("qh", q, dtype, (B, H, G, d))
    _check("mask", mask, torch.float32, (B, G, A))
    out = torch.empty((B, H, G, d), dtype=torch.float32, device=kv.device)
    lib = _cuda.library("decode_attn")
    P = _cuda.ptr
    rc = lib.wtt_self_attend_q8(P(kv), P(scale), P(q),
                                int(dtype == torch.bfloat16), P(mask), P(out),
                                B, H, G, C, d, A, l,
                                int(dtype == torch.bfloat16),
                                _cuda.stream_of(kv))
    _cuda.check(lib, "wtt_self_attend_q8", rc)
    self_attend_q8.launches += 1
    return out


self_attend_q8.launches = 0
