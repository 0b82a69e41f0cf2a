"""Flash attention for the whisper encoder, in two segments.

Port of whisper_tpu/ops/attention.py.  The JAX package calls JAX's library
Pallas `flash_attention` with segment ids (rows below `true_len` form one
segment, the padded rows another) and causal=False; here
`flash_self_attention` launches the Hopper kernel of csrc/flash_attn.cu on
a CUDA tensor and runs `flash_self_attention_plain` on a CPU tensor.

The encoder reaches this route when the fused-QKV kernel (ops/enc_attn.py)
does not apply: WTPU_ENC_ATTN=flash, or a head layout that kernel refuses.
Rows at or past `true_len` are junk that real rows never read; the JAX
wrapper pads T to a multiple of 512 with zeros that fall in the junk
segment, while the kernel here reads q, k and v in place through their
strides and pads nothing, so junk rows may differ from the JAX package's.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

# the library kernel's mask value: finite, so the online rescaling never
# forms inf - inf
MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def flash_self_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               true_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding points, as a
    single-pass softmax: f32 scores of the bf16-rounded q and k times
    1/sqrt(D), the segment mask, p = exp(s - max) with its f32 row sum,
    bf16(p) @ bf16(v) in f32, divided by the sum and rounded to bf16.
    q, k, v (H, T, D); returns (H, T, D) f32."""
    H, T, D = q.shape
    n_real = T if true_len is None else true_len
    qb, kb, vb = (a.to(torch.bfloat16).float() for a in (q, k, v))
    s = torch.matmul(qb, kb.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    real = torch.arange(T, device=q.device) < n_real
    allow = real[:, None] == real[None, :]
    s = torch.where(allow, s, s + MASK_VALUE)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.matmul(p.to(torch.bfloat16).float(), vb) / p.sum(-1, keepdim=True)
    return o.to(torch.bfloat16).float()


def _check_view(name, t, dtype, shape):
    if (t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != shape
            or t.stride(-1) != 1 or t.stride(0) % 4 or t.stride(1) % 4
            or t.data_ptr() % (4 * t.element_size())):
        raise ValueError(
            f"{name}: want a {dtype} CUDA tensor of shape {shape} with unit "
            f"stride along D and 4-element aligned rows, got {t.dtype} "
            f"{tuple(t.shape)} strides {t.stride()} on {t.device}")


def flash_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         true_len: Optional[int] = None) -> torch.Tensor:
    """Full (non-causal) self-attention, (H, T, D) -> (H, T, D) f32 (values
    rounded to bf16), with rows and keys at or past `true_len` in their own
    segment.  q, k and v may be strided head views (the encoder passes
    `_split_heads` views of its fused projection); the result is a
    transposed view of a (T, H, D) buffer, so merging the heads back is
    free."""
    if q.device.type == "cpu":
        return flash_self_attention_plain(q, k, v, true_len)
    from . import _cuda

    H, T, D = q.shape
    n_real = T if true_len is None else true_len
    if D not in (64, 128) or not 0 < n_real <= T:
        raise ValueError(f"flash_self_attention: bad shapes q{tuple(q.shape)} "
                         f"true_len={true_len}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_self_attention: inputs must be f32 or bf16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_view(name, t, q.dtype, (H, T, D))
    out = torch.empty((T, H, D), dtype=torch.float32, device=q.device)
    lib = _cuda.library("flash_attn")
    P = _cuda.ptr
    rc = lib.wtt_flash_attn(
        P(q), P(k), P(v), P(out), H, T, D, n_real, int(q.dtype == torch.bfloat16),
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        out.stride(1), out.stride(0), 1.0 / math.sqrt(D), _cuda.stream_of(q))
    _cuda.check(lib, "wtt_flash_attn", rc)
    flash_self_attention.launches += 1
    return out.transpose(0, 1)


flash_self_attention.launches = 0

_flash_enabled = True  # CLI -nfa / whisper-cli's --no-flash-attn analogue


def set_flash_enabled(enable: bool) -> None:
    """Global switch for the flash route (whisper-cli -nfa)."""
    global _flash_enabled
    _flash_enabled = bool(enable)


def use_flash(t: int, dtype=torch.bfloat16) -> bool:
    """Take the flash route?  The kernel computes in bf16, so only for a
    bf16 compute type (an f32 encode keeps the exact plain graph), and only
    where the score matrix is large enough to matter."""
    return _flash_enabled and t >= 256 and dtype == torch.bfloat16
