"""Encoder self-attention over the fused QKV projection.

Port of whisper_tpu/ops/enc_attn.py: q/k/v of every head are read straight
from the (T, 3S) projection output and the result comes back merged as
(T, S) bf16 — no head transposes.  Key columns at or past `true_len` (the
encoder's pad rows) are masked with -1e30; pad rows themselves stay
unmasked, so no softmax row is ever fully masked.  On a CUDA tensor
`self_attention_qkv` launches the Hopper kernel of csrc/enc_attn.cu; on a
CPU tensor it runs `self_attention_qkv_plain`.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch


def use_kernel() -> bool:
    """Route encoder self-attention through this kernel?

    WTPU_ENC_ATTN (auto|pallas|xla|flash), as in the JAX package: `pallas`
    forces the kernel, `xla` and `flash` turn it off.  `auto` is the kernel:
    the port runs on one card and has no mesh (the JAX package keeps the
    flash/plain route under a multi-device mesh, since the kernel does not
    partition by head)."""
    return os.environ.get("WTPU_ENC_ATTN", "auto") not in ("xla", "flash")


def self_attention_qkv_plain(qkv: torch.Tensor, n_head: int,
                             true_len: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version with the TPU kernel's rounding points: q scaled
    by bf16(1/sqrt(d)) in bf16, f32 scores, p = bf16(exp(s - max)), output
    (p @ v) / sum(p) in f32, stored as bf16."""
    t, s3 = qkv.shape
    s = s3 // 3
    d = s // n_head
    n_real = t if true_len is None else true_len
    x = qkv.to(torch.bfloat16)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.bfloat16)

    def heads(i):                                    # (H, T, d)
        return x[:, i * s:(i + 1) * s].reshape(t, n_head, d).transpose(0, 1)

    q = (heads(0) * scale).float()
    k, v = heads(1).float(), heads(2).float()
    sc = torch.matmul(q, k.transpose(-1, -2))        # (H, T, T) f32
    if n_real < t:
        col = torch.arange(t, device=qkv.device)
        sc = sc + torch.where(col < n_real, 0.0, -1e30).to(sc)
    p = torch.exp(sc - sc.amax(-1, keepdim=True)).to(torch.bfloat16).float()
    o = torch.matmul(p, v) / p.sum(-1, keepdim=True)
    return o.transpose(0, 1).reshape(t, s).to(torch.bfloat16)


def self_attention_qkv(qkv: torch.Tensor, n_head: int,
                       true_len: Optional[int] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v for all heads, straight off the fused
    projection.  qkv: (T, 3S); returns (T, S) bf16."""
    if qkv.device.type == "cpu":
        return self_attention_qkv_plain(qkv, n_head, true_len)
    from . import _cuda
    from .qmm import _check

    t, s3 = qkv.shape
    s = s3 // 3
    d = s // n_head
    n_real = t if true_len is None else true_len
    if d not in (64, 128) or s % d or s3 != 3 * s or t % 16 or not 0 < n_real <= t:
        raise ValueError(f"self_attention_qkv: bad shapes qkv{tuple(qkv.shape)} "
                         f"n_head={n_head} true_len={true_len}")
    if 16 * t * 4 + 16 * d * 4 > 227 * 1024:
        raise ValueError(f"self_attention_qkv: T={t} too long for one score tile")
    x = qkv.to(torch.bfloat16).contiguous()
    _check("qkv", x, torch.bfloat16, (t, s3))
    out = torch.empty((t, s), dtype=torch.bfloat16, device=qkv.device)
    lib = _cuda.library("enc_attn")
    rc = lib.wtt_self_attention_qkv(_cuda.ptr(x), _cuda.ptr(out), t, s, d,
                                    n_real, _cuda.stream_of(x))
    _cuda.check(lib, "wtt_self_attention_qkv", rc)
    self_attention_qkv.launches += 1
    return out


self_attention_qkv.launches = 0
