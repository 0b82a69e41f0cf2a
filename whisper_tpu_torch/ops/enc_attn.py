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
from typing import Optional, Tuple

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


def kernel_shapes(qkv: torch.Tensor, n_head: int,
                  true_len: Optional[int] = None) -> Tuple[int, int, int, int]:
    """(T, S, d, true_len) of a call csrc/enc_attn.cu takes; ValueError for
    one it does not: a (T, 3S) f32 or bf16 buffer, heads of 64 or 128, T a
    multiple of 16, 0 < true_len <= T."""
    if qkv.ndim != 2 or qkv.dtype not in (torch.float32, torch.bfloat16) or n_head < 1:
        raise ValueError(f"self_attention_qkv: want a 2-D f32 or bf16 (T, 3S) buffer, "
                         f"got {qkv.dtype} {tuple(qkv.shape)} n_head={n_head}")
    t, s3 = qkv.shape
    s = s3 // 3
    d = s // n_head
    n_real = t if true_len is None else true_len
    if (d not in (64, 128) or d * n_head != s or s3 != 3 * s or t < 16 or t % 16
            or not 0 < n_real <= t):
        raise ValueError(f"self_attention_qkv: bad shapes qkv{tuple(qkv.shape)} "
                         f"n_head={n_head} true_len={true_len}")
    return t, s, d, n_real


def self_attention_qkv(qkv: torch.Tensor, n_head: int,
                       true_len: Optional[int] = None) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v for all heads, straight off the fused
    projection.  qkv: (T, 3S) f32 (the encoder's projection) or bf16, read
    as it is and rounded to bf16 in the kernel; returns (T, S) bf16."""
    if qkv.device.type == "cpu":
        return self_attention_qkv_plain(qkv, n_head, true_len)
    from . import _cuda
    from .qmm import _check

    t, s, d, n_real = kernel_shapes(qkv, n_head, true_len)
    _check("qkv", qkv, qkv.dtype, (t, 3 * s))
    if qkv.data_ptr() % 16:
        raise ValueError("self_attention_qkv: qkv must be 16-byte aligned")
    out = torch.empty((t, s), dtype=torch.bfloat16, device=qkv.device)
    lib = _cuda.library("enc_attn")
    rc = lib.wtt_self_attention_qkv(_cuda.ptr(qkv), _cuda.ptr(out), t, s, d, n_real,
                                    int(qkv.dtype == torch.bfloat16),
                                    _cuda.stream_of(qkv))
    _cuda.check(lib, "wtt_self_attention_qkv", rc)
    self_attention_qkv.launches += 1
    return out


self_attention_qkv.launches = 0
