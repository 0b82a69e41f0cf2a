"""Streaming dequant x matmul over block-quantized weight planes.

Port of whisper_tpu/ops/qmm.py's transposed-plane path.  Block-quantized
weights live on the device as struct-of-arrays planes: int8 codes plus f32
per-block scales (and mins for affine formats), so the decode matmuls read
1.125 B per weight instead of bf16's 2.

  x:        (T, K)    activations
  codes_t:  (K, R)    int8 codes, TRANSPOSED (contiguous along the output R;
                      installed with rows pitched to 64 columns, see
                      `pitch_qweight_t`)
  scales_t: (K/qk, R) f32 per-block scales (qk = 32, 16 for NVFP4)
  mins_t:   (K/qk, R) f32 per-block offsets of affine formats, or None

`qmmt_fused` computes act(LN(x) @ dequant + bias) + residual and `qmmt` the
bare product.  On a CUDA tensor both launch the Hopper kernel of
csrc/qmmt.cu; on a CPU tensor they run the plain PyTorch version beside
them, which the tests hold to the JAX package's Pallas kernel.

`qmm` is the product over planes in file orientation, codes (R, K), with
the weight dequantized to bf16 before a bf16 product (the JAX package's
`qmm`, which whisper-bench -w 2 times): csrc/qmm.cu on a CUDA tensor,
`qmm_plain` on a CPU tensor.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

QK = 32  # block size of the *_0 formats (ggml-common.h:180)


class QWeight(NamedTuple):
    """Packed quantized weight, logical shape (R, K) in file orientation;
    dequant = codes * scale (+ min for affine formats)."""

    codes: torch.Tensor   # (R, K) int8
    scales: torch.Tensor  # (R, K // qk) f32
    mins: Optional[torch.Tensor] = None

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.codes.shape)


class QWeightT(NamedTuple):
    """Transposed planes: codes (K, R), so a column tile of the output reads
    contiguous bytes of every code row."""

    codes_t: torch.Tensor   # (K, R) int8
    scales_t: torch.Tensor  # (K // qk, R) f32
    mins_t: Optional[torch.Tensor] = None

    @property
    def shape(self) -> Tuple[int, int]:
        # logical (R, K), matching QWeight's convention
        return (self.codes_t.shape[1], self.codes_t.shape[0])


PITCH = 64  # columns: rows of an installed transposed plane are padded to this


def pitch_plane(a, dtype, device="cpu") -> Optional[torch.Tensor]:
    """A (K, R) plane (numpy array or tensor) installed on `device` as the
    (K, R) view of a zero-padded (K, R_pad) buffer, R_pad the next multiple
    of PITCH, so every row starts 16-byte aligned for csrc/qmmt.cu."""
    if a is None:
        return None
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.array(a, order="C"))
    K, R = a.shape
    buf = torch.zeros((K, -(-R // PITCH) * PITCH), dtype=dtype, device=device)
    buf[:, :R] = a
    return buf[:, :R]


def pitch_qweight_t(codes_t, scales_t, mins_t=None, device="cpu") -> QWeightT:
    """The transposed planes (K, R) and (K/qk, R) as `QWeightT` on `device`,
    each row pitched to a multiple of PITCH columns (`pitch_plane`); the
    install that runtime/context.py and models/whisper/convert.py share."""
    return QWeightT(pitch_plane(codes_t, torch.int8, device),
                    pitch_plane(scales_t, torch.float32, device),
                    pitch_plane(mins_t, torch.float32, device))


def _gelu(y: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(y, approximate="tanh")


def qmmt_fused_plain(x, codes_t, scales_t, mins_t=None, ln_w=None, ln_b=None,
                     bias=None, residual=None, act: Optional[str] = None,
                     eps: float = 1e-5, dtype=torch.bfloat16) -> torch.Tensor:
    """The plain PyTorch version of `qmmt_fused`, with the TPU kernel's
    rounding points but for the layer norm's statistics: mean and variance
    from f64 sums of x and x^2, rounded to f32, as csrc/qmmt.cu computes
    them (so both round the normalised rows to `dtype` alike), the
    normalisation in f32; rows rounded to `dtype`, one f32 dot per qk-block
    scaled after the dot, affine sum(x_blk) * min, then bias, tanh-GELU and
    residual in f32."""
    T, K = x.shape
    nb, R = scales_t.shape
    qk = K // nb
    h = x.float()
    if ln_w is not None:
        h64 = h.double()
        mean = h64.sum(-1, keepdim=True) / K
        var = h64.square().sum(-1, keepdim=True) / K - mean * mean
        eps32 = float(torch.tensor(eps, dtype=torch.float32))    # the kernel's f32 eps
        rstd = (1.0 / torch.sqrt(var + eps32)).float()
        h = (h - mean.float()) * rstd * ln_w.float() + ln_b.float()
    xb = h.to(dtype).float().reshape(T, nb, qk).transpose(0, 1)   # (nb, T, qk)
    part = torch.bmm(xb, codes_t.reshape(nb, qk, R).float())      # (nb, T, R)
    y = (part * scales_t.float()[:, None, :]).sum(0)
    if mins_t is not None:
        y = y + (xb.sum(-1)[:, :, None] * mins_t.float()[:, None, :]).sum(0)
    if bias is not None:
        y = y + bias.float()
    if act == "gelu":
        y = _gelu(y)
    if residual is not None:
        y = y + residual.float()
    return y


def _check(name, t, dtype, shape):
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: want a contiguous {dtype} CUDA tensor of shape {shape}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def _check_plane(name, t, dtype, shape):
    """A transposed plane: rows contiguous, each starting 16-byte aligned
    (the layout `pitch_qweight_t` installs)."""
    if t.device.type != "cuda" or t.dtype != dtype or tuple(t.shape) != shape \
            or t.stride(1) != 1 or t.stride(0) < shape[1] \
            or (t.stride(0) * t.element_size()) % 16 or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: want a {dtype} CUDA plane of shape {shape} with 16-byte "
            f"aligned rows (ops/qmm.py pitch_qweight_t), got {t.dtype} "
            f"{tuple(t.shape)} strides {t.stride()} on {t.device}")


TILE = 64            # output columns per block of csrc/qmmt.cu
# from this many activation rows on (a whole mma.sync N of 8), a bf16 product
# runs on the tensor cores instead of CUDA-core FMAs; chip_smoke.py times
# both routes at T = 1, 5 and 32
MMA_MIN_T = 8
_N_COUNTERS = 1 << 16
_COUNTERS = {}       # device -> per-tile arrival counters, all 0 between launches


def slice_rows(K: int, R: int, qk: int, n_sm: int, T: int) -> int:
    """Rows of K per block of csrc/qmmt.cu for T activation rows: 8
    qk-blocks, or 4 where 8 would leave fewer than two blocks per SM (four
    at T = 1, where a block's products are short); chip_smoke.py times
    128, 256 and 512 rows at T = 1 and 5."""
    tiles = -(-R // TILE)
    ks = 8 * qk
    if tiles * -(-K // ks) < (4 if T == 1 else 2) * n_sm:
        ks = 4 * qk
    return min(ks, K)


def _use_mma(T: int, qk: int, dtype) -> bool:
    """The tensor-core product takes bf16 rows and whole 16-row k-steps
    inside each qk-block."""
    return dtype == torch.bfloat16 and qk % 16 == 0 and T >= MMA_MIN_T


def _counters(device) -> torch.Tensor:
    c = _COUNTERS.get(device)
    if c is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("qmmt: launch once before capturing a CUDA graph")
        c = _COUNTERS[device] = torch.zeros(_N_COUNTERS, dtype=torch.int32,
                                            device=device)
    return c


def _launch_qmmt(x, codes_t, scales_t, mins_t, ln_w, ln_b, bias, residual,
                 act, eps, dtype) -> torch.Tensor:
    from . import _cuda

    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"qmmt: compute dtype {dtype} not supported")
    if act not in (None, "gelu"):
        raise ValueError(f"qmmt: activation {act!r} not supported")
    T, K = x.shape
    Kc, R = codes_t.shape
    nb = scales_t.shape[0]
    if T < 1 or R < 1 or Kc != K or nb < 1 or K % nb or K // nb not in (8, 16, 32):
        raise ValueError(f"qmmt: bad shapes x{tuple(x.shape)} "
                         f"codes_t{tuple(codes_t.shape)} "
                         f"scales_t{tuple(scales_t.shape)}")
    if ln_w is not None and min(T, 8) * K * 4 > 160 * 1024:
        raise ValueError(f"qmmt: K={K} too wide for the staged rows")
    qk = K // nb
    _check("x", x, torch.float32, (T, K))
    if x.data_ptr() % 16:
        raise ValueError("qmmt: x must be 16-byte aligned")
    _check_plane("codes_t", codes_t, torch.int8, (K, R))
    _check_plane("scales_t", scales_t, torch.float32, (nb, R))
    if mins_t is not None:
        _check_plane("mins_t", mins_t, torch.float32, (nb, R))
        if mins_t.stride(0) != scales_t.stride(0):
            raise ValueError("qmmt: mins_t and scales_t need the same pitch")
    if ln_w is not None:
        _check("ln_w", ln_w, torch.float32, (K,))
        _check("ln_b", ln_b, torch.float32, (K,))
    if bias is not None:
        _check("bias", bias, torch.float32, (R,))
    if residual is not None:
        _check("residual", residual, torch.float32, (T, R))
    tiles = -(-R // TILE)
    if tiles > _N_COUNTERS:
        raise ValueError(f"qmmt: R={R} has more tiles than counters")
    ks = slice_rows(K, R, qk, _n_sm(x.device), T)
    slices = -(-K // ks)
    ws = (torch.empty(tiles * slices * T * TILE, dtype=torch.float32,
                      device=x.device) if slices > 1 else None)
    out = torch.empty((T, R), dtype=torch.float32, device=x.device)
    lib = _cuda.library("qmmt")
    P = _cuda.ptr
    rc = lib.wtt_qmmt(P(x), P(codes_t), P(scales_t), P(mins_t), P(ln_w),
                      P(ln_b), P(bias), P(residual), P(out), P(ws),
                      P(_counters(x.device)), T, K, R, codes_t.stride(0),
                      scales_t.stride(0), qk, ks, int(dtype == torch.bfloat16),
                      int(act == "gelu"), int(_use_mma(T, qk, dtype)), float(eps),
                      _cuda.stream_of(x))
    _cuda.check(lib, "wtt_qmmt", rc)
    return out


@functools.lru_cache(maxsize=None)
def _n_sm(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def qmmt_fused(x, codes_t, scales_t, mins_t=None, ln_w=None, ln_b=None,
               bias=None, residual=None, act: Optional[str] = None,
               eps: float = 1e-5, dtype=torch.bfloat16) -> torch.Tensor:
    """act(LN(x) @ dequant(codes_t, scales_t[, mins_t]) + bias) + residual,
    (T, R) f32.  A CUDA tensor launches the kernel (csrc/qmmt.cu), a CPU
    tensor takes `qmmt_fused_plain`."""
    if (ln_w is None) != (ln_b is None):
        raise ValueError("qmmt_fused: ln_w and ln_b go together")
    if x.device.type == "cpu":
        return qmmt_fused_plain(x, codes_t, scales_t, mins_t, ln_w, ln_b, bias,
                                residual, act, eps, dtype)
    out = _launch_qmmt(x, codes_t, scales_t, mins_t, ln_w, ln_b, bias,
                       residual, act, eps, dtype)
    qmmt_fused.launches += 1
    return out


qmmt_fused.launches = 0


def qmmt(x, codes_t, scales_t, mins_t=None, dtype=torch.bfloat16) -> torch.Tensor:
    """x[T, K] @ dequant(codes_t, scales_t[, mins_t]) -> (T, R) f32: the same
    kernel as `qmmt_fused` with its prologue and epilogue off."""
    if x.device.type == "cpu":
        return qmmt_fused_plain(x, codes_t, scales_t, mins_t, dtype=dtype)
    out = _launch_qmmt(x, codes_t, scales_t, mins_t, None, None, None, None,
                       None, 1e-5, dtype)
    qmmt.launches += 1
    return out


qmmt.launches = 0


def qmmt_fused_auto(x: torch.Tensor, qw: QWeightT, dtype=torch.bfloat16, *,
                    ln=None, bias=None, residual=None,
                    act: Optional[str] = None, eps: float = 1e-5) -> torch.Tensor:
    """`qmmt_fused` over arbitrary leading dims of x."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).float().contiguous()
    r2 = (residual.reshape(-1, residual.shape[-1]).float().contiguous()
          if residual is not None else None)
    y = qmmt_fused(x2, qw.codes_t, qw.scales_t, qw.mins_t,
                   ln_w=ln[0] if ln is not None else None,
                   ln_b=ln[1] if ln is not None else None,
                   bias=bias, residual=r2, act=act, eps=eps, dtype=dtype)
    return y.reshape(*lead, y.shape[-1])


def qmmt_auto(x: torch.Tensor, qw: QWeightT, dtype=torch.bfloat16) -> torch.Tensor:
    """`qmmt` over arbitrary leading dims of x."""
    lead = x.shape[:-1]
    y = qmmt(x.reshape(-1, x.shape[-1]).float().contiguous(), qw.codes_t,
             qw.scales_t, qw.mins_t, dtype=dtype)
    return y.reshape(*lead, y.shape[-1])


def qmm_plain(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
              dtype=torch.bfloat16) -> torch.Tensor:
    """The plain PyTorch version of `qmm`, with the TPU kernel's rounding
    points: x rounded to `dtype`, W = dtype(dtype(code) * dtype(scale)),
    product summed in f32."""
    qk = codes.shape[1] // scales.shape[1]
    s = scales.to(dtype).float().repeat_interleave(qk, dim=1)
    w = (codes.float() * s).to(dtype).float()
    return torch.matmul(x.to(dtype).float(), w.T)


def qmm_shapes(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
               dtype=torch.bfloat16) -> Tuple[int, int, int, int]:
    """(T, K, R, qk) of a call csrc/qmm.cu takes; ValueError for one it does
    not: bf16 compute, x (T, K), int8 codes (R, K) and f32 scales (R, K/qk)
    with qk in {16, 32}, K a multiple of 16 (16-byte TMA row strides)."""
    if dtype != torch.bfloat16:
        raise ValueError(f"qmm: compute dtype {dtype} not supported")
    if x.ndim != 2 or codes.ndim != 2 or scales.ndim != 2 \
            or codes.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError(f"qmm: want x (T, K), int8 codes (R, K), f32 scales (R, K/qk); "
                         f"got x{tuple(x.shape)} codes {codes.dtype}{tuple(codes.shape)} "
                         f"scales {scales.dtype}{tuple(scales.shape)}")
    T, K = x.shape
    R, Kc = codes.shape
    nb = scales.shape[1]
    if (Kc != K or scales.shape[0] != R or nb < 1 or K % nb or K // nb not in (16, 32)
            or T < 1 or R < 1):
        raise ValueError(f"qmm: bad shapes x{tuple(x.shape)} codes{tuple(codes.shape)} "
                         f"scales{tuple(scales.shape)}")
    return T, K, R, K // nb


def qmm(x: torch.Tensor, codes: torch.Tensor, scales: torch.Tensor,
        dtype=torch.bfloat16) -> torch.Tensor:
    """y[T, R] = x[T, K] @ dequant(codes, scales)[R, K]^T in f32, with x and
    the dequantized weight rounded to bf16.  codes (R, K) int8, scales
    (R, K/qk) f32 with qk = K // nb in {16, 32}.  A CUDA tensor launches the
    kernel (csrc/qmm.cu), a CPU tensor takes `qmm_plain`.  A float x other
    than bf16 is rounded to bf16 here, one cast pass that counts in the
    call's time."""
    if x.device.type == "cpu":
        return qmm_plain(x, codes, scales, dtype)
    from . import _cuda

    T, K, R, qk = qmm_shapes(x, codes, scales, dtype)
    xb = x.to(torch.bfloat16).contiguous()
    _check("x", xb, torch.bfloat16, (T, K))
    _check("codes", codes, torch.int8, (R, K))
    _check("scales", scales, torch.float32, (R, K // qk))
    if codes.data_ptr() % 16 or xb.data_ptr() % 16:
        raise ValueError("qmm: x and codes must be 16-byte aligned")
    out = torch.empty((T, R), dtype=torch.float32, device=x.device)
    lib = _cuda.library("qmm")
    P = _cuda.ptr
    rc = lib.wtt_qmm(P(xb), P(codes), P(scales), P(out), T, K, R, qk,
                     _cuda.stream_of(x))
    _cuda.check(lib, "wtt_qmm", rc)
    qmm.launches += 1
    return out


qmm.launches = 0


def embed_lookup(qw: QWeight, tokens: torch.Tensor,
                 dtype=torch.float32) -> torch.Tensor:
    """Embedding-row gather + dequant for a packed token-embedding matrix
    (plain tensor ops: a few rows per step)."""
    rows = qw.codes[tokens].float()                       # (..., K)
    qk = qw.codes.shape[-1] // qw.scales.shape[-1]
    out = rows * torch.repeat_interleave(qw.scales[tokens], qk, dim=-1)
    if qw.mins is not None:
        out = out + torch.repeat_interleave(qw.mins[tokens], qk, dim=-1)
    return out.to(dtype)
