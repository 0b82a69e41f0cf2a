"""Block-quantization codecs (ggml-compatible layouts), vectorized in numpy.

These are the *reference* codecs: bit-faithful re-implementations of the block
formats defined in the reference (ggml/src/ggml-common.h:194-269 and
ggml/src/ggml-quants.c:113-299).  They are used for

  * reading quantized tensors out of legacy ggml model files,
  * the `whisper-tpu quantize` tool (writing quantized model files),
  * producing the packed `(codes, scales)` device arrays consumed by the
    Pallas fused dequant-matmul kernels in :mod:`whisper_tpu.ops.qmatmul`.

Unlike ggml, which keeps the interleaved structs on every device, the TPU
path re-lays the blocks out as struct-of-arrays (a uint8/int8 code plane plus
a float16 scale plane) so the MXU kernels can DMA dense tiles; see
``plan_device_layout``.

Rounding semantics are matched exactly (C `(int8_t)` truncation toward zero
after the +x.5 bias, round-half-away for q8_0, f16 round-to-nearest-even for
scales), so a quantize round-trip here is byte-identical with the reference's
`quantize_row_*_ref`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np

# --- ggml_type enum (ggml/include/ggml.h:390-433) ---------------------------
GGML_TYPE_F32 = 0
GGML_TYPE_F16 = 1
GGML_TYPE_Q4_0 = 2
GGML_TYPE_Q4_1 = 3
GGML_TYPE_Q5_0 = 6
GGML_TYPE_Q5_1 = 7
GGML_TYPE_Q8_0 = 8
GGML_TYPE_Q8_1 = 9
GGML_TYPE_Q2_K = 10
GGML_TYPE_Q3_K = 11
GGML_TYPE_Q4_K = 12
GGML_TYPE_Q5_K = 13
GGML_TYPE_Q6_K = 14
GGML_TYPE_Q8_K = 15
GGML_TYPE_IQ2_XXS = 16
GGML_TYPE_IQ2_XS = 17
GGML_TYPE_IQ3_XXS = 18
GGML_TYPE_IQ1_S = 19
GGML_TYPE_IQ4_NL = 20
GGML_TYPE_IQ3_S = 21
GGML_TYPE_IQ2_S = 22
GGML_TYPE_IQ4_XS = 23
GGML_TYPE_IQ1_M = 29
GGML_TYPE_I8 = 24
GGML_TYPE_I16 = 25
GGML_TYPE_I32 = 26
GGML_TYPE_BF16 = 30
GGML_TYPE_TQ1_0 = 34
GGML_TYPE_TQ2_0 = 35
GGML_TYPE_MXFP4 = 39
GGML_TYPE_NVFP4 = 40

# --- ggml_ftype enum (ggml/include/ggml.h:450-478) ---------------------------
GGML_FTYPE_ALL_F32 = 0
GGML_FTYPE_MOSTLY_F16 = 1
GGML_FTYPE_MOSTLY_Q4_0 = 2
GGML_FTYPE_MOSTLY_Q4_1 = 3
GGML_FTYPE_MOSTLY_Q8_0 = 7
GGML_FTYPE_MOSTLY_Q5_0 = 8
GGML_FTYPE_MOSTLY_Q5_1 = 9
GGML_FTYPE_MOSTLY_Q2_K = 10
GGML_FTYPE_MOSTLY_Q3_K = 11
GGML_FTYPE_MOSTLY_Q4_K = 12
GGML_FTYPE_MOSTLY_Q5_K = 13
GGML_FTYPE_MOSTLY_Q6_K = 14
GGML_FTYPE_MOSTLY_IQ2_XXS = 15
GGML_FTYPE_MOSTLY_IQ2_XS = 16
GGML_FTYPE_MOSTLY_IQ3_XXS = 17
GGML_FTYPE_MOSTLY_IQ1_S = 18
GGML_FTYPE_MOSTLY_IQ4_NL = 19
GGML_FTYPE_MOSTLY_IQ3_S = 20
GGML_FTYPE_MOSTLY_IQ2_S = 21
GGML_FTYPE_MOSTLY_IQ4_XS = 22
GGML_FTYPE_MOSTLY_IQ1_M = 23
GGML_FTYPE_MOSTLY_MXFP4 = 25
GGML_FTYPE_MOSTLY_NVFP4 = 26

GGML_QNT_VERSION = 2
GGML_QNT_VERSION_FACTOR = 1000

FTYPE_TO_QTYPE = {
    GGML_FTYPE_ALL_F32: GGML_TYPE_F32,
    GGML_FTYPE_MOSTLY_F16: GGML_TYPE_F16,
    GGML_FTYPE_MOSTLY_Q4_0: GGML_TYPE_Q4_0,
    GGML_FTYPE_MOSTLY_Q4_1: GGML_TYPE_Q4_1,
    GGML_FTYPE_MOSTLY_Q8_0: GGML_TYPE_Q8_0,
    GGML_FTYPE_MOSTLY_Q5_0: GGML_TYPE_Q5_0,
    GGML_FTYPE_MOSTLY_Q5_1: GGML_TYPE_Q5_1,
    GGML_FTYPE_MOSTLY_Q2_K: GGML_TYPE_Q2_K,
    GGML_FTYPE_MOSTLY_Q3_K: GGML_TYPE_Q3_K,
    GGML_FTYPE_MOSTLY_Q4_K: GGML_TYPE_Q4_K,
    GGML_FTYPE_MOSTLY_Q5_K: GGML_TYPE_Q5_K,
    GGML_FTYPE_MOSTLY_Q6_K: GGML_TYPE_Q6_K,
    GGML_FTYPE_MOSTLY_IQ4_NL: GGML_TYPE_IQ4_NL,
    GGML_FTYPE_MOSTLY_IQ4_XS: GGML_TYPE_IQ4_XS,
    GGML_FTYPE_MOSTLY_MXFP4: GGML_TYPE_MXFP4,
    GGML_FTYPE_MOSTLY_NVFP4: GGML_TYPE_NVFP4,
    GGML_FTYPE_MOSTLY_IQ2_XXS: GGML_TYPE_IQ2_XXS,
    GGML_FTYPE_MOSTLY_IQ2_XS: GGML_TYPE_IQ2_XS,
    GGML_FTYPE_MOSTLY_IQ2_S: GGML_TYPE_IQ2_S,
    GGML_FTYPE_MOSTLY_IQ3_XXS: GGML_TYPE_IQ3_XXS,
    GGML_FTYPE_MOSTLY_IQ3_S: GGML_TYPE_IQ3_S,
    GGML_FTYPE_MOSTLY_IQ1_S: GGML_TYPE_IQ1_S,
    GGML_FTYPE_MOSTLY_IQ1_M: GGML_TYPE_IQ1_M,
}
QTYPE_TO_FTYPE = {v: k for k, v in FTYPE_TO_QTYPE.items()}

QK = 32      # block size of the *_0/*_1 formats
QK_K = 256   # super-block size of the K-quant formats


@dataclass(frozen=True)
class QuantSpec:
    """Static description of one block format."""

    name: str
    ggml_type: int
    block_elems: int
    block_bytes: int


SPECS: Dict[int, QuantSpec] = {
    GGML_TYPE_F32: QuantSpec("f32", GGML_TYPE_F32, 1, 4),
    GGML_TYPE_F16: QuantSpec("f16", GGML_TYPE_F16, 1, 2),
    GGML_TYPE_BF16: QuantSpec("bf16", GGML_TYPE_BF16, 1, 2),
    GGML_TYPE_I8: QuantSpec("i8", GGML_TYPE_I8, 1, 1),
    GGML_TYPE_I16: QuantSpec("i16", GGML_TYPE_I16, 1, 2),
    GGML_TYPE_I32: QuantSpec("i32", GGML_TYPE_I32, 1, 4),
    GGML_TYPE_Q4_0: QuantSpec("q4_0", GGML_TYPE_Q4_0, QK, 2 + 16),
    GGML_TYPE_Q4_1: QuantSpec("q4_1", GGML_TYPE_Q4_1, QK, 4 + 16),
    GGML_TYPE_Q5_0: QuantSpec("q5_0", GGML_TYPE_Q5_0, QK, 2 + 4 + 16),
    GGML_TYPE_Q5_1: QuantSpec("q5_1", GGML_TYPE_Q5_1, QK, 4 + 4 + 16),
    GGML_TYPE_Q8_0: QuantSpec("q8_0", GGML_TYPE_Q8_0, QK, 2 + 32),
    GGML_TYPE_Q2_K: QuantSpec("q2_k", GGML_TYPE_Q2_K, QK_K, 16 + 64 + 4),
    GGML_TYPE_Q3_K: QuantSpec("q3_k", GGML_TYPE_Q3_K, QK_K, 32 + 64 + 12 + 2),
    GGML_TYPE_Q4_K: QuantSpec("q4_k", GGML_TYPE_Q4_K, QK_K, 4 + 12 + 128),
    GGML_TYPE_Q5_K: QuantSpec("q5_k", GGML_TYPE_Q5_K, QK_K, 4 + 12 + 32 + 128),
    GGML_TYPE_Q6_K: QuantSpec("q6_k", GGML_TYPE_Q6_K, QK_K, 128 + 64 + 16 + 2),
    GGML_TYPE_IQ4_NL: QuantSpec("iq4_nl", GGML_TYPE_IQ4_NL, QK, 2 + 16),
    GGML_TYPE_IQ4_XS: QuantSpec("iq4_xs", GGML_TYPE_IQ4_XS, QK_K,
                                2 + 2 + 4 + 128),
    # importance-matrix grid formats (decode-only; ggml-common.h:384-443)
    GGML_TYPE_IQ2_XXS: QuantSpec("iq2_xxs", GGML_TYPE_IQ2_XXS, QK_K, 2 + 64),
    GGML_TYPE_IQ2_XS: QuantSpec("iq2_xs", GGML_TYPE_IQ2_XS, QK_K,
                                2 + 64 + 8),
    GGML_TYPE_IQ2_S: QuantSpec("iq2_s", GGML_TYPE_IQ2_S, QK_K,
                               2 + 64 + 16),
    GGML_TYPE_IQ3_XXS: QuantSpec("iq3_xxs", GGML_TYPE_IQ3_XXS, QK_K, 2 + 96),
    GGML_TYPE_IQ3_S: QuantSpec("iq3_s", GGML_TYPE_IQ3_S, QK_K,
                               2 + 64 + 8 + 32 + 4),
    GGML_TYPE_IQ1_S: QuantSpec("iq1_s", GGML_TYPE_IQ1_S, QK_K, 2 + 32 + 16),
    GGML_TYPE_IQ1_M: QuantSpec("iq1_m", GGML_TYPE_IQ1_M, QK_K, 32 + 16 + 8),
    GGML_TYPE_MXFP4: QuantSpec("mxfp4", GGML_TYPE_MXFP4, QK, 1 + 16),
    GGML_TYPE_NVFP4: QuantSpec("nvfp4", GGML_TYPE_NVFP4, 64, 4 + 32),
    GGML_TYPE_TQ1_0: QuantSpec("tq1_0", GGML_TYPE_TQ1_0, QK_K, 48 + 4 + 2),
    GGML_TYPE_TQ2_0: QuantSpec("tq2_0", GGML_TYPE_TQ2_0, QK_K, 64 + 2),
}

NAME_TO_TYPE = {s.name: t for t, s in SPECS.items()}


def type_name(ggml_type: int) -> str:
    return SPECS[ggml_type].name if ggml_type in SPECS else f"type{ggml_type}"


def row_size(ggml_type: int, n_elems: int) -> int:
    """Bytes of one contiguous run of `n_elems` elements (ggml_row_size)."""
    spec = SPECS[ggml_type]
    if n_elems % spec.block_elems != 0:
        raise ValueError(
            f"{spec.name}: {n_elems} elements not divisible by block {spec.block_elems}"
        )
    return n_elems // spec.block_elems * spec.block_bytes


def _f16(x: np.ndarray) -> np.ndarray:
    """f32 -> f16 with round-to-nearest-even (matches GGML_FP32_TO_FP16)."""
    return x.astype(np.float16)


def _c_trunc_i8(x: np.ndarray) -> np.ndarray:
    """C `(int8_t)` cast: truncation toward zero."""
    return np.trunc(x).astype(np.int8)


# --------------------------------------------------------------------------
# q4_0: 32 elems, f16 scale `d`, 16 bytes of nibbles.  value = (q - 8) * d.
# Nibble j low = elem j, high = elem j+16 (ggml-common.h:194-199).
# --------------------------------------------------------------------------

def quantize_q4_0(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK)
    nb = x.shape[0]
    # signed max-by-magnitude per block; ties resolved like the C loop
    # (first element attaining the max magnitude wins)
    idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(nb), idx]
    d = maxv / -8.0
    id_ = np.where(d != 0.0, np.float32(1.0) / np.where(d == 0, 1, d), 0.0).astype(np.float32)
    xi = np.minimum(15, _c_trunc_i8(x * id_[:, None] + np.float32(8.5))).astype(np.uint8)
    qs = (xi[:, :16] | (xi[:, 16:] << 4)).astype(np.uint8)
    out = np.zeros((nb, 18), dtype=np.uint8)
    out[:, :2] = _f16(d.astype(np.float32)).view(np.uint8).reshape(nb, 2)
    out[:, 2:] = qs
    return out.tobytes()


def dequantize_q4_0(buf: bytes, n: int) -> np.ndarray:
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, 18)
    d = raw[:, :2].copy().view(np.float16).astype(np.float32)  # (nb,1)
    qs = raw[:, 2:]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    vals = np.concatenate([lo, hi], axis=1).astype(np.float32) * d
    return vals.reshape(-1)[:n]


# --------------------------------------------------------------------------
# q4_1: d + m f16, value = q * d + m (ggml-quants.c:150-185)
# --------------------------------------------------------------------------

def quantize_q4_1(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK)
    nb = x.shape[0]
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / np.float32(15.0)
    id_ = np.where(d != 0.0, np.float32(1.0) / np.where(d == 0, 1, d), 0.0).astype(np.float32)
    q = np.minimum(15, _c_trunc_i8((x - mn[:, None]) * id_[:, None] + np.float32(0.5))).astype(np.uint8)
    qs = (q[:, :16] | (q[:, 16:] << 4)).astype(np.uint8)
    out = np.zeros((nb, 20), dtype=np.uint8)
    out[:, 0:2] = _f16(d.astype(np.float32)).view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = _f16(mn.astype(np.float32)).view(np.uint8).reshape(nb, 2)
    out[:, 4:] = qs
    return out.tobytes()


def dequantize_q4_1(buf: bytes, n: int) -> np.ndarray:
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, 20)
    d = raw[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = raw[:, 2:4].copy().view(np.float16).astype(np.float32)
    qs = raw[:, 4:]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    vals = np.concatenate([lo, hi], axis=1) * d + m
    return vals.reshape(-1)[:n]


# --------------------------------------------------------------------------
# q5_0: f16 d, u32 qh of 5th bits, 16 nibble bytes; value = (q - 16) * d
# (ggml-common.h:229-235, ggml-quants.c:187-229)
# --------------------------------------------------------------------------

def quantize_q5_0(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK)
    nb = x.shape[0]
    idx = np.argmax(np.abs(x), axis=1)
    maxv = x[np.arange(nb), idx]
    d = maxv / -16.0
    id_ = np.where(d != 0.0, np.float32(1.0) / np.where(d == 0, 1, d), 0.0).astype(np.float32)
    xi = np.minimum(31, _c_trunc_i8(x * id_[:, None] + np.float32(16.5))).astype(np.uint32)
    x0, x1 = xi[:, :16], xi[:, 16:]
    qs = ((x0 & 0x0F) | ((x1 & 0x0F) << 4)).astype(np.uint8)
    shifts = np.arange(16, dtype=np.uint32)
    qh = (((x0 >> 4) & 1) << shifts).sum(axis=1, dtype=np.uint64) | \
         ((((x1 >> 4) & 1) << (shifts + 16)).sum(axis=1, dtype=np.uint64))
    out = np.zeros((nb, 22), dtype=np.uint8)
    out[:, 0:2] = _f16(d.astype(np.float32)).view(np.uint8).reshape(nb, 2)
    out[:, 2:6] = qh.astype(np.uint32).view(np.uint8).reshape(nb, 4)
    out[:, 6:] = qs
    return out.tobytes()


def dequantize_q5_0(buf: bytes, n: int) -> np.ndarray:
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, 22)
    d = raw[:, 0:2].copy().view(np.float16).astype(np.float32)
    qh = raw[:, 2:6].copy().view(np.uint32).astype(np.uint32)  # (nb,1)
    qs = raw[:, 6:]
    shifts = np.arange(16, dtype=np.uint32)
    h0 = ((qh >> shifts) & 1).astype(np.uint8) << 4
    h1 = ((qh >> (shifts + 16)) & 1).astype(np.uint8) << 4
    lo = ((qs & 0x0F) | h0).astype(np.int16) - 16
    hi = ((qs >> 4) | h1).astype(np.int16) - 16
    vals = np.concatenate([lo, hi], axis=1).astype(np.float32) * d
    return vals.reshape(-1)[:n]


# --------------------------------------------------------------------------
# q5_1: d + m f16, qh u32; value = q * d + m (ggml-quants.c:231-274)
# --------------------------------------------------------------------------

def quantize_q5_1(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK)
    nb = x.shape[0]
    mn = x.min(axis=1)
    mx = x.max(axis=1)
    d = (mx - mn) / np.float32(31.0)
    id_ = np.where(d != 0.0, np.float32(1.0) / np.where(d == 0, 1, d), 0.0).astype(np.float32)
    xi = np.minimum(31, _c_trunc_i8((x - mn[:, None]) * id_[:, None] + np.float32(0.5))).astype(np.uint32)
    x0, x1 = xi[:, :16], xi[:, 16:]
    qs = ((x0 & 0x0F) | ((x1 & 0x0F) << 4)).astype(np.uint8)
    shifts = np.arange(16, dtype=np.uint32)
    qh = (((x0 >> 4) & 1) << shifts).sum(axis=1, dtype=np.uint64) | \
         ((((x1 >> 4) & 1) << (shifts + 16)).sum(axis=1, dtype=np.uint64))
    out = np.zeros((nb, 24), dtype=np.uint8)
    out[:, 0:2] = _f16(d.astype(np.float32)).view(np.uint8).reshape(nb, 2)
    out[:, 2:4] = _f16(mn.astype(np.float32)).view(np.uint8).reshape(nb, 2)
    out[:, 4:8] = qh.astype(np.uint32).view(np.uint8).reshape(nb, 4)
    out[:, 8:] = qs
    return out.tobytes()


def dequantize_q5_1(buf: bytes, n: int) -> np.ndarray:
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, 24)
    d = raw[:, 0:2].copy().view(np.float16).astype(np.float32)
    m = raw[:, 2:4].copy().view(np.float16).astype(np.float32)
    qh = raw[:, 4:8].copy().view(np.uint32).astype(np.uint32)
    qs = raw[:, 8:]
    shifts = np.arange(16, dtype=np.uint32)
    h0 = ((qh >> shifts) & 1).astype(np.uint8) << 4
    h1 = ((qh >> (shifts + 16)) & 1).astype(np.uint8) << 4
    lo = ((qs & 0x0F) | h0).astype(np.float32)
    hi = ((qs >> 4) | h1).astype(np.float32)
    vals = np.concatenate([lo, hi], axis=1) * d + m
    return vals.reshape(-1)[:n]


# --------------------------------------------------------------------------
# q8_0: f16 d, 32 int8; value = q * d; q = roundf(x/d) (ggml-quants.c:276-299)
# --------------------------------------------------------------------------

def quantize_q8_0(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1, QK)
    nb = x.shape[0]
    amax = np.abs(x).max(axis=1)
    d = amax / np.float32(127.0)
    id_ = np.where(d != 0.0, np.float32(1.0) / np.where(d == 0, 1, d), 0.0).astype(np.float32)
    scaled = x * id_[:, None]
    # C roundf = round half away from zero
    q = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
    out = np.zeros((nb, 34), dtype=np.uint8)
    out[:, 0:2] = _f16(d.astype(np.float32)).view(np.uint8).reshape(nb, 2)
    out[:, 2:] = q.astype(np.int8).view(np.uint8)
    return out.tobytes()


def dequantize_q8_0(buf: bytes, n: int) -> np.ndarray:
    raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, 34)
    d = raw[:, 0:2].copy().view(np.float16).astype(np.float32)
    qs = raw[:, 2:].copy().view(np.int8).astype(np.float32)
    return (qs * d).reshape(-1)[:n]


# --------------------------------------------------------------------------
# dispatch (ggml_quantize_chunk analogue, ggml/src/ggml.c:7919)
# --------------------------------------------------------------------------

from . import kquants as _kq  # noqa: E402 — K-quant super-block codecs
from . import iquants as _iq  # noqa: E402 — IQ4/MXFP4/ternary codecs

_QUANTIZERS: Dict[int, Callable[[np.ndarray], bytes]] = {
    GGML_TYPE_Q4_0: quantize_q4_0,
    GGML_TYPE_Q4_1: quantize_q4_1,
    GGML_TYPE_Q5_0: quantize_q5_0,
    GGML_TYPE_Q5_1: quantize_q5_1,
    GGML_TYPE_Q8_0: quantize_q8_0,
    GGML_TYPE_Q2_K: _kq.quantize_q2_k,
    GGML_TYPE_Q3_K: _kq.quantize_q3_k,
    GGML_TYPE_Q4_K: _kq.quantize_q4_k,
    GGML_TYPE_Q5_K: _kq.quantize_q5_k,
    GGML_TYPE_Q6_K: _kq.quantize_q6_k,
    GGML_TYPE_IQ4_NL: _iq.quantize_iq4_nl,
    GGML_TYPE_IQ4_XS: _iq.quantize_iq4_xs,
    GGML_TYPE_MXFP4: _iq.quantize_mxfp4,
    GGML_TYPE_NVFP4: _iq.quantize_nvfp4,
    GGML_TYPE_TQ1_0: _iq.quantize_tq1_0,
    GGML_TYPE_TQ2_0: _iq.quantize_tq2_0,
}

_DEQUANTIZERS: Dict[int, Callable[[bytes, int], np.ndarray]] = {
    GGML_TYPE_Q4_0: dequantize_q4_0,
    GGML_TYPE_Q4_1: dequantize_q4_1,
    GGML_TYPE_Q5_0: dequantize_q5_0,
    GGML_TYPE_Q5_1: dequantize_q5_1,
    GGML_TYPE_Q8_0: dequantize_q8_0,
    GGML_TYPE_Q2_K: _kq.dequantize_q2_k,
    GGML_TYPE_Q3_K: _kq.dequantize_q3_k,
    GGML_TYPE_Q4_K: _kq.dequantize_q4_k,
    GGML_TYPE_Q5_K: _kq.dequantize_q5_k,
    GGML_TYPE_Q6_K: _kq.dequantize_q6_k,
    GGML_TYPE_IQ4_NL: _iq.dequantize_iq4_nl,
    GGML_TYPE_IQ4_XS: _iq.dequantize_iq4_xs,
    GGML_TYPE_IQ2_XXS: _iq.dequantize_iq2_xxs,
    GGML_TYPE_IQ2_XS: _iq.dequantize_iq2_xs,
    GGML_TYPE_IQ2_S: _iq.dequantize_iq2_s,
    GGML_TYPE_IQ3_XXS: _iq.dequantize_iq3_xxs,
    GGML_TYPE_IQ3_S: _iq.dequantize_iq3_s,
    GGML_TYPE_IQ1_S: _iq.dequantize_iq1_s,
    GGML_TYPE_IQ1_M: _iq.dequantize_iq1_m,
    GGML_TYPE_MXFP4: _iq.dequantize_mxfp4,
    GGML_TYPE_NVFP4: _iq.dequantize_nvfp4,
    GGML_TYPE_TQ1_0: _iq.dequantize_tq1_0,
    GGML_TYPE_TQ2_0: _iq.dequantize_tq2_0,
}


def supported_quant_types() -> Tuple[int, ...]:
    return tuple(sorted(_QUANTIZERS))


_NATIVE_TYPES = {GGML_TYPE_Q4_0: "q4_0", GGML_TYPE_Q5_0: "q5_0",
                 GGML_TYPE_Q8_0: "q8_0"}


def quantize(x: np.ndarray, ggml_type: int,
             imatrix: "np.ndarray | None" = None) -> bytes:
    """Quantize a float array to the packed byte layout of `ggml_type`.

    Prefers the native C++ codecs (whisper_tpu.native, bit-identical to the
    numpy reference implementations below) when the library is available.

    `imatrix`: per-input-channel importance weights (one f32 per column of
    a 2-D `x`).  REQUIRED for the IQ1/IQ2/IQ3 grid formats (the reference
    asserts the same, ggml-quants.c quantize_iq*); ignored by the other
    codecs, whose reference quantizers don't take it for whisper tensors."""
    if ggml_type in _IMATRIX_QUANTIZERS:
        if imatrix is None:
            raise NotImplementedError(
                f"quantize to {type_name(ggml_type)} requires an importance "
                "matrix (tools/make_imatrix.py)")
        x2 = np.asarray(x, np.float32)
        if x2.ndim == 1:
            x2 = x2.reshape(1, -1)
        x2 = x2.reshape(-1, x2.shape[-1])
        im = np.asarray(imatrix, np.float32)
        fn = _IMATRIX_QUANTIZERS[ggml_type]
        # rows are independent; chunk them so the vectorized searches keep
        # bounded working sets (a 51k-row token embedding would otherwise
        # build multi-GB candidate tensors)
        step = max(1, (1 << 19) // x2.shape[-1])
        return b"".join(fn(x2[i:i + step], im)
                        for i in range(0, x2.shape[0], step))
    if ggml_type == GGML_TYPE_F32:
        return np.ascontiguousarray(x, dtype=np.float32).tobytes()
    if ggml_type == GGML_TYPE_F16:
        return np.ascontiguousarray(x, dtype=np.float32).astype(np.float16).tobytes()
    if ggml_type in _NATIVE_TYPES:
        from .. import native

        out = native.quantize(_NATIVE_TYPES[ggml_type], np.asarray(x))
        if out is not None:
            return out
    fn = _QUANTIZERS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"quantize to {type_name(ggml_type)} not supported")
    return fn(np.asarray(x))


class _IQEncoders(dict):
    """Lazy registry: the grid-format encoders import iq_encode (which
    builds the quantizer tables, ~15 s) only when actually used."""

    def __contains__(self, k):
        return k in (GGML_TYPE_IQ2_XXS, GGML_TYPE_IQ2_XS, GGML_TYPE_IQ2_S,
                     GGML_TYPE_IQ3_XXS, GGML_TYPE_IQ3_S, GGML_TYPE_IQ1_S,
                     GGML_TYPE_IQ1_M)

    def __getitem__(self, k):
        from . import iq_encode as IE

        return {
            GGML_TYPE_IQ2_XXS: IE.quantize_iq2_xxs,
            GGML_TYPE_IQ2_XS: IE.quantize_iq2_xs,
            GGML_TYPE_IQ2_S: IE.quantize_iq2_s,
            GGML_TYPE_IQ3_XXS: IE.quantize_iq3_xxs,
            GGML_TYPE_IQ3_S: IE.quantize_iq3_s,
            GGML_TYPE_IQ1_S: IE.quantize_iq1_s,
            GGML_TYPE_IQ1_M: IE.quantize_iq1_m,
        }[k]


_IMATRIX_QUANTIZERS = _IQEncoders()


def dequantize(buf: bytes, ggml_type: int, n_elems: int) -> np.ndarray:
    """Decode packed bytes into a flat float32 array of `n_elems`."""
    if ggml_type == GGML_TYPE_F32:
        return np.frombuffer(buf, dtype=np.float32, count=n_elems).copy()
    if ggml_type == GGML_TYPE_F16:
        return np.frombuffer(buf, dtype=np.float16, count=n_elems).astype(np.float32)
    if ggml_type == GGML_TYPE_BF16:
        raw = np.frombuffer(buf, dtype=np.uint16, count=n_elems).astype(np.uint32) << 16
        return raw.view(np.float32).copy()
    fn = _DEQUANTIZERS.get(ggml_type)
    if fn is None:
        raise NotImplementedError(f"dequantize from {type_name(ggml_type)} not supported")
    return fn(buf, n_elems)


# --------------------------------------------------------------------------
# TPU device layout: struct-of-arrays planes for the Pallas kernels
# --------------------------------------------------------------------------

@dataclass
class QTensor:
    """A quantized 2-D weight in TPU-friendly struct-of-arrays layout.

    For a logical weight of shape (rows, cols) with block size B along cols:
      codes:  (rows, cols)     int8 -- the *centered* integer code (q - zero)
      scales: (rows, cols//B)  f32  -- per-block scale d
      mins:   (rows, cols//B)  f32 or None -- per-block offset m (affine formats)

    dequantized value = codes * scale (+ min ⋅ 1 if affine, where codes are
    then the raw unsigned codes).  This layout lets the MXU kernel read dense
    int8 tiles and a small scale plane instead of ggml's 18/22/34-byte
    interleaved structs.
    """

    ggml_type: int
    shape: Tuple[int, int]
    codes: np.ndarray
    scales: np.ndarray
    mins: Optional[np.ndarray] = None

    @property
    def block(self) -> int:
        return SPECS[self.ggml_type].block_elems


def unpack_to_planes(buf: bytes, ggml_type: int, shape: Tuple[int, ...]) -> QTensor:
    """Decode packed ggml bytes into the struct-of-arrays device layout."""
    rows = int(np.prod(shape[:-1])) if len(shape) > 1 else 1
    cols = int(shape[-1])
    n = rows * cols
    if ggml_type == GGML_TYPE_Q4_0:
        raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, 18)
        d = raw[:, :2].copy().view(np.float16).astype(np.float32).reshape(rows, cols // QK)
        qs = raw[:, 2:]
        lo = (qs & 0x0F).astype(np.int8) - 8
        hi = (qs >> 4).astype(np.int8) - 8
        codes = np.concatenate([lo, hi], axis=1).reshape(rows, cols)
        return QTensor(ggml_type, (rows, cols), codes, d)
    if ggml_type == GGML_TYPE_Q5_0:
        raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, 22)
        d = raw[:, :2].copy().view(np.float16).astype(np.float32).reshape(rows, cols // QK)
        qh = raw[:, 2:6].copy().view(np.uint32)
        qs = raw[:, 6:]
        shifts = np.arange(16, dtype=np.uint32)
        h0 = ((qh >> shifts) & 1).astype(np.uint8) << 4
        h1 = ((qh >> (shifts + 16)) & 1).astype(np.uint8) << 4
        lo = ((qs & 0x0F) | h0).astype(np.int16) - 16
        hi = ((qs >> 4) | h1).astype(np.int16) - 16
        codes = np.concatenate([lo, hi], axis=1).astype(np.int8).reshape(rows, cols)
        return QTensor(ggml_type, (rows, cols), codes, d)
    if ggml_type == GGML_TYPE_Q8_0:
        raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, 34)
        d = raw[:, :2].copy().view(np.float16).astype(np.float32).reshape(rows, cols // QK)
        codes = raw[:, 2:].copy().view(np.int8).reshape(rows, cols)
        return QTensor(ggml_type, (rows, cols), codes, d)
    if ggml_type in (GGML_TYPE_Q4_1, GGML_TYPE_Q5_1):
        flat = dequantize(buf, ggml_type, n)
        # affine formats are rare (not produced by whisper quantize defaults);
        # fall back to requantizing into q8_0-style planes is wrong, so keep
        # exact: store raw codes + scale + min.
        if ggml_type == GGML_TYPE_Q4_1:
            raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, 20)
            d = raw[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(rows, cols // QK)
            m = raw[:, 2:4].copy().view(np.float16).astype(np.float32).reshape(rows, cols // QK)
            qs = raw[:, 4:]
            lo = (qs & 0x0F).astype(np.int8)
            hi = (qs >> 4).astype(np.int8)
            codes = np.concatenate([lo, hi], axis=1).reshape(rows, cols)
        else:
            raw = np.frombuffer(buf, dtype=np.uint8).reshape(-1, 24)
            d = raw[:, 0:2].copy().view(np.float16).astype(np.float32).reshape(rows, cols // QK)
            m = raw[:, 2:4].copy().view(np.float16).astype(np.float32).reshape(rows, cols // QK)
            qh = raw[:, 4:8].copy().view(np.uint32)
            qs = raw[:, 8:]
            shifts = np.arange(16, dtype=np.uint32)
            h0 = ((qh >> shifts) & 1).astype(np.uint8) << 4
            h1 = ((qh >> (shifts + 16)) & 1).astype(np.uint8) << 4
            lo = ((qs & 0x0F) | h0).astype(np.int8)
            hi = ((qs >> 4) | h1).astype(np.int8)
            codes = np.concatenate([lo, hi], axis=1).reshape(rows, cols)
        return QTensor(ggml_type, (rows, cols), codes, d, m)
    if ggml_type in (GGML_TYPE_IQ4_NL, GGML_TYPE_IQ4_XS, GGML_TYPE_MXFP4,
                     GGML_TYPE_NVFP4, GGML_TYPE_TQ1_0, GGML_TYPE_TQ2_0):
        if ggml_type == GGML_TYPE_IQ4_NL:
            codes, scales = _iq.planes_iq4_nl(buf, rows, cols)
        elif ggml_type == GGML_TYPE_IQ4_XS:
            codes, scales = _iq.planes_iq4_xs(buf, rows, cols)
        elif ggml_type == GGML_TYPE_MXFP4:
            codes, scales = _iq.planes_mxfp4(buf, rows, cols)
        elif ggml_type == GGML_TYPE_NVFP4:
            codes, scales = _iq.planes_nvfp4(buf, rows, cols)
        else:
            codes, scales = _iq.planes_tq(buf, rows, cols, ggml_type)
        return QTensor(ggml_type, (rows, cols), codes,
                       np.ascontiguousarray(scales))
    if ggml_type in (GGML_TYPE_Q4_K, GGML_TYPE_Q5_K, GGML_TYPE_Q6_K):
        from . import kquants as _kq

        codes, scales, mins = _kq.to_planes(buf, ggml_type, rows, cols)
        return QTensor(ggml_type, (rows, cols), codes,
                       np.ascontiguousarray(scales),
                       None if mins is None else np.ascontiguousarray(mins))
    raise NotImplementedError(f"unpack_to_planes: {type_name(ggml_type)}")
