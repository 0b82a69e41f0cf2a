"""Plain versions of the port's qmmt / qmmt_fused against the JAX package's
Pallas kernels (interpret mode), for every option combination the decode
path uses, on symmetric (q5_0) and affine (q4_1) planes.

Tolerance: 1e-5 of max |y| in f32 — both sides compute the same per-block
products in f32 and differ only in summation order.  The bf16 case rounds
the same operands on both sides, so it holds to the same bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.ops import qmm as JQMM
from whisper_tpu_torch.formats import quants as Q
from whisper_tpu_torch.ops import qmm as TQMM

T, K, R = 3, 128, 96


def _planes(qtype, k, r, seed):
    w = np.random.default_rng(seed).standard_normal((r, k)).astype(np.float32)
    p = Q.unpack_to_planes(Q.quantize(w, qtype), qtype, (r, k))
    tr = lambda a: None if a is None else np.ascontiguousarray(a.T)
    return tr(p.codes).astype(np.int8), tr(p.scales), tr(p.mins)


# (ln, bias, act, residual) per decode-path use
CASES = {
    "qkv_xq": (True, True, None, False),
    "o_xo_mlp1": (False, True, None, True),
    "mlp0": (True, True, "gelu", False),
    "logits_head": (True, False, None, False),
}


@pytest.mark.parametrize("qtype", [Q.GGML_TYPE_Q5_0, Q.GGML_TYPE_Q4_1],
                         ids=["q5_0", "q4_1"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_qmmt_fused_plain_matches_pallas(case, qtype, dtype):
    ln, bias, act, res = CASES[case]
    rng = np.random.default_rng(7)
    codes, scales, mins = _planes(qtype, K, R, 11)
    x = rng.standard_normal((T, K)).astype(np.float32)
    lw = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32) if ln else None
    lb = (0.1 * rng.standard_normal(K)).astype(np.float32) if ln else None
    b = rng.standard_normal(R).astype(np.float32) if bias else None
    r = rng.standard_normal((T, R)).astype(np.float32) if res else None
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    jo = lambda a: None if a is None else jnp.asarray(a)
    to = lambda a: None if a is None else torch.from_numpy(a)
    y_ref = np.asarray(JQMM.qmmt_fused(
        jo(x), jo(codes), jo(scales), jo(mins), ln_w=jo(lw), ln_b=jo(lb),
        bias=jo(b), residual=jo(r), act=act, block_r=256, dtype=jd,
        interpret=True))
    before = TQMM.qmmt_fused.launches
    y = TQMM.qmmt_fused(to(x), to(codes), to(scales), to(mins), ln_w=to(lw),
                        ln_b=to(lb), bias=to(b), residual=to(r), act=act,
                        dtype=td).numpy()
    assert TQMM.qmmt_fused.launches == before   # the CPU takes the plain path
    assert y.shape == (T, R) and y.dtype == np.float32
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-5 * np.abs(y_ref).max())


@pytest.mark.parametrize("qtype", [Q.GGML_TYPE_Q5_0, Q.GGML_TYPE_Q4_1],
                         ids=["q5_0", "q4_1"])
def test_qmmt_plain_matches_pallas(qtype):
    codes, scales, mins = _planes(qtype, K, R, 5)
    x = np.random.default_rng(2).standard_normal((T, K)).astype(np.float32)
    y_ref = np.asarray(JQMM.qmmt(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scales),
        None if mins is None else jnp.asarray(mins), block_r=256,
        dtype=jnp.float32, interpret=True))
    to = lambda a: None if a is None else torch.from_numpy(a)
    y = TQMM.qmmt(to(x), to(codes), to(scales), to(mins), dtype=torch.float32)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0,
                               atol=1e-5 * np.abs(y_ref).max())


def test_qmmt_fused_auto_leading_dims():
    codes, scales, _ = _planes(Q.GGML_TYPE_Q5_0, K, R, 9)
    qw = TQMM.QWeightT(*(torch.from_numpy(a) for a in (codes, scales)))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 4, K)).astype(np.float32))
    y = TQMM.qmmt_fused_auto(x, qw, torch.float32)
    y2 = TQMM.qmmt_fused(x.reshape(8, K), qw.codes_t, qw.scales_t,
                         dtype=torch.float32)
    assert y.shape == (2, 4, R)
    torch.testing.assert_close(y.reshape(8, R), y2, rtol=0, atol=0)


def test_embed_lookup_matches_jax():
    w = np.random.default_rng(4).standard_normal((50, K)).astype(np.float32)
    p = Q.unpack_to_planes(Q.quantize(w, Q.GGML_TYPE_Q4_1), Q.GGML_TYPE_Q4_1,
                           w.shape)
    toks = np.array([[0, 7, 49], [3, 3, 1]])
    ref = np.asarray(JQMM.embed_lookup(
        JQMM.QWeight(jnp.asarray(p.codes), jnp.asarray(p.scales),
                     jnp.asarray(p.mins)), jnp.asarray(toks)))
    got = TQMM.embed_lookup(
        TQMM.QWeight(torch.from_numpy(p.codes), torch.from_numpy(p.scales),
                     torch.from_numpy(p.mins)), torch.from_numpy(toks))
    np.testing.assert_array_equal(got.numpy(), ref)


# K5: qmm over planes in file orientation, codes (R, K).  T and R are not
# multiples of the JAX kernel's tiles (16 x 128 here), and qk is 32 (the
# *_0 formats) or 16 (NVFP4 sub-blocks).  Tolerance 1e-5 of max |y|: the
# same bf16-rounded operands on both sides, another f32 summation order.
@pytest.mark.parametrize("qk", [32, 16])
@pytest.mark.parametrize("T_,K_,R_", [(37, 256, 300), (1, 128, 5), (20, 512, 129)])
def test_qmm_plain_matches_pallas(qk, T_, K_, R_):
    rng = np.random.default_rng(T_ + K_ + R_ + qk)
    x = rng.standard_normal((T_, K_)).astype(np.float32)
    codes = rng.integers(-16, 16, (R_, K_)).astype(np.int8)
    scales = (0.02 * rng.random((R_, K_ // qk))).astype(np.float32)
    y_ref = np.asarray(JQMM.qmm(jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scales),
                                block_t=16, block_r=128, interpret=True))
    before = TQMM.qmm.launches
    y = TQMM.qmm(*(torch.from_numpy(a) for a in (x, codes, scales)))
    assert TQMM.qmm.launches == before       # the CPU takes the plain path
    assert y.dtype == torch.float32 and tuple(y.shape) == (T_, R_)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=0, atol=1e-5 * np.abs(y_ref).max())


def test_qmm_plain_rounds_like_the_tpu_kernel():
    # W = bf16(bf16(code) * bf16(scale)) and x rounded to bf16: an input
    # already in bf16 gives the same product
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(-16, 16, (8, 64)).astype(np.int8))
    scales = torch.from_numpy((0.02 * rng.random((8, 2))).astype(np.float32))
    y = TQMM.qmm_plain(x, codes, scales)
    assert torch.equal(y, TQMM.qmm_plain(x.to(torch.bfloat16), codes, scales))
    w = (codes.float() * scales.to(torch.bfloat16).float().repeat_interleave(32, 1))
    ref = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float().T
    torch.testing.assert_close(y, ref, rtol=0, atol=0)
