"""Plain versions of the port's attention kernels against the JAX package's
Pallas kernels (interpret mode on the CPU).

self_attend_q8 (decode, int8 cache): f32 to 1e-5 of max |out| — the same
f32 arithmetic in another summation order; bf16 to 2e-2 — p * s_v rounds
to bf16 on both sides, and a rounding-boundary flip moves a product by one
bf16 ulp (2^-8 relative).

self_attention_qkv (encoder): bf16 output on both sides, so 2e-2 of max
|out| (a couple of bf16 ulps after the f32 sums differ in order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.ops import decode_attn as JDA
from whisper_tpu.ops import enc_attn as JEA
from whisper_tpu_torch.ops import decode_attn as TDA
from whisper_tpu_torch.ops import enc_attn as TEA

L, B, H, C, D = 2, 2, 2, 16, 64


def _q8_inputs(G, A, seed=0):
    rng = np.random.default_rng(seed)
    kv = rng.integers(-127, 128, (L, B, H, 2, C, D)).astype(np.int8)
    scale = (0.01 + 0.02 * rng.random((L, B, 2, C))).astype(np.float32)
    q = rng.standard_normal((B, H, G, D)).astype(np.float32)
    # causal over the first cells: query g sees cells < A - G + g + 1
    vis = np.arange(A)[None, :] < (A - G + np.arange(G) + 1)[:, None]
    mask = np.where(vis, 0.0, -np.inf).astype(np.float32)
    mask = np.broadcast_to(mask, (B, G, A)).copy()
    return kv, scale, q, mask


@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("A", [8, 16])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_self_attend_q8_plain_matches_pallas(G, A, dtype):
    kv, scale, q, mask = _q8_inputs(G, A)
    jd, td, tol = ((jnp.float32, torch.float32, 1e-5) if dtype == "f32"
                   else (jnp.bfloat16, torch.bfloat16, 2e-2))
    for l in range(L):
        ref = np.asarray(JDA.self_attend_q8(
            jnp.asarray(kv), jnp.asarray(scale), jnp.asarray(q),
            jnp.asarray(mask), l=l, attn_ctx=A, dtype=jd))
        before = TDA.self_attend_q8.launches
        out = TDA.self_attend_q8(
            torch.from_numpy(kv), torch.from_numpy(scale), torch.from_numpy(q),
            torch.from_numpy(mask), l=l, attn_ctx=A, dtype=td).numpy()
        assert TDA.self_attend_q8.launches == before
        assert out.shape == (B, H, G, D)
        np.testing.assert_allclose(out, ref, rtol=0, atol=tol * np.abs(ref).max())


def test_self_attend_q8_rejects_bad_mask():
    kv, scale, q, mask = _q8_inputs(1, 8)
    with pytest.raises(ValueError):
        TDA.self_attend_q8(torch.from_numpy(kv), torch.from_numpy(scale),
                           torch.from_numpy(q), torch.from_numpy(mask[:, :, :4]),
                           l=0, attn_ctx=8)


# true_len 500 (the encoder's pad columns), T (no masked column) and 1 (a
# single real column: every row is one value row of v)
@pytest.mark.parametrize("n_head,d,true_len", [
    pytest.param(2, 64, 500, id="2-64"), pytest.param(1, 128, 500, id="1-128"),
    (2, 64, 512), (1, 128, 512), (2, 64, 1), (1, 128, 1)])
def test_self_attention_qkv_plain_matches_pallas(n_head, d, true_len):
    T = 512
    S = n_head * d
    qkv = np.random.default_rng(1).standard_normal((T, 3 * S)).astype(np.float32)
    ref = np.asarray(JEA.self_attention_qkv(
        jnp.asarray(qkv), n_head, true_len=true_len, block_q=512)).astype(np.float32)
    before = TEA.self_attention_qkv.launches
    out = TEA.self_attention_qkv(torch.from_numpy(qkv), n_head, true_len=true_len)
    assert TEA.self_attention_qkv.launches == before
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == (T, S)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0,
                               atol=2e-2 * np.abs(ref).max())


@pytest.mark.parametrize("true_len", [None, 100, 1])
def test_self_attention_qkv_plain_rounds_on_load(true_len):
    # the kernel reads the f32 projection and rounds it to bf16 as it loads:
    # the plain version on an f32 buffer equals it on the buffer cast first
    qkv = torch.from_numpy(
        np.random.default_rng(3).standard_normal((128, 3 * 128)).astype(np.float32))
    a = TEA.self_attention_qkv_plain(qkv, 2, true_len)
    b = TEA.self_attention_qkv_plain(qkv.to(torch.bfloat16), 2, true_len)
    assert torch.equal(a, b)


@pytest.mark.parametrize("shape,n_head,true_len,dtype", [
    ((512, 3 * 128), 2, 500, torch.float32),
    ((1536, 3 * 1280), 20, 1500, torch.bfloat16),
    ((208, 3 * 256), 2, 1, torch.float32),
])
def test_self_attention_qkv_kernel_shapes(shape, n_head, true_len, dtype):
    qkv = torch.zeros(shape, dtype=dtype)
    t, s, d, n = TEA.kernel_shapes(qkv, n_head, true_len)
    assert (t, s, d, n) == (shape[0], shape[1] // 3, shape[1] // 3 // n_head, true_len)


@pytest.mark.parametrize("shape,n_head,true_len,dtype", [
    ((512, 3 * 96), 1, None, torch.float32),       # heads of 96
    ((512, 3 * 128), 4, None, torch.float32),      # heads of 32
    ((520, 3 * 128), 2, None, torch.float32),      # T not a multiple of 16
    ((512, 3 * 128), 2, 0, torch.float32),         # no real column
    ((512, 3 * 128), 2, 513, torch.float32),       # true_len past T
    ((512, 3 * 128), 2, None, torch.float16),      # neither f32 nor bf16
    ((512, 3 * 128 + 1), 2, None, torch.float32),  # not (T, 3S)
])
def test_self_attention_qkv_kernel_refuses(shape, n_head, true_len, dtype):
    with pytest.raises(ValueError):
        TEA.kernel_shapes(torch.zeros(shape, dtype=dtype), n_head, true_len)
