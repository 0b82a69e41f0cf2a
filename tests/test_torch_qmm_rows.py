"""K1/K2's many-row route (csrc/qmmt.cu qmmt_rows_kernel) on the CPU: its
split rule and workspace bound at the turbo decoder's shapes, the route
choice, the plain version of its row pass, and the plain versions at the
route's row counts against the JAX package's Pallas kernels (interpret
mode).  The kernel itself runs on the card (tests/test_torch_gpu.py).

Tolerance against JAX: 1e-5 of max |y|, as tests/test_torch_qmm.py: both
sides compute the same per-block products in f32 and differ only in
summation order; the bf16 case rounds the same operands on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from whisper_tpu.ops import qmm as JQMM
from whisper_tpu_torch.formats import quants as Q
from whisper_tpu_torch.ops import qmm as TQMM

N_SM = 132   # an H100's SMs
TURBO = {"qkv": (1280, 3840), "o": (1280, 1280), "mlp0": (1280, 5120),
         "mlp1": (5120, 1280), "logits": (1280, 51866)}


@pytest.mark.parametrize("T", [1, 5, 32, 128, 1024])
@pytest.mark.parametrize("use", list(TURBO))
def test_rows_plan_workspace_within_code_bytes(T, use):
    K, R = TURBO[use]
    plan = TQMM.rows_plan(T, K, R, 32, N_SM)
    tiles = -(-R // TQMM.TILE)
    # whole 64-row chunks of K, every row of K and of T covered once
    assert plan.ks % TQMM.KC == 0 and plan.slices == -(-K // plan.ks)
    assert (plan.slices - 1) * plan.ks < K <= plan.slices * plan.ks
    assert plan.groups == -(-T // plan.rows) and plan.n in (8, 16, 32, 64)
    assert min(plan.rows, T) <= 2 * plan.n or plan.rows % TQMM.RC_MAX == 0
    # the split-K workspace never exceeds the call's code bytes
    assert plan.ws_floats * 4 <= K * R
    assert (plan.ws_floats == 0) == (plan.slices == 1)
    # the block fits in shared memory with at least two ring stages
    chunks = -(-min(plan.rows, T) // (2 * plan.n))
    assert TQMM.rows_stages(plan.ks, plan.n, chunks, False) >= 2
    # K is split only while the blocks fit in one wave
    blocks = tiles * plan.slices * plan.groups
    if plan.slices > 1:
        assert blocks <= TQMM._blocks_per_sm(plan.n) * N_SM


def test_rows_plan_logits_head_one_slice_from_32_rows():
    # the logits head's 811 tiles fill the card: K is not split, so no
    # workspace at prompt-pass rows (1.06 GB a call at T = 1024 before)
    for T in (32, 128, 224, 1024):
        plan = TQMM.rows_plan(T, *TURBO["logits"], 32, N_SM)
        assert plan.slices == 1 and plan.ws_floats == 0 and plan.groups == 1


def test_rows_plan_keeps_converted_codes_for_every_row_chunk():
    # a block that walks several row chunks keeps its slice's converted
    # codes (K = 1280 at 1024 rows); mlp1's K = 5120 cannot stay beside the
    # ring, so its groups hold one row chunk each
    plan = TQMM.rows_plan(1024, *TURBO["logits"], 32, N_SM)
    assert plan.rows == 1024 and plan.n == 64
    assert TQMM.rows_stages(plan.ks, plan.n, 8, False) >= 2
    plan = TQMM.rows_plan(1024, *TURBO["mlp1"], 32, N_SM)
    assert plan.rows == TQMM.RC_MAX and plan.groups == 8 and plan.slices == 1
    assert TQMM.rows_stages(5120, 64, 8, False) == 0


@pytest.mark.parametrize("affine", [False, True])
def test_rows_plan_affine_planes_fit(affine):
    for use, (K, R) in TURBO.items():
        for T in (8, 20, 128, 224, 1024):
            plan = TQMM.rows_plan(T, K, R, 32, N_SM, affine)
            chunks = -(-min(plan.rows, T) // (2 * plan.n))
            assert TQMM.rows_stages(plan.ks, plan.n, chunks, affine) >= 2, (use, T)


def test_route_choice():
    bf16, f32 = torch.bfloat16, torch.float32
    m = TQMM.MMA_MIN_T
    assert m >= 2
    # the decode step stays on the FMA route; from the crossover on, bf16
    # rows take the many-row route
    assert not TQMM._use_mma(1, 1280, 32, bf16)
    assert not TQMM._use_mma(m - 1, 1280, 32, bf16)
    for T in (m, 8, 20, 128, 1024):
        assert TQMM._use_mma(max(T, m), 1280, 32, bf16)
        assert TQMM._use_mma(max(T, m), 1280, 16, bf16)
        # f32 compute keeps the FMA route at every T; qk = 8 and K not a
        # multiple of 64 have no whole k-steps or chunks
        assert not TQMM._use_mma(max(T, m), 1280, 32, f32)
        assert not TQMM._use_mma(max(T, m), 1280, 8, bf16)
        assert not TQMM._use_mma(max(T, m), 1312, 32, bf16)


@pytest.mark.parametrize("ln", [True, False])
@pytest.mark.parametrize("qk", [16, 32])
def test_rows_pass_plain_matches_fused_plain(ln, qk):
    rng = np.random.default_rng(3)
    T, K, R = 20, 256, 64
    x = torch.from_numpy((3 * rng.standard_normal((T, K)) + 1).astype(np.float32))
    lw = torch.from_numpy((1 + 0.1 * rng.standard_normal(K)).astype(np.float32)) if ln else None
    lb = torch.from_numpy((0.1 * rng.standard_normal(K)).astype(np.float32)) if ln else None
    rows, xsum = TQMM.qmmt_rows_plain(x, qk, lw, lb)
    assert rows.dtype == torch.bfloat16 and rows.shape == (T, K)
    assert xsum.shape == (T, K // qk)
    # the layer norm's statistics from f64 sums, as an f64 reference
    x64 = x.double()
    if ln:
        mean = x64.mean(-1, keepdim=True)
        var = (x64 * x64).mean(-1, keepdim=True) - mean * mean
        ref = (x64 - mean) / torch.sqrt(var + 1e-5) * lw.double() + lb.double()
    else:
        ref = x64
    # within one bf16 rounding of the exact rows
    assert ((rows.double() - ref).abs() <= 2.0 ** -8 * ref.abs() + 1e-6).all()
    np.testing.assert_allclose(xsum.numpy(), rows.float().reshape(T, -1, qk).sum(-1).numpy(),
                               rtol=0, atol=1e-5)
    # qmmt_fused_plain multiplies exactly these rows
    codes = torch.from_numpy(rng.integers(-16, 16, (K, R)).astype(np.int8))
    scales = torch.from_numpy((0.01 + 0.02 * rng.random((K // qk, R))).astype(np.float32))
    mins = torch.from_numpy((0.05 * rng.standard_normal((K // qk, R))).astype(np.float32))
    y = TQMM.qmmt_fused_plain(x, codes, scales, mins, ln_w=lw, ln_b=lb)
    w = codes.double() * scales.double().repeat_interleave(qk, 0)
    exact = rows.double() @ w + xsum.double() @ mins.double()
    assert (y.double() - exact).abs().max() <= 1e-5 * exact.abs().max()


def _planes(qtype, k, r, seed):
    w = np.random.default_rng(seed).standard_normal((r, k)).astype(np.float32)
    p = Q.unpack_to_planes(Q.quantize(w, qtype), qtype, (r, k))
    tr = lambda a: None if a is None else np.ascontiguousarray(a.T)
    return tr(p.codes).astype(np.int8), tr(p.scales), tr(p.mins)


# the route's row counts (a batched step, two beam windows, a DTW pass and
# prompt bucket) with the whole prologue and epilogue, at cheap widths.  In
# bf16 at 128 rows the JAX kernel's two-pass f32 layer-norm statistics round
# a few normalised inputs one bf16 step apart from the port's f64 ones (the
# port's defined numerics, tests/test_torch_gpu.py's note on the batched
# rows): there both sides take the rows normalised once by the port's plain
# layer norm, which test_rows_pass_plain_matches_fused_plain holds to f64
@pytest.mark.parametrize("T", [8, 20, 128])
@pytest.mark.parametrize("qtype", [Q.GGML_TYPE_Q5_0, Q.GGML_TYPE_Q4_1], ids=["q5_0", "q4_1"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_qmmt_fused_plain_matches_pallas_at_many_rows(T, qtype, dtype):
    K, R = 128, 96
    rng = np.random.default_rng(T)
    codes, scales, mins = _planes(qtype, K, R, 13)
    x = rng.standard_normal((T, K)).astype(np.float32)
    lw = (1 + 0.1 * rng.standard_normal(K)).astype(np.float32)
    lb = (0.1 * rng.standard_normal(K)).astype(np.float32)
    b = rng.standard_normal(R).astype(np.float32)
    r = rng.standard_normal((T, R)).astype(np.float32)
    jd, td = ((jnp.float32, torch.float32) if dtype == "f32"
              else (jnp.bfloat16, torch.bfloat16))
    if dtype == "bf16" and T == 128:
        x = TQMM._rows(torch.from_numpy(x), torch.from_numpy(lw), torch.from_numpy(lb),
                       1e-5, torch.float32).numpy()
        lw = lb = None
    jo = lambda a: None if a is None else jnp.asarray(a)
    to = lambda a: None if a is None else torch.from_numpy(a)
    y_ref = np.asarray(JQMM.qmmt_fused(
        jo(x), jo(codes), jo(scales), jo(mins), ln_w=jo(lw), ln_b=jo(lb), bias=jo(b),
        residual=jo(r), act="gelu", block_r=256, dtype=jd, interpret=True))
    y = TQMM.qmmt_fused(to(x), *TQMM.pitch_qweight_t(codes, scales, mins), ln_w=to(lw),
                        ln_b=to(lb), bias=to(b), residual=to(r), act="gelu",
                        dtype=td).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-5 * np.abs(y_ref).max())
    # K2, the bare product
    y_ref = np.asarray(JQMM.qmmt(jo(x), jo(codes), jo(scales), jo(mins), block_r=256,
                                 dtype=jd, interpret=True))
    y = TQMM.qmmt(to(x), to(codes), to(scales), to(mins), dtype=td).numpy()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=1e-5 * np.abs(y_ref).max())
