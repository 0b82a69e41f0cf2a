"""Device times of the dequantize x matmul (csrc/qmm.cu), of the encoder's
fused-QKV attention (csrc/enc_attn.cu), of the flash attention
(csrc/flash_attn.cu) and of the decode matmul (csrc/qmmt.cu) against
variants of their designs that were tried and dropped.

    python -m whisper_tpu_torch.utils.kernel_variants [qmm] [enc_attn] [flash_attn] [flash_mma] [qmmt] [qmmt_rows]

on the card; with no argument it times all six (flash_mma: the flash
attention's heads of 16 and 32; qmmt_rows: ablations of the decode
matmul's many-row route).

Each variant is a copy of the source with a few text edits (each anchored on
a line of the source, so a changed source fails loudly here), built with the
package's nvcc flags into whisper_tpu_torch/build/ and installed under the
package's wrapper.  The qmm ablations (`ablate_*`) drop part of the work on
purpose, so their error is large; they say where the time goes.  Each
variant's error against the plain version is printed and it is timed at
the shapes chip_smoke.py times, with its timer (`device_ms`: CUDA events
around CUDA-graph replays of calls on input copies that rotate past the
50 MB L2): qmm at 4096^3 on bf16 x, self_attention_qkv and
flash_self_attention at large-v3-turbo's T = 1536, true_len = 1500 on the
f32 projection and on bf16, qmmt_fused per decode step of the turbo
decoder (25 launches) at T = 1 and 4 rows (its FMA route, whose layer norm
the variants change; from QM.MMA_MIN_T rows the row pass computes it).
The kernels of the package are not changed.
"""
import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

from ..formats import quants as Q
from ..ops import _cuda
from ..ops import attention as FA
from ..ops import enc_attn as EA
from ..ops import qmm as QM

CS = str(_cuda.CSRC)

# K5: the int-to-float conversion pipe (I2F, FMUL, F2F) in place of byte
# permutes, f32 adds and bf16x2 multiplies
I2F = [("""  const uint32_t u = c ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  const uint32_t c01 = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  const uint32_t c23 = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
  asm("mul.rn.bf16x2 %0, %1, %2;\\n" : "=r"(lo) : "r"(c01), "r"(s2));
  asm("mul.rn.bf16x2 %0, %1, %2;\\n" : "=r"(hi) : "r"(c23), "r"(s2));
""", """  const float sc = __uint_as_float(s2 << 16);
  const float f0 = (float)(int8_t)(c & 0xff), f1 = (float)(int8_t)((c >> 8) & 0xff);
  const float f2 = (float)(int8_t)((c >> 16) & 0xff), f3 = (float)(int8_t)(c >> 24);
  lo = wtt_pack_bf16(f0 * sc, f1 * sc);
  hi = wtt_pack_bf16(f2 * sc, f3 * sc);
""")]
# K5: one register set; each warpgroup converts a stage, then issues and
# waits for its products, so only the other warpgroup overlaps the convert
SERIAL = [("""  float sc[2][4];
  uint32_t a0[4][4], a1[4][4];
  const int ra0 = r0 + row0;
  load_scales(sc, scales, 0, ra0, R, nb, qk);
  convert_stage(sm, 0, a0, sc, row0, qk, tg);
  if (n_it > 1) load_scales(sc, scales, 1, ra0, R, nb, qk);
#pragma unroll 1
  for (int it = 0; it < n_it; it += 2) {
    issue_stage(sm, it, acc, a0);
    if (it + 1 < n_it) {
      convert_stage(sm, it + 1, a1, sc, row0, qk, tg);
      if (it + 2 < n_it) load_scales(sc, scales, it + 2, ra0, R, nb, qk);
    }
    retire_stage(sm, it, acc);
    if (it + 1 < n_it) {
      issue_stage(sm, it + 1, acc, a1);
      if (it + 2 < n_it) {
        convert_stage(sm, it + 2, a0, sc, row0, qk, tg);
        if (it + 3 < n_it) load_scales(sc, scales, it + 3, ra0, R, nb, qk);
      }
      retire_stage(sm, it + 1, acc);
    }
  }
""", """  float sc[2][4], sn[2][4];
  uint32_t a0[4][4];
  const int ra0 = r0 + row0;
  load_scales(sc, scales, 0, ra0, R, nb, qk);
#pragma unroll 1
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) load_scales(sn, scales, it + 1, ra0, R, nb, qk);
    convert_stage(sm, it, a0, sc, row0, qk, tg);
    issue_stage(sm, it, acc, a0);
    retire_stage(sm, it, acc);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[h][j] = sn[h][j];
  }
""")]
STAGES4 = [("constexpr int STAGES = 5;", "constexpr int STAGES = 4;")]
# K4: blocks of 64 query rows and 4 warps
BQ64 = [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;"),
        ("constexpr int BQ = 128;", "constexpr int BQ = 64;")]

# K5 ablations, which give wrong results on purpose and say where the time
# goes: the dequant replaced by a register move (codes, loads and scales
# still read), one product per stage in place of four (the other three
# fragments folded into it, so their conversion stays), and the epilogue
# storing one of its 32 row groups
NO_CONVERT = [(I2F[0][0], """  lo = c;
  hi = c ^ s2;
""")]
ONE_PRODUCT = [("  for (int kk = 0; kk < 4; ++kk) wgmma_m64n256k16_rs<0>(acc, a[kk], desc_sw128(xb + kk * 32), 1);",
                """  uint32_t f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = a[0][i] ^ a[1][i] ^ a[2][i] ^ a[3][i];
  wgmma_m64n256k16_rs<0>(acc, f, desc_sw128(xb), 1);""")]
NO_EPILOGUE = [("  for (int j = 0; j < BT / 8; ++j) {", "  for (int j = 0; j < 1; ++j) {")]

QMM_VARIANTS = [("committed", []), ("i2f_dequant", I2F), ("serial_convert", SERIAL),
                ("stages_4", STAGES4), ("ablate_no_convert", NO_CONVERT),
                ("ablate_one_product", ONE_PRODUCT), ("ablate_no_epilogue", NO_EPILOGUE)]
ENC_VARIANTS = [("committed", []), ("bq64_4warps", BQ64)]
# K6: key tiles of 128 (one block per SM), two blocks per SM at D = 64 for
# f32 input too, and no prefetch (tile j + 1 loaded after tile j's products)
FLASH_LB0 = "__global__ void __launch_bounds__(kThreads, D == 64 && sizeof(TIn) == 2 ? 2 : 1)"
FLASH_LB = (FLASH_LB0, "__global__ void __launch_bounds__(kThreads, 1)")
FLASH_LB2 = (FLASH_LB0, "__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)")
FLASH_LOAD = "    if (more) tile.load(kh, vh, st.k_t, st.v_t, kv0 + BKV, T);\n"
FLASH_STORE = "      uint8_t* nk = sm + ((jt + 1) & 1) * 2 * TILE;\n"
FLASH_VARIANTS = [("committed", []),
                  ("bkv128", [("constexpr int BKV = 64;", "constexpr int BKV = 128;"), FLASH_LB]),
                  ("two_blocks_per_sm", [FLASH_LB2]),
                  ("no_prefetch", [(FLASH_LOAD, ""),
                                   (FLASH_STORE, FLASH_STORE + FLASH_LOAD.replace("    if (more) ", "      "))])]
# K6 at heads of 16 and 32 (flash_attn_mma_kernel): blocks a cluster at
# most, 32-row blocks, key tile depth, the softmax in base 2 (scores scaled
# by sm_scale * log2(e), exp2f), the per-score mask test on every tile; and
# two ablations that drop work on purpose (their error is large): no
# next-tile loads, no exps
MMA_BPS = "constexpr int kBlocksPerSm = 4;"
MMA_CLUSTER = "constexpr int kClusterMax = 4;"
MMA_LOAD = "    if (more) tile.load(kh, vh, st.k_t, st.v_t, kv0 + MBKV, T);\n"
MMA_EXP = "      s[j][0] = expf(s[j][0] - mn0); s[j][1] = expf(s[j][1] - mn0);\n" \
          "      s[j][2] = expf(s[j][2] - mn1); s[j][3] = expf(s[j][3] - mn1);\n"
MMA_ALPHA = "    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);\n"
MMA_MERGE = "      const float a0 = expf(m0 - mn0), b0 = expf(om0 - mn0);\n" \
            "      const float a1 = expf(m1 - mn1), b1 = expf(om1 - mn1);\n"
MMA_PLAIN = ("    if (all_real && kv0 + MBKV <= n_real)\n"
             "      scale_scores<false>(s, sm_scale, kv0 + tg * 2, T, n_real, real0, real1, mx0, mx1);\n"
             "    else\n"
             "      scale_scores<true>(s, sm_scale, kv0 + tg * 2, T, n_real, real0, real1, mx0, mx1);\n")
FLASH_MMA_VARIANTS = [
    ("committed", []),
    ("cluster1", [(MMA_CLUSTER, "constexpr int kClusterMax = 1;")]),
    ("cluster2", [(MMA_CLUSTER, "constexpr int kClusterMax = 2;")]),
    ("rows32", [("constexpr int kWarpsQ = 4;", "constexpr int kWarpsQ = 2;"),
                (MMA_BPS, "constexpr int kBlocksPerSm = 8;")]),
    ("bkv128", [("constexpr int MBKV = 64;", "constexpr int MBKV = 128;")]),
    ("base2_exp2f", [(MMA_PLAIN, MMA_PLAIN.replace("sm_scale,", "sm_scale * 1.44269504f,")),
                     (MMA_EXP, MMA_EXP.replace("expf(", "exp2f(")),
                     (MMA_ALPHA, MMA_ALPHA.replace("expf(", "exp2f(")),
                     (MMA_MERGE, MMA_MERGE.replace("expf(", "exp2f("))]),
    ("mask_every_tile", [(MMA_PLAIN, MMA_PLAIN.split("    else\n")[1])]),
    ("ablate_loads", [(MMA_LOAD, "")]),
    ("ablate_exp", [(MMA_EXP, MMA_EXP.replace("expf(", "("))]),
]


# K1: the layer norm's statistics as the split-K design first computed
# them, two passes of f32 sums (they round some normalised rows to bf16 one
# ulp apart from the plain version's once there are ~10^5 of them); two
# passes of f64 sums; and two passes of f64 sums one row at a time (one
# accumulator live, four block reductions per row).  The committed kernel
# takes one pass of f64 sums of x and x^2.
QMMT_LN = """    if (ln) {
      // one pass over the staged rows, float4 at a time, all rows at once:
      // sum(x) and sum(x^2) in f64 (x^2 exact there), so the statistics are
      // the f32 roundings of (nearly) exact ones, as the plain version's,
      // and the normalised rows round to bf16 alike on both (f32 sums in
      // two orders flip some of them one bf16 ulp apart once there are
      // ~10^5 of them)
      const int k4n = a.K / 4;
      const float4* xr4 = reinterpret_cast<const float4*>(xraw);
      double* dscratch = reinterpret_cast<double*>(scratch);
      double acc[2 * TT];  // sum(x) of each row, then sum(x^2)
#pragma unroll
      for (int t = 0; t < 2 * TT; ++t) acc[t] = 0.0;
      for (int i = tid; i < k4n; i += kThreads) {
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          if (t < tt) {
            const float4 v = xr4[t * k4n + i];
            const double x0 = v.x, x1 = v.y, x2 = v.z, x3 = v.w;
            acc[t] += (x0 + x1) + (x2 + x3);
            acc[TT + t] += (x0 * x0 + x1 * x1) + (x2 * x2 + x3 * x3);
          }
        }
      }
      block_sums<2 * TT>(acc, dscratch);
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        const double m = acc[t] / a.K;
        mean[t] = (float)m;
        rstd[t] = (float)(1.0 / sqrt(acc[TT + t] / a.K - m * m + (double)a.eps));
      }
    }
"""
QMMT_VARIANTS = [("committed", []),
                 ("f32_two_pass", [(QMMT_LN, """    if (ln) {
      const int k4n = a.K / 4;
      const float4* xr4 = reinterpret_cast<const float4*>(xraw);
#pragma unroll
      for (int t = 0; t < TT; ++t) mean[t] = 0.f;
      for (int i = tid; i < k4n; i += kThreads) {
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          if (t < tt) {
            const float4 v = xr4[t * k4n + i];
            mean[t] += (v.x + v.y) + (v.z + v.w);
          }
        }
      }
      block_sums_f32<TT>(mean, scratch);
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        mean[t] /= a.K;
        rstd[t] = 0.f;
      }
      for (int i = tid; i < k4n; i += kThreads) {
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          if (t < tt) {
            const float4 v = xr4[t * k4n + i];
            const float d0 = v.x - mean[t], d1 = v.y - mean[t];
            const float d2 = v.z - mean[t], d3 = v.w - mean[t];
            rstd[t] += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
          }
        }
      }
      block_sums_f32<TT>(rstd, scratch);
#pragma unroll
      for (int t = 0; t < TT; ++t) rstd[t] = 1.0f / sqrtf(rstd[t] / a.K + a.eps);
    }
"""),
                                   ("constexpr int kPerThread = 4;", """template <int TT>
__device__ __forceinline__ void block_sums_f32(float v[TT], float* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < TT; ++t) v[t] = wtt_warp_sum(v[t]);
  __syncthreads();
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < TT; ++t) scratch[warp * TT + t] = v[t];
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < TT; ++t) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += scratch[w * TT + t];
    v[t] = s;
  }
}

constexpr int kPerThread = 4;""")]),
                 ("f64_two_pass", [(QMMT_LN, """    if (ln) {
      // two passes over the staged rows, float4 at a time, all rows at
      // once, summed in f64: the statistics are the f32 roundings of
      // (nearly) exact ones, as the plain version's, so the normalised rows
      // round to bf16 alike on both (f32 sums in two orders flip some of
      // them one bf16 ulp apart once there are ~10^5 of them)
      const int k4n = a.K / 4;
      const float4* xr4 = reinterpret_cast<const float4*>(xraw);
      double* dscratch = reinterpret_cast<double*>(scratch);
      double acc[TT];
#pragma unroll
      for (int t = 0; t < TT; ++t) acc[t] = 0.0;
      for (int i = tid; i < k4n; i += kThreads) {
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          if (t < tt) {
            const float4 v = xr4[t * k4n + i];
            acc[t] += ((double)v.x + (double)v.y) + ((double)v.z + (double)v.w);
          }
        }
      }
      block_sums<TT>(acc, dscratch);
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        mean[t] = (float)(acc[t] / a.K);
        acc[t] = 0.0;
      }
      for (int i = tid; i < k4n; i += kThreads) {
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          if (t < tt) {
            const float4 v = xr4[t * k4n + i];
            const double d0 = v.x - mean[t], d1 = v.y - mean[t];
            const double d2 = v.z - mean[t], d3 = v.w - mean[t];
            acc[t] += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
          }
        }
      }
      block_sums<TT>(acc, dscratch);
#pragma unroll
      for (int t = 0; t < TT; ++t)
        rstd[t] = (float)(1.0 / sqrt(acc[t] / a.K + (double)a.eps));
    }
""")]),
                 ("f64_two_pass_row_at_a_time", [(QMMT_LN, """    if (ln) {
      const int k4n = a.K / 4;
      const float4* xr4 = reinterpret_cast<const float4*>(xraw);
      double* dscratch = reinterpret_cast<double*>(scratch);
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        if (t < tt) {
          double acc[1] = {0.0};
          for (int i = tid; i < k4n; i += kThreads) {
            const float4 v = xr4[t * k4n + i];
            acc[0] += ((double)v.x + (double)v.y) + ((double)v.z + (double)v.w);
          }
          block_sums<1>(acc, dscratch);
          mean[t] = (float)(acc[0] / a.K);
          acc[0] = 0.0;
          for (int i = tid; i < k4n; i += kThreads) {
            const float4 v = xr4[t * k4n + i];
            const double d0 = v.x - mean[t], d1 = v.y - mean[t];
            const double d2 = v.z - mean[t], d3 = v.w - mean[t];
            acc[0] += (d0 * d0 + d1 * d1) + (d2 * d2 + d3 * d3);
          }
          block_sums<1>(acc, dscratch);
          rstd[t] = (float)(1.0 / sqrt(acc[0] / a.K + (double)a.eps));
        }
      }
    }
""")])]


# K1/K2's many-row route: ablations (each drops part of the work, so its
# error is large; they say where a call's time goes) and the row pass and
# the product kernel alone
QMMT_ROWS_VARIANTS = [
    ("committed", []),
    ("no_dependent_launch", [("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")]),
    ("ablate_scale", [("        scale(acc, st, bl);\n", "")]),
    ("ablate_convert", [("        if (p < n_kc) {\n          // a slot taken in turn",
                         "        if (p < 0) {\n          // a slot taken in turn")]),
    ("ablate_fixup", [("    if (n_slices > 1) {\n      // split-K fix-up",
                       "    if (n_slices < 0) {\n      // split-K fix-up")]),
    ("row_pass_only", [("  const int groups = (T + rows - 1) / rows;\n",
                        "  const int groups = (T + rows - 1) / rows;\n  if (groups > 0) return 0;\n")]),
    ("products_only", [("  cudaError_t err = launch_pdl(\n      qmmt_rows_prep_kernel,",
                        "  cudaError_t err = cudaSuccess;\n  if (T < 0) err = launch_pdl(\n      qmmt_rows_prep_kernel,")]),
]


def build(name, tag, edits):
    """Install a copy of csrc/<name>.cu with `edits` under the wrapper;
    returns ptxas's register and spill lines."""
    with open(os.path.join(CS, name + ".cu")) as f:
        src = f.read()
    for a, b in edits:
        assert a in src, a
        src = src.replace(a, b, 1)
    _cuda.BUILD.mkdir(parents=True, exist_ok=True)
    out = str(_cuda.BUILD / f"{name}_{tag}.cu")
    with open(out, "w") as f:
        f.write(src)
    so = str(_cuda.BUILD / f"{name}_{tag}.so")
    r = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", CS, "-o", so, out],
                       check=True, capture_output=True, text=True)
    _cuda._LIBS[name] = _cuda._bind(name, ctypes.CDLL(so))
    return [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
            if "Used" in ln or "spill" in ln or "C7513" in ln]


def main(which=("qmm", "enc_attn", "flash_attn", "flash_mma", "qmmt", "qmmt_rows")):
    if not torch.cuda.is_available():
        raise SystemExit("kernel_variants: no CUDA card")
    # the same timer as chip_smoke.py phase 3, from the root of the checkout
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    from chip_smoke import device_ms
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)
    if "qmm" in which:
        time_qmm(dev, g, device_ms)
    if "enc_attn" in which:
        time_enc_attn(dev, g, device_ms)
    if "flash_attn" in which:
        time_flash_attn(dev, device_ms)
    if "flash_mma" in which:
        time_flash_mma(dev, device_ms)
    if "qmmt" in which:
        time_qmmt(dev, g, device_ms)
    if "qmmt_rows" in which:
        time_qmmt_rows(dev, g, device_ms)


def time_qmm(dev, g, device_ms):
    N = 4096
    xb = torch.randn((N, N), generator=g).to(dev, torch.bfloat16)
    codes = torch.randint(-16, 16, (N, N), generator=g, dtype=torch.int8).to(dev)
    scales = (0.02 * torch.rand((N, N // 32), generator=g)).to(dev)
    ref = QM.qmm_plain(xb, codes, scales)
    planes = {}

    def plane(i):
        if i not in planes:
            planes[i] = (codes.clone(), scales.clone())
        return planes[i]
    for tag, edits in QMM_VARIANTS:
        ptxas = build("qmm", tag, edits)
        y = QM.qmm(xb, codes, scales)
        torch.cuda.synchronize()
        err = ((y - ref).abs().max() / ref.abs().max()).item()
        ms = device_ms(lambda i: (lambda: QM.qmm(xb, *plane(i))), N * N * 7)
        print(f"qmm[4096^3, bf16 x] {tag}: ms={ms:.5f} tflops={2 * N ** 3 / ms / 1e9:.1f} "
              f"max_err/max_ref={err:.2e} ptxas={ptxas}", flush=True)
    planes.clear()


def time_qmmt(dev, g, device_ms):
    """K1's FMA route on the turbo decoder's uses (chip_smoke.py phase
    3's), planes pitched as the main path installs them: per decode step at
    T = 1 and 4 (4 layers of six matmuls and the logits head); the largest
    error against the plain version."""
    S = 1280
    uses = [("qkv", S, 3 * S, True, True, None, False, 4),  # K, R, ln, bias, act, res, per step
            ("o", S, S, False, True, None, True, 4),
            ("xq", S, S, True, True, None, False, 4),
            ("xo", S, S, False, True, None, True, 4),
            ("mlp0", S, 4 * S, True, True, "gelu", False, 4),
            ("mlp1", 4 * S, S, False, True, None, True, 4),
            ("logits", S, 51866, True, False, None, False, 1)]
    cases = [(T, u) for T in (1, 4) for u in uses]
    inputs = {}
    for _, (name, K, R, ln, bias, act, res, _) in cases:
        if name not in inputs:
            w = torch.randn((R, K), generator=g).numpy()
            p = Q.unpack_to_planes(Q.quantize(w, Q.GGML_TYPE_Q5_0), Q.GGML_TYPE_Q5_0, (R, K))
            inputs[name] = QM.pitch_qweight_t(p.codes.T, p.scales.T, device=dev)
    for tag, edits in QMMT_VARIANTS:
        ptxas = build("qmmt", tag, edits)
        step, err = {}, 0.0
        for T, (name, K, R, ln, bias, act, res, per_step) in cases:
            qw = inputs[name]
            gx = torch.Generator().manual_seed(T)
            rnd = lambda *sh: torch.randn(sh, generator=gx).to(dev)
            x = rnd(T, K)
            kw = dict(ln_w=rnd(K) if ln else None, ln_b=rnd(K) if ln else None,
                      bias=rnd(R) if bias else None, residual=rnd(T, R) if res else None,
                      act=act, dtype=torch.bfloat16)
            y = QM.qmmt_fused(x, qw.codes_t, qw.scales_t, **kw)
            ref = QM.qmmt_fused_plain(x, qw.codes_t, qw.scales_t, **kw)
            torch.cuda.synchronize()
            e = ((y - ref).abs().max() / ref.abs().max()).item()
            err = max(err, e)
            copies = {}

            def planes(i, qw=qw):
                if i not in copies:
                    copies[i] = QM.pitch_qweight_t(qw.codes_t, qw.scales_t, device=dev)[:2]
                return copies[i]
            ms = device_ms(lambda i: (lambda: QM.qmmt_fused(x, *planes(i), **kw)),
                           K * R * 9 // 8)
            copies.clear()
            step[T] = step.get(T, 0.0) + per_step * ms
        print(f"qmmt_fused per decode step (25 launches) {tag}: "
              + " ".join(f"T={T}:{v:.5f}" for T, v in step.items())
              + f" max_err/max_ref={err:.2e} ptxas={ptxas}", flush=True)


def time_qmmt_rows(dev, g, device_ms):
    """K1/K2's many-row route (forced at every T) on turbo shapes of
    chip_smoke.py phase 3: a DTW pass's o projection (T = 32, 128), mlp1
    at a batched step (T = 8) and a DTW pass (T = 32), qkv at a beam step
    (T = 5) and a prompt pass (T = 128), the logits head at T = 20 and
    1024, each variant's call in turn."""
    shapes = [("o", 32, 1280, 1280, False), ("o", 128, 1280, 1280, False),
              ("mlp1", 8, 5120, 1280, False), ("mlp1", 32, 5120, 1280, False),
              ("qkv", 5, 1280, 3840, True), ("qkv", 128, 1280, 3840, True),
              ("logits", 20, 1280, 51866, True), ("logits", 1024, 1280, 51866, True)]
    libs = {tag: (build("qmmt", tag, edits), _cuda._LIBS["qmmt"])
            for tag, edits in QMMT_ROWS_VARIANTS}
    for tag, (ptxas, _) in libs.items():
        print(f"qmmt_rows {tag}: ptxas={ptxas}", flush=True)
    chosen = QM.MMA_MIN_T
    QM.MMA_MIN_T = 1
    for name, T, K, R, ln in shapes:
        w = torch.randn((R, K), generator=g).numpy()
        p = Q.unpack_to_planes(Q.quantize(w, Q.GGML_TYPE_Q5_0), Q.GGML_TYPE_Q5_0, (R, K))
        qw = QM.pitch_qweight_t(p.codes.T, p.scales.T, device=dev)
        x = torch.randn((T, K), generator=g).to(dev)
        kw = dict(ln_w=torch.ones(K, device=dev), ln_b=torch.zeros(K, device=dev)) if ln else {}
        copies = {}

        def planes(i):
            if i not in copies:
                copies[i] = QM.pitch_qweight_t(qw.codes_t, qw.scales_t, device=dev)[:2]
            return copies[i]
        line = []
        for tag, (_, lib) in libs.items():
            _cuda._LIBS["qmmt"] = lib
            ms = device_ms(lambda i: (lambda: QM.qmmt_fused(x, *planes(i), **kw)),
                           K * R * 9 // 8 + T * K * 4)
            line.append(f"{tag}={ms:.5f}")
        copies.clear()
        print(f"qmmt_rows[{name}, T={T}] ms: " + " ".join(line), flush=True)
    QM.MMA_MIN_T = chosen
    _cuda._LIBS["qmmt"] = libs["committed"][1]


def time_enc_attn(dev, g, device_ms):
    T, true_len, H, D = 1536, 1500, 20, 64
    qkv = torch.randn((T, 3 * H * D), generator=g).to(dev)
    aref = EA.self_attention_qkv_plain(qkv, H, true_len=true_len).float()
    bufs = {}
    for tag, edits in ENC_VARIANTS:
        ptxas = build("enc_attn", tag, edits)
        for src in (qkv, qkv.to(torch.bfloat16)):
            def buf(i, src=src):
                if (src.dtype, i) not in bufs:
                    bufs[src.dtype, i] = src.clone()
                return bufs[src.dtype, i]
            o = EA.self_attention_qkv(src, H, true_len=true_len)
            torch.cuda.synchronize()
            err = ((o.float() - aref).abs().max() / aref.abs().max()).item()
            ms = device_ms(lambda i: (lambda: EA.self_attention_qkv(buf(i), H, true_len=true_len)),
                          src.numel() * src.element_size())
            print(f"self_attention_qkv[T={T}, {str(src.dtype)[6:]} qkv] {tag}: ms={ms:.5f} "
                  f"max_err/max_ref={err:.2e}", flush=True)
        print(f"  enc_attn {tag} ptxas={ptxas}", flush=True)
        bufs.clear()


def time_flash_attn(dev, device_ms):
    """K6 as chip_smoke.py phase 3 times it: head views of the (T, 3S)
    projection, f32 and bf16, each variant checked against the plain
    version on real rows (tolerance 2e-2) and at D = 128 (10 heads)."""
    T, true_len, H, D = 1536, 1500, 20, 64
    S = H * D
    qkv = torch.randn((T, 3 * S), generator=torch.Generator().manual_seed(4)).to(dev)

    def views(buf, h=H):
        return [buf[:, i * S:(i + 1) * S].reshape(T, h, S // h).transpose(0, 1)
                for i in range(3)]

    refs = {(src.dtype, h): FA.flash_self_attention_plain(*views(src, h), true_len=true_len)
            for src in (qkv, qkv.to(torch.bfloat16)) for h in (H, 10)}
    bufs = {}
    for tag, edits in FLASH_VARIANTS:
        ptxas = build("flash_attn", tag, edits)
        for src in (qkv, qkv.to(torch.bfloat16)):
            err = 0.0
            for h in (H, 10):
                o = FA.flash_self_attention(*views(src, h), true_len=true_len)
                torch.cuda.synchronize()
                err = max(err, (o - refs[src.dtype, h])[:, :true_len].abs().max().item())

            def buf(i, src=src):
                if (src.dtype, i) not in bufs:
                    bufs[src.dtype, i] = views(src.clone())
                return bufs[src.dtype, i]
            ms = device_ms(lambda i: (lambda: FA.flash_self_attention(*buf(i), true_len=true_len)),
                           4 * T * S * src.element_size())
            print(f"flash_self_attention[T={T}, {str(src.dtype)[6:]} qkv] {tag}: ms={ms:.5f} "
                  f"per_encode_ms={32 * ms:.4f} max_abs_err={err:.2e} (D=64 and D=128)",
                  flush=True)
        print(f"  flash_attn {tag} ptxas={ptxas}", flush=True)
        bufs.clear()


def time_flash_mma(dev, device_ms):
    """K6's heads of 32 and 16 as chip_smoke.py phase 3 times them (2 heads
    of 32 and 6 of 16 at T = 1536, 1500 real, head views of the f32 and
    bf16 projection), each variant's largest error over real rows against
    the plain version, as a share of FLASH_REL_TOL * max |ref|."""
    from chip_smoke import FLASH_REL_TOL
    T, true_len = 1536, 1500
    shapes = ((2, 32), (6, 16))
    qkv = {hd: torch.randn((T, 3 * hd[0] * hd[1]),
                           generator=torch.Generator().manual_seed(4)).to(dev)
           for hd in shapes}

    def views(buf, h, d):
        return [buf[:, i * h * d:(i + 1) * h * d].reshape(T, h, d).transpose(0, 1)
                for i in range(3)]

    refs = {(hd, dt): FA.flash_self_attention_plain(*views(qkv[hd].to(dt), *hd),
                                                    true_len=true_len)
            for hd in shapes for dt in (torch.float32, torch.bfloat16)}
    bufs = {}
    for tag, edits in FLASH_MMA_VARIANTS:
        ptxas = build("flash_attn", tag, edits)
        for (h, d) in shapes:
            for dt in (torch.float32, torch.bfloat16):
                src = qkv[h, d].to(dt)
                ref = refs[(h, d), dt][:, :true_len]
                o = FA.flash_self_attention(*views(src, h, d), true_len=true_len)
                torch.cuda.synchronize()
                err = (o[:, :true_len] - ref).abs().max().item()
                share = err / (FLASH_REL_TOL * ref.abs().max().item())

                def buf(i, src=src, h=h, d=d):
                    if (h, src.dtype, i) not in bufs:
                        bufs[h, src.dtype, i] = views(src.clone(), h, d)
                    return bufs[h, src.dtype, i]
                ms = device_ms(lambda i: (lambda: FA.flash_self_attention(
                    *buf(i), true_len=true_len)), 4 * T * h * d * src.element_size())
                print(f"flash_self_attention[H={h}, D={d}, T={T}, {str(dt)[6:]} qkv] {tag}: "
                      f"ms={ms:.5f} err/tol={share:.3f}", flush=True)
        print(f"  flash_attn {tag} ptxas={ptxas}", flush=True)
        bufs.clear()


if __name__ == "__main__":
    main(sys.argv[1:] or ("qmm", "enc_attn", "flash_attn", "flash_mma", "qmmt", "qmmt_rows"))
