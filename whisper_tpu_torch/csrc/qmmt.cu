// Split-K streaming dequant x matmul over transposed block-quantized planes.
//
// Replaces the TPU kernels whisper_tpu/ops/qmm.py qmmt_fused
// (_qmmt_fused_kernel) and qmmt (_qmmt_kernel, the same computation with no
// prologue or epilogue):
//
//   out[T, R] = act(LN(x) @ dequant(codes_t, scales_t[, mins_t]) + bias) + res
//
//   x (T, K) f32; codes_t (K, R) int8 with a row pitch of pitch_c bytes;
//   scales_t / mins_t (K/qk, R) f32 with a row pitch of pitch_s floats;
//   ln_w, ln_b (K,); bias (R,); res (T, R) f32; out (T, R) f32.
//
// Numerics follow the TPU kernel, but for the layer norm's statistics:
// mean and variance from one pass of f64 sums (the TPU kernel's two f32
// passes, summed in another order here, would round some normalised rows
// to bf16 apart from the plain version's), rounded to f32; the
// normalisation in f32, the normalised rows rounded to bf16 when
// the compute type is bf16, each qk-block's dot accumulated in f32 and scaled by
// that block's scale afterwards, affine formats adding sum(x_blk) * min per
// block, then bias, tanh-GELU and the residual in f32.
//
// What bounds it on an H100: bytes.  At decode shapes T is a few rows, so
// the int8 code plane (1 B per weight) plus the f32 scale plane (1/8 B per
// weight) is nearly all the traffic: 178 MB per large-v3-turbo decode step,
// 74.7 MB of it in the logits head, about 53 us at 3.35 TB/s.  Reaching that
// needs megabytes of loads in flight across the card and code conversion
// that keeps pace with them.
//
// Design:
//  * Work items are (64-column tile, K-slice) pairs, grid (tiles, slices).
//    The wrapper picks the slice (ks = 8 qk, or 4 qk when that leaves fewer
//    than two blocks per SM, four at T = 1), so the 1280-wide projections
//    run 200 blocks of 128 threads and the logits head 4055, not 40 and 811.
//  * Bytes in flight: each block first issues cp.async copies (16 B per
//    thread) of its whole code tile (ks x 64 B) and its scale (and min) rows
//    into shared memory, in three groups: the activation rows (whole rows
//    for the layer norm, else the slice; through L1, as the blocks of an SM
//    read the same rows); the scale (min) rows and each warp's first
//    qk-block of codes; the other codes with the epilogue's residual rows
//    and bias.  No operand waits in registers, so a block needs 63
//    registers at T = 1 and 128 at T = 5, and more blocks fit on an SM.
//    Every tile byte is read from device memory once, whatever T is: groups
//    of up to 8 activation rows loop over the staged tile.
//  * Pitched planes: the planes are installed with rows padded to a multiple
//    of 64 columns (ops/qmm.py pitch_qweight_t), so every code row of every
//    plane, the logits head's included, starts 16-byte aligned; the ragged
//    last tile is masked at the store.
//  * The prologue runs once per block with all 128 threads: the block stages
//    its rows, reduces the layer-norm statistics over the full K (two block
//    reductions), and normalises and rounds only its own K-slice.
//  * Inner product, two routes, both converting codes exactly with one
//    byte-permute each against the float 2^23 (2 instructions per code).  A
//    warp owns whole qk-blocks, so each qk-block is one f32 dot scaled after
//    the dot.
//    - CUDA cores (f32, and bf16 below 8 rows): a lane takes 4 adjacent
//      columns of the even or the odd rows (a 64-byte tile row fills 16
//      banks: no conflicts) and does T FMAs per code; the two half-warps
//      meet with one shuffle.
//    - Tensor cores (bf16 from 8 rows: prompt passes): mma.sync m16n8k16,
//      A = 16 columns x 16 rows of codes converted to bf16 (exact: integers
//      in [-128, 127]), B = 8 activation rows in bf16, fresh f32
//      accumulators per qk-block.  chip_smoke.py times both routes at T = 1,
//      5 and 32: the FMAs win at 1 and 5, the tensor cores at 32.
//  * Split-K fix-up in the same launch, deterministic: each block writes its
//    (T x 64) partial to an f32 workspace and, after a block barrier, thread
//    0 counts the block in on a per-tile arrival counter with one
//    acquire-release atomic (no separate fences).  The last block to arrive
//    copies the tile's partials from L2 with 16-byte cp.async copies, sums
//    them in slice order, runs the epilogue (bias, GELU, residual; operands
//    prefetched at the block's start), writes out and resets the counter to
//    0 for the next launch (or the next replay of a captured CUDA graph).
//    No float atomics: the result does not depend on the order in which
//    blocks arrive.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int BC = 64;  // output columns per tile (16 lanes x 4)

__device__ __forceinline__ float gelu_tanh(float v) {
  // jax.nn.gelu(approximate=True)
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
}

__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v) : "memory");
  return old;
}

// the four int8 codes of `w` as exact floats: (u + 2^23) - (2^23 + 128) with
// u = code + 128 placed in the mantissa of 2^23 by one byte permute
__device__ __forceinline__ void codes4(uint32_t w, float c[4]) {
  w ^= 0x80808080u;
  c[0] = __int_as_float(__byte_perm(w, 0x4B000000u, 0x7650)) - 8388736.0f;
  c[1] = __int_as_float(__byte_perm(w, 0x4B000000u, 0x7651)) - 8388736.0f;
  c[2] = __int_as_float(__byte_perm(w, 0x4B000000u, 0x7652)) - 8388736.0f;
  c[3] = __int_as_float(__byte_perm(w, 0x4B000000u, 0x7653)) - 8388736.0f;
}

// Sums of N f64 values per thread over the block (the layer norm's
// statistics); every thread gets all N.  scratch holds kWarps*N.
template <int N>
__device__ __forceinline__ void block_sums(double v[N], double* scratch) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int t = 0; t < N; ++t) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[t] += __shfl_xor_sync(WTT_FULL_MASK, v[t], off);
  }
  __syncthreads();  // scratch may still be read from a previous call
  if (lane == 0) {
#pragma unroll
    for (int t = 0; t < N; ++t) scratch[warp * N + t] = v[t];
  }
  __syncthreads();
#pragma unroll
  for (int t = 0; t < N; ++t) {
    double s = 0.0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += scratch[w * N + t];
    v[t] = s;
  }
}

constexpr int kPerThread = 4;  // slice columns per thread: ks <= 512
constexpr int kEpRows = 8;     // residual rows prefetched for the epilogue
constexpr int kEpFloats = (kEpRows + 1) * BC;

// the block sums' room, rounded up so that the float4 rows after it stay
// 16-byte aligned
__host__ __device__ constexpr int xsum_floats(int tt, int nbs) { return (tt * nbs + 3) & ~3; }

struct Args {
  const float* x;
  const int8_t* codes;
  const float* scales;
  const float* mins;
  const float* ln_w;
  const float* ln_b;
  const float* bias;
  const float* res;
  float* out;
  float* ws;
  int* counters;
  int T, K, R, pitch_c, pitch_s, qk, ks, round_bf16, act_gelu;
  int body_floats;  // floats of shared memory after the epilogue's operands
  float eps;
};

// bias, GELU and residual for output (t, tile column c); ep holds the
// tile's residual rows t < 8 and its bias, prefetched at the block's start
__device__ __forceinline__ float epilogue(const Args& a, const float* ep, float y, int t,
                                          int c, int col) {
  if (a.bias != nullptr) y += ep[kEpRows * BC + c];
  if (a.act_gelu) y = gelu_tanh(y);
  if (a.res != nullptr) y += t < kEpRows ? ep[t * BC + c] : a.res[(size_t)t * a.R + col];
  return y;
}

// TT: activation rows per group; MMA: the product on the tensor cores (bf16
// compute type, TT = 8, qk a multiple of 16), else on CUDA-core FMAs
template <int TT, bool MMA>
__global__ void __launch_bounds__(kThreads) qmmt_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockIdx.x, slice = blockIdx.y, n_slices = gridDim.y;
  const int k0 = slice * a.ks;
  const int kn = min(a.ks, a.K - k0);      // rows of this slice (a multiple of qk)
  const int qk = a.qk, half = qk / 2;
  const int nbs = kn / qk;                 // qk-blocks in this slice
  const int nbs_max = a.ks / qk;
  const bool ln = a.ln_w != nullptr, affine = a.mins != nullptr;

  // shared memory: the epilogue's operands, code tile, scale (min) rows, the
  // slice's activation rows (de-interleaved by row parity), block sums, warp
  // partials, the staged activation rows (whole rows for the layer norm,
  // else the slice)
  float* ep = reinterpret_cast<float*>(smem);                         // (8 + 1, 64)
  unsigned char* body = smem + kEpFloats * sizeof(float);
  int8_t* ct = reinterpret_cast<int8_t*>(body);                       // (ks, 64)
  float* ss = reinterpret_cast<float*>(body + (size_t)a.ks * BC);     // (nbs, 64)
  float* sm = ss + nbs_max * BC;                                      // (nbs, 64)
  float* xd = sm + (affine ? nbs_max * BC : 0);                       // (TT, ks)
  float* xsum = xd + TT * a.ks;                                       // (TT, nbs)
  float* red = xsum + xsum_floats(TT, nbs_max);                       // (warps, TT, 64)
  float* scratch = red + kWarps * TT * BC;                            // (warps, 2 TT) f64
  float* xraw = scratch + 4 * kWarps * TT;                            // (tt, K | ks)
  // the tensor-core path keeps the activation rows in bf16, rows padded so
  // that the 8 rows of a fragment load fall in distinct banks
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(xd);           // (TT, ks + 16)
  const int xbs = a.ks + 16;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int col_base = tile * BC;

  // 1. issue the block's copies in three groups: the first row group's
  //    activation rows (whole rows for the layer norm, else the slice); the
  //    scale (min) rows and the code rows of each warp's first qk-block; the
  //    other code rows and the epilogue's residual rows and bias
  auto stage_x = [&](int t0, int tt) {
    const float* src = a.x + (size_t)t0 * a.K;
    if (ln) {
      for (int i = tid * 4; i < tt * a.K; i += kThreads * 4) wtt_cp_async_ca<16>(xraw + i, src + i);
    } else {
      for (int i = tid * 4; i < tt * kn; i += kThreads * 4) {
        const int t = i / kn, k = i - t * kn;
        wtt_cp_async_ca<16>(xraw + t * a.ks + k, src + (size_t)t * a.K + k0 + k);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage_x(0, min(TT, a.T));
  const int kn_first = min(nbs, kWarps) * qk;
  for (int i = tid; i < nbs * 16; i += kThreads) {
    const int b = i >> 4, c = (i & 15) * 4;
    const bool in = col_base + c + 4 <= a.pitch_s;
    const size_t off = (size_t)(k0 / qk + b) * a.pitch_s + col_base + c;
    wtt_cp_async16(ss + b * BC + c, in ? a.scales + off : a.scales, in ? 16 : 0);
    if (affine) wtt_cp_async16(sm + b * BC + c, in ? a.mins + off : a.mins, in ? 16 : 0);
  }
  for (int stage = 0; stage < 2; ++stage) {
    const int r0 = stage == 0 ? 0 : kn_first, r1 = stage == 0 ? kn_first : kn;
    for (int i = r0 * 4 + tid; i < r1 * 4; i += kThreads) {
      const int r = i >> 2, c = (i & 3) * 16;
      const bool in = col_base + c + 16 <= a.pitch_c;
      const int8_t* src = in ? a.codes + (size_t)(k0 + r) * a.pitch_c + col_base + c : a.codes;
      // the tensor-core path reads 8-byte column runs of 4 rows at once: its
      // tile swaps the 16-byte chunks of rows with bit 1 set (no bank conflicts)
      wtt_cp_async16(ct + r * BC + (MMA ? (((c >> 4) ^ (r & 2)) << 4) : c), src, in ? 16 : 0);
    }
    if (stage == 1) {
      for (int i = tid; i < kEpRows * BC; i += kThreads) {
        const int t = i / BC, col = col_base + i % BC;
        if (a.res != nullptr && t < a.T && col < a.R)
          wtt_cp_async_ca<4>(ep + i, a.res + (size_t)t * a.R + col);
      }
      if (a.bias != nullptr && tid < BC && col_base + tid < a.R)
        wtt_cp_async_ca<4>(ep + kEpRows * BC + tid, a.bias + col_base + tid);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }

  // this thread's columns of the slice (ks <= 4 x 128) with their
  // layer-norm weights, loaded while the copies are in flight
  float lw[kPerThread], lb[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const int kk = tid + u * kThreads;
    lw[u] = ln && kk < kn ? a.ln_w[k0 + kk] : 0.f;
    lb[u] = ln && kk < kn ? a.ln_b[k0 + kk] : 0.f;
  }

  // 2. the CUDA-core route's lanes: 4 adjacent columns (cg) of the even or
  //    odd rows (h)
  const int cg = lane & 15, h = lane >> 4;

  for (int t0 = 0; t0 < a.T; t0 += TT) {
    const int tt = min(TT, a.T - t0);
    // 2a. the slice's activation rows, normalised and rounded
    float mean[TT], rstd[TT];
    // the group's rows in shared memory: the first group's copies are the
    // oldest of the three groups in flight
    if (t0 == 0) {
      asm volatile("cp.async.wait_group 2;\n" ::);
    } else {
      stage_x(t0, tt);
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    if (ln) {
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
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int kk = tid + u * kThreads;
      if (kk < kn) {
        float v[TT];
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          if (t >= tt) {
            v[t] = 0.f;
          } else if (ln) {
            v[t] = __fadd_rn(__fmul_rn(__fmul_rn(xraw[t * a.K + k0 + kk] - mean[t], rstd[t]),
                                       lw[u]), lb[u]);
          } else {
            v[t] = xraw[t * a.ks + kk];
          }
        }
        if constexpr (MMA) {
          // row t of the B operand, each 16-row step stored as the 4 x 4
          // transpose that the fragment layout below reads 8 bytes at a time
          const int r16 = kk & 15;
          __nv_bfloat16* dst = xb + (kk & ~15) + 4 * (r16 & 3) + (r16 >> 2);
#pragma unroll
          for (int t = 0; t < TT; ++t)
            dst[t * xbs] = __float2bfloat16_rn(t < tt ? v[t] : 0.f);
        } else {
          const int b = kk / qk, r = kk % qk;
          float* dst = xd + b * qk + (r & 1) * half + (r >> 1);
#pragma unroll
          for (int t = 0; t < TT; ++t)
            dst[t * a.ks] = t < tt ? (a.round_bf16 ? wtt_round_bf16(v[t]) : v[t]) : 0.f;
        }
      }
    }
    __syncthreads();
    if (affine) {
      for (int i = tid; i < TT * nbs; i += kThreads) {
        const int t = i / nbs, b = i % nbs;
        float s = 0.f;
        if constexpr (MMA) {
          const __nv_bfloat16* blk = xb + t * xbs + b * qk;
          for (int j = 0; j < qk; ++j) s += __bfloat162float(blk[j]);
        } else {
          const float* blk = xd + t * a.ks + b * qk;
          for (int j = 0; j < qk; ++j) s += blk[j];
        }
        xsum[t * nbs_max + b] = s;
      }
    }

    // 2b. the product: warp w takes qk-blocks w, w + 4, ...; on the first
    //     row group the first block starts when its copy group has landed.
    //     tot holds this lane's outputs: FMA path [row][4 adjacent columns],
    //     MMA path [16-column tile j][fragment element]
    float tot[MMA ? 4 : TT][4];
#pragma unroll
    for (int t = 0; t < (MMA ? 4 : TT); ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) tot[t][j] = 0.f;
    auto product_fma = [&](int b) {
      float acc[TT][4];
#pragma unroll
      for (int t = 0; t < TT; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[t][j] = 0.f;
      const int8_t* crow = ct + (b * qk + h) * BC + cg * 4;
      const float* xr = xd + b * qk + h * half;
      for (int i4 = 0; i4 < half; i4 += 4) {
        float4 xv[TT];
#pragma unroll
        for (int t = 0; t < TT; ++t) xv[t] = *reinterpret_cast<const float4*>(xr + t * a.ks + i4);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float c[4];
          codes4(*reinterpret_cast<const uint32_t*>(crow + (2 * (i4 + u)) * BC), c);
#pragma unroll
          for (int t = 0; t < TT; ++t) {
            const float xs = u == 0 ? xv[t].x : u == 1 ? xv[t].y : u == 2 ? xv[t].z : xv[t].w;
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[t][j] = fmaf(xs, c[j], acc[t][j]);
          }
        }
      }
      // even rows + odd rows: the block's f32 dot, then its scale
#pragma unroll
      for (int t = 0; t < TT; ++t)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[t][j] += __shfl_xor_sync(WTT_FULL_MASK, acc[t][j], 16);
      const float4 s4 = *reinterpret_cast<const float4*>(ss + b * BC + cg * 4);
      const float s[4] = {s4.x, s4.y, s4.z, s4.w};
      float m[4] = {0.f, 0.f, 0.f, 0.f};
      if (affine) {
        const float4 m4 = *reinterpret_cast<const float4*>(sm + b * BC + cg * 4);
        m[0] = m4.x; m[1] = m4.y; m[2] = m4.z; m[3] = m4.w;
      }
#pragma unroll
      for (int t = 0; t < TT; ++t) {
        const float xb_ = affine ? xsum[t * nbs_max + b] : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) tot[t][j] += acc[t][j] * s[j] + xb_ * m[j];
      }
    };
    // m16n8k16 fragments (g = lane / 4, q4 = lane % 4): A is 16 output
    // columns x 16 rows of codes, B is 16 rows x 8 activation rows.  Lane
    // (g, q4) holds, for column tile j, columns 8g + 2j and 8g + 2j + 1, and
    // the rows q4 + 4i (i < 4) of each 16-row step as its k-slots 2q4, 2q4 + 1,
    // 2q4 + 8, 2q4 + 9; the B rows are stored in the same order.  So one
    // 8-byte shared load per row feeds all four column tiles, and the
    // result element (e) is column 8g + 2j + (e >> 1), row 2q4 + (e & 1).
    auto product_mma = [&](int b) {
      const int g = lane >> 2, q4 = lane & 3;
      float acc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int k16 = b * qk; k16 < (b + 1) * qk; k16 += 16) {
        const uint2 xv = *reinterpret_cast<const uint2*>(xb + g * xbs + k16 + 4 * q4);
        const uint32_t bf[2] = {xv.x, xv.y};
        float c[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = k16 + q4 + 4 * i;
          const uint2 w = *reinterpret_cast<const uint2*>(
              ct + r * BC + ((((g >> 1) ^ (r & 2)) << 4) | ((g & 1) << 3)));
          codes4(w.x, c[i]);
          codes4(w.y, c[i] + 4);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t af[4] = {wtt_pack_bf16(c[0][2 * j], c[1][2 * j]),
                                  wtt_pack_bf16(c[0][2 * j + 1], c[1][2 * j + 1]),
                                  wtt_pack_bf16(c[2][2 * j], c[3][2 * j]),
                                  wtt_pack_bf16(c[2][2 * j + 1], c[3][2 * j + 1])};
          wtt_mma_bf16(acc[j], af, bf);
        }
      }
      // the block's f32 dots, then their scales
      const float4 s0 = *reinterpret_cast<const float4*>(ss + b * BC + 8 * g);
      const float4 s1 = *reinterpret_cast<const float4*>(ss + b * BC + 8 * g + 4);
      const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
      float m[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float xs0 = 0.f, xs1 = 0.f;
      if (affine) {
        const float4 m0 = *reinterpret_cast<const float4*>(sm + b * BC + 8 * g);
        const float4 m1 = *reinterpret_cast<const float4*>(sm + b * BC + 8 * g + 4);
        m[0] = m0.x; m[1] = m0.y; m[2] = m0.z; m[3] = m0.w;
        m[4] = m1.x; m[5] = m1.y; m[6] = m1.z; m[7] = m1.w;
        xs0 = xsum[(2 * q4) * nbs_max + b];
        xs1 = xsum[(2 * q4 + 1) * nbs_max + b];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        tot[j][0] += acc[j][0] * s[2 * j] + xs0 * m[2 * j];
        tot[j][1] += acc[j][1] * s[2 * j] + xs1 * m[2 * j];
        tot[j][2] += acc[j][2] * s[2 * j + 1] + xs0 * m[2 * j + 1];
        tot[j][3] += acc[j][3] * s[2 * j + 1] + xs1 * m[2 * j + 1];
      }
    };
    auto product = [&](int b) {
      if constexpr (MMA) product_mma(b); else product_fma(b);
    };
    int b = warp;
    if (t0 == 0) {
      asm volatile("cp.async.wait_group 1;\n" ::);
      __syncthreads();
      if (b < nbs) product(b);
      b += kWarps;
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    for (; b < nbs; b += kWarps) product(b);
    if constexpr (MMA) {
      const int g = lane >> 2, q4 = lane & 3;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[(warp * TT + 2 * q4 + (e & 1)) * BC + 8 * g + 2 * j + (e >> 1)] = tot[j][e];
    } else if (h == 0) {
#pragma unroll
      for (int t = 0; t < TT; ++t)
        *reinterpret_cast<float4*>(red + (warp * TT + t) * BC + cg * 4) =
            make_float4(tot[t][0], tot[t][1], tot[t][2], tot[t][3]);
    }
    __syncthreads();

    // 2c. the block's partial: warps summed in order
    for (int i = tid; i < tt * BC; i += kThreads) {
      const int t = i / BC, c = i % BC;
      float y = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) y += red[(w * TT + t) * BC + c];
      if (n_slices == 1) {
        const int col = col_base + c;
        if (col < a.R) a.out[(size_t)(t0 + t) * a.R + col] = epilogue(a, ep, y, t0 + t, c, col);
      } else {
        a.ws[(((size_t)tile * n_slices + slice) * a.T + t0 + t) * BC + c] = y;
      }
    }
    __syncthreads();  // xd, xraw and red are refilled by the next row group
  }
  if (n_slices == 1) return;

  // 3. split-K fix-up: the last block of the tile sums the slices in order.
  //    The barrier orders the block's partial before thread 0's release; the
  //    acquire side orders the last block's reads after every release.
  __shared__ int is_last;
  __syncthreads();
  if (tid == 0) is_last = atomic_add_acq_rel(a.counters + tile, 1) == n_slices - 1;
  __syncthreads();
  if (!is_last) return;
  // the partials of `rows` output rows at a time, every slice's rows being
  // contiguous in the workspace, are copied to shared memory (all of it
  // after the epilogue's operands, at least 64 x n_slices floats) with
  // 16-byte copies from L2; then each output is summed over the slices in
  // slice order
  float* fx = reinterpret_cast<float*>(body);
  const float* wt = a.ws + (size_t)tile * n_slices * a.T * BC;
  const int rows = max(1, a.body_floats / (n_slices * BC));
  for (int r0 = 0; r0 < a.T; r0 += rows) {
    const int nr = min(rows, a.T - r0), seg = nr * BC / 4;   // float4 per slice
    for (int i = tid; i < n_slices * seg; i += kThreads) {
      const int s = i / seg, j = i % seg;
      wtt_cp_async16(fx + (size_t)i * 4, wt + ((size_t)s * a.T + r0) * BC + (size_t)j * 4);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    for (int i = tid; i < nr * BC; i += kThreads) {
      const int col = col_base + i % BC;
      float y = 0.f;
      for (int s = 0; s < n_slices; ++s) y += fx[s * nr * BC + i];
      if (col < a.R)
        a.out[(size_t)r0 * a.R + (size_t)(i / BC) * a.R + col] =
            epilogue(a, ep, y, r0 + i / BC, i % BC, col);
    }
    __syncthreads();
  }
  if (tid == 0) a.counters[tile] = 0;
}

template <int TT, bool MMA>
cudaError_t launch(Args a, cudaStream_t stream) {
  const int nbs = a.ks / a.qk;
  const size_t floats = (size_t)nbs * BC * (a.mins != nullptr ? 2 : 1) + (size_t)TT * a.ks +
                        xsum_floats(TT, nbs) + (size_t)kWarps * TT * BC + 4 * kWarps * TT +
                        (size_t)(a.T < TT ? a.T : TT) * (a.ln_w != nullptr ? a.K : a.ks);
  const int n_slices = (a.K + a.ks - 1) / a.ks;
  size_t body = (size_t)a.ks * BC + sizeof(float) * floats;
  // the fix-up stages at least one output row of every slice
  if (body < sizeof(float) * n_slices * BC) body = sizeof(float) * n_slices * BC;
  const size_t smem = sizeof(float) * kEpFloats + body;
  a.body_floats = (int)(body / sizeof(float));
  static size_t smem_allowed = 0;  // one per instantiation
  cudaError_t err = wtt_allow_smem(qmmt_kernel<TT, MMA>, smem, &smem_allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.R + BC - 1) / BC, n_slices);
  qmmt_kernel<TT, MMA><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Pointers the caller does not use (mins, ln_w/ln_b, bias, res) are NULL;
// ws (tiles x slices x T x 64 f32) may be NULL when K <= ks (one slice).
// counters holds one int per 64-column tile, all 0 between launches.
// mma != 0 takes the tensor-core product: round_bf16 and qk % 16 == 0.
// Requirements (checked by the Python wrapper): T >= 1, qk in {8, 16, 32},
// K % qk == 0, ks % qk == 0, qk <= ks <= 512; x, res, out contiguous; code rows
// 16-byte aligned (pitch_c % 16 == 0), scale / min rows too (pitch_s % 4).
extern "C" int wtt_qmmt(const void* x, const void* codes, const void* scales,
                        const void* mins, const void* ln_w, const void* ln_b,
                        const void* bias, const void* res, void* out, void* ws,
                        void* counters, int T, int K, int R, int pitch_c, int pitch_s,
                        int qk, int ks, int round_bf16, int act_gelu, int mma, float eps,
                        void* stream) {
  Args a;
  a.x = static_cast<const float*>(x);
  a.codes = static_cast<const int8_t*>(codes);
  a.scales = static_cast<const float*>(scales);
  a.mins = static_cast<const float*>(mins);
  a.ln_w = static_cast<const float*>(ln_w);
  a.ln_b = static_cast<const float*>(ln_b);
  a.bias = static_cast<const float*>(bias);
  a.res = static_cast<const float*>(res);
  a.out = static_cast<float*>(out);
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.T = T; a.K = K; a.R = R; a.pitch_c = pitch_c; a.pitch_s = pitch_s;
  a.qk = qk; a.ks = ks; a.round_bf16 = round_bf16; a.act_gelu = act_gelu; a.eps = eps;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mma) {
    err = launch<8, true>(a, s);
  } else {
    switch (T < 8 ? T : 8) {
      case 1: err = launch<1, false>(a, s); break;
      case 2: err = launch<2, false>(a, s); break;
      case 3: err = launch<3, false>(a, s); break;
      case 4: err = launch<4, false>(a, s); break;
      case 5: err = launch<5, false>(a, s); break;
      case 6: err = launch<6, false>(a, s); break;
      case 7: err = launch<7, false>(a, s); break;
      default: err = launch<8, false>(a, s); break;
    }
  }
  return (int)err;
}
