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
// The FMA route (qmmt_kernel).  What bounds it on an H100: bytes.  At
// decode shapes T is a few rows, so the int8 code plane (1 B per weight)
// plus the f32 scale plane (1/8 B per weight) is nearly all the traffic:
// 178 MB per large-v3-turbo decode step, 74.7 MB of it in the logits head,
// about 53 us at 3.35 TB/s.  Reaching that needs megabytes of loads in
// flight across the card and code conversion that keeps pace with them.
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
//  * Inner product (the FMA route: f32 compute at every T, bf16 below
//    MMA_MIN_T rows): codes converted exactly with one byte-permute each
//    against the float 2^23 (2 instructions per code).  A warp owns whole
//    qk-blocks, so each qk-block is one f32 dot scaled after the dot.  A
//    lane takes 4 adjacent columns of the even or the odd rows (a 64-byte
//    tile row fills 16 banks: no conflicts) and does T FMAs per code; the
//    two half-warps meet with one shuffle.
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
//
// The many-row route (bf16 compute from MMA_MIN_T rows: batched steps,
// prompt passes, DTW passes; qmmt_rows_kernel) replaces the 8-row mma.sync
// groups that ran one after another and converted every code again for
// each group (T = 128 converted each code 16 times).  What bounds it:
// bytes up to about 256 rows (the code planes; a DTW pass's 24 products
// read ~103 MB), operations above (the T = 1024 logits head: 136 GFLOP,
// 0.137 ms at the bf16 peak).
//  * A row pass (qmmt_rows_prep_kernel, one block per row) computes the
//    layer-norm statistics once per row, from the same f64 sums, and writes
//    the rows normalised and rounded to bf16 (and each qk-block's sum of
//    them for affine formats): blocks stage no whole rows and reduce no
//    statistics, and the row count has no cap.  The product kernel is its
//    programmatic dependent: it issues its weight copies before it waits
//    for the row pass.
//  * Blocks of three warpgroups over (64-column tile, K-slice, row group).
//    One producer thread keeps a ring of up to 8 stages in flight with TMA:
//    a 64-deep chunk of the rows (bf16, K-major, 128-byte swizzle), the
//    chunk's int8 codes (row chunk 0 only), scales, mins, row block sums.
//    Three producer warps convert each chunk's codes once into bf16 (the
//    MN-major wgmma A operand, 128-byte swizzle) and publish the stage.  A
//    block that walks several row chunks keeps its slice's converted codes
//    for all of them, so the conversion does not grow with T; with one row
//    chunk, three converted chunks take turns.
//  * Two consumer warpgroups split each row chunk (N = 8, 16, 32 or 64 rows
//    a warpgroup) and run wgmma m64nNk16, M = the tile's 64 columns.  Each
//    qk-block's products start on fresh accumulators (scale-d off on its
//    first k-step) and are scaled after the dot; two accumulator sets
//    alternate, so block b + 1 multiplies while block b is scaled
//    (wgmma.wait_group 1).  The epilogue stays in f32.
//  * Split rule (ops/qmm.py rows_plan): K is split only as far as one wave
//    of blocks holds and the workspace stays within the call's code bytes
//    (the logits head is not split from 32 rows on); rows are grouped to
//    fill that wave, or into single row chunks where a slice's converted
//    codes do not fit beside the ring.  The fix-up is the FMA route's:
//    partials in fragment order, an acquire-release counter per (tile,
//    group), the last block summing the slices in order from shared memory,
//    bit-identical over calls and replays.
#include "tma.cuh"

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

// The FMA route; TT: activation rows per group
template <int TT>
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
      wtt_cp_async16(ct + r * BC + c, src, in ? 16 : 0);
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
        const int b = kk / qk, r = kk % qk;
        float* dst = xd + b * qk + (r & 1) * half + (r >> 1);
#pragma unroll
        for (int t = 0; t < TT; ++t)
          dst[t * a.ks] = t < tt ? (a.round_bf16 ? wtt_round_bf16(v[t]) : v[t]) : 0.f;
      }
    }
    __syncthreads();
    if (affine) {
      for (int i = tid; i < TT * nbs; i += kThreads) {
        const int t = i / nbs, b = i % nbs;
        float s = 0.f;
        const float* blk = xd + t * a.ks + b * qk;
        for (int j = 0; j < qk; ++j) s += blk[j];
        xsum[t * nbs_max + b] = s;
      }
    }

    // 2b. the product: warp w takes qk-blocks w, w + 4, ...; on the first
    //     row group the first block starts when its copy group has landed.
    //     tot holds this lane's outputs, [row][4 adjacent columns]
    float tot[TT][4];
#pragma unroll
    for (int t = 0; t < TT; ++t)
#pragma unroll
      for (int j = 0; j < 4; ++j) tot[t][j] = 0.f;
    auto product = [&](int b) {
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
    if (h == 0) {
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

template <int TT>
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
  cudaError_t err = wtt_allow_smem(qmmt_kernel<TT>, smem, &smem_allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.R + BC - 1) / BC, n_slices);
  qmmt_kernel<TT><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// The many-row route: bf16 compute, qk in {16, 32}, from MMA_MIN_T rows
// ---------------------------------------------------------------------------

constexpr int kConsumers = 256;       // two consumer warpgroups
constexpr int kRowThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kMaxStages = 8;
constexpr int kMaxASlots = 3;         // converted chunks taking turns (one row chunk)
constexpr int KC = 64;                // k rows of a chunk: one 128-byte swizzle row of bf16
constexpr int kChunkA = KC * BC * 2;  // bytes of a converted code chunk (8192)
// dynamic shared memory of one block, static room aside: all of an SM's
// at N = 64 (one block an SM by registers), half of it below (two)
__host__ __device__ constexpr int rows_smem_cap(int n) { return n >= 64 ? 231424 : 114688; }

struct RowsArgs {
  const __nv_bfloat16* xb;  // (T, K) activation rows, normalised and rounded by the row pass
  const float* xsum;        // (T, K / 16): sums of xb's qk-blocks, 4 slots a 64-row chunk
                            // (affine formats), else NULL
  const int8_t* codes;
  const float* scales;
  const float* mins;
  const float* bias;
  const float* res;
  float* out;
  float* ws;
  int* counters;
  int T, K, R, pitch_c, pitch_s, qk, ks, rows, act_gelu;
  int a_slots, stages, stage_bytes;  // set by launch_rows
};

// a ring stage: RC activation rows x 64 k (bf16, K-major, 128-byte
// swizzle), the chunk's raw codes (64 k x 64 columns), scales and mins (up
// to 4 qk-blocks x 64 columns) and the rows' qk-block sums (RC x 4)
__host__ __device__ constexpr int rows_stage_bytes(int rc, bool affine) {
  return (rc * 128 + 4096 + 1024 + (affine ? 1024 + rc * 16 : 0) + 1023) & ~1023;
}

// The row pass, one block per activation row: the layer norm's statistics
// from one pass of f64 sums of x and x^2 (as the FMA route's), the row
// normalised in f32 and rounded to bf16, 8 consecutive k a thread, and for
// affine formats each qk-block's sum of the rounded row (the 8-element sums
// of its 2 or 4 threads added pairwise by shuffles).
__global__ void __launch_bounds__(kThreads) qmmt_rows_prep_kernel(
    const float* __restrict__ x, const float* __restrict__ ln_w, const float* __restrict__ ln_b,
    __nv_bfloat16* __restrict__ xb, float* __restrict__ xsum, int K, int qk, float eps) {
  __shared__ double scratch[2 * kWarps];
  // the product kernel may start its weight copies now; it waits for this
  // grid to finish before it reads the rows.  This grid, launched as a
  // programmatic dependent itself, waits for the kernel before it (x).
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int t = blockIdx.x, tid = threadIdx.x;
  const float* xr = x + (size_t)t * K;
  const bool ln = ln_w != nullptr;
  float mean = 0.f, rstd = 0.f;
  if (ln) {
    double acc[2] = {0.0, 0.0};
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = tid; i < K / 4; i += kThreads) {
      const float4 v = x4[i];
      const double x0 = v.x, x1 = v.y, x2 = v.z, x3 = v.w;
      acc[0] += (x0 + x1) + (x2 + x3);
      acc[1] += (x0 * x0 + x1 * x1) + (x2 * x2 + x3 * x3);
    }
    block_sums<2>(acc, scratch);
    const double m = acc[0] / K;
    mean = (float)m;
    rstd = (float)(1.0 / sqrt(acc[1] / K - m * m + (double)eps));
  }
  for (int i0 = 0; i0 < K / 8; i0 += kThreads) {
    const int k = (i0 + tid) * 8;
    const bool in = k < K;
    float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (in) {
      const float4 v0 = *reinterpret_cast<const float4*>(xr + k);
      const float4 v1 = *reinterpret_cast<const float4*>(xr + k + 4);
      v[0] = v0.x; v[1] = v0.y; v[2] = v0.z; v[3] = v0.w;
      v[4] = v1.x; v[5] = v1.y; v[6] = v1.z; v[7] = v1.w;
      if (ln) {
        const float4 w0 = *reinterpret_cast<const float4*>(ln_w + k);
        const float4 w1 = *reinterpret_cast<const float4*>(ln_w + k + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(ln_b + k);
        const float4 b1 = *reinterpret_cast<const float4*>(ln_b + k + 4);
        const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
        const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __fadd_rn(__fmul_rn(__fmul_rn(v[e] - mean, rstd), w[e]), bb[e]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = wtt_round_bf16(v[e]);
      *reinterpret_cast<uint4*>(xb + (size_t)t * K + k) =
          make_uint4(wtt_pack_bf16(v[0], v[1]), wtt_pack_bf16(v[2], v[3]),
                     wtt_pack_bf16(v[4], v[5]), wtt_pack_bf16(v[6], v[7]));
    }
    if (xsum != nullptr) {
      float sum = ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
      sum += __shfl_xor_sync(WTT_FULL_MASK, sum, 1);
      if (qk == 32) sum += __shfl_xor_sync(WTT_FULL_MASK, sum, 2);
      if (in && (tid & (qk / 8 - 1)) == 0)
        xsum[(size_t)t * (K / 16) + (k / KC) * 4 + (k % KC) / qk] = sum;
    }
  }
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ float rows_epilogue(const RowsArgs& a, float y, int t, int col) {
  if (a.bias != nullptr) y += __ldg(a.bias + col);
  if (a.act_gelu) y = gelu_tanh(y);
  if (a.res != nullptr) y += __ldg(a.res + (size_t)t * a.R + col);
  return y;
}

// Block (tile, slice, group): 64 output columns x the slice's ks rows of K x
// the group's rows of T, walked as iterations it = (row chunk, 64-row
// k-chunk).  Warpgroup 2 is the producer: its first thread keeps a ring of
// stages in flight with TMA (the rows, the chunk's raw codes in row chunk
// 0, scales, mins, row block sums; a `loaded` barrier counts the bytes),
// its other three warps convert each chunk's codes into the A slot once
// they have landed and publish the stage on its `full` barrier.
// Warpgroups 0 and 1, the consumers, take rows [wN, wN + N) of each
// RC-row chunk, multiply, scale and release the stage on its `empty`
// barrier.  Consumer thread t holds v[4j + e] for output column
// 16 (t / 32) + (t % 32) / 4 + 8 (e >> 1) and chunk row
// wN + 8j + 2 (t % 4) + (e & 1).  No product or accumulator access sits on
// a divergent path (qk is a template parameter, the qk-blocks of a chunk
// are unrolled, a warpgroup without real rows multiplies zero rows):
// ptxas serializes the wgmma pipeline otherwise (C7518).
template <int N, int QK>
__global__ void __launch_bounds__(kRowThreads, N >= 64 ? 1 : 2)
qmmt_rows_kernel(const __grid_constant__ CUtensorMap x_map,
                 const __grid_constant__ CUtensorMap c_map,
                 const __grid_constant__ CUtensorMap s_map,
                 const __grid_constant__ CUtensorMap m_map,
                 const __grid_constant__ CUtensorMap xs_map, const RowsArgs a) {
  constexpr int RC = 2 * N;     // rows of a row chunk
  constexpr int NA = N / 2;     // accumulator floats a consumer thread
  constexpr int NB = KC / QK;   // qk-blocks of a chunk
  constexpr int OFF_RAW = RC * 128, OFF_SC = OFF_RAW + 4096, OFF_MN = OFF_SC + 1024,
                OFF_XS = OFF_MN + 1024;
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t loaded[kMaxStages], full[kMaxStages], empty[kMaxStages],
      a_empty[kMaxASlots];
  __shared__ int is_last;
  // [converted code chunks | ring of stages], 1024-byte aligned for the swizzle
  uint8_t* sA = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = sA + a.a_slots * kChunkA;

  const int tile = blockIdx.x, slice = blockIdx.y, group = blockIdx.z;
  const int n_slices = gridDim.y;
  const int unit = tile * gridDim.z + group;  // its arrival counter and workspace
  const int k0 = slice * a.ks, kn = min(a.ks, a.K - k0);
  const int n_kc = kn / KC;
  const int t0 = group * a.rows, tn = min(a.rows, a.T - t0);
  const int n_rc = (tn + RC - 1) / RC;
  const int n_rc_ws = (min(a.rows, a.T) + RC - 1) / RC;  // row chunks of a group's workspace
  const int total = n_rc * n_kc;
  const int S = a.stages;
  const bool affine = a.mins != nullptr;
  const int col_base = tile * BC;
  const int tid = threadIdx.x, wg = tid >> 7, lt = tid & 127;

  if (tid == 256) {
    // the tensor maps' descriptors fetched while the barriers are set up
    tma_prefetch(&x_map);
    tma_prefetch(&c_map);
    tma_prefetch(&s_map);
    tma_prefetch(&m_map);
    tma_prefetch(&xs_map);
  }
  // the barriers, a thread a stage
  if (tid < S) {
    mbar_init(&loaded[tid], 1);
    mbar_init(&full[tid], 96);
    mbar_init(&empty[tid], kConsumers / 32);
  } else if (tid >= 32 && tid < 32 + kMaxASlots) {
    mbar_init(&a_empty[tid - 32], kConsumers / 32);
  }
  if (tid < 32 + kMaxASlots) asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncthreads();

  if (wg == 2) {
    // ---- the producer ----
    if (lt == 0) {
      // stage `it`'s copies: the weights (raw codes in row chunk 0 only;
      // scales, mins), then the rows and their block sums
      auto issue_weights = [&](int it, uint8_t* st) {
        const int kk0 = k0 + (it % n_kc) * KC;
        mbar_expect_tx(&loaded[it % S], RC * 128 + (it < n_kc ? 4096 : 0) +
                                            NB * 256 * (affine ? 2 : 1) + (affine ? RC * 16 : 0));
        if (it < n_kc) tma_load_2d(st + OFF_RAW, &c_map, &loaded[it % S], col_base, kk0);
        tma_load_2d(st + OFF_SC, &s_map, &loaded[it % S], col_base, kk0 / QK);
        if (affine) tma_load_2d(st + OFF_MN, &m_map, &loaded[it % S], col_base, kk0 / QK);
      };
      auto issue_rows = [&](int it, uint8_t* st) {
        const int r0 = t0 + (it / n_kc) * RC, kk0 = k0 + (it % n_kc) * KC;
        tma_load_2d(st, &x_map, &loaded[it % S], kk0, r0);
        if (affine) tma_load_2d(st + OFF_XS, &xs_map, &loaded[it % S], (kk0 / KC) * 4, r0);
      };
      // the weights of the first stages do not depend on the row pass:
      // issued before waiting for it
      const int first = min(S, total);
      for (int it = 0; it < first; ++it) issue_weights(it, ring + it * a.stage_bytes);
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int it = 0; it < first; ++it) issue_rows(it, ring + it * a.stage_bytes);
      for (int it = S; it < total; ++it) {
        uint8_t* st = ring + (it % S) * a.stage_bytes;
        mbar_wait(&empty[it % S], ((it / S) - 1) & 1);
        issue_weights(it, st);
        issue_rows(it, st);
      }
    } else if (lt >= 32) {
      // each chunk's codes, once landed, converted once (two byte permutes
      // and f32 subtracts per pair; the upper halves of the exact f32 codes
      // are their bf16) into the MN-major A operand: k row r holds the
      // tile's 64 columns in 128 bytes, 16-byte pieces swizzled by r % 8 (a
      // quarter-warp's stores fill all 32 banks once); then published
      const int ct = lt - 32;
      for (int p = 0; p < total; ++p) {
        uint8_t* st = ring + (p % S) * a.stage_bytes;
        mbar_wait(&loaded[p % S], (p / S) & 1);
        if (p < n_kc) {
          // a slot taken in turn: free once its chunk's products have retired
          if (p >= a.a_slots) mbar_wait(&a_empty[p % a.a_slots], ((p / a.a_slots) - 1) & 1);
          uint8_t* dst = sA + (p % a.a_slots) * kChunkA;
#pragma unroll
          for (int u = ct; u < KC * 4; u += 96) {
            const int r = u >> 2, q = u & 3;
            const uint4 w = *reinterpret_cast<const uint4*>(st + OFF_RAW + r * 64 + q * 16);
            const uint32_t wv[4] = {w.x, w.y, w.z, w.w};
            uint32_t c2[8];
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              float c[4];
              codes4(wv[v], c);
              c2[2 * v] = __byte_perm(__float_as_uint(c[0]), __float_as_uint(c[1]), 0x7632);
              c2[2 * v + 1] = __byte_perm(__float_as_uint(c[2]), __float_as_uint(c[3]), 0x7632);
            }
            *reinterpret_cast<uint4*>(dst + r * 128 + (((2 * q) ^ (r & 7)) << 4)) =
                make_uint4(c2[0], c2[1], c2[2], c2[3]);
            *reinterpret_cast<uint4*>(dst + r * 128 + (((2 * q + 1) ^ (r & 7)) << 4)) =
                make_uint4(c2[4], c2[5], c2[6], c2[7]);
          }
          fence_proxy_async();
        }
        mbar_arrive(&full[p % S]);
      }
    }
  } else {
    // ---- the consumers ----
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    const int warp = lt >> 5, g = (tid & 31) >> 2, tg = tid & 3;
    float tot[NA], acc0[NA], acc1[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) acc0[i] = acc1[i] = 0.f;
    // one qk-block's dot: wgmma m64nNk16, A the converted codes (a k-step
    // is 16 rows, 2048 bytes), B the rows (a k-step is 32 bytes along their
    // 128-byte rows), fresh accumulators
    auto product = [&](float* acc, uint32_t a0, uint32_t b0, int bl) {
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < QK / 16; ++s)
        wgmma_m64k16_ss_ta<N>(acc, desc_sw128_mn(a0 + bl * QK * 128 + s * 2048, kChunkA),
                              desc_sw128(b0 + bl * QK * 2 + s * 32), s);
      wgmma_commit();
    };
    // the dot scaled by its block's scale, plus sum(x_blk) * min for affine
    // formats, into the running totals
    auto scale = [&](const float* acc, const uint8_t* st, int bl) {
      const float* sc = reinterpret_cast<const float*>(st + OFF_SC) + bl * BC + 16 * warp + g;
      const float s0 = sc[0], s1 = sc[8];
      if (affine) {
        const float* mn = reinterpret_cast<const float*>(st + OFF_MN) + bl * BC + 16 * warp + g;
        const float m0 = mn[0], m1 = mn[8];
        const float* xs = reinterpret_cast<const float*>(st + OFF_XS) + (wg * N + 2 * tg) * 4 + bl;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const float x0 = xs[32 * j], x1 = xs[32 * j + 4];
          tot[4 * j] += acc[4 * j] * s0 + x0 * m0;
          tot[4 * j + 1] += acc[4 * j + 1] * s0 + x1 * m0;
          tot[4 * j + 2] += acc[4 * j + 2] * s1 + x0 * m1;
          tot[4 * j + 3] += acc[4 * j + 3] * s1 + x1 * m1;
        }
      } else {
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          tot[4 * j] += acc[4 * j] * s0;
          tot[4 * j + 1] += acc[4 * j + 1] * s0;
          tot[4 * j + 2] += acc[4 * j + 2] * s1;
          tot[4 * j + 3] += acc[4 * j + 3] * s1;
        }
      }
    };
    auto write_out = [&](const float* v, int rc) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int tl = rc * RC + wg * N + 8 * (i >> 2) + 2 * tg + (i & 1);
        const int col = col_base + 16 * warp + g + 8 * ((i >> 1) & 1);
        if (tl < tn && col < a.R)
          a.out[(size_t)(t0 + tl) * a.R + col] = rows_epilogue(a, v[i], t0 + tl, col);
      }
    };
    int rc = 0, j = 0;
    for (int it = 0; it < total; ++it) {
      if (j == 0) {
#pragma unroll
        for (int i = 0; i < NA; ++i) tot[i] = 0.f;
      }
      const uint8_t* st = ring + (it % S) * a.stage_bytes;
      mbar_wait(&full[it % S], (it / S) & 1);
      const uint32_t a0 = smem_addr(sA + (j % a.a_slots) * kChunkA);
      const uint32_t b0 = smem_addr(st) + wg * N * 128;
      product(acc0, a0, b0, 0);
      product(acc1, a0, b0, 1);
#pragma unroll
      for (int bl = 0; bl < NB; ++bl) {
        if (bl + 1 < NB) wgmma_wait<1>(); else wgmma_wait<0>();
        float* acc = bl & 1 ? acc1 : acc0;
        fence_acc<NA>(acc);
        scale(acc, st, bl);
        if (bl + 2 < NB) product(acc, a0, b0, bl + 2);
      }
      // the stage (and a converted chunk taken in turn) is consumed: one
      // arrival a warp
      __syncwarp();
      if ((tid & 31) == 0) {
        mbar_arrive(&empty[it % S]);
        if (a.a_slots < n_kc) mbar_arrive(&a_empty[j % a.a_slots]);
      }
      if (j == n_kc - 1) {
        if (n_slices == 1) {
          write_out(tot, rc);
        } else {
          float* w = a.ws + ((((size_t)unit * n_slices + slice) * n_rc_ws + rc) * 2 + wg) * (NA * 128) + lt;
#pragma unroll
          for (int i = 0; i < NA; ++i) __stcg(w + i * 128, tot[i]);
        }
      }
      if (++j == n_kc) {
        j = 0;
        ++rc;
      }
    }
    if (n_slices > 1) {
      // split-K fix-up, as the FMA route's: the block's partials before
      // thread 0's release (the barrier below); the last block of the
      // (tile, group) sums each row chunk's partials in slice order
      named_barrier_sync(2, kConsumers);
      if (tid == 0) is_last = atomic_add_acq_rel(a.counters + unit, 1) == n_slices - 1;
      named_barrier_sync(2, kConsumers);
      if (!is_last) return;
      // every slice's partial of a row chunk copied from L2 into shared
      // memory at once (as many slices as the ring and slots hold), then
      // summed in slice order
      float* fx = reinterpret_cast<float*>(sA);
      constexpr int per = RC * BC;  // floats of one slice's row chunk
      const int nsb = max(1, (a.a_slots * kChunkA + S * a.stage_bytes) / (per * 4));
      for (int r = 0; r < n_rc; ++r) {
        float y[NA];
#pragma unroll
        for (int i = 0; i < NA; ++i) y[i] = 0.f;
        for (int s0 = 0; s0 < n_slices; s0 += nsb) {
          const int ns = min(nsb, n_slices - s0);
          for (int i = tid; i < ns * (per / 4); i += kConsumers) {
            const int sl = i / (per / 4), o = i - sl * (per / 4);
            wtt_cp_async16(fx + (size_t)i * 4,
                           a.ws + (((size_t)unit * n_slices + s0 + sl) * n_rc_ws + r) * per + o * 4);
          }
          asm volatile("cp.async.commit_group;\n" ::);
          asm volatile("cp.async.wait_group 0;\n" ::);
          named_barrier_sync(2, kConsumers);
          for (int sl = 0; sl < ns; ++sl) {
#pragma unroll
            for (int i = 0; i < NA; ++i) y[i] += fx[sl * per + wg * (NA * 128) + i * 128 + lt];
          }
          named_barrier_sync(2, kConsumers);
        }
        write_out(y, r);
      }
      named_barrier_sync(2, kConsumers);
      if (tid == 0) a.counters[unit] = 0;
    }
  }
}

// a launch that may start before the kernel ahead of it in the stream ends
// (programmatic dependent launch); the kernel waits for it with
// griddepcontrol.wait before it reads what that kernel wrote
template <typename... Params, typename... Args>
cudaError_t launch_pdl(void (*kernel)(Params...), dim3 grid, int threads, size_t smem,
                       cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int N, int QK>
cudaError_t launch_rows(RowsArgs a, int groups, cudaStream_t stream) {
  constexpr int RC = 2 * N;
  const int rows = a.rows < a.T ? a.rows : a.T;
  const int chunks = (rows + RC - 1) / RC;
  const int n_kc = a.ks / KC;
  // the converted codes stay for every row chunk of a group; with one row
  // chunk up to three take turns
  a.a_slots = chunks > 1 || n_kc <= kMaxASlots ? n_kc : kMaxASlots;
  a.stage_bytes = rows_stage_bytes(RC, a.mins != nullptr);
  const int fit = (rows_smem_cap(N) - 1024 - a.a_slots * kChunkA) / a.stage_bytes;
  a.stages = fit < kMaxStages ? fit : kMaxStages;
  if (a.stages < 2) return cudaErrorInvalidValue;
  const size_t smem = 1024 + (size_t)a.a_slots * kChunkA + (size_t)a.stages * a.stage_bytes;
  static size_t smem_allowed = 0;  // one per instantiation
  cudaError_t err = wtt_allow_smem(qmmt_rows_kernel<N, QK>, smem, &smem_allowed);
  if (err != cudaSuccess) return err;
  // tensor maps: the rows (128-byte swizzle, rows past T read as zeros),
  // the code plane, scale and min planes (rows pitched), the block sums
  CUtensorMap x_map, c_map, s_map, m_map, xs_map;
  if (!make_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a.xb, a.T, a.K, RC, KC,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&c_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, a.codes, a.K, a.pitch_c, KC, BC,
                CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&s_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.scales, a.K / QK, a.pitch_s,
                KC / QK, BC, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  m_map = xs_map = s_map;  // read only for affine formats
  if (a.mins != nullptr &&
      (!make_map(&m_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.mins, a.K / QK, a.pitch_s,
                 KC / QK, BC, CU_TENSOR_MAP_SWIZZLE_NONE) ||
       !make_map(&xs_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.xsum, a.T, a.K / 16, RC, 4,
                 CU_TENSOR_MAP_SWIZZLE_NONE)))
    return cudaErrorInvalidValue;
  // a programmatic dependent of the row pass: its weight copies overlap
  // that pass
  return launch_pdl(qmmt_rows_kernel<N, QK>,
                    dim3((a.R + BC - 1) / BC, (a.K + a.ks - 1) / a.ks, groups), kRowThreads,
                    smem, stream, x_map, c_map, s_map, m_map, xs_map, a);
}

}  // namespace

// The FMA route.  Pointers the caller does not use (mins, ln_w/ln_b, bias,
// res) are NULL; ws (tiles x slices x T x 64 f32) may be NULL when K <= ks
// (one slice).  counters holds one int per 64-column tile, all 0 between
// launches.  Requirements (checked by the Python wrapper): T >= 1, qk in
// {8, 16, 32}, K % qk == 0, ks % qk == 0, qk <= ks <= 512; x, res, out
// contiguous; code rows 16-byte aligned (pitch_c % 16 == 0), scale / min rows
// too (pitch_s % 4).
extern "C" int wtt_qmmt(const void* x, const void* codes, const void* scales,
                        const void* mins, const void* ln_w, const void* ln_b,
                        const void* bias, const void* res, void* out, void* ws,
                        void* counters, int T, int K, int R, int pitch_c, int pitch_s,
                        int qk, int ks, int round_bf16, int act_gelu, float eps,
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
  switch (T < 8 ? T : 8) {
    case 1: err = launch<1>(a, s); break;
    case 2: err = launch<2>(a, s); break;
    case 3: err = launch<3>(a, s); break;
    case 4: err = launch<4>(a, s); break;
    case 5: err = launch<5>(a, s); break;
    case 6: err = launch<6>(a, s); break;
    case 7: err = launch<7>(a, s); break;
    default: err = launch<8>(a, s); break;
  }
  return (int)err;
}

// The many-row route: the row pass into xb (T x K bf16) and, for affine
// formats, xsum (T x K/qk f32), then the product kernel on a grid of
// (64-column tiles, ceil(K / ks) slices, ceil(T / rows) groups) with n rows
// a warpgroup (8, 16, 32 or 64; a row chunk is 2n rows).  ws holds
// tiles x groups x slices x ceil(min(rows, T) / 2n) x 2n x 64 f32 (NULL for
// one slice); counters one int per (tile, group), all 0 between launches.
// Requirements (checked by the Python wrapper, ops/qmm.py rows_plan): bf16
// compute, qk in {16, 32}, K % 64 == 0, ks % 64 == 0, x, res, out
// contiguous and 16-byte aligned, code rows 16-byte aligned.
extern "C" int wtt_qmmt_rows(const void* x, const void* codes, const void* scales,
                             const void* mins, const void* ln_w, const void* ln_b,
                             const void* bias, const void* res, void* out, void* ws,
                             void* counters, void* xb, void* xsum, int T, int K, int R,
                             int pitch_c, int pitch_s, int qk, int ks, int rows, int n,
                             int act_gelu, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = launch_pdl(
      qmmt_rows_prep_kernel, dim3(T), kThreads, 0, s, static_cast<const float*>(x),
      static_cast<const float*>(ln_w), static_cast<const float*>(ln_b),
      static_cast<__nv_bfloat16*>(xb), mins != nullptr ? static_cast<float*>(xsum) : nullptr,
      K, qk, eps);
  if (err != cudaSuccess) return (int)err;
  RowsArgs a;
  a.xb = static_cast<const __nv_bfloat16*>(xb);
  a.xsum = static_cast<const float*>(xsum);
  a.codes = static_cast<const int8_t*>(codes);
  a.scales = static_cast<const float*>(scales);
  a.mins = static_cast<const float*>(mins);
  a.bias = static_cast<const float*>(bias);
  a.res = static_cast<const float*>(res);
  a.out = static_cast<float*>(out);
  a.ws = static_cast<float*>(ws);
  a.counters = static_cast<int*>(counters);
  a.T = T; a.K = K; a.R = R; a.pitch_c = pitch_c; a.pitch_s = pitch_s;
  a.qk = qk; a.ks = ks; a.rows = rows; a.act_gelu = act_gelu;
  const int groups = (T + rows - 1) / rows;
  switch (n * (qk == 32 ? 1 : -1)) {
    case 8: err = launch_rows<8, 32>(a, groups, s); break;
    case 16: err = launch_rows<16, 32>(a, groups, s); break;
    case 32: err = launch_rows<32, 32>(a, groups, s); break;
    case 64: err = launch_rows<64, 32>(a, groups, s); break;
    case -8: err = launch_rows<8, 16>(a, groups, s); break;
    case -16: err = launch_rows<16, 16>(a, groups, s); break;
    case -32: err = launch_rows<32, 16>(a, groups, s); break;
    case -64: err = launch_rows<64, 16>(a, groups, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
