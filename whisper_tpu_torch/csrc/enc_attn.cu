// Encoder self-attention read straight from the fused QKV projection:
// exact two-pass softmax on the tensor cores.
//
// Replaces the TPU kernel whisper_tpu/ops/enc_attn.py self_attention_qkv
// (_kernel): non-causal attention of every head over the (T, 3S) buffer
// [q | k | v], written back as the merged (T, S) output in bf16.
//
//   q' = bf16(bf16(q) * bf16(1/sqrt(d)))            (q pre-scaled in bf16)
//   s  = q' bf16(k)^T (f32), key columns j >= true_len get -1e30
//   m  = max_j s over all columns (exact, not a running max)
//   pb = bf16(exp(s - m)),  l = sum_j pb (f32)
//   out = bf16((pb @ bf16(v)) / l)
//
// Junk rows past true_len stay unmasked (they attend to the real columns and
// give finite junk that the encoder slices away), so no row is ever fully
// masked.  Masked columns give exp(-1e30 - m) = 0 exactly, so key tiles
// wholly past true_len are skipped: they add exact zeros.
//
// What bounds it on an H100: operations.  At T = 1536, true_len = 1500,
// 20 heads of 64 the two products are 4 * T * true_len * S = 11.8 GFLOP per
// layer (0.012 ms at the bf16 peak) against 31 MB of f32 q/k/v.
//
// Design: an online softmax would round p against a running max and change
// the result, so the keys are walked twice.  One block of 8 warps per (128
// query rows, head); each warp keeps its 16 rows of bf16 q' fragments in
// registers.  (Blocks of 64 rows and 4 warps read every key tile twice as
// often and are slower on an H100; utils/kernel_variants.py times both.)  Pass 1: for every key tile, S = q' K^T on mma.sync m16n8k16,
// the mask added, and the running row max kept (a quad shuffle at the end).
// Pass 2: S recomputed by the same code on the same tile, pb against the
// final max (expf, as the plain version's exp), l += pb, and acc += pb V
// with pb repacked from the S accumulators as the A operand and V read
// with ldmatrix.trans.  q, k and v are read at lane offsets h*d, S + h*d and
// 2S + h*d of the fused buffer, in f32 (the encoder's projection) or bf16,
// and rounded to bf16 on load: no transposes and no cast pass.  Key and
// value tiles go to shared memory double-buffered: the next tile's global
// loads are in flight in registers while the current tile's products run,
// with one block barrier per tile.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 128;  // query rows per block (16 per warp)

template <typename TIn> struct Vec;
template <> struct Vec<float> {
  using T = float4;
  static constexpr int N = 4;
};
template <> struct Vec<__nv_bfloat16> {
  using T = uint4;
  static constexpr int N = 8;
};

__device__ __forceinline__ void load2(const float* p, float* f) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  f[0] = v.x; f[1] = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float* f) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  f[0] = __low2float(v); f[1] = __high2float(v);
}

__device__ __forceinline__ void store_bf16(__nv_bfloat16* dst, const float4& v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(wtt_pack_bf16(v.x, v.y), wtt_pack_bf16(v.z, v.w));
}
__device__ __forceinline__ void store_bf16(__nv_bfloat16* dst, const uint4& v) {
  *reinterpret_cast<uint4*>(dst) = v;
}

// One key (or value) tile of BKV rows x D, held in registers between its
// global load and its bf16 store to shared memory.  Rows past T read zeros.
template <int D, int BKV, typename TIn>
struct TileRegs {
  using V = typename Vec<TIn>::T;
  static constexpr int EPC = Vec<TIn>::N;          // elements per chunk
  static constexpr int CPR = D / EPC;              // chunks per row
  static constexpr int N = BKV * CPR / kThreads;   // chunks per thread
  V v[N];

  __device__ __forceinline__ void load(const TIn* col0, size_t ld, int kv0, int T) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int key = kv0 + c / CPR, d = (c % CPR) * EPC;
      if (key < T) v[i] = *reinterpret_cast<const V*>(col0 + (size_t)key * ld + d);
      else v[i] = V{};
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16 (*tile)[D + 8]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = threadIdx.x + i * kThreads;
      store_bf16(&tile[c / CPR][(c % CPR) * EPC], v[i]);
    }
  }
};

// s = q' K^T for one warp's 16 rows against a key tile, plus the mask.
// Both passes call this, so pass 2 sees the very scores pass 1 maxed over.
template <int D, int BKV>
__device__ __forceinline__ void tile_scores(float (&s)[BKV / 8][4], const uint32_t (&qf)[D / 16][4],
                                            const __nv_bfloat16 (*Kt)[D + 8], int kv0,
                                            int true_len) {
  constexpr int NS = BKV / 8;
  const int lane = threadIdx.x & 31, tg = lane & 3;
  const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int j = 0; j < NS; j += 2) {
      uint32_t b[4];
      wtt_ldsm_x4(b, &Kt[(j + (mi >> 1)) * 8 + rr][kk * 16 + (mi & 1) * 8]);
      wtt_mma_bf16(s[j], qf[kk], b);
      wtt_mma_bf16(s[j + 1], qf[kk], b + 2);
    }
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (kv0 + j * 8 + tg * 2 + (e & 1) >= true_len) s[j][e] += -1e30f;
}

template <int D, typename TIn>
__global__ void __launch_bounds__(kThreads)
enc_attn_kernel(const TIn* __restrict__ qkv, __nv_bfloat16* __restrict__ out, int T, int S,
                int true_len, float q_scale) {
  constexpr int BKV = 4096 / D;  // key rows per tile: 64 at d = 64
  constexpr int KS = D / 16;     // k-steps of q k^T
  constexpr int NS = BKV / 8;    // n-tiles of S
  constexpr int ND = D / 8;      // n-tiles of the output
  __shared__ __align__(16) __nv_bfloat16 Ks[2][BKV][D + 8];
  __shared__ __align__(16) __nv_bfloat16 Vs[2][BKV][D + 8];

  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = blockIdx.x * BQ + warp * 16 + g, r1 = r0 + 8;
  const size_t ld = 3 * (size_t)S;
  const TIn* kcol = qkv + S + h * D;
  const TIn* vcol = qkv + 2 * (size_t)S + h * D;
  const int n_tiles = (true_len + BKV - 1) / BKV;  // later tiles add exact zeros

  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int d0 = h * D + kk * 16 + tg * 2;
    float a[2] = {0.f, 0.f}, b[2] = {0.f, 0.f}, c[2] = {0.f, 0.f}, e[2] = {0.f, 0.f};
    if (r0 < T) { load2(qkv + r0 * ld + d0, a); load2(qkv + r0 * ld + d0 + 8, c); }
    if (r1 < T) { load2(qkv + r1 * ld + d0, b); load2(qkv + r1 * ld + d0 + 8, e); }
    auto qs = [&](float v) { return wtt_round_bf16(wtt_round_bf16(v) * q_scale); };
    qf[kk][0] = wtt_pack_bf16(qs(a[0]), qs(a[1]));
    qf[kk][1] = wtt_pack_bf16(qs(b[0]), qs(b[1]));
    qf[kk][2] = wtt_pack_bf16(qs(c[0]), qs(c[1]));
    qf[kk][3] = wtt_pack_bf16(qs(e[0]), qs(e[1]));
  }

  TileRegs<D, BKV, TIn> kr, vr;
  float s[NS][4];

  // pass 1: the exact row max over every key column
  float m0 = -INFINITY, m1 = -INFINITY;
  kr.load(kcol, ld, 0, T);
  kr.store(Ks[0]);
  __syncthreads();
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) kr.load(kcol, ld, (i + 1) * BKV, T);
    tile_scores<D, BKV>(s, qf, Ks[i & 1], i * BKV, true_len);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
      m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
    }
    if (i + 1 < n_tiles) kr.store(Ks[(i + 1) & 1]);
    __syncthreads();
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(WTT_FULL_MASK, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(WTT_FULL_MASK, m1, off));
  }

  // pass 2: pb against the final max, its f32 sum and pb @ v
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  const int mi = lane >> 3, rr = lane & 7;
  kr.load(kcol, ld, 0, T);
  vr.load(vcol, ld, 0, T);
  kr.store(Ks[0]);
  vr.store(Vs[0]);
  __syncthreads();
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      kr.load(kcol, ld, (i + 1) * BKV, T);
      vr.load(vcol, ld, (i + 1) * BKV, T);
    }
    tile_scores<D, BKV>(s, qf, Ks[i & 1], i * BKV, true_len);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = wtt_round_bf16(expf(s[j][0] - m0));
      s[j][1] = wtt_round_bf16(expf(s[j][1] - m0));
      s[j][2] = wtt_round_bf16(expf(s[j][2] - m1));
      s[j][3] = wtt_round_bf16(expf(s[j][3] - m1));
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    const __nv_bfloat16 (*Vt)[D + 8] = Vs[i & 1];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = wtt_pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = wtt_pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = wtt_pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = wtt_pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < ND; j += 2) {
        uint32_t b[4];
        wtt_ldsm_x4_trans(b, &Vt[kk * 16 + (mi & 1) * 8 + rr][(j + (mi >> 1)) * 8]);
        wtt_mma_bf16(acc[j], a, b);
        wtt_mma_bf16(acc[j + 1], a, b + 2);
      }
    }
    if (i + 1 < n_tiles) {
      kr.store(Ks[(i + 1) & 1]);
      vr.store(Vs[(i + 1) & 1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(WTT_FULL_MASK, l0, off);
    l1 += __shfl_xor_sync(WTT_FULL_MASK, l1, off);
  }

#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int d = h * D + j * 8 + tg * 2;
    if (r0 < T)
      *reinterpret_cast<uint32_t*>(out + (size_t)r0 * S + d) =
          wtt_pack_bf16(acc[j][0] / l0, acc[j][1] / l0);
    if (r1 < T)
      *reinterpret_cast<uint32_t*>(out + (size_t)r1 * S + d) =
          wtt_pack_bf16(acc[j][2] / l1, acc[j][3] / l1);
  }
}

template <int D, typename TIn>
cudaError_t launch(const void* qkv, void* out, int T, int S, int true_len, cudaStream_t stream) {
  // q is pre-scaled by the bf16 value of 1/sqrt(d), as on the TPU
  const float q_scale = __bfloat162float(__float2bfloat16_rn(1.0f / sqrtf((float)D)));
  dim3 grid((T + BQ - 1) / BQ, S / D);
  enc_attn_kernel<D, TIn><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(qkv), static_cast<__nv_bfloat16*>(out), T, S, true_len, q_scale);
  return cudaGetLastError();
}

}  // namespace

// Requirements (checked by the Python wrapper): D in {64, 128}, T % 16 == 0,
// S % D == 0, 0 < true_len <= T, contiguous tensors on the device: qkv f32
// (in_bf16 = 0) or bf16, 16-byte aligned; out bf16.
extern "C" int wtt_self_attention_qkv(const void* qkv, void* out, int T, int S, int D,
                                      int true_len, int in_bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64 && in_bf16) err = launch<64, __nv_bfloat16>(qkv, out, T, S, true_len, s);
  else if (D == 64) err = launch<64, float>(qkv, out, T, S, true_len, s);
  else if (D == 128 && in_bf16) err = launch<128, __nv_bfloat16>(qkv, out, T, S, true_len, s);
  else if (D == 128) err = launch<128, float>(qkv, out, T, S, true_len, s);
  return (int)err;
}
