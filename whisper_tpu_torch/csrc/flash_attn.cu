// Non-causal flash attention in two segments, on the tensor cores.
//
// Replaces the TPU kernel that whisper_tpu/ops/attention.py
// flash_self_attention reaches: the library Pallas flash_attention with
// segment ids (row < n_real) and causal=False.  What it computes, per head:
//
//   s   = (bf16(q) . bf16(k)^T) * sm_scale              (f32)
//   s  += 0 where (row < n_real) == (col < n_real), else -0.7 * FLT_MAX
//   online softmax over key tiles: m = running max, p = exp(s - m) in f32,
//   l   = sum of the unrounded p (f32), acc += bf16(p) @ bf16(v) (f32),
//   out = bf16(acc / l), stored as f32.
//
// The mask value is finite, as in the library, so the online rescaling never
// forms inf - inf; every row has at least one allowed key (pad rows attend
// to their own segment), so no row ends in NaN.  Key columns past T are
// treated as masked.
//
// What bounds it on an H100: operations.  Whisper's encoder at
// large-v3-turbo (20 heads of 64, T = 1536, 1500 real) is 4 * H * D *
// (1500^2 + 36^2) = 11.5 GFLOP per layer against a few MB of inputs.
//
// Design (FlashAttention-2): one block of 4 warps per (64 query rows, head);
// each warp owns 16 query rows, whose bf16 q fragments stay in registers.
// Key and value tiles of 64 rows are rounded to bf16 into shared memory
// (values transposed, so both products read 32-bit fragments), S = q k^T
// and acc += P V run on mma.sync m16n8k16, and the S accumulators are
// repacked in registers as the A operand of the P V product.  q, k and v
// are read through strides, so the encoder hands over head views of its
// fused (T, 3S) projection with no copy, and the output is written through
// strides too.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int BQ = 64;   // query rows per block (16 per warp)
constexpr int BKV = 64;  // key rows per tile
constexpr float kMask = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ void load2(const float* p, float* f) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  f[0] = v.x; f[1] = v.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float* f) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  f[0] = __low2float(v); f[1] = __high2float(v);
}
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 v = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = __bfloat162float(e[i]);
}

struct Strides {
  long long q_h, q_t, k_h, k_t, v_h, v_t, o_h, o_t;
};

template <int D, typename TIn>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                  const TIn* __restrict__ v, float* __restrict__ out, int T, int n_real,
                  Strides st, float sm_scale) {
  constexpr int KS = D / 16;   // k-steps of the q k^T product
  constexpr int NS = BKV / 8;  // n-tiles of S
  constexpr int ND = D / 8;    // n-tiles of the output
  __shared__ __align__(16) __nv_bfloat16 Ks[BKV][D + 8];
  __shared__ __align__(16) __nv_bfloat16 Vt[D][BKV + 8];

  const int h = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int r0 = blockIdx.x * BQ + warp * 16 + g, r1 = r0 + 8;
  const TIn* qh = q + h * st.q_h;
  const TIn* kh = k + h * st.k_h;
  const TIn* vh = v + h * st.v_h;

  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int d0 = kk * 16 + tg * 2;
    float a[2] = {0.f, 0.f}, b[2] = {0.f, 0.f}, c[2] = {0.f, 0.f}, e[2] = {0.f, 0.f};
    if (r0 < T) { load2(qh + r0 * st.q_t + d0, a); load2(qh + r0 * st.q_t + d0 + 8, c); }
    if (r1 < T) { load2(qh + r1 * st.q_t + d0, b); load2(qh + r1 * st.q_t + d0 + 8, e); }
    qf[kk][0] = wtt_pack_bf16(a[0], a[1]);
    qf[kk][1] = wtt_pack_bf16(b[0], b[1]);
    qf[kk][2] = wtt_pack_bf16(c[0], c[1]);
    qf[kk][3] = wtt_pack_bf16(e[0], e[1]);
  }
  const bool real0 = r0 < n_real, real1 = r1 < n_real;

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int kv0 = 0; kv0 < T; kv0 += BKV) {
    __syncthreads();  // the previous tile has been read
    for (int i = tid; i < BKV * D / 4; i += kThreads) {
      const int key = i / (D / 4), d = (i % (D / 4)) * 4;  // K: d fastest
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (kv0 + key < T) load4(kh + (kv0 + key) * st.k_t + d, f);
      uint2 w = make_uint2(wtt_pack_bf16(f[0], f[1]), wtt_pack_bf16(f[2], f[3]));
      *reinterpret_cast<uint2*>(&Ks[key][d]) = w;
    }
    for (int i = tid; i < BKV * D / 4; i += kThreads) {
      const int key = i % BKV, d = (i / BKV) * 4;          // V: key fastest
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (kv0 + key < T) load4(vh + (kv0 + key) * st.v_t + d, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) Vt[d + e][key] = __float2bfloat16_rn(f[e]);
    }
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(&Ks[j * 8 + g][kk * 16 + tg * 2]);
        b[1] = *reinterpret_cast<const uint32_t*>(&Ks[j * 8 + g][kk * 16 + tg * 2 + 8]);
        wtt_mma_bf16(s[j], qf[kk], b);
      }

    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + tg * 2 + (e & 1);
        const bool row_real = e < 2 ? real0 : real1;
        const float sv = s[j][e] * sm_scale;
        s[j][e] = col >= T ? kMask : ((col < n_real) == row_real ? sv : sv + kMask);
        if (e < 2) mx0 = fmaxf(mx0, s[j][e]); else mx1 = fmaxf(mx1, s[j][e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(WTT_FULL_MASK, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(WTT_FULL_MASK, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = expf(s[j][0] - mn0); s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1); s[j][3] = expf(s[j][3] - mn1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(WTT_FULL_MASK, sum0, off);
      sum1 += __shfl_xor_sync(WTT_FULL_MASK, sum1, off);
    }
    l0 = al0 * l0 + sum0;
    l1 = al1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= al0; acc[j][1] *= al0;
      acc[j][2] *= al1; acc[j][3] *= al1;
    }

#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = wtt_pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = wtt_pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = wtt_pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = wtt_pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        uint32_t b[2];
        b[0] = *reinterpret_cast<const uint32_t*>(&Vt[j * 8 + g][kk * 16 + tg * 2]);
        b[1] = *reinterpret_cast<const uint32_t*>(&Vt[j * 8 + g][kk * 16 + tg * 2 + 8]);
        wtt_mma_bf16(acc[j], a, b);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int d = j * 8 + tg * 2;
    if (r0 < T) {
      float2 o = make_float2(wtt_round_bf16(acc[j][0] / l0), wtt_round_bf16(acc[j][1] / l0));
      *reinterpret_cast<float2*>(out + h * st.o_h + r0 * st.o_t + d) = o;
    }
    if (r1 < T) {
      float2 o = make_float2(wtt_round_bf16(acc[j][2] / l1), wtt_round_bf16(acc[j][3] / l1));
      *reinterpret_cast<float2*>(out + h * st.o_h + r1 * st.o_t + d) = o;
    }
  }
}

template <int D, typename TIn>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int H, int T,
                   int n_real, const Strides& st, float sm_scale, cudaStream_t stream) {
  dim3 grid((T + BQ - 1) / BQ, H);
  flash_attn_kernel<D, TIn><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(q), static_cast<const TIn*>(k), static_cast<const TIn*>(v),
      static_cast<float*>(out), T, n_real, st, sm_scale);
  return cudaGetLastError();
}

}  // namespace

// Requirements (checked by the Python wrapper): D in {64, 128}; q, k, v of
// one type (f32 or bf16) with unit stride along D, and row and head strides
// that keep 4-element loads aligned; out f32 with unit stride along D.
// Strides are in elements.
extern "C" int wtt_flash_attn(const void* q, const void* k, const void* v, void* out, int H,
                              int T, int D, int n_real, int in_bf16, long long q_h,
                              long long q_t, long long k_h, long long k_t, long long v_h,
                              long long v_t, long long o_h, long long o_t, float sm_scale,
                              void* stream) {
  const Strides st{q_h, q_t, k_h, k_t, v_h, v_t, o_h, o_t};
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64 && in_bf16) err = launch<64, __nv_bfloat16>(q, k, v, out, H, T, n_real, st, sm_scale, s);
  else if (D == 64) err = launch<64, float>(q, k, v, out, H, T, n_real, st, sm_scale, s);
  else if (D == 128 && in_bf16) err = launch<128, __nv_bfloat16>(q, k, v, out, H, T, n_real, st, sm_scale, s);
  else if (D == 128) err = launch<128, float>(q, k, v, out, H, T, n_real, st, sm_scale, s);
  return (int)err;
}
