// Dequantize x matmul over block-quantized weight planes in file
// orientation, on the tensor cores.
//
// Replaces the TPU kernel whisper_tpu/ops/qmm.py qmm (_qmm_kernel):
//
//   out[T, R] = bf16(x)[T, K] @ W[R, K]^T,  W = bf16(bf16(code) * bf16(scale))
//
//   x (T, K) bf16 (the wrapper rounds any float input); codes (R, K) int8;
//   scales (R, K/qk) f32 with qk in {16, 32}; out (T, R) f32.
//
// Numerics follow the TPU kernel: the block scale is rounded to bf16 (its
// 0/1 expansion matmul there is exact), the code is exact in bf16, their
// product is rounded to bf16, and the dot accumulates in f32.
//
// What bounds it on an H100: operations.  At 4096^3 (whisper-bench -w 2) the
// product is 137 GFLOP against 153 MB of operands: 0.139 ms at the bf16
// tensor-core peak, 0.046 ms of memory traffic.
//
// Design: a tiled GEMM on mma.sync m16n8k16 (bf16 in, f32 accumulate).  One
// block of 8 warps per 128 x 128 output tile walks K in slabs of 32.  Each
// slab of x and of the dequantized weight rows goes to shared memory (two
// buffers, so the next slab's global loads overlap this slab's products);
// each thread dequantizes 16 codes of one weight row on the way in.  Both
// operands are K-contiguous, which is exactly the row.col layout of the mma
// fragments, so fragments are 32-bit shared-memory loads.  wgmma and TMA
// are later work.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDS = BK + 8;  // padded row (bf16): conflict-free fragment loads
constexpr int WM = 64, WN = 32;  // warp tile: 2 x 4 warps
constexpr int MT = WM / 16, NT = WN / 8;

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

struct Slab {
  uint4 x[2];      // 2 x 8 bf16 of x
  uint4 codes;     // 16 int8 codes of one weight row
  float scale;     // that row's block scale, rounded to bf16
};

__device__ __forceinline__ void load_slab(Slab& s, const __nv_bfloat16* __restrict__ x,
                                          const int8_t* __restrict__ codes,
                                          const float* __restrict__ scales, int T, int K,
                                          int R, int nb, int qk, int m0, int n0, int k0) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;       // 512 chunks of 8 bf16
    const int r = idx >> 2, c = (idx & 3) * 8;
    const int gr = m0 + r, gk = k0 + c;
    s.x[i] = (gr < T && gk < K)
                 ? *reinterpret_cast<const uint4*>(x + (size_t)gr * K + gk)
                 : make_uint4(0, 0, 0, 0);
  }
  const int r = tid >> 1, c = (tid & 1) * 16;  // 256 chunks of 16 codes
  const int gr = n0 + r, gk = k0 + c;
  if (gr < R && gk < K) {
    s.codes = *reinterpret_cast<const uint4*>(codes + (size_t)gr * K + gk);
    s.scale = __bfloat162float(__float2bfloat16_rn(scales[(size_t)gr * nb + gk / qk]));
  } else {
    s.codes = make_uint4(0, 0, 0, 0);
    s.scale = 0.f;
  }
}

__device__ __forceinline__ void store_slab(const Slab& s, __nv_bfloat16* As, __nv_bfloat16* Bs) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx >> 2, c = (idx & 3) * 8;
    *reinterpret_cast<uint4*>(As + r * LDS + c) = s.x[i];
  }
  const int r = tid >> 1, c = (tid & 1) * 16;
  const int8_t* q = reinterpret_cast<const int8_t*>(&s.codes);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = pack_bf16((float)q[2 * i] * s.scale, (float)q[2 * i + 1] * s.scale);
  uint4* dst = reinterpret_cast<uint4*>(Bs + r * LDS + c);
  dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
  dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

__global__ void __launch_bounds__(kThreads)
qmm_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
           const float* __restrict__ scales, float* __restrict__ out, int T, int K,
           int R, int qk) {
  __shared__ __align__(16) __nv_bfloat16 As[2][BM * LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[2][BN * LDS];

  const int nb = K / qk;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 2) * WM, wn = (warp & 3) * WN;
  const int g = lane >> 2, tg = lane & 3;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int n_slabs = (K + BK - 1) / BK;
  Slab s;
  load_slab(s, x, codes, scales, T, K, R, nb, qk, m0, n0, 0);
  store_slab(s, As[0], Bs[0]);
  __syncthreads();

  for (int kt = 0; kt < n_slabs; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < n_slabs) load_slab(s, x, codes, scales, T, K, R, nb, qk, m0, n0, (kt + 1) * BK);
    const __nv_bfloat16* A = As[cur];
    const __nv_bfloat16* B = Bs[cur];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* p = A + (wm + i * 16 + g) * LDS + kk + tg * 2;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* p = B + (wn + j * 8 + g) * LDS + kk + tg * 2;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
    if (kt + 1 < n_slabs) store_slab(s, As[cur ^ 1], Bs[cur ^ 1]);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + wm + i * 16 + g + (e >> 1) * 8;
        const int c = n0 + wn + j * 8 + tg * 2 + (e & 1);
        if (r < T && c < R) out[(size_t)r * R + c] = acc[i][j][e];
      }
}

}  // namespace

// Requirements (checked by the Python wrapper): K % 16 == 0, qk = K / nb in
// {16, 32}, contiguous tensors on the device, x bf16 with 16-byte aligned
// rows (K % 8 == 0 follows).
extern "C" int wtt_qmm(const void* x, const void* codes, const void* scales, void* out,
                       int T, int K, int R, int qk, void* stream) {
  dim3 grid((R + BN - 1) / BN, (T + BM - 1) / BM);
  qmm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes),
      static_cast<const float*>(scales), static_cast<float*>(out), T, K, R, qk);
  return (int)cudaGetLastError();
}
