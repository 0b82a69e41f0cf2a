// Dequantize x matmul over block-quantized weight planes in file
// orientation: a Hopper mixed-input GEMM (wgmma fed by TMA).
//
// Replaces the TPU kernel whisper_tpu/ops/qmm.py qmm (_qmm_kernel):
//
//   out[T, R] = bf16(x)[T, K] @ W[R, K]^T,  W = bf16(code * bf16(scale))
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
// tensor-core peak, 0.046 ms of memory traffic.  Only wgmma reaches that
// peak, so the product runs on it.
//
// Design: the operands are swapped, so each block computes a 128 x 256 tile
// of out^T = W . x^T.  The dequantized W is wgmma's A operand, taken from
// registers: W rows are K-contiguous, as register A needs, and the bf16
// weight tile never exists in shared memory.  x is the B operand, read by
// wgmma from a TMA tile (K-major, 128-byte swizzle).
//
//   - One producer thread keeps a ring of 5 stages in flight, 64 deep in K:
//     per stage one TMA box of x (256 x 64 bf16) and one of codes (128 x 64
//     int8, 64-byte swizzle, so the consumers' 4-byte reads are free of
//     bank conflicts).  A full mbarrier per stage counts the TMA bytes; an
//     empty mbarrier counts the consumer warps.  Each consumer thread reads
//     its rows' block scales itself, through L1, ahead of their use.
//   - Two consumer warpgroups own 64 weight rows each and a 64 x 256 f32
//     accumulator (128 registers a thread; setmaxnreg gives them 232 and
//     the producer 40).  Per stage each thread reads its rows' codes from
//     shared memory in wgmma's A-fragment order, converts them with the
//     row's bf16 scale (byte permutes, f32 adds and bf16x2 multiplies:
//     the int-to-float conversion pipe would take 3/4 of the products'
//     time), and issues 4 wgmma m64n256k16.  The A fragments alternate
//     between two register sets (the loop is unrolled by two): the next
//     stage is converted into one set while the products of this stage
//     read the other, and the wait that retires them (wait_group 0) comes
//     before any product reads the new set, so ptxas keeps the products
//     asynchronous.  A stage goes back to the producer once the products
//     that read it have retired; the other warpgroup's products keep the
//     tensor cores busy across that wait.
//   - TMA zero-fills the ragged T, R and K edges; the epilogue stores the
//     accumulator straight to out (T, R): each warp store writes whole
//     32-byte sectors (8 consecutive weight rows of 4 activation rows).
//   - No split-K: two calls give bit-identical results.
#include "tma.cuh"

namespace {

constexpr int BR = 128;   // weight rows (out columns) per block: 2 warpgroups x 64
constexpr int BT = 256;   // activation rows (out rows) per block: the wgmma N
constexpr int BK = 64;    // K per stage: one 128-byte swizzle row of bf16 x
constexpr int STAGES = 5;
constexpr int kConsumers = 256;
constexpr int kThreads = kConsumers + 128;  // + the producer warpgroup

constexpr int X_BYTES = BT * BK * 2;         // 32768
constexpr int C_BYTES = BR * BK;             // 8192
constexpr int STAGE_BYTES = X_BYTES + C_BYTES;  // 40960, a multiple of 1024
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8 + 1024;

// byte offset of (row, byte) in a tile of 64-byte rows written by TMA with
// 64-byte swizzle: 16-byte chunk bits [4, 6) XOR address bits [7, 9)
__device__ __forceinline__ int swz64(int row, int byte) {
  return row * 64 + ((((byte >> 4) ^ (row >> 1)) & 3) << 4) + (byte & 15);
}

// four int8 codes (bytes 0..3) times a bf16 scale s2 = (s, s), as two bf16x2
// registers, off the conversion pipe (16 results a clock per SM): each
// code + 128 goes into the low byte of 2^23 and 2^23 + 128 comes off in f32,
// which leaves the code exact in the upper half of the word (bf16); one
// bf16x2 multiply then rounds code * s once, as bf16(f32(code * s)) does
__device__ __forceinline__ void dequant4(uint32_t c, uint32_t s2, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = c ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
  const uint32_t c01 = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  const uint32_t c23 = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(lo) : "r"(c01), "r"(s2));
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(hi) : "r"(c23), "r"(s2));
}

struct Smem {
  uint8_t* base;  // 1024-aligned
  __device__ __forceinline__ __nv_bfloat16* x(int s) const {
    return reinterpret_cast<__nv_bfloat16*>(base + s * STAGE_BYTES);
  }
  __device__ __forceinline__ uint8_t* codes(int s) const { return base + s * STAGE_BYTES + X_BYTES; }
  __device__ __forceinline__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(base + STAGES * STAGE_BYTES) + s;
  }
  __device__ __forceinline__ uint64_t* empty(int s) const { return full(STAGES) + s; }
};

// The block scales of this thread's two weight rows for stage `it` (2 or 4
// per row), read through L1 about a stage ahead of their use; zero past R
// and K.
__device__ __forceinline__ void load_scales(float (&sc)[2][4], const float* __restrict__ scales,
                                            int it, int ra, int R, int nb, int qk) {
  const int per = BK / qk;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int b = it * per + j;
      sc[h][j] = (j < per && r < R && b < nb) ? __ldg(scales + (size_t)r * nb + b) : 0.f;
    }
  }
}

// Stage `it`'s A fragments for this thread, once the stage has landed: the
// codes of its two rows in wgmma's A order (k = 2tg, 2tg+1, 2tg+8, 2tg+9 of
// each 16-deep k-step), each times its block's bf16 scale.
__device__ __forceinline__ void convert_stage(const Smem& sm, int it, uint32_t (&a)[4][4],
                                              const float (&sc)[2][4], int row0, int qk, int tg) {
  const int st = it % STAGES;
  mbar_wait(sm.full(st), (it / STAGES) & 1);
  const uint8_t* cs = sm.codes(st);
  const uint32_t sel = (tg & 1) ? 0x7632 : 0x5410;
  const int wb = 4 * (tg >> 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(cs + swz64(r, 16 * kk + wb));
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(cs + swz64(r, 16 * kk + 8 + wb));
      const uint32_t c = __byte_perm(w0, w1, sel);  // codes of this k-step
      const float s = qk == 16 ? sc[h][kk] : sc[h][kk >> 1];
      const __nv_bfloat162 s2 = __float2bfloat162_rn(s);
      dequant4(c, *reinterpret_cast<const uint32_t*>(&s2), a[kk][h], a[kk][h + 2]);
    }
  }
}

// the 4 products of stage `it`, issued and committed as one group
__device__ __forceinline__ void issue_stage(const Smem& sm, int it, float* acc,
                                            const uint32_t (&a)[4][4]) {
  const uint32_t xb = smem_addr(sm.x(it % STAGES));
  fence_acc<128>(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n256k16_rs<0>(acc, a[kk], desc_sw128(xb + kk * 32), 1);
  wgmma_commit();
}

// wait for the group to retire, then hand the stage back to the producer
__device__ __forceinline__ void retire_stage(const Smem& sm, int it, float* acc) {
  wgmma_wait<0>();
  fence_acc<128>(acc);
  if ((threadIdx.x & 31) == 0) mbar_arrive(sm.empty(it % STAGES));
}

__global__ void __launch_bounds__(kThreads, 1)
qmm_kernel(const __grid_constant__ CUtensorMap x_map, const __grid_constant__ CUtensorMap c_map,
           const float* __restrict__ scales, float* __restrict__ out, int T, int K, int R,
           int qk) {
  extern __shared__ uint8_t smem_raw[];
  Smem sm{reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                     ~uintptr_t(1023))};
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * BR, t0 = blockIdx.y * BT;
  const int n_it = (K + BK - 1) / BK;
  const int nb = K / qk;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(sm.full(s), 1);
      mbar_init(sm.empty(s), kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // producer warpgroup: one thread issues, the others leave
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid > kConsumers) return;
    for (int it = 0; it < n_it; ++it) {
      const int st = it % STAGES;
      mbar_wait(sm.empty(st), ((it / STAGES) & 1) ^ 1);
      mbar_expect_tx(sm.full(st), X_BYTES + C_BYTES);
      tma_load_2d(sm.x(st), &x_map, sm.full(st), it * BK, t0);
      tma_load_2d(sm.codes(st), &c_map, sm.full(st), it * BK, r0);
    }
    return;
  }

  // consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3;
  const int row0 = wg * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float sc[2][4];
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

  // acc[4j + e]: weight row row0 + 8 * (e >> 1), activation row 8j + 2tg + (e & 1)
  const int ra = r0 + row0, rb = ra + 8;
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
    const int t = t0 + 8 * j + 2 * tg;
    if (t < T) {
      if (ra < R) out[(size_t)t * R + ra] = acc[4 * j];
      if (rb < R) out[(size_t)t * R + rb] = acc[4 * j + 2];
    }
    if (t + 1 < T) {
      if (ra < R) out[(size_t)(t + 1) * R + ra] = acc[4 * j + 1];
      if (rb < R) out[(size_t)(t + 1) * R + rb] = acc[4 * j + 3];
    }
  }
}

}  // namespace

// Requirements (checked by the Python wrapper): K % 16 == 0 (16-byte TMA
// row strides), qk = K / nb in {16, 32}, contiguous tensors on the device,
// x bf16, x and codes 16-byte aligned.
extern "C" int wtt_qmm(const void* x, const void* codes, const void* scales, void* out,
                       int T, int K, int R, int qk, void* stream) {
  CUtensorMap x_map, c_map;
  if (!make_map(&x_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, T, K, BT, BK,
                CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map(&c_map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes, R, K, BR, BK,
                CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  static size_t smem_allowed = 0;
  cudaError_t err = wtt_allow_smem(qmm_kernel, SMEM_BYTES, &smem_allowed);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + BR - 1) / BR, (T + BT - 1) / BT);
  qmm_kernel<<<grid, kThreads, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      x_map, c_map, static_cast<const float*>(scales), static_cast<float*>(out), T, K, R, qk);
  return (int)cudaGetLastError();
}
