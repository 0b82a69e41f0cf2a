// Shared helpers of the port's Hopper kernels (built for sm_90a).
//
// Every source under csrc/ compiles on its own into a shared library with a
// plain C interface (ops/_cuda.py loads it with ctypes).  Each C entry
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError(); wtt_error_string turns that code into text.
#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define WTT_FULL_MASK 0xffffffffu

__device__ __forceinline__ float wtt_round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float wtt_warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(WTT_FULL_MASK, v, off);
  return v;
}

__device__ __forceinline__ float wtt_warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(WTT_FULL_MASK, v, off));
  return v;
}

// two floats as a bf16x2 register, `lo` in the low half (the first element
// of an mma fragment pair)
__device__ __forceinline__ uint32_t wtt_pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a @ b on the tensor cores: m16n8k16, bf16 in, f32 accumulate
__device__ __forceinline__ void wtt_mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8x8 bf16 matrices from shared memory into mma.sync fragments: lane
// 8i + j gives the address of row j of matrix i, and r[i] receives this
// lane's pair of matrix i; _trans transposes each matrix, for a B operand
// stored k by n (as V is)
__device__ __forceinline__ void wtt_ldsm_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void wtt_ldsm_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Asynchronous copies into shared memory (cp.async; commit and wait at the
// call site).  wtt_cp_async16 bypasses L1 and copies `bytes` (16, or 0 to
// fill the 16 with zeros); wtt_cp_async_ca copies N (4, 8 or 16) bytes
// through L1, for data that other blocks of the SM read too.
__device__ __forceinline__ void wtt_cp_async16(void* smem, const void* gmem, int bytes = 16) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(bytes));
}

template <int N>
__device__ __forceinline__ void wtt_cp_async_ca(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(N));
}

// Block-wide reduction over blockDim.x threads (a multiple of 32, at most
// 1024); `scratch` holds 32 floats of shared memory.  Every thread gets the
// result.
template <bool IS_MAX>
__device__ __forceinline__ float wtt_block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = IS_MAX ? wtt_warp_max(v) : wtt_warp_sum(v);
  __syncthreads();  // scratch may still be read from a previous call
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = lane < n_warps ? scratch[lane] : (IS_MAX ? -INFINITY : 0.0f);
  r = IS_MAX ? wtt_warp_max(r) : wtt_warp_sum(r);
  return r;
}

// Dynamic shared memory above 48 KB needs an explicit opt-in per kernel.
// `allowed` (one static per kernel instantiation at the call site) keeps
// the largest size already granted, so the attribute is set once per size
// increase and never inside a captured CUDA graph after a warm-up call.
template <typename Kernel>
__host__ inline cudaError_t wtt_allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= 48 * 1024 || bytes <= *allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *allowed = bytes;
  return err;
}

extern "C" const char* wtt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
