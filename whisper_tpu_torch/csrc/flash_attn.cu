// Non-causal flash attention in two segments, on Hopper's warpgroup tensor
// cores (wgmma).
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
// (1500^2 + 36^2) = 11.5 GFLOP per layer against a few MB of inputs; only
// wgmma reaches the tensor cores' full rate.
//
// Design: one block of two warpgroups (256 threads) per (128 query rows,
// head); each warpgroup owns 64 query rows.  The block's threads read q, k
// and v through the strides with 16-byte loads (f32, or bf16 in 8-byte
// halves), round them to bf16 (cvt.rn.bf16x2.f32) and store them to shared
// memory with the 128-byte swizzle, 64 columns per 128-byte row:
//   - q once, as the K-major A operand of S = q K^T for the whole key loop
//     (in registers, as a loop-invariant register A, ptxas gave its
//     registers to P at head dimension 64: csrc/wgmma.cuh);
//   - the two warpgroups share every key and value tile of BKV keys.  K and
//     V have the same layout: K is the K-major B operand of S, V the
//     MN-major (transposed) B operand of acc += P V, so nothing is stored
//     transposed;
//   - tiles are double-buffered: the global loads of tile j + 1 go out into
//     registers before the products of tile j and are stored while its P V
//     product runs, with one block barrier per tile;
//   - S is wgmma m64n{BKV}k16 over D / 16 k-steps.  The mask, the running
//     max and the sum run on the accumulator in registers (quad shuffles);
//     P is rounded to bf16 and repacked in registers as the A operand of
//     wgmma m64n{D}k16.
//   - In a block whose rows are all real, key tiles wholly at or past n_real
//     add exact zeros (p = exp(mask) = 0, the rescale is 1) and are skipped.
// q, k and v are read through strides, so the encoder hands over head views
// of its fused (T, 3S) projection with no copy, and the output is written
// through strides too.
//
// Heads of 16 and 32 (the matrix's mini and multilingual minis; no real
// Whisper size has them) take flash_attn_mma_kernel, FlashAttention-2 on
// mma.sync m16n8k16 (a wgmma k-step is 16 wide and a swizzled row 64, so
// such heads would waste most of each tile).  Same rounding points, expf
// included: ex2.approx on scores scaled by sm_scale * log2(e) was 13-22%
// faster, but it rounds the scores elsewhere and moved a DTW path of the
// parity matrix, card against CPU.  At T = 1536 the roofline bound is under 1 µs
// (0.58 GFLOP at 2 heads of 32); what bounds the kernel is latency and
// parallelism: two heads give 48 blocks of 64 query rows on 132 SMs, and
// each warp's tile is a serial chain of S products, quad shuffles, 32
// exps a thread on the SFU and P V products.  So:
//   - a block is 4 warps and 64 query rows; each warp keeps its 16 rows of
//     bf16(q) as A fragments for the whole key loop;
//   - the row block's key tiles are split over a thread-block cluster of
//     1, 2 or 4 blocks (the most that keeps every block of the grid
//     resident, 4 an SM at 128 registers a thread): 192 blocks at 2 heads
//     of 32, 288 at 6 of 16.  Each block reads only its share of K and V,
//     so the cluster adds no device-memory traffic;
//   - 64-key tiles of K and V, rounded to bf16, go to shared memory in
//     rows padded by 16 bytes (ldmatrix without bank conflicts),
//     double-buffered: the next tile's global loads are in flight in
//     registers while the current tile's products run.  The loads are
//     plain 16-byte (f32) and 8-byte (bf16) loads, not cp.async: the
//     wrapper promises only 4-element alignment, and f32 input is
//     converted on the way anyway;
//   - S = q K^T reads K with ldmatrix; the mask is applied per score only
//     on tiles that need it (a template chosen once a tile); P is rounded
//     to bf16 and repacked from S's accumulators as the A operand of
//     acc += P V, with V read by ldmatrix.trans, so nothing is stored
//     transposed;
//   - a block whose rows are all real skips key tiles wholly at or past
//     n_real, as above;
//   - at the end ranks 1 .. nc - 1 write (m, l, acc) into rank 0's shared
//     memory (distributed shared memory, between two cluster barriers) and
//     rank 0 merges them in rank order: no atomics, the same bits from
//     call to call and under graph replay.
#include <cooperative_groups.h>

#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // two warpgroups
constexpr int BQ = 128;        // query rows per block (64 per warpgroup)
constexpr int BKV = 64;        // keys per tile
constexpr float kMask = -0.7f * 3.4028234663852886e38f;

// byte offset of 16-byte chunk c (bf16 columns 8c .. 8c + 7) of row r in a
// tile of ROWS rows: column block c / 8 holds ROWS rows of 128 bytes, the
// chunks of a row swizzled within each 8-row group
template <int ROWS>
__device__ __forceinline__ int swz128(int r, int c) {
  return (c >> 3) * ROWS * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// 8 consecutive elements of a key row, held between the global load and the
// bf16 store to shared memory
template <typename TIn> struct Chunk;
template <> struct Chunk<float> {
  float4 a, b;
  __device__ __forceinline__ void load(const float* p) {
    a = *reinterpret_cast<const float4*>(p);
    b = *reinterpret_cast<const float4*>(p + 4);
  }
  __device__ __forceinline__ void zero() { a = b = make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ uint4 bf16() const {
    return make_uint4(wtt_pack_bf16(a.x, a.y), wtt_pack_bf16(a.z, a.w),
                      wtt_pack_bf16(b.x, b.y), wtt_pack_bf16(b.z, b.w));
  }
};
template <> struct Chunk<__nv_bfloat16> {
  uint2 a, b;  // 8-byte halves: rows are only 4-element aligned
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    a = *reinterpret_cast<const uint2*>(p);
    b = *reinterpret_cast<const uint2*>(p + 4);
  }
  __device__ __forceinline__ void zero() { a = b = make_uint2(0u, 0u); }
  __device__ __forceinline__ uint4 bf16() const { return make_uint4(a.x, a.y, b.x, b.y); }
};

// This thread's share of one key tile and one value tile.  Keys at or past
// T read zeros.
template <int D, typename TIn>
struct TileRegs {
  static constexpr int CPR = D / 8;               // chunks per key row
  static constexpr int N = BKV * CPR / kThreads;  // chunks per thread, of K and of V
  Chunk<TIn> k[N], v[N];

  __device__ __forceinline__ void load(const TIn* kh, const TIn* vh, long long k_t,
                                       long long v_t, int kv0, int T) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int key = kv0 + c / CPR, d = (c % CPR) * 8;
      if (key < T) {
        k[i].load(kh + key * k_t + d);
        v[i].load(vh + key * v_t + d);
      } else {
        k[i].zero();
        v[i].zero();
      }
    }
  }
  __device__ __forceinline__ void store(uint8_t* ks, uint8_t* vs) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const int off = swz128<BKV>(c / CPR, c % CPR);
      *reinterpret_cast<uint4*>(ks + off) = k[i].bf16();
      *reinterpret_cast<uint4*>(vs + off) = v[i].bf16();
    }
  }
};

struct Strides {
  long long q_h, q_t, k_h, k_t, v_h, v_t, o_h, o_t;
};

// q, then K and V double-buffered, + alignment
template <int D>
constexpr int smem_bytes() {
  return (BQ + 2 * 2 * BKV) * D * 2 + 1024;
}

// the block's BQ rows of q, rounded to bf16 into shared memory; rows at or
// past T are zeros
template <int D, typename TIn>
__device__ __forceinline__ void store_q(uint8_t* qs, const TIn* qh, long long q_t, int q0, int T) {
  constexpr int CPR = D / 8;
#pragma unroll
  for (int i = 0; i < BQ * CPR / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int row = c / CPR;
    Chunk<TIn> x;
    if (q0 + row < T) x.load(qh + (q0 + row) * q_t + (c % CPR) * 8);
    else x.zero();
    *reinterpret_cast<uint4*>(qs + swz128<BQ>(row, c % CPR)) = x.bf16();
  }
}

// Blocks per SM: two for bf16 input at D = 64 (128 registers a thread);
// f32 input keeps its tile prefetch in twice the registers and spills at
// that cap, so it takes one (utils/kernel_variants.py times both)
template <int D, typename TIn>
__global__ void __launch_bounds__(kThreads, D == 64 && sizeof(TIn) == 2 ? 2 : 1)
flash_attn_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                  const TIn* __restrict__ v, float* __restrict__ out, int T, int n_real,
                  Strides st, float sm_scale) {
  constexpr int KS = D / 16;         // k-steps of S = q K^T
  constexpr int NS = BKV / 8;        // 8-column groups of S
  constexpr int ND = D / 8;          // 8-column groups of the output
  constexpr int TILE = BKV * D * 2;  // bytes of one bf16 key or value tile
  extern __shared__ uint8_t smem_raw[];
  // [q | K0 | V0 | K1 | V1], 1024-byte aligned for the swizzle
  uint8_t* qs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* sm = qs + BQ * D * 2;

  const int h = blockIdx.y, tid = threadIdx.x;
  const int warp = (tid >> 5) & 3, lane = tid & 31;  // warp within its warpgroup
  const int g = lane >> 2, tg = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int r0 = q0 + (tid >> 7) * 64 + warp * 16 + g, r1 = r0 + 8;
  const TIn* qh = q + h * st.q_h;
  const TIn* kh = k + h * st.k_h;
  const TIn* vh = v + h * st.v_h;

  const bool real0 = r0 < n_real, real1 = r1 < n_real;
  const bool all_real = q0 + BQ <= n_real;
  const int n_tiles = ((all_real ? n_real : T) + BKV - 1) / BKV;

  float acc[ND * 4];
#pragma unroll
  for (int i = 0; i < ND * 4; ++i) acc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  store_q<D>(qs, qh, st.q_t, q0, T);
  // this warpgroup's 64 rows of q
  const uint32_t qa = smem_addr(qs) + (tid >> 7) * 64 * 128;
  TileRegs<D, TIn> tile;
  tile.load(kh, vh, st.k_t, st.v_t, 0, T);
  tile.store(sm, sm + TILE);
  fence_proxy_async();
  __syncthreads();

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int kv0 = jt * BKV;
    const uint32_t kb = smem_addr(sm + (jt & 1) * 2 * TILE), vb = kb + TILE;
    const bool more = jt + 1 < n_tiles;
    if (more) tile.load(kh, vh, st.k_t, st.v_t, kv0 + BKV, T);

    // S = q K^T: a k-step is 32 bytes along the 128-byte rows of q and K;
    // columns 64 on are the next column block, BQ (q) or BKV (K) rows on
    float s[NS * 4];
#pragma unroll
    for (int i = 0; i < NS * 4; ++i) s[i] = 0.f;
    fence_acc<NS * 4>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_m64k16_ss<BKV, 0>(s, desc_sw128(qa + (kk >> 2) * BQ * 128 + (kk & 3) * 32),
                              desc_sw128(kb + (kk >> 2) * BKV * 128 + (kk & 3) * 32), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc<NS * 4>(s);

    // s[4j + e]: row r0 (e < 2) or r1, key kv0 + 8j + 2tg + (e & 1)
    const bool plain = all_real && kv0 + BKV <= n_real;  // no score masked
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sv = s[4 * j + e] * sm_scale;
        if (!plain) {
          const int col = kv0 + j * 8 + tg * 2 + (e & 1);
          const bool row_real = e < 2 ? real0 : real1;
          sv = col >= T ? kMask : ((col < n_real) == row_real ? sv : sv + kMask);
        }
        s[4 * j + e] = sv;
        if (e < 2) mx0 = fmaxf(mx0, sv); else mx1 = fmaxf(mx1, sv);
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
      s[4 * j] = expf(s[4 * j] - mn0); s[4 * j + 1] = expf(s[4 * j + 1] - mn0);
      s[4 * j + 2] = expf(s[4 * j + 2] - mn1); s[4 * j + 3] = expf(s[4 * j + 3] - mn1);
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
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
      acc[4 * j] *= al0; acc[4 * j + 1] *= al0;
      acc[4 * j + 2] *= al1; acc[4 * j + 3] *= al1;
    }
    // bf16(p) as A fragments, 16 keys (two 8-column groups) per k-step
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      pa[kk][0] = wtt_pack_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = wtt_pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = wtt_pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = wtt_pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }

    // acc += P V: V read MN-major, a k-step is 16 key rows (2048 bytes);
    // columns 64 on are the next column block, BKV rows on (LBO)
    fence_acc<ND * 4>(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_m64k16_rs<D, 1>(acc, pa[kk], desc_sw128_mn(vb + kk * 2048, BKV * 128), 1);
    wgmma_commit();
    if (more) {
      // the other buffer was last read by tile jt - 1's products, which
      // retired before the barrier that ended it
      uint8_t* nk = sm + ((jt + 1) & 1) * 2 * TILE;
      tile.store(nk, nk + TILE);
      fence_proxy_async();
    }
    wgmma_wait<0>();
    fence_acc<ND * 4>(acc);
    __syncthreads();
  }

  // acc[4j + e]: row r0 (e < 2) or r1, column 8j + 2tg + (e & 1)
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int d = j * 8 + tg * 2;
    if (r0 < T) {
      float2 o = make_float2(wtt_round_bf16(acc[4 * j] / l0), wtt_round_bf16(acc[4 * j + 1] / l0));
      *reinterpret_cast<float2*>(out + h * st.o_h + r0 * st.o_t + d) = o;
    }
    if (r1 < T) {
      float2 o = make_float2(wtt_round_bf16(acc[4 * j + 2] / l1),
                             wtt_round_bf16(acc[4 * j + 3] / l1));
      *reinterpret_cast<float2*>(out + h * st.o_h + r1 * st.o_t + d) = o;
    }
  }
}

template <int D, typename TIn>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int H, int T,
                   int n_real, const Strides& st, float sm_scale, cudaStream_t stream) {
  static size_t smem_allowed = 0;
  cudaError_t err = wtt_allow_smem(flash_attn_kernel<D, TIn>, smem_bytes<D>(), &smem_allowed);
  if (err != cudaSuccess) return err;
  dim3 grid((T + BQ - 1) / BQ, H);
  flash_attn_kernel<D, TIn><<<grid, kThreads, smem_bytes<D>(), stream>>>(
      static_cast<const TIn*>(q), static_cast<const TIn*>(k), static_cast<const TIn*>(v),
      static_cast<float*>(out), T, n_real, st, sm_scale);
  return cudaGetLastError();
}


// Heads of D = 16 and 32: FlashAttention-2 on mma.sync m16n8k16 (bf16 in,
// f32 sums), with the rounding points of flash_attn_kernel.
constexpr int kWarpsQ = 4;                   // warps a block, 16 query rows each
constexpr int kMmaThreads = 32 * kWarpsQ;
constexpr int MBQ = 16 * kWarpsQ;            // query rows per block
constexpr int MBKV = 64;                     // keys per tile
constexpr int kClusterMax = 4;               // blocks per cluster, at most
constexpr int kBlocksPerSm = 4;              // resident at once (launch bounds)

// two consecutive elements of a q row as a bf16x2 A-fragment register
__device__ __forceinline__ uint32_t q_pair(const float* p) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  return wtt_pack_bf16(v.x, v.y);
}
__device__ __forceinline__ uint32_t q_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// This thread's share of one key tile and one value tile, between the
// global load and the bf16 store to shared memory.  Keys at or past T
// read zeros.
template <int D, typename TIn>
struct MmaTileRegs {
  static constexpr int CPR = D / 8;                  // chunks per key row
  static constexpr int N = MBKV * CPR / kMmaThreads;  // chunks per thread, of K and of V
  Chunk<TIn> k[N], v[N];

  __device__ __forceinline__ void load(const TIn* kh, const TIn* vh, long long k_t,
                                       long long v_t, int kv0, int T) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = threadIdx.x + i * kMmaThreads;
      const int key = kv0 + c / CPR, d = (c % CPR) * 8;
      if (key < T) {
        k[i].load(kh + key * k_t + d);
        v[i].load(vh + key * v_t + d);
      } else {
        k[i].zero();
        v[i].zero();
      }
    }
  }
  __device__ __forceinline__ void store(__nv_bfloat16 (*ks)[D + 8],
                                        __nv_bfloat16 (*vs)[D + 8]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = threadIdx.x + i * kMmaThreads;
      *reinterpret_cast<uint4*>(&ks[c / CPR][(c % CPR) * 8]) = k[i].bf16();
      *reinterpret_cast<uint4*>(&vs[c / CPR][(c % CPR) * 8]) = v[i].bf16();
    }
  }
};

// One tile's scores times sm_scale, the two rows'
// maxima over this thread's columns folded into mx0, mx1.  MASK adds kMask
// across the segments and puts kMask at key columns at or past T, as
// flash_attn_kernel does; tiles of all-real rows and keys take MASK = false
// and no per-score test.  s[j][e]: row r0 (e < 2) or r1, key col0 + 8j +
// (e & 1).
template <bool MASK, int NS>
__device__ __forceinline__ void scale_scores(float (&s)[NS][4], float scale, int col0, int T,
                                             int n_real, bool real0, bool real1, float& mx0,
                                             float& mx1) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float sv = s[j][e] * scale;
      if (MASK) {
        const int col = col0 + j * 8 + (e & 1);
        const bool row_real = e < 2 ? real0 : real1;
        sv = col >= T ? kMask : ((col < n_real) == row_real ? sv : sv + kMask);
      }
      s[j][e] = sv;
      if (e < 2) mx0 = fmaxf(mx0, sv); else mx1 = fmaxf(mx1, sv);
    }
}

// floats of one warp's (acc, m, l) in the merge, lane-major
template <int D>
__host__ __device__ constexpr int merge_slot() {
  return (D / 2 + 4) * 32;
}

// the tile buffers, or rank 0's merge slots of a cluster of nc blocks
template <int D>
int mma_smem_bytes(int nc) {
  const int tiles = 2 * 2 * MBKV * (D + 8) * 2;
  const int merge = (nc - 1) * kWarpsQ * merge_slot<D>() * 4;
  return tiles > merge ? tiles : merge;
}

// One cluster of nc blocks per (MBQ query rows, head).  Rank r of the
// cluster takes key tiles [r * per, (r + 1) * per); its warp w owns query
// rows 16w .. 16w + 15.  The ranks' (m, l, acc) merge at the end in rank
// 0, in rank order.
template <int D, typename TIn>
__global__ void __launch_bounds__(kMmaThreads, kBlocksPerSm)
flash_attn_mma_kernel(const TIn* __restrict__ q, const TIn* __restrict__ k,
                      const TIn* __restrict__ v, float* __restrict__ out, int T, int n_real,
                      Strides st, float sm_scale, int nc) {
  constexpr int KS = D / 16;   // k-steps of S = q K^T
  constexpr int NS = MBKV / 8;  // 8-key groups of S
  constexpr int ND = D / 8;    // 8-column groups of the output
  // [buffer][K, V][key][column]; rows padded by 16 bytes so that
  // ldmatrix's eight row addresses fall in distinct banks
  extern __shared__ __align__(16) uint8_t smem_mma[];
  auto kv = reinterpret_cast<__nv_bfloat16 (*)[2][MBKV][D + 8]>(smem_mma);

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int h = blockIdx.y, tid = threadIdx.x;
  const int wq = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tg = lane & 3, mi = lane >> 3, rr = lane & 7;
  const int q0 = blockIdx.x / nc * MBQ;
  const int r0 = q0 + wq * 16 + g, r1 = r0 + 8;
  const TIn* qh = q + h * st.q_h;
  const TIn* kh = k + h * st.k_h;
  const TIn* vh = v + h * st.v_h;

  const bool real0 = r0 < n_real, real1 = r1 < n_real;
  const bool all_real = q0 + MBQ <= n_real;
  const int n_tiles = ((all_real ? n_real : T) + MBKV - 1) / MBKV;
  const int per = (n_tiles + nc - 1) / nc;
  const int j_begin = rank * per, n_mine = max(0, min(per, n_tiles - j_begin));

  // bf16(q) as A fragments for the whole key loop; rows at or past T are zeros
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int d = kk * 16 + tg * 2;
    qf[kk][0] = r0 < T ? q_pair(qh + r0 * st.q_t + d) : 0u;
    qf[kk][1] = r1 < T ? q_pair(qh + r1 * st.q_t + d) : 0u;
    qf[kk][2] = r0 < T ? q_pair(qh + r0 * st.q_t + d + 8) : 0u;
    qf[kk][3] = r1 < T ? q_pair(qh + r1 * st.q_t + d + 8) : 0u;
  }

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // m0, m1: running maxima; l0, l1: this thread's share of the
  // row sums (its two key columns of each 8-key group), summed over the
  // quad at the end
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  MmaTileRegs<D, TIn> tile;
  if (n_mine > 0) {
    tile.load(kh, vh, st.k_t, st.v_t, j_begin * MBKV, T);
    tile.store(kv[0][0], kv[0][1]);
  }
  __syncthreads();
  for (int i = 0; i < n_mine; ++i) {
    const int kv0 = (j_begin + i) * MBKV, buf = i & 1;
    const bool more = i + 1 < n_mine;
    if (more) tile.load(kh, vh, st.k_t, st.v_t, kv0 + MBKV, T);
    const __nv_bfloat16 (*Kt)[D + 8] = kv[buf][0];
    const __nv_bfloat16 (*Vt)[D + 8] = kv[buf][1];

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int j = 0; j < NS; j += 2) {
        uint32_t b[4];
        wtt_ldsm_x4(b, &Kt[(j + (mi >> 1)) * 8 + rr][kk * 16 + (mi & 1) * 8]);
        wtt_mma_bf16(s[j], qf[kk], b);
        wtt_mma_bf16(s[j + 1], qf[kk], b + 2);
      }

    float mx0 = -INFINITY, mx1 = -INFINITY;
    if (all_real && kv0 + MBKV <= n_real)
      scale_scores<false>(s, sm_scale, kv0 + tg * 2, T, n_real, real0, real1, mx0, mx1);
    else
      scale_scores<true>(s, sm_scale, kv0 + tg * 2, T, n_real, real0, real1, mx0, mx1);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(WTT_FULL_MASK, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(WTT_FULL_MASK, mx1, off));
    }
    // p = exp(s - m) with expf, as the plain version (the header says why
    // not in base 2); expf(-inf) = 0 on the first tile
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
    l0 = al0 * l0 + sum0;
    l1 = al1 * l1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      acc[j][0] *= al0; acc[j][1] *= al0;
      acc[j][2] *= al1; acc[j][3] *= al1;
    }

    // acc += bf16(p) V: p repacked from S's accumulators as the A operand,
    // 16 keys a k-step; V read with ldmatrix.trans as the B operand
#pragma unroll
    for (int kk = 0; kk < MBKV / 16; ++kk) {
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
    // the other buffer was last read by tile i - 1, before the barrier
    // that ended it
    if (more) tile.store(kv[buf ^ 1][0], kv[buf ^ 1][1]);
    __syncthreads();
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(WTT_FULL_MASK, l0, off);
    l1 += __shfl_xor_sync(WTT_FULL_MASK, l1, off);
  }

  // ranks 1 .. nc - 1 hand (m, l, acc) to rank 0 through its shared memory
  // (its tile buffers, free once the whole cluster is past its tiles),
  // lane-major; rank 0 merges them in rank order, so the result is the
  // same bits from call to call (a rank with no tile has m = -inf, l = 0)
  if (nc > 1) {
    constexpr int SLOT = merge_slot<D>();
    float* mg = reinterpret_cast<float*>(smem_mma);
    cluster.sync();
    if (rank > 0) {
      float* p = cluster.map_shared_rank(mg, 0) + ((rank - 1) * kWarpsQ + wq) * SLOT + lane;
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) p[(4 * j + e) * 32] = acc[j][e];
      p[ND * 128] = m0; p[ND * 128 + 32] = m1;
      p[ND * 128 + 64] = l0; p[ND * 128 + 96] = l1;
    }
    cluster.sync();
    if (rank > 0) return;
    for (int o = 0; o < nc - 1; ++o) {
      const float* p = mg + (o * kWarpsQ + wq) * SLOT + lane;
      const float om0 = p[ND * 128], om1 = p[ND * 128 + 32];
      const float mn0 = fmaxf(m0, om0), mn1 = fmaxf(m1, om1);
      const float a0 = expf(m0 - mn0), b0 = expf(om0 - mn0);
      const float a1 = expf(m1 - mn1), b1 = expf(om1 - mn1);
      l0 = a0 * l0 + b0 * p[ND * 128 + 64];
      l1 = a1 * l1 + b1 * p[ND * 128 + 96];
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc[j][0] = a0 * acc[j][0] + b0 * p[(4 * j) * 32];
        acc[j][1] = a0 * acc[j][1] + b0 * p[(4 * j + 1) * 32];
        acc[j][2] = a1 * acc[j][2] + b1 * p[(4 * j + 2) * 32];
        acc[j][3] = a1 * acc[j][3] + b1 * p[(4 * j + 3) * 32];
      }
      m0 = mn0;
      m1 = mn1;
    }
  }

  // acc[j][e]: row r0 (e < 2) or r1, column 8j + 2tg + (e & 1)
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    const int d = j * 8 + tg * 2;
    if (r0 < T)
      *reinterpret_cast<float2*>(out + h * st.o_h + r0 * st.o_t + d) =
          make_float2(wtt_round_bf16(acc[j][0] / l0), wtt_round_bf16(acc[j][1] / l0));
    if (r1 < T)
      *reinterpret_cast<float2*>(out + h * st.o_h + r1 * st.o_t + d) =
          make_float2(wtt_round_bf16(acc[j][2] / l1), wtt_round_bf16(acc[j][3] / l1));
  }
}

// Blocks per cluster: the most (up to kClusterMax) that keeps the grid
// within kBlocksPerSm blocks an SM (the launch bounds' registers), so that
// every block is resident at once
inline int pick_cluster(int blocks) {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n_sm = 132;
  }
  int nc = 1;
  while (nc < kClusterMax && blocks * nc * 2 <= kBlocksPerSm * n_sm) nc *= 2;
  return nc;
}

template <int D, typename TIn>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* out, int H, int T,
                       int n_real, const Strides& st, float sm_scale, cudaStream_t stream) {
  const int n_qb = (T + MBQ - 1) / MBQ;
  const int nc = pick_cluster(n_qb * H);
  const int smem = mma_smem_bytes<D>(nc);
  static size_t smem_allowed = 0;
  cudaError_t err = wtt_allow_smem(flash_attn_mma_kernel<D, TIn>, smem, &smem_allowed);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_qb * nc, H);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_attn_mma_kernel<D, TIn>, static_cast<const TIn*>(q),
                           static_cast<const TIn*>(k), static_cast<const TIn*>(v),
                           static_cast<float*>(out), T, n_real, st, sm_scale, nc);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Requirements (checked by the Python wrapper): D in {16, 32, 64, 128}; q, k, v of
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
  else if (D == 32 && in_bf16) err = launch_mma<32, __nv_bfloat16>(q, k, v, out, H, T, n_real, st, sm_scale, s);
  else if (D == 32) err = launch_mma<32, float>(q, k, v, out, H, T, n_real, st, sm_scale, s);
  else if (D == 16 && in_bf16) err = launch_mma<16, __nv_bfloat16>(q, k, v, out, H, T, n_real, st, sm_scale, s);
  else if (D == 16) err = launch_mma<16, float>(q, k, v, out, H, T, n_real, st, sm_scale, s);
  return (int)err;
}
