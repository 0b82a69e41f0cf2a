// Decode-step self-attention over the stacked int8 KV cache, one thread-block
// cluster per (row, head).
//
// Replaces the TPU kernel whisper_tpu/ops/decode_attn.py self_attend_q8
// (_kernel): for layer l and every (row b, head h, query g),
//
//   s[a]  = (q . k_codes[a]) * s_k[a] / sqrt(d) + mask[b, g, a]   (f32)
//   p     = softmax(s)                                           (f32)
//   out   = round_dtype(p * s_v) @ v_codes                       (f32 acc)
//
//   kv (L, B, H, 2, C, d) int8 (K at [..., 0, :, :]); scale (L, B, 2, C) f32;
//   q (B, H, G, d) f32 or bf16 through strides (the head view of the fused
//   projection), rounded to the compute type (f32, bf16, or f16 in the
//   parity mode) on load; mask (B, G, A) f32
//   additive over the first A cells; out (B, H, G, d) f32.
//
// What bounds it on an H100: bytes, 57 KB of cache per (b, h) at A = 448,
// d = 64, 1.15 MB per launch at 20 heads: 0.35 us, below the cost of a
// launch.  So the aim is latency: many blocks, one memory round trip each.
//
// Design:
//  * One cluster of NC blocks (8 by default) per (b, h); rank r takes the
//    cells [r n, (r + 1) n), n = ceil(A / NC), for ALL G query rows, so the
//    cache block is read once per launch (not once per query row) by
//    NC x B x H blocks (160 at greedy).  A rank with no cells contributes a
//    max of -inf and a sum of 0.
//  * Each block copies its key and value cells (n x d int8 each) and their
//    scales into shared memory with cp.async copies up front, and loads its
//    query rows and mask in one batched pass meanwhile, so one memory
//    latency covers the block.  Scores: d / 16 lanes per key row, 16 codes each,
//    partial dots met by a shuffle.
//  * The softmax keeps the TPU kernel's rounding points: each rank's max and
//    sum of exponentials are exchanged through distributed shared memory
//    (each rank writes its pair into every rank, then one cluster barrier),
//    so every
//    rank knows the global max and sum over all A cells (the sum rescaled
//    and added in rank order) before it rounds p * s_v to the compute type,
//    exactly where the plain version rounds it.
//  * Each block writes its partial P V (query rows x d, f32) into its own
//    slot of rank 0's shared memory; rank 0 sums the slots in rank order
//    and writes out.  Two cluster barriers per chunk of query rows, one
//    launch, deterministic, no workspace.
//  * Query rows go in chunks of GC = 1, 4 or 16, the least that covers G
//    (a decode step has G = 1, a prompt pass up to 448).
#include "common.cuh"

#include <cuda_fp16.h>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
// room for the (max, sum) pairs of every rank: kMaxCluster x GC <= 16 float2
constexpr int kMlBytes = kMaxCluster * 16 * 8;

struct Args {
  const int8_t* kv;
  const float* scale;
  const void* q;
  long long sqb, sqh, sqg;  // q strides in elements (the last one is 1)
  const float* mask;
  float* out;
  int q_bf16, B, H, G, C, A, l, round_to, nc;
  float inv_sqrt_d;
};

// the compute type's rounding: 0 none (f32), 1 bf16, 2 f16
__device__ __forceinline__ float round_to(float v, int mode) {
  return mode == 1 ? wtt_round_bf16(v) : mode == 2 ? __half2float(__float2half_rn(v)) : v;
}

// GC: query rows per chunk (1 at a decode step, 4 or 16 for prompt passes)
template <int D, int GC>
__global__ void __launch_bounds__(kThreads) self_attend_q8_kernel(const Args a) {
  constexpr int LPR = D / 16;            // lanes per cache row, 16 codes each
  constexpr int RPW = 32 / LPR;          // rows per warp step
  constexpr int DPL = D >= 32 ? D / 32 : 1;  // output dims per lane
  cg::cluster_group cluster = cg::this_cluster();
  const int NC = a.nc;  // blocks per cluster
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.x / NC;
  const int b = bh / a.H, h = bh % a.H;
  const int n = (a.A + NC - 1) / NC;
  const int a0 = rank * n;
  const int na = max(0, min(n, a.A - a0));

  extern __shared__ __align__(16) unsigned char smem[];
  float2* ml = reinterpret_cast<float2*>(smem);         // (NC, GC) max, sum
  int8_t* kc = reinterpret_cast<int8_t*>(smem + kMlBytes);  // (n, D)
  int8_t* vc = kc + (size_t)n * D;                      // (n, D)
  float* sk = reinterpret_cast<float*>(vc + (size_t)n * D);  // (n,)
  float* sv = sk + n;                                   // (n,)
  float* qs = sv + n;                                   // (GC, D)
  float* sc = qs + GC * D;                              // (GC, n) scores, then p
  float* red = sc + GC * n;                             // (warps, GC, D)
  float* part = red + kWarps * GC * D;                  // (NC, GC, D) on rank 0

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int8_t* kb = a.kv + ((((size_t)a.l * a.B + b) * a.H + h) * 2) * (size_t)a.C * D;
  const int8_t* vb = kb + (size_t)a.C * D;
  const float* skg = a.scale + (((size_t)a.l * a.B + b) * 2) * (size_t)a.C;
  const float* svg = skg + a.C;

  for (int i = tid; i < na * LPR; i += kThreads) {
    const size_t off = (size_t)(a0 + i / LPR) * D + (i % LPR) * 16;
    wtt_cp_async16(kc + (size_t)i * 16, kb + off);
    wtt_cp_async16(vc + (size_t)i * 16, vb + off);
  }
  for (int i = tid; i < na; i += kThreads) {
    wtt_cp_async_ca<4>(sk + i, skg + a0 + i);
    wtt_cp_async_ca<4>(sv + i, svg + a0 + i);
  }
  asm volatile("cp.async.commit_group;\n" ::);

  for (int g0 = 0; g0 < a.G; g0 += GC) {
    const int gc = min(GC, a.G - g0);
    // this chunk's query rows (rounded to the compute type) and the mask of
    // its cells, which seeds the scores: one pass, 8 loads in flight
    const int nq = gc * D, nall = nq + gc * na;
    for (int base = tid; base < nall; base += kThreads * 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = base + u * kThreads;
        if (i < nq) {
          const size_t off = (size_t)b * a.sqb + (size_t)h * a.sqh +
                             (size_t)(g0 + i / D) * a.sqg + i % D;
          v[u] = a.q_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.q)[off])
                          : static_cast<const float*>(a.q)[off];
        } else if (i < nall) {
          const int m = i - nq;
          v[u] = a.mask[((size_t)b * a.G + g0 + m / na) * a.A + a0 + m % na];
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = base + u * kThreads;
        if (i < nq) {
          qs[i] = round_to(v[u], a.round_to);
        } else if (i < nall) {
          const int m = i - nq;
          sc[(m / na) * n + m % na] = v[u];
        }
      }
    }
    asm volatile("cp.async.wait_all;\n" ::);
    __syncthreads();

    // scores: LPR lanes per key row, RPW rows per warp step
    {
      const int j = lane % LPR;
      for (int r = warp * RPW + lane / LPR; r < ((na + RPW - 1) / RPW) * RPW;
           r += kWarps * RPW) {
        const bool live = r < na;
        float c[16];
        {
          const int4 w = live ? *reinterpret_cast<const int4*>(kc + (size_t)r * D + j * 16)
                              : make_int4(0, 0, 0, 0);
          const int8_t* e = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
          for (int i = 0; i < 16; ++i) c[i] = (float)e[i];
        }
        for (int g = 0; g < gc; ++g) {
          const float* qg = qs + g * D + j * 16;
          float s = 0.f;
#pragma unroll
          for (int i = 0; i < 16; ++i) s = fmaf(qg[i], c[i], s);
#pragma unroll
          for (int off = 1; off < LPR; off <<= 1) s += __shfl_xor_sync(WTT_FULL_MASK, s, off);
          if (live && j == 0)
            sc[g * n + r] = __fadd_rn(__fmul_rn(__fmul_rn(s, sk[r]), a.inv_sqrt_d), sc[g * n + r]);
        }
      }
    }
    __syncthreads();

    // this block's max m_r and sum l_r = sum(exp(s - m_r)) per query row,
    // exchanged over the cluster; the global max M and sum
    // S = sum_r l_r exp(m_r - M) (in rank order) are known before any p
    for (int g = warp; g < gc; g += kWarps) {
      float m = -INFINITY;
      for (int i = lane; i < na; i += 32) m = fmaxf(m, sc[g * n + i]);
      m = wtt_warp_max(m);
      float l = 0.f;
      if (m != -INFINITY)
        for (int i = lane; i < na; i += 32) l += expf(sc[g * n + i] - m);
      l = wtt_warp_sum(l);
      // pushed into slot `rank` of every rank's pairs: reads stay local
      if (lane < NC) *cluster.map_shared_rank(ml + rank * GC + g, lane) = make_float2(m, l);
    }
    cluster.sync();
    for (int g = warp; g < gc; g += kWarps) {
      const float2 mine = lane < NC ? ml[lane * GC + g] : make_float2(-INFINITY, 0.f);
      // every row has a visible cell; guard the max anyway so a fully
      // masked row gives no (-inf) - (-inf)
      float M = wtt_warp_max(mine.x);
      if (M == -INFINITY) M = 0.f;
      const float part_l = mine.x == -INFINITY ? 0.f : mine.y * expf(mine.x - M);
      float S = 0.f;
      for (int r = 0; r < NC; ++r) S += __shfl_sync(WTT_FULL_MASK, part_l, r);
      for (int i = lane; i < na; i += 32) {
        const float p = expf(sc[g * n + i] - M) / S * sv[i];
        sc[g * n + i] = round_to(p, a.round_to);
      }
    }
    __syncthreads();

    // P V over this block's cells: warp w takes cells w, w + 4, ...; lane
    // owns DPL adjacent output dims
    {
      float acc[GC][DPL];
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[g][e] = 0.f;
      const bool owner = lane * DPL < D;
      for (int i = warp; i < na; i += kWarps) {
        float v[DPL];
        const int8_t* vr = vc + (size_t)i * D + lane * DPL;
#pragma unroll
        for (int e = 0; e < DPL; ++e) v[e] = owner ? (float)vr[e] : 0.f;
#pragma unroll
        for (int g = 0; g < GC; ++g) {
          if (g < gc) {
            const float p = sc[g * n + i];
#pragma unroll
            for (int e = 0; e < DPL; ++e) acc[g][e] = fmaf(p, v[e], acc[g][e]);
          }
        }
      }
      if (owner) {
#pragma unroll
        for (int g = 0; g < GC; ++g)
#pragma unroll
          for (int e = 0; e < DPL; ++e) red[(warp * GC + g) * D + lane * DPL + e] = acc[g][e];
      }
    }
    __syncthreads();
    // this block's P V, warps summed in order, into its slot on rank 0
    float* part0 = cluster.map_shared_rank(part, 0) + (size_t)rank * GC * D;
    for (int i = tid; i < gc * D; i += kThreads) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += red[w * GC * D + i];
      part0[i] = o;
    }
    // every slot is written; rank 0 sums the ranks in order.  Its reads end
    // before it reaches the next chunk's first barrier, and no rank writes
    // part or ml again before passing that barrier
    cluster.sync();
    if (rank == 0) {
      for (int i = tid; i < gc * D; i += kThreads) {
        float o = 0.f;
        for (int r = 0; r < NC; ++r) o += part[(size_t)r * GC * D + i];
        const int g = i / D, d = i % D;
        a.out[(((size_t)b * a.H + h) * a.G + g0 + g) * D + d] = o;
      }
    }
  }
}

template <int D, int GC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int nc = a.nc;
  const int n = (a.A + nc - 1) / nc;
  const size_t smem = 2 * (size_t)n * D +
                      sizeof(float) * (2 * (size_t)n + GC * D + (size_t)GC * n +
                                       (size_t)kWarps * GC * D + (size_t)nc * GC * D) +
                      kMlBytes;
  static size_t smem_allowed = 0;
  cudaError_t err = wtt_allow_smem(self_attend_q8_kernel<D, GC>, smem, &smem_allowed);
  if (err != cudaSuccess) return err;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.H * nc);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, self_attend_q8_kernel<D, GC>, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// Requirements (checked by the Python wrapper): D in {16, 32, 64, 128},
// 1 <= A <= C, 0 <= l < L, cluster in {1, 2, 4, 8}; kv, scale, mask and out
// contiguous, q's last stride 1.
extern "C" int wtt_self_attend_q8(const void* kv, const void* scale, const void* q,
                                  int q_bf16, long long sqb, long long sqh, long long sqg,
                                  const void* mask, void* out, int B, int H, int G, int C,
                                  int D, int A, int l, int round_to, int cluster,
                                  void* stream) {
  Args a;
  a.kv = static_cast<const int8_t*>(kv);
  a.scale = static_cast<const float*>(scale);
  a.q = q;
  a.sqb = sqb; a.sqh = sqh; a.sqg = sqg;
  a.mask = static_cast<const float*>(mask);
  a.out = static_cast<float*>(out);
  a.q_bf16 = q_bf16; a.B = B; a.H = H; a.G = G; a.C = C; a.A = A; a.l = l;
  a.round_to = round_to;
  a.nc = cluster;
  a.inv_sqrt_d = 1.0f / sqrtf((float)D);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D * 100 + (G <= 1 ? 1 : G <= 4 ? 4 : 16)) {
    case 1601: err = launch<16, 1>(a, s); break;
    case 1604: err = launch<16, 4>(a, s); break;
    case 1616: err = launch<16, 16>(a, s); break;
    case 3201: err = launch<32, 1>(a, s); break;
    case 3204: err = launch<32, 4>(a, s); break;
    case 3216: err = launch<32, 16>(a, s); break;
    case 6401: err = launch<64, 1>(a, s); break;
    case 6404: err = launch<64, 4>(a, s); break;
    case 6416: err = launch<64, 16>(a, s); break;
    case 12801: err = launch<128, 1>(a, s); break;
    case 12804: err = launch<128, 4>(a, s); break;
    default: err = launch<128, 16>(a, s); break;
  }
  return (int)err;
}
