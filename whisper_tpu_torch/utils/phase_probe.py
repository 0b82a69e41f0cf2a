"""Where a launch of the decode matmul (csrc/qmmt.cu, its FMA route and its
many-row route), of the decode attention (csrc/decode_attn.cu) or of the
flash attention's heads of 16 and 32 (csrc/flash_attn.cu
flash_attn_mma_kernel) spends its time, block by block.

    python -m whisper_tpu_torch.utils.phase_probe            # on the card
    PROBE=fixup python -m whisper_tpu_torch.utils.phase_probe  # K1's fix-up
    PROBE=flash python -m whisper_tpu_torch.utils.phase_probe  # K6, D = 32 and 16
    PROBE=rows python -m whisper_tpu_torch.utils.phase_probe   # K1/K2's many rows

It copies each source into whisper_tpu_torch/build/, stamps thread 0 of
every block with clock64() and %globaltimer at fixed points of the kernel
(each point named by a line of the source it precedes or follows, so a
changed source fails loudly here), builds the copy with the package's nvcc
flags, and runs it once after three warm-up calls at large-v3-turbo
shapes.  For each launch it prints the spread of the blocks' start times
and, per point, the microseconds since the block started (p50, p90, max;
clock64 read at 1.755 GHz).  The kernels of the package are not changed.
"""
import ctypes
import os
import subprocess

import numpy as np
import torch

from ..formats import quants as Q
from ..ops import _cuda
from ..ops import decode_attn as DA
from ..ops import qmm as QM

CS = str(_cuda.CSRC)

PH = ('if (threadIdx.x == 0 && g_stamps) {{ unsigned long long t_ = clock64(), g_; '
      'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_)); '
      'size_t o_ = (((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x) * 16; '
      'g_stamps[o_ + {i}] = t_; g_stamps[o_ + 8 + {i}] = g_; }}\n')
HEAD = ('#include "common.cuh"\n__device__ unsigned long long* g_stamps;\n'
        'extern "C" int wtt_set_stamps(void* p) { return (int)cudaMemcpyToSymbol('
        'g_stamps, &p, sizeof(p)); }\n')


def patch(src, points):
    inc = next(f'#include "{h}"\n' for h in ("tma.cuh", "wgmma.cuh", "common.cuh")
               if f'#include "{h}"\n' in src)
    s = src.replace(inc, HEAD.replace('#include "common.cuh"\n', inc), 1)
    for i, (anchor, after) in enumerate(points):
        assert anchor in s, anchor
        s = s.replace(anchor, anchor + PH.format(i=i) if after else PH.format(i=i) + anchor, 1)
    return s


K1 = [
    ("  const int col_base = tile * BC;\n", True),
    ("  float lw[kPerThread], lb[kPerThread];\n", False),
    ("#pragma unroll\n    for (int u = 0; u < kPerThread; ++u) {\n      const int kk = tid + u * kThreads;\n      if (kk < kn) {", False),
    ('      asm volatile("cp.async.wait_group 1;\\n" ::);\n      __syncthreads();\n', True),
    ("    for (; b < nbs; b += kWarps) product(b);\n", True),
    ("  if (n_slices == 1) return;\n", False),
    ("  if (!is_last) return;\n", True),
    ("  if (tid == 0) a.counters[tile] = 0;\n", False),
]
K1F = [
    ("  const int col_base = tile * BC;\n", True),
    ("  float* fx = reinterpret_cast<float*>(body);\n", False),
    ("    __syncthreads();\n    for (int i = tid; i < nr * BC; i += kThreads) {", False),
    ("            epilogue(a, ep, y, r0 + i / BC, i % BC, col);\n    }\n", True),
    ("  if (tid == 0) a.counters[tile] = 0;\n", False),
    ("  if (!is_last) return;\n", True),
]
# K1/K2's many-row route (qmmt_rows_kernel), thread 0 of each block (a
# consumer): the start, the row pass's end (griddepcontrol.wait), then in
# the last iteration its stage published and its products retired and
# scaled, the loop's end, the fix-up's start and end
KR = [
    ("  const int tid = threadIdx.x, wg = tid >> 7, lt = tid & 127;\n", True),
    ('    asm volatile("griddepcontrol.wait;\\n" ::: "memory");\n    const int warp = lt >> 5', False),
    ("      mbar_wait(&full[it % S], (it / S) & 1);\n", True),
    ("      // the stage (and a converted chunk taken in turn) is consumed: one\n", False),
    ("    if (n_slices > 1) {\n      // split-K fix-up", False),
    ("      if (!is_last) return;\n", True),
    ("      if (tid == 0) a.counters[unit] = 0;\n", False),
]
K3 = [
    ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n", True),
    ('    asm volatile("cp.async.wait_all;\\n" ::);\n    __syncthreads();\n', True),
    ("    // this block's max m_r and sum l_r = sum(exp(s - m_r)) per query row,\n", False),
    ("      const float2 mine = lane < NC ? ml[lane * GC + g] : make_float2(-INFINITY, 0.f);\n", False),
    ("    // P V over this block's cells", False),
    ("    // this block's P V, warps summed in order", False),
    ("    if (rank == 0) {\n      for (int i = tid; i < gc * D; i += kThreads) {", False),
    ("  }\n}\n\ntemplate <int D, int GC>", False),
]

# K6 at D <= 32, thread 0 of each block: the prologue (q fragments, first
# tile), then the last key tile's steps (next tile's loads issued, S = q
# K^T issued, the softmax, P V issued, the next tile stored and the block
# barrier), then the cluster's merge and the output (rank 0)
K6 = [
    ("  const int j_begin = rank * per, n_mine = max(0, min(per, n_tiles - j_begin));\n", True),
    ("  for (int i = 0; i < n_mine; ++i) {\n", False),
    ("    const __nv_bfloat16 (*Vt)[D + 8] = kv[buf][1];\n", True),
    ("    if (all_real && kv0 + MBKV <= n_real)\n", False),
    ("    // acc += bf16(p) V: p repacked", False),
    ("    // the other buffer was last read by tile i - 1", False),
    ("#pragma unroll\n  for (int off = 1; off < 4; off <<= 1) {\n    l0 += __shfl_xor_sync", False),
    ("          make_float2(wtt_round_bf16(acc[j][2] / l1), wtt_round_bf16(acc[j][3] / l1));\n  }\n", True),
]


def build(name, points):
    with open(os.path.join(CS, name + ".cu")) as f:
        src = f.read()
    _cuda.BUILD.mkdir(parents=True, exist_ok=True)
    out = str(_cuda.BUILD / f"{name}_probe.cu")
    with open(out, "w") as f:
        f.write(patch(src, points))
    so = str(_cuda.BUILD / f"{name}_probe.so")
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS[:-2], "-I", CS, "-o", so, out], check=True)
    lib = _cuda._bind(name, ctypes.CDLL(so))
    lib.wtt_set_stamps.argtypes = [ctypes.c_void_p]
    return lib


def report(tag, st, nblk):
    st = st[:nblk].astype(np.int64)
    clk, gt = st[:, :8], st[:, 8:]
    ok = clk[:, 0] > 0
    clk, gt = clk[ok], gt[ok]
    g0 = gt[:, 0].min()
    starts = (gt[:, 0] - g0) / 1e3
    print(f"{tag}: blocks={ok.sum()} start spread us: p50={np.median(starts):.2f} "
          f"max={starts.max():.2f}; last stamp us={(gt.max() - g0) / 1e3:.2f}")
    for i in range(1, 8):
        have = clk[:, i] > 0
        if have.any():
            d = (clk[have, i] - clk[have, 0]) / 1.755e3
            print(f"   phase {i}: n={have.sum()} us since block start p50={np.median(d):.2f} "
                  f"p90={np.percentile(d, 90):.2f} max={d.max():.2f}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("phase_probe: no CUDA card")
    dev = torch.device("cuda")
    buf = torch.zeros(16 * 8192, dtype=torch.int64, device=dev)
    if os.environ.get("PROBE") == "flash":
        return probe_flash(dev, buf)
    if os.environ.get("PROBE") == "rows":
        return probe_rows(dev, buf)
    lib1 = build("qmmt", K1F if os.environ.get("PROBE") == "fixup" else K1)
    lib1.wtt_set_stamps(buf.data_ptr())
    _cuda._LIBS["qmmt"] = lib1
    g = torch.Generator().manual_seed(0)
    for name, T, K, R, ln, res in (("o", 1, 1280, 1280, False, True), ("xq", 1, 1280, 1280, True, False),
                                   ("mlp1", 1, 5120, 1280, False, True),
                                   ("logits", 1, 1280, 51866, True, False),
                                   ("o", 5, 1280, 1280, False, True),
                                   ("logits", 5, 1280, 51866, True, False)):
        w = torch.randn((R, K), generator=g).numpy()
        p = Q.unpack_to_planes(Q.quantize(w, Q.GGML_TYPE_Q5_0), Q.GGML_TYPE_Q5_0, (R, K))
        qw = QM.pitch_qweight_t(p.codes.T, p.scales.T, device=dev)
        x = torch.randn((T, K), generator=g).to(dev)
        kw = dict(ln_w=torch.ones(K, device=dev), ln_b=torch.zeros(K, device=dev)) if ln else {}
        if res:
            kw["residual"] = torch.randn((T, R), generator=g).to(dev)
        # the FMA route (both rows counts are below QM.MMA_MIN_T)
        for _ in range(3):
            QM.qmmt_fused(x, qw.codes_t, qw.scales_t, bias=torch.zeros(R, device=dev), **kw)
        torch.cuda.synchronize()
        buf.zero_()
        QM.qmmt_fused(x, qw.codes_t, qw.scales_t, bias=torch.zeros(R, device=dev), **kw)
        torch.cuda.synchronize()
        nblk = -(-R // 64) * -(-K // QM.slice_rows(K, R, 32, 132, T))
        report(f"qmmt {name} T={T} fma", buf.view(-1, 16).cpu().numpy(), nblk)

    lib3 = build("decode_attn", K3)
    lib3.wtt_set_stamps(buf.data_ptr())
    _cuda._LIBS["decode_attn"] = lib3
    for B in (1, 5):
        L, H, C, D, A = 4, 20, 448, 64, 448
        kv = torch.randint(-127, 128, (L, B, H, 2, C, D), generator=g, dtype=torch.int8).to(dev)
        scale = (0.01 + 0.02 * torch.rand((L, B, 2, C), generator=g)).to(dev)
        q = torch.randn((B, H, 1, D), generator=g).to(dev)
        mask = torch.zeros((B, 1, A), device=dev)
        for _ in range(3):
            DA.self_attend_q8(kv, scale, q, mask, l=3, attn_ctx=A)
        torch.cuda.synchronize()
        buf.zero_()
        DA.self_attend_q8(kv, scale, q, mask, l=3, attn_ctx=A)
        torch.cuda.synchronize()
        report(f"self_attend_q8 B={B}", buf.view(-1, 16).cpu().numpy(), B * H * DA.CLUSTER)


def probe_rows(dev, buf):
    """K1/K2's many-row route at chip_smoke.py phase 3's shapes (turbo
    widths, q5_0): a DTW pass's o projection (T = 32 and 128, no prologue),
    a batched step's mlp1 (T = 8), the prompt pass's qkv (T = 128) and
    logits head (T = 1024).  Phases 2 and 3 are the last iteration's."""
    lib = build("qmmt", KR)
    lib.wtt_set_stamps(buf.data_ptr())
    _cuda._LIBS["qmmt"] = lib
    g = torch.Generator().manual_seed(0)
    for name, T, K, R, ln in (("o", 32, 1280, 1280, False), ("o", 128, 1280, 1280, False),
                              ("mlp1", 8, 5120, 1280, False), ("qkv", 128, 1280, 3840, True),
                              ("logits", 1024, 1280, 51866, True)):
        w = torch.randn((R, K), generator=g).numpy()
        p = Q.unpack_to_planes(Q.quantize(w, Q.GGML_TYPE_Q5_0), Q.GGML_TYPE_Q5_0, (R, K))
        qw = QM.pitch_qweight_t(p.codes.T, p.scales.T, device=dev)
        x = torch.randn((T, K), generator=g).to(dev)
        kw = dict(ln_w=torch.ones(K, device=dev), ln_b=torch.zeros(K, device=dev)) if ln else {}
        for _ in range(3):
            QM.qmmt_fused(x, qw.codes_t, qw.scales_t, **kw)
        torch.cuda.synchronize()
        buf.zero_()
        QM.qmmt_fused(x, qw.codes_t, qw.scales_t, **kw)
        torch.cuda.synchronize()
        plan = QM.rows_plan(T, K, R, 32, torch.cuda.get_device_properties(dev).multi_processor_count)
        nblk = -(-R // QM.TILE) * plan.slices * plan.groups
        report(f"qmmt_rows {name} T={T} {tuple(plan)}", buf.view(-1, 16).cpu().numpy(), nblk)


def probe_flash(dev, buf):
    """K6 at chip_smoke.py phase 3's small shapes (T = 1536, 1500 real, head
    views of the f32 projection): phases 2-5 are the last key tile's."""
    from ..ops import attention as FA

    lib = build("flash_attn", K6)
    lib.wtt_set_stamps(buf.data_ptr())
    _cuda._LIBS["flash_attn"] = lib
    T, true_len = 1536, 1500
    for h, d in ((2, 32), (6, 16)):
        qkv = torch.randn((T, 3 * h * d), generator=torch.Generator().manual_seed(4)).to(dev)
        views = [qkv[:, i * h * d:(i + 1) * h * d].reshape(T, h, d).transpose(0, 1)
                 for i in range(3)]
        for _ in range(3):
            FA.flash_self_attention(*views, true_len=true_len)
        torch.cuda.synchronize()
        buf.zero_()
        FA.flash_self_attention(*views, true_len=true_len)
        torch.cuda.synchronize()
        # every block of every cluster stamps; unused slots stay zero
        report(f"flash_attn_mma_kernel H={h} D={d}", buf.view(-1, 16).cpu().numpy(),
               buf.numel() // 16)


if __name__ == "__main__":
    main()
