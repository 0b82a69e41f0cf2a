#!/usr/bin/env python3
"""Smoke run of whisper_tpu_torch, the PyTorch/CUDA port, on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card: name, count, power limit, torch and CUDA versions;
  2. build the Hopper kernels from whisper_tpu_torch/csrc with nvcc, with
     each kernel's registers, shared memory and spills;
  3. each kernel against its plain PyTorch version on the card at the
     shapes its path gives it (large-v3-turbo; whisper-bench -w 2's 4096^3
     for qmm), max error beside its tolerance, then device times of the
     kernel, the plain version and a library yardstick, with the least
     time the card could take;
  4. the paths, each with every launch count set to 0 just before it and
     read just after: a q5_0 large-v3-turbo file written from a seed,
     `whisper_tpu_torch.load()` + `transcribe()` of 40 s of seeded audio
     with default parameters (kv cache q8, then f16), one 30 s window of
     the q8 context under torch.profiler (device busy share, device time by
     kernel), one 30 s encode on the flash route (WTPU_ENC_ATTN=flash)
     against the fused-QKV route, the port's whisper-cli at its default
     flags (beam search 5, best-of 5) on the same file and audio as a wav
     (kv cache f16, then q8), and whisper-bench -w 1 and -w 2;
  5. the slice on the card against the slice on the CPU, on a small
     decisive model: identical segments, greedy and beam search, on the
     fused-QKV and the flash encoder routes and on -nfa's plain graphs.

The last lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOP_PER_S = 989e12         # H100 SXM dense bf16 tensor-core peak
L2_ROTATE_BYTES = 160 * 2**20    # rotate input copies past the 50 MB L2


def log(*a):
    print(*a, flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]


def device_ms(make_call, bytes_per_call: int, reps: int = 20) -> float:
    """Device time of one call: `make_call(i)` returns a thunk on the i-th
    copy of the inputs; copies rotate so the working set exceeds L2, and
    the launches replay from a CUDA graph so host overhead is not timed."""
    n = max(1, min(64, math.ceil(L2_ROTATE_BYTES / max(bytes_per_call, 1))))
    calls = [make_call(i) for i in range(n)]
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for c in calls:                       # warm-up outside the graph
            c()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for c in calls:
            c()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * n)


def bound_ms(nbytes: int, flops: float) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions, and their times
# ---------------------------------------------------------------------------

def check_qmmt(dev, Q, QM):
    """K1 (qmmt_fused) per decode-path use, and K2 (qmmt), at turbo widths."""
    S = 1280
    cases = [  # name, T, K, R, ln, bias, act, res, launches per decode step
        ("qkv", 1, S, 3 * S, True, True, None, False, 4),
        ("o", 1, S, S, False, True, None, True, 4),
        ("xq", 1, S, S, True, True, None, False, 4),
        ("xo", 1, S, S, False, True, None, True, 4),
        ("mlp0", 1, S, 4 * S, True, True, "gelu", False, 4),
        ("mlp1", 1, 4 * S, S, False, True, None, True, 4),
        ("logits", 1, S, 51866, True, False, None, False, 1),
        ("qkv_prompt4", 4, S, 3 * S, True, True, None, False, 0),
        ("logits_prompt4", 4, S, 51866, True, False, None, False, 0),
        ("qmmt", 1, S, 3 * S, False, False, None, False, 0),
    ]
    g = torch.Generator().manual_seed(0)
    agg = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, err=0.0, bytes=0, flops=0)
           for k in ("qmmt_fused", "qmmt")}
    for name, T, K, R, ln, bias, act, res, per_step in cases:
        w = torch.randn((R, K), generator=g).numpy()
        p = Q.unpack_to_planes(Q.quantize(w, Q.GGML_TYPE_Q5_0), Q.GGML_TYPE_Q5_0, (R, K))
        codes = torch.from_numpy(np.ascontiguousarray(p.codes.T)).to(dev)
        scales = torch.from_numpy(np.ascontiguousarray(p.scales.T)).to(dev)
        rnd = lambda *s: torch.randn(s, generator=g).to(dev)
        x = rnd(T, K)
        kw = dict(ln_w=rnd(K) if ln else None, ln_b=rnd(K) if ln else None,
                  bias=rnd(R) if bias else None, residual=rnd(T, R) if res else None,
                  act=act, dtype=torch.bfloat16)
        kernel = QM.qmmt if name == "qmmt" else QM.qmmt_fused
        y = kernel(x, codes, scales, **({"dtype": torch.bfloat16} if name == "qmmt" else kw))
        ref = QM.qmmt_fused_plain(x, codes, scales, **kw)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item()
        log(f"  check {kernel.__name__}[{name}] T={T} K={K} R={R}: "
            f"max_abs_err={err:.3e} tol={tol:.3e}")
        assert math.isfinite(err) and err <= tol, name

        nb = K // 32
        nbytes = (K * R + nb * R * 4 + T * K * 4 + T * R * 4
                  + (2 * K * 4 if ln else 0) + (R * 4 if bias else 0)
                  + (T * R * 4 if res else 0))
        flops = 2.0 * T * K * R
        copies = {}

        def planes(i):
            if i not in copies:
                copies[i] = (codes.clone(), scales.clone())
            return copies[i]

        def run_kernel(i):
            c, s = planes(i)
            if name == "qmmt":
                return lambda: QM.qmmt(x, c, s, dtype=torch.bfloat16)
            return lambda: QM.qmmt_fused(x, c, s, **kw)

        def run_plain(i):
            c, s = planes(i)
            return lambda: QM.qmmt_fused_plain(x, c, s, **kw)

        wdq = (codes.float() * scales.repeat_interleave(32, 0)).to(torch.bfloat16)
        xb = x.to(torch.bfloat16)
        wcopies = {}

        def run_library(i):
            # cuBLAS on a bf16-dequantized weight (the product alone)
            if i not in wcopies:
                wcopies[i] = wdq.clone()
            wi = wcopies[i]
            return lambda: torch.mm(xb, wi, out_dtype=torch.float32)

        ms = device_ms(run_kernel, nbytes)
        plain_ms = device_ms(run_plain, nbytes)
        library_ms = device_ms(run_library, 2 * K * R)
        copies.clear()
        wcopies.clear()
        b_ms, by = bound_ms(nbytes, flops)
        log(f"  time  {kernel.__name__}[{name}]: kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
            f"library_ms={library_ms:.5f} bound_ms={b_ms:.5f} ({by}) "
            f"launches_per_step={per_step}")
        a = agg[kernel.__name__]
        a["err"] = max(a["err"], err)
        weight = per_step if kernel is QM.qmmt_fused else 1
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms)):
            a[k] += weight * v
        a["bytes"] += weight * nbytes
        a["flops"] += weight * flops
    return agg


def check_self_attend_q8(dev, DA):
    """K3 at turbo widths: G = 1 (a decode step) and G = 4 (a prompt
    bucket) for every attention bucket A."""
    L, B, H, C, D = 4, 1, 20, 448, 64
    g = torch.Generator().manual_seed(1)
    kv = torch.randint(-127, 128, (L, B, H, 2, C, D), generator=g, dtype=torch.int8).to(dev)
    scale = (0.01 + 0.02 * torch.rand((L, B, 2, C), generator=g)).to(dev)
    agg = None
    err_max = 0.0
    for G in (1, 4):
        for A in (128, 256, 384, 448):
            q = torch.randn((B, H, G, D), generator=g).to(dev)
            vis = torch.arange(A)[None, :] < (A - G + torch.arange(G) + 1)[:, None]
            mask = torch.where(vis, 0.0, float("-inf")).expand(B, G, A).contiguous().to(dev)
            out = DA.self_attend_q8(kv, scale, q, mask, l=L - 1, attn_ctx=A)
            ref = DA.self_attend_q8_plain(kv, scale, q, mask, l=L - 1, attn_ctx=A)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = 2e-2 * ref.abs().max().item()
            log(f"  check self_attend_q8[G={G},A={A}]: max_abs_err={err:.3e} tol={tol:.3e}")
            assert math.isfinite(err) and err <= tol
            err_max = max(err_max, err)
            nbytes = (2 * B * H * A * D + 2 * B * A * 4 + B * H * G * D * 2
                      + B * G * A * 4 + B * H * G * D * 4)
            flops = 4.0 * B * H * G * A * D
            caches = {}

            def cache(i):
                if i not in caches:
                    caches[i] = (kv.clone(), scale.clone())
                return caches[i]

            def run_kernel(i):
                k, s = cache(i)
                return lambda: DA.self_attend_q8(k, s, q, mask, l=L - 1, attn_ctx=A)

            def run_plain(i):
                k, s = cache(i)
                return lambda: DA.self_attend_q8_plain(k, s, q, mask, l=L - 1, attn_ctx=A)

            kd = (kv[L - 1, :, :, 0, :A].float() * scale[L - 1, :, None, 0, :A, None]
                  ).to(torch.bfloat16)
            vd = (kv[L - 1, :, :, 1, :A].float() * scale[L - 1, :, None, 1, :A, None]
                  ).to(torch.bfloat16)
            qb, mb = q.to(torch.bfloat16), mask[:, None].to(torch.bfloat16)
            lib = {}

            def run_library(i):
                if i not in lib:
                    lib[i] = (kd.clone(), vd.clone())
                k, v = lib[i]
                return lambda: torch.nn.functional.scaled_dot_product_attention(
                    qb, k, v, attn_mask=mb)

            ms = device_ms(run_kernel, nbytes)
            plain_ms = device_ms(run_plain, nbytes)
            library_ms = device_ms(run_library, 2 * B * H * A * D * 2)
            caches.clear()
            lib.clear()
            b_ms, by = bound_ms(nbytes, flops)
            per_step = 4 if G == 1 else 0
            log(f"  time  self_attend_q8[G={G},A={A}]: kernel_ms={ms:.5f} "
                f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
                f"bound_ms={b_ms:.5f} ({by}) launches_per_step={per_step}")
            if G == 1 and A == 448:
                # the JSON row: one decode step's 4 layers at the largest bucket
                agg = dict(ms=4 * ms, plain_ms=4 * plain_ms, library_ms=4 * library_ms,
                           bytes=4 * nbytes, flops=4 * flops)
    agg["err"] = err_max
    return agg


def check_qmm(dev, QM):
    """K5 at whisper-bench -w 2's shape: 4096^3, codes in [-16, 16) with
    per-32 scales, f32 activations as the bench chain feeds them."""
    N = 4096
    g = torch.Generator().manual_seed(3)
    x = torch.randn((N, N), generator=g).to(dev)
    codes = torch.randint(-16, 16, (N, N), generator=g, dtype=torch.int8).to(dev)
    scales = (0.02 * torch.rand((N, N // 32), generator=g)).to(dev)
    y = QM.qmm(x, codes, scales)
    ref = QM.qmm_plain(x, codes, scales)
    torch.cuda.synchronize()
    err = (y - ref).abs().max().item()
    tol = 1e-4 * ref.abs().max().item()
    log(f"  check qmm[T=K=R={N}]: max_abs_err={err:.3e} tol={tol:.3e}")
    assert math.isfinite(err) and err <= tol
    # x (f32) and codes read once, scales once, the f32 output written once
    nbytes = N * N * 4 + N * N + N * (N // 32) * 4 + N * N * 4
    flops = 2.0 * N ** 3
    planes = {}

    def plane(i):
        if i not in planes:
            planes[i] = (codes.clone(), scales.clone())
        return planes[i]

    def run_kernel(i):
        c, sc = plane(i)
        return lambda: QM.qmm(x, c, sc)

    def run_plain(i):
        c, sc = plane(i)
        return lambda: QM.qmm_plain(x, c, sc)

    # cuBLAS on bf16 x and the bf16-dequantized weight, f32 out
    wdq = (codes.float() * scales.to(torch.bfloat16).float().repeat_interleave(32, 1)
           ).to(torch.bfloat16)
    xb = x.to(torch.bfloat16)
    lib = {}

    def run_library(i):
        if i not in lib:
            lib[i] = wdq.clone()
        w = lib[i]
        return lambda: torch.mm(xb, w.T, out_dtype=torch.float32)

    ms = device_ms(run_kernel, nbytes)
    plain_ms = device_ms(run_plain, nbytes)
    library_ms = device_ms(run_library, 2 * N * N * 2)
    planes.clear()
    lib.clear()
    b_ms, by = bound_ms(nbytes, flops)
    log(f"  time  qmm[T=K=R={N}]: kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
        f"library_ms={library_ms:.5f} bound_ms={b_ms:.5f} ({by}) "
        f"tflops={flops / ms / 1e9:.2f}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bytes=nbytes,
                flops=flops, err=err)


def check_flash(dev, FA):
    """K6 at turbo widths: H = 20 heads of 64, T = 1536 with 1500 real rows,
    q, k and v passed as head views of the encoder's f32 (T, 3S) projection.
    Real rows are compared; pad rows are junk."""
    T, true_len, H, D = 1536, 1500, 20, 64
    S = H * D
    g = torch.Generator().manual_seed(4)
    qkv = torch.randn((T, 3 * S), generator=g).to(dev)

    def views(buf):
        return [buf[:, i * S:(i + 1) * S].reshape(T, H, D).transpose(0, 1)
                for i in range(3)]

    out = FA.flash_self_attention(*views(qkv), true_len=true_len)
    ref = FA.flash_self_attention_plain(*views(qkv), true_len=true_len)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    err = (out[:, :true_len] - ref[:, :true_len]).abs().max().item()
    tol = 2e-2
    log(f"  check flash_self_attention[H={H},T={T},true_len={true_len},D={D}]: "
        f"max_abs_err={err:.3e} tol={tol:.3e} (real rows)")
    assert math.isfinite(err) and err <= tol
    # q, k, v read once (f32), the f32 output written once; the work is the
    # two segments: real rows against real keys, pad rows against pad keys
    nbytes = 3 * T * S * 4 + T * S * 4
    flops = 4.0 * H * D * (true_len ** 2 + (T - true_len) ** 2)
    bufs = {}

    def buf(i):
        if i not in bufs:
            bufs[i] = views(qkv.clone())
        return bufs[i]

    def run_kernel(i):
        q, k, v = buf(i)
        return lambda: FA.flash_self_attention(q, k, v, true_len=true_len)

    def run_plain(i):
        q, k, v = buf(i)
        return lambda: FA.flash_self_attention_plain(q, k, v, true_len=true_len)

    heads = [h.to(torch.bfloat16).contiguous() for h in views(qkv)]
    real = torch.arange(T, device=dev) < true_len
    allow = real[:, None] == real[None, :]
    lib = {}

    def run_library(i):
        if i not in lib:
            lib[i] = [h.clone() for h in heads]
        q, k, v = lib[i]
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=allow)

    ms = device_ms(run_kernel, nbytes)
    plain_ms = device_ms(run_plain, nbytes)
    library_ms = device_ms(run_library, 4 * T * S * 2)
    bufs.clear()
    lib.clear()
    b_ms, by = bound_ms(nbytes, flops)
    log(f"  time  flash_self_attention[T={T}]: kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
        f"library_ms={library_ms:.5f} bound_ms={b_ms:.5f} ({by}) launches_per_encode=32")
    # the JSON row: one encode's 32 layers, as K4's
    return dict(ms=32 * ms, plain_ms=32 * plain_ms, library_ms=32 * library_ms,
                bytes=32 * nbytes, flops=32 * flops, err=err)


def check_self_attention_qkv(dev, EA):
    """K4 at turbo widths: T = 1536 (1500 padded), S = 1280, 20 heads of 64."""
    T, true_len, H, D = 1536, 1500, 20, 64
    S = H * D
    g = torch.Generator().manual_seed(2)
    qkv = torch.randn((T, 3 * S), generator=g).to(dev)
    out = EA.self_attention_qkv(qkv, H, true_len=true_len)
    ref = EA.self_attention_qkv_plain(qkv, H, true_len=true_len)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    tol = 2e-2 * ref.float().abs().max().item()
    log(f"  check self_attention_qkv[T={T},true_len={true_len}]: "
        f"max_abs_err={err:.3e} tol={tol:.3e}")
    assert math.isfinite(err) and err <= tol
    qkvb = qkv.to(torch.bfloat16)
    # key columns at or past true_len add exactly 0 to the output, so the
    # work the function needs reads k and v for true_len rows only; q and
    # the output keep all T rows
    nbytes = T * S * 2 + 2 * true_len * S * 2 + T * S * 2
    flops = 4.0 * T * true_len * S
    bufs = {}

    def buf(i):
        if i not in bufs:
            bufs[i] = qkvb.clone()
        return bufs[i]

    def run_kernel(i):
        b = buf(i)
        return lambda: EA.self_attention_qkv(b, H, true_len=true_len)

    def run_plain(i):
        b = buf(i)
        return lambda: EA.self_attention_qkv_plain(b, H, true_len=true_len)

    heads = [qkvb[:, i * S:(i + 1) * S].reshape(T, H, D).transpose(0, 1).contiguous()
             for i in range(3)]
    keep = (torch.arange(T, device=dev) < true_len)[None, :].expand(T, T)
    lib = {}

    def run_library(i):
        if i not in lib:
            lib[i] = [h.clone() for h in heads]
        q, k, v = lib[i]
        return lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=keep)

    ms = device_ms(run_kernel, nbytes)
    plain_ms = device_ms(run_plain, nbytes)
    library_ms = device_ms(run_library, nbytes)
    bufs.clear()
    lib.clear()
    b_ms, by = bound_ms(nbytes, flops)
    log(f"  time  self_attention_qkv[T={T}]: kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
        f"library_ms={library_ms:.5f} bound_ms={b_ms:.5f} ({by}) launches_per_encode=32")
    # the JSON row: one encode's 32 layers
    return dict(ms=32 * ms, plain_ms=32 * plain_ms, library_ms=32 * library_ms,
                bytes=32 * nbytes, flops=32 * flops, err=err)


# ---------------------------------------------------------------------------
# phases 4 and 5: the main path, and the small-input reference check
# ---------------------------------------------------------------------------

def seeded_audio(seconds: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    t = np.arange(n) / 16000.0
    tone = 0.05 * np.sin(2 * np.pi * 220.0 * t) * (1 + np.sin(2 * np.pi * 0.5 * t))
    return (tone + 0.05 * rng.standard_normal(n)).astype(np.float32)


def run_main_path(W, counters, path: str, kv_itype: str, pcm: np.ndarray):
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx = W.load(path, kv_itype=kv_itype)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    assert ctx.device.type == "cuda" and ctx.compute_dtype == torch.bfloat16
    assert ctx.use_packed_weights
    # the process's first transcribe also loads PyTorch's CUDA modules and
    # cuBLAS lazily: a 3 s warm-up keeps that out of the timed run
    t0 = time.perf_counter()
    W.transcribe(ctx, W.TranscribeParams(), pcm[:16000 * 3])
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    ctx.timings.reset()
    for fn in ctx._window_fns.values():
        fn.readbacks = 0
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    segs = W.transcribe(ctx, W.TranscribeParams(), pcm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    tm = ctx.timings
    log(f"  [{kv_itype}] load_s={t_load:.3f} warmup_3s_wall_s={t_warm:.3f} "
        f"transcribe_wall_s={wall:.3f} segments={len(segs)} windows={tm.n_encode}")
    for s in segs[:5]:
        log(f"    [{s.t0:6d} -> {s.t1:6d}] {s.text!r} tokens={[t.id for t in s.tokens]}")
    readbacks = sum(fn.readbacks for fn in ctx._window_fns.values())
    # t=0 attempts run the device window loop (t_decode: one lane, prompt
    # pass included); t>0 fallbacks run the host loop (t_batchd: one
    # batched step of best_of lanes, t_sample: its host-side filters)
    log(f"  [{kv_itype}] encode_ms_per_window={ms_per(tm.t_encode_us, tm.n_encode):.3f} "
        f"device_loop_ms_per_token={ms_per(tm.t_decode_us, tm.n_decode):.3f} "
        f"device_loop_tokens={tm.n_decode} device_loop_readbacks={readbacks} "
        f"host_loop_ms_per_step={ms_per(tm.t_batchd_us, tm.n_batchd):.3f} "
        f"host_loop_steps={tm.n_batchd} host_sample_ms={tm.t_sample_us / 1e3:.3f} "
        f"fallbacks={tm.n_fail_p} max_memory_allocated={torch.cuda.max_memory_allocated()}")
    log(f"  [{kv_itype}] launches={json.dumps(launches)}")
    # what comes out is right by the repo's own means: token ids in the
    # vocabulary, segment ends within the audio, finite encoder output and
    # finite logits of the expected shape.  A segment's t0 follows the
    # reference's rule seek + 2 * (tid - token_beg), and a first token with
    # no timestamp mass keeps tid 0, so t0 is not bounded here.
    n_len = ctx.n_len_org
    assert segs and all(isinstance(s.text, str) and s.tokens for s in segs)
    assert all(0 <= s.t1 <= n_len + 3000 for s in segs)
    assert all(0 <= t.id < ctx.hp.n_vocab for s in segs for t in s.tokens)
    xk = ctx.xk.codes.float() if hasattr(ctx.xk, "codes") else ctx.xk
    assert torch.isfinite(xk).all()
    logits, _ = ctx.decode(np.array([[ctx.vocab.token_sot]]), 0, ctx.new_cache(1))
    assert logits.shape == (1, ctx.hp.n_vocab) and np.isfinite(logits).all()
    return ctx, segs, launches


def ms_per(t_us: int, n: int) -> float:
    return t_us / 1e3 / max(n, 1)


def dev_us(e):
    return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total


def device_events(prof):
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_window(W, ctx, pcm: np.ndarray) -> None:
    """One window at t = 0 (encode + the device window loop, no fallback)
    under torch.profiler: the device's busy share of the wall time, kernel
    launches per decode step, and device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    params = W.TranscribeParams(temperature_inc=0.0)
    W.transcribe(ctx, params, pcm)
    torch.cuda.synchronize()
    ctx.timings.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        W.transcribe(ctx, params, pcm)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    tm = ctx.timings

    on_dev = device_events(prof)
    busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
    n_launch = sum(e.count for e in on_dev)
    log(f"  profile: wall_ms={wall_ms:.3f} device_busy_ms={busy_ms:.3f} "
        f"idle_share={1 - busy_ms / wall_ms:.4f} device_events={n_launch} "
        f"windows={tm.n_encode} decode_tokens={tm.n_decode} "
        f"encode_ms={ms_per(tm.t_encode_us, tm.n_encode):.3f} "
        f"device_loop_ms_per_token={ms_per(tm.t_decode_us, tm.n_decode):.3f} "
        f"(profiler on)")
    for e in sorted(on_dev, key=dev_us, reverse=True)[:12]:
        log(f"    {dev_us(e) / 1e3:9.3f} ms {e.count:6d}x  {e.key[:110]}")


def flash_encode(M, FA, EA, ctx, pcm: np.ndarray) -> None:
    """One 30 s encode on the flash route (WTPU_ENC_ATTN=flash: K6 in every
    layer, no K4) against the same window on the fused-QKV route (K4)."""
    ctx.pcm_to_mel(pcm[:16000 * 30])
    mel = torch.from_numpy(np.ascontiguousarray(ctx.mel[:, :3000])).to(ctx.device)
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for route in ("auto", "flash"):
        os.environ["WTPU_ENC_ATTN"] = route
        M.encode(ctx.params, mel, ctx.hp, dtype=ctx.compute_dtype)   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        M.encode(ctx.params, mel, ctx.hp, dtype=ctx.compute_dtype)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        EA.self_attention_qkv.launches = FA.flash_self_attention.launches = 0
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out[route] = M.encode(ctx.params, mel, ctx.hp, dtype=ctx.compute_dtype)
            torch.cuda.synchronize()
        n_k4, n_k6 = EA.self_attention_qkv.launches, FA.flash_self_attention.launches
        on_dev = device_events(prof)
        busy = sum(dev_us(e) for e in on_dev) / 1e3
        attn = sum(dev_us(e) for e in on_dev
                   if "enc_attn_kernel" in e.key or "flash_attn_kernel" in e.key) / 1e3
        log(f"  encode route={route}: encode_wall_ms={ms:.3f} device_busy_ms={busy:.3f} "
            f"attention_kernel_ms={attn:.3f} (profiler) "
            f"self_attention_qkv_launches={n_k4} flash_self_attention_launches={n_k6}")
    del os.environ["WTPU_ENC_ATTN"]
    assert n_k6 == ctx.hp.n_audio_layer == 32 and n_k4 == 0, (n_k4, n_k6)
    assert torch.isfinite(out["flash"]).all()
    err = (out["flash"] - out["auto"]).abs().max().item()
    log(f"  encoder output, flash route vs fused-QKV route (all 1500 rows real): "
        f"max_abs_err={err:.4e} max_abs={out['auto'].abs().max().item():.4e}")
    return n_k6


def run_cli(W, TC, counters, model_path: str, wav: str, out_dir: str, extra):
    """The port's whisper-cli at its default flags (beam 5, best-of 5) on the
    card, writing -otxt -ojf; wall time of the CLI and of its transcribe."""
    for fn in counters:
        fn.launches = 0
    inner, timed = W.transcribe, {}

    def transcribe(ctx, *a, **kw):
        t0 = time.perf_counter()
        segs = inner(ctx, *a, **kw)
        torch.cuda.synchronize()
        timed["s"] = time.perf_counter() - t0
        timed["tm"] = ctx.timings
        timed["readbacks"] = sum(fn.readbacks for fn in ctx._window_fns.values())
        return segs

    W.transcribe = transcribe
    base = os.path.join(out_dir, "cli" + "".join(extra).replace("-", "_"))
    t0 = time.perf_counter()
    try:
        rc = TC.run(["-m", model_path, "-f", wav, "-otxt", "-ojf", "-of", base, "-np",
                     *extra])
    finally:
        W.transcribe = inner
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    assert rc == 0
    with open(base + ".json") as f:
        js = json.load(f)
    segs = js["transcription"]
    with open(base + ".txt") as f:
        n_lines = len(f.read().splitlines())
    tm = timed["tm"]
    log(f"  whisper-cli {' '.join(extra) or '(defaults)'}: cli_wall_s={wall:.3f} "
        f"transcribe_wall_s={timed['s']:.3f} segments={len(segs)} txt_lines={n_lines}")
    log(f"    encode_ms_per_window={ms_per(tm.t_encode_us, tm.n_encode):.3f} "
        f"windows={tm.n_encode} device_loop_ms_per_step={ms_per(tm.t_decode_us, tm.n_decode):.3f} "
        f"device_loop_steps={tm.n_decode} device_loop_readbacks={timed['readbacks']} "
        f"host_loop_ms_per_step={ms_per(tm.t_batchd_us, tm.n_batchd):.3f} "
        f"host_loop_steps={tm.n_batchd} host_sample_ms={tm.t_sample_us / 1e3:.3f} "
        f"fallbacks={tm.n_fail_p}")
    log(f"    launches={json.dumps(launches)}")
    for sg in segs[:6]:
        log(f"    [{sg['offsets']['from']:7d} -> {sg['offsets']['to']:7d}] {sg['text']!r}")
    assert segs and n_lines == len(segs)
    assert all(0 <= t["id"] < 51866 for sg in segs for t in sg["tokens"])
    return launches


def card_matches_cpu(tmp: str) -> None:
    """The slice on the card against the slice on the CPU (bf16 compute,
    packed weights on both) on a small decisive model and 35 s of seeded
    audio: identical segments over two windows, greedy for both kv caches,
    beam search for both kv caches, greedy on the flash encoder route
    (WTPU_ENC_ATTN=flash: K6 on the card, its plain version on the CPU),
    and greedy on -nfa's graphs (flash off, WTPU_ENC_ATTN and
    WTPU_DECODE_ATTN `xla`: the unpadded plain encoder, and the q8 cache's
    dequantize-and-attend graph in place of K3).
    tests/test_torch_gpu.py runs this same check."""
    import whisper_tpu_torch as W
    from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
    from whisper_tpu_torch.ops import attention as FA
    from whisper_tpu_torch.ops import decode_attn as DA
    from whisper_tpu_torch.utils.synth import write_synth_model

    hp = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                        n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                        n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)
    path = os.path.join(tmp, "mini-q5_0.bin")
    write_synth_model(path, hp, seed=1, qtype="q5_0", decisive=True)
    audio = (0.1 * np.random.default_rng(5).standard_normal(16000 * 35)).astype(np.float32)
    greedy = W.TranscribeParams(temperature_inc=0.0)
    beam = W.TranscribeParams.default(W.SamplingStrategy.BEAM_SEARCH)
    beam.temperature_inc = 0.0
    # (name, kv cache, params, WTPU_ENC_ATTN, WTPU_DECODE_ATTN, flash on)
    cases = [("greedy", "q8", greedy, "auto", "auto", True),
             ("greedy", "f16", greedy, "auto", "auto", True),
             ("beam", "q8", beam, "auto", "auto", True),
             ("beam", "f16", beam, "auto", "auto", True),
             ("greedy-flash", "f16", greedy, "flash", "auto", True),
             # -nfa: unpadded plain encoder, dequantize-and-attend q8 graph
             ("greedy-nfa", "q8", greedy, "xla", "xla", False)]
    for name, kv, params, enc_route, dec_route, flash_on in cases:
        os.environ["WTPU_ENC_ATTN"] = enc_route
        os.environ["WTPU_DECODE_ATTN"] = dec_route
        FA.set_flash_enabled(flash_on)
        FA.flash_self_attention.launches = DA.self_attend_q8.launches = 0
        gpu = W.transcribe(W.load(path, kv_itype=kv), params, audio)
        n_k6, n_k3 = FA.flash_self_attention.launches, DA.self_attend_q8.launches
        cpu = W.transcribe(W.load(path, device="cpu", kv_itype=kv,
                                  use_packed_weights=True,
                                  compute_dtype=torch.bfloat16), params, audio)
        del os.environ["WTPU_ENC_ATTN"], os.environ["WTPU_DECODE_ATTN"]
        FA.set_flash_enabled(True)
        a = [(s.t0, s.t1, s.text) for s in gpu]
        b = [(s.t0, s.t1, s.text) for s in cpu]
        log(f"  [{name} {kv}] card segments={a}")
        assert a == b and len(a) >= 2, (a, b)
        assert (n_k6 > 0) == (enc_route == "flash"), n_k6
        assert (n_k3 > 0) == (kv == "q8" and dec_route == "auto"), n_k3
        log(f"  [{name} {kv}] card == cpu: {len(a)} segments identical (launches on "
            f"the card: flash_self_attention {n_k6}, self_attend_q8 {n_k3})")


def main() -> int:
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here))
    t_start = time.perf_counter()

    log("== 1. device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    import whisper_tpu_torch as W
    from whisper_tpu_torch.audio.io import write_wav
    from whisper_tpu_torch.cli import bench_cli as TB
    from whisper_tpu_torch.cli import transcribe as TC
    from whisper_tpu_torch.formats import quants as Q
    from whisper_tpu_torch.models.whisper import model as M
    from whisper_tpu_torch.models.whisper.hparams import LARGE_V3_TURBO
    from whisper_tpu_torch.ops import _cuda
    from whisper_tpu_torch.ops import attention as FA
    from whisper_tpu_torch.ops import decode_attn as DA
    from whisper_tpu_torch.ops import enc_attn as EA
    from whisper_tpu_torch.ops import qmm as QM
    from whisper_tpu_torch.utils.synth import write_synth_model

    # the plain versions are the references: full f32 products, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    log(f"  device={kind} count={torch.cuda.device_count()} torch={torch.__version__} "
        f"cuda={torch.version.cuda}")
    log(f"  nvidia-smi: {smi}")

    log("== 2. build")
    info = _cuda.build_all()
    for name, d in info.items():
        log(f"  {name}: build_s={d['seconds']:.2f} {d['path']}")
        for line in d["ptxas"].splitlines():
            if any(k in line for k in ("Compiling entry", "Used", "spill")):
                log(f"    {line.strip()}")

    log("== 3. kernels against their plain versions (turbo shapes)")
    k1 = check_qmmt(dev, Q, QM)
    k3 = check_self_attend_q8(dev, DA)
    k4 = check_self_attention_qkv(dev, EA)
    k5 = check_qmm(dev, QM)
    k6 = check_flash(dev, FA)

    log("== 4. paths: q5_0 large-v3-turbo, load() + transcribe(), flash encode, "
        "whisper-cli, whisper-bench")
    counters = [QM.qmmt_fused, QM.qmmt, DA.self_attend_q8, EA.self_attention_qkv,
                QM.qmm, FA.flash_self_attention]
    pcm = seeded_audio(40.0, seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "large-v3-turbo-q5_0.bin")
        t0 = time.perf_counter()
        write_synth_model(path, LARGE_V3_TURBO, seed=0, qtype="q5_0", decisive=True)
        log(f"  synth_s={time.perf_counter() - t0:.1f} bytes={os.path.getsize(path)}")
        ctx, segs_q8, launches = run_main_path(W, counters, path, "q8", pcm)
        profile_window(W, ctx, pcm[:16000 * 30])
        n_flash = flash_encode(M, FA, EA, ctx, pcm)
        del ctx
        ctx, segs_f16, launches_f16 = run_main_path(W, counters, path, "f16", pcm)
        del ctx
        wav = os.path.join(tmp, "audio-40s.wav")
        write_wav(wav, pcm)
        cli_f16 = run_cli(W, TC, counters, path, wav, tmp, [])
        cli_q8 = run_cli(W, TC, counters, path, wav, tmp, ["--kv-itype", "q8"])
    same = [(s.t0, s.t1, s.text) for s in segs_q8] == [(s.t0, s.t1, s.text) for s in segs_f16]
    log(f"  q8 and f16 kv caches give the same segments: {same}")
    for name in ("qmmt_fused", "self_attend_q8", "self_attention_qkv"):
        assert launches[name] > 0, f"{name} was not launched on the main path"
    assert launches_f16["self_attend_q8"] == 0 and launches_f16["qmmt_fused"] > 0
    assert launches["flash_self_attention"] == 0 and launches["qmm"] == 0
    for cli in (cli_f16, cli_q8):
        assert cli["qmmt_fused"] > 0 and cli["self_attention_qkv"] > 0
    assert cli_q8["self_attend_q8"] > 0 and cli_f16["self_attend_q8"] == 0

    log("  whisper-bench -w 1")
    assert TB.main(["-w", "1"]) == 0
    for fn in counters:
        fn.launches = 0
    log("  whisper-bench -w 2")
    assert TB.main(["-w", "2"]) == 0
    n_qmm = QM.qmm.launches
    log(f"  whisper-bench -w 2: qmm launches={n_qmm}")
    assert n_qmm > 0

    log("== 5. small decisive model: the card against the CPU")
    with tempfile.TemporaryDirectory() as tmp:
        card_matches_cpu(tmp)

    def entry(name, src, replaces, agg, n_launches):
        b_ms, by = bound_ms(agg["bytes"], agg["flops"])
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": n_launches, "max_abs_err": agg["err"], "ms": agg["ms"],
                "plain_ms": agg["plain_ms"], "bound_ms": b_ms, "bound_by": by,
                "library_ms": agg["library_ms"]}

    # launches: K1, K3, K4 on the q8 load() + transcribe() path; K5 on
    # whisper-bench -w 2; K6 on the flash-route encode
    kernels = [
        entry("qmmt_fused", "whisper_tpu_torch/csrc/qmmt.cu",
              "whisper_tpu/ops/qmm.py:333", k1["qmmt_fused"], launches["qmmt_fused"]),
        entry("self_attend_q8", "whisper_tpu_torch/csrc/decode_attn.cu",
              "whisper_tpu/ops/decode_attn.py:96", k3, launches["self_attend_q8"]),
        entry("self_attention_qkv", "whisper_tpu_torch/csrc/enc_attn.cu",
              "whisper_tpu/ops/enc_attn.py:107", k4, launches["self_attention_qkv"]),
        entry("qmm", "whisper_tpu_torch/csrc/qmm.cu",
              "whisper_tpu/ops/qmm.py:116", k5, n_qmm),
        entry("flash_self_attention", "whisper_tpu_torch/csrc/flash_attn.cu",
              "whisper_tpu/ops/attention.py:48", k6, n_flash),
    ]
    # qmmt (K2) is the same kernel with its prologue and epilogue off; no
    # path calls it, so it is reported apart from the paths' kernels
    off_path = [entry("qmmt", "whisper_tpu_torch/csrc/qmmt.cu",
                      "whisper_tpu/ops/qmm.py:216", k1["qmmt"], launches["qmmt"])]
    log(json.dumps({"off_path_kernels": off_path}))
    log(f"  total_s={time.perf_counter() - t_start:.1f}")
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
