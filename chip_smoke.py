#!/usr/bin/env python3
"""Smoke run of whisper_tpu_torch, the PyTorch/CUDA port, on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card: name, count, power limit, torch and CUDA versions;
  2. build the Hopper kernels from whisper_tpu_torch/csrc with nvcc, with
     each kernel's registers, shared memory and spills;
  3. each kernel against its plain PyTorch version on the card at the
     shapes its path gives it (large-v3-turbo; whisper-bench -w 2's 4096^3
     for qmm; K2 at a DTW pass's 32 and 128 rows; K6 also at heads of
     128 and at the parity matrix's heads of 32 and 16, each with two
     planted faults that its tolerance must see), max error beside its
     tolerance, then device times of the kernel, the plain version and a
     library yardstick, with the least time the card could take;
  4. the paths, each with every launch count set to 0 just before it and
     read just after: a q5_0 large-v3-turbo file written from a seed,
     `whisper_tpu_torch.load()` + `transcribe()` of 40 s of seeded audio
     with default parameters (kv cache q8, then f16; five timed runs, the
     window loop's CUDA graphs' flag reads, captures and ms per token),
     one window through the window loop's graphs against its eager loop,
     decode_step_bucketed against the full-context step on the q8
     context's packed planes, q8 and f16 caches, from the prompt pass to
     the last cell (every attention bucket; K1 and K3 launched, K3 at each
     bucket's context), `qmm_auto` on the card against the CPU, one 30 s
     window of the q8 context under torch.profiler on the graphs and on
     the eager loop (device busy share, device time by kernel), its
     window-loop time at 1, 2, 4, 8 and 16 steps per read of the done
     flag, one beam-search window of the f16 context under the profiler,
     one 30 s encode on the flash route (WTPU_ENC_ATTN=flash) against the
     fused-QKV route, the port's whisper-cli at its default flags (beam
     search 5, best-of 5) on the same file and audio as a wav (kv cache
     f16, then q8), and whisper-bench -w 1 and -w 2;
  5. the slice on the card against the slice on the CPU, on a small
     decisive model: identical segments and DTW token timestamps, greedy
     and beam search, on the fused-QKV and the flash encoder routes and on
     -nfa's plain graphs (the card's device mel, the CPU's numpy mel);
  6. batched serving on the turbo file: the port's whisper-server answers
     4 concurrent greedy requests and 2 concurrent beam-search ones (their
     window decodes batched natively by the server-wide WindowBatcher),
     then each alone, every concurrent response equal to its solo one;
     then the whisper-cli with -p 4 --kv-itype q8 (the decode attention
     kernel at 4 x 5 rows);
  7. before and after the window loop, on a seeded 40 s clip with two 3 s
     silences cut in: a synthetic Silero VAD file (seed 0, Silero's
     widths) on the card against the CPU (under the caller's TF32 flags
     all on and at torch's defaults), its time, and the share of samples
     its filter keeps; the device mel against the numpy mel, and each
     one's time; the whisper-cli on the turbo file with -vad and
     -dtw large.v3.turbo (VAD segments in the clip's time, each window's
     t_dtw, K2 launched by the DTW passes);
  8. Parakeet-TDT, the second model family: a full-width ParakeetHParams()
     file written from seed 0 (f16) and quantized to q5_0 by the port's
     parakeet-quantize; `ParakeetContext.full()` on 40 s (packed weights,
     the device mel, the TDT loop as CUDA graphs of 8 steps; five timed
     runs after a warm-up, mel/encode/decode times, the loop's steps,
     replays and flag reads, tokens, peak memory, no K1-K6 launch); the
     encode packed against dense; the loop's graphs against its eager
     step bit for bit; the chunked loop (chunk 16) against the frame loop,
     both on graphs; `full_batch` of 4 clips against the same 4 through
     `full()`; one 700 s clip on the local-attention path; the port's
     parakeet-cli with -otxt and with --batch; a small decisive Parakeet
     on the card against the CPU;
  9. the parity mode (precision="ggml_cpu_f16") and grammars on a q5_0
     turbo file with 4 of its 32 encoder layers and the 40 s of phase 4: `load(precision="ggml_cpu_f16")` +
     `transcribe()` (a warm-up and three timed runs: wall, encode ms per
     window, ms per host-loop step, host filter ms, peak memory, no K1-K6
     launch); one parity window through the window loop's graphs against
     its eager loop, bit for bit; the whisper-cli with --precision
     ggml_cpu_f16, then with -p 2; the whisper-cli with --grammar
     tests/data/text_parity/script.gbnf --grammar-rule root at its
     defaults (beam 5), then with --kv-itype q8 (K1 launched, and K3 under
     q8); and on a small decisive model the card against the CPU: parity on
     q5_0 and f16 files (greedy, beam 5, and greedy with the q8 cache, K3
     at f16), grammars greedy and beam 5, identical segments;
 10. the rest of the CLIs and the format tools, on the turbo file and the
     40 s of phase 4: whisper-stream's `run_stream` with --step 3000
     --length 10000, the same with -ac 768 (K4 at 768 frames), and the
     VAD mode (--step 0) on an 8 s clip played in real time on a
     simulated clock (ms per step, K1 and K4 launches); whisper-command's
     guided scores of 8 words; whisper-bench -w 0 -m large-v3-turbo (its
     JSON line, with the Parakeet rows; K1, K3, K4 launched); the imatrix
     capture (cli/make_imatrix.py, on the card) of a turbo-width f16 file
     with 4 of the 32 encoder layers, and greedy `transcribe()` of that
     file quantized to q4_k (K1 on affine planes; K1 per decode step on
     q4_k against q5_0 planes); then on small decisive models the card
     against the CPU: whisper-stream (the three modes), whisper-command
     (guided and --grammar), whisper-talk (a local --llm-cmd),
     whisper-lsp (its framing), wchess, the imatrix capture, and (as
     "10b", after phase 12) q4_k and iq2_xxs files (the card's imatrix)
     loaded on both.  The q4_k and iq2_xxs whisper-quantize runs (host
     numpy, minutes) start in the background after phase 2 ("2b") and are
     killed if the script exits before they are waited for;
 11. the C ABI and fine-tuning, on the turbo file and the 40 s of phase 4
     (written as raw f32 PCM) and phase 8's Parakeet file: the shim
     libwhisper_tpu_torch.so (whisper_tpu_torch/abi.py) loaded into this
     interpreter runs whisper_init_from_file_with_params (default params:
     the card) and whisper_full against the port's transcribe() of the same
     params (identical segments, K1 and K4 launched by the C call, each
     one's wall, medians of 3), and the VAD at its default context params
     (the card) on phase 7's file and clip against the port's Python VAD
     (identical segments); fine-tuning the turbo file's f32 weights on
     one seeded 30 s window and a 64-token row (8 AdamW steps with the
     encoder frozen, the loss falling; one step with the encoder trained;
     ms per step and peak memory of each), the result written with
     save_finetuned, read back equal at f16 rounding and transcribed; then
     the C hosts all at once, each a process of its own (abi_host.c with
     "cuda", native/test_abi_main.c, test_abi_structs.c,
     test_abi_callbacks.c, bindings/cpp/example.cpp on phase 5's small
     model, and native/test_abi_parakeet.c on the Parakeet file): each
     exits 0 and
     prints the segments (or the first token, the segment count, the
     Parakeet text) the port's own Python calls give; meanwhile 3 AdamW
     steps on a small model card vs CPU, the losses within rtol 1e-4;
 12. scale-out (whisper_tpu_torch/parallel/), after the parent has freed
     its memory, on phase 4's turbo file and 40 s and phase 8's Parakeet
     file, in one 1-rank launch and one 2-rank launch (parallel/launch.py):
     a. one rank over NCCL on a 1 x 1 mesh: the dense bf16 turbo file's
        encode (K4), cross-K/V q8, a prompt pass and 3 steps, and a greedy
        window through the window decoder's CUDA graphs (K3), bit for bit
        equal to tp=None, with no all-reduce launched (a one-rank group has
        no collective), the step's ms beside tp=None's; the collective
        audit's decode step (parallel/collective_audit.py) at tp = 1, float
        and q8 caches, reading no collective; the scaling bench's 1x1 line
        (parallel/scaling_bench.py, synthetic dense large-v3-turbo);
     b. two ranks sharing the card over gloo (NCCL refuses two ranks on one
        device), Whisper tp=2 at full turbo width, dense bf16: encode,
        cross-K/V f16 and q8, the prompt pass and 3 steps with f16 and q8
        caches, a greedy window on the decoder's eager loop (gloo cannot be
        captured), against the unsharded run on the card in the same rank
        (max relative error <= 1e-2, tokens identical);
     c. the same ranks, dp=2: transcribe_multihost of the 40 s on the
        packed q5_0 file (K1, K3, K4 launched on each rank), both merged
        lists identical and equal to transcribe_parallel(ctx, p, pcm, 2,
        batched=False) on the card;
     d. Parakeet tp=2, dense f32: the encode against the unsharded one
        (<= 1e-4 under full_f32), TDT tokens equal;
     e. fine-tuning dp=2: one step at full turbo width, encoder frozen, a
        batch of 2, against one process on the same batch (loss and
        leaves within 1e-4); ms per step and peak memory per rank.
     Every wall time of b-e is that of two ranks sharing one card.

The last lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import contextlib
import copy
import ctypes
import io
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


def heading(title: str, t_start: float) -> None:
    """A phase's heading, with the seconds since the script started."""
    log(f"== {title} [at_s={time.perf_counter() - t_start:.1f}]")


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

def same_under_graph(fn) -> bool:
    """`fn()` twice eagerly and once replayed from a CUDA graph: all three
    results bit-identical (no order-dependent atomics in the kernel)."""
    a, b = fn(), fn()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                  # warm-up outside the graph
    torch.cuda.current_stream().wait_stream(stream)
    with torch.cuda.graph(graph):
        c = fn()
    graph.replay()
    torch.cuda.synchronize()
    return torch.equal(a, b) and torch.equal(a, c)


BATCHED_T = (4, 8, 10, 20)    # K1 rows of natively batched steps (phase 6)
# K2 at a DTW pass (phase 7): one full-sequence decoder pass over a window's
# tokens, T = 32 and 128 rows, through each layer's six packed planes
DTW_T = (32, 128)
DTW_USES = (("qkv", 1280, 3840, 1), ("o_xq_xo", 1280, 1280, 3), ("mlp0", 1280, 5120, 1),
            ("mlp1", 5120, 1280, 1))   # name, K, R, launches per layer
# prompt buckets of W = 4 natively batched windows: the prompt pass runs K1
# at T = 4 x bucket rows, and K3 at B = 4, G = bucket with each row's
# left-pad mask
NATIVE_PROMPT_BUCKETS = (4, 32, 256)


def check_qmmt(dev, Q, QM):
    """K1 (qmmt_fused) per decode-path use at T = 1 (a greedy step) and T = 5
    (a beam step of five lanes), at the batched steps' T = W x G of
    BATCHED_T (W = 4 greedy windows, 8 rows, W = 2 beam windows of 5, W = 4
    beam windows of 5), prompt passes at T = 4 and 32, the qkv and logits
    uses of natively batched prompt passes at T = 4 x NATIVE_PROMPT_BUCKETS
    (W = 4 windows), and K2 (qmmt) at T = 1 and at a DTW pass's DTW_T rows
    (its JSON row: one pass's 24 launches at T = 32), at turbo widths, on
    planes installed as the main path installs them (rows pitched to 64
    columns)."""
    S = 1280
    uses = [  # name, K, R, ln, bias, act, res, launches per step
        ("qkv", S, 3 * S, True, True, None, False, 4),
        ("o", S, S, False, True, None, True, 4),
        ("xq", S, S, True, True, None, False, 4),
        ("xo", S, S, False, True, None, True, 4),
        ("mlp0", S, 4 * S, True, True, "gelu", False, 4),
        ("mlp1", 4 * S, S, False, True, None, True, 4),
        ("logits", S, 51866, True, False, None, False, 1),
    ]
    cases = ([(n, T, *u) for T in (1, 5, *BATCHED_T) for n, *u in uses]
             + [("qkv_prompt4", 4, S, 3 * S, True, True, None, False, 0),
                ("logits_prompt4", 4, S, 51866, True, False, None, False, 0),
                ("qkv_prompt32", 32, S, 3 * S, True, True, None, False, 0),
                ("logits_prompt32", 32, S, 51866, True, False, None, False, 0)]
             + [(f"{u}_native_prompt4x{b}", 4 * b, S, R, True, u == "qkv", None, False, 0)
                for b in NATIVE_PROMPT_BUCKETS for u, R in (("qkv", 3 * S), ("logits", 51866))]
             + [("qmmt", 1, S, 3 * S, False, False, None, False, 0)]
             + [(f"qmmt_dtw_{u}", T, K, R, False, False, None, False, 4 * n)
                for T in DTW_T for u, K, R, n in DTW_USES])
    g = torch.Generator().manual_seed(0)
    step_key = {1: "qmmt_fused", 5: "qmmt_fused_beam",
                **{T: f"qmmt_fused_T{T}" for T in BATCHED_T}}
    dtw_key = {T: "qmmt" if T == DTW_T[0] else f"qmmt_dtw_T{T}" for T in DTW_T}
    agg = {k: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, err=0.0, bytes=0, flops=0)
           for k in (*dtw_key.values(), *step_key.values())}
    for name, T, K, R, ln, bias, act, res, per_step in cases:
        w = torch.randn((R, K), generator=g).numpy()
        p = Q.unpack_to_planes(Q.quantize(w, Q.GGML_TYPE_Q5_0), Q.GGML_TYPE_Q5_0, (R, K))
        qw = QM.pitch_qweight_t(p.codes.T, p.scales.T, device=dev)
        codes, scales = qw.codes_t, qw.scales_t
        rnd = lambda *s: torch.randn(s, generator=g).to(dev)
        x = rnd(T, K)
        kw = dict(ln_w=rnd(K) if ln else None, ln_b=rnd(K) if ln else None,
                  bias=rnd(R) if bias else None, residual=rnd(T, R) if res else None,
                  act=act, dtype=torch.bfloat16)
        bare = name.startswith("qmmt")
        kernel = QM.qmmt if bare else QM.qmmt_fused
        call = ((lambda: QM.qmmt(x, codes, scales, dtype=torch.bfloat16)) if bare
                else (lambda: QM.qmmt_fused(x, codes, scales, **kw)))
        y = call()
        ref = QM.qmmt_fused_plain(x, codes, scales, **kw)
        torch.cuda.synchronize()
        err = (y - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item()
        ks = QM.slice_rows(K, R, 32, torch.cuda.get_device_properties(dev).multi_processor_count, T)
        log(f"  check {kernel.__name__}[{name}] T={T} K={K} R={R} pitch={codes.stride(0)} "
            f"grid={-(-R // QM.TILE)}x{-(-K // ks)}: max_abs_err={err:.3e} tol={tol:.3e}")
        assert math.isfinite(err) and err <= tol, name
        if (name in ("logits", "mlp1", "qkv_prompt4") and T in (1, 5, 4, 20)
                or name == "qmmt_dtw_mlp1"):
            assert same_under_graph(call), f"{name}: not bit-identical across calls"
            log(f"  check {kernel.__name__}[{name}] T={T}: bit-identical over two calls "
                f"and a CUDA-graph replay")

        nb = K // 32
        nbytes = (K * R + nb * R * 4 + T * K * 4 + T * R * 4
                  + (2 * K * 4 if ln else 0) + (R * 4 if bias else 0)
                  + (T * R * 4 if res else 0))
        flops = 2.0 * T * K * R
        copies = {}

        def planes(i):
            # another copy of the pitched planes, so the rotation passes L2
            if i not in copies:
                copies[i] = QM.pitch_qweight_t(codes, scales, device=dev)[:2]
            return copies[i]

        def run_kernel(i):
            c, s = planes(i)
            if bare:
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
        if T in (1, 5, 32, 8, 20) and not bare:
            # the product on the other route (tensor cores against CUDA-core
            # FMAs); the wrapper takes the tensor cores from QM.MMA_MIN_T rows
            chosen = QM.MMA_MIN_T
            QM.MMA_MIN_T = 1 if T < chosen else T + 1
            other_ms = device_ms(run_kernel, nbytes)
            QM.MMA_MIN_T = chosen
            mma = T >= chosen
            log(f"  time  {kernel.__name__}[{name}] T={T} by product route: "
                f"mma_ms={ms if mma else other_ms:.5f} fma_ms={other_ms if mma else ms:.5f} "
                f"(the wrapper takes {'mma' if mma else 'fma'})")
        if name in ("qkv", "mlp0", "mlp1", "logits") and T in (1, 5):
            # rows of K per block, measured here; the wrapper's choice is
            # QM.slice_rows
            chosen, times = QM.slice_rows, {}
            for rows in (128, 256, 512):
                QM.slice_rows = lambda *_, rows=rows: rows
                times[rows] = device_ms(run_kernel, nbytes)
            QM.slice_rows = chosen
            log(f"  time  qmmt_fused[{name}] T={T} by K-slice rows: "
                + " ".join(f"{r}:{t:.5f}" for r, t in times.items()) + f" (the wrapper takes {ks})")
        copies.clear()
        wcopies.clear()
        b_ms, by = bound_ms(nbytes, flops)
        log(f"  time  {kernel.__name__}[{name}] T={T}: kernel_ms={ms:.5f} "
            f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} bound_ms={b_ms:.5f} "
            f"({by}) launches_per_{'dtw_pass' if bare else 'beam_step' if T == 5 else 'step'}"
            f"={per_step}")
        # K2's row is one DTW pass at T = DTW_T[0]; its T = 1 check counts
        # in its error only
        key = (dtw_key.get(T, "qmmt") if bare else step_key.get(T, "qmmt_fused")
               if per_step else "qmmt_fused")
        a = agg[key]
        a["err"] = max(a["err"], err)
        weight = per_step
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms)):
            a[k] += weight * v
        a["bytes"] += weight * nbytes
        a["flops"] += weight * flops
    for T, key in step_key.items():
        a = agg[key]
        b_ms, by = bound_ms(a["bytes"], a["flops"])
        unit = ("decode step" if T == 1 else "beam step" if T == 5 else "batched step")
        log(f"  qmmt_fused per {unit} (T={T}), 25 launches: kernel_ms={a['ms']:.5f} "
            f"plain_ms={a['plain_ms']:.5f} library_ms={a['library_ms']:.5f} "
            f"bound_ms={b_ms:.5f} ({by}) ratio_to_T1={a['ms'] / agg['qmmt_fused']['ms']:.3f} "
            f"bound_ratio_to_T1={b_ms / bound_ms(agg['qmmt_fused']['bytes'], agg['qmmt_fused']['flops'])[0]:.3f} "
            f"kernel_not_slower_than_library={a['ms'] <= a['library_ms']}")
    for T, key in dtw_key.items():
        a = agg[key]
        b_ms, by = bound_ms(a["bytes"], a["flops"])
        log(f"  qmmt per DTW pass (T={T}), 24 launches: kernel_ms={a['ms']:.5f} "
            f"plain_ms={a['plain_ms']:.5f} library_ms={a['library_ms']:.5f} "
            f"bound_ms={b_ms:.5f} ({by}) kernel_to_library={a['ms'] / a['library_ms']:.3f} "
            f"kernel_to_bound={a['ms'] / b_ms:.3f}")
    for key in (*step_key.values(), *dtw_key.values()):
        into = "qmmt" if key in dtw_key.values() else "qmmt_fused"
        if key != into:
            agg[into]["err"] = max(agg[into]["err"], agg.pop(key)["err"])
    return agg


# K3 against its plain version: 2e-2 of the largest |output| (bf16 products
# of int8 codes, f32 sums in another order); phase 4's bucketed step holds
# its logits to the same share of the largest |logit|
K3_REL_TOL = 2e-2


def check_self_attend_q8(dev, DA):
    """K3 at turbo widths: G = 1 (a decode step) and G = 4 (a prompt
    bucket) for every attention bucket A with one row, B = 5 rows (a beam
    step) at A = 448, the natively batched steps' B = 4 and 10 rows at
    A = 128 and 448 with each row's left-pad cells masked (0 to 7 of them),
    and the natively batched prompt passes of W = 4 windows, B = 4 and G =
    NATIVE_PROMPT_BUCKETS, with the mask the prompt pass builds (causal,
    each row's left-pad cells hidden, a pad query seeing itself) over the
    native cache's cells; q is the f32 head view of the fused projection,
    as decode_step passes it.  Then the cluster size at A = 448, G = 1, and
    the parity mode's f16 rounding at B = 1, G = 1, A = 448."""
    from whisper_tpu_torch.decoding import device_loop as DL
    from whisper_tpu_torch.models.whisper import model as M

    L, H, D = 4, 20, 64
    S = H * D
    g = torch.Generator().manual_seed(1)
    agg = None
    err_max = 0.0
    # B, G, A, C, the rows' masks: "causal" (one window), "pad" (a batched
    # step), "prompt" (a batched prompt pass)
    cases = ([(1, G, A, 448, "causal") for G in (1, 4) for A in (128, 256, 384, 448)]
             + [(5, 1, 448, 448, "causal")]
             + [(B, 1, A, 448, "pad") for B in (4, 10) for A in (128, 448)]
             + [(4, G, next(a for a in M.attn_ctx_buckets(448) if a >= G),
                 max(448, G + 220), "prompt") for G in NATIVE_PROMPT_BUCKETS])
    for B, G, A, C, rows in cases:
        kv = torch.randint(-127, 128, (L, B, H, 2, C, D), generator=g, dtype=torch.int8).to(dev)
        scale = (0.01 + 0.02 * torch.rand((L, B, 2, C), generator=g)).to(dev)
        qkv = torch.randn((B, G, 3 * S), generator=g).to(dev)
        q = qkv[..., :S].reshape(B, G, H, D).transpose(1, 2)     # (B, H, G, D) view
        if rows == "prompt":
            lens = torch.randint(G // 2 + 1, G + 1, (B,), generator=g).tolist()
            _, mask_prompt, _ = DL.prompt_pad_masks(G, C, lens, dev)
            mask = M.decode_mask(0, G, A, dev, mask_prompt)[:, 0].expand(B, G, A).contiguous()
        else:
            vis = torch.arange(A)[None, :] < (A - G + torch.arange(G) + 1)[:, None]
            vis = vis.expand(B, G, A)
            if rows == "pad":        # each row's left-pad cells, masked
                shift = torch.randint(0, 8, (B,), generator=g)
                vis = vis & (torch.arange(A)[None, None, :] >= shift[:, None, None])
            mask = torch.where(vis, 0.0, float("-inf")).contiguous().to(dev)
        batched = rows != "causal"
        call = lambda: DA.self_attend_q8(kv, scale, q, mask, l=L - 1, attn_ctx=A)
        out = call()
        ref = DA.self_attend_q8_plain(kv, scale, q, mask, l=L - 1, attn_ctx=A)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = K3_REL_TOL * ref.abs().max().item()
        tag = f"B={B},G={G},A={A},C={C}" + {"causal": "", "pad": ",pad rows masked",
                                               "prompt": ",native prompt pass"}[rows]
        log(f"  check self_attend_q8[{tag}]: max_abs_err={err:.3e} tol={tol:.3e} "
            f"max_abs={ref.abs().max().item():.3e}")
        assert math.isfinite(err) and err <= tol
        err_max = max(err_max, err)
        if A == 448 and G == 1:
            assert same_under_graph(call), f"self_attend_q8[{tag}]: not bit-identical"
        # the cache block, its scales, q (f32), the mask read once; out written
        nbytes = (2 * B * H * A * D + 2 * B * A * 4 + B * H * G * D * 4
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
        b_ms, by = bound_ms(nbytes, flops)
        per_step = 4 if G == 1 else 0
        log(f"  time  self_attend_q8[{tag}]: kernel_ms={ms:.5f} "
            f"plain_ms={plain_ms:.5f} library_ms={library_ms:.5f} "
            f"bound_ms={b_ms:.5f} ({by}) launches_per_{'beam_' if B == 5 else ''}step={per_step}"
            + (f" per_{'step' if G == 1 else 'prompt_pass'}_ms={4 * ms:.5f} "
               f"per_{'step' if G == 1 else 'prompt_pass'}_bound_ms={4 * b_ms:.5f}"
               if batched else ""))
        if A == 448 and G == 1 and not batched:
            # blocks per (row, head) cluster, measured here; the wrapper's is
            # DA.CLUSTER
            chosen = DA.CLUSTER
            times = {}
            for nc in (1, 2, 4, 8):
                DA.CLUSTER = nc
                times[nc] = device_ms(run_kernel, nbytes)
            DA.CLUSTER = chosen
            log(f"  time  self_attend_q8[{tag}] by cluster size: "
                + " ".join(f"{nc}:{t:.5f}" for nc, t in times.items())
                + f" (the wrapper takes {chosen})")
        caches.clear()
        lib.clear()
        if B == 1 and G == 1 and A == 448:
            # the JSON row: one decode step's 4 layers at the largest bucket
            agg = dict(ms=4 * ms, plain_ms=4 * plain_ms, library_ms=4 * library_ms,
                       bytes=4 * nbytes, flops=4 * flops)
            log(f"  self_attend_q8 per decode step (4 launches, A=448): "
                f"kernel_ms={4 * ms:.5f} library_ms={4 * library_ms:.5f} "
                f"bound_ms={4 * b_ms:.5f} kernel_not_slower_than_library={ms <= library_ms}")
            # the parity mode's q8 cache: q and p * s_v rounded to f16
            out = DA.self_attend_q8(kv, scale, q, mask, l=L - 1, attn_ctx=A,
                                    dtype=torch.float16)
            ref = DA.self_attend_q8_plain(kv, scale, q, mask, l=L - 1, attn_ctx=A,
                                          dtype=torch.float16)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tol = 2.5e-3 * ref.abs().max().item()      # ~5 f16 ulps, as bf16's 2e-2
            log(f"  check self_attend_q8[{tag},f16 (parity)]: max_abs_err={err:.3e} "
                f"tol={tol:.3e}")
            assert math.isfinite(err) and err <= tol
    agg["err"] = err_max
    return agg


def check_qmm(dev, QM):
    """K5 at whisper-bench -w 2's shape: 4096^3, codes in [-16, 16) with
    per-32 scales.  Checked and timed on f32 x, as the bench chain feeds it
    (the wrapper's bf16 cast counts in the time), and on bf16 x, the input
    cuBLAS gets as the yardstick."""
    N = 4096
    g = torch.Generator().manual_seed(3)
    x = torch.randn((N, N), generator=g).to(dev)
    xb = x.to(torch.bfloat16)
    codes = torch.randint(-16, 16, (N, N), generator=g, dtype=torch.int8).to(dev)
    scales = (0.02 * torch.rand((N, N // 32), generator=g)).to(dev)
    ref = QM.qmm_plain(x, codes, scales)
    tol = 1e-4 * ref.abs().max().item()
    err = 0.0
    for name, xi in (("f32 x", x), ("bf16 x", xb)):
        y = QM.qmm(xi, codes, scales)
        torch.cuda.synchronize()
        e = (y - ref).abs().max().item()
        log(f"  check qmm[T=K=R={N}, {name}]: max_abs_err={e:.3e} tol={tol:.3e}")
        assert math.isfinite(e) and e <= tol
        err = max(err, e)
    assert same_under_graph(lambda: QM.qmm(x, codes, scales)), "qmm: not bit-identical"
    log(f"  check qmm[T=K=R={N}]: bit-identical over two calls and a CUDA-graph replay")
    # x (f32 or bf16) and codes read once, scales once, the f32 output
    # written once
    nbytes = N * N * 4 + N * N + N * (N // 32) * 4 + N * N * 4
    nbytes_bf16 = nbytes - N * N * 2
    flops = 2.0 * N ** 3
    planes = {}

    def plane(i):
        if i not in planes:
            planes[i] = (codes.clone(), scales.clone())
        return planes[i]

    def run_kernel(xi):
        def make(i):
            c, sc = plane(i)
            return lambda: QM.qmm(xi, c, sc)
        return make

    def run_plain(i):
        c, sc = plane(i)
        return lambda: QM.qmm_plain(x, c, sc)

    # cuBLAS on bf16 x and the bf16-dequantized weight, f32 out
    wdq = (codes.float() * scales.to(torch.bfloat16).float().repeat_interleave(32, 1)
           ).to(torch.bfloat16)
    lib = {}

    def run_library(i):
        if i not in lib:
            lib[i] = wdq.clone()
        w = lib[i]
        return lambda: torch.mm(xb, w.T, out_dtype=torch.float32)

    ms = device_ms(run_kernel(x), nbytes)
    ms_bf16 = device_ms(run_kernel(xb), nbytes_bf16)
    cast_ms = device_ms(lambda i: (lambda: x.to(torch.bfloat16)), N * N * 6)
    plain_ms = device_ms(run_plain, nbytes)
    library_ms = device_ms(run_library, 2 * N * N * 2)
    planes.clear()
    lib.clear()
    b_ms, by = bound_ms(nbytes, flops)
    log(f"  time  qmm[T=K=R={N}]: kernel_ms={ms:.5f} (f32 x, cast included) "
        f"kernel_bf16_x_ms={ms_bf16:.5f} cast_ms={cast_ms:.5f} plain_ms={plain_ms:.5f} "
        f"library_ms={library_ms:.5f} bound_ms={b_ms:.5f} ({by}) "
        f"tflops={flops / ms / 1e9:.2f} tflops_bf16_x={flops / ms_bf16 / 1e9:.2f} "
        f"half_bound_met={ms <= 2 * b_ms} bf16_not_slower_than_library={ms_bf16 <= library_ms}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bytes=nbytes,
                flops=flops, err=err)


def kernel_ptxas(log_text: str, kernel: str) -> list:
    """One line per instantiation of `kernel` in an nvcc -Xptxas -v log:
    its template arguments (int, float or bf16), registers, stack, spills
    and shared memory as ptxas reports them (dynamic shared memory is not
    listed)."""
    import re

    rows, cur = [], None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            cur = None
            if kernel in line:
                name = line.split("'")[1]
                mangled = name[name.index(kernel) + len(kernel):].split("EEv")[0]
                args = [m.group(1) or {"f": "float", "13__nv_bfloat16": "bf16"}[m.group(0)]
                        for m in re.finditer(r"Li(\d+)E|13__nv_bfloat16|f", mangled)]
                cur = [f"{kernel}<{', '.join(args)}>"]
                rows.append(cur)
        elif cur is not None and ("spill" in line or "Used" in line):
            cur.append(line.split(":", 1)[-1].strip())
    return [f"{r[0]}: " + "; ".join(r[1:]) for r in rows]


# K6's shapes at the encoder's T = 1536 with 1500 real rows: turbo (20
# heads of 64), the same width in heads of 128, and the parity matrix's mini
# (2 heads of 32) and multilingual mini (6 heads of 16), which take the
# CUDA-core kernel (phase 13 runs them)
FLASH_SHAPES = ((20, 64), (10, 128), (2, 32), (6, 16))
# the output is rounded to bf16: one bf16 step of the largest real output
# (2^-7 of it), as K4's check
FLASH_REL_TOL = 8e-3


def plain_over_keys(q, k, v, n_keys: int) -> torch.Tensor:
    """Every query row over keys [0, n_keys) only, at the plain version's
    rounding points: the planted faults of `check_flash_shape`."""
    qb, kb, vb = (a.to(torch.bfloat16).float() for a in (q, k[:, :n_keys], v[:, :n_keys]))
    s = torch.matmul(qb, kb.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = torch.matmul(p.to(torch.bfloat16).float(), vb) / p.sum(-1, keepdim=True)
    return o.to(torch.bfloat16).float()


def check_flash_shape(dev, FA, g, T: int, true_len: int, h: int, d: int) -> dict:
    """K6 at h heads of d against its plain version, on head views of an f32
    and a bf16 (T, 3S) projection with a ragged (true_len) and a whole
    length; at the ragged one each check also reads two planted faults (real
    rows that read the pad keys; real rows that skip the last partial
    64-key tile) and asserts that the tolerance sees them.  Then the device
    times of the kernel (f32 and bf16 qkv), the plain version and SDPA, and
    the bound."""
    S = h * d
    qkv = torch.randn((T, 3 * S), generator=g).to(dev)

    def views(buf):
        return [buf[:, i * S:(i + 1) * S].reshape(T, h, d).transpose(0, 1)
                for i in range(3)]

    err = 0.0
    faults = (("pad keys read", T), ("last partial tile dropped", true_len // 64 * 64))
    for name, src in (("f32", qkv), ("bf16", qkv.to(torch.bfloat16))):
        for n_real in (true_len, T):
            got = FA.flash_self_attention(*views(src), true_len=n_real)
            ref = FA.flash_self_attention_plain(*views(src), true_len=n_real)
            torch.cuda.synchronize()
            assert torch.isfinite(got).all()
            e = (got[:, :n_real] - ref[:, :n_real]).abs().max().item()
            tol = FLASH_REL_TOL * ref[:, :n_real].abs().max().item()
            seen = []
            if n_real < T:
                for fault, n_keys in faults:
                    f = (got[:, :n_real] - plain_over_keys(*views(src), n_keys)[:, :n_real])
                    seen.append((fault, f.abs().max().item()))
            log(f"  check flash_self_attention[H={h},T={T},true_len={n_real},D={d},"
                f"{name} qkv]: max_abs_err={e:.3e} tol={tol:.3e} (real rows)"
                + "".join(f" planted[{fault}]={f:.3e}" for fault, f in seen))
            assert math.isfinite(e) and e <= tol
            assert all(f > tol for _, f in seen), seen
            err = max(err, e)
    assert same_under_graph(lambda: FA.flash_self_attention(*views(qkv), true_len=true_len))
    # q, k, v read once (f32), the f32 output written once; the work is the
    # two segments: real rows against real keys, pad rows against pad keys
    nbytes = 4 * T * S * 4
    flops = 4.0 * h * d * (true_len ** 2 + (T - true_len) ** 2)
    copies = {}

    def buf(i, cast=None, whole=False):
        if (i, cast, whole) not in copies:
            b = views(qkv.clone().to(cast or torch.float32))
            copies[i, cast, whole] = [x.contiguous() for x in b] if whole else b
        return copies[i, cast, whole]

    real = torch.arange(T, device=dev) < true_len
    allow = real[:, None] == real[None, :]
    ms = device_ms(lambda i: (lambda q=buf(i): FA.flash_self_attention(
        *q, true_len=true_len)), nbytes)
    ms_bf16 = device_ms(lambda i: (lambda q=buf(i, torch.bfloat16): FA.flash_self_attention(
        *q, true_len=true_len)), nbytes - 3 * T * S * 2)
    plain_ms = device_ms(lambda i: (lambda q=buf(i): FA.flash_self_attention_plain(
        *q, true_len=true_len)), nbytes)
    library_ms = device_ms(lambda i: (lambda q=buf(i, torch.bfloat16, True):
                                      torch.nn.functional.scaled_dot_product_attention(
                                          *q, attn_mask=allow)), nbytes // 2)
    copies.clear()
    b_ms, by = bound_ms(nbytes, flops)
    log(f"  time  flash_self_attention[H={h},D={d},T={T}]: kernel_ms={ms:.5f} (f32 qkv) "
        f"kernel_bf16_qkv_ms={ms_bf16:.5f} plain_ms={plain_ms:.5f} "
        f"library_ms={library_ms:.5f} bound_ms={b_ms:.5f} ({by})")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bytes=nbytes,
                flops=flops, bound_ms=b_ms, err=err)


def check_flash(dev, FA, ptxas: str):
    """K6 at each of FLASH_SHAPES (`check_flash_shape`); the JSON row is
    turbo's, one encode's 32 layers as K4's, with the largest error of all
    shapes."""
    for kernel in ("flash_attn_kernel", "flash_attn_small_kernel"):
        for line in kernel_ptxas(ptxas, kernel):
            log(f"  ptxas {line}")
    T, true_len = 1536, 1500
    g = torch.Generator().manual_seed(4)
    rows = [check_flash_shape(dev, FA, g, T, true_len, h, d) for h, d in FLASH_SHAPES]
    turbo = rows[0]
    ms = turbo["ms"]
    log(f"  turbo flash_self_attention: launches_per_encode=32 per_encode_ms={32 * ms:.4f} "
        f"tflops={turbo['flops'] / ms / 1e9:.1f} target_2.5ms_per_encode_met={32 * ms <= 2.5} "
        f"half_bound_met={ms <= 2 * turbo['bound_ms']}")
    return dict(ms=32 * ms, plain_ms=32 * turbo["plain_ms"],
                library_ms=32 * turbo["library_ms"], bytes=32 * turbo["bytes"],
                flops=32 * turbo["flops"], err=max(r["err"] for r in rows))


def check_self_attention_qkv(dev, EA):
    """K4 at turbo widths: T = 1536 (1500 padded), S = 1280, 20 heads of 64,
    on the encoder's f32 (T, 3S) projection as the encoder hands it over;
    the bf16 input is checked and timed beside it."""
    T, true_len, H, D = 1536, 1500, 20, 64
    S = H * D
    g = torch.Generator().manual_seed(2)
    qkv = torch.randn((T, 3 * S), generator=g).to(dev)
    qkvb = qkv.to(torch.bfloat16)
    err = 0.0
    for name, buf in (("f32", qkv), ("bf16", qkvb)):
        out = EA.self_attention_qkv(buf, H, true_len=true_len)
        ref = EA.self_attention_qkv_plain(buf, H, true_len=true_len)
        torch.cuda.synchronize()
        e = (out.float() - ref.float()).abs().max().item()
        tol = 8e-3 * ref.float().abs().max().item()
        log(f"  check self_attention_qkv[T={T},true_len={true_len},{name} qkv]: "
            f"max_abs_err={e:.3e} tol={tol:.3e}")
        assert math.isfinite(e) and e <= tol
        err = max(err, e)
    assert same_under_graph(lambda: EA.self_attention_qkv(qkv, H, true_len=true_len))
    log("  check self_attention_qkv: bit-identical over two calls and a CUDA-graph replay")
    # key columns at or past true_len add exactly 0 to the output, so the
    # work the function needs reads k and v for true_len rows only; q and
    # the output keep all T rows.  q, k, v are read in f32, the output
    # written in bf16.
    nbytes = T * S * 4 + 2 * true_len * S * 4 + T * S * 2
    nbytes_bf16 = T * S * 2 + 2 * true_len * S * 2 + T * S * 2
    flops = 4.0 * T * true_len * S
    bufs = {}

    def buf(src, i):
        if (src.dtype, i) not in bufs:
            bufs[src.dtype, i] = src.clone()
        return bufs[src.dtype, i]

    def run_kernel(src):
        def make(i):
            b = buf(src, i)
            return lambda: EA.self_attention_qkv(b, H, true_len=true_len)
        return make

    def run_plain(i):
        b = buf(qkv, i)
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

    ms = device_ms(run_kernel(qkv), nbytes)
    ms_bf16 = device_ms(run_kernel(qkvb), nbytes_bf16)
    plain_ms = device_ms(run_plain, nbytes)
    library_ms = device_ms(run_library, nbytes_bf16)
    bufs.clear()
    lib.clear()
    b_ms, by = bound_ms(nbytes, flops)
    log(f"  time  self_attention_qkv[T={T}]: kernel_ms={ms:.5f} (f32 qkv) "
        f"kernel_bf16_qkv_ms={ms_bf16:.5f} plain_ms={plain_ms:.5f} "
        f"library_ms={library_ms:.5f} bound_ms={b_ms:.5f} ({by}) launches_per_encode=32 "
        f"per_encode_ms={32 * ms:.4f} target_0.25ms_met={ms <= 0.25}")
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


def window_fns(ctx):
    return list(ctx._window_fns.values())


def run_main_path(W, counters, path: str, kv_itype: str, pcm: np.ndarray,
                  repeats: int = 5):
    """load() + transcribe() of `pcm`: the first timed run's counts and
    launches, and the wall of `repeats` timed runs (median, min, max: the
    host sets the wall, and it spreads)."""
    from whisper_tpu_torch.decoding import device_loop as DL

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
    for fn in window_fns(ctx):
        fn.readbacks = fn.windows = fn.steps = 0
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    segs = W.transcribe(ctx, W.TranscribeParams(), pcm)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    launches = {fn.__name__: fn.launches for fn in counters}
    tm = copy.copy(ctx.timings)
    fns = window_fns(ctx)
    windows = sum(fn.windows for fn in fns)
    readbacks = sum(fn.readbacks for fn in fns)
    steps = sum(fn.steps for fn in fns)
    for _ in range(repeats - 1):
        t0 = time.perf_counter()
        again = W.transcribe(ctx, W.TranscribeParams(), pcm)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        assert [(s.t0, s.t1, s.text) for s in again] == [(s.t0, s.t1, s.text) for s in segs]
    log(f"  [{kv_itype}] load_s={t_load:.3f} warmup_3s_wall_s={t_warm:.3f} "
        f"transcribe_wall_s median={float(np.median(walls)):.3f} min={min(walls):.3f} "
        f"max={max(walls):.3f} runs={len(walls)} all={[round(w, 3) for w in walls]} "
        f"segments={len(segs)} windows={tm.n_encode}")
    for s in segs[:5]:
        log(f"    [{s.t0:6d} -> {s.t1:6d}] {s.text!r} tokens={[t.id for t in s.tokens]}")
    # t=0 attempts run the device window loop (t_decode: one lane, prompt
    # pass included, graph captures not); t>0 fallbacks run the host loop
    # (t_batchd: one batched step of best_of lanes, t_sample: its
    # host-side filters).  Counts are the first timed run's.
    log(f"  [{kv_itype}] encode_ms_per_window={ms_per(tm.t_encode_us, tm.n_encode):.3f} "
        f"device_loop_ms_per_token={ms_per(tm.t_decode_us, tm.n_decode):.3f} "
        f"device_loop_tokens={tm.n_decode} device_loop_windows={windows} "
        f"device_loop_steps={steps} device_loop_readbacks={readbacks} "
        f"graphs_captured={tm.n_capture} capture_ms={tm.t_capture_us / 1e3:.3f} "
        f"host_loop_ms_per_step={ms_per(tm.t_batchd_us, tm.n_batchd):.3f} "
        f"host_loop_steps={tm.n_batchd} host_sample_ms={tm.t_sample_us / 1e3:.3f} "
        f"fallbacks={tm.n_fail_p} max_memory_allocated={torch.cuda.max_memory_allocated()}")
    log(f"  [{kv_itype}] launches={json.dumps(launches)}")
    # the host reads the done flag every FLAG_EVERY steps
    n_max = ctx.hp.n_text_ctx // 2 - 4
    bound = windows * (math.ceil(n_max / DL.FLAG_EVERY) + 2)
    assert 0 < windows and readbacks <= bound, (readbacks, bound)
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


def check_bucketed(M, QM, DA, G, ctx, pcm: np.ndarray) -> dict:
    """decode_step_bucketed against the full-context decode_step on the
    turbo file's packed planes (K1), with the q8 self-KV cache (K3) and the
    f16 one: a prompt pass, then greedy steps fed the full step's tokens up
    to the last cell, so the occupancy passes through every attention
    bucket (128, 256, 384, 448).  Each step's argmax equal and its logits
    within K3_REL_TOL of the largest |logit| (a bucket changes K3's
    reduction: bit-equality is not asked); the contexts K3 was launched at
    and the K1 and K3 launches of the bucketed steps."""
    hp, dev, v = ctx.hp, ctx.device, ctx.vocab
    bf16 = torch.bfloat16
    ctx.pcm_to_mel(pcm)
    ctx.encode_window(0)
    xk, xv = ctx.xk, ctx.xv
    prompt = [v.token_sot, v.lang_token(0), v.token_transcribe]
    counted = (QM.qmmt_fused, DA.self_attend_q8)
    ctxs = []

    class Spy:
        """The model's view of ops/decode_attn.py, recording the context of
        each K3 call (the wrapper itself stays in place: it counts its
        launches on its own function object)."""

        def __getattr__(self, name):
            return getattr(DA, name)

        @staticmethod
        def self_attend_q8(*a, **k):
            ctxs.append(k["attn_ctx"])
            return DA.self_attend_q8(*a, **k)

    out = {}
    for itype in ("q8", "f16"):
        ctxs.clear()
        caches = [M.new_cache(hp, 1, bf16, itype=itype, device=dev) for _ in range(2)]
        tok = torch.tensor([prompt], device=dev)
        pos = torch.arange(len(prompt), device=dev)[None]
        errs, scales, agree = [], [], []
        launches = dict.fromkeys((fn.__name__ for fn in counted), 0)
        t_b = t_f = 0.0
        head = 0
        with G.DEVICE_LOCK:
            M.decode_attn = Spy()
            try:
                while head + tok.shape[1] <= hp.n_text_ctx:
                    before = [fn.launches for fn in counted]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    lb, caches[0] = M.decode_step_bucketed(ctx.params, tok, pos, head,
                                                           caches[0], xk, xv, hp, dtype=bf16)
                    torch.cuda.synchronize()
                    t_b += time.perf_counter() - t0
                    for fn, n0 in zip(counted, before):
                        launches[fn.__name__] += fn.launches - n0
                    t0 = time.perf_counter()
                    lf, caches[1] = M.decode_step(ctx.params, tok, pos, head, caches[1], xk,
                                                  xv, hp, dtype=bf16)
                    torch.cuda.synchronize()
                    t_f += time.perf_counter() - t0
                    lb, lf = lb[:, -1], lf[:, -1]
                    errs.append((lb - lf).abs().max())
                    scales.append(lf.abs().max())
                    agree.append((lb.argmax(-1) == lf.argmax(-1)).all())
                    head += tok.shape[1]
                    tok = lf.argmax(-1, keepdim=True)
                    pos = torch.full((1, 1), min(head, hp.n_text_ctx - 1), device=dev)
            finally:
                M.decode_attn = DA
        err = torch.stack(errs).float().cpu()
        scale = torch.stack(scales).float().cpu()
        rel = float((err / scale).max())
        same = bool(torch.stack(agree).all())
        n = len(errs)
        seen = sorted(set(ctxs))
        log(f"  bucketed step [{itype}] vs full context: steps={n} (prompt pass + {n - 1}, "
            f"last occupancy {head}) argmax equal={same} max_rel_err={rel:.3e} "
            f"(tol {K3_REL_TOL:.0e} of max |logit|) max_abs_err={float(err.max()):.3e} "
            f"K3 attn_ctx={seen} launches={json.dumps(launches)} host_ms_per_step "
            f"bucketed={1e3 * t_b / n:.3f} full={1e3 * t_f / n:.3f}")
        assert same and math.isfinite(rel) and rel <= K3_REL_TOL
        assert launches["qmmt_fused"] > 0
        if itype == "q8":
            assert launches["self_attend_q8"] > 0 and seen == list(M.attn_ctx_buckets(448))
        else:
            assert launches["self_attend_q8"] == 0
        out[itype] = {"launches": launches, "rel": rel}
    return out


def check_qmm_auto(QM, dev) -> None:
    """`qmm_auto` (the product over file-orientation planes: `_mm` on a
    QWeight, the logits head without its transposed planes; plain tensor
    code) on the card against the CPU: turbo's mlp0 planes with affine
    f16-derived scales and mins, 3 rows; both round W to bf16 in two steps
    and sum in f32, so only the order of the sums differs: within 1e-4 of
    max |y| (cuBLAS may split the 1280 products' sum, where the CPU test
    holds the CPU to JAX at 1e-5)."""
    g = torch.Generator().manual_seed(5)
    R, K = 5120, 1280
    qw = QM.QWeight(torch.randint(0, 32, (R, K), generator=g, dtype=torch.int8),
                    (0.001 + 0.02 * torch.rand((R, K // 32), generator=g)).half().float(),
                    (-0.3 * torch.rand((R, K // 32), generator=g)).half().float())
    x = torch.randn((3, K), generator=g)
    ref = QM.qmm_auto(x, qw)
    y = QM.qmm_auto(x.to(dev), QM.QWeight(*(a.to(dev) for a in qw))).cpu()
    err, scale = float((y - ref).abs().max()), float(ref.abs().max())
    log(f"  qmm_auto card vs CPU (R={R}, K={K}, T=3, bf16, affine): max_abs_err={err:.3e} "
        f"tol={1e-4 * scale:.3e}")
    assert math.isfinite(err) and err <= 1e-4 * scale

class _Eager:
    """A window decoder with its eager loop in place of its graphs."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn.eager(*args)

    def __getattr__(self, name):
        return getattr(self.fn, name)


@contextlib.contextmanager
def eager_windows(ctx):
    """Inside, every window decoder `ctx` has built runs its eager loop:
    the reference for its CUDA graphs."""
    fns = ctx._window_fns
    ctx._window_fns = {k: _Eager(f) for k, f in fns.items()}
    try:
        yield
    finally:
        ctx._window_fns = fns


def graph_matches_eager(ctx, counters, strategy: str, seeks, temperature: float = 0.0,
                        n_lanes: int = 1) -> None:
    """Windows of `ctx` (its mel set) through the window loop's CUDA graphs
    and through its eager loop on the card: the same WindowResult bit for
    bit and the same kernel launches (replays counted; none in the parity
    mode), window after window, each encoded anew (a graph that read a
    stale cross-K/V would differ from the eager loop from the second window
    on)."""
    v = ctx.vocab
    prompt = [v.token_sot, v.lang_token(0), v.token_transcribe]
    import whisper_tpu_torch as W

    params = (W.TranscribeParams.default(W.SamplingStrategy.BEAM_SEARCH)
              if strategy == "beam" else W.TranscribeParams())

    def window(seek):
        return ctx.decode_window_device(prompt, n_lanes, temperature, seek,
                                        ctx.n_len_org, params, False,
                                        rng_seed=seek + 7, strategy=strategy)

    ctx.encode_window(seeks[0])
    first = window(seeks[0])               # captures this decoder's graphs
    for seek in seeks:
        ctx.encode_window(seek)
        out = {}
        for mode in ("graphs", "eager"):
            for fn in counters:
                fn.launches = 0
            with eager_windows(ctx) if mode == "eager" else contextlib.nullcontext():
                res = window(seek)
            out[mode] = (res, {fn.__name__: fn.launches for fn in counters})
        (g, n_g), (e, n_e) = out["graphs"], out["eager"]
        for name in g._fields:
            assert np.array_equal(getattr(g, name), getattr(e, name)), (strategy, seek, name)
        assert n_g == n_e, (n_g, n_e)
        if ctx.parity:                    # no kernel but K3 on a q8 cache
            k3 = n_g["self_attend_q8"]
            assert (k3 > 0) == (ctx.kv_itype == "q8") and sum(n_g.values()) == k3, n_g
        else:
            assert n_g["qmmt_fused"] > 0, n_g
        if seek == seeks[0]:
            # the same window again, with the same rng_seed: the same tokens
            assert np.array_equal(first.tok_id, g.tok_id)
        log(f"  [{strategy} t={temperature} lanes={n_lanes} seek={seek}"
            f"{' parity' if ctx.parity else ''}] graphs == eager bit for bit: "
            f"tokens={int(g.n_tok.max())} launches={json.dumps(n_g)}")


def native_graph_matches_eager(ctx, counters, strategy: str, n_windows: int,
                               n_lanes: int, temperature: float = 0.0) -> None:
    """`n_windows` windows of `ctx` (its mel set; seeks 0, 3000, 0, ...,
    prompts of different lengths, so the batch left-pads them) natively
    batched, through the window decoder's CUDA graphs and through its eager
    loop: the same WindowResult bit for bit and the same kernel launches
    (replays counted), twice (the second graph call replays on windows
    loaded anew)."""
    from whisper_tpu_torch.decoding import device_loop as DL
    from whisper_tpu_torch.runtime.batching import _stack

    import whisper_tpu_torch as W

    v = ctx.vocab
    params = (W.TranscribeParams.default(W.SamplingStrategy.BEAM_SEARCH)
              if strategy == "beam" else W.TranscribeParams())
    seeks = [3000 * (w % 2) for w in range(n_windows)]
    bt = 8
    rows, lens, xks, xvs = [], [], [], []
    for w, seek in enumerate(seeks):
        prompt = (([v.token_prev, *range(300, 300 + w)] if w else [])
                  + [v.token_sot, v.lang_token(0), v.token_transcribe])
        ctx.encode_window(seek)
        row = np.zeros(bt, np.int64)
        row[:len(prompt)] = prompt
        rows.append(row)
        lens.append(len(prompt))
        xks.append(ctx.xk)
        xvs.append(ctx.xv)
    base, initial = (torch.from_numpy(a).to(ctx.device)
                     for a in DL.build_masks(ctx.filter_tables, params))
    args = (ctx.params, torch.from_numpy(np.stack(rows)).to(ctx.device), lens,
            _stack(xks), _stack(xvs), base, initial, [temperature] * n_windows, seeks,
            [s + 3500 for s in seeks], 0, [7 + w for w in range(n_windows)])
    fn = ctx.window_decoder((n_lanes, bt, False, False, strategy), n_windows=n_windows)
    fn(*args)                             # captures this decoder's graphs
    out = {}
    for mode in ("graphs", "eager", "graphs again"):
        for f in counters:
            f.launches = 0
        res = fn.eager(*args) if mode == "eager" else fn(*args)
        out[mode] = (res, {f.__name__: f.launches for f in counters})
    (g, n_g), (e, n_e), (g2, n_g2) = out["graphs"], out["eager"], out["graphs again"]
    for name in g._fields:
        assert np.array_equal(getattr(g, name), getattr(e, name)), (strategy, name)
        assert np.array_equal(getattr(g, name), getattr(g2, name)), (strategy, name)
    assert n_g == n_e == n_g2 and n_g["qmmt_fused"] > 0, (n_g, n_e, n_g2)
    assert g.tok_id.shape[:2] == (n_windows, n_lanes) and g.n_tok.min() > 1
    log(f"  [{strategy} W={n_windows} G={n_lanes} t={temperature} {ctx.kv_itype}] native "
        f"graphs == eager bit for bit: tokens={g.n_tok.max(axis=1).tolist()} "
        f"launches={json.dumps(n_g)}")


def flag_period_sweep(W, DL, ctx, pcm: np.ndarray, periods=(1, 2, 4, 8, 16),
                      repeats: int = 6) -> None:
    """A window at t = 0 (encode + the window loop's graphs) for several
    flag periods (steps per read of the done flag), in turns, the order
    reversed every other round: per period the median time in the window
    loop (ctx.timings.t_decode_us: prompt pass, replays, flag and result
    reads) and of the whole transcribe, the steps run and the flag reads."""
    params = W.TranscribeParams(temperature_inc=0.0)
    chosen = DL.FLAG_EVERY
    W.transcribe(ctx, params, pcm)                # the graphs serve every k
    loop_ms, walls, counts = ({k: [] for k in periods} for _ in range(3))
    try:
        for r in range(repeats):
            for k in (periods if r % 2 == 0 else periods[::-1]):
                DL.FLAG_EVERY = k
                ctx.timings.reset()
                for fn in window_fns(ctx):
                    fn.readbacks = fn.steps = 0
                t0 = time.perf_counter()
                W.transcribe(ctx, params, pcm)
                torch.cuda.synchronize()
                walls[k].append(1e3 * (time.perf_counter() - t0))
                loop_ms[k].append(ctx.timings.t_decode_us / 1e3)
                fns = window_fns(ctx)
                counts[k] = (sum(fn.steps for fn in fns), sum(fn.readbacks for fn in fns),
                             ctx.timings.n_decode)
    finally:
        DL.FLAG_EVERY = chosen
    for k in periods:
        steps, reads, tokens = counts[k]
        log(f"  flag period k={k}: window_loop_ms median={float(np.median(loop_ms[k])):.3f} "
            f"min={min(loop_ms[k]):.3f} max={max(loop_ms[k]):.3f} "
            f"wall_ms median={float(np.median(walls[k])):.3f} min={min(walls[k]):.3f} "
            f"max={max(walls[k]):.3f} steps={steps} readbacks={reads} tokens={tokens} "
            f"runs={repeats}{' (chosen)' if k == chosen else ''}")


def ms_per(t_us: int, n: int) -> float:
    return t_us / 1e3 / max(n, 1)


def dev_us(e):
    return getattr(e, "self_device_time_total", None) or e.self_cuda_time_total


def device_events(prof):
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def profile_window(W, ctx, pcm: np.ndarray, label: str, beam: bool = False) -> None:
    """One window at t = 0 (encode + the device window loop, no fallback;
    greedy, or beam search of 5) under torch.profiler: the device's busy
    share of the wall time, kernel launches per decode step, and device
    time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    if beam:
        params = W.TranscribeParams.default(W.SamplingStrategy.BEAM_SEARCH)
        params.temperature_inc = 0.0
    else:
        params = W.TranscribeParams(temperature_inc=0.0)
    W.transcribe(ctx, params, pcm)
    torch.cuda.synchronize()
    ctx.timings.reset()
    for fn in window_fns(ctx):
        fn.readbacks = fn.steps = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        W.transcribe(ctx, params, pcm)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    tm = ctx.timings

    on_dev = device_events(prof)
    busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
    n_launch = sum(e.count for e in on_dev)
    fns = window_fns(ctx)
    log(f"  profile [{label}{' beam 5' if beam else ''}]: wall_ms={wall_ms:.3f} "
        f"device_busy_ms={busy_ms:.3f} "
        f"idle_share={1 - busy_ms / wall_ms:.4f} device_events={n_launch} "
        f"windows={tm.n_encode} decode_tokens={tm.n_decode} "
        f"steps={sum(fn.steps for fn in fns)} readbacks={sum(fn.readbacks for fn in fns)} "
        f"encode_ms={ms_per(tm.t_encode_us, tm.n_encode):.3f} "
        f"device_loop_ms_per_token={ms_per(tm.t_decode_us, tm.n_decode):.3f} "
        f"(profiler on)")
    for e in sorted(on_dev, key=dev_us, reverse=True)[:15]:
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
        casts = sum(e.count for e in on_dev if "copy" in e.key)
        log(f"  encode route={route}: encode_wall_ms={ms:.3f} device_busy_ms={busy:.3f} "
            f"attention_kernel_ms={attn:.3f} copy_kernel_launches={casts} "
            f"device_launches={sum(e.count for e in on_dev)} (profiler) "
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
    card, writing -otxt -ojf; wall time of the CLI and of its transcribe
    (with -p, which does not call `transcribe`, the CLI's alone)."""
    for fn in counters:
        fn.launches = 0
    inner, timed = W.transcribe, {}

    def transcribe(ctx, *a, **kw):
        t0 = time.perf_counter()
        segs = inner(ctx, *a, **kw)
        torch.cuda.synchronize()
        timed["s"] = time.perf_counter() - t0
        timed["tm"] = ctx.timings
        timed["readbacks"] = sum(fn.readbacks for fn in window_fns(ctx))
        return segs

    W.transcribe = transcribe
    base = os.path.join(out_dir, "cli" + "".join(
        os.path.basename(a) for a in extra).replace("-", "_"))
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
    log(f"  whisper-cli {' '.join(extra) or '(defaults)'}: cli_wall_s={wall:.3f} "
        + (f"transcribe_wall_s={timed['s']:.3f} " if timed else "")
        + f"segments={len(segs)} txt_lines={n_lines}")
    if timed:
        # a host-loop run (the parity mode, grammars) counts its one-lane
        # steps where the window loop counts its tokens (t_decode_us)
        tm = timed["tm"]
        log(f"    encode_ms_per_window={ms_per(tm.t_encode_us, tm.n_encode):.3f} "
            f"windows={tm.n_encode} device_loop_ms_per_step={ms_per(tm.t_decode_us, tm.n_decode):.3f} "
            f"device_loop_steps={tm.n_decode} device_loop_readbacks={timed['readbacks']} "
            f"graphs_captured={tm.n_capture} capture_ms={tm.t_capture_us / 1e3:.3f} "
            f"host_loop_ms_per_step={ms_per(tm.t_batchd_us, tm.n_batchd):.3f} "
            f"host_loop_steps={tm.n_batchd} host_sample_ms={tm.t_sample_us / 1e3:.3f} "
            f"fallbacks={tm.n_fail_p}")
    log(f"    launches={json.dumps(launches)}")
    for sg in segs[:6]:
        log(f"    [{sg['offsets']['from']:7d} -> {sg['offsets']['to']:7d}] {sg['text']!r}")
    assert segs and n_lines == len(segs)
    assert all(0 <= t["id"] < 51866 for sg in segs for t in sg["tokens"])
    return launches


@contextlib.contextmanager
def dtw_matrices(DTW, into: list):
    """Inside, each DTW cost matrix (tokens x audio tokens, after the
    normalisation, median filter and head mean) is appended to `into`."""
    inner = DTW.dtw_and_backtrace

    def keep(x):
        into.append(x.copy())
        return inner(x)

    DTW.dtw_and_backtrace = keep
    try:
        yield
    finally:
        DTW.dtw_and_backtrace = inner


DTW_NEAR_TIE = 1e-3     # relative cost gap of two DTW paths that a bf16-level matrix flips


def dtw_paths_tie(DTW, name: str, card_m: list, cpu_m: list) -> bool:
    """Where the card's and the CPU's DTW paths differ, whether each such
    window is a near-tie: under the CPU's matrix the card's path costs
    within DTW_NEAR_TIE (relative) of the CPU's optimal one.  Logs each
    window's matrix difference and cost gap."""
    ok = True
    for w, (a, b) in enumerate(zip(card_m, cpu_m)):
        pa, pb = DTW.dtw_and_backtrace(a), DTW.dtw_and_backtrace(b)
        cost = lambda m, pth: float(m[pth[0], pth[1]].astype(np.float64).sum())
        d = float(np.abs(a - b).max())
        gap = cost(b, pa) - cost(b, pb)
        same = np.array_equal(pa, pb)
        log(f"  [{name}] dtw window {w}: max|M_card - M_cpu|={d:.3e} (max|M| "
            f"{np.abs(b).max():.3e}) paths_equal={same} cost_gap_under_cpu_M={gap:.3e} "
            f"(relative {abs(gap) / abs(cost(b, pb)):.3e})")
        ok &= same or abs(gap) <= DTW_NEAR_TIE * abs(cost(b, pb))
    return ok


def card_matches_cpu(tmp: str) -> None:
    """The slice on the card against the slice on the CPU (bf16 compute,
    packed weights on both; the card's default device mel, the CPU's numpy
    mel; DTW token timestamps on, n_top_most=1, so each window's DTW pass
    runs K2 on the card and its plain version on the CPU) on a small
    decisive model and 35 s of seeded audio: identical segments and t_dtw
    over two windows (t_dtw may differ, by an audio token at most, only
    where the two DTW paths nearly tie: `dtw_paths_tie`; the bf16 cost
    matrices differ by ~1e-2), greedy for both kv caches,
    beam search for both kv caches, greedy on the flash encoder route
    (WTPU_ENC_ATTN=flash: K6 on the card, its plain version on the CPU),
    and greedy on -nfa's graphs (flash off, WTPU_ENC_ATTN and
    WTPU_DECODE_ATTN `xla`: the unpadded plain encoder, and the q8 cache's
    dequantize-and-attend graph in place of K3).
    tests/test_torch_gpu.py runs this same check."""
    import whisper_tpu_torch as W
    from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
    from whisper_tpu_torch.ops import attention as FA
    from whisper_tpu_torch.decoding import dtw as DTW
    from whisper_tpu_torch.ops import decode_attn as DA
    from whisper_tpu_torch.ops import qmm as QM
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
        QM.qmmt.launches = 0
        card_ctx = W.load(path, kv_itype=kv)
        cpu_ctx = W.load(path, device="cpu", kv_itype=kv, use_packed_weights=True,
                         compute_dtype=torch.bfloat16)
        assert (card_ctx.mel_fn.backend, cpu_ctx.mel_fn.backend) == ("torch", "numpy")
        for c in (card_ctx, cpu_ctx):
            c.enable_dtw(n_top_most=1)
        card_m, cpu_m = [], []
        with dtw_matrices(DTW, card_m):
            gpu = W.transcribe(card_ctx, params, audio)
        n_k6, n_k3, n_k2 = (FA.flash_self_attention.launches, DA.self_attend_q8.launches,
                            QM.qmmt.launches)
        with dtw_matrices(DTW, cpu_m):
            cpu = W.transcribe(cpu_ctx, params, audio)
        del os.environ["WTPU_ENC_ATTN"], os.environ["WTPU_DECODE_ATTN"]
        FA.set_flash_enabled(True)
        a = [(s.t0, s.t1, s.text) for s in gpu]
        b = [(s.t0, s.t1, s.text) for s in cpu]
        log(f"  [{name} {kv}] card segments={a}")
        assert a == b and len(a) >= 2, (a, b)
        ta = [[t.t_dtw for t in s.tokens] for s in gpu]
        tb = [[t.t_dtw for t in s.tokens] for s in cpu]
        assert any(t >= 0 for ts in ta for t in ts) and len(card_m) == len(cpu_m)
        if ta != tb:
            log(f"  [{name} {kv}] t_dtw differ: card={ta} cpu={tb}")
            assert all(abs(x - y) <= 2 for sa, sb in zip(ta, tb) for x, y in zip(sa, sb))
            assert dtw_paths_tie(DTW, f"{name} {kv}", card_m, cpu_m), (ta, tb)
        assert (n_k6 > 0) == (enc_route == "flash"), n_k6
        assert (n_k3 > 0) == (kv == "q8" and dec_route == "auto"), n_k3
        assert n_k2 == 6 * 3 * card_ctx.timings.n_dtw > 0, n_k2
        d_max = max(float(np.abs(x - y).max()) for x, y in zip(card_m, cpu_m))
        log(f"  [{name} {kv}] card == cpu: {len(a)} segments identical, t_dtw "
            f"{'identical' if ta == tb else 'one audio token apart at a near-tie'} "
            f"(DTW cost matrices max|card - cpu|={d_max:.3e}) "
            f"(launches on the card: flash_self_attention {n_k6}, self_attend_q8 {n_k3}, "
            f"qmmt {n_k2} over {card_ctx.timings.n_dtw} DTW passes)")


# ---------------------------------------------------------------------------
# phase 6: batched serving
# ---------------------------------------------------------------------------

def _multipart(fields) -> tuple:
    boundary = "----whisper-tpu-torch-smoke"
    out = []
    for name, (filename, content) in fields.items():
        dispo = f'Content-Disposition: form-data; name="{name}"'
        if filename:
            dispo += f'; filename="{filename}"'
        out += [f"--{boundary}\r\n{dispo}\r\n\r\n".encode(),
                content if isinstance(content, bytes) else content.encode(), b"\r\n"]
    out.append(f"--{boundary}--\r\n".encode())
    return b"".join(out), f"multipart/form-data; boundary={boundary}"


def _post(url: str, fields) -> tuple:
    """(HTTP status, body, seconds) of one multipart POST."""
    import urllib.request

    body, ctype = _multipart(fields)
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        out = r.status, r.read().decode("utf-8")
    return (*out, time.perf_counter() - t0)


def _volley(url: str, requests) -> tuple:
    """`requests` ([(name, fields)]) posted at once, one thread each:
    (wall seconds of the volley, {name: (body, seconds)})."""
    import threading

    out, errors = {}, []

    def hit(name, fields):
        try:
            status, body, sec = _post(url + "/inference", fields)
            assert status == 200, (name, status)
            out[name] = (body, sec)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=hit, args=r) for r in requests]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall, out


def batched_step_ms(ctx, pcms, repeats: int = 3) -> None:
    """The t = 0 greedy window decode of the first 30 s of each of `pcms`
    on the window loop's graphs: solo, one window after another, and
    natively batched (W = len(pcms)), `repeats` times in turns.  Per mode
    the median of the host clock around the calls (ending in their result
    reads) over the steps they ran: ms per step, prompt passes and reads
    included."""
    from whisper_tpu_torch.decoding import device_loop as DL
    from whisper_tpu_torch.runtime.batching import _stack

    import whisper_tpu_torch as W

    v = ctx.vocab
    subs = []
    for pcm in pcms:
        sub = ctx.clone_state()
        sub.pcm_to_mel(pcm)
        sub.encode_window(0)
        subs.append(sub)
    base, initial = (torch.from_numpy(a).to(ctx.device) for a in DL.build_masks(
        subs[0].filter_tables, W.TranscribeParams()))
    row = torch.tensor([v.token_sot, v.lang_token(0), v.token_transcribe, 0],
                       device=ctx.device)
    key = (1, 4, False, False, "greedy")
    n = len(subs)
    solo_fn, native_fn = ctx.window_decoder(key), ctx.window_decoder(key, n_windows=n)

    def solo():
        return [solo_fn(ctx.params, row, 3, s.xk, s.xv, base, initial, 0.0, 0,
                        s.n_len_org, 0, 0) for s in subs]

    def batched():
        return native_fn(ctx.params, row.expand(n, 4), [3] * n, _stack([s.xk for s in subs]),
                         _stack([s.xv for s in subs]), base, initial, [0.0] * n, [0] * n,
                         [s.n_len_org for s in subs], 0, [0] * n)

    runs = {"solo": (solo, solo_fn, []), "batched": (batched, native_fn, [])}
    for r in range(repeats + 1):
        for name in (("solo", "batched") if r % 2 else ("batched", "solo")):
            call, fn, out = runs[name]
            steps = fn.steps
            t0 = time.perf_counter()
            res = call()
            torch.cuda.synchronize()
            if r:                            # the first round warms up
                out.append((1e3 * (time.perf_counter() - t0), fn.steps - steps))
            runs[name] = (call, fn, out)
    same = all(np.array_equal(b, s.tok_id[0]) for b, s in zip(batched().tok_id[:, 0], solo()))
    ms = {k: float(np.median([t / st for t, st in v[2]])) for k, v in runs.items()}
    steps = {k: v[2][-1][1] for k, v in runs.items()}
    log(f"  window loop, t=0 greedy, {n} windows: ms_per_step solo={ms['solo']:.4f} "
        f"(steps per run {steps['solo']}) batched_W{n}={ms['batched']:.4f} "
        f"(steps per run {steps['batched']}) step_ratio={ms['batched'] / ms['solo']:.3f} "
        f"window_steps_per_ms solo={1 / ms['solo']:.3f} batched={n / ms['batched']:.3f} "
        f"tokens_equal={same} runs={repeats}")


SOLO_GREEDY = 2       # greedy requests replayed alone in phase 6


def serve_batched(TS, counters, path: str, tmp: str) -> dict:
    """The port's whisper-server on the card (turbo file, the server's
    defaults: f16 cache, greedy or beam search 5 per request, fallbacks on)
    at 127.0.0.1, port 0: one warm-up request, then 4 concurrent greedy
    requests (distinct seeded 40 s clips), 2 concurrent beam_size=5
    requests, and SOLO_GREEDY of the greedy ones and both beam ones again
    alone, one after another (the phase's time cap leaves no room for all
    4 greedy replays).  Each replayed response must equal its concurrent
    one (srt: text and timestamps); the batcher must have coalesced.
    Returns the launches of this path (counts set to 0 just before the
    concurrent requests, read after the last solo one)."""
    import threading

    from whisper_tpu_torch.audio.io import write_wav

    def clip(seconds, seed):
        f = os.path.join(tmp, f"clip-{seed}.wav")
        write_wav(f, seeded_audio(seconds, seed))
        with open(f, "rb") as fh:
            return fh.read()

    greedy = [(f"greedy{i}", {"file": ("clip.wav", clip(40.0, 1 + i)),
                              "response_format": ("", "srt")}) for i in range(4)]
    beam = [(f"beam{i}", {"file": ("clip.wav", clip(40.0, 5 + i)),
                          "response_format": ("", "srt"), "beam_size": ("", "5")})
            for i in range(2)]
    from whisper_tpu_torch.decoding import timestamps as TT

    # each request's own timers (its context clone's), in arrival order, and
    # the time in token-level timestamps (host code the timers do not cover;
    # the server turns them on unless a request asks for no timestamps)
    seen, tt_ms = [], [0.0]
    joining, token_ts = TS.transcribe_joining, TT.compute_token_level_timestamps

    def timed_joining(*args):
        t0 = time.perf_counter()
        segs, sub = joining(*args)
        seen.append((time.perf_counter() - t0, sub.timings))
        return segs, sub

    def timed_token_ts(*args):
        t0 = time.perf_counter()
        out = token_ts(*args)
        tt_ms[0] += 1e3 * (time.perf_counter() - t0)
        return out

    def mark():
        seen.clear()
        tt_ms[0] = 0.0

    def breakdown(label, entries, token_ts_ms):
        tm = [t for _, t in entries]
        tot = lambda f: sum(getattr(t, f) for t in tm) / 1e3
        wall = 1e3 * sum(w for w, _ in entries)
        parts = {"mel": tot("t_mel_us"), "encode": tot("t_encode_us"),
                 "window_loop": tot("t_decode_us"), "captures": tot("t_capture_us"),
                 "host_loop": tot("t_batchd_us"), "host_filters": tot("t_sample_us"),
                 "token_timestamps": token_ts_ms}
        log(f"  {label}: transcribe_ms={wall:.1f} " + " ".join(
            f"{k}_ms={v:.1f}" for k, v in parts.items())
            + f" rest_ms={wall - sum(parts.values()):.1f} encodes={sum(t.n_encode for t in tm)} "
            f"window_tokens={sum(t.n_decode for t in tm)} host_loop_steps="
            f"{sum(t.n_batchd for t in tm)} fallbacks={sum(t.n_fail_p for t in tm)} "
            f"(summed over {len(tm)} requests; window_loop includes waiting in the batcher)")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    TS.transcribe_joining, TT.compute_token_level_timestamps = timed_joining, timed_token_ts
    httpd = TS.serve(path, host="127.0.0.1", port=0, defaults={"language": "en"})
    state = httpd.whisper_state
    ctx, batcher = state.get()
    t_load = time.perf_counter() - t0
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        t0 = time.perf_counter()
        status, _, _ = _post(url + "/inference", {"file": ("clip.wav", clip(3.0, 9))})
        assert status == 200
        t_warm = time.perf_counter() - t0
        base = (batcher.n_rounds, batcher.n_coalesced_rounds, batcher.t_round_us)
        g0 = sum(f.graphs for f in window_fns(ctx))
        c0 = sum(f.capture_us for f in window_fns(ctx))
        for fn in counters:
            fn.launches = 0
        mark()
        greedy_wall, conc = _volley(url, greedy)
        conc_timers = (list(seen), tt_ms[0])
        beam_wall, conc_beam = _volley(url, beam)
        conc.update(conc_beam)
        rounds = batcher.n_rounds - base[0]
        coalesced = batcher.n_coalesced_rounds - base[1]
        round_ms = (batcher.t_round_us - base[2]) / 1e3
        largest = batcher.max_round_size
        solo = {}
        mark()
        for i, (name, fields) in enumerate(greedy[:SOLO_GREEDY] + beam):
            if i == SOLO_GREEDY:
                solo_timers = (list(seen), tt_ms[0])
            status, body, sec = _post(url + "/inference", fields)
            assert status == 200
            solo[name] = (body, sec)
        launches = {fn.__name__: fn.launches for fn in counters}
        fns = window_fns(ctx)
        graphs = sum(f.graphs for f in fns) - g0
        capture_ms = (sum(f.capture_us for f in fns) - c0) / 1e3
        native = sorted(k[2] for k in ctx._window_fns if len(k) == 3 and k[1] == "native")
        peak = torch.cuda.max_memory_allocated()
        batched_step_ms(ctx, [seeded_audio(30.0, 1 + i) for i in range(4)])
    finally:
        TS.transcribe_joining, TT.compute_token_level_timestamps = joining, token_ts
        httpd.shutdown()
        httpd.server_close()
        thread.join()
    log(f"  server: load_s={t_load:.3f} warmup_s={t_warm:.3f} kv_itype={ctx.kv_itype}")
    log(f"  batcher (the 6 concurrent requests): rounds={rounds} coalesced_rounds={coalesced} "
        f"largest_round={largest} round_ms={round_ms:.3f} "
        f"round_ms_mean={round_ms / max(rounds, 1):.3f} native_decoders_W={native}")
    # the 4 requests one after another, estimated from the replayed ones
    solo_greedy = len(greedy) / SOLO_GREEDY * sum(solo[n][1] for n, _ in greedy[:SOLO_GREEDY])
    log(f"  4 concurrent greedy requests: wall_s={greedy_wall:.3f} "
        f"sequential_s_est={solo_greedy:.3f} (4/{SOLO_GREEDY} x the {SOLO_GREEDY} replayed "
        f"alone) ratio={greedy_wall / solo_greedy:.3f} "
        f"per_request_s={[round(conc[n][1], 3) for n, _ in greedy]} "
        f"solo_s={[round(solo[n][1], 3) for n, _ in greedy[:SOLO_GREEDY]]}")
    breakdown("4 concurrent greedy, per-request timers", *conc_timers)
    breakdown(f"{SOLO_GREEDY} of those greedy alone, per-request timers", *solo_timers)
    solo_beam = sum(solo[n][1] for n, _ in beam)
    log(f"  2 concurrent beam-5 requests: wall_s={beam_wall:.3f} "
        f"sum_of_solo_walls_s={solo_beam:.3f} ratio={beam_wall / solo_beam:.3f}")
    log(f"  graphs_captured={graphs} capture_ms={capture_ms:.3f} "
        f"max_memory_allocated={peak}")
    log(f"  server path launches={json.dumps(launches)}")
    for name, _ in greedy + beam:
        same = conc[name][0] == solo[name][0] if name in solo else "not replayed"
        first = conc[name][0].split("\n\n")[0].replace("\n", " | ")
        log(f"    {name}: concurrent == solo: {same} segments={conc[name][0].count('-->')} "
            f"first={first!r}")
        assert same, (name, conc[name][0], solo[name][0])
        assert conc[name][0].count("-->") >= 1
    assert largest >= 2 and coalesced >= 1, (rounds, coalesced, largest)
    assert launches["qmmt_fused"] > 0 and launches["self_attention_qkv"] > 0, launches
    return launches


def run_cli_parallel(TC, TB, counters, model_path: str, wav: str, out_dir: str) -> dict:
    """The port's whisper-cli with -p 4 --kv-itype q8 (four chunks of one
    40 s file whose windows batch natively; beam 5 by default): its
    launches, the batcher's rounds, and the outputs' form."""
    sizes = []
    inner = TB.WindowBatcher._take_locked

    def counted(self):
        sizes.append(len(self.pending))
        return inner(self)

    for fn in counters:
        fn.launches = 0
    base = os.path.join(out_dir, "cli_p4_q8")
    TB.WindowBatcher._take_locked = counted
    t0 = time.perf_counter()
    try:
        # the segments it prints go to a file (the output files hold them)
        with open(base + ".stdout", "w") as out, contextlib.redirect_stdout(out):
            rc = TC.run(["-m", model_path, "-f", wav, "-p", "4", "--kv-itype", "q8",
                         "-otxt", "-ojf", "-of", base, "-np"])
    finally:
        TB.WindowBatcher._take_locked = inner
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    assert rc == 0
    with open(base + ".json") as f:
        segs = json.load(f)["transcription"]
    log(f"  whisper-cli -p 4 --kv-itype q8: cli_wall_s={wall:.3f} segments={len(segs)} "
        f"batcher_rounds={len(sizes)} round_sizes={sizes}")
    log(f"    launches={json.dumps(launches)}")
    for sg in segs[:4]:
        log(f"    [{sg['offsets']['from']:7d} -> {sg['offsets']['to']:7d}] {sg['text']!r}")
    assert segs and all(0 <= t["id"] < 51866 for sg in segs for t in sg["tokens"])
    assert max(sizes) >= 2, sizes
    assert launches["self_attend_q8"] > 0 and launches["qmmt_fused"] > 0, launches
    return launches


# ---------------------------------------------------------------------------
# phase 7: before and after the window loop (VAD, device mel, DTW)
# ---------------------------------------------------------------------------

VAD_SILENCES_S = (12, 26)    # 3 s of silence cut in at each
# the synthetic Silero's probabilities stay within ~0.41-0.65, so a silence
# never falls 0.15 below a threshold at their median (the state machine's
# end of speech): a 2 s maximum speech duration splits segments, and a split
# inside a silence lets the silence be cut
VAD_MAX_SPEECH_S = 2.0


def vad_clip() -> np.ndarray:
    pcm = seeded_audio(40.0, seed=0)
    for s in VAD_SILENCES_S:
        pcm[16000 * s:16000 * (s + 3)] = 0.0
    return pcm


@contextlib.contextmanager
def tf32_flags(matmul: bool, cudnn: bool):
    """The caller's TF32 flags set as given inside, restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def check_vad(vad_path: str, pcm: np.ndarray, repeats: int = 5) -> float:
    """The Silero VAD on the card against the CPU on `pcm`, under the
    caller's TF32 flags all on (the first call, which captures the chunk
    bucket's graph) and at torch's defaults (cuDNN TF32 on, matmul off):
    max |probs difference| <= 1e-5 and equal segments at a threshold at the
    median of the card's probabilities; then the host clock of `repeats`
    calls on the card and the share of samples the filter keeps.  Returns
    the threshold."""
    from whisper_tpu_torch.decoding.params import TranscribeParams, VadParams
    from whisper_tpu_torch.models.vad import pipeline as VP
    from whisper_tpu_torch.models.vad import silero as VS

    cpu = VS.VadContext.from_file(vad_path, device="cpu")
    t0 = time.perf_counter()
    want = cpu.detect_speech(pcm)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    card = VS.VadContext.from_file(vad_path)
    assert card.device.type == "cuda"
    got = {}
    for label, flags in (("all TF32 on, first call", (True, True)),
                         ("torch defaults", (False, True))):
        with tf32_flags(*flags):
            t0 = time.perf_counter()
            got[label] = card.detect_speech(pcm)
            ms = 1e3 * (time.perf_counter() - t0)
        err = float(np.abs(got[label] - want).max())
        log(f"  vad card vs cpu [{label}]: max_abs_err={err:.3e} tol=1e-05 "
            f"chunks={len(want)} card_ms={ms:.3f}")
        assert err <= 1e-5, (label, err)
    walls = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        card.detect_speech(pcm)
        walls.append(1e3 * (time.perf_counter() - t0))
    probs = got["torch defaults"]
    thr = float(np.median(probs))
    vp = VadParams(threshold=thr, max_speech_duration_s=VAD_MAX_SPEECH_S)
    segs = {k: [(s.start, s.end) for s in VS.segments_from_probs(p, vp)]
            for k, p in (("card", probs), ("cpu", want))}
    log(f"  vad 40 s on the card: ms median={float(np.median(walls)):.3f} "
        f"min={min(walls):.3f} max={max(walls):.3f} runs={repeats} "
        f"(bucket {max(8, 1 << (len(want) - 1).bit_length())} chunks, one graph replay; "
        f"CPU eager {cpu_ms:.1f} ms)")
    log(f"  vad threshold (median of the card's probs)={thr!r} "
        f"max_speech_s={VAD_MAX_SPEECH_S}: card segments={segs['card']}")
    assert segs["card"] == segs["cpu"] and segs["card"], segs

    class OnCard:
        device = card.device

    params = TranscribeParams(vad=True, vad_model_path=vad_path, vad_params=vp)
    filtered, _, used = VP.filter_speech(OnCard(), params, pcm)
    kept = len(filtered) / len(pcm)
    log(f"  vad filter: kept_share={kept:.4f} segments_used={used}")
    assert 0 < kept < 1
    return thr


def check_device_mel(path: str, pcm: np.ndarray, repeats: int = 5) -> None:
    """The device mel (backend "torch", the card's default) against the
    numpy mel on `pcm` with the turbo file's filters: max |diff| over max
    |mel| <= 1e-5, and each backend's host clock per call (t_mel_us)."""
    from whisper_tpu_torch.audio.mel import LogMel
    from whisper_tpu_torch.models.whisper.load import _read_header

    with open(path, "rb") as f:
        _, filters, _, _ = _read_header(f)
    fns = {"numpy": LogMel(filters.data), "torch": LogMel(filters.data, backend="torch")}
    out, us = {}, {}
    for name, fn in fns.items():
        out[name] = fn(pcm)
        walls = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(pcm)
            walls.append(int((time.perf_counter() - t0) * 1e6))
        us[name] = walls
    (ref, n_ref), (got, n) = out["numpy"], out["torch"]
    rel = float(np.abs(got - ref).max() / np.abs(ref).max())
    log(f"  device mel vs numpy mel: shape={got.shape} max_rel_err={rel:.3e} tol=1e-05")
    for name, walls in us.items():
        log(f"  t_mel_us [{name}] median={int(np.median(walls))} min={min(walls)} "
            f"max={max(walls)} runs={repeats}")
    assert n == n_ref and got.shape == ref.shape and rel <= 1e-5


def run_cli_vad_dtw(W, TC, DTW, counters, model_path: str, wav: str, vad_path: str,
                    thr: float, pcm: np.ndarray, out_dir: str) -> dict:
    """The port's whisper-cli on the card with -vad -vm -vt <thr> -vmsd
    -dtw large.v3.turbo -ojf (beam 5 by default): >= 1 VAD segment, segment
    times in the original clip, t_dtw set on text tokens, non-decreasing
    within each window and inside it, and K2 launched by the DTW passes.
    Returns the run's launches."""
    from whisper_tpu_torch.models.vad import pipeline as VP

    windows, seen = [], {}
    inner_dtw, inner_tr = DTW.compute_token_level_timestamps_dtw, W.transcribe

    def dtw(ctx, params, result_all, i_segment, n_segments, seek, n_frames, **kw):
        t0 = time.perf_counter()
        inner_dtw(ctx, params, result_all, i_segment, n_segments, seek, n_frames, **kw)
        toks = [t for s in result_all[i_segment:i_segment + n_segments] for t in s.tokens
                if t.id < ctx.vocab.token_eot]
        windows.append((seek, n_frames, [t.t_dtw for t in toks],
                        time.perf_counter() - t0))

    def transcribe(ctx, *a, **kw):
        t0 = time.perf_counter()
        segs = inner_tr(ctx, *a, **kw)
        torch.cuda.synchronize()
        seen.update(s=time.perf_counter() - t0, ctx=ctx, segs=segs)
        return segs

    for fn in counters:
        fn.launches = 0
    DTW.compute_token_level_timestamps_dtw, W.transcribe = dtw, transcribe
    base = os.path.join(out_dir, "cli_vad_dtw")
    t0 = time.perf_counter()
    try:
        rc = TC.run(["-m", model_path, "-f", wav, "-vad", "-vm", vad_path, "-vt", repr(thr),
                     "-vmsd", str(VAD_MAX_SPEECH_S), "-dtw", "large.v3.turbo", "-ojf",
                     "-of", base, "-np"])
    finally:
        DTW.compute_token_level_timestamps_dtw, W.transcribe = inner_dtw, inner_tr
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    assert rc == 0
    ctx, segs = seen["ctx"], seen["segs"]
    tm = ctx.timings
    vctx = VP.get_vad_context(vad_path, ctx.device)
    with open(base + ".json") as f:
        js = json.load(f)["transcription"]
    n_cs = len(pcm) // 160
    used = ctx.vad_segments_used
    dtw_s = sum(w[3] for w in windows)
    log(f"  whisper-cli -vad -dtw large.v3.turbo: cli_wall_s={wall:.3f} "
        f"transcribe_wall_s={seen['s']:.3f} segments={len(segs)} json_segments={len(js)} "
        f"vad_segments={used} mel_backend={ctx.mel_fn.backend}")
    log(f"    t_mel_ms={tm.t_mel_us / 1e3:.3f} t_vad_ms (this context, all calls)="
        f"{vctx.t_vad_us / 1e3:.3f} encode_ms_per_window={ms_per(tm.t_encode_us, tm.n_encode):.3f} "
        f"windows={tm.n_encode} dtw_passes={tm.n_dtw} dtw_pass_ms_each="
        f"{ms_per(tm.t_dtw_us, tm.n_dtw):.3f} dtw_total_ms_each (pass + host DTW)="
        f"{1e3 * dtw_s / max(len(windows), 1):.3f}")
    log(f"    launches={json.dumps(launches)}")
    for seek, n_frames, ts, sec in windows:
        log(f"    dtw window seek={seek} n_frames={n_frames} text_tokens={len(ts)} "
            f"t_dtw={ts[:12]}{'...' if len(ts) > 12 else ''} ms={1e3 * sec:.1f}")
        assert all(seek <= t < seek + n_frames for t in ts), (seek, n_frames, ts)
        assert all(a <= b for a, b in zip(ts, ts[1:])), ts
    for sg in segs[:6]:
        log(f"    [{sg.t0:6d} -> {sg.t1:6d}] {sg.text!r}")
    assert used and all(0 <= a < b <= n_cs for a, b in used), used
    # remapped times lie inside the mapping table's original range; the
    # 10 ms minimum duration may push a t1 10 ms past the clip's end
    assert segs and all(0 <= s.t0 <= s.t1 <= n_cs + 10 for s in segs)
    assert windows and any(ts for _, _, ts, _ in windows)
    assert launches["qmmt"] == 6 * 4 * tm.n_dtw > 0, launches
    assert launches["qmmt_fused"] > 0 and launches["self_attention_qkv"] > 0
    return launches


# ---------------------------------------------------------------------------
# phase 8: Parakeet-TDT
# ---------------------------------------------------------------------------

PARAKEET_CLIP_S = 40.0
PARAKEET_LONG_S = 700.0     # ~8750 frames: past LOCAL_ATTN_THRESHOLD (8192)
PARAKEET_REPEATS = 5
# the card-vs-CPU model: three layers at narrow widths, its joint's output
# weights scaled up so that every argmax is decisive
SMALL_PARAKEET = dict(n_vocab=64, n_audio_state=128, n_audio_head=4, n_audio_layer=3,
                      n_subsampling_channels=32, n_pred_dim=128)
SMALL_JOINT_SCALE = 8.0


def parakeet_vocab(n: int) -> list:
    """n SentencePiece-like pieces: the control tokens, then word starts
    ("▁" + piece) and continuations."""
    return [b"<unk>", b"<s>", b"</s>"] + [
        (("▁" if i % 3 == 0 else "") + f"p{i}").encode() for i in range(n - 3)]


def write_parakeet(path: str, hp, seed: int, use_f16: bool, joint_scale: float = 1.0) -> None:
    """A Parakeet ggml file of seeded weights at `hp`'s widths
    (`synth_parakeet_tensors`), with two changes that keep the frames
    apart: the stem's biases are zeroed (with them its output barely moves
    from frame to frame), and each conformer block's four residual
    branches end in output weights scaled by 0.1 (24 random blocks at full
    scale wash the input out, and one token wins every frame)."""
    from whisper_tpu_torch.models.parakeet.writer import (synth_parakeet_tensors,
                                                          write_parakeet_model)

    rng = np.random.default_rng(seed)
    filters = (rng.random((hp.n_mels, hp.n_fft // 2 + 1)) * 0.01).astype(np.float32)
    window = np.hanning(min(400, hp.n_fft)).astype(np.float32)
    tensors = synth_parakeet_tensors(hp, seed=seed)
    for name in [f"encoder.pre_encode.conv.{i}.bias" for i in (0, 2, 3, 5, 6)] + [
            "encoder.pre_encode.out.bias"]:
        tensors[name][...] = 0.0
    for i in range(hp.n_audio_layer):
        for name in ("feed_forward1.linear2", "feed_forward2.linear2",
                     "self_attn.linear_out", "conv.pointwise_conv2"):
            tensors[f"encoder.layers.{i}.{name}.weight"] *= 0.1
    tensors["joint.joint_net.2.weight"] *= joint_scale
    write_parakeet_model(path, hp, filters, window, parakeet_vocab(hp.n_vocab), tensors,
                         use_f16=use_f16)


def _seg_key(segs) -> list:
    return [(s.text, [(t.id, t.frame_index, t.duration_idx) for t in s.tokens]) for s in segs]


def parakeet_full_runs(ctx, counters, pcm: np.ndarray) -> None:
    """`full()` on the 40 s clip: one warm-up (it captures the TDT loop's
    graph), then PARAKEET_REPEATS timed runs with every launch count and the
    loop's counters set to 0 just before them; what comes out checked."""
    from whisper_tpu_torch.models.parakeet.hparams import LOCAL_ATTN_THRESHOLD

    hp, loop = ctx.hp, ctx.decoder.loop
    assert ctx.full(pcm) == 0
    for fn in counters:
        fn.launches = 0
    loop.runs = loop.replays = loop.flag_reads = loop.steps = 0
    graphs = loop.graphs
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    walls, mel, enc, dec, first = [], [], [], [], None
    for _ in range(PARAKEET_REPEATS):
        ctx.t_mel_us = ctx.t_encode_us = ctx.t_decode_us = 0
        t0 = time.perf_counter()
        assert ctx.full(pcm) == 0
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        mel.append(ctx.t_mel_us)
        enc.append(ctx.t_encode_us)
        dec.append(ctx.t_decode_us)
        key = _seg_key(ctx.result_all)
        assert first is None or key == first
        first = key
    launches = {fn.__name__: fn.launches for fn in counters}
    toks = ctx.decoded_token_data
    n_frames = -(-ctx.n_len_org // hp.subsampling_factor)
    med = lambda a: float(np.median(a))
    log(f"  full() 40 s: wall_s median={med(walls):.4f} min={min(walls):.4f} "
        f"max={max(walls):.4f} runs={len(walls)} all={[round(w, 4) for w in walls]}")
    log(f"  t_mel_us median={int(med(mel))} t_encode_us median={int(med(enc))} "
        f"(min {min(enc)} max {max(enc)}) t_decode_us median={int(med(dec))} "
        f"(min {min(dec)} max {max(dec)})")
    log(f"  tdt loop per run: steps={loop.steps // PARAKEET_REPEATS} "
        f"replays={loop.replays // PARAKEET_REPEATS} "
        f"flag_reads={loop.flag_reads // PARAKEET_REPEATS} graphs_captured_in_runs="
        f"{loop.graphs - graphs} frames={n_frames} emitted_tokens={len(toks)} "
        f"decode_us_per_step={med(dec) / (loop.steps / PARAKEET_REPEATS):.2f} "
        f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
        f"peak_above_start={torch.cuda.max_memory_allocated() - base}")
    log(f"  text[:120]={ctx.full_text()[:120]!r}")
    log(f"  launches={json.dumps(launches)} (the Parakeet path reaches none of K1-K6)")
    assert not any(launches.values()) and loop.graphs == graphs
    # right by the repo's own means: tokens in the vocabulary, frames in
    # order inside the audio, durations from the table, p a probability,
    # and a finite encoder output of (frames, n_state)
    assert toks and n_frames <= LOCAL_ATTN_THRESHOLD
    assert all(0 <= t.id < hp.n_vocab for t in toks)
    frames = [t.frame_index for t in toks]
    assert frames == sorted(frames) and frames[-1] < n_frames
    assert all(t.duration_value in hp.tdt_durations and 0.0 <= t.p <= 1.0 for t in toks)
    assert loop.flag_reads == loop.replays and loop.runs == PARAKEET_REPEATS
    ctx.encode_only()
    assert ctx._cached_enc.shape == (n_frames, hp.n_audio_state)
    assert torch.isfinite(ctx._cached_enc).all()


def _enc_ms(ctx, mel: np.ndarray) -> float:
    t0 = time.perf_counter()
    ctx._encode(mel[None], mel.shape[0])
    return 1e3 * (time.perf_counter() - t0)


def parakeet_packed_vs_dense(ctx, model) -> None:
    """The 40 s encode with packed q5_0 conformer weights (dequantized at
    every call) against the same weights dense, in turns."""
    from whisper_tpu_torch.models.parakeet.context import ParakeetContext

    dense = ParakeetContext(model, use_packed_weights=False)
    mel = ctx.mel
    ms = {"packed": [], "dense": []}
    for c in (ctx, dense):
        _enc_ms(c, mel)
    for order in (("packed", "dense"), ("dense", "packed")) * 3:
        for name in order:
            ms[name].append(_enc_ms(ctx if name == "packed" else dense, mel))
    a = ctx._encode(mel[None], mel.shape[0])
    b = dense._encode(mel[None], mel.shape[0])
    rel = float((a - b).abs().max() / b.abs().max())
    for name, v in ms.items():
        log(f"  encode 40 s [{name}]: ms median={float(np.median(v)):.3f} "
            f"min={min(v):.3f} max={max(v):.3f} runs={len(v)}")
    log(f"  packed vs dense encoder output: max_rel_err={rel:.3e} tol=1e-04")
    assert rel <= 1e-4


def parakeet_graphs_vs_eager(ctx) -> None:
    """The TDT loop on the 40 s clip's frames as graph replays and as the
    eager step: every output equal bit for bit."""
    from whisper_tpu_torch.models.parakeet.decode import max_out_for

    hp, loop = ctx.hp, ctx.decoder.loop
    enc = ctx._encode(ctx.mel[None], ctx.n_len_org)
    n = -(-ctx.n_len_org // hp.subsampling_factor)
    z = torch.zeros((1, hp.n_pred_layers, hp.n_pred_dim), device=enc.device)
    out, ms, steps = {}, {}, {}
    for eager in (False, True):
        s0 = loop.steps
        t0 = time.perf_counter()
        out[eager] = loop.run(enc, [n], z, z, [max_out_for(n, hp)], eager=eager)
        ms[eager] = 1e3 * (time.perf_counter() - t0)
        steps[eager] = loop.steps - s0
    same = all(np.array_equal(x, y) for x, y in zip(out[False][:7], out[True][:7]))
    same = same and all(torch.equal(x, y) for x, y in zip(out[False][7:9], out[True][7:9]))
    log(f"  tdt loop graphs vs eager: identical={same} tokens={int(out[False][6][0])} "
        f"graphs_ms={ms[False]:.3f} eager_ms={ms[True]:.3f} steps={steps[False]} "
        f"graphs_us_per_step={1e3 * ms[False] / steps[False]:.2f} "
        f"eager_us_per_step={1e3 * ms[True] / steps[True]:.2f}")
    assert same and steps[False] == steps[True]


# the chunked TDT loop against the frame loop: p and plog as the CPU test
# holds them (tests/test_parakeet.py:258-270), the joint's encoder half
# being one batched product over every frame
TDT_CHUNK = 16
TDT_CHUNK_ATOL = 1e-4
TDT_BIAS = 60.0          # a crafted joint output bias that wins every argmax
TDT_BLANK_LADDER = (0.0, 0.25, 0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0, 5.0, 6.0, 8.0, 16.0)
TDT_MIN_BLANK_RUNS = 4


def _tdt_compare(a, b):
    """Two TdtLoop.run results of one row: (tokens, integer fields equal,
    final h/c equal, p/plog max abs error)."""
    k = int(a[6][0])
    ints = int(b[6][0]) == k and all(np.array_equal(x[:, :k], y[:, :k])
                                     for x, y in zip(a[:4], b[:4]))
    state = torch.equal(a[7], b[7]) and torch.equal(a[8], b[8])
    err = max(float(np.abs(x[:, :k] - y[:, :k]).max(initial=0.0)) for x, y in zip(a[4:6], b[4:6]))
    return k, ints, state, err


def _tdt_both(loop, enc, n, z, hp) -> tuple:
    """chunk = 1 and chunk = TDT_CHUNK on `loop`'s graphs (after one run
    each that captures its graph): the results, the steps and the ms of
    each."""
    from whisper_tpu_torch.models.parakeet.decode import max_out_for

    out, ms, steps = {}, {}, {}
    for chunk in (1, TDT_CHUNK):
        loop.run(enc, [n], z, z, [max_out_for(n, hp)], chunk=chunk)
        s0 = loop.steps
        t0 = time.perf_counter()
        out[chunk] = loop.run(enc, [n], z, z, [max_out_for(n, hp)], chunk=chunk)
        ms[chunk] = 1e3 * (time.perf_counter() - t0)
        steps[chunk] = loop.steps - s0
    return out, steps, ms


def _blank_runs(res) -> int:
    """The emissions of a result that come after at least one blank frame
    (the frames between them and the previous emission's end)."""
    k = int(res[6][0])
    frame, dval = res[1][0, :k], res[3][0, :k]
    ends = np.concatenate([[0], frame[:-1] + np.maximum(dval[:-1], 1)])
    return int((frame > ends).sum()) if k else 0


def parakeet_chunked_vs_frame_loop(ctx) -> None:
    """The TDT loop on the 40 s clip's frames with chunk = TDT_CHUNK against
    chunk = 1, both on their CUDA graphs: tokens, frames, durations and the
    final LSTM state equal, p and plog within TDT_CHUNK_ATOL; the steps and
    wall of each.  The clip emits at every step, so the chunk's walk
    through blank frames runs on crafted joint output biases (as
    tests/test_torch_parakeet_chunked.py's), on a copy of the loop's
    weights at full width: (a) a token of duration 0 on every frame (the
    forced advance); (b) blanks of duration 2 on every frame (each chunk's
    walk steps past its last frame); (c) the blank's bias raised along
    TDT_BLANK_LADDER until the frame loop emits after blank runs (the walk
    stops on an emission inside a chunk).  Where blanks occur, chunk
    TDT_CHUNK must take fewer steps than chunk 1."""
    from whisper_tpu_torch.models.parakeet.decode import TdtLoop, max_out_for

    hp, base = ctx.hp, ctx.decoder.loop
    enc = ctx._encode(ctx.mel[None], ctx.n_len_org)
    n = -(-ctx.n_len_org // hp.subsampling_factor)
    z = torch.zeros((1, hp.n_pred_layers, hp.n_pred_dim), device=enc.device)
    out, steps, ms = _tdt_both(base, enc, n, z, hp)
    k, ints, state, err = _tdt_compare(out[1], out[TDT_CHUNK])
    log(f"  tdt loop chunk={TDT_CHUNK} vs chunk=1 on graphs: tokens={k} tokens, frames, "
        f"durations equal={ints} h/c equal={state} p/plog max_abs_err={err:.3e} "
        f"(tol {TDT_CHUNK_ATOL:.0e}) steps chunk1={steps[1]} chunk{TDT_CHUNK}="
        f"{steps[TDT_CHUNK]} ms chunk1={ms[1]:.3f} chunk{TDT_CHUNK}={ms[TDT_CHUNK]:.3f}")
    assert k > 0 and ints and state and err <= TDT_CHUNK_ATOL

    # the crafted biases: one loop over a copy of the joint's output bias,
    # rewritten in place between cases (its graphs read it where it lies)
    joint = dict(base.params["joint"])
    orig = joint["net_b"]
    net_b = joint["net_b"] = orig.clone()
    loop = TdtLoop(dict(base.params, joint=joint), hp, base.dtype)
    nv, blank = hp.blank_id + 1, hp.blank_id

    def set_bias(bias: dict) -> None:
        net_b.copy_(orig)
        for i, v in bias.items():
            net_b[i] = v

    # (c): of the ladder's blank biases, the one whose frame loop has the
    # most of both emissions and emissions after blank runs
    ladder = {}
    for b in TDT_BLANK_LADDER:
        set_bias({blank: float(orig[blank]) + b})
        one = loop.run(enc, [n], z, z, [max_out_for(n, hp)])
        ladder[b] = (int(one[6][0]), _blank_runs(one))
    best = max((min(v), b) for b, v in ladder.items())
    log(f"  tdt loop blank ladder (bias: tokens, emissions after blank runs) {ladder}: "
        f"+{best[1]:g} (at least {TDT_MIN_BLANK_RUNS} of both)")
    assert best[0] >= TDT_MIN_BLANK_RUNS, best
    cases = [("a forced", {5: TDT_BIAS, nv: TDT_BIAS}),
             ("b blanks", {blank: TDT_BIAS, nv + 2: TDT_BIAS}),
             (f"c blank+{best[1]:g}", {blank: float(orig[blank]) + best[1]})]
    for name, bias in cases:
        set_bias(bias)
        out, steps, ms = _tdt_both(loop, enc, n, z, hp)
        k, ints, state, err = _tdt_compare(out[1], out[TDT_CHUNK])
        runs = _blank_runs(out[1])
        log(f"  tdt loop {name}: tokens={k} emissions after blank runs={runs} tokens, "
            f"frames, durations equal={ints} h/c equal={state} p/plog max_abs_err={err:.3e} "
            f"steps chunk1={steps[1]} chunk{TDT_CHUNK}={steps[TDT_CHUNK]} ms chunk1="
            f"{ms[1]:.3f} chunk{TDT_CHUNK}={ms[TDT_CHUNK]:.3f}")
        assert ints and state and err <= TDT_CHUNK_ATOL, name
        if name.startswith("a"):
            assert k > 0 and (out[1][0][0, :k] == 5).all() and (out[1][3][0, :k] == 0).all()
        else:
            assert k == 0 if name.startswith("b") else runs >= TDT_MIN_BLANK_RUNS, name
            assert steps[TDT_CHUNK] < steps[1], (name, steps)


def parakeet_batch_vs_sequential(ctx, clips) -> None:
    """full_batch on the clips against the same clips one by one through
    full() on a fork of the context with exact_shapes=False (the same padded
    mel bucket): equal segments, and the wall of each."""
    seq = ctx.fork_state()
    seq.exact_shapes = False
    ctx.full_batch(clips)                       # captures the rows' graph
    t0 = time.perf_counter()
    batch = ctx.full_batch(clips)
    t_batch = time.perf_counter() - t0
    walls, segs = [], []
    for c in clips:
        t0 = time.perf_counter()
        assert seq.full(c) == 0
        walls.append(time.perf_counter() - t0)
        segs.append(list(seq.result_all))
    same = [_seg_key(a) == _seg_key(b) for a, b in zip(batch, segs)]
    log(f"  full_batch x{len(clips)} wall_s={t_batch:.4f}; sequential full() "
        f"wall_s={sum(walls):.4f} each={[round(w, 4) for w in walls]}; equal segments={same} "
        f"tokens={[sum(len(s.tokens) for s in b) for b in batch]}")
    assert all(same) and all(batch)


def parakeet_long(ctx) -> None:
    """700 s in one full(): the encoder takes the local attention path."""
    from whisper_tpu_torch.models.parakeet.hparams import LOCAL_ATTN_THRESHOLD

    pcm = seeded_audio(PARAKEET_LONG_S, seed=2)
    ctx.t_mel_us = ctx.t_encode_us = ctx.t_decode_us = 0
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    assert ctx.full(pcm) == 0
    wall = time.perf_counter() - t0
    n_frames = -(-ctx.n_len_org // ctx.hp.subsampling_factor)
    log(f"  full() {PARAKEET_LONG_S:.0f} s: frames={n_frames} (local attention past "
        f"{LOCAL_ATTN_THRESHOLD}) wall_s={wall:.3f} t_mel_us={ctx.t_mel_us} "
        f"t_encode_us={ctx.t_encode_us} t_decode_us={ctx.t_decode_us} "
        f"tokens={len(ctx.decoded_token_data)} max_memory_allocated="
        f"{torch.cuda.max_memory_allocated()} peak_above_start="
        f"{torch.cuda.max_memory_allocated() - base}")
    assert n_frames > LOCAL_ATTN_THRESHOLD and ctx.decoded_token_data
    assert ctx.decoded_token_data[-1].frame_index < n_frames


def parakeet_cli(ctx, model_path: str, tmp: str, clips) -> None:
    """The port's parakeet-cli on the card: -otxt on one wav, then --batch
    on two; each text file equal to the context's own transcript of the
    same (int16-rounded) samples."""
    import io

    from whisper_tpu_torch.audio.io import load_audio, write_wav
    from whisper_tpu_torch.cli import parakeet_cli as PC

    wavs = []
    for i, c in enumerate(clips[:2]):
        wavs.append(os.path.join(tmp, f"parakeet-{i}.wav"))
        write_wav(wavs[-1], c)
    pcms = [load_audio(w)[0] for w in wavs]
    base = os.path.join(tmp, "parakeet-single")
    for argv in (["-m", model_path, "-f", wavs[0], "-otxt", "-of", base, "-np"],
                 ["-m", model_path, "--batch", "-otxt", "-np", *wavs]):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = PC.main(argv)
        log(f"  parakeet-cli {' '.join(a for a in argv if a.startswith('-'))}: rc={rc} "
            f"wall_s={time.perf_counter() - t0:.3f} stdout[:80]={out.getvalue()[:80]!r}")
        assert rc == 0
    assert ctx.full(pcms[0]) == 0
    assert Path(base + ".txt").read_text() == ctx.full_text() + "\n"
    want = ["".join(s.text for s in segs) + "\n" for segs in ctx.full_batch(pcms)]
    got = [Path(w + ".txt").read_text() for w in wavs]
    log(f"  parakeet-cli text files equal the context's: single=True batch={got == want}")
    assert got == want


def parakeet_card_matches_cpu(tmp: str) -> None:
    """A small Parakeet (SMALL_PARAKEET, decisive joint) on the card against
    the CPU on 20 s: equal tokens, frames and durations; encoder output
    within 1e-4 of its max |value|; every emitted row's joint margins far
    above the card-CPU difference of those logits."""
    from whisper_tpu_torch.models.parakeet.context import ParakeetContext
    from whisper_tpu_torch.models.parakeet.hparams import ParakeetHParams

    hp = ParakeetHParams(**SMALL_PARAKEET)
    path = os.path.join(tmp, "parakeet-small.bin")
    write_parakeet(path, hp, seed=3, use_f16=False, joint_scale=SMALL_JOINT_SCALE)
    pcm = seeded_audio(20.0, seed=4)
    card = ParakeetContext.from_file(path)
    cpu = ParakeetContext.from_file(path, device="cpu")
    for c in (card, cpu):
        c.capture_logits = True
        assert c.full(pcm) == 0
    key = lambda c: [(t.id, t.frame_index, t.duration_idx, t.duration_value)
                     for t in c.decoded_token_data]
    enc_card = card._encode(cpu.mel[None], cpu.n_len_org).cpu()
    enc_cpu = cpu._encode(cpu.mel[None], cpu.n_len_org)
    rel = float((enc_card - enc_cpu).abs().max() / enc_cpu.abs().max())
    nv = hp.n_vocab + 1
    lg = cpu.last_logits
    top2 = lambda a: np.sort(a, axis=1)[:, -1] - np.sort(a, axis=1)[:, -2]
    margin = float(min(top2(lg[:, :nv]).min(), top2(lg[:, nv:]).min()))
    assert key(card) == key(cpu)
    diff = float(np.abs(card.last_logits - lg).max())
    log(f"  small parakeet card vs cpu: tokens={len(key(cpu))} identical={key(card) == key(cpu)} "
        f"encoder max_rel_err={rel:.3e} tol=1e-04 min_joint_margin={margin:.4f} "
        f"max_logit_diff={diff}")
    assert len(key(cpu)) > 5 and len({t[0] for t in key(cpu)}) > 2
    assert rel <= 1e-4 and margin > 100 * diff


def check_parakeet(counters, tmp: str, t_start: float) -> None:
    """Phase 8: a full-width ParakeetHParams() file from seed 0 (f16, then
    q5_0 through the port's parakeet-quantize) on the card."""
    from whisper_tpu_torch.cli import parakeet_quantize as PQ
    from whisper_tpu_torch.models.parakeet.context import ParakeetContext
    from whisper_tpu_torch.models.parakeet.hparams import ParakeetHParams
    from whisper_tpu_torch.models.parakeet.load import load_parakeet_model

    t_phase = time.perf_counter()
    hp = ParakeetHParams()
    f16 = os.path.join(tmp, "parakeet-f16.bin")
    path = os.path.join(tmp, "parakeet-q5_0.bin")
    t0 = time.perf_counter()
    write_parakeet(f16, hp, seed=0, use_f16=True)
    t_synth = time.perf_counter() - t0
    t0 = time.perf_counter()
    assert PQ.main([f16, path, "q5_0", "-q"]) == 0
    t_quant = time.perf_counter() - t0
    os.remove(f16)
    t0 = time.perf_counter()
    model = load_parakeet_model(path)
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctx = ParakeetContext(model)
    torch.cuda.synchronize()
    t_ctx = time.perf_counter() - t0
    log(f"  synth_f16_s={t_synth:.1f} quantize_q5_0_s={t_quant:.1f} read_s={t_read:.1f} "
        f"context_s={t_ctx:.1f} bytes={os.path.getsize(path)} device={ctx.device} "
        f"packed={ctx.use_packed_weights} mel={ctx.mel_backend}")
    assert ctx.device.type == "cuda" and ctx.use_packed_weights and ctx.mel_backend == "torch"
    pcm = seeded_audio(PARAKEET_CLIP_S, seed=1)
    parakeet_full_runs(ctx, counters, pcm)
    parakeet_packed_vs_dense(ctx, model)
    parakeet_graphs_vs_eager(ctx)
    parakeet_chunked_vs_frame_loop(ctx)
    clips = [seeded_audio(PARAKEET_CLIP_S, seed=10 + i) for i in range(4)]
    parakeet_batch_vs_sequential(ctx, clips)
    parakeet_long(ctx)
    parakeet_cli(ctx, path, tmp, clips)
    del ctx, model
    parakeet_card_matches_cpu(tmp)
    log(f"  phase_s={time.perf_counter() - t_phase:.1f}")


# ---------------------------------------------------------------------------
# phase 9: the parity mode and grammars
# ---------------------------------------------------------------------------

PARITY = "ggml_cpu_f16"
GRAMMAR = "tests/data/text_parity/script.gbnf"


def parity_runs(W, M, counters, path: str, pcm: np.ndarray, repeats: int = 3):
    """`load(path, precision="ggml_cpu_f16")` + `transcribe()` of `pcm`: a
    3 s warm-up (as phase 4's), then `repeats` timed runs with the same
    segments, none of which launches a kernel (the JAX parity route
    reaches no Pallas kernel).  Returns the context (its mel set) and the
    segments."""
    t0 = time.perf_counter()
    ctx = W.load(path, precision=PARITY)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    assert ctx.parity and ctx.compute_dtype == torch.float16
    assert ctx.cache_dtype == torch.float16 and not ctx.use_packed_weights
    assert ctx.mel_fn.backend == "numpy"
    assert isinstance(ctx.params["dec"]["tok_embd"], M.QWGGML)
    assert isinstance(ctx.params["enc"]["blocks"]["mlp0_w"], M.QWGGML)
    t0 = time.perf_counter()
    W.transcribe(ctx, W.TranscribeParams(), pcm[:16000 * 3])
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls, segs = [], None
    for _ in range(repeats):
        ctx.timings.reset()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        got = W.transcribe(ctx, W.TranscribeParams(), pcm)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = {fn.__name__: fn.launches for fn in counters}
        assert not any(launches.values()), launches
        if segs is None:
            segs, tm = got, copy.copy(ctx.timings)
        assert [(s.t0, s.t1, s.text) for s in got] == [(s.t0, s.t1, s.text) for s in segs]
    # host-loop steps: one-lane ones (t_decode_us) and those of several
    # lanes (t_batchd_us, with the prompt decodes under 16 tokens)
    n_steps = tm.n_decode + tm.n_batchd
    step_ms = ms_per(tm.t_decode_us + tm.t_batchd_us, n_steps)
    log(f"  [parity] load_s={t_load:.3f} warmup_3s_wall_s={t_warm:.3f} "
        f"transcribe_wall_s median={float(np.median(walls)):.3f} min={min(walls):.3f} "
        f"max={max(walls):.3f} runs={len(walls)} all={[round(w, 3) for w in walls]} "
        f"segments={len(segs)} windows={tm.n_encode}")
    log(f"  [parity] encode_ms_per_window={ms_per(tm.t_encode_us, tm.n_encode):.3f} "
        f"host_loop_ms_per_step={step_ms:.3f} host_loop_steps={n_steps} "
        f"(one-lane {ms_per(tm.t_decode_us, tm.n_decode):.3f} ms x {tm.n_decode}, "
        f"batched {ms_per(tm.t_batchd_us, tm.n_batchd):.3f} ms x {tm.n_batchd}) "
        f"host_filter_ms={tm.t_sample_us / 1e3:.3f} "
        f"host_filter_ms_per_step={ms_per(tm.t_sample_us, n_steps):.3f} "
        f"fallbacks={tm.n_fail_p} allocated_before_runs={base} "
        f"peak_bytes_in_runs={torch.cuda.max_memory_allocated()} "
        f"peak_above_before={torch.cuda.max_memory_allocated() - base} launches=0")
    for s in segs[:4]:
        log(f"    [{s.t0:6d} -> {s.t1:6d}] {s.text!r} tokens={[t.id for t in s.tokens][:12]}")
    assert segs and all(s.tokens for s in segs)
    assert all(0 <= s.t1 <= ctx.n_len_org + 3000 for s in segs)
    assert all(0 <= t.id < ctx.hp.n_vocab for s in segs for t in s.tokens)
    assert torch.isfinite(ctx.xk.float()).all() and ctx.xk.dtype == torch.float16
    return ctx, segs


def parity_grammar_card_matches_cpu(tmp: str, counters) -> None:
    """The parity mode and grammars on the card against the CPU, on the
    small decisive model of phase 5 at t = 0: parity (f16 products, no
    kernel) on q5_0 and f16 files, greedy and beam 5, on 35 s (two
    windows), and greedy with the q8 cache (K3 at f16 rounding on the card,
    its plain version on the CPU); the committed grammar on the q5_0 file
    (bf16 and packed planes on both sides, as phase 5), greedy and beam 5,
    on 20 s (one window: the grammar's host filter costs ~50 ms a lane-step
    whatever the model).  Identical segments and tokens.
    tests/test_torch_gpu.py runs this same check."""
    import whisper_tpu_torch as W
    from whisper_tpu_torch.decoding import grammar_parser
    from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
    from whisper_tpu_torch.utils.synth import write_synth_model

    hp = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                        n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                        n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)
    paths = {}
    for qtype in ("q5_0", "f16"):
        paths[qtype] = os.path.join(tmp, f"mini-{qtype}.bin")
        write_synth_model(paths[qtype], hp, seed=1, qtype=qtype, decisive=True)
    audio = (0.1 * np.random.default_rng(5).standard_normal(16000 * 35)).astype(np.float32)
    with open(Path(__file__).resolve().parent / GRAMMAR) as f:
        parsed = grammar_parser.parse(f.read())

    def params(strategy, grammar):
        p = (W.TranscribeParams.default(W.SamplingStrategy.BEAM_SEARCH)
             if strategy == "beam" else W.TranscribeParams())
        p.temperature_inc = 0.0
        if grammar:
            p.grammar_rules = parsed.rules
            p.i_start_rule = parsed.start_rule_id("root")
        return p

    # (name, file, strategy, kv cache, grammar)
    cases = [("parity", "q5_0", "greedy", "f16", False),
             ("parity", "q5_0", "beam", "f16", False),
             ("parity", "f16", "greedy", "f16", False),
             ("parity", "f16", "beam", "f16", False),
             ("parity", "q5_0", "greedy", "q8", False),
             ("grammar", "q5_0", "greedy", "f16", True),
             ("grammar", "q5_0", "beam", "f16", True)]
    for name, qtype, strategy, kv, grammar in cases:
        pcm = audio[:16000 * 20] if grammar else audio
        kw = ({} if grammar else {"precision": PARITY})
        card_ctx = W.load(paths[qtype], kv_itype=kv, **kw)
        cpu_kw = ({"use_packed_weights": True, "compute_dtype": torch.bfloat16}
                  if grammar else kw)
        cpu_ctx = W.load(paths[qtype], device="cpu", kv_itype=kv, **cpu_kw)
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        gpu = W.transcribe(card_ctx, params(strategy, grammar), pcm)
        t_card = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        t0 = time.perf_counter()
        cpu = W.transcribe(cpu_ctx, params(strategy, grammar), pcm)
        t_cpu = time.perf_counter() - t0
        a = [(s.t0, s.t1, s.text, [t.id for t in s.tokens]) for s in gpu]
        b = [(s.t0, s.t1, s.text, [t.id for t in s.tokens]) for s in cpu]
        tag = f"[{name} {qtype} {strategy} kv={kv}]"
        log(f"  {tag} card segments={[x[:3] for x in a][:4]} card_s={t_card:.3f} "
            f"cpu_s={t_cpu:.3f} launches={json.dumps(launches)}")
        assert a == b and len(a) >= 1 + (not grammar), (a, b)
        if grammar:
            assert launches["qmmt_fused"] > 0 and launches["self_attention_qkv"] > 0
        else:
            k3 = launches.pop("self_attend_q8")
            assert (k3 > 0) == (kv == "q8") and not any(launches.values()), (k3, launches)
        assert not card_ctx._window_fns                   # the host loop only
        log(f"  {tag} card == cpu: {len(a)} segments and their tokens identical")


def write_turbo_cut(path: str) -> None:
    """The q5_0 turbo file cut to TURBO_CUT_ENC_LAYERS of its 32 encoder
    layers (full widths, vocabulary and decoder; seed 0) that phases 6, 7
    and 9-12 take: each of their loads takes a few seconds where the whole
    file's takes ~20-35 s, which keeps the smoke inside its time limit on a
    slow host."""
    from whisper_tpu_torch.models.whisper.hparams import LARGE_V3_TURBO, WhisperHParams
    from whisper_tpu_torch.utils.synth import write_synth_model

    t0 = time.perf_counter()
    write_synth_model(path, WhisperHParams(**{**LARGE_V3_TURBO.__dict__,
                                              "n_audio_layer": TURBO_CUT_ENC_LAYERS}),
                      seed=0, qtype="q5_0", decisive=True)
    log(f"  turbo {TURBO_CUT_ENC_LAYERS} enc layers q5_0 synth_s={time.perf_counter() - t0:.1f}")


def check_parity_grammar(W, M, TC, counters, path: str, wav: str, pcm: np.ndarray,
                         tmp: str) -> dict:
    """Phase 9 on the cut turbo file (`write_turbo_cut`).  Returns the
    grammar CLI's launches (q8)."""
    t_phase = time.perf_counter()
    ctx, _ = parity_runs(W, M, counters, path, pcm)
    graph_matches_eager(ctx, counters, "greedy", seeks=(0,))
    del ctx
    for extra in (["--precision", PARITY], ["--precision", PARITY, "-p", "2"]):
        launches = run_cli(W, TC, counters, path, wav, tmp, extra)
        assert not any(launches.values()), launches
    grammar = ["--grammar", str(Path(__file__).resolve().parent / GRAMMAR),
               "--grammar-rule", "root"]
    g_f16 = run_cli(W, TC, counters, path, wav, tmp, grammar)
    g_q8 = run_cli(W, TC, counters, path, wav, tmp, grammar + ["--kv-itype", "q8"])
    for launches in (g_f16, g_q8):
        assert launches["qmmt_fused"] > 0 and launches["self_attention_qkv"] > 0, launches
    assert g_q8["self_attend_q8"] > 0 and g_f16["self_attend_q8"] == 0, (g_f16, g_q8)
    with tempfile.TemporaryDirectory() as small:
        parity_grammar_card_matches_cpu(small, counters)
    log(f"  phase_s={time.perf_counter() - t_phase:.1f}")
    return g_q8


# ---------------------------------------------------------------------------
# phase 10: the rest of the CLIs and the format tools
# ---------------------------------------------------------------------------

COMMAND_WORDS = ["red", "green", "blue", "yellow", "stop", "start", "left", "right"]
# the small decisive model of phase 5
SMALL_DIMS = dict(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128, n_audio_head=2,
                  n_audio_layer=2, n_text_ctx=448, n_text_state=128, n_text_head=2,
                  n_text_layer=3, n_mels=80)
# a small decisive model 256 wide: K-quant and grid-format rows hold whole
# 256-blocks
IQ_DIMS = dict(SMALL_DIMS, n_audio_state=256, n_audio_head=4, n_audio_layer=1,
               n_text_state=256, n_text_head=4, n_text_layer=2)
# the turbo files of phase 9 and of phase 10's imatrix capture and q4_k
# transcription: full widths, vocabulary and decoder, 4 of the 32 encoder
# layers (numpy's q4_k encoder takes ~1 us an element on one core: the full
# file's 0.8 G elements would take some 13 minutes; a load of the q5_0 file
# takes ~26 s)
TURBO_CUT_ENC_LAYERS = 4


class SimClock:
    """Stands in for the `time` module of a voice CLI and of cli/stream.py's
    file source: `sleep` advances `monotonic`, nothing else does.  The
    tools' loops then play a file back in real time without waiting for
    it, and the same way in every run."""

    def __init__(self):
        self.t = 0.0

    def monotonic(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += s


@contextlib.contextmanager
def patched(*triples):
    """setattr(obj, name, value) for each triple, undone on exit."""
    old = [(o, n, getattr(o, n)) for o, n, _ in triples]
    for o, n, v in triples:
        setattr(o, n, v)
    try:
        yield
    finally:
        for o, n, v in old:
            setattr(o, n, v)


def voice_clip(pcm: np.ndarray, seconds: float, tail: float = 1.5) -> np.ndarray:
    """The first `seconds` of `pcm` with its last `tail` seconds made quiet,
    so the energy VAD (audio/energy_vad.py) sees speech end there."""
    x = pcm[:int(16000 * seconds)].copy()
    x[len(x) - int(16000 * tail):] *= 0.02
    return x


def stream_args(**kw):
    """whisper-stream's parsed flags, at its defaults, with -nf."""
    import argparse

    a = dict(step=3000, length=10000, keep=200, no_context=True, vad_thold=0.6,
             freq_thold=100.0, beam_size=-1, translate=False, max_tokens=32,
             language="en", audio_ctx=0, no_fallback=True)
    a.update(kw)
    return argparse.Namespace(**a)


STREAM_MODES = {"fixed": dict(step=3000, length=10000),
                "fixed_ac768": dict(step=3000, length=10000, audio_ctx=768),
                "vad": dict(step=0, length=10000)}


def stream_run(TS, ctx, wav: str, mode: str):
    """`run_stream` of whisper-stream on `ctx` over `wav`: fixed-step modes
    read the file with --no-realtime, the VAD mode plays it back in real
    time on a SimClock (with --no-realtime it would read the whole file
    before its first 2 s and never transcribe).  Returns the printed
    output and each transcription's ms (host clock, its readback
    included)."""
    args = stream_args(**STREAM_MODES[mode])
    realtime = mode == "vad"
    inner, steps = TS.transcribe, []

    def timed(c, params, pcm):
        t0 = time.perf_counter()
        segs = inner(c, params, pcm)
        steps.append((time.perf_counter() - t0) * 1e3)
        return segs

    buf = io.StringIO()
    swaps = [(TS, "transcribe", timed)] + ([(TS, "time", SimClock())] if realtime else [])
    with patched(*swaps):
        source = TS.FileAudioSource(wav, max(args.length, 30000), realtime=realtime)
        assert TS.run_stream(ctx, source, args, out=buf) == 0
    return buf.getvalue(), steps


def stream_turbo(TS, counters, ctx, wav: str, wav_vad: str) -> dict:
    """whisper-stream on the turbo file: fixed step, fixed step with -ac
    768 (K4 at 768 frames, padded to 1024), VAD mode on an 8 s clip."""
    out = {}
    for mode in STREAM_MODES:
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        text, steps = stream_run(TS, ctx, wav_vad if mode == "vad" else wav, mode)
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        lines = [ln for ln in text.replace("\33[2K\r", "\n").splitlines() if ln.strip()]
        log(f"  [stream {mode}] steps={len(steps)} ms_per_step median="
            f"{float(np.median(steps)):.3f} min={min(steps):.3f} max={max(steps):.3f} "
            f"all={[round(s, 3) for s in steps]} wall_s={wall:.3f} "
            f"qmmt_fused={launches['qmmt_fused']} "
            f"self_attention_qkv={launches['self_attention_qkv']}")
        for ln in lines[:3]:
            log(f"    {ln[:120]!r}")
        assert steps and lines, text
        assert launches["qmmt_fused"] > 0 and launches["self_attention_qkv"] > 0, launches
        out[mode] = launches
    return out


def command_turbo(TCMD, counters, ctx, pcm: np.ndarray) -> None:
    """whisper-command's guided scoring (ctx.decode: one prompt pass, then
    each command's tokens one step at a time) on the turbo file, 8 words,
    8 s of audio."""
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    scores = TCMD.score_commands(ctx, pcm[:16000 * 8], COMMAND_WORDS)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    best = int(np.argmax(scores))
    log(f"  [command] scores={dict(zip(COMMAND_WORDS, [round(s, 4) for s in scores]))} "
        f"choice={COMMAND_WORDS[best]!r} wall_s={wall:.3f} "
        f"qmmt_fused={launches['qmmt_fused']} "
        f"self_attention_qkv={launches['self_attention_qkv']}")
    assert all(np.isfinite(scores)) and launches["qmmt_fused"] > 0


def bench_turbo(BM, counters) -> dict:
    """whisper-bench -w 0 -m large-v3-turbo (its rows and the Parakeet
    rows): the JSON line, and each kernel's launches in it."""
    for fn in counters:
        fn.launches = 0
    env = {k: os.environ.get(k) for k in ("WTPU_BENCH_MODEL", "WTPU_BENCH_PARAKEET")}
    os.environ["WTPU_BENCH_MODEL"] = "large-v3-turbo"
    os.environ["WTPU_BENCH_PARAKEET"] = "1"
    t0 = time.perf_counter()
    try:
        rows = BM.main()
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"  [bench -w 0] wall_s={time.perf_counter() - t0:.1f} launches={json.dumps(launches)}")
    for k in ("qmmt_fused", "self_attend_q8", "self_attention_qkv"):
        assert launches[k] > 0, launches
    assert all(np.isfinite(v) and v > 0 for k, v in rows.items() if k.endswith("_ms"))
    return launches


def start_quantize(src: str, dst: str, ftype: str, imatrix=None) -> dict:
    """The port's whisper-quantize of `src` in a process of its own, its
    output to `dst`.log; the numpy encoders run on one host core while the
    card runs the other phases (phase 10 waits for them)."""
    logf = open(dst + ".log", "w")
    cmd = ["nice", "-n", "19", sys.executable, "-m", "whisper_tpu_torch.cli.quantize",
           src, dst, ftype]
    if imatrix:
        cmd += ["--imatrix", imatrix]
    # one thread each, at the lowest priority: the jobs share the host
    # with the phases' host work, which they must not slow
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=str(Path(__file__).resolve().parent),
                            stdout=logf, stderr=subprocess.STDOUT, env=env)
    return {"proc": proc, "log": logf, "dst": dst, "ftype": ftype,
            "t0": time.perf_counter()}


def finish_quantize(job: dict, timeout: float) -> float:
    """Wait for a start_quantize job; returns the quantize's own total
    seconds (its "total time" line)."""
    t0 = time.perf_counter()
    rc = job["proc"].wait(timeout=timeout)
    job["log"].close()
    with open(job["dst"] + ".log") as f:
        text = f.read()
    assert rc == 0, text[-3000:]
    total_s = float(text.rsplit("total time = ", 1)[1].split()[0]) / 1e3
    log(f"  [quantize {os.path.basename(job['dst'])}] {job['ftype']} total_s={total_s:.1f} "
        f"waited_s={time.perf_counter() - t0:.1f} bytes={os.path.getsize(job['dst'])} "
        f"({text.strip().splitlines()[-2].strip()})")
    return total_s


def stop_jobs(jobs) -> None:
    for job in jobs:
        if job["proc"].poll() is None:
            job["proc"].kill()
            job["proc"].wait()
        job["log"].close()


def capture_imatrix(MI, path: str, wav: str, device: str, steps: int = 32):
    """make-imatrix's capture of `path` over `wav` on `device`: (the
    collector, its seconds, the launches of K1-K6 in it)."""
    from whisper_tpu_torch.decoding.graphs import COUNTED
    from whisper_tpu_torch.models.whisper.load import load_model

    model = load_model(path)
    for fn in COUNTED:
        fn.launches = 0
    t0 = time.perf_counter()
    coll = MI.capture(model, [wav], steps, torch.device(device), log=lambda *a, **k: None)
    if device == "cuda":
        torch.cuda.synchronize()
    return coll, time.perf_counter() - t0, {fn.__name__: fn.launches for fn in COUNTED}


def imatrix_card_matches_cpu(MI, path: str, wav: str, card=None) -> dict:
    """The capture on the card (`card`: one made already) against the CPU:
    the same tensors, `ncalls` equal, each tensor's sums within 1e-4 of its
    largest (f32 products in other orders; the card sums in f64, the CPU
    in numpy's f32).  Returns the card's sums.  tests/test_torch_gpu.py
    runs this same check."""
    if card is None:
        card = capture_imatrix(MI, path, wav, "cuda")[0]
    cpu = capture_imatrix(MI, path, wav, "cpu")[0]
    a, b = MI.host_sums(card), MI.host_sums(cpu)
    assert list(a) == list(b) and card.ncalls == cpu.ncalls
    err = max(float(np.abs(a[k] - b[k]).max() / np.abs(b[k]).max()) for k in a)
    log(f"  [imatrix card vs cpu] tensors={len(a)} ncalls equal, max |card - cpu| / "
        f"max |cpu| per tensor={err:.3e} (bound 1e-4)")
    assert err <= 1e-4, err
    return a


def stream_card_matches_cpu(TS, card_ctx, cpu_ctx, wavs, modes=tuple(STREAM_MODES)) -> None:
    """whisper-stream's output on the card and on the CPU (bf16, packed
    planes), identical, in each of `modes`.  tests/test_torch_gpu.py runs
    the -ac 768 mode."""
    for mode in modes:
        a, steps = stream_run(TS, card_ctx, wavs[mode], mode)
        b, _ = stream_run(TS, cpu_ctx, wavs[mode], mode)
        log(f"  [stream {mode} card vs cpu] steps={len(steps)} identical={a == b} "
            f"{a.replace(chr(27) + '[2K', '').strip()[:100]!r}")
        assert a == b and steps and a.strip(), (a, b)


def voice_tools_card_matches_cpu(mods, card_ctx, cpu_ctx, wav: str, tmp: str) -> None:
    """whisper-command (guided scores within 1e-3 of each score and the
    same choice: both sides round activations to bf16, in other orders, so
    a score of ~-30 moves by ~1e-2; the grammar mode's printed lines), whisper-talk (a local --llm-cmd),
    whisper-lsp (guided and unguided requests through its Content-Length
    framing) and wchess (one move) on the card and on the CPU, each main
    given the context and run on a SimClock."""
    TS, TCMD, TTALK, TLSP, TCH = mods
    pcm = voice_clip(seeded_audio(5.0, seed=3), 5.0)
    sa = TCMD.score_commands(card_ctx, pcm, COMMAND_WORDS)
    sb = TCMD.score_commands(cpu_ctx, pcm, COMMAND_WORDS)
    d = float(np.max(np.abs(np.subtract(sa, sb)) / np.abs(sb)))
    log(f"  [command guided card vs cpu] choice={COMMAND_WORDS[int(np.argmax(sa))]!r} "
        f"scores card={[round(x, 4) for x in sa]} cpu={[round(x, 4) for x in sb]} "
        f"max |card - cpu| / |cpu|={d:.3e} (bound 1e-3)")
    assert int(np.argmax(sa)) == int(np.argmax(sb)) and d <= 1e-3, (sa, sb)

    grammar = os.path.join(tmp, "colors.gbnf")
    with open(grammar, "w") as f:
        f.write('root ::= " " color "."\ncolor ::= "red" | "green" | "blue" | "stop"\n')
    runs = {"command --grammar": (TCMD, ["--grammar", grammar]),
            "talk": (TTALK, ["--no-realtime", "-p", "Sam", "-bn", "Echo",
                             "--llm-cmd", "head -c 32", "-vms", "4000"]),
            "wchess": (TCH, [])}
    for name, (mod, flags) in runs.items():
        outs = []
        for ctx in (card_ctx, cpu_ctx):
            fixed = type("Fixed", (), {"from_file": staticmethod(lambda *a, **k: ctx)})
            clock = SimClock()
            buf = io.StringIO()
            with patched((mod, "WhisperContext", fixed), (mod, "time", clock),
                         (TS, "time", clock)), contextlib.redirect_stdout(buf):
                assert mod.main(["-m", "unused", "-f", wav, *flags]) == 0
            outs.append(buf.getvalue())
        log(f"  [{name} card vs cpu] identical={outs[0] == outs[1]} "
            f"{outs[0].strip().splitlines()[-1][:100]!r}")
        assert outs[0] == outs[1] and outs[0].strip(), outs

    calls = [{"jsonrpc": "2.0", "id": 1, "method": "registerCommandset",
              "params": COMMAND_WORDS},
             {"jsonrpc": "2.0", "id": 2, "method": "guided", "params": {"commandset_index": 0}},
             {"jsonrpc": "2.0", "id": 3, "method": "unguided", "params": {}}]
    outs = []
    for ctx in (card_ctx, cpu_ctx):
        source = TLSP.FileAudioSource(wav, 30000, realtime=False)
        while not source.done:
            source.poll()
        server = TLSP.LspServer(ctx, source)
        rx, tx = io.BytesIO(), io.BytesIO()
        for c in calls:
            TLSP.write_message(rx, c)
        rx.seek(0)
        while (body := TLSP.read_message(rx)) is not None:
            TLSP.write_message(tx, server.dispatch(body))
        outs.append(tx.getvalue())
    log(f"  [lsp card vs cpu] identical={outs[0] == outs[1]} {outs[0][-160:]!r}")
    assert outs[0] == outs[1] and b'"command_text"' in outs[0]


def quantized_card_matches_cpu(W, paths, pcm: np.ndarray) -> None:
    """Each quantized file loaded on the card and on the CPU (bf16, packed
    planes where the format has them): identical greedy segments."""
    for name, path in paths.items():
        card = W.load(path)
        cpu = W.load(path, device="cpu", use_packed_weights=True,
                      compute_dtype=torch.bfloat16)
        p = W.TranscribeParams(temperature_inc=0.0)
        a = [(s.t0, s.t1, s.text) for s in W.transcribe(card, p, pcm)]
        b = [(s.t0, s.t1, s.text) for s in W.transcribe(cpu, p, pcm)]
        log(f"  [{name} card vs cpu] packed={card.use_packed_weights} segments={a[:3]}")
        assert a == b and a, (a, b)


def k1_step_ms(ctx) -> float:
    """Device ms of one decode step's K1 launches at T = 1 on `ctx`'s packed
    planes (every layer's six matmuls and the logits head, bare products)."""
    planes = [qw for layer in ctx.params["dec"]["blocks_packed"] for qw in layer.values()]
    planes.append(ctx.params["dec"]["tok_embd_t"])
    from whisper_tpu_torch.ops import qmm as QM

    xs = {qw.codes_t.shape[0]: torch.randn((1, qw.codes_t.shape[0]), device="cuda")
          for qw in planes}
    nbytes = sum(qw.codes_t.numel() + 4 * qw.scales_t.numel()
                 + (0 if qw.mins_t is None else 4 * qw.mins_t.numel()) for qw in planes)

    def make_call(i):
        def call():
            for qw in planes:
                QM.qmmt_fused(xs[qw.codes_t.shape[0]], qw.codes_t, qw.scales_t, qw.mins_t)
        return call

    before = QM.qmmt_fused.launches
    ms = device_ms(make_call, nbytes)
    QM.qmmt_fused.launches = before
    return ms


def phase10_setup(W, MI, pcm: np.ndarray, tmp: str) -> dict:
    """What phase 10 needs from the host ahead of time: the turbo f16 file
    (4 encoder layers), the 256-wide small model in f16 with its imatrix
    captured on the card, and their whisper-quantize jobs started in the
    background (q4_k of both, iq2_xxs of the small one)."""
    from whisper_tpu_torch.audio.io import write_wav
    from whisper_tpu_torch.models.whisper.hparams import LARGE_V3_TURBO, WhisperHParams
    from whisper_tpu_torch.formats.imatrix import save_imatrix
    from whisper_tpu_torch.utils.synth import write_synth_model

    st = {"jobs": []}
    t0 = time.perf_counter()
    hp = WhisperHParams(**{**LARGE_V3_TURBO.__dict__, "n_audio_layer": TURBO_CUT_ENC_LAYERS})
    st["turbo_f16"] = os.path.join(tmp, "turbo-4enc-f16.bin")
    write_synth_model(st["turbo_f16"], hp, seed=0, qtype="f16", decisive=True)
    t_turbo = time.perf_counter() - t0
    st["jobs"].append(start_quantize(st["turbo_f16"], os.path.join(tmp, "turbo-4enc-q4_k.bin"),
                                     "q4_k"))
    t0 = time.perf_counter()
    st["iq_f16"] = os.path.join(tmp, "small256-f16.bin")
    write_synth_model(st["iq_f16"], WhisperHParams(**IQ_DIMS), seed=1, qtype="f16",
                      decisive=True)
    st["wav_small"] = os.path.join(tmp, "audio-10s.wav")
    write_wav(st["wav_small"], voice_clip(pcm, 10.0))
    coll, t_cap, launches = capture_imatrix(MI, st["iq_f16"], st["wav_small"], "cuda")
    st["iq_card_imatrix"] = coll
    st["iq_imatrix"] = os.path.join(tmp, "small256.imatrix")
    save_imatrix(st["iq_imatrix"], MI.host_sums(coll), coll.ncalls)
    st["jobs"].append(start_quantize(st["iq_f16"], os.path.join(tmp, "small256-q4_k.bin"),
                                     "q4_k"))
    st["jobs"].append(start_quantize(st["iq_f16"], os.path.join(tmp, "small256-iq2_xxs.bin"),
                                     "iq2_xxs", st["iq_imatrix"]))
    log(f"  turbo_4enc_f16_synth_s={t_turbo:.1f} bytes={os.path.getsize(st['turbo_f16'])}; "
        f"small256 imatrix on the card: capture_s={t_cap:.3f} tensors={len(coll.sums)} "
        f"launches={json.dumps(launches)}; quantize jobs started: "
        f"{[os.path.basename(j['dst']) for j in st['jobs']]}")
    return st


def check_tools(W, counters, path: str, wav: str, pcm: np.ndarray, st: dict,
                tmp: str) -> dict:
    """Phase 10 on the turbo file and the small models; returns the
    launches of bench -w 0."""
    from whisper_tpu_torch.audio.io import write_wav
    from whisper_tpu_torch.cli import bench_model as BM
    from whisper_tpu_torch.cli import command as TCMD
    from whisper_tpu_torch.cli import lsp as TLSP
    from whisper_tpu_torch.cli import make_imatrix as MI
    from whisper_tpu_torch.cli import stream as TS
    from whisper_tpu_torch.cli import talk as TTALK
    from whisper_tpu_torch.cli import wchess as TCH
    from whisper_tpu_torch.formats.imatrix import save_imatrix
    from whisper_tpu_torch.models.whisper import model as M
    from whisper_tpu_torch.models.whisper.hparams import LARGE_V3_TURBO, WhisperHParams
    from whisper_tpu_torch.utils.synth import write_synth_model

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    ctx = W.load(path)
    log(f"  turbo q5_0 load_s={time.perf_counter() - t0:.1f}")
    wav_vad = os.path.join(tmp, "audio-8s-vad.wav")
    write_wav(wav_vad, voice_clip(pcm, 8.0))
    stream_turbo(TS, counters, ctx, wav, wav_vad)
    command_turbo(TCMD, counters, ctx, pcm)
    k1_q5_0 = k1_step_ms(ctx)
    del ctx
    bench = bench_turbo(BM, counters)

    # the imatrix capture at full width, then q4_k from the background job
    coll, t_cap, launches = capture_imatrix(MI, st["turbo_f16"], wav, "cuda")
    im_path = os.path.join(tmp, "turbo-4enc.imatrix")
    save_imatrix(im_path, MI.host_sums(coll), coll.ncalls)
    hp = WhisperHParams(**{**LARGE_V3_TURBO.__dict__,
                           "n_audio_layer": TURBO_CUT_ENC_LAYERS})
    route = M._enc_attn_route(torch.float32, hp.n_audio_ctx, hp.n_audio_head,
                              hp.n_audio_state // hp.n_audio_head)
    log(f"  [imatrix turbo {TURBO_CUT_ENC_LAYERS} enc layers, 40 s, --steps 32] "
        f"capture_s={t_cap:.3f} tensors={len(coll.sums)} bytes={os.path.getsize(im_path)} "
        f"encoder_attention_route_f32={route} launches={json.dumps(launches)}")
    del coll
    jobs = {os.path.basename(j["dst"]): j for j in st["jobs"]}
    finish_quantize(jobs["turbo-4enc-q4_k.bin"], timeout=900)
    q4k = jobs["turbo-4enc-q4_k.bin"]["dst"]
    t0 = time.perf_counter()
    ctx = W.load(q4k)
    t_load = time.perf_counter() - t0
    assert all(qw.mins_t is not None for layer in ctx.params["dec"]["blocks_packed"]
               for qw in layer.values())
    W.transcribe(ctx, W.TranscribeParams(temperature_inc=0.0), pcm[:16000 * 3])
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    segs = W.transcribe(ctx, W.TranscribeParams(temperature_inc=0.0), pcm)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    log(f"  [q4_k turbo transcribe] load_s={t_load:.1f} wall_s={wall:.3f} "
        f"segments={len(segs)} windows={ctx.timings.n_encode} launches={json.dumps(launches)}")
    for s in segs[:3]:
        log(f"    [{s.t0:6d} -> {s.t1:6d}] {s.text!r}")
    assert segs and launches["qmmt_fused"] > 0 and launches["self_attention_qkv"] > 0
    k1_q4_k = k1_step_ms(ctx)
    log(f"  [K1 per decode step at T=1, turbo decoder planes] q5_0_ms={k1_q5_0:.5f} "
        f"q4_k_ms={k1_q4_k:.5f} (25 launches each)")
    del ctx

    # the small models: the card against the CPU
    small = os.path.join(tmp, "small-q5_0.bin")
    write_synth_model(small, WhisperHParams(**SMALL_DIMS), seed=1, qtype="q5_0",
                      decisive=True)
    card_ctx = W.load(small)
    cpu_ctx = W.load(small, device="cpu", use_packed_weights=True,
                     compute_dtype=torch.bfloat16)
    wav5 = os.path.join(tmp, "audio-5s-voice.wav")
    write_wav(wav5, voice_clip(seeded_audio(5.0, seed=3), 5.0))
    wav12 = os.path.join(tmp, "audio-12s.wav")
    write_wav(wav12, voice_clip(pcm, 12.0))
    stream_card_matches_cpu(TS, card_ctx, cpu_ctx,
                            {"fixed": wav12, "fixed_ac768": wav12, "vad": wav5})
    voice_tools_card_matches_cpu((TS, TCMD, TTALK, TLSP, TCH), card_ctx, cpu_ctx, wav5, tmp)
    del card_ctx, cpu_ctx
    imatrix_card_matches_cpu(MI, st["iq_f16"], st["wav_small"], card=st["iq_card_imatrix"])
    log(f"  phase_s={time.perf_counter() - t_phase:.1f}")
    return bench


def check_quantized_small(W, st: dict, pcm: np.ndarray) -> None:
    """Phase 10's last check, run after phase 12: the small q4_k and
    iq2_xxs files on the card against the CPU.  The iq2_xxs job (numpy on
    one host core, ~800 s from phase 2b on) is the last to end, so the
    phases between wait for nothing."""
    t_phase = time.perf_counter()
    jobs = {os.path.basename(j["dst"]): j for j in st["jobs"]}
    for name in ("small256-q4_k.bin", "small256-iq2_xxs.bin"):
        finish_quantize(jobs[name], timeout=900)
    quantized_card_matches_cpu(W, {n: jobs[n]["dst"] for n in ("small256-q4_k.bin",
                                                              "small256-iq2_xxs.bin")},
                               voice_clip(pcm, 10.0))
    log(f"  phase_s={time.perf_counter() - t_phase:.1f}")


# ---------------------------------------------------------------------------
# phase 11: the C ABI and fine-tuning on the card
# ---------------------------------------------------------------------------

# bindings/cpp/example.cpp's whisper_full_json params
ABI_EXAMPLE = '{"language": "en", "best_of": 1, "temperature_inc": 0}'
ABI_REPEATS = 3
# each C host (source, extra argv, its success line): all but the Parakeet
# host run on the small decisive model of phase 5 (128 wide: the hosts show
# that C drives the library on the card; whisper_full from C at full width
# runs in this interpreter) and phase 4's 40 s, the Parakeet host on phase
# 8's file, each with whisper_context_params / parakeet_context_params at their
# defaults (use_gpu true: the card); abi_host takes "cuda" for use_gpu
ABI_HOSTS = {
    "abi_host": ("whisper_tpu_torch/native/abi_host.c", ["cuda"], "ABI-HOST-OK"),
    "test_abi_main": ("native/test_abi_main.c", [], "C-ABI OK"),
    "test_abi_structs": ("native/test_abi_structs.c", [], "STRUCT-ABI-OK"),
    "test_abi_callbacks": ("native/test_abi_callbacks.c", [], "CALLBACKS-OK"),
    "cpp_example": ("bindings/cpp/example.cpp", [], "streamed:"),
    "test_abi_parakeet": ("native/test_abi_parakeet.c", [], "PARAKEET-ABI-OK"),
}
FT_STEPS = 8
FT_LR = 1e-5
FT_TOKENS = 64


def abi_build(abi, here: Path) -> dict:
    """The shim library, then every C host against it (one g++/gcc each,
    all at once)."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    abi.build_library()
    t_lib = time.perf_counter() - t0
    with ThreadPoolExecutor(len(ABI_HOSTS)) as ex:
        exes = dict(zip(ABI_HOSTS, ex.map(lambda src: abi.build_host(here / src[0]),
                                          ABI_HOSTS.values())))
    log(f"  build_s: library={t_lib:.1f} hosts={time.perf_counter() - t0 - t_lib:.1f} "
        f"({abi.LIB})")
    return exes


def abi_in_process(abi, W, counters, path: str, pcm: np.ndarray) -> dict:
    """libwhisper_tpu_torch.so loaded into this interpreter: whisper_init_
    from_file_with_params at the default context params (the card) and
    whisper_full with the struct params at their greedy defaults (language
    "en", no temperature fallback), against the port's transcribe() of the
    same params on the context the C init made (the handle is the capi's
    key to it): identical segments, K1 and K4 launched by the C call, and
    each one's wall (a warm-up each, then ABI_REPEATS runs of each in
    turns; medians)."""
    from whisper_tpu_torch import capi

    lib = abi.load_library()
    cp = lib.whisper_context_default_params()
    assert cp.use_gpu
    t0 = time.perf_counter()
    cctx = lib.whisper_init_from_file_with_params(path.encode(), cp)
    t_init = time.perf_counter() - t0
    assert cctx, "whisper_init_from_file_with_params returned NULL"
    fp = lib.whisper_full_default_params(0)
    fp.language, fp.temperature_inc, fp.print_progress = b"en", 0.0, False
    buf = np.ascontiguousarray(pcm, np.float32)
    cbuf = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ctx = capi._contexts[cctx]
    assert ctx.device.type == "cuda" and ctx.use_packed_weights
    params = capi._params_from_json(abi.GREEDY)

    def run_c():
        t = time.perf_counter()
        assert lib.whisper_full(cctx, fp, cbuf, len(buf)) == 0
        torch.cuda.synchronize()
        return time.perf_counter() - t

    def run_py():
        t = time.perf_counter()
        segs = W.transcribe(ctx, params, pcm)
        torch.cuda.synchronize()
        return time.perf_counter() - t, segs

    run_c()
    run_py()
    for fn in counters:
        fn.launches = 0
    walls_c, walls_py = [run_c()], []
    launches = {fn.__name__: fn.launches for fn in counters}
    for i in range(ABI_REPEATS):
        w, segs = run_py()
        walls_py.append(w)
        if i + 1 < ABI_REPEATS:
            walls_c.append(run_c())
    ref = [(s.t0, s.t1, s.text, [t.id for t in s.tokens]) for s in segs]
    got = abi.segments(lib, cctx)
    med_c, med_py = float(np.median(walls_c)), float(np.median(walls_py))
    log(f"  in process: init_s={t_init:.2f} whisper_full_wall_s median={med_c:.4f} "
        f"all={[round(w, 4) for w in walls_c]} transcribe_wall_s median={med_py:.4f} "
        f"all={[round(w, 4) for w in walls_py]} abi_over_transcribe_ms="
        f"{(med_c - med_py) * 1e3:.2f} segments={len(got)} launches={json.dumps(launches)}")
    assert got == ref and len(ref) >= 2, (got, ref)
    assert launches["qmmt_fused"] > 0 and launches["self_attention_qkv"] > 0, launches
    example = [(s.t0, s.t1, s.text) for s in
               W.transcribe(ctx, capi._params_from_json(ABI_EXAMPLE), pcm)]
    lib.whisper_free(cctx)
    t = segs[0].tokens[0]
    first = {"id": t.id, "tid": t.tid, "p": t.p, "t0": t.t0, "t1": t.t1}
    return {"ref": ref, "example": example, "launches": launches, "first_token": first}


def abi_vad_in_process(abi, vad_path: str, pcm: np.ndarray, thr: float) -> None:
    """The VAD through the library in this interpreter:
    whisper_vad_init_from_file_with_params at the port's default VAD context
    params (use_gpu true: the card) and whisper_vad_segments_from_samples at
    phase 7's threshold and maximum speech duration, against the port's
    Python VAD on the card (segments_from_samples) at the same params:
    equal segments, and the C call's context on the card."""
    from whisper_tpu_torch import capi
    from whisper_tpu_torch.decoding.params import VadParams
    from whisper_tpu_torch.models.vad import silero as VS

    lib = abi.load_library()
    vcp = lib.whisper_vad_default_context_params()
    assert vcp.use_gpu
    vctx = lib.whisper_vad_init_from_file_with_params(vad_path.encode(), vcp)
    assert vctx, "whisper_vad_init_from_file_with_params returned NULL"
    assert capi._contexts[vctx].device.type == "cuda"
    vp = lib.whisper_vad_default_params()
    vp.threshold, vp.max_speech_duration_s = thr, VAD_MAX_SPEECH_S
    t = time.perf_counter()
    got = abi.vad_segments(lib, vctx, vp, pcm)
    wall = time.perf_counter() - t
    lib.whisper_vad_free(vctx)
    params = VadParams(threshold=float(vp.threshold), max_speech_duration_s=VAD_MAX_SPEECH_S)
    want = [(float(s.start), float(s.end)) for s in
            VS.segments_from_samples(VS.VadContext.from_file(vad_path), params, pcm)]
    log(f"  VAD from C on the card: segments={len(got)} first_call_wall_s={wall:.3f} "
        f"equal to the Python VAD's: {got == want}")
    assert got == want and got, (got, want)


def start_hosts(exes: dict, turbo: str, parakeet: str, pcm_path: str, abi) -> dict:
    """Every C host at once, each a process of its own with an embedded
    interpreter (host_env), on the card."""
    procs = {}
    for name, (_, extra, _) in ABI_HOSTS.items():
        model = parakeet if name == "test_abi_parakeet" else turbo
        procs[name] = subprocess.Popen([str(exes[name]), model, pcm_path, *extra],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True, env=abi.host_env())
    atexit.register(kill_hosts, procs)
    return {"procs": procs, "t0": time.perf_counter()}


def kill_hosts(procs: dict) -> None:
    """At exit: end any host still running (a phase that failed first)."""
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


def finish_hosts(hosts: dict, refs: dict, parakeet_text: str) -> None:
    """Each host must exit 0, print its success line, and print what the
    port's own Python calls give on the same file, audio and params."""
    from whisper_tpu_torch import abi

    out = {}
    for name, p in hosts["procs"].items():
        so, se = p.communicate(timeout=600)
        out[name] = (p.returncode, so, se)
        log(f"  {name}: rc={p.returncode} done_at_s={time.perf_counter() - hosts['t0']:.1f}")
    for name, (rc, so, se) in out.items():
        assert rc == 0 and ABI_HOSTS[name][2] in so, f"{name}: rc={rc}\n{so[-3000:]}\n{se[-3000:]}"
    ref = refs["ref"]
    assert abi.seg_lines(out["abi_host"][1]) == ref
    assert [s[:3] for s in abi.seg_lines(out["test_abi_main"][1])] == [r[:3] for r in ref]
    assert [s[:3] for s in abi.seg_lines(out["cpp_example"][1])] == refs["example"]
    first = refs["first_token"]
    want = (f"token_data: id={first['id']} tid={first['tid']} p={first['p']:.4f} "
            f"t0={first['t0']} t1={first['t1']}")
    assert want in out["test_abi_structs"][1], (want, out["test_abi_structs"][1])
    assert f"run A: {len(ref)} segments streamed" in out["test_abi_callbacks"][1]
    text = [ln for ln in out["test_abi_parakeet"][1].splitlines()
            if ln.startswith("TEXT=")][0][len("TEXT="):]
    assert text == parakeet_text, (text[:200], parakeet_text[:200])
    log(f"  C hosts: every one exit 0 and printed the port's own segments (whisper: "
        f"{len(ref)} segments; parakeet: {len(text)} characters) "
        f"wall_s={time.perf_counter() - hosts['t0']:.1f}")


def finetune_full_width(counters, path: str, pcm: np.ndarray, tmp: str) -> dict:
    """The turbo file, dequantized to f32 by the loader, on one seeded 30 s
    window with a FT_TOKENS-token row: FT_STEPS AdamW steps with the encoder
    frozen (the loss after them below the first step's), written with
    save_finetuned (f16), then one step with the encoder trained; ms per
    step and peak memory of each.  Returns what `check_finetuned_file`
    checks."""
    from whisper_tpu_torch.audio.mel import LogMel
    from whisper_tpu_torch.models.whisper.load import load_model
    from whisper_tpu_torch.training import finetune as TF
    from whisper_tpu_torch.training.opt import OptimizerParams

    t0 = time.perf_counter()
    wm = load_model(path)
    t_read = time.perf_counter() - t0
    hp, v = wm.hparams, wm.vocab
    mel, _ = LogMel(wm.filters.data)(pcm[:16000 * 30])
    mel = np.ascontiguousarray(mel[:, :2 * hp.n_audio_ctx])
    rng = np.random.default_rng(0)
    prompt = [v.token_sot, v.lang_token(0), v.token_transcribe]
    body = rng.integers(100, 5000, FT_TOKENS - len(prompt) - 1)
    row = np.array(prompt + body.tolist() + [v.token_eot], np.int32)
    batch = TF._DictBatcher.collate([(mel, row)], len(row))
    opt = lambda _it: OptimizerParams(alpha=FT_LR)

    def steps(freeze_encoder: bool, n: int):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        ctx = TF.make_finetune_context(wm, freeze_encoder=freeze_encoder, get_opt_pars=opt)
        torch.cuda.synchronize()
        t_ctx = time.perf_counter() - t
        for fn in counters:
            fn.launches = 0
        losses, ms = [], []
        for _ in range(n):
            t = time.perf_counter()
            losses.append(ctx.step(batch))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t) * 1e3)
        launches = {fn.__name__: fn.launches for fn in counters}
        # the peak above what earlier phases left allocated (retired
        # graphs' pools among it) is the training's own
        peak = (torch.cuda.max_memory_allocated(), torch.cuda.max_memory_allocated() - base)
        return ctx, losses, ms, t_ctx, launches, peak

    ctx, losses, ms, t_ctx, launches, peak = steps(True, FT_STEPS)
    after = ctx.eval(batch)
    log(f"  fine-tune (encoder frozen): read_s={t_read:.1f} context_s={t_ctx:.1f} "
        f"losses={[round(x, 4) for x in losses]} loss_after_{FT_STEPS}={after:.4f} "
        f"ms_per_step first={ms[0]:.1f} median_of_rest={float(np.median(ms[1:])):.1f} "
        f"all={[round(x, 1) for x in ms]} max_memory_allocated={peak[0]} "
        f"peak_above_start={peak[1]} launches={json.dumps(launches)}")
    assert all(math.isfinite(x) for x in losses) and after < losses[0], (losses, after)
    assert not any(launches.values()), launches     # f32: no kernel
    out = os.path.join(tmp, "turbo-finetuned-f16.bin")
    t = time.perf_counter()
    TF.save_finetuned(out, wm, ctx.params, use_f16=True)
    saved = TF.pytree_to_tensors(ctx.params, hp)
    log(f"  save_finetuned: save_s={time.perf_counter() - t:.1f} bytes={os.path.getsize(out)}")
    del ctx
    torch.cuda.empty_cache()
    ctx, losses_e, ms_e, t_ctx, _, peak = steps(False, 1)
    log(f"  fine-tune (encoder trained): context_s={t_ctx:.1f} loss={losses_e[0]:.4f} "
        f"ms_per_step={ms_e[0]:.1f} max_memory_allocated={peak[0]} "
        f"peak_above_start={peak[1]}")
    assert math.isfinite(losses_e[0])
    del ctx
    torch.cuda.empty_cache()
    return {"out": out, "saved": saved, "hp": hp}


def check_finetuned_file(W, tuned: dict, pcm: np.ndarray) -> None:
    """The saved file read back with the port's loader equals the trained
    tensors at the converter's rounding (f16 or f32 per tensor), and one
    transcribe() of it on the card gives tokens in the vocabulary."""
    from whisper_tpu_torch.formats.quants import GGML_TYPE_F16
    from whisper_tpu_torch.models.whisper.load import load_model
    from whisper_tpu_torch.models.whisper.writer import tensor_storage_type
    from whisper_tpu_torch.training import finetune as TF

    out, saved, hp = tuned["out"], tuned["saved"], tuned["hp"]
    got = TF.pytree_to_tensors(load_model(out).params, hp)
    assert got.keys() == saved.keys()
    for name, a in saved.items():
        if tensor_storage_type(name, a.ndim, True) == GGML_TYPE_F16:
            a = a.astype(np.float16).astype(np.float32)
        assert np.array_equal(got[name], a), name
    segs = W.transcribe(W.load(out), W.TranscribeParams(temperature_inc=0.0), pcm)
    log(f"  the tuned file: {len(saved)} tensors read back equal at f16 rounding; "
        f"transcribe(): {len(segs)} segments")
    assert all(0 <= t.id < hp.n_vocab for s in segs for t in s.tokens)
    os.remove(out)


def finetune_card_matches_cpu(tmp: str) -> None:
    """3 AdamW steps on a small decisive model, the encoder trained too, on
    the card (IEEE f32, full_f32) and on the CPU: the losses agree within
    rtol 1e-4 (f32 sums in other orders; AdamW's update of an element whose
    gradient is near 0 follows its noise)."""
    from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
    from whisper_tpu_torch.models.whisper.load import load_model
    from whisper_tpu_torch.training import finetune as TF
    from whisper_tpu_torch.utils.synth import write_synth_model

    hp = WhisperHParams(n_vocab=51865, n_audio_ctx=1500, n_audio_state=128,
                        n_audio_head=2, n_audio_layer=2, n_text_ctx=448,
                        n_text_state=128, n_text_head=2, n_text_layer=3, n_mels=80)
    path = os.path.join(tmp, "mini-ft-q5_0.bin")
    write_synth_model(path, hp, seed=1, qtype="q5_0", decisive=True)
    wm = load_model(path)
    rng = np.random.default_rng(0)
    mel = (0.1 * rng.standard_normal((hp.n_mels, 2 * hp.n_audio_ctx))).astype(np.float32)
    row = np.concatenate([[wm.vocab.token_sot], rng.integers(100, 1000, 20),
                          [wm.vocab.token_eot]]).astype(np.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        _, out[dev] = TF.finetune(wm, [(mel, row)], steps=3, lr=1e-3, freeze_encoder=False,
                                  device=dev)
    log(f"  fine-tune card vs CPU (small model, 3 steps): card={out['cuda']} cpu={out['cpu']}")
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4)
    assert out["cuda"][-1] < out["cuda"][0]


def check_abi_and_training(W, counters, path: str, pcm: np.ndarray, tmp: str,
                           here: Path, vad: tuple) -> dict:
    """Phase 11: the C ABI library in this interpreter (timed), its VAD on
    phase 7's file, clip and threshold (`vad`), fine-tuning at full width
    (timed), then the C hosts all at once while the tuned file, the
    Parakeet reference and fine-tuning card vs CPU are checked."""
    from whisper_tpu_torch import abi
    from whisper_tpu_torch.models.parakeet.context import ParakeetContext

    t_phase = time.perf_counter()
    exes = abi_build(abi, here)
    refs = abi_in_process(abi, W, counters, path, pcm)
    abi_vad_in_process(abi, *vad)
    torch.cuda.empty_cache()
    tuned = finetune_full_width(counters, path, pcm, tmp)
    parakeet = os.path.join(tmp, "parakeet-q5_0.bin")
    pcm_path = os.path.join(tmp, "audio-40s.pcm.f32")
    pcm.astype("<f4").tofile(pcm_path)
    from whisper_tpu_torch.models.whisper.hparams import WhisperHParams
    from whisper_tpu_torch.utils.synth import write_synth_model

    small = os.path.join(tmp, "small-hosts-q5_0.bin")
    write_synth_model(small, WhisperHParams(**SMALL_DIMS), seed=1, qtype="q5_0",
                      decisive=True)
    host_refs = abi_in_process(abi, W, counters, small, pcm)
    hosts = start_hosts(exes, small, parakeet, pcm_path, abi)
    check_finetuned_file(W, tuned, pcm)
    pk = ParakeetContext.from_file(parakeet)
    assert pk.full(pcm) == 0
    pk_text = pk.full_text()
    del pk
    finetune_card_matches_cpu(tmp)
    finish_hosts(hosts, host_refs, pk_text)
    log(f"  phase_s={time.perf_counter() - t_phase:.1f}")
    return refs["launches"]


# ---------------------------------------------------------------------------
# phase 12: scale-out on torch.distributed
# ---------------------------------------------------------------------------

# phase 12a's timed window calls on the 1 x 1 mesh and on tp=None, in turn
WINDOW_REPEATS = 5
# the wall times of phase 12's ranks are those of ranks that share ONE card
# (NCCL refuses two ranks on one device): no scaling figure comes from them
SHARED = "two ranks sharing one H100, gloo through the host"
# tp=2 against unsharded at bf16, each reading with its own bound, near
# the geometric mean of the sound runs' reading and what a planted fault
# reads on the card (tests/test_torch_gpu_scale_out.py; PERF.md section
# 6): the encoder 5.2e-5 sound, 1.3e-3 with the attention-output bias
# added on both ranks; the logits 6.5e-4 sound, 3.3e-3 with the decoder's
# biases added on both ranks
TP_ENC_REL = 2.5e-4
TP_LOGITS_REL = 1.5e-3
# the bf16 cross-K: the reduce order may turn one rounding, one bf16 step
# (at most 2^-7 of the largest value).  The q8 cross-K and the q8 self-KV
# cache: codes within one quantisation step and scales (amax / 127 of
# those bf16 values) within the same bound.  A rank-local amax moves the
# q8 logits no further than the reduce order does (7.3e-4 against 6.5e-4),
# so the cache's scales are held themselves.
TP_XK_REL = 2.0 ** -7
PARAKEET_TP_REL = 1e-4   # Parakeet tp=2 against unsharded, IEEE f32
DP_FT_REL = 1e-4         # a dp=2 fine-tuning step against one process: loss, leaves
# and the update (new - old leaf) of every decoder leaf.  AdamW's first step
# moves each element by ~lr * sign(gradient), so leaf_rel stays ~lr / |leaf|
# whatever the gradient; an update from one rank's half of the batch (the
# gradients not all-reduced) turns signs and reads ~1 in the update
DP_FT_STEP_REL = 1e-4


def _rank_log(*a) -> None:
    import torch.distributed as dist

    log(f"  [rank {dist.get_rank()}]", *a)


def _zero(counters) -> None:
    for fn in counters:
        fn.launches = 0


def _counts(counters) -> dict:
    return {fn.__name__: fn.launches for fn in counters}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def _window_args(ctx, pcm: np.ndarray):
    """One 30 s window of `pcm` encoded on `ctx` (its filter tables), its
    mel as a tensor, and the window decoder's prompt, masks and bucket."""
    import whisper_tpu_torch as W
    from whisper_tpu_torch.decoding import device_loop as DL
    from whisper_tpu_torch.runtime.context import _bucket

    ctx.pcm_to_mel(pcm)
    ctx.encode_window(0)
    hp, v, dev = ctx.hp, ctx.vocab, ctx.device
    window = np.zeros((hp.n_mels, 2 * hp.n_audio_ctx), np.float32)
    n = min(ctx.n_len, window.shape[1])
    window[:, :n] = ctx.mel[:, :n]
    prompt = [v.token_sot, v.lang_token(0), v.token_transcribe]
    bt = _bucket(len(prompt))
    padded = torch.zeros(bt, dtype=torch.long, device=dev)
    padded[:len(prompt)] = torch.tensor(prompt)
    base, initial = (torch.from_numpy(m).to(dev) for m in
                     DL.build_masks(ctx.filter_tables, W.TranscribeParams()))
    return torch.from_numpy(window).to(dev), prompt, bt, padded, base, initial


def _decode_chain(M, params, xk, xv, prompt, hp, itype: str, tp, n_steps: int = 3):
    """A prompt pass and n_steps greedy steps: (the logits of each call,
    the tokens chosen, the self-KV cache)."""
    dev = xk.codes.device if isinstance(xk, M.XK8) else xk.device
    cache = M.new_cache(hp, 1, torch.bfloat16, itype=itype, device=dev, tp=tp)
    toks = torch.tensor([prompt], device=dev)
    pos = torch.arange(len(prompt), device=dev)[None]
    outs, chosen = [], []
    for s in range(n_steps + 1):
        lg, cache = M.decode_step(params, toks, pos, 0 if s == 0 else len(prompt) + s - 1,
                                  cache, xk, xv, hp, dtype=torch.bfloat16, tp=tp)
        outs.append(lg[:, -1])
        toks = lg[:, -1:].argmax(-1)
        chosen.append(int(toks))
        pos = torch.full((1, 1), len(prompt) + s, device=dev)
    return torch.cat(outs), chosen, cache


def _q8_against(codes, scale, codes_ref, scale_ref) -> dict:
    """int8 codes and their scales against the unsharded run's: the
    scales' relative error, the largest code step, the codes that turned."""
    d = (codes.float() - codes_ref.float()).abs()
    return {"scale_rel": _rel(scale, scale_ref), "code_step_max": float(d.max()),
            "codes_turned": int((d > 0).sum())}


NCCL_GRAPH_REPLAYS = 4


def _nccl_graph_all_reduce() -> dict:
    """`dist.all_reduce` (sum and max) on the one-rank NCCL world group,
    captured in a CUDA graph between elementwise ops and replayed on fresh
    inputs: the capture path the window decoder's graphs take at tp > 1 on
    several cards, which a one-rank tp group no longer launches.  Each
    replay against the same ops without the collective (one rank's sum and
    max are its input), bit for bit; two calls at capture, none at replay."""
    import torch.distributed as dist

    from whisper_tpu_torch.parallel import collective_audit as CA

    world = dist.group.WORLD
    assert dist.get_backend(world) == "nccl" and dist.get_world_size(world) == 1
    g = torch.Generator(device="cuda").manual_seed(0)
    src = torch.zeros((8, 1, 1280), device="cuda")    # a row-parallel product of 8 rows
    s, m = torch.empty_like(src), torch.empty_like(src)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):        # NCCL sets up its communicator before capture
        dist.all_reduce(src, group=world)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with CA.recorded_all_reduces() as calls:
        with torch.cuda.graph(graph):
            s.copy_(src)
            dist.all_reduce(s, op=dist.ReduceOp.SUM, group=world)
            s.mul_(3.0)
            m.copy_(src)
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=world)
            m.add_(1.0)
        n_capture = len(calls)
        equal = []
        for _ in range(NCCL_GRAPH_REPLAYS):
            src.normal_(generator=g)
            graph.replay()
            torch.cuda.synchronize()
            equal.append(torch.equal(s, src * 3.0) and torch.equal(m, src + 1.0))
        n_replay = len(calls) - n_capture
    _rank_log(f"a. NCCL all-reduce (sum, max) on the one-rank world group captured in a "
              f"CUDA graph: calls at capture={calls[:n_capture]} at {NCCL_GRAPH_REPLAYS} "
              f"replays={n_replay}; each replay bit-equal={equal}")
    assert all(equal) and n_capture == 2 and n_replay == 0
    return {"calls_at_capture": n_capture, "replays": NCCL_GRAPH_REPLAYS, "equal": all(equal)}


def scale_out_nccl(path: str, pcm: np.ndarray) -> dict:
    """Phase 12a, one rank over NCCL on a 1 x 1 mesh: the dense bf16 turbo
    file's encode (K4), cross-K/V q8 and the window decoder through its CUDA
    graphs (K3) against tp=None, bit for bit, with no all-reduce launched (a
    one-rank group has no collective); NCCL all-reduces captured in a CUDA
    graph and replayed on the one-rank world group (the window graphs' path
    at tp > 1 on several cards); the collective audit's step at tp = 1
    (none) and the scaling bench's 1x1 line."""
    import torch.distributed as dist

    from whisper_tpu_torch.decoding import device_loop as DL
    from whisper_tpu_torch.decoding import graphs as G
    from whisper_tpu_torch.models.whisper import model as M
    from whisper_tpu_torch.models.whisper.load import load_model
    from whisper_tpu_torch.parallel import collective_audit as CA
    from whisper_tpu_torch.parallel import mesh as PM
    from whisper_tpu_torch.parallel import scaling_bench as SB
    from whisper_tpu_torch.parallel import sharding as PS
    from whisper_tpu_torch.runtime.context import WhisperContext

    t0 = time.perf_counter()
    ctx = WhisperContext(load_model(path), use_packed_weights=False)
    hp, bf16 = ctx.hp, torch.bfloat16
    assert ctx.compute_dtype == bf16 and "blocks_packed" not in ctx.params["dec"]
    mesh = PM.make_mesh(1, 1)
    tp = PM.axis_group(mesh, "tp")
    assert dist.get_backend(tp) == "nccl"
    local = PS.shard_params(ctx.params, mesh, hp)
    mel, prompt, bt, padded, base, initial = _window_args(ctx, pcm)
    _rank_log(f"a. nccl 1x1: load_s={time.perf_counter() - t0:.1f} "
              f"backend={dist.get_backend(tp)} mesh={tuple(mesh.shape)}")
    counters = G.COUNTED
    with G.DEVICE_LOCK, CA.recorded_all_reduces() as calls_chain:
        _zero(counters)
        enc_tp = M.encode(local, mel, hp, dtype=bf16, tp=tp)
        xk_tp, xv_tp = M.compute_cross_kv(local, enc_tp, hp, dtype=bf16, itype="q8", tp=tp)
        n_enc = _counts(counters)
        enc_1 = M.encode(ctx.params, mel, hp, dtype=bf16)
        xk_1, xv_1 = M.compute_cross_kv(ctx.params, enc_1, hp, dtype=bf16, itype="q8")
        lg_tp, tok_tp, _ = _decode_chain(M, local, xk_tp, xv_tp, prompt, hp, "q8", tp)
        lg_1, tok_1, _ = _decode_chain(M, ctx.params, xk_1, xv_1, prompt, hp, "q8", None)
    same = (torch.equal(enc_tp, enc_1) and all(torch.equal(a, b) for a, b in zip(
        (*xk_tp, *xv_tp), (*xk_1, *xv_1))) and torch.equal(lg_tp, lg_1) and tok_tp == tok_1)
    eot, beg = ctx.vocab.token_eot, ctx.vocab.token_beg
    fns = {name: DL.make_window_decoder(hp, 1, bt, bf16, False, False, eot, beg,
                                        kv_itype="q8", tp=g)
           for name, g in (("tp", tp), ("none", None))}
    inputs = {"tp": (local, xk_tp, xv_tp), "none": (ctx.params, xk_1, xv_1)}
    res, ms = {}, {}
    _zero(counters)
    # the first call of each captures its graphs; then the two in turn, and
    # each one's median ms per step (host clock, one window a call)
    with CA.recorded_all_reduces() as calls:
        for rep in range(1 + WINDOW_REPEATS):
            for name, fn in fns.items():
                p, xk, xv = inputs[name]
                torch.cuda.synchronize()
                steps0, t = fn.steps, time.perf_counter()
                res[name] = fn(p, padded, len(prompt), xk, xv, base, initial, 0.0, 0,
                               ctx.n_len_org, 0, 0)
                torch.cuda.synchronize()
                if rep:
                    ms.setdefault(name, []).append(
                        (time.perf_counter() - t) * 1e3 / max(1, fn.steps - steps0))
    runs = ms
    ms = {name: float(np.median(v)) for name, v in runs.items()}
    n_win = _counts(counters)
    fields_equal = all(np.array_equal(a, b) for a, b in zip(res["tp"], res["none"]))
    _rank_log(f"a. encode + cross-K/V q8 + prompt pass + 3 steps with tp == tp=None bit for "
              f"bit: {same}; tokens={tok_tp}; window through graphs: tokens={int(res['tp'].n_tok[0])} "
              f"WindowResult equal={fields_equal} graphs_captured={fns['tp'].graphs} "
              f"eager_windows={fns['tp'].eager_windows} ms_per_step median of "
              f"{WINDOW_REPEATS} tp={ms['tp']:.3f} tp=None={ms['none']:.3f} (all: tp="
              f"{[round(v, 3) for v in runs['tp']]} tp=None={[round(v, 3) for v in runs['none']]}; "
              f"{nvidia_smi_line()}, one rank); launches encode={n_enc} "
              f"windows={n_win}")
    assert same and fields_equal, "a 1 x 1 NCCL mesh must compute what tp=None computes"
    assert fns["tp"].graphs > 0 and fns["tp"].eager_windows == 0
    assert n_enc["self_attention_qkv"] > 0 and n_win["self_attend_q8"] > 0
    # a one-rank group launches no collective (parallel/mesh.py), so the
    # graphs hold none
    _rank_log(f"a. all_reduce launches on the 1 x 1 mesh: encode and steps "
              f"{len(calls_chain)}, windows {len(calls)}")
    assert calls_chain == [] and calls == [], "a one-rank group launched an all-reduce"
    graph_ar = _nccl_graph_all_reduce()
    # the collective audit's step (parallel/collective_audit.py, the JAX
    # tool's default dims) at tp = 1 over NCCL, float and q8 caches
    ahp = CA.audit_hparams(4, 1024, 16)
    for itype in ("f16", "q8"):
        audit_calls, _ = CA.step_collectives(ahp, mesh, 8, itype, device="cuda")
        for line in CA.header(4, 1024, 16, 8, itype) + CA.table_rows(1, audit_calls, 4):
            _rank_log(f"a. audit {line}")
        assert audit_calls == [], "the audit at tp = 1 must read no collective"
    # the scaling bench's 1x1 line (parallel/scaling_bench.py): synthetic
    # dense bf16 turbo, 4 windows on the beam axis, chains of 8 and 32 steps
    t = time.perf_counter()
    step_s = SB.step_seconds(SB.DIMS["large-v3-turbo"], mesh, 4, 32, bf16, "cuda")
    line = SB.config_line("1x1", "large-v3-turbo", 1, 1, 4, 4 / step_s, None)
    _rank_log(f"a. scaling_bench {json.dumps(line)} step_ms={1e3 * step_s:.3f} "
              f"wall_s={time.perf_counter() - t:.1f}")
    assert line["tok_s"] > 0 and line["efficiency_vs_linear"] == 1.0
    return {"same": same and fields_equal, "graphs": fns["tp"].graphs, "ms_tp": ms["tp"],
            "ms_none": ms["none"], "launches": n_enc, "window_launches": n_win,
            "graph_all_reduce": graph_ar, "scaling": line}


def _tp_whisper(wm, pcm: np.ndarray, counters) -> dict:
    """Phase 12b on this rank: tp=2 over gloo at full turbo width (dense
    bf16) against the unsharded run on the card in this process."""
    import torch.distributed as dist

    from whisper_tpu_torch.decoding import device_loop as DL
    from whisper_tpu_torch.decoding import graphs as G
    from whisper_tpu_torch.models.whisper import model as M
    from whisper_tpu_torch.parallel import mesh as PM
    from whisper_tpu_torch.parallel import sharding as PS
    from whisper_tpu_torch.runtime.context import WhisperContext

    t0 = time.perf_counter()
    ctx = WhisperContext(wm, use_packed_weights=False)
    hp, bf16 = ctx.hp, torch.bfloat16
    mesh = PM.make_mesh(1, 2)
    tp = PM.axis_group(mesh, "tp")
    r, k = PM.group_rank(tp), hp.n_text_head // 2
    local = PS.shard_params(ctx.params, mesh, hp)
    mel, prompt, bt, padded, base, initial = _window_args(ctx, pcm)
    t_setup = time.perf_counter() - t0
    out = {}
    with G.DEVICE_LOCK:
        _zero(counters)
        torch.cuda.synchronize()
        t = time.perf_counter()
        enc_tp = M.encode(local, mel, hp, dtype=bf16, tp=tp)
        torch.cuda.synchronize()
        t_enc_tp = time.perf_counter() - t
        n_enc = _counts(counters)
        t = time.perf_counter()
        enc_1 = M.encode(ctx.params, mel, hp, dtype=bf16)
        torch.cuda.synchronize()
        t_enc_1 = time.perf_counter() - t
        out["enc_rel"] = _rel(enc_tp, enc_1)
        for itype in ("f16", "q8"):
            xk_tp, xv_tp = M.compute_cross_kv(local, enc_tp, hp, dtype=bf16, itype=itype, tp=tp)
            xk_1, xv_1 = M.compute_cross_kv(ctx.params, enc_1, hp, dtype=bf16, itype=itype)
            heads = (lambda a: a[:, r * k:(r + 1) * k])
            if itype == "q8":
                xk_rel = _rel(xk_tp.codes * xk_tp.scale[..., None],
                              heads(xk_1.codes * xk_1.scale[..., None]))
                out["xk8"] = _q8_against(xk_tp.codes, xk_tp.scale, heads(xk_1.codes),
                                         heads(xk_1.scale))
            else:
                xk_rel = _rel(xk_tp, heads(xk_1))
            _zero(counters)
            lg_tp, tok_tp, kv_tp = _decode_chain(M, local, xk_tp, xv_tp, prompt, hp, itype, tp)
            n_dec = _counts(counters)
            lg_1, tok_1, kv_1 = _decode_chain(M, ctx.params, xk_1, xv_1, prompt, hp, itype, None)
            if itype == "q8":   # the self-KV cache: this rank's heads, every row's scale
                out["kv8"] = _q8_against(kv_tp.kv, kv_tp.scale,
                                         kv_1.kv[:, :, r * k:(r + 1) * k], kv_1.scale)
            out[itype] = {"xk_rel": xk_rel, "logits_rel": _rel(lg_tp, lg_1),
                          "tokens": tok_tp, "tokens_ref": tok_1, "launches": n_dec}
    eot, beg = ctx.vocab.token_eot, ctx.vocab.token_beg
    xk_tp, xv_tp = M.compute_cross_kv(local, enc_tp, hp, dtype=bf16, itype="q8", tp=tp)
    xk_1, xv_1 = M.compute_cross_kv(ctx.params, enc_1, hp, dtype=bf16, itype="q8")
    fn_tp = DL.make_window_decoder(hp, 1, bt, bf16, False, False, eot, beg, kv_itype="q8",
                                   tp=tp)
    fn_1 = DL.make_window_decoder(hp, 1, bt, bf16, False, False, eot, beg, kv_itype="q8")
    _zero(counters)
    torch.cuda.synchronize()
    t = time.perf_counter()
    res_tp = fn_tp(local, padded, len(prompt), xk_tp, xv_tp, base, initial, 0.0, 0,
                   ctx.n_len_org, 0, 0)
    t_win = time.perf_counter() - t
    n_win = _counts(counters)
    res_1 = fn_1(ctx.params, padded, len(prompt), xk_1, xv_1, base, initial, 0.0, 0,
                 ctx.n_len_org, 0, 0)
    n = int(res_1.n_tok[0])
    out["window"] = {"tokens": res_tp.tok_id[0, :int(res_tp.n_tok[0])].tolist(),
                     "tokens_ref": res_1.tok_id[0, :n].tolist(),
                     "eager_windows": fn_tp.eager_windows, "graphs": fn_tp.graphs,
                     "launches": n_win,
                     "ms_per_step": t_win * 1e3 / max(1, fn_tp.steps)}
    _rank_log(
        f"b. tp=2 gloo dense bf16: setup_s={t_setup:.1f} encode_rel={out['enc_rel']:.3e} "
        f"encode_ms tp={t_enc_tp * 1e3:.1f} unsharded={t_enc_1 * 1e3:.1f} ({SHARED}) "
        + " ".join(f"{it}: xk_rel={out[it]['xk_rel']:.3e} logits_rel={out[it]['logits_rel']:.3e} "
                   f"tokens={out[it]['tokens']} ref={out[it]['tokens_ref']}"
                   for it in ("f16", "q8"))
        + "".join(f" q8 {name}: scale_rel={out[key]['scale_rel']:.3e} code_step_max="
                  f"{out[key]['code_step_max']:.0f} codes_turned={out[key]['codes_turned']}"
                  for name, key in (("cross-K", "xk8"), ("self-KV cache", "kv8")))
        + f" window: n_tok={len(out['window']['tokens'])} ref={n} eager_windows="
          f"{fn_tp.eager_windows} graphs={fn_tp.graphs} ms_per_step="
          f"{out['window']['ms_per_step']:.2f} ({SHARED}); launches encode={n_enc} "
          f"q8 steps={out['q8']['launches']} window={n_win}")
    assert out["enc_rel"] <= TP_ENC_REL, out["enc_rel"]
    assert out["f16"]["xk_rel"] <= TP_XK_REL, out["f16"]
    for key in ("xk8", "kv8"):
        assert out[key]["code_step_max"] <= 1 and out[key]["scale_rel"] <= TP_XK_REL, out[key]
    for it in ("f16", "q8"):
        assert out[it]["logits_rel"] <= TP_LOGITS_REL, out[it]
        assert out[it]["tokens"] == out[it]["tokens_ref"], out[it]
    assert out["window"]["tokens"] == out["window"]["tokens_ref"]
    assert dist.get_backend(tp) == "gloo" and fn_tp.eager_windows == 1 and fn_tp.graphs == 0
    assert n_enc["self_attention_qkv"] > 0 and out["q8"]["launches"]["self_attend_q8"] > 0
    assert n_win["self_attend_q8"] > 0
    out["launches"] = {"encode": n_enc, "window": n_win}
    del ctx, local
    torch.cuda.empty_cache()
    return out


def _dp_transcribe(wm, pcm: np.ndarray, counters) -> dict:
    """Phase 12c on this rank: `transcribe_multihost` of the 40 s on the
    packed q5_0 turbo context (q8 cache), then `transcribe_parallel(...,
    2, batched=False)` on the same context."""
    import whisper_tpu_torch as W
    from whisper_tpu_torch.decoding.parallel import transcribe_parallel
    from whisper_tpu_torch.parallel.multihost import make_global_mesh, transcribe_multihost
    from whisper_tpu_torch.runtime.context import WhisperContext

    ctx = WhisperContext(wm, kv_itype="q8")
    assert ctx.use_packed_weights
    mesh = make_global_mesh(n_tp=1)
    p = W.TranscribeParams()
    W.transcribe(ctx, p, pcm[:16000 * 3])              # warm-up (lazy CUDA set-up)
    _zero(counters)
    t = time.perf_counter()
    segs = transcribe_multihost(ctx, p, pcm)
    wall = time.perf_counter() - t
    launches = _counts(counters)
    key = [(s.t0, s.t1, s.text) for s in segs]
    ref = [(s.t0, s.t1, s.text) for s in transcribe_parallel(ctx, p, pcm, 2, batched=False)]
    _rank_log(f"c. dp=2 transcribe_multihost: mesh={tuple(mesh.shape)} segments={len(key)} "
              f"equal to transcribe_parallel(2, batched=False): {key == ref} wall_s={wall:.3f} "
              f"({SHARED}) launches={json.dumps(launches)}")
    assert key == ref and key
    for name in ("qmmt_fused", "self_attend_q8", "self_attention_qkv"):
        assert launches[name] > 0, name
    del ctx
    torch.cuda.empty_cache()
    return {"segs": key, "wall_s": wall, "launches": launches}


def _tp_parakeet(parakeet_path: str, pcm: np.ndarray) -> dict:
    """Phase 12d on this rank: phase 8's Parakeet file, dense f32, its
    encode of the 40 s at tp=2 against the unsharded one, and the TDT
    tokens of each."""
    from whisper_tpu_torch.decoding.graphs import DEVICE_LOCK, full_f32
    from whisper_tpu_torch.models.parakeet import decode as PD
    from whisper_tpu_torch.models.parakeet import model as PKM
    from whisper_tpu_torch.models.parakeet.context import ParakeetContext
    from whisper_tpu_torch.parallel import mesh as PM
    from whisper_tpu_torch.parallel.parakeet_sharding import shard_parakeet_params

    t0 = time.perf_counter()
    pk = ParakeetContext.from_file(parakeet_path, use_packed_weights=False)
    hp = pk.hp
    mesh = PM.make_mesh(1, 2)
    tp = PM.axis_group(mesh, "tp")
    local = shard_parakeet_params(pk.params, mesh)
    pk.pcm_to_mel(pcm)
    mel = torch.from_numpy(pk.mel[None]).to(pk.device)
    t_setup = time.perf_counter() - t0
    toks = {}
    with DEVICE_LOCK, full_f32():
        torch.cuda.synchronize()
        t = time.perf_counter()
        enc_tp = PKM.encode(local, mel, mel.shape[1], hp, tp=tp)
        torch.cuda.synchronize()
        t_tp = time.perf_counter() - t
        enc_1 = PKM.encode(pk.params, mel, mel.shape[1], hp)
        rel = _rel(enc_tp, enc_1)
        for name, p, e in (("tp", local, enc_tp), ("none", pk.params, enc_1)):
            n = e.shape[1]
            h = torch.zeros(hp.n_pred_layers, hp.n_pred_dim, device=pk.device)
            res = PD.tdt_greedy_decode(PD.TdtLoop(p, hp), e[0], n, h, h.clone(),
                                       PD.max_out_for(n, hp))
            toks[name] = np.array(res[0][:res[6]]).tolist()
    _rank_log(f"d. parakeet tp=2 dense f32: setup_s={t_setup:.1f} frames={enc_tp.shape[1]} "
              f"encode_rel={rel:.3e} encode_ms tp={t_tp * 1e3:.1f} ({SHARED}) "
              f"tokens={len(toks['tp'])} equal={toks['tp'] == toks['none']}")
    assert rel <= PARAKEET_TP_REL, rel
    assert toks["tp"] == toks["none"] and toks["tp"]
    del pk, local
    torch.cuda.empty_cache()
    return {"rel": rel, "tokens": toks["tp"]}


def _dp_finetune(wm, pcm: np.ndarray) -> dict:
    """Phase 12e on this rank: one fine-tuning step at dp=2 (encoder
    frozen, a batch of 2: one 30 s window each), then on rank 0 the same
    step in one process: the loss and every leaf within DP_FT_REL."""
    import torch.distributed as dist

    from whisper_tpu_torch.audio.mel import LogMel
    from whisper_tpu_torch.parallel.multihost import make_global_mesh
    from whisper_tpu_torch.training import finetune as TF
    from whisper_tpu_torch.training.opt import OptimizerParams

    hp, v = wm.hparams, wm.vocab
    rng = np.random.default_rng(0)
    samples = []
    for start in (0, 10):
        mel, _ = LogMel(wm.filters.data)(pcm[16000 * start:16000 * (start + 30)])
        prompt = [v.token_sot, v.lang_token(0), v.token_transcribe]
        body = rng.integers(100, 5000, FT_TOKENS - len(prompt) - 1).tolist()
        samples.append((np.ascontiguousarray(mel[:, :2 * hp.n_audio_ctx]),
                        np.array(prompt + body + [v.token_eot], np.int32)))
    batch = TF._DictBatcher.collate(samples, FT_TOKENS)
    opt = lambda _it: OptimizerParams(alpha=FT_LR)
    mesh = make_global_mesh(n_tp=1)

    def one_step(mesh):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ctx = TF.make_finetune_context(wm, freeze_encoder=True, get_opt_pars=opt, mesh=mesh)
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = ctx.step(batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        peak = torch.cuda.max_memory_allocated() - base
        return ctx.params, loss, ms, peak

    leaves, loss, ms, peak = one_step(mesh)
    _rank_log(f"e. fine-tune dp=2 (encoder frozen, batch 2): loss={loss:.6f} ms_per_step={ms:.1f} "
              f"peak_above_start={peak} ({SHARED})")
    out = {"loss": loss, "ms": ms, "peak": peak}
    if dist.get_rank() == 0:
        solo, loss_1, ms_1, peak_1 = one_step(None)
        a, b = _flat_leaves(leaves), _flat_leaves(solo)
        leaf_rel = max(_rel(a[k], b[k]) for k in a)
        orig = _flat_leaves(wm.params)
        step_rel = max(_rel(a[k] - torch.from_numpy(orig[k]).to(a[k].device),
                            b[k] - torch.from_numpy(orig[k]).to(b[k].device))
                       for k in a if not k.startswith(".enc"))
        loss_rel = abs(loss - loss_1) / abs(loss_1)
        _rank_log(f"e. one process, the same batch: loss={loss_1:.6f} ms_per_step={ms_1:.1f} "
                  f"peak_above_start={peak_1}; dp=2 against it: loss_rel={loss_rel:.3e} "
                  f"max leaf rel={leaf_rel:.3e} max update rel={step_rel:.3e}")
        assert loss_rel <= DP_FT_REL and leaf_rel <= DP_FT_REL, (loss_rel, leaf_rel)
        assert step_rel <= DP_FT_STEP_REL, step_rel
        out.update(loss_solo=loss_1, loss_rel=loss_rel, leaf_rel=leaf_rel, step_rel=step_rel)
        del solo
    del leaves
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _flat_leaves(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        return {k2: v2 for k in tree for k2, v2 in _flat_leaves(tree[k], f"{prefix}.{k}").items()}
    return {prefix: tree}


def scale_out_gloo(path: str, parakeet_path: str, pcm: np.ndarray) -> dict:
    """Phases 12b-e on each of two ranks that share the card (gloo): the
    turbo file is read once and serves b (dense bf16), c (packed q5_0) and
    e (f32)."""
    from whisper_tpu_torch.decoding import graphs as G
    from whisper_tpu_torch.models.whisper.load import load_model

    t0 = time.perf_counter()
    wm = load_model(path)
    _rank_log(f"read_s={time.perf_counter() - t0:.1f}")
    counters = G.COUNTED
    out = {}
    t = time.perf_counter()
    out["tp"] = _tp_whisper(wm, pcm[:16000 * 30], counters)
    out["tp"]["s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["dp"] = _dp_transcribe(wm, pcm, counters)
    out["dp"]["s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["parakeet"] = _tp_parakeet(parakeet_path, pcm)
    out["parakeet"]["s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["finetune"] = _dp_finetune(wm, pcm)
    out["finetune"]["s"] = time.perf_counter() - t
    _rank_log("seconds: " + " ".join(f"{k}={v['s']:.1f}" for k, v in out.items()))
    return out


def check_scale_out(path: str, parakeet: str, pcm: np.ndarray, here: Path) -> None:
    """Phase 12: one 1-rank launch over NCCL (a), one 2-rank launch over
    gloo on the same card (b-e; parallel/launch.py); the ranks' results
    held against each other here."""
    import gc

    from whisper_tpu_torch.parallel.launch import launch

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  parent: memory_allocated={torch.cuda.memory_allocated()} after freeing; "
        f"{nvidia_smi_line()}")
    smoke = str(here / "chip_smoke.py")
    t = time.perf_counter()
    (a,) = launch(f"{smoke}:scale_out_nccl", 1, (path, pcm[:16000 * 30]), backend="nccl",
                  timeout=300, echo=True)
    log(f"  a. launch_s={time.perf_counter() - t:.1f}")
    t = time.perf_counter()
    ranks = launch(f"{smoke}:scale_out_gloo", 2, (path, parakeet, pcm), backend="gloo",
                   timeout=600, echo=True)
    log(f"  b-e. launch_s={time.perf_counter() - t:.1f}")
    r0, r1 = ranks
    assert r0["tp"]["window"]["tokens"] == r1["tp"]["window"]["tokens"]
    for it in ("f16", "q8"):
        assert r0["tp"][it]["tokens"] == r1["tp"][it]["tokens"]
    assert r0["dp"]["segs"] == r1["dp"]["segs"], "the DP ranks merged other lists"
    assert r0["parakeet"]["tokens"] == r1["parakeet"]["tokens"]
    assert r0["finetune"]["loss"] == r1["finetune"]["loss"]
    log(f"  ranks agree: tp tokens, dp merged lists ({len(r0['dp']['segs'])} segments), "
        f"parakeet tokens, dp fine-tune loss; launches per rank: "
        + json.dumps([{"tp_encode": r["tp"]["launches"]["encode"],
                       "tp_window": r["tp"]["launches"]["window"],
                       "dp": r["dp"]["launches"]} for r in ranks]))
    log(f"  {nvidia_smi_line()}")
    log(f"  phase_s={time.perf_counter() - t_phase:.1f}")


# ---------------------------------------------------------------------------
# phase 13: the whisper-cli parity matrix, the card against the CPU
# ---------------------------------------------------------------------------

# the matrix's CPU rows come from a process of its own, started in phase 2b:
# one thread at a low priority, beside phase 10's whisper-quantize jobs
MATRIX_CPU_THREADS = 1
# the card's logits against the CPU's (both bf16 products) at a t > 0 draw
# where the two part: the kernels and their plain versions round at the same
# points but sum in other orders, and one bf16 rounding that flips (2^-8
# relative) carries through the later layers: 2^-8 of the row's largest
# |logit|
CARD_LOGIT_REL_BOUND = 2.0 ** -8
# (tier, the cases' models, the kernels its cases must launch on the card):
# K6 on the minis' 32- and the multilingual mini's 16-wide heads, K1 on the
# packed q5_0, q8_0 and q5_k decoders, K4 on the 64-wide heads (full dims,
# K-quant mini), K3 with the q8 cache, K2 on a DTW pass over packed planes
MATRIX_TIERS = (
    ("mini", ("f16", "tdrz-f16", "race-f16", "stat-s21", "stat-s22", "stat-s23",
              "stat-s24", "stat-s25"), ("flash_self_attention",)),
    ("quant", ("q5_0", "q8_0"), ("qmmt_fused", "flash_self_attention")),
    ("ml", ("ml-f16",), ("flash_self_attention",)),
    ("kq", ("kq-q5_k",), ("qmmt_fused", "self_attention_qkv")),
    ("fd", ("fd-f16", "fd-q5_0", "fd-ml-f16", "fd-stat-s31", "fd-stat-s32",
            "fd-stat-s37", "fd-stat-s38", "fd-stat-s41"),
     ("self_attention_qkv", "qmmt_fused")),
    ("fd@q8", (), ("self_attend_q8", "self_attention_qkv")),
    ("dtw packed", (), ("qmmt",)),
)


def matrix_cpu_rows(root: str, dst: str) -> None:
    """Phase 13's reference, in the process start_matrix_cpu starts: every
    case's rows on the CPU with the card's numerics (`port_engine(
    card_numerics=True)`: bf16 products and packed planes, the card's
    kernels' plain versions at their rounding points, as phases 5, 9 and 10
    compare), keyed by case name ("<name>@q8" for Q8_CASES with the q8
    cache), the script first set from SCRIPT_CASE; written to `dst` as
    JSON.  A t > 0 case also gets its draws' [token, u], so that phase 13
    finds where the card's part."""
    from whisper_tpu_torch.decoding import full, stdrng
    from whisper_tpu_torch.evals import matrix as MX

    t0 = time.perf_counter()
    inputs = MX.Inputs.make(os.path.join(root, "inputs"))
    engine = MX.port_engine("cpu", card_numerics=True)
    engine_q8 = MX.port_engine("cpu", "q8", card_numerics=True)
    inputs.set_script(MX.script_rows(engine, inputs))
    by_name = {c.name: c for c in MX.ALL_CASES + MX.EXTRA_CASES}
    runs = [(c.name, c, engine) for c in MX.ALL_CASES + MX.EXTRA_CASES]
    runs += [(n + "@q8", by_name[n], engine_q8) for n in MX.Q8_CASES]
    rows = {}
    for key, case, eng in runs:
        case = MX.synth_case(case, inputs)
        with MX.DrawRecorder(full, stdrng) as rec:
            res = MX.run_case(eng, case, inputs)
        if case.lpt is not None:
            res["draws"] = [[d.token, d.u] for d in rec.draws]
        rows[key] = res
        print(f"{key} {res['seconds']:.2f}s", flush=True)
    with open(dst + ".part", "w") as f:
        json.dump({"seconds": time.perf_counter() - t0,
                   "vad_threshold": inputs.vad_threshold, "cases": rows}, f)
    os.replace(dst + ".part", dst)


def start_matrix_cpu(root: str) -> dict:
    """`matrix_cpu_rows` in a process of its own, while the card runs
    phases 3-12; phase 13 shares its directory of seeded files."""
    os.makedirs(root, exist_ok=True)
    dst = os.path.join(root, "cpu.json")
    logf = open(dst + ".log", "w")
    cmd = ["nice", "-n", "15", sys.executable, "-c",
           f"import chip_smoke; chip_smoke.matrix_cpu_rows({root!r}, {dst!r})"]
    env = dict(os.environ, OMP_NUM_THREADS=str(MATRIX_CPU_THREADS),
               CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen(cmd, cwd=str(Path(__file__).resolve().parent),
                            stdout=logf, stderr=subprocess.STDOUT, env=env)
    return {"proc": proc, "log": logf, "dst": dst, "root": root, "t0": time.perf_counter()}


def finish_matrix_cpu(job: dict, timeout: float) -> dict:
    t0 = time.perf_counter()
    rc = job["proc"].wait(timeout=timeout)
    job["log"].close()
    with open(job["dst"] + ".log") as f:
        text = f.read()
    assert rc == 0, text[-3000:]
    with open(job["dst"]) as f:
        cpu = json.load(f)
    log(f"  CPU rows: {len(cpu['cases'])} runs in {cpu['seconds']:.1f} s (its own clock), "
        f"waited_s={time.perf_counter() - t0:.1f}")
    return cpu


class MatrixCard:
    """Phase 13's card side: the port's entry points on the card, each
    case held to the CPU's rows under the matrix's gates."""

    def __init__(self, MX, cpu: dict, root: str):
        import whisper_tpu_torch.decoding.full as TF
        import whisper_tpu_torch.decoding.logits as TLF
        import whisper_tpu_torch.decoding.stdrng as TR

        self.MX, self.TF, self.TLF, self.TR = MX, TF, TLF, TR
        self.cpu, self.root = cpu, root
        self.inputs = MX.Inputs.make(os.path.join(root, "inputs"))
        assert self.inputs.vad_threshold == cpu["vad_threshold"]
        self.inputs.set_script(cpu["cases"][MX.SCRIPT_CASE]["rows"])
        self.engines = {"f16": MX.port_engine("cuda"), "q8": MX.port_engine("cuda", "q8")}
        self.gates = {}

    def run(self, key: str, case, kv: str, keep=()):
        c = self.MX.synth_case(case, self.inputs)
        if case.name in self.MX.CLI_CASES:
            return self.MX.run_cli_case(c, self.inputs, self.root, "cuda"), []
        with self.MX.DrawRecorder(self.TF, self.TR, keep) as rec:
            res = self.MX.run_case(self.engines[kv], c, self.inputs)
        torch.cuda.synchronize()
        return res, rec.draws

    def cpu_draw(self, key: str, case, kv: str, k: int):
        """The CPU's draw k with its logits: the case run again here on the
        CPU, as the CPU process ran it (the same tokens and u)."""
        MX = self.MX
        eng = MX.port_engine("cpu", kv, card_numerics=True)
        with MX.DrawRecorder(self.TF, self.TR, (k,)) as rec:
            MX.run_case(eng, MX.synth_case(case, self.inputs), self.inputs)
        assert [[d.token, d.u] for d in rec.draws] == self.cpu["cases"][key]["draws"], key
        return rec.draws[k]

    def check(self, key: str, case, kv: str = "f16") -> str:
        MX = self.MX
        t0 = time.perf_counter()
        got, draws = self.run(key, case, kv)
        ref = self.cpu["cases"][key]
        if MX.is_statistical(case):
            stats = MX.statistical_gate(ref["rows"], got["rows"])
            assert stats["ok"], f"{key}: {stats}\ncpu: {ref['rows']}\ncard: {got['rows']}"
            gate = f"statistical similarity={stats['similarity']:.3f}"
        elif got["rows"] == ref["rows"]:
            gate = "exact"
        else:
            assert case.lpt is not None, (f"{key}: the card's rows differ from the CPU's\n"
                                          f"cpu: {ref['rows']}\ncard: {got['rows']}")
            k = MX.first_parting([MX.Draw(t, u) for t, u in ref["draws"]], draws)
            assert k is not None, f"{key}: rows differ with the same draws"
            _, kept = self.run(key, case, kv, keep=(k,))
            proof = MX.tie_proof(self.cpu_draw(key, case, kv, k), kept[k], self.TLF,
                                 self.TR, rel_bound=CARD_LOGIT_REL_BOUND)
            log(f"    {key}: draw {k} of {len(draws)} parts: "
                + json.dumps({n: proof[n] for n in ("tokens", "t", "u", "edge", "gap",
                                                     "effect", "delta", "bound",
                                                     "effect_of_delta", "a", "b")}))
            assert proof["ok"], f"{key}: draw {k} parts beyond a rounding tie"
            gate = f"tie at draw {k}"
        if "lang_id" in got:
            assert got["lang_id"] == ref["lang_id"], key
        self.gates[key] = gate
        log(f"    {key}: {gate}, segments={len(got['rows'])} card_s={time.perf_counter() - t0:.2f} "
            f"cpu_s={ref['seconds']:.2f}")
        return gate


def check_matrix(counters, job: dict, t_start: float) -> dict:
    """Phase 13: every case of the matrix (text_parity.CASES, the
    statistical tiers, the full-dims t = 0 cases with the q8 cache, a DTW
    pass on packed planes) through the port on the card, held to the CPU's
    rows; each tier's launches per kernel."""
    import gc

    from whisper_tpu_torch.evals import matrix as MX

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cpu = finish_matrix_cpu(job, timeout=max(60.0, 1150.0 - (time.perf_counter() - t_start)))
    card = MatrixCard(MX, cpu, job["root"])
    by_name = {c.name: c for c in MX.ALL_CASES + MX.EXTRA_CASES}
    tiers = {}
    for tier, models, kernels in MATRIX_TIERS:
        if tier == "fd@q8":
            runs = [(n + "@q8", by_name[n], "q8") for n in MX.Q8_CASES]
        elif tier == "dtw packed":
            runs = [(c.name, c, "f16") for c in MX.EXTRA_CASES]
        else:
            runs = [(c.name, c, "f16") for c in MX.ALL_CASES if c.model in models]
        _zero(counters)
        t = time.perf_counter()
        for key, case, kv in runs:
            card.check(key, case, kv)
        launches = _counts(counters)
        secs = time.perf_counter() - t
        log(f"  tier {tier}: cases={len(runs)} seconds={secs:.1f} launches={json.dumps(launches)}")
        for name in kernels:
            assert launches[name] > 0, f"tier {tier}: {name} was not launched"
        tiers[tier] = {"cases": len(runs), "seconds": secs, "launches": launches}
        for eng in card.engines.values():
            eng.ctxs.clear()
        gc.collect()
        torch.cuda.empty_cache()
    n = len(card.gates)
    assert n == len(MX.ALL_CASES) + len(MX.Q8_CASES) + len(MX.EXTRA_CASES)
    log(f"  gates: " + json.dumps({g: sum(1 for v in card.gates.values() if v.startswith(g))
                                   for g in ("exact", "statistical", "tie")}))
    log(f"  phase_s={time.perf_counter() - t_phase:.1f}")
    return tiers


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
    from whisper_tpu_torch.cli import server as TS
    from whisper_tpu_torch.cli import transcribe as TC
    from whisper_tpu_torch.decoding import device_loop as DL
    from whisper_tpu_torch.decoding import dtw as DTW
    from whisper_tpu_torch.decoding import graphs as G
    from whisper_tpu_torch.formats import quants as Q
    from whisper_tpu_torch.models.whisper import model as M
    from whisper_tpu_torch.models.whisper.hparams import LARGE_V3_TURBO
    from whisper_tpu_torch.ops import _cuda
    from whisper_tpu_torch.ops import attention as FA
    from whisper_tpu_torch.ops import decode_attn as DA
    from whisper_tpu_torch.ops import enc_attn as EA
    from whisper_tpu_torch.ops import qmm as QM
    from whisper_tpu_torch.models.vad.writer import synth_vad_tensors, write_vad_model
    from whisper_tpu_torch.runtime import batching as TBA
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

    heading("2. build", t_start)
    info = _cuda.build_all()
    for name, d in info.items():
        log(f"  {name}: build_s={d['seconds']:.2f} {d['path']}")
        for line in d["ptxas"].splitlines():
            if any(k in line for k in ("Compiling entry", "Used", "spill")):
                log(f"    {line.strip()}")

    heading("2b. phase 10's files, and its whisper-quantize jobs in the background",
            t_start)
    from whisper_tpu_torch.cli import make_imatrix as MI

    tools = tempfile.TemporaryDirectory()
    st = phase10_setup(W, MI, seeded_audio(40.0, seed=0), tools.name)
    atexit.register(stop_jobs, st["jobs"])
    log("  phase 13's matrix rows on the CPU, in the background")
    matrix = tempfile.TemporaryDirectory()
    matrix_job = start_matrix_cpu(matrix.name)
    atexit.register(stop_jobs, [matrix_job])

    heading("3. kernels against their plain versions (turbo shapes)", t_start)
    k1 = check_qmmt(dev, Q, QM)
    k3 = check_self_attend_q8(dev, DA)
    k4 = check_self_attention_qkv(dev, EA)
    k5 = check_qmm(dev, QM)
    k6 = check_flash(dev, FA, info["flash_attn"]["ptxas"])

    heading("4. paths: q5_0 large-v3-turbo, load() + transcribe(), flash encode, "
            "whisper-cli, whisper-bench", t_start)
    counters = G.COUNTED
    pcm = seeded_audio(40.0, seed=0)
    # the whole turbo file serves phase 4 (the main path); removed when main
    # returns
    turbo = tempfile.TemporaryDirectory()
    tmp = turbo.name
    path = os.path.join(tmp, "large-v3-turbo-q5_0.bin")
    t0 = time.perf_counter()
    write_synth_model(path, LARGE_V3_TURBO, seed=0, qtype="q5_0", decisive=True)
    log(f"  synth_s={time.perf_counter() - t0:.1f} bytes={os.path.getsize(path)}")
    ctx, segs_q8, launches = run_main_path(W, counters, path, "q8", pcm)
    graph_matches_eager(ctx, counters, "greedy", seeks=(0,))
    check_bucketed(M, QM, DA, G, ctx, pcm[:16000 * 30])
    check_qmm_auto(QM, dev)
    profile_window(W, ctx, pcm[:16000 * 30], "graphs")
    with eager_windows(ctx):
        profile_window(W, ctx, pcm[:16000 * 30], "eager")
    flag_period_sweep(W, DL, ctx, pcm[:16000 * 30])
    n_flash = flash_encode(M, FA, EA, ctx, pcm)
    del ctx
    ctx, segs_f16, launches_f16 = run_main_path(W, counters, path, "f16", pcm)
    profile_window(W, ctx, pcm[:16000 * 30], "graphs", beam=True)
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

    heading("5. small decisive model: the card against the CPU", t_start)
    with tempfile.TemporaryDirectory() as tmp:
        card_matches_cpu(tmp)

    heading("6. batched serving: whisper-server with concurrent requests, whisper-cli -p 4", t_start)
    # phases 6, 7 and 9-12 on the turbo file cut to 4 of its 32 encoder layers
    cut = os.path.join(turbo.name, "turbo-4enc-q5_0.bin")
    write_turbo_cut(cut)
    serve_batched(TS, counters, cut, turbo.name)
    run_cli_parallel(TC, TBA, counters, cut, wav, turbo.name)

    heading("7. before and after the window loop: VAD, device mel, DTW", t_start)
    vad_path = os.path.join(turbo.name, "silero-synth.bin")
    write_vad_model(vad_path, synth_vad_tensors(seed=0))
    pcm_vad = vad_clip()
    thr = check_vad(vad_path, pcm_vad)
    check_device_mel(cut, pcm_vad)
    wav_vad = os.path.join(turbo.name, "audio-40s-silences.wav")
    write_wav(wav_vad, pcm_vad)
    cli_dtw = run_cli_vad_dtw(W, TC, DTW, counters, cut, wav_vad, vad_path, thr, pcm_vad,
                              turbo.name)

    heading("8. Parakeet-TDT: full width, packed q5_0, the TDT loop's graphs, "
            "batched utterances, 700 s, parakeet-cli, card vs CPU", t_start)
    check_parakeet(counters, turbo.name, t_start)

    heading("9. the parity mode and grammars: load(precision=ggml_cpu_f16), graphs vs "
            "eager, whisper-cli --precision/-p 2/--grammar, card vs CPU", t_start)
    check_parity_grammar(W, M, TC, counters, cut, wav, pcm, turbo.name)

    heading("10. the rest of the CLIs and the format tools: whisper-stream, whisper-command, "
            "whisper-bench -w 0, imatrix capture, whisper-quantize q4_k/iq2_xxs, "
            "card vs CPU", t_start)
    bench = check_tools(W, counters, cut, wav, pcm, st, tools.name)

    heading("11. the C ABI and fine-tuning: libwhisper_tpu_torch.so in process and the C "
            "hosts on the card, fine-tuning at full width, card vs CPU", t_start)
    check_abi_and_training(W, counters, cut, pcm, turbo.name, here, (vad_path, pcm_vad, thr))

    heading("12. scale-out: a 1 x 1 NCCL mesh through graphs; two ranks on the card over "
            "gloo: Whisper tp=2, transcribe_multihost dp=2, Parakeet tp=2, fine-tuning dp=2",
            t_start)
    check_scale_out(cut, os.path.join(turbo.name, "parakeet-q5_0.bin"), pcm, here)
    turbo.cleanup()

    heading("10b. phase 10's small q4_k and iq2_xxs files, card vs CPU (their "
            "whisper-quantize jobs end last)", t_start)
    check_quantized_small(W, st, pcm)
    tools.cleanup()

    heading("13. the whisper-cli parity matrix: 47 cases, the statistical tiers, the "
            "full-dims tier with the q8 cache, on the card against the CPU", t_start)
    check_matrix(counters, matrix_job, t_start)
    matrix.cleanup()

    def entry(name, src, replaces, agg, n_launches):
        b_ms, by = bound_ms(agg["bytes"], agg["flops"])
        return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                "launches": n_launches, "max_abs_err": agg["err"], "ms": agg["ms"],
                "plain_ms": agg["plain_ms"], "bound_ms": b_ms, "bound_by": by,
                "library_ms": agg["library_ms"]}

    # launches: K1, K3, K4 on the q8 load() + transcribe() path; K2 on the
    # whisper-cli's DTW passes (phase 7); K5 on whisper-bench -w 2; K6 on the
    # flash-route encode
    kernels = [
        entry("qmmt_fused", "whisper_tpu_torch/csrc/qmmt.cu",
              "whisper_tpu/ops/qmm.py:333", k1["qmmt_fused"], launches["qmmt_fused"]),
        entry("qmmt", "whisper_tpu_torch/csrc/qmmt.cu",
              "whisper_tpu/ops/qmm.py:216", k1["qmmt"], cli_dtw["qmmt"]),
        entry("self_attend_q8", "whisper_tpu_torch/csrc/decode_attn.cu",
              "whisper_tpu/ops/decode_attn.py:96", k3, launches["self_attend_q8"]),
        entry("self_attention_qkv", "whisper_tpu_torch/csrc/enc_attn.cu",
              "whisper_tpu/ops/enc_attn.py:107", k4, launches["self_attention_qkv"]),
        entry("qmm", "whisper_tpu_torch/csrc/qmm.cu",
              "whisper_tpu/ops/qmm.py:116", k5, n_qmm),
        entry("flash_self_attention", "whisper_tpu_torch/csrc/flash_attn.cu",
              "whisper_tpu/ops/attention.py:48", k6, n_flash),
    ]
    log(f"  total_s={time.perf_counter() - t_start:.1f}")
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
