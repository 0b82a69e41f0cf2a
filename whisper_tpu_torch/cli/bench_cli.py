"""whisper-bench equivalent (reference: examples/bench/bench.cpp,
whisper.h:756-759 whisper_bench_memcpy / whisper_bench_ggml_mul_mat).

Port of whisper_tpu/cli/bench_cli.py, on the CUDA card:

  -w 1   device memcpy bandwidth
  -w 2   matmul throughput at 4096^2: a chain of bf16 torch.matmul (plain,
         as jnp.matmul is in the JAX package), then a chain of q5_0-style
         fused-dequant products through the qmm kernel (csrc/qmm.cu)
  -w 0   the full-model bench (cli/bench_model.py, the port of the repo's
         bench.py): one JSON line of encoder, decode, batch, prompt and
         Parakeet rows for -m MODEL (default large-v3, plus the
         large-v3-turbo rows)

Times come from CUDA events around chains of two lengths, so the launch of
the chain and its readback cancel out.  The command has no CPU flag, as the
JAX one has none: without a card it raises.  `bench_memcpy` and
`bench_mul_mat` take `n` and `device` so that tests can call them small on
the CPU (host clock there).

Usage: python -m whisper_tpu_torch.cli.bench_cli [-w N] [-m MODEL_NAME]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..runtime.context import resolve_device


def _timed_chain(make_chain, n1: int, n2: int, dev: torch.device, reps: int = 3) -> float:
    """Seconds per link of a chain: the best of `reps` runs of the n2-long
    chain less the n1-long one, over n2 - n1.  Card: CUDA events; CPU: the
    host clock."""
    f1, f2 = make_chain(n1), make_chain(n2)
    f1()
    f2()

    def t_of(f):
        best = float("inf")
        for _ in range(reps):
            if dev.type == "cuda":
                a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                a.record()
                f()
                b.record()
                b.synchronize()
                best = min(best, a.elapsed_time(b) / 1e3)
            else:
                t0 = time.perf_counter()
                f()
                best = min(best, time.perf_counter() - t0)
        return best

    return (t_of(f2) - t_of(f1)) / (n2 - n1)


def bench_memcpy(n: int = 256 * 1024 * 1024 // 4, device=None) -> int:
    """Device copy bandwidth (whisper_bench_memcpy analogue): a chain of
    `acc = acc + acc[-1]` over n f32, each link reading and writing the
    whole buffer."""
    dev = resolve_device(device)
    x = torch.zeros(n, dtype=torch.float32, device=dev)

    def mk(k):
        def f():
            acc = x
            for _ in range(k):
                acc = acc + acc[-1]
            return acc[::65536].sum().item()
        return f

    dt = _timed_chain(mk, 8, 56, dev, reps=5)
    bw = 2 * n * 4 / dt / 1e9
    print(f"memcpy: {bw:7.2f} GB/s (device read+write, {n * 4 / 2**20:g} MB buffer)")
    return 0


def bench_mul_mat(n: int = 4096, device=None) -> int:
    """n^2 matmul throughput per weight format
    (whisper_bench_ggml_mul_mat analogue)."""
    from ..ops.qmm import qmm

    dev = resolve_device(device)
    N = n
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((N, N))).to(dev, torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((N, N))).to(dev, torch.bfloat16)
    codes = torch.from_numpy(rng.integers(-16, 16, (N, N))).to(dev, torch.int8)
    scales = torch.from_numpy(rng.random((N, N // 32))).to(dev, torch.float32) * 0.02

    flops = 2 * N * N * N

    def mk_dense(k):
        def f():
            acc = x
            for _ in range(k):
                acc = torch.matmul(acc, w)
            return acc.float().sum().item()
        return f

    dt = _timed_chain(mk_dense, 4, 12, dev)
    print(f"mul_mat {N}x{N}: bf16 {flops / dt / 1e12:7.2f} TFLOPS")

    def mk_q(k):
        def f():
            acc = x.float()
            for _ in range(k):
                acc = qmm(acc, codes, scales)
            return acc.sum().item()
        return f

    dt = _timed_chain(mk_q, 2, 6, dev)
    print(f"mul_mat {N}x{N}: q5_0 fused dequant {flops / dt / 1e12:7.2f} TFLOPS")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="whisper-bench")
    ap.add_argument("-w", "--what", type=int, default=0,
                    help="0=full model, 1=memcpy, 2=mul_mat")
    ap.add_argument("-m", "--model", default="large-v3",
                    help="model size name for -w 0 (synthetic weights)")
    args = ap.parse_args(argv)

    from ..runtime.logging import print_system_info

    print(print_system_info(), file=sys.stderr)

    if args.what == 1:
        return bench_memcpy()
    if args.what == 2:
        return bench_mul_mat()
    import os

    from . import bench_model

    os.environ["WTPU_BENCH_MODEL"] = args.model
    bench_model.main()
    return 0


if __name__ == "__main__":
    sys.exit(main())
