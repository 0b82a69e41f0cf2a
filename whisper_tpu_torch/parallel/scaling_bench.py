"""Decode scaling over (dp, tp) mesh configurations.

The counterpart of tools/scaling_bench.py: batched-serving decode
throughput (tokens/s) on each (dp, tp) configuration and its efficiency
against linear scaling of the first configuration run.  Each configuration
is n_dp * n_tp local ranks (parallel/launch.py) on a (dp, tp) mesh
(parallel/mesh.py `make_mesh`); each dp shard decodes `--windows` windows,
which ride the decode step's beam axis, on its tp group's shards of a
synthetic dense decoder (`utils/synth.py synth_params`, parallel/sharding.py
`shard_params`).  A rank times chains of greedy decode steps of two lengths
(the better of two runs each, after a warm-up chain); the difference of the
two times over the difference of the lengths is its step time, free of the
chains' set-up, and a configuration's step is its slowest rank's.

On the CPU the ranks run over gloo (each on one thread, f32 products): a
check that every configuration shards and runs, not a speed figure.  On
the card, one rank over NCCL (bf16 products; NCCL refuses two ranks on one
device), so only 1x1 runs there:

  python -m whisper_tpu_torch.parallel.scaling_bench --model tiny \\
      --configs 1x1,2x1,1x2,2x2 [--windows 4] [--steps 32] [--backend gloo|nccl]

Output: one JSON line per configuration {config, devices, dp, tp, model,
windows_total, tok_s, efficiency_vs_linear}, or {config, skipped} for one
that needs more devices than there are (the cards under NCCL, the CPU
cores under gloo) or whose tp does not divide the heads.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..models.whisper import hparams as H

DIMS = {"tiny": H.TINY, "base": H.BASE, "small": H.SMALL, "medium": H.MEDIUM,
        "large-v3": H.LARGE_V3, "large-v3-turbo": H.LARGE_V3_TURBO}


def step_seconds(hp, mesh, n_windows: int, n_steps: int, dtype, device,
                 seed: int = 0) -> float:
    """This rank's seconds per decode step of `n_windows` rows on its shard
    of `mesh` (every rank of the mesh calls it)."""
    from ..models.whisper import model as M
    from ..utils.synth import synth_params
    from .mesh import axis_group, group_size
    from .sharding import shard_params

    tp = axis_group(mesh, "tp")
    params = shard_params(synth_params(hp, dtype, seed=seed, device=device), mesh, hp)
    W, Tc = n_windows, hp.n_audio_ctx
    d = hp.n_text_state // hp.n_text_head
    g = torch.Generator(device=device).manual_seed(seed + 1 + dist.get_rank())
    xk = torch.randn((hp.n_text_layer, W, hp.n_text_head // group_size(tp), Tc, d),
                     generator=g, device=device).to(dtype)
    xv = xk * 0.5

    def run(K: int) -> float:
        dist.barrier()
        t0 = time.perf_counter()
        cache = M.new_cache(hp, W, dtype, device=device, tp=tp)
        tok = torch.zeros((W, 1), dtype=torch.long, device=device)
        for i in range(K):
            pos = torch.full((W, 1), min(i, hp.n_text_ctx - 1), device=device)
            logits, cache = M.decode_step(params, tok, pos, i, cache, xk, xv, hp,
                                          dtype=dtype, tp=tp)
            tok = logits.argmax(-1)
        int(tok.sum())                     # the chain's end, on the host
        return time.perf_counter() - t0

    run(4)
    k1, k2 = max(1, n_steps // 4), n_steps
    t1 = min(run(k1) for _ in range(2))
    t2 = min(run(k2) for _ in range(2))
    return max(1e-9, (t2 - t1) / (k2 - k1))


def _rank(model: str, n_dp: int, n_tp: int, n_windows: int, n_steps: int) -> float:
    """One rank of a configuration's launch."""
    from .mesh import make_mesh

    cuda = dist.get_backend() == "nccl"
    return step_seconds(DIMS[model], make_mesh(n_dp, n_tp), n_windows, n_steps,
                        torch.bfloat16 if cuda else torch.float32, "cuda" if cuda else "cpu")


def config_line(spec: str, model: str, n_dp: int, n_tp: int, n_windows: int,
                tok_s: float, base_tok_s: Optional[float]) -> dict:
    """The JSON line of one configuration; `base_tok_s` is the first run
    configuration's (None: this one is the first)."""
    n = n_dp * n_tp
    eff = tok_s / ((base_tok_s or tok_s) * n)
    return {"config": spec, "devices": n, "dp": n_dp, "tp": n_tp, "model": model,
            "windows_total": n_dp * n_windows, "tok_s": round(tok_s, 1),
            "efficiency_vs_linear": round(eff, 3)}


def skip_reason(hp, n_dp: int, n_tp: int, n_dev: int) -> Optional[str]:
    if n_dp * n_tp > n_dev:
        return f"needs {n_dp * n_tp} devices, have {n_dev}"
    if hp.n_text_head % n_tp:
        return f"tp={n_tp} does not divide {hp.n_text_head} heads"
    return None


def main(argv: Optional[list] = None) -> int:
    from .launch import launch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="tiny", choices=sorted(DIMS))
    ap.add_argument("--configs", default="1x1,2x1,4x1,8x1,4x2,2x4",
                    help="comma-separated DPxTP list")
    ap.add_argument("--windows", type=int, default=4, help="serving windows per dp shard")
    ap.add_argument("--steps", type=int, default=32)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    a = ap.parse_args(argv)
    n_dev = torch.cuda.device_count() if a.backend == "nccl" else os.cpu_count() or 1
    hp = DIMS[a.model]
    base_tok_s = None
    for spec in a.configs.split(","):
        n_dp, n_tp = (int(v) for v in spec.strip().split("x"))
        why = skip_reason(hp, n_dp, n_tp, n_dev)
        if why:
            print(json.dumps({"config": spec, "skipped": why}), flush=True)
            continue
        steps = launch("whisper_tpu_torch.parallel.scaling_bench:_rank", n_dp * n_tp,
                       (a.model, n_dp, n_tp, a.windows, a.steps), backend=a.backend,
                       timeout=900.0, threads=None if a.backend == "nccl" else 1)
        tok_s = n_dp * a.windows / max(steps)
        print(json.dumps(config_line(spec, a.model, n_dp, n_tp, a.windows, tok_s, base_tok_s)),
              flush=True)
        if base_tok_s is None:
            base_tok_s = tok_s
    return 0


if __name__ == "__main__":
    sys.exit(main())
