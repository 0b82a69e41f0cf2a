"""Collective audit of the TP-sharded decode step.

The counterpart of tools/collective_audit.py.  The JAX tool reads the
collectives GSPMD put into the compiled step's HLO; here every collective
of the model seams is a `torch.distributed.all_reduce` that
parallel/mesh.py's `all_reduce_sum` (after each row-parallel product) or
`all_reduce_max` (the q8 self-KV cache's row amax) launches, so the audit
runs one `decode_step` on a (1, tp) mesh of N ranks (parallel/launch.py)
and records every all_reduce the step launches: op, dtype[shape], bytes.
A one-rank group launches none.

Same model and step as the JAX tool: a synthetic dense f32 decoder
(`utils/synth.py synth_params`), 1500 cross-attention positions, B beams,
one token, f32 products; `--itype q8` takes the q8 self-KV cache instead of
the float one.  Gloo ranks on the CPU; on the card one rank over NCCL (NCCL
refuses two ranks on one device):

  python -m whisper_tpu_torch.parallel.collective_audit [--layers 4] \\
      [--state 1024] [--heads 16] [--beams 8] [--tp 1 2 4 8] [--itype f16|q8] \\
      [--backend gloo|nccl]
"""

from __future__ import annotations

import argparse
import contextlib
import sys
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

# the reduce op's name in the table: `all_reduce_sum` and `all_reduce_max`
OP_NAMES = {dist.ReduceOp.SUM: "all-reduce", dist.ReduceOp.MAX: "all-reduce-max"}
DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
               torch.int32: "s32", torch.int64: "s64", torch.int8: "s8"}


def audit_hparams(layers: int, state: int, heads: int):
    """The JAX tool's decoder: 51864 tokens, 448 text and 1500 audio
    positions, one encoder layer (the step reads none of it)."""
    from ..models.whisper.hparams import WhisperHParams

    return WhisperHParams(n_vocab=51864, n_audio_ctx=1500, n_audio_state=state,
                          n_audio_head=heads, n_audio_layer=1, n_text_ctx=448,
                          n_text_state=state, n_text_head=heads, n_text_layer=layers,
                          n_mels=80)


@contextlib.contextmanager
def recorded_all_reduces():
    """Every torch.distributed.all_reduce launched inside the block, as
    (op, dtype name, shape, bytes) in launch order."""
    calls: List[Tuple[str, str, Tuple[int, ...], int]] = []
    inner = dist.all_reduce

    def all_reduce(tensor, op=dist.ReduceOp.SUM, group=None, async_op=False):
        calls.append((OP_NAMES.get(op, str(op)), DTYPE_NAMES.get(tensor.dtype, str(tensor.dtype)),
                      tuple(tensor.shape), tensor.numel() * tensor.element_size()))
        return inner(tensor, op=op, group=group, async_op=async_op)

    dist.all_reduce = all_reduce
    try:
        yield calls
    finally:
        dist.all_reduce = inner


def step_collectives(hp, mesh, beams: int, itype: str = "f16", device="cpu",
                     seed: int = 0) -> Tuple[list, torch.Tensor]:
    """The all_reduces of one decode step (one token, `beams` rows, kv_head
    0) on this rank's part of the synthetic decoder under `mesh`'s tp axis
    (None: one device), and the step's logits.  Every rank of the mesh
    calls it."""
    from ..models.whisper import model as M
    from ..utils.synth import synth_params
    from .mesh import axis_group, group_size
    from .sharding import shard_params

    params = synth_params(hp, torch.float32, seed=seed, device=device)
    tp = None if mesh is None else axis_group(mesh, "tp")
    local = params if mesh is None else shard_params(params, mesh, hp)
    d_head = hp.n_text_state // hp.n_text_head
    xk = torch.zeros((hp.n_text_layer, hp.n_text_head // group_size(tp), hp.n_audio_ctx,
                      d_head), device=device)
    cache = M.new_cache(hp, beams, torch.float32, itype=itype, device=device, tp=tp)
    toks = torch.zeros((beams, 1), dtype=torch.long, device=device)
    with recorded_all_reduces() as calls:
        logits, _ = M.decode_step(local, toks, toks, 0, cache, xk, torch.zeros_like(xk), hp,
                                  dtype=torch.float32, tp=tp)
    return calls, logits


def _rank(layers: int, state: int, heads: int, beams: int, itype: str) -> list:
    """One rank of a launch: the step on a (1, world) mesh."""
    from .mesh import make_mesh

    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return step_collectives(audit_hparams(layers, state, heads),
                            make_mesh(1, dist.get_world_size()), beams, itype, device)[0]


def audit(n_tp: int, layers: int, state: int, heads: int, beams: int,
          itype: str = "f16", backend: str = "gloo") -> list:
    """The step's all_reduces on rank 0 of an n_tp-rank launch."""
    from .launch import launch

    return launch("whisper_tpu_torch.parallel.collective_audit:_rank", n_tp,
                  (layers, state, heads, beams, itype), backend=backend, timeout=600.0,
                  threads=1)[0]


def summarize(calls: list) -> Tuple[Dict[str, int], int, Dict[tuple, Tuple[int, int]]]:
    """(count per op, bytes per step, {(op, dtype[shape]): (count, bytes each)})."""
    counts: Dict[str, int] = {}
    by_shape: Dict[tuple, Tuple[int, int]] = {}
    total = 0
    for op, dt, shape, nb in calls:
        counts[op] = counts.get(op, 0) + 1
        key = (op, f"{dt}[{','.join(str(s) for s in shape)}]")
        by_shape[key] = (by_shape.get(key, (0, 0))[0] + 1, nb)
        total += nb
    return counts, total, by_shape


def table_rows(n_tp: int, calls: list, layers: int) -> List[str]:
    """The JAX tool's row for one tp, then its per-shape lines."""
    counts, nbytes, by_shape = summarize(calls)
    desc = " + ".join(f"{v} {k}" for k, v in sorted(counts.items())) or "none"
    rows = [f"| {n_tp} | {desc} | {sum(counts.values()) / layers:.2f} | "
            f"{nbytes / 1024:.1f} KiB |"]
    for (op, shape), (cnt, nb) in sorted(by_shape.items(),
                                         key=lambda kv: -kv[1][0] * kv[1][1]):
        rows.append(f"    {op:20s} {shape:24s} x{cnt:<4d} {nb} B each")
    return rows


def header(layers: int, state: int, heads: int, beams: int, itype: str) -> List[str]:
    return [f"decode step: {layers} layers, S={state}, H={heads}, B={beams}, 1 token, "
            f"{itype} self-KV cache",
            "| tp | collectives (total) | per layer | bytes/step |",
            "|---|---|---|---|"]


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--state", type=int, default=1024)
    ap.add_argument("--heads", type=int, default=16)
    ap.add_argument("--beams", type=int, default=8)
    ap.add_argument("--tp", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--itype", choices=("f16", "q8"), default="f16")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    a = ap.parse_args(argv)
    if a.backend == "nccl" and max(a.tp) > max(1, torch.cuda.device_count()):
        ap.error(f"NCCL takes one rank per card: tp={max(a.tp)} on "
                 f"{torch.cuda.device_count()} card(s)")
    for line in header(a.layers, a.state, a.heads, a.beams, a.itype):
        print(line)
    for n_tp in a.tp:
        if a.heads % n_tp:
            print(f"| {n_tp} | skipped: tp={n_tp} does not divide {a.heads} heads | | |")
            continue
        calls = audit(n_tp, a.layers, a.state, a.heads, a.beams, a.itype, a.backend)
        for line in table_rows(n_tp, calls, a.layers):
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
