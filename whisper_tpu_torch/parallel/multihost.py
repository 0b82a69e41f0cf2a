"""Multi-host execution on torch.distributed.

Port of whisper_tpu/parallel/multihost.py, the counterpart of the
reference's RPC remote-device backend (ggml/src/ggml-rpc/ggml-rpc.cpp:34-75).
Every host runs the same program, one process per card; what this module
adds:

  * :func:`init_distributed` — the default process group from explicit
    arguments or WTPU_COORDINATOR / WTPU_NUM_PROCESSES / WTPU_PROCESS_ID
    (tcp:// or a URL), else from the variables torchrun sets (env://, the
    counterpart of the JAX package's pod auto-detection);
  * :func:`make_global_mesh` — a (dp, tp) mesh whose 'tp' groups stay
    within a host (consecutive ranks of one host) and whose 'dp' axis spans
    hosts: data parallelism tolerates the slow links, tensor parallelism
    does not;
  * :func:`transcribe_multihost` — the DP-over-hosts chunk scheduler: the
    audio is split as whisper_full_parallel splits it
    (src/whisper.cpp:7811-7939), each process transcribes its own chunks,
    and the segment lists are all-gathered and merged with the
    reference's offset fix-up and non-overlap clamp, so every process
    returns the same list.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

SAMPLE_RATE = 16000
# a collective that waits longer than this raises (a rank that died)
COLLECTIVE_TIMEOUT_S = 600


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None) -> None:
    """Initialise the default process group.

    `coordinator` is "host:port" of rank 0, or a URL that
    torch.distributed takes (tcp://, file://), or WTPU_COORDINATOR; with no
    coordinator at all the group comes from torchrun's variables (env://).
    The backend is "nccl" when a CUDA card is present and "gloo" otherwise,
    unless the caller names one; under NCCL the process takes card
    LOCAL_RANK (or its rank) mod the card count.  A backend that fails to
    initialise raises."""
    coordinator = coordinator or os.environ.get("WTPU_COORDINATOR")
    if num_processes is None and "WTPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["WTPU_NUM_PROCESSES"])
    if process_id is None and "WTPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["WTPU_PROCESS_ID"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"

    kw: Dict[str, Any] = {"timeout": datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)}
    if coordinator is None:
        kw["init_method"] = "env://"
        rank = int(os.environ.get("RANK", 0))
    else:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id "
                             "(or WTPU_NUM_PROCESSES / WTPU_PROCESS_ID)")
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        kw.update(init_method=url, world_size=num_processes,
                  rank=process_id)
        rank = process_id
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % max(1, torch.cuda.device_count()))
    dist.init_process_group(backend=backend, **kw)


def check_layout(n_dp: Optional[int], n_tp: int, n_global: int,
                 local_counts: List[int]) -> int:
    """The JAX `make_global_mesh` checks on a layout of `n_global` ranks
    whose hosts hold `local_counts` ranks each (one card per rank); returns
    n_dp (n_global // n_tp when None) or raises ValueError."""
    n_local = local_counts[0]
    n_proc = len(local_counts)
    if n_tp > n_local:
        raise ValueError(
            f"tp={n_tp} exceeds the {n_local} devices local to one host — "
            "tensor parallelism must not cross DCN")
    if n_dp is None:
        n_dp = n_global // n_tp
    if len(set(local_counts)) > 1:
        counts = dict(enumerate(local_counts))
        raise ValueError(
            "hosts expose unequal device counts "
            f"({counts}) — the (dp, tp) mesh needs a uniform per-host layout; "
            "drop the ragged host")
    if n_local % n_tp != 0:
        raise ValueError(
            f"tp={n_tp} does not divide the {n_local} devices per host — "
            "tp groups would straddle hosts (DCN)")
    if n_dp * n_tp != n_global:
        raise ValueError(
            f"mesh dp={n_dp} x tp={n_tp} = {n_dp * n_tp} does not cover the "
            f"{n_global} global devices ({n_proc} hosts x "
            f"{n_local} devices); pick dp*tp == n_devices")
    return n_dp


def make_global_mesh(n_dp: Optional[int] = None, n_tp: int = 1):
    """A (dp, tp) mesh over every rank, 'tp' within a host.  The per-host
    count is LOCAL_WORLD_SIZE (all ranks when unset: one host); ranks are
    host-major, as torchrun numbers them, so tp groups of consecutive ranks
    stay on one host."""
    from .mesh import make_mesh

    n_global = dist.get_world_size()
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", n_global))
    local = _allgather_pyobj(n_local)
    # one entry per host: the first rank of each host's block
    hosts, r = [], 0
    while r < n_global:
        hosts.append(local[r])
        r += max(1, local[r])
    n_dp = check_layout(n_dp, n_tp, n_global, hosts)
    return make_mesh(n_dp, n_tp)


_GLOO: Dict[str, Any] = {"world": None, "group": None}


def _object_group():
    """The group objects travel over: the default group under gloo, else a
    gloo group of every rank, made once per default group (every rank
    makes it together, at its first object exchange)."""
    if dist.get_backend() == "gloo":
        return None
    if _GLOO["world"] is not dist.group.WORLD:
        _GLOO.update(world=dist.group.WORLD, group=dist.new_group(backend="gloo"))
    return _GLOO["group"]


def _allgather_pyobj(obj: Any) -> List[Any]:
    """Every rank's picklable `obj`, in rank order (the merge step's segment
    exchange); [obj] outside a process group of more than one rank."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj, group=_object_group())
    return out


def transcribe_multihost(ctx, params, samples: np.ndarray,
                         chunks_per_host: int = 1) -> List[Any]:
    """DP-over-hosts transcription: process p takes chunks {p, p+P, ...} of
    the whisper_full_parallel split; the results are all-gathered so EVERY
    process returns the same complete, merged segment list."""
    from ..decoding.full import full_with_state
    from ..decoding.parallel import replace_params, transcribe_parallel

    on = dist.is_initialized()
    n_proc = dist.get_world_size() if on else 1
    pid = dist.get_rank() if on else 0
    n_chunks = n_proc * chunks_per_host
    if n_chunks <= 1:
        return transcribe_parallel(ctx, params, samples, 1)

    if params.vad:
        from ..models.vad.pipeline import filter_speech

        filtered = filter_speech(ctx, params, samples)
        if filtered is None:
            return []
        samples, _, _ = filtered

    n_samples = len(samples)
    offset_samples = (SAMPLE_RATE * params.offset_ms) // 1000
    n_per = (n_samples - offset_samples) // n_chunks

    local: List[Any] = []   # (chunk_idx, segments)
    for i in range(n_chunks):
        if i % n_proc != pid:
            continue
        if i == 0:
            chunk = samples[: offset_samples + n_per]
            p = replace_params(params)
        else:
            start = offset_samples + i * n_per
            n_cur = n_samples - start if i == n_chunks - 1 else n_per
            chunk = samples[start: start + n_cur]
            p = replace_params(params, clear_offset=True)
        segs = full_with_state(ctx, p, chunk)
        ctx.prompt_past0, ctx.prompt_past1 = [], []
        local.append((i, segs))

    # exchange + deterministic merge (identical on every process)
    gathered = _allgather_pyobj(local)
    by_chunk = {i: segs for part in gathered for (i, segs) in part}

    all_segments: List[Any] = []
    offset_t = params.offset_ms // 10
    for i in range(n_chunks):
        segs = by_chunk.get(i, [])
        if i == 0:
            all_segments.extend(segs)
            continue
        shift = 100 * (i * n_per) // SAMPLE_RATE + offset_t
        for s in segs:
            s.t0 += shift
            s.t1 += shift
            if all_segments:
                s.t0 = max(s.t0, all_segments[-1].t1)
            all_segments.append(s)
    return all_segments
