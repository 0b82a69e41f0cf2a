"""The (dp, tp) device mesh and the collectives the model seams call.

Port of whisper_tpu/parallel/mesh.py.  The JAX mesh is an array of devices
that GSPMD partitions over; here it is a `DeviceMesh` over the ranks of the
initialised default process group, and its per-axis process groups are
what the code takes: `mesh["tp"].get_group()` (or `axis_group(mesh,
"tp")`) is the group the model functions' `tp=` seams all-reduce over,
`axis_group(mesh, "dp")` the one OptContext(mesh=) reduces gradients over.
One rank is one device (one process per card, or on the CPU one process
per rank), and the ranks of one tp group are consecutive, as in the JAX
package's `reshape(n_dp, n_tp)`.

The mesh's device type follows the default group's backend: "cuda" for
NCCL, "cpu" for gloo (whose collectives also take CUDA tensors, through
the host, so ranks that share one card can run a tp group over gloo).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _require_init(what: str) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(
            f"{what} needs an initialised torch.distributed default process "
            "group: call whisper_tpu_torch.parallel.multihost.init_distributed "
            "(or torch.distributed.init_process_group) first")


def make_mesh(n_dp: int = 1, n_tp: Optional[int] = None,
              devices: Optional[Sequence[int]] = None):
    """A (dp, tp) DeviceMesh over `devices` (the default group's ranks, all
    of them by default); every rank of the default group must call it."""
    _require_init("make_mesh")
    from torch.distributed.device_mesh import DeviceMesh

    devices = list(devices if devices is not None else range(dist.get_world_size()))
    if n_tp is None:
        n_tp = len(devices) // n_dp
    assert n_dp * n_tp == len(devices), (
        f"mesh {n_dp}x{n_tp} != {len(devices)} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    arr = torch.tensor(devices, dtype=torch.int64).reshape(n_dp, n_tp)
    return DeviceMesh(device_type, arr, mesh_dim_names=("dp", "tp"))


def axis_group(mesh, axis: str):
    """The process group of this rank along mesh axis `axis`."""
    return mesh.get_group(axis)


def group_size(group) -> int:
    """The ranks in `group`; 1 for None (no tensor parallelism)."""
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    """This rank's index in `group`; 0 for None."""
    return 0 if group is None else dist.get_rank(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over `group` in place (the partial products of a
    row-parallel projection); x unchanged, and no collective launched, for
    None or a one-rank group (a one-device JAX mesh has no collective)."""
    if group_size(group) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max over `group`, in place; x unchanged for None or
    a one-rank group."""
    if group_size(group) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def take(x: torch.Tensor, dim: int, n: int, r: int, what: str = "a tensor") -> torch.Tensor:
    """Part r of n of `x` along `dim`, as a contiguous copy (so the whole
    tensor can be freed)."""
    if x.shape[dim] % n:
        raise ValueError(f"{what}: dimension {dim} of {tuple(x.shape)} does not "
                         f"split over {n} ranks")
    k = x.shape[dim] // n
    return x.narrow(dim, r * k, k).contiguous()


def shard(mesh, spec: Optional[int], x: torch.Tensor) -> torch.Tensor:
    """This rank's part of `x` under `spec`: the dimension sharded over the
    mesh's 'tp' axis, or None for a replicated tensor (returned as is)."""
    if spec is None:
        return x
    group = axis_group(mesh, "tp")
    return take(x, spec, group_size(group), group_rank(group))
