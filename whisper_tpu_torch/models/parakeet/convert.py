"""Carry a Parakeet parameter tree of numpy arrays over to the port's tensors.

The tree is the layout of the JAX package's Parakeet pytree
(models/parakeet/load.py build_param_pytree, with the packed overlay that
its context installs: `PQW` named tuples of planes in place of the dense
conformer weights).  A `PQW` maps onto the port's `model.PQW`, so a tree
taken from a JAX `ParakeetContext` (leaves turned into numpy arrays) and a
tree the port builds from the same file compute the same thing.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .model import PQW


def _tensor(a, device, dtype) -> torch.Tensor:
    arr = np.ascontiguousarray(a)
    if not arr.flags.writeable:      # read-only views (e.g. of JAX arrays)
        arr = arr.copy()
    t = torch.from_numpy(arr)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree: Any, device="cpu", dtype=torch.float32) -> Any:
    """Map every array leaf of `tree` to a tensor on `device`; dicts keep
    their structure and a `PQW` tuple (by name) becomes the port's `PQW`,
    its planes kept in their own dtypes, as does a bare (codes, scales,
    mins) tuple of build_packed_overlay.  Dense float leaves take `dtype`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return PQW(*(None if v is None else _tensor(v, device, None) for v in tree))
    return _tensor(tree, device, dtype)
