"""Carry a parameter tree of numpy arrays over to the port's tensors.

The tree is the layout of the JAX package's parameter pytree
(models/whisper/load.py build_param_pytree, plus the packed overlay that
runtime/context.py installs): nested dicts, the per-layer `blocks_packed`
list, and named tuples of planes (QWeight, QWeightT, XK8, KVCache,
KVCache8).  A named tuple maps onto the port's class of the same name
(QWeightT with its rows pitched as runtime/context.py installs them), so a
tree taken from the JAX package (with its leaves turned into numpy arrays)
and a tree the port builds itself compute the same thing.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ...ops.qmm import QWeight, pitch_qweight_t
from .model import XK8, KVCache, KVCache8

_NAMED = {c.__name__: c for c in (QWeight, XK8, KVCache, KVCache8)}


def to_tensor(a, device="cpu") -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":        # ml_dtypes arrays from JAX
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:      # read-only views (e.g. of JAX arrays)
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """Map every array leaf of `tree` to a tensor on `device`; dicts, lists
    and the named plane tuples keep their structure (None stays None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_numpy(v, device) for v in tree]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        name = type(tree).__name__
        if name == "QWeightT":     # the kernel's pitched install
            return pitch_qweight_t(*(None if v is None else to_tensor(v)
                                     for v in tree), device=device)
        cls = _NAMED.get(name)
        if cls is None:
            raise TypeError(f"no port counterpart for {name}")
        return cls(*(params_from_numpy(v, device) for v in tree))
    return to_tensor(tree, device)
