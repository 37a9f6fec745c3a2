"""Carry the reference's LM trees over to the port's per-layer layout.

The reference keeps every block leaf stacked over periods (``blocks``,
``cross``; the whisper encoder's ``encoder.blocks`` over its layers) and
its caches stacked the same way; the port keeps lists of per-layer dicts.
The trees arrive as numpy arrays (``jax.tree.map(np.asarray, tree)``).  A
bf16 leaf arrives as an ``ml_dtypes.bfloat16`` array, which
``torch.from_numpy`` refuses: it is taken bit for bit through an int16
view, recognised by its dtype's name (``ml_dtypes`` is not imported: the
card's machine has no JAX and may not have it).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """A copy of ``arr`` on ``device`` as a tensor of the same dtype, bf16
    bit for bit."""
    arr = np.array(arr)                        # a writable, contiguous copy
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree


def unstack(tree, device) -> List[Any]:
    """A tree whose leaves are stacked on a leading axis -> a list of the
    per-index trees, as tensors on ``device``: a reference cache (or
    prefill's cross K/V) stacked over periods becomes the port's list over
    periods."""
    n = np.shape(_first_leaf(tree))[0]
    return [_map(tree, lambda a, i=i: tensor_from_numpy(np.asarray(a)[i],
                                                        device))
            for i in range(n)]


def params_from_reference(tree: Dict[str, Any], device) -> Dict:
    """The reference's parameter tree (numpy leaves, period-stacked) as
    the port's per-layer tree of tensors on ``device``."""
    out: Dict[str, Any] = {}
    for key, sub in tree.items():
        if key in ("blocks", "cross"):
            out[key] = unstack(sub, device)
        elif key == "encoder":
            out[key] = {"blocks": unstack(sub["blocks"], device),
                        "final_norm": _map(sub["final_norm"],
                                           lambda a: tensor_from_numpy(
                                               a, device))}
        else:
            out[key] = _map(sub, lambda a: tensor_from_numpy(a, device))
    return out
