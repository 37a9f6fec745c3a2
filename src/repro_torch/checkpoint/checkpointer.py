"""Atomic, asynchronous checkpoints of a tree of tensors
(``repro/checkpoint/checkpointer.py``).

  * **atomic**: written to ``<dir>/tmp.<step>.<pid>``, then moved into
    place by ``os.replace``: a crash mid-write never harms the newest
    checkpoint;
  * **asynchronous**: the copy to the host happens in ``save``, the write
    on a thread; one write is outstanding at most, and its error is raised
    at the next ``wait`` (or ``save``);
  * **self-describing**: a JSON manifest holds the step and each leaf's
    path, dtype and shape, checked on restore.

The format is the reference's, so each package reads the other's
checkpoint of the same nested-dict tree: leaf paths spelled as jax's
``keystr`` spells them (``"['conv1']['w']"``), leaves in jax's order
(dict keys sorted; None is an empty subtree), the arrays in one
``np.savez`` file as ``a0``, ``a1``, ..., and bf16 stored as a ``uint16``
view under the dtype name ``"bfloat16"``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Iterator, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in jax's flattening order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [pl for i, v in enumerate(tree)
                for pl in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(like, leaves: Iterator):
    """``like``'s structure with its leaves taken from ``leaves`` in
    ``_flatten``'s order."""
    if like is None:
        return None
    if isinstance(like, dict):
        vals = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return type(like)((k, vals[k]) for k in like)
    if isinstance(like, (list, tuple)) and not hasattr(like, "_fields"):
        return type(like)(_unflatten(v, leaves) for v in like)
    return next(leaves)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(the array ``np.savez`` stores, the manifest's dtype name): a copy,
    so the caller may change the leaf while the write runs."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
        return a, str(a.dtype)
    a = np.array(leaf, copy=True)
    return a, str(a.dtype)


def _restore_leaf(a: np.ndarray, like, device):
    """The stored array ``a`` as the kind of leaf ``like`` is: a tensor of
    its dtype on ``device`` (default: its own), a numpy array of its dtype,
    or a Python scalar of its type."""
    if isinstance(like, torch.Tensor):
        if tuple(a.shape) != tuple(like.shape):
            raise ValueError(f"stored shape {a.shape} != {tuple(like.shape)}")
        dev = like.device if device is None else torch.device(device)
        if like.dtype == torch.bfloat16 and a.dtype == np.uint16:
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(a)).to(like.dtype)
        return t.to(dev)
    if isinstance(like, (np.ndarray, np.generic)):
        target = np.dtype(like.dtype)
        if (a.dtype != target and a.dtype.kind == "u"
                and a.dtype.itemsize == target.itemsize):
            out = a.view(target)
        else:
            out = np.asarray(a).astype(target)
        return out if isinstance(like, np.ndarray) else out[()]
    return type(like)(a.item())


class Checkpointer:
    def __init__(self, directory: str, async_write: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: Any, block: bool = False) -> None:
        self.wait()                     # one outstanding write at most
        flat = [(p, *_to_host(x)) for p, x in _flatten(tree)]

        def write():
            try:
                self._write_sync(step, flat)
            except BaseException as e:   # raised at the next wait()
                self._error = e

        if self.async_write and not block:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        else:
            write()
            self._raise_if_failed()

    def _write_sync(self, step: int, flat) -> None:
        tmp = self.dir / f"tmp.{step}.{os.getpid()}"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / "arrays.npz",
                 **{f"a{i}": a for i, (_, a, _) in enumerate(flat)})
        manifest = {
            "step": step,
            "paths": [p for p, _, _ in flat],
            "dtypes": [d for _, _, d in flat],
            "shapes": [list(a.shape) for _, a, _ in flat],
            "time": time.time(),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = self.dir / f"step_{step:010d}"
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self._raise_if_failed()

    def _raise_if_failed(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError(f"async checkpoint write failed: {e}") from e

    # -- restore -------------------------------------------------------------

    def steps(self) -> List[int]:
        """Every checkpoint step on disk, ascending (a restart walks them
        newest first)."""
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*"))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, tree_like: Any, step: Optional[int] = None,
                device=None):
        """Restore into the structure of ``tree_like``: each leaf comes
        back as ``tree_like``'s leaf is (tensors of its dtype on ``device``,
        default the leaf's own device).  Returns (step, tree).  A manifest
        or file that does not match raises."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        flat_like = _flatten(tree_like)
        paths = [p for p, _ in flat_like]
        if paths != manifest["paths"]:
            diff = set(manifest["paths"]) ^ set(paths)
            raise ValueError(
                f"checkpoint/tree structure mismatch: {sorted(diff)[:5]}")
        with np.load(d / "arrays.npz") as data:
            arrays = [data[f"a{i}"] for i in range(len(flat_like))]
        for p, a, shape in zip(paths, arrays, manifest["shapes"]):
            if list(a.shape) != list(shape):
                raise ValueError(f"{p}: array shape {a.shape} != the "
                                 f"manifest's {shape}")
        leaves = iter([_restore_leaf(a, like, device)
                       for a, (_, like) in zip(arrays, flat_like)])
        return step, _unflatten(tree_like, leaves)

    # -- retention -----------------------------------------------------------

    def gc(self, keep: int = 3) -> None:
        for p in sorted(self.dir.glob("step_*"))[:-keep]:
            shutil.rmtree(p, ignore_errors=True)
