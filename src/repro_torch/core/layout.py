"""Data-layout descriptors and layout algebra (paper §IV).

A layout is a string permutation of logical dim names, e.g. ``"NCHW"`` or
``"CHWN"`` for conv feature maps; the rightmost letter is minormost
(contiguous).  ``plan_transform`` is the paper's §IV.C dimension
combining: maximal runs of dims that appear contiguously in BOTH layouts
are collapsed (``CHWN -> NCHW`` collapses ``CHW``), so most CNN re-layouts
become a single 2-D transpose.  Same algebra as ``repro/core/layout.py``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Sequence, Tuple


def perm_between(src: str, dst: str) -> Tuple[int, ...]:
    """Axis permutation p such that ``x_src.permute(p)`` is laid out as dst."""
    if sorted(src) != sorted(dst):
        raise ValueError(f"layouts {src!r} / {dst!r} name different dims")
    return tuple(src.index(d) for d in dst)


@dataclass(frozen=True)
class TransformPlan:
    """Collapsed view of a layout change.

    ``groups_src``: slices of the source layout that move as units;
    ``perm``: permutation of those groups.
    """
    src: str
    dst: str
    groups_src: Tuple[str, ...]
    perm: Tuple[int, ...]

    @property
    def is_identity(self) -> bool:
        return self.perm == tuple(range(len(self.perm)))

    @property
    def is_2d_transpose(self) -> bool:
        return len(self.perm) == 2 and self.perm == (1, 0)

    def collapsed_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        dims = dict(zip(self.src, shape))
        return tuple(math.prod(dims[d] for d in g) for g in self.groups_src)


def plan_transform(src: str, dst: str) -> TransformPlan:
    """Collapse maximal common substrings (paper §IV.C dimension combining):
    scan ``src`` and start a new group wherever the next dim is not also the
    next one in ``dst`` order."""
    if sorted(src) != sorted(dst):
        raise ValueError(f"layouts {src!r} / {dst!r} name different dims")
    groups: List[str] = []
    cur = src[0]
    for a, b in zip(src, src[1:]):
        if dst.index(b) == dst.index(a) + 1:
            cur += b
        else:
            groups.append(cur)
            cur = b
    groups.append(cur)
    order = sorted(range(len(groups)), key=lambda i: dst.index(groups[i][0]))
    return TransformPlan(src=src, dst=dst, groups_src=tuple(groups),
                         perm=tuple(order))


def transform_bytes(shape: Sequence[int], dtype_bytes: int) -> int:
    """A layout transform reads + writes every element once."""
    return 2 * math.prod(shape) * dtype_bytes
