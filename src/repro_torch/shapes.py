"""Conv/pool output spatial sizes, shared by the configs, the executor, the
kernel wrappers and the plain versions so that none of them can disagree.

A copy of the JAX package's ``repro/shapes.py``: the port imports nothing
of that package.  Stdlib only.
"""
from __future__ import annotations


def conv_out_hw(hw: int, F: int, S: int, pad: int = 0) -> int:
    """Output rows/cols of an F x F convolution over ``hw`` x ``hw`` input
    with stride ``S`` and symmetric padding ``pad``."""
    return (hw + 2 * pad - F) // S + 1


def pool_out_hw(hw: int, F: int, S: int) -> int:
    """Output rows/cols of an F x F pooling window over ``hw`` x ``hw``
    input with stride ``S`` (pooling layers are unpadded everywhere in the
    paper's networks)."""
    return (hw - F) // S + 1
