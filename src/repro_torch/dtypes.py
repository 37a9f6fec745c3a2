"""Canonical storage-dtype names for the port.

The same names, aliases and byte widths as the JAX package's
``repro/dtypes.py``, so plan-cache keys written by either package agree
("bf16" == "bfloat16").  int8 is a storage dtype only: a network never
runs "uniform int8".  Only float32 executes in the port so far; the other
names exist so persisted plans and keys canonicalize identically.
"""
from __future__ import annotations

import torch

DEFAULT_DTYPE = "float32"
INT8_DTYPE = "int8"

_ALIASES = {
    "float32": "float32", "f32": "float32", "fp32": "float32",
    "bfloat16": "bfloat16", "bf16": "bfloat16",
    "float16": "float16", "f16": "float16", "fp16": "float16",
    "int8": "int8", "i8": "int8",
}

_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}

_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "int8": torch.int8}


def canon_dtype(dtype: str) -> str:
    """Canonical name ("bf16" -> "bfloat16"); raises on unknown dtypes."""
    try:
        return _ALIASES[str(dtype)]
    except KeyError:
        raise ValueError(
            f"unknown storage dtype {dtype!r}; known: {sorted(_ALIASES)}")


def dtype_bytes(dtype: str) -> int:
    """Element size in bytes of a (canonicalized) storage dtype."""
    return _BYTES[canon_dtype(dtype)]


def torch_dtype(dtype: str) -> torch.dtype:
    """The torch dtype for a storage dtype name."""
    return _TORCH[canon_dtype(dtype)]
