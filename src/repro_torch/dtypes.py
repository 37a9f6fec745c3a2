"""Canonical storage-dtype names for the port.

The same names, aliases and byte widths as the JAX package's
``repro/dtypes.py``, so plan-cache keys written by either package agree
("bf16" == "bfloat16").  int8 is a storage dtype only: a network never
runs "uniform int8": tensors quantized per channel (``repro_torch.quant``)
are stored at 1 byte an element between conv chains, and the conv kernels
widen them and accumulate in float32.  float32 and bfloat16 execute on the
card (bfloat16 on the serving path's kernels, K1, K2, K5a and K4); float16
is a name only, so persisted plans and keys canonicalize identically.
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

# dtypes a whole network (params, host I/O, classifier head) can run in;
# int8 is storage-only and deliberately NOT in this set
FLOAT_DTYPES = ("float32", "bfloat16", "float16")

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


def is_float_dtype(dtype: str) -> bool:
    """True when ``dtype`` can carry a whole network (see FLOAT_DTYPES)."""
    return canon_dtype(dtype) in FLOAT_DTYPES
