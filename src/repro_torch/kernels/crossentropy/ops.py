"""Wrapper of the fused unembed + cross entropy kernel K12
(``csrc/crossentropy.cu``).

``fused_xent(h, table, labels, softcap=None)`` is the reference's
``repro.kernels.crossentropy.ops.fused_xent`` without the TPU tiling knobs:
h [T, D] and table [V, D] (float32 or bfloat16, one dtype), integer labels
[T] -> the per-token loss [T] float32, the [T, V] logits never stored.  A
label outside [0, V) hits no column: its loss is the bare logsumexp.  The
reference's padding of T and V to block multiples is not carried over:
the kernel masks the ragged edges.  The vocab axis is split across blocks
(``xent_splits``) into a small workspace that a second launch combines in
a fixed order, so two runs agree bit for bit; the two launches count as
one call.

For a CPU tensor it returns the plain version (``ref.xent_ref``); for a
CUDA tensor it launches the kernel or raises.  Launches are counted in
``fused_xent.launches``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.crossentropy.ref import xent_ref

_TILE = 128               # tokens and vocab columns a block tile holds
_SMS = 132                # H100 SXM streaming multiprocessors
_TARGET_BLOCKS = 16 * _SMS
_MAX_GRID_Y = 65535


def xent_splits(T: int, V: int) -> Tuple[int, int]:
    """(vocab tiles per split, splits) for T tokens and V columns: enough
    splits that the (token tile, split) grid holds ~16 blocks an SM, each
    split a contiguous run of 128-column vocab tiles, none empty."""
    t_tiles, v_tiles = -(-T // _TILE), -(-V // _TILE)
    want = min(v_tiles, _MAX_GRID_Y,
               max(1, -(-_TARGET_BLOCKS // max(t_tiles, 1))))
    per = -(-v_tiles // want)
    return per, -(-v_tiles // per)


def fused_xent(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
               softcap: Optional[float] = None) -> torch.Tensor:
    """K12: per-token ``logsumexp(z) - z[label]`` of the logits z = h @
    tableᵀ (``softcap * tanh(z / softcap)`` with a softcap) -> [T]
    float32."""
    if h.dim() != 2 or table.dim() != 2 or h.shape[1] != table.shape[1] \
            or labels.shape != (h.shape[0],):
        raise ValueError(f"fused_xent takes h [T, D], table [V, D], labels "
                         f"[T], got {tuple(h.shape)}, {tuple(table.shape)}, "
                         f"{tuple(labels.shape)}")
    if labels.dtype.is_floating_point or labels.dtype.is_complex \
            or labels.dtype == torch.bool:
        raise TypeError(f"fused_xent: labels are {labels.dtype}, not an "
                        "integer type")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"fused_xent: softcap {softcap} must be > 0")
    if _build.on_cpu("fused_xent", h):
        return xent_ref(h, table, labels, softcap)
    dtype = _build.require_cuda_float("fused_xent", h.device, h=h,
                                      table=table)
    if labels.device != h.device:
        raise ValueError(f"fused_xent: labels on {labels.device}, h on "
                         f"{h.device}")
    (T, D), V = h.shape, table.shape[0]
    if V < 1 or D < 1 or max(T, V) >= 2 ** 31:
        raise ValueError(f"fused_xent: T={T}, V={V}, D={D} not supported")
    per, splits = xent_splits(T, V)
    lab = labels.to(torch.int64).contiguous()
    ws = torch.empty(3, splits, T, device=h.device, dtype=torch.float32)
    loss = torch.empty(T, device=h.device, dtype=torch.float32)
    err = _build.library().xent_forward(
        h.data_ptr(), table.data_ptr(), lab.data_ptr(), ws.data_ptr(),
        loss.data_ptr(), T, V, D, float(softcap or 0.0), per, splits,
        int(dtype == torch.bfloat16), _build.stream_of(h.device))
    _build.check("fused_xent", err)
    fused_xent.launches += 1
    return loss


fused_xent.launches = 0
