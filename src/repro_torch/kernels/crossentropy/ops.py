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

_TILE = 128               # tokens and vocab rows a block tile holds
_SMS = 132                # H100 SXM streaming multiprocessors
_MAX_GRID_Y = 65535
# a block's pipeline fill and final combine, in vocab tiles (modeled)
_FILL_TILES = 0.5


def xent_splits(T: int, V: int) -> Tuple[int, int]:
    """(vocab tiles per split, splits) for T tokens and V columns: the
    split whose (token tile, split) grid has the least modeled time, the
    waves of resident blocks (one an SM: the kernel's 128 KB ring) times a
    block's vocab tiles plus ``_FILL_TILES``; each split a contiguous run of
    128-row vocab tiles, none empty, fewer splits on a tie."""
    t_tiles, v_tiles = -(-T // _TILE), -(-V // _TILE)
    t_tiles = max(t_tiles, 1)
    best = None
    for per in range(1, v_tiles + 1):
        splits = -(-v_tiles // per)
        if splits > _MAX_GRID_Y or -(-v_tiles // splits) != per:
            continue   # too many, or the same ranges as a smaller per
        cost = -(-(t_tiles * splits) // _SMS) * (per + _FILL_TILES)
        if best is None or (cost, splits) < best[0]:
            best = ((cost, splits), per, splits)
    return best[1], best[2]


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
        int(dtype == torch.bfloat16), _build.stream_of(h.get_device()))
    _build.check("fused_xent", err)
    fused_xent.launches += 1
    return loss


fused_xent.launches = 0
