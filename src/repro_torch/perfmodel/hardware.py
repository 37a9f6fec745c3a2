"""The device inputs of the cost model, as one frozen ``Hardware`` profile.

The reference's traffic model hard-codes its device: the peak rate and the
memory bandwidth of ``repro/launch/mesh.py``, the lane and sublane tiling
and the 256-byte coalescing span of ``repro/perfmodel/traffic.py``, and a
stack gate that sizes a staged tile against a fixed on-chip budget.  Here
each of those is a field, so the same arithmetic prices any device; the
port's default is the H100 (``default_hardware``), whose numbers come
from its data sheet and from the port's own kernels.

The stack gate decides whether a conv->conv pair may run as one stack
kernel.  ``"smem"`` asks the stack kernels' own tile model
(``kernels.conv.ops.stack_tiling``) whether a block tile fits the shared
memory of one block, and the conv kernels' (``conv_tiling``,
``nchw_tiling``) whether a conv may fold its pool; ``"budget"`` is a
footprint of the staged tile (``traffic.stack_vmem_bytes``) under
``stack_budget`` bytes, row-blocked by ``stack_blocking`` (the port's
copy, ``traffic.stack_blocking``, unless one is given), and folds every
pool.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch

STACK_GATES = ("smem", "budget")


def _lookup(table: Tuple[Tuple[int, float], ...], dtype_bytes: int, what):
    for k, v in table:
        if k == dtype_bytes:
            return v
    raise ValueError(f"no {what} for dtype_bytes={dtype_bytes!r}; known "
                     f"element sizes: {sorted(k for k, _ in table)}")


@dataclass(frozen=True)
class Hardware:
    """Every device-specific input of ``perfmodel.traffic``.

    ``peak_flops``, ``minor`` and ``second_minor`` are keyed by the element
    size in bytes of the stored operand.  ``minor`` is the granule of a
    tensor's minor (contiguous) dim, ``second_minor`` that of the next one
    out (a conv's reduction), ``co_block`` the granule the NCHW engine
    rounds Co up to, ``span_bytes`` the bytes the CHWN engine's N must span
    to read at full rate."""
    name: str
    peak_flops: Tuple[Tuple[int, float], ...]
    mem_bw: float                       # bytes/s
    minor: Tuple[Tuple[int, int], ...]
    second_minor: Tuple[Tuple[int, int], ...]
    co_block: int
    span_bytes: int
    stack_gate: str = "smem"
    stack_budget: int = 0               # bytes, for the "budget" gate
    stack_blocking: Optional[Callable] = None

    def __post_init__(self):
        if self.stack_gate not in STACK_GATES:
            raise ValueError(f"unknown stack gate {self.stack_gate!r}; "
                             f"known: {STACK_GATES}")

    def peak(self, dtype_bytes: int) -> float:
        return _lookup(self.peak_flops, dtype_bytes, "peak rate")

    def minor_granule(self, dtype_bytes: int) -> int:
        return _lookup(self.minor, dtype_bytes, "minor-dim granule")

    def second_minor_granule(self, dtype_bytes: int) -> int:
        return _lookup(self.second_minor, dtype_bytes,
                       "second-minor-dim granule")


# NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit: the data sheet's
# dense rates and bandwidth
H100_HBM_BW = 3.35e12               # bytes/s
H100_BF16_FLOPS = 989e12            # tensor cores, bf16 (and fp16)
H100_TF32_FLOPS = 495e12            # tensor cores, TF32
H100_INT8_OPS = 1979e12             # tensor cores, int8


@functools.lru_cache(maxsize=None)
def default_hardware() -> Hardware:
    """The H100 profile (NVIDIA H100 80GB HBM3, 700 W power limit); one
    shared, immutable instance."""
    return Hardware(
        name="NVIDIA H100 80GB HBM3",
        # fp32 convs run 3xTF32 (three TF32 products a term, K1/K2/K5b);
        # bf16 on m16n8k16; int8 on m16n8k32
        peak_flops=((4, H100_TF32_FLOPS / 3), (2, H100_BF16_FLOPS),
                    (1, H100_INT8_OPS)),
        mem_bw=H100_HBM_BW,
        # N is the CHWN minor dim: K1 keeps at least 8 images in a pooled
        # tile, so a run of 8 columns is 32 bytes (one sector) of a row
        minor=((4, 8), (2, 16), (1, 32)),
        # the reduction advances by one mma k-step: m16n8k8 (TF32),
        # m16n8k16 (bf16), m16n8k32 (int8)
        second_minor=((4, 8), (2, 16), (1, 32)),
        # K2 (``nchw_tiling``) blocks Co by 64, 128 or 256
        co_block=64,
        # a warp's 32 lanes coalesce into one 128-byte line
        span_bytes=128,
        # the kernels tile themselves (``stack_tiling``, ``conv_tiling``,
        # ``nchw_tiling``): a pair stacks, and a conv folds its pool, when
        # a block tile fits one block's shared memory
        stack_gate="smem")


# The JAX package's device model (a TPU v5e chip): its peak rate and
# memory bandwidth (``repro/launch/mesh.py``), the lane and sublane tiling,
# the 256-byte coalescing span and the stack footprint budget
# (``repro/perfmodel/traffic.py``), copied: the port imports nothing of it
TPU_V5E_BF16_FLOPS = 197e12         # per chip
TPU_V5E_HBM_BW = 819e9              # bytes/s per chip
TPU_LANES = 128
TPU_SUBLANES = ((4, 8), (2, 16), (1, 32))
TPU_STACK_BUDGET = 14 * (1 << 20)   # bytes of VMEM a stack's tile may take


@functools.lru_cache(maxsize=None)
def reference_hardware() -> Hardware:
    """The reference's own device profile: the JAX package's cost model
    of a TPU v5e, with its stack gate (a staged-tile footprint under a
    fixed budget, row-blocked as ``traffic.stack_blocking``, the port's
    copy of the reference's geometry).  Under it the port's planner makes
    the reference's plans, field for field; the card runs such a plan (the
    packaged plans are made so).  One shared, immutable instance."""
    return Hardware(
        name="reference (TPU v5e model)",
        peak_flops=tuple((b, TPU_V5E_BF16_FLOPS) for b in (4, 2, 1)),
        mem_bw=TPU_V5E_HBM_BW,
        minor=tuple((b, TPU_LANES) for b in (4, 2, 1)),
        second_minor=TPU_SUBLANES,
        co_block=TPU_LANES,
        span_bytes=TPU_LANES * 2,
        stack_gate="budget",
        stack_budget=TPU_STACK_BUDGET)


def hardware_id(device=None) -> str:
    """Identity of the silicon a measurement ran on: the CUDA device's
    name, or ``"cpu"``.  ``device`` defaults to the CUDA device when there
    is one."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
