"""The arithmetic of the port's 3xTF32 tensor-core kernels (K1, K6, K12),
in plain torch, so the CPU can hold it against float64.

The kernels (``csrc/mma.cuh``) split each fp32 operand v into big = v
rounded to TF32 (10 mantissa bits; to nearest, ties away from zero) and
small = v - big, which the tensor core reads truncated to TF32, and form a
product as a_small*b_big + a_big*b_small + a_big*b_big.  The tensor core
truncates as it accumulates, so a kernel sums each slice of 32 reduction
terms from zero and adds the slices to an fp32 total in order.
``gemm_emulated`` computes a product that way (each slice's sum in fp32).
"""
from __future__ import annotations

import torch

SLICE = 32   # reduction terms a kernel sums before it flushes


def rna_tf32(a: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as ``cvt.rna.tf32.f32`` rounds."""
    u = a.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & 0xFFFFE000
    u = torch.where(u >= 2 ** 31, u - 2 ** 32, u)
    return u.to(torch.int32).view(torch.float32)


def trunc_tf32(a: torch.Tensor) -> torch.Tensor:
    """fp32 cut to TF32: the tensor core reads the top 19 bits."""
    u = a.contiguous().view(torch.int32) & -0x2000
    return u.view(torch.float32)


def gemm_emulated(a: torch.Tensor, b: torch.Tensor, split: bool = True,
                  slice_len: int = SLICE) -> torch.Tensor:
    """a [M, K] @ b [K, N] in fp32 as the kernels form it: the reduction
    cut into slices of ``slice_len`` (zero-padded), each slice's products
    summed in fp32 from zero, the slices added to an fp32 total in order.
    ``split``: the 3xTF32 products; else one TF32 product a term."""
    a, b = a.float(), b.float()
    M, K = a.shape
    pad = -K % slice_len
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        b = torch.nn.functional.pad(b, (0, 0, 0, pad))
    ab, bb = rna_tf32(a), rna_tf32(b)

    def slices(x, y):   # [slices, M, N]: each slice's sum in fp32
        return torch.bmm(x.reshape(M, -1, slice_len).transpose(0, 1),
                         y.reshape(-1, slice_len, y.shape[1]))

    part = slices(ab, bb)
    if split:
        part = (slices(trunc_tf32(a - ab), bb)
                + slices(ab, trunc_tf32(b - bb))) + part
    total = torch.zeros(M, b.shape[1], dtype=torch.float32)
    for s in part:
        total = total + s
    return total
