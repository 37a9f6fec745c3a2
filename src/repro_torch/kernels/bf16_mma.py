"""The arithmetic of the port's bf16 tensor-core kernels (K1's narrow
builds, the bf16 builds of K5a, K5b and K6), in plain torch, so the CPU can
hold it against float64.

A product of two bf16 values is exact in fp32.  The tensor core sums the
products in fp32, and the kernels sum each slice of reduction terms from
zero in the mma registers and add the slices to an fp32 total in order: K1
every 64 terms (``K1_SLICE``; its int8->fp32 build every 16,
``K1_I8F32_SLICE``, over the float32 w in three bf16 parts:
``k1_i8f32_emulated``), K5a's conv2 once a chunk of 64 mid channels
(``K5A_CHUNK`` x F2 x F2 terms; its conv1 runs one chain over K1), K5b's
conv2 once a chunk of 32 (``K5B_CHUNK``; its conv1 one chain a pass, over
all of K1), K6 every 32 output positions (``K6_SLICE``), each split of
the positions into its own total, the splits then summed in order
(``wgrad_emulated``).  ``gemm_emulated`` forms a product that way, each
slice's sum in fp32.

The stacks' conv2 reads the float32 mid activation, as the reference does.
``mid_parts`` cuts a float32 value into the bf16 parts the kernel
multiplies: three (hi = bf16(m), md = bf16(m - hi), lo = bf16(m - hi - md)),
whose sum is m exactly; two or one (m rounded to bf16) to compare.
``conv2_emulated`` is conv2's product over those parts.
"""
from __future__ import annotations

from typing import List

import torch

K1_SLICE = 64     # reduction terms K1's narrow builds sum before a flush
K5A_CHUNK = 64    # mid channels of a K5a chunk: conv2 flushes once a chunk
K5B_CHUNK = 32    # mid channels of a K5b chunk: conv2 flushes once a chunk
K6_SLICE = 32     # output positions of a K6 slice: flushed every slice
K1_I8F32_SLICE = 16   # terms of a chain of K1's int8->fp32 build (k16)


def to_bf16(a: torch.Tensor) -> torch.Tensor:
    """``a`` rounded to bf16 (to nearest even), held in float32."""
    return a.to(torch.bfloat16).float()


def mid_parts(m: torch.Tensor, parts: int = 3) -> List[torch.Tensor]:
    """float32 ``m`` as ``parts`` bf16 values (held in float32), each the
    rest of the ones before it rounded to bf16; three sum to ``m``
    exactly (8 significand bits each)."""
    out, rest = [], m.float()
    for _ in range(parts):
        part = to_bf16(rest)
        out.append(part)
        rest = rest - part
    return out


def gemm_emulated(a: torch.Tensor, bs: List[torch.Tensor],
                  slice_len: int = K1_SLICE) -> torch.Tensor:
    """a [M, K] @ sum(bs) [K, N] as the kernels form it, every operand a
    bf16 value (held in float32 or bf16): the reduction cut into slices of
    ``slice_len`` (zero-padded), each slice's products (exact) summed in
    fp32 from zero over every part of ``bs`` (in the order given: the
    kernel's lo, md, hi), the slices added to an fp32 total in order."""
    a = a.float()
    M, K = a.shape
    pad = -K % slice_len
    a = torch.nn.functional.pad(a, (0, pad))
    total = torch.zeros(M, bs[0].shape[1], dtype=torch.float32)
    per = a.reshape(M, -1, slice_len).transpose(0, 1)   # [slices, M, S]
    part = None
    for b in bs:
        b = torch.nn.functional.pad(b.float(), (0, 0, 0, pad))
        s = torch.bmm(per, b.reshape(-1, slice_len, b.shape[1]))
        part = s if part is None else part + s
    for s in part:
        total = total + s
    return total


def conv2_emulated(w2: torch.Tensor, mid: torch.Tensor, F2: int,
                   parts: int = 3, chunk: int = K5A_CHUNK) -> torch.Tensor:
    """A stack's conv2 product w2 [Co, K2] (bf16 values) @ mid [K2, cols]
    (float32), K2 = Cm x F2 x F2, with the mid cut into ``parts`` bf16
    parts (``mid_parts``), lo first, summed as ``gemm_emulated`` does, a
    slice a chunk of ``chunk`` mid channels (K5a's ``K5A_CHUNK``, K5b's
    ``K5B_CHUNK``)."""
    return gemm_emulated(w2, mid_parts(mid, parts)[::-1], chunk * F2 * F2)


def wgrad_emulated(g: torch.Tensor, x: torch.Tensor,
                   per: int) -> torch.Tensor:
    """K6 bf16's dw [Co, K] = g [Co, P] @ x [P, K] (bf16 values): the
    positions in splits of ``per`` (``wgrad_tiling``'s), each split
    summed as ``gemm_emulated`` does with a slice every ``K6_SLICE``
    positions, then the splits' fp32 totals added in split order (the
    kernel's second launch)."""
    total = None
    for p0 in range(0, g.shape[1], per):
        part = gemm_emulated(g[:, p0:p0 + per], [x[p0:p0 + per]], K6_SLICE)
        total = part if total is None else total + part
    return total


def k1_i8f32_emulated(w: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """K1's int8->fp32 product w [K, Co] (float32)^T @ p [K, cols] (int8
    values, exact in bf16) as its kernel forms it: w cut into three bf16
    parts (``mid_parts``), each k16 step's products summed from zero over
    the parts lo, md, hi, the steps added to an fp32 total in order.
    Returns [Co, cols]."""
    return gemm_emulated(p.float().t(), mid_parts(w)[::-1],
                         K1_I8F32_SLICE).t()
