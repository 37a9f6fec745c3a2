"""K1's int8->fp32 build (``conv_chwn_i8f32_kernel`` in
``kernels/conv/csrc/conv_chwn.cu``) and the bf16 transposes K9a/K9b
(``transpose_bf16_kernel`` in ``kernels/transpose/csrc/transpose.cu``),
on the card.

- K1 int8->fp32 on the calibration's case (Fig. 4's base layer: N 64,
  Ci 256, 13 x 13, Co 384, F 3, CHWN) and on every point of the
  calibration sweep (Ci 1-512 at N 64, N 16-512 at Ci 256 and 512),
  within 1e-5 scale-relative of float64 and rtol 1e-4 / atol 1e-3 of the
  plain version; with bias, ReLU, a max or avg pool (and ``save_act``'s
  z), a residual, an NCHW source or output, ragged N, Co not a multiple of
  4, and x one byte past an 8-byte boundary (element-by-element copies);
  three runs bitwise equal and ``variant_launches["i8f32"]`` stepped by
  one a launch.
- K9a and K9b bf16 on every launch shape of ``chip_smoke.py`` (ResNet-18
  b32's [32, X] -> [X, 32] re-layouts, K9b's [32, 64, 224 * 224] case),
  and on ragged shapes (N not a multiple of 8, below one tile, M past one
  tile, odd M and N) and x one or two halfwords past a 16-byte boundary
  (the 4-byte and halfword paths), exactly equal to the plain version;
  three runs bitwise equal.

Every test needs a CUDA device and ``nvcc`` and skips with the reason
where either is missing.  No jax, no reference package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_k1_i8f32_k9_bf16_card.py
"""
from __future__ import annotations

import math

import pytest
import torch

from repro_torch.core.layout import perm_between
from repro_torch.kernels import _build
from repro_torch.kernels.conv.ops import _conv, conv_direct_chwn
from repro_torch.kernels.conv.ref import conv_ref
from repro_torch.kernels.transpose.ops import (transpose2d,
                                               transpose2d_batched)
from repro_torch.kernels.transpose.ref import (transpose2d_batched_ref,
                                               transpose2d_ref)
from repro_torch.perfmodel.calibration import C_SWEEP, N_SWEEP
from repro_torch.shapes import conv_out_hw

CONV_RTOL, CONV_ATOL = 1e-4, 1e-3
TC_FP32_TOL = 1e-5

# (N, Ci, H, Co, F, S, pad, pool, res, src, dst, x byte offset, save_act)
CAL = (64, 256, 13, 384, 3, 1, 0, None, False, "CHWN", "CHWN", 0, False)
SWEEP = sorted({(64, ci) for ci in C_SWEEP}
               | {(n, ci) for n in N_SWEEP for ci in (256, 512)})
K1_CASES = [CAL] + [
    (n, ci, 13, 384, 3, 1, 0, None, False, "CHWN", "CHWN", 0, False)
    for n, ci in SWEEP if (n, ci) != (64, 256)] + [
    (16, 64, 13, 96, 3, 1, 1, (3, 2, "max"), True, "CHWN", "CHWN", 0, False),
    (16, 64, 13, 96, 3, 1, 1, (3, 2, "max"), False, "CHWN", "CHWN", 0, True),
    (8, 32, 12, 64, 3, 1, 1, (2, 2, "avg"), True, "CHWN", "NCHW", 0, False),
    (13, 48, 11, 40, 3, 1, 0, None, True, "CHWN", "CHWN", 0, False),
    (5, 24, 9, 30, 3, 2, 1, None, False, "NCHW", "CHWN", 0, False),
    (64, 256, 13, 384, 3, 1, 0, None, False, "CHWN", "CHWN", 1, False),
    (32, 96, 27, 128, 5, 1, 2, (3, 2, "max"), False, "CHWN", "CHWN", 0,
     False),
    (128, 3, 35, 96, 11, 4, 0, None, False, "NCHW", "CHWN", 0, False),
]


def _k1_id(c):
    N, Ci, H, Co, F, S, pad, pool, res, src, dst, off, save = c
    return (f"N{N}-Ci{Ci}-H{H}-Co{Co}-F{F}s{S}p{pad}-{pool and pool[2]}"
            f"{'-res' if res else ''}-{src}to{dst}"
            f"{f'-off{off}' if off else ''}{'-z' if save else ''}")


# K9a: [M, N]; K9b: [B, M, N]; x offset in halfwords
K9A_CASES = [((32, 100352), 0), ((32, 50176), 0), ((32, 25088), 0),
             ((32, 100), 0), ((64, 37), 0), ((32, 7), 0), ((64, 130), 0),
             ((17, 9), 0), ((100, 24), 0), ((1, 1000), 0), ((1000, 1), 0),
             ((33, 70), 0), ((30, 98), 0), ((32, 1024), 1), ((32, 1024), 2),
             ((64, 520), 1), ((128, 4096), 0)]
K9B_CASES = [((32, 64, 224 * 224), 0), ((3, 64, 37), 0), ((2, 32, 300), 0),
             ((4, 65, 130), 0), ((2, 64, 8), 0), ((3, 30, 96), 2),
             ((2, 64, 256), 1)]


@pytest.fixture
def card():
    reason = _build.toolchain_missing()
    if reason:
        pytest.skip(reason)
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _offset(t: torch.Tensor, off: int) -> torch.Tensor:
    """``t`` copied to a view ``off`` elements past an aligned base."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    v = buf[off:].view(t.shape)
    v.copy_(t)
    return v


@pytest.mark.parametrize("case", K1_CASES, ids=_k1_id)
def test_k1_i8f32_matches_plain_and_float64(card, case):
    N, Ci, H, Co, F, S, pad, pool, res, src, dst, off, save = case
    g = torch.Generator(device=card).manual_seed(K1_CASES.index(case))
    q = torch.randint(-127, 128, (N, Ci, H, H), device=card, generator=g,
                      dtype=torch.int8)
    w = torch.randn(Co, Ci, F, F, device=card, generator=g) \
        / (127 * math.sqrt(Ci * F * F))
    b = torch.randn(Co, device=card, generator=g)
    Ho = conv_out_hw(H, F, S, pad)
    r = (torch.randn(Co, Ho, Ho, N, device=card, generator=g) if res
         else None)
    x = _offset(q.permute(perm_between("NCHW", src)).contiguous(), off)
    wk = w.permute(1, 2, 3, 0).contiguous()
    kw = dict(bias=b, relu=True, pool=pool, res=r, res_layout="CHWN",
              src_layout=src, dst_layout=dst)
    before = conv_direct_chwn.variant_launches["i8f32"]
    # the wrappers' own path; save_act (the training forward) returns z too
    got = _conv("CHWN", x, wk, S, pad, save_act=save, **kw)
    torch.cuda.synchronize()
    assert conv_direct_chwn.variant_launches["i8f32"] == before + 1
    want = conv_ref(x, w, S, pad, save_act=save, act_layout="CHWN", **kw)
    k64 = {**kw, "bias": b.double(), "res": None if r is None else r.double()}
    want64 = conv_ref(x, w.double(), S, pad, save_act=save,
                      act_layout="CHWN", **k64)
    outs = zip(got, want, want64) if save else [(got, want, want64)]
    for o, p, p64 in outs:
        assert o.dtype == torch.float32 and o.shape == p.shape
        torch.testing.assert_close(o, p, rtol=CONV_RTOL, atol=CONV_ATOL)
        err = ((o.double() - p64).abs().max()
               / max(1.0, p64.abs().max().item())).item()
        assert err <= TC_FP32_TOL, err
    again = [_conv("CHWN", x, wk, S, pad, save_act=save, **kw)
             for _ in range(2)]
    for a in again:
        for o, p in (zip(a, got) if save else [(a, got)]):
            assert torch.equal(o, p)


@pytest.mark.parametrize("case", K9A_CASES,
                         ids=lambda c: f"{c[0][0]}x{c[0][1]}-off{c[1]}")
def test_k9a_bf16_exact(card, case):
    shape, off = case
    x = _offset(torch.randn(*shape, device=card).to(torch.bfloat16), off)
    before = transpose2d.variant_launches["bf16"]
    got = transpose2d(x)
    torch.cuda.synchronize()
    assert transpose2d.variant_launches["bf16"] == before + 1
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert torch.equal(got.view(torch.int16),
                       transpose2d_ref(x).view(torch.int16))
    for _ in range(2):
        assert torch.equal(transpose2d(x), got)


@pytest.mark.parametrize("case", K9B_CASES,
                         ids=lambda c: "x".join(map(str, c[0]))
                         + f"-off{c[1]}")
def test_k9b_bf16_exact(card, case):
    shape, off = case
    x = _offset(torch.randn(*shape, device=card).to(torch.bfloat16), off)
    before = transpose2d_batched.variant_launches["bf16"]
    got = transpose2d_batched(x)
    torch.cuda.synchronize()
    assert transpose2d_batched.variant_launches["bf16"] == before + 1
    assert torch.equal(got.view(torch.int16),
                       transpose2d_batched_ref(x).view(torch.int16))
    for _ in range(2):
        assert torch.equal(transpose2d_batched(x), got)
