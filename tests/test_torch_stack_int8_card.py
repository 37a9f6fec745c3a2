"""int8 x into the conv->conv stacks on the card: the four builds K5a
int8->fp32, K5a int8->bf16 (``kernels/conv/csrc/conv_stack_chwn.cu``),
K5b int8->fp32 and K5b int8->bf16 (``conv_stack_nchw.cu``).

- Each build on its engine's cases against the plain version
  (``conv_stack_ref``) on the same card inputs: int8->fp32 within 1e-5
  scale-relative of float64 (as K1 int8->fp32) and rtol 1e-4 / atol 1e-3 of
  the float32 plain version; int8->bf16 within one bf16 step (2^-7 |want|
  + 1e-5 max |want|).  x is quantized per channel with its scale folded
  into w1.  The cases reach both x paths of each build: runs of n (K5a:
  CHWN x, N a multiple of 8) or of w (K5b: NCHW x, W a multiple of 8 or
  of 4) widened from 4- or 8-byte loads, and element by element (N or W
  ragged, a CHWN source into K5b, x one byte past an aligned base).
- The output is w's dtype; ``variant_launches`` steps by one a launch;
  the FLOPs the blocks execute (and K5a's cluster) are ``stack_tiling``'s;
  three runs are bitwise equal; ``stack_max_clusters`` answers for the
  int8 builds.
- The int8->bf16 kernels' copy paths at their edges (``EDGE_CASES``): W
  of 55, 13 and 7, pad 0 and 2, conv1 stride 2, CHWN N of 4 and 12 (no
  runs of n), an NCHW source into K5a, x as a view 1, 2 and 4 bytes past
  an aligned base, W 64 (K5b's 8-aligned box), several chunks of Cm in a
  cluster of 3 (K5a): each within one bf16 step of the plain version, with
  bitwise repeats and the counted FLOPs; K5b's output also bitwise equal
  to its bf16 twin's on the same values (the same consumers and sums).
- The int8->fp32 kernels at the same edges (K5b: x by 16-, 8- or 4-byte
  chunks, or element loads; K5a: runs of 8 images, or element loads),
  each within 1e-5 scale-relative of float64, with bitwise repeats and
  the counted FLOPs; K5b int8->fp32's output bitwise equal to its float32
  twin's on the same values.
- A build error or a launch the card refuses raises
  (``KernelBuildError``, ``KernelLaunchError``): nothing falls back.

Every test needs a CUDA device and ``nvcc`` and skips with the reason
where either is missing.  No jax, no reference package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_stack_int8_card.py
"""
from __future__ import annotations

import math

import pytest
import torch

from repro_torch.core.layout import perm_between
from repro_torch.kernels import _build
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.kernels.conv.ref import conv_stack_ref
from repro_torch.quant import fold_scale_into_weights, quantize
from repro_torch.shapes import conv_out_hw

CONV_RTOL, CONV_ATOL = 1e-4, 1e-3
TC_FP32_TOL = 1e-5
BF16_STEP = 2.0 ** -7
WDT = {"i8f32": torch.float32, "i8bf16": torch.bfloat16}

# (N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, res layout, src, dst,
#  x byte offset)
K5A_CASES = [
    (16, 8, 12, 16, 24, 3, 1, 1, 3, 1, 1, (2, 2, "max"), None, "CHWN",
     "CHWN", 0),
    (32, 3, 32, 64, 64, 3, 1, 1, 3, 1, 1, (2, 2, "max"), None, "CHWN",
     "CHWN", 0),
    (6, 3, 11, 10, 7, 3, 2, 1, 3, 1, 1, None, "CHWN", "NCHW", "NCHW", 0),
    (8, 16, 13, 32, 40, 3, 1, 1, 3, 1, 1, (3, 2, "max"), "NCHW", "CHWN",
     "CHWN", 1),
]
K5B_CASES = [
    (4, 16, 16, 32, 32, 3, 1, 1, 3, 1, 1, None, "NCHW", "NCHW", "NCHW", 0),
    (2, 8, 12, 16, 24, 3, 1, 1, 3, 1, 1, (2, 2, "max"), None, "NCHW",
     "NCHW", 0),
    (3, 5, 13, 12, 9, 3, 1, 1, 3, 1, 1, (2, 2, "avg"), None, "NCHW", "NCHW",
     0),
    (4, 8, 10, 16, 8, 3, 2, 1, 3, 1, 1, None, "CHWN", "CHWN", "CHWN", 0),
    (2, 16, 16, 32, 16, 3, 1, 1, 3, 1, 1, None, None, "NCHW", "NCHW", 1),
]
CASES = ([("CHWN", c) for c in K5A_CASES]
         + [("NCHW", c) for c in K5B_CASES])
# the int8->bf16 kernels' copy paths at their edges
EDGE_CASES = [
    ("NCHW", (2, 16, 55, 16, 16, 3, 1, 1, 3, 1, 1, None, "NCHW", "NCHW",
              "NCHW", 0)),
    ("NCHW", (3, 8, 13, 16, 8, 3, 1, 1, 3, 1, 1, (2, 2, "max"), None,
              "NCHW", "NCHW", 0)),
    ("NCHW", (4, 16, 7, 24, 16, 3, 1, 1, 3, 1, 1, None, None, "NCHW",
              "NCHW", 0)),
    ("NCHW", (2, 20, 16, 16, 16, 3, 1, 0, 3, 1, 1, None, None, "NCHW",
              "NCHW", 0)),
    ("NCHW", (2, 16, 20, 16, 16, 5, 1, 2, 3, 1, 1, None, None, "NCHW",
              "NCHW", 0)),
    ("NCHW", (2, 16, 32, 32, 16, 3, 2, 1, 3, 1, 1, None, "NCHW", "NCHW",
              "NCHW", 0)),
    ("NCHW", (2, 16, 64, 64, 32, 3, 1, 1, 3, 1, 1, None, None, "NCHW",
              "NCHW", 0)),
    ("NCHW", (2, 16, 16, 16, 16, 3, 1, 1, 3, 1, 1, None, None, "NCHW",
              "NCHW", 1)),
    ("NCHW", (2, 16, 16, 16, 16, 3, 1, 1, 3, 1, 1, None, None, "NCHW",
              "NCHW", 2)),
    ("NCHW", (2, 16, 16, 16, 16, 3, 1, 1, 3, 1, 1, None, None, "NCHW",
              "NCHW", 4)),
    ("CHWN", (8, 3, 55, 16, 16, 3, 1, 1, 3, 1, 1, None, None, "CHWN",
              "CHWN", 0)),
    ("CHWN", (8, 8, 13, 16, 24, 3, 1, 1, 3, 1, 1, (2, 2, "max"), None,
              "CHWN", "CHWN", 0)),
    ("CHWN", (8, 8, 7, 16, 16, 3, 1, 1, 3, 1, 1, None, "CHWN", "CHWN",
              "NCHW", 0)),
    ("CHWN", (8, 8, 12, 16, 16, 3, 1, 0, 3, 1, 1, None, None, "CHWN",
              "CHWN", 0)),
    ("CHWN", (8, 8, 12, 16, 16, 5, 1, 2, 3, 1, 1, None, None, "CHWN",
              "CHWN", 0)),
    ("CHWN", (8, 8, 16, 16, 16, 3, 2, 1, 3, 1, 1, None, None, "CHWN",
              "CHWN", 0)),
    ("CHWN", (4, 8, 12, 16, 24, 3, 1, 1, 3, 1, 1, (2, 2, "max"), None,
              "CHWN", "CHWN", 0)),
    ("CHWN", (12, 8, 12, 16, 24, 3, 1, 1, 3, 1, 1, (2, 2, "max"), None,
              "CHWN", "CHWN", 0)),
    ("CHWN", (8, 8, 12, 16, 24, 3, 1, 1, 3, 1, 1, None, None, "NCHW",
              "CHWN", 0)),
    ("CHWN", (8, 8, 12, 16, 16, 3, 1, 1, 3, 1, 1, None, None, "CHWN",
              "CHWN", 1)),
    ("CHWN", (8, 8, 12, 16, 16, 3, 1, 1, 3, 1, 1, None, None, "CHWN",
              "CHWN", 2)),
    ("CHWN", (8, 8, 12, 16, 16, 3, 1, 1, 3, 1, 1, None, None, "CHWN",
              "CHWN", 4)),
    ("CHWN", (8, 4, 10, 160, 192, 3, 1, 1, 3, 1, 1, None, None, "CHWN",
              "CHWN", 0)),
]


@pytest.fixture
def card():
    reason = _build.toolchain_missing()
    if reason:
        pytest.skip(reason)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(engine, case, wdt, dev, seed=0):
    (N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, rlay, src, dst,
     offset) = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    Ho2 = conv_out_hw(conv_out_hw(H, F1, S1, P1), F2, S2, P2)
    q, scale = quantize(torch.randn(N, Ci, H, H, device=dev, generator=gen),
                        1)
    w1 = fold_scale_into_weights(
        torch.randn(Cm, Ci, F1, F1, device=dev, generator=gen)
        / math.sqrt(Ci * F1 * F1), scale).to(wdt)
    w2 = (torch.randn(Co, Cm, F2, F2, device=dev, generator=gen)
          / math.sqrt(Cm * F2 * F2)).to(wdt)
    b1 = torch.randn(Cm, device=dev, generator=gen).to(wdt)
    b2 = torch.randn(Co, device=dev, generator=gen).to(wdt)
    res = (torch.randn(N, Co, Ho2, Ho2, device=dev, generator=gen).to(wdt)
           .permute(perm_between("NCHW", rlay)).contiguous()
           if rlay else None)
    x = q.permute(perm_between("NCHW", src)).contiguous()
    if offset:   # the same values one byte past an aligned base
        base = torch.empty(x.numel() + offset, device=dev, dtype=torch.int8)
        base[offset:].copy_(x.reshape(-1))
        x = base[offset:].view(x.shape)
    kw = dict(bias1=b1, bias2=b2, relu1=True, relu2=True, pool=pool,
              res=res, res_layout=rlay or engine, src_layout=src,
              dst_layout=dst)
    wk = ((w1.permute(1, 2, 3, 0).contiguous(),
           w2.permute(1, 2, 3, 0).contiguous()) if engine == "CHWN"
          else (w1, w2))
    return x, w1, w2, wk, (S1, P1, S2, P2), kw


def _wrapper(engine):
    return (conv_ops.conv_stack_chwn if engine == "CHWN"
            else conv_ops.conv_stack_nchw)


def _check(variant, y, x, w1, w2, args, kw):
    if variant == "i8f32":
        want = conv_stack_ref(x, w1, w2, *args, **kw)
        torch.testing.assert_close(y, want, rtol=CONV_RTOL, atol=CONV_ATOL)
        k64 = {**kw, "bias1": kw["bias1"].double(),
               "bias2": kw["bias2"].double(),
               "res": None if kw["res"] is None else kw["res"].double()}
        want64 = conv_stack_ref(x, w1.double(), w2.double(), *args, **k64)
        err = ((y.double() - want64).abs().max()
               / max(1.0, want64.abs().max().item())).item()
        assert err <= TC_FP32_TOL, err
    else:
        want = conv_stack_ref(x, w1, w2, *args, **kw).double()
        got = y.double()
        bound = BF16_STEP * want.abs() + 1e-5 * want.abs().max()
        assert ((got - want).abs() <= bound).all(), \
            ((got - want).abs() - bound).max().item()


@pytest.mark.parametrize("variant", ["i8f32", "i8bf16"])
@pytest.mark.parametrize("engine,case", CASES,
                         ids=[f"{e}-{i}" for i, (e, _) in enumerate(CASES)])
def test_int8_stack_matches_plain_version(card, variant, engine, case):
    wdt = WDT[variant]
    x, w1, w2, wk, args, kw = _inputs(engine, case, wdt, card)
    assert x.dtype == torch.int8
    wrapper = _wrapper(engine)
    before = wrapper.variant_launches[variant]
    y = wrapper(x, *wk, *args, **kw)
    torch.cuda.synchronize()
    assert wrapper.variant_launches[variant] == before + 1
    assert y.dtype == wdt
    _check(variant, y, x, w1, w2, args, kw)
    for _ in range(2):
        assert torch.equal(wrapper(x, *wk, *args, **kw), y)


@pytest.mark.parametrize("variant", ["i8f32", "i8bf16"])
@pytest.mark.parametrize("engine", ["CHWN", "NCHW"])
def test_int8_stack_counts_the_tilings_work(card, variant, engine):
    case = (K5A_CASES if engine == "CHWN" else K5B_CASES)[0]
    x, w1, w2, wk, args, kw = _inputs(engine, case, WDT[variant], card)
    (N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool) = case[:12]
    t = conv_ops.stack_tiling(engine, N, Ci, H, H, Cm, F1, S1, P1, Co, F2,
                              S2, P2, pool)
    if engine == "CHWN":
        y, flops, cluster = conv_ops.conv_stack_chwn_counted(
            x, *wk, *args, **kw)
        assert (flops, cluster) == (t.executed_flops, t.cluster)
        assert conv_ops.stack_max_clusters(
            N, Ci, H, H, Cm, F1, S1, P1, Co, F2, S2, P2, pool, t,
            dtype=torch.int8, w_dtype=WDT[variant]) > 0
    else:
        y, flops = conv_ops.conv_stack_nchw_counted(x, *wk, *args, **kw)
        assert flops == t.executed_flops
    _check(variant, y, x, w1, w2, args, kw)


@pytest.mark.parametrize("engine,case", EDGE_CASES,
                         ids=[f"{e}-{i}" for i, (e, _) in
                              enumerate(EDGE_CASES)])
def test_i8bf16_copy_path_edges(card, engine, case):
    x, w1, w2, wk, args, kw = _inputs(engine, case, torch.bfloat16, card)
    (N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool) = case[:12]
    t = conv_ops.stack_tiling(engine, N, Ci, H, H, Cm, F1, S1, P1, Co, F2,
                              S2, P2, pool)
    wrapper = _wrapper(engine)
    if engine == "CHWN":
        y, flops, cluster = conv_ops.conv_stack_chwn_counted(
            x, *wk, *args, **kw)
        assert (flops, cluster) == (t.executed_flops, t.cluster)
    else:
        y, flops = conv_ops.conv_stack_nchw_counted(x, *wk, *args, **kw)
        assert flops == t.executed_flops
        # the int8 kernel's consumers are the twin's: the same sums
        assert torch.equal(wrapper(x.to(torch.bfloat16), *wk, *args, **kw),
                           y)
    torch.cuda.synchronize()
    _check("i8bf16", y, x, w1, w2, args, kw)
    for _ in range(2):
        assert torch.equal(wrapper(x, *wk, *args, **kw), y)


@pytest.mark.parametrize("engine,case", EDGE_CASES,
                         ids=[f"{e}-{i}" for i, (e, _) in
                              enumerate(EDGE_CASES)])
def test_i8f32_copy_path_edges(card, engine, case):
    """The int8->fp32 kernels' copy paths at the same edges: K5b's x by 4-,
    8- or 16-byte chunks (or element loads), K5a's runs of 8 images (or
    element loads), each within 1e-5 of float64, bitwise repeats, the
    counted FLOPs."""
    x, w1, w2, wk, args, kw = _inputs(engine, case, torch.float32, card)
    (N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool) = case[:12]
    t = conv_ops.stack_tiling(engine, N, Ci, H, H, Cm, F1, S1, P1, Co, F2,
                              S2, P2, pool)
    wrapper = _wrapper(engine)
    if engine == "CHWN":
        y, flops, cluster = conv_ops.conv_stack_chwn_counted(
            x, *wk, *args, **kw)
        assert (flops, cluster) == (t.executed_flops, t.cluster)
    else:
        y, flops = conv_ops.conv_stack_nchw_counted(x, *wk, *args, **kw)
        assert flops == t.executed_flops
    torch.cuda.synchronize()
    assert y.dtype == torch.float32
    _check("i8f32", y, x, w1, w2, args, kw)
    for _ in range(2):
        assert torch.equal(wrapper(x, *wk, *args, **kw), y)


@pytest.mark.parametrize("case", [c for e, c in EDGE_CASES if e == "NCHW"]
                         + K5B_CASES)
def test_k5b_i8f32_is_its_twin_bit_for_bit(card, case):
    """K5b int8->fp32's consumers are its float32 twin's: on x widened
    beforehand the twin gives the same bits (the product of x's small
    part, zero for int8, is left out without changing a sum)."""
    x, _, _, wk, args, kw = _inputs("NCHW", case, torch.float32, card)
    y = conv_ops.conv_stack_nchw(x, *wk, *args, **kw)
    assert torch.equal(conv_ops.conv_stack_nchw(x.float(), *wk, *args, **kw),
                       y)


def test_a_refused_int8_stack_launch_raises(card, monkeypatch):
    x, _, _, wk, args, kw = _inputs("NCHW", K5B_CASES[0], torch.bfloat16,
                                    card)
    _build.library("i8bf16")          # the error text comes from a library
    monkeypatch.setattr(_build, "entry", lambda name, variant="": (
        lambda *a: 1))                 # cudaErrorInvalidValue
    with pytest.raises(_build.KernelLaunchError, match="conv_stack_nchw"):
        conv_ops.conv_stack_nchw(x, *wk, *args, **kw)


def test_an_int8_stack_that_does_not_build_raises(card, monkeypatch,
                                                  tmp_path):
    x, _, _, wk, args, kw = _inputs("CHWN", K5A_CASES[0], torch.float32,
                                    card)
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_entries", {})
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)

    def no_nvcc():
        raise _build.KernelBuildError("nvcc removed for this test")

    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    with pytest.raises(_build.KernelBuildError):
        conv_ops.conv_stack_chwn(x, *wk, *args, **kw)


def test_int8_stack_refuses_other_pairs(card):
    x, _, _, (w1, w2), args, kw = _inputs("CHWN", K5A_CASES[0],
                                          torch.float32, card)
    with pytest.raises(TypeError, match="conv_stack_chwn"):
        conv_ops.conv_stack_chwn(x, w1.to(torch.int8), w2, *args, **kw)
    with pytest.raises(TypeError, match="bias1"):
        conv_ops.conv_stack_chwn(
            x, w1, w2, *args, **{**kw, "bias1": kw["bias1"].bfloat16()})
