"""K1 (the direct CHWN conv), K5a (the CHWN conv -> conv stack) and K12
(the fused unembed + cross entropy) on the tensor cores, checked on the
CPU.

- Their fp32 arithmetic, 3xTF32 with a flush every 32 reduction terms
  (``repro_torch.kernels.tf32``), over the longest reductions they run:
  K1 within 1e-5 scale-relative to float64 (K6's ``WGRAD_TOL``, the
  accuracy gate of the kernel), where one TF32 product a term misses it;
  K12's loss within ``LM_TOL`` (1e-4 rtol and atol) of float64.
- The bf16 arithmetic of K1's and K2's narrow builds and the bf16 builds
  of K5a, K5b and K6 (``repro_torch.kernels.bf16_mma``): bf16 products
  summed in fp32 with a flush every 64 terms (K1), once a 64-channel chunk
  (K5a's conv2) or a 32-channel one (K5b's conv2), one chain over K1 (K5b's
  conv1) or over all of K (K2) hold the bf16 gate (one bf16 step,
  2^-7 |want| + 1e-5 max|want|) against float64 at the longest
  reductions; the stacks' conv2, which reads the float32 mid as three bf16
  parts, holds the gate and float32 accuracy (``MID_TOL``) at its longest
  reductions, where two parts miss float32 accuracy and a bf16-rounded mid
  misses the gate; K6's slices of 32 positions, flushed each slice and
  summed split by split, hold K6's gate (1e-5 scale-relative to float64)
  over VGG16 conv1_2's 1.6M positions.
- The narrow builds' shared memory (``k1_narrow_smem``,
  ``k2_bf16_layout``, ``k5a_bf16_ring_bytes``, ``k5b_bf16_layout``,
  ``wgrad_bf16_smem``, mirrors of their layouts) within what the tile
  models reckon (``conv_tiling``, ``k2_layout``, ``stack_tiling``,
  ``k5b_layout``, 227 KB) at every bf16 and int8-input launch of the
  smoke's bf16 serving and training plans, that the card cases of the bf16
  kernels reach each of their producers' lanes, and the H100 profile's
  plans of every network unchanged.
- K1's block tile ``conv_tiling``: a block-by-block recount of what the
  kernel computes (its conv outputs, its FLOPs, its blocks), that every
  pooled output has exactly one owner block and every conv output under a
  window exactly one ``save_act`` writer, on AlexNet's three 3/2 layers
  (which must execute at most 1.3x their direct FLOPs) and on every pooled
  case of the card tests.
"""
from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.cnn.network import plan_network_fused
from repro_torch.configs.cnn_networks import CNN_CONFIGS
from repro_torch.kernels import bf16_mma
from repro_torch.kernels.conv.backward import (dgrad_shape, wgrad_bf16_smem,
                                               wgrad_tiling)
from repro_torch.kernels.conv.ops import (SMEM_PER_BLOCK,
                                          _cluster_ring_bytes, conv_tiling,
                                          k1_narrow_smem, k2_bf16_layout,
                                          k2_bf16_xv, k2_layout,
                                          k5a_bf16_ring_bytes, k5b_bf16_layout,
                                          k5b_layout, nchw_tiling,
                                          stack_tiling)
from repro_torch.kernels.tf32 import gemm_emulated
from repro_torch.shapes import conv_out_hw, pool_out_hw
from tests.test_torch_bf16_train_card import STACK_CASES, WGRAD_SHAPES
from tests.test_torch_k2_bf16_card import K2_BF16_CASES, problem
from tests.test_torch_kernels_card import CONV_CASES

K1_TOL = 1e-5        # scale-relative to float64
LM_TOL = 1e-4        # K12 fp32 (rtol and atol)

# (what, K): the longest reductions K1 runs on the main path: VGG16's
# conv5_x forward (unfused "cuda-convnet", 512 x 3 x 3), the dgrad of its
# conv4_3 (Co x F x F = 512 x 3 x 3) and of AlexNet's conv2 (256 x 5 x 5)
K1_REDUCTIONS = [("vgg16-conv5-forward", 512 * 9),
                 ("vgg16-conv4_3-dgrad", 512 * 9),
                 ("alexnet-conv2-dgrad", 256 * 25)]


def _scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


@pytest.mark.parametrize("what,K", K1_REDUCTIONS,
                         ids=[w for w, _ in K1_REDUCTIONS])
def test_k1_3xtf32_holds_1e5_and_one_pass_tf32_does_not(what, K):
    """out[co, col] = sum_k w[k, co] P[k, col] as K1 forms it: weights at
    the networks' He scale, activations (or gradients) of unit scale."""
    rng = np.random.default_rng(K)
    w = torch.from_numpy(rng.standard_normal((64, K), np.float32)
                         * np.float32(np.sqrt(2.0 / K)))
    p = torch.from_numpy(rng.standard_normal((K, 256), np.float32))
    want = w.double() @ p.double()
    err3 = _scaled_err(gemm_emulated(w, p, split=True), want)
    err1 = _scaled_err(gemm_emulated(w, p, split=False), want)
    assert err3 <= K1_TOL, (what, err3)
    assert err1 > K1_TOL, (what, err1)


# --------------------------------------------------------------------------
# the bf16 builds' arithmetic: K1 bf16 / int8->bf16, K5a bf16
# --------------------------------------------------------------------------

BF16_STEP = 2.0 ** -7
# float32 accuracy: 16 float32 steps (2^-20) of the largest output, what
# the reference's float32 mid times bf16 w2 keeps (its own float32 product
# lies within 2.4e-7..3.4e-7 of float64 here)
MID_TOL = 2.0 ** -20
# K5a's longest conv2 reductions (Cm x F2 x F2) on the main path: VGG16's
# conv1_1 -> conv1_2 pair (64 x 3 x 3) and AlexNet's conv3 -> conv4 (384 x
# 3 x 3)
K5A_CONV2_REDUCTIONS = [("vgg16-conv1_2", 64 * 9), ("alexnet-conv4", 384 * 9)]


def _bf16_gate(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| over one bf16 step (2^-7 |want| + 1e-5
    max|want|): at most 1 within the gate."""
    bound = BF16_STEP * want.abs() + 1e-5 * want.abs().max()
    return ((got.double() - want).abs() / bound).max().item()


def _he_bf16(rng, rows: int, K: int) -> torch.Tensor:
    return bf16_mma.to_bf16(torch.from_numpy(
        rng.standard_normal((rows, K), np.float32)
        * np.float32(np.sqrt(2.0 / K))))


@pytest.mark.parametrize("what,K", K1_REDUCTIONS,
                         ids=[w for w, _ in K1_REDUCTIONS])
def test_k1_bf16_products_summed_per_slice_hold_the_bf16_gate(what, K):
    """out[co, col] = sum_k w[k, co] P[k, col] as K1's narrow builds form
    it: bf16 w at the He scale and bf16 activations, products exact, a
    flush into fp32 every 64 terms."""
    rng = np.random.default_rng(K)
    w = _he_bf16(rng, 64, K)
    p = bf16_mma.to_bf16(torch.from_numpy(
        rng.standard_normal((K, 256), np.float32)))
    want = w.double() @ p.double()
    got = bf16_mma.gemm_emulated(w, [p], bf16_mma.K1_SLICE)
    assert _bf16_gate(got, want) <= 1.0, what
    assert _scaled_err(got, want) <= K1_TOL, what


@pytest.mark.parametrize("what,K", K5A_CONV2_REDUCTIONS,
                         ids=[w for w, _ in K5A_CONV2_REDUCTIONS])
def test_k5a_conv2_three_part_mid_holds_float32_and_fewer_parts_do_not(
        what, K):
    """K5a's conv2 of a float32 mid (a ReLU output, unit scale) by bf16 w2
    at the He scale, against float64 of the same values.  Three bf16 parts
    (the kernel's split) give the mid exactly: within the bf16 gate and
    float32 accuracy.  Two parts leave up to 2^-16 of each value: within
    the bf16 gate here (about a fifth of it), but not float32 accuracy, so
    not the reference's function.  One part (the mid rounded to bf16)
    misses the gate."""
    rng = np.random.default_rng(K)
    w2 = _he_bf16(rng, 64, K)
    mid = torch.from_numpy(np.maximum(
        rng.standard_normal((K, 512), np.float32), np.float32(0)))
    want = w2.double() @ mid.double()
    three = bf16_mma.conv2_emulated(w2, mid, 3, parts=3)
    assert _bf16_gate(three, want) <= 1.0, what
    assert _scaled_err(three, want) <= MID_TOL, what
    assert _scaled_err(bf16_mma.conv2_emulated(w2, mid, 3, parts=2),
                       want) > MID_TOL, what
    assert _bf16_gate(bf16_mma.conv2_emulated(w2, mid, 3, parts=1),
                      want) > 1.0, what


# K5b's longest reductions on the main path: ResNet-18's layer4 (512 x 3 x
# 3, conv1 and conv2 alike) and the stacks it runs (layer1, 64 x 3 x 3)
K5B_REDUCTIONS = [("resnet18-layer1", 64 * 9), ("resnet18-layer4", 512 * 9)]


@pytest.mark.parametrize("what,K", K5B_REDUCTIONS,
                         ids=[w for w, _ in K5B_REDUCTIONS])
def test_k5b_bf16_conv1_one_chain_a_pass_holds_the_bf16_gate(what, K):
    """K5b bf16's conv1: bf16 w1 at the He scale by bf16 activations,
    products exact, summed in fp32 in ONE chain over all of K1 (a pass
    never flushes), against float64."""
    rng = np.random.default_rng(K + 1)
    w1 = _he_bf16(rng, 32, K)
    x = bf16_mma.to_bf16(torch.from_numpy(
        rng.standard_normal((K, 256), np.float32)))
    want = w1.double() @ x.double()
    got = bf16_mma.gemm_emulated(w1, [x], K)
    assert _bf16_gate(got, want) <= 1.0, what
    assert _scaled_err(got, want) <= K1_TOL, what


@pytest.mark.parametrize("what,K", K5B_REDUCTIONS,
                         ids=[w for w, _ in K5B_REDUCTIONS])
def test_k5b_bf16_conv2_three_part_mid_in_32_channel_chunks(what, K):
    """K5b bf16's conv2: the float32 mid (a ReLU output) as three bf16
    parts by bf16 w2, one chain a chunk of 32 mid channels (288 terms of
    a 3 x 3 conv2, three products each), the chunks added in fp32: within
    the bf16 gate and float32 accuracy of float64."""
    rng = np.random.default_rng(K + 2)
    w2 = _he_bf16(rng, 64, K)
    mid = torch.from_numpy(np.maximum(
        rng.standard_normal((K, 512), np.float32), np.float32(0)))
    want = w2.double() @ mid.double()
    got = bf16_mma.conv2_emulated(w2, mid, 3, parts=3,
                                  chunk=bf16_mma.K5B_CHUNK)
    assert _bf16_gate(got, want) <= 1.0, what
    assert _scaled_err(got, want) <= MID_TOL, what


# K2 bf16's reductions on the main path: the calibration case (Fig. 4's
# 256 x 3 x 3), ResNet-18's layer4 (512 x 3 x 3, forward and dgrad) and its
# thin 7x7 first layer (3 x 7 x 7: one stage's k list)
K2_REDUCTIONS = [("calibration", 256 * 9), ("resnet18-layer4", 512 * 9),
                 ("resnet18-conv1-thin", 3 * 7 * 7)]


@pytest.mark.parametrize("what,K", K2_REDUCTIONS,
                         ids=[w for w, _ in K2_REDUCTIONS])
def test_k2_bf16_one_chain_over_k_holds_the_bf16_gate(what, K):
    """K2 bf16: bf16 w at the He scale by bf16 activations (int8 levels
    are exact in bf16 too), products exact, summed in fp32 in ONE chain
    over all of K (the kernel never flushes), against float64."""
    rng = np.random.default_rng(K + 3)
    w = _he_bf16(rng, 64, K)
    x = bf16_mma.to_bf16(torch.from_numpy(
        rng.standard_normal((K, 256), np.float32)))
    want = w.double() @ x.double()
    got = bf16_mma.gemm_emulated(w, [x], K)
    assert _bf16_gate(got, want) <= 1.0, what
    assert _scaled_err(got, want) <= K1_TOL, what


WGRAD_TOL = 1e-5     # K6's gate, scale-relative to float64


def test_k6_bf16_slices_hold_its_gate_over_vgg16_conv1_2():
    """K6 bf16 at VGG16 conv1_2's 32 x 224 x 224 output positions (its
    longest reduction): bf16 g and x of unit scale, as the smoke draws
    them, one bf16 product a term, each 32-position slice summed from zero
    and added to its split's fp32 total, the splits of ``wgrad_tiling``
    added in order; within 1e-5 scale-relative of float64."""
    P = 32 * 224 * 224
    t = wgrad_tiling(64, 64 * 9, P)
    assert t.splits > 1
    rng = np.random.default_rng(7)
    g = bf16_mma.to_bf16(torch.from_numpy(
        rng.standard_normal((4, P), np.float32)))
    x = bf16_mma.to_bf16(torch.from_numpy(
        rng.standard_normal((P, 8), np.float32)))
    want = g.double() @ x.double()
    got = bf16_mma.wgrad_emulated(g, x, t.per)
    assert _scaled_err(got, want) <= WGRAD_TOL


def test_mid_parts_sum_to_the_float32_value_exactly():
    rng = np.random.default_rng(0)
    m = torch.from_numpy(rng.standard_normal(4096, np.float32)
                         * np.float32(2.0) ** rng.integers(-30, 30, 4096))
    hi, md, lo = bf16_mma.mid_parts(m, 3)
    for part in (hi, md, lo):
        assert torch.equal(part, bf16_mma.to_bf16(part))
    assert torch.equal((hi.double() + md.double() + lo.double()).float(), m)
    assert torch.equal(hi + md + lo, m)


# --------------------------------------------------------------------------
# the narrow builds' shared memory against the tile models
# --------------------------------------------------------------------------

def _narrow_launches():
    """(kernel, case) of every bf16 and int8->bf16 K1 and K5a launch of the
    smoke's bf16 serving plans and bf16 training steps, planned on the
    CPU as the smoke plans them (each distinct one once)."""
    out = []
    for network, bucket, policy, stack in chip_smoke.DTYPE_SERVED:
        cfg, plan = chip_smoke.dtype_plan(network, bucket, policy, stack)
        out += chip_smoke.fused_launches(cfg, plan)
    for network, batch, profile in chip_smoke.BF16_TRAINED:
        cfg, plan = chip_smoke.bf16_train_plan(network, batch, profile)
        out += chip_smoke.plan_train_launches(cfg, plan)
    narrow = ("conv_chwn.bf16", "conv_chwn.i8bf16", "conv_nchw.bf16",
              "conv_stack_chwn.bf16", "conv_stack_nchw.bf16", "wgrad.bf16")
    return sorted({(k, c) for k, c in out if k in narrow}, key=repr)


def _k1_shape(case):
    """(N, Ci, H, Co, F, S, pad, pool) of K1's launch for a smoke case:
    the forward's, or the stride-1 conv a dgrad poses."""
    if case[0] == "dgrad":
        N, Ci, H, Co, F, S, pad = case[1:8]
        N, Ci, H, _, Co, F, S, pad = dgrad_shape(N, Ci, H, H, Co, F, S, pad)
        return N, Ci, H, Co, F, S, pad, None
    return case[case[0] == "save_act":][:8]


def test_narrow_builds_fit_the_tile_models_at_every_main_path_launch():
    launches = _narrow_launches()
    kinds = {k for k, _ in launches}
    assert kinds == {"conv_chwn.bf16", "conv_chwn.i8bf16", "conv_nchw.bf16",
                     "conv_stack_chwn.bf16", "conv_stack_nchw.bf16",
                     "wgrad.bf16"}
    assert any(c[0] == "dgrad" for k, c in launches)
    assert any(c[0] == "save_act" for k, c in launches)
    for kern, case in launches:
        if kern == "conv_stack_chwn.bf16":
            N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool = case[:12]
            t = stack_tiling("CHWN", N, Ci, H, H, Cm, F1, S1, P1, Co, F2,
                             S2, P2, pool)
            # the bf16 rings lie inside the float32 ring, so the slab (and
            # the block's shared memory) is where stack_tiling puts it
            assert k5a_bf16_ring_bytes(t.bm) <= _cluster_ring_bytes(t.bm),                 case
            assert t.smem_bytes <= SMEM_PER_BLOCK, case
            continue
        if kern == "conv_stack_nchw.bf16":
            N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool = case[:12]
            t = stack_tiling("NCHW", N, Ci, H, H, Cm, F1, S1, P1, Co, F2,
                             S2, P2, pool)
            pF, pS = (pool[0], pool[1]) if pool else (0, 0)
            tile = (F2, S2, pF, pS, t.bm, t.nb, t.uth, t.utw)
            # 16-channel bf16 stages inside the float32 layout's slot: the
            # block's shared memory is k5b_layout's, which the tiling fits
            _, stage_a, stage_b, slot, _ = k5b_bf16_layout(Ci, F1, S1, *tile)
            assert max(stage_a, stage_b) <= slot, case
            assert k5b_layout(Ci, F1, S1, *tile)[1] == t.smem_bytes, case
            assert t.smem_bytes <= SMEM_PER_BLOCK, case
            continue
        if kern == "conv_nchw.bf16":
            N, Ci, H, Co, F, S, pad, pool = _k1_shape(case)
            src = case[-2]      # x's layout (a dgrad's: g's)
            t = nchw_tiling(N, Ci, H, H, Co, F, S, pad, pool)
            pF, pS = (pool[0], pool[1]) if pool else (0, 0)
            tile = (Ci, F, S, pF, pS, t.bm, t.nb, t.uth, t.utw, t.tr, t.ga)
            # 16-channel bf16 stages inside the float32 layout's bytes
            _, nbytes = k2_bf16_layout(
                *tile, xv=k2_bf16_xv(torch.bfloat16, src, H))
            assert k2_layout(*tile) == t.smem_bytes, case
            assert nbytes <= t.smem_bytes <= SMEM_PER_BLOCK, case
            continue
        if kern == "wgrad.bf16":
            N, Ci, H, Co, F, S, pad = case[:7]
            Ho = conv_out_hw(H, F, S, pad)
            t = wgrad_tiling(Co, Ci * F * F, N * Ho * Ho)
            assert wgrad_bf16_smem(t.bm, t.bn) <= SMEM_PER_BLOCK, case
            continue
        N, Ci, H, Co, F, S, pad, pool = _k1_shape(case)
        t = conv_tiling(N, Ci, H, H, Co, F, S, pad, pool)
        cmax = 0
        if pool is not None:
            Ho = conv_out_hw(H, F, S, pad)
            UH = pool_out_hw(Ho, pool[0], pool[1])
            cmax = min(t.nb, N) * ((min(t.ph, UH) - 1) * pool[1]
                                   + pool[0]) * ((min(t.pw, UH) - 1)
                                                 * pool[1] + pool[0])
        assert k1_narrow_smem(t.bm, cmax) <= t.smem_bytes, (kern, case)
        # unpooled sums are staged over the ring: bm rows of 128 + 8 floats
        assert 4 * t.bm * (128 + 8) <= k1_narrow_smem(t.bm, 0) - 4 * 3 * 128


def test_bf16_card_cases_reach_every_producer_lane():
    """The card tests of K5b bf16 and K6 bf16 (tests/
    test_torch_bf16_train_card.py) reach each path of the bf16 kernels'
    producers and tiles: K5b's x box by 16-byte copies (an NCHW source, W
    % 8 == 0, the 8-aligned box fitting the slot) and by halfwords, stride
    2, Ci and Cm not multiples of 16, both sources and residual layouts,
    both pools; K6 at one split and many, each block width (thin K at bn
    32 and 64), Wo 28, 14 and 7, stride 2."""
    box16 = halfwords = 0
    for (N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, rlay, src,
         _) in STACK_CASES:
        t = stack_tiling("NCHW", N, Ci, H, H, Cm, F1, S1, P1, Co, F2, S2,
                         P2, pool)
        pF, pS = (pool[0], pool[1]) if pool else (0, 0)
        box8 = k5b_bf16_layout(Ci, F1, S1, F2, S2, pF, pS, t.bm, t.nb,
                               t.uth, t.utw)[4]
        if src == "NCHW" and H % 8 == 0 and box8:
            box16 += 1
        else:
            halfwords += 1
    assert box16 and halfwords
    assert {c[6] for c in STACK_CASES} >= {1, 2}
    assert any(c[1] % 16 for c in STACK_CASES)
    assert any(c[3] % 16 for c in STACK_CASES)
    assert {c[14] for c in STACK_CASES} == {"NCHW", "CHWN"}
    assert {c[12] for c in STACK_CASES} == {None, "NCHW", "CHWN"}
    assert {c[11][2] for c in STACK_CASES if c[11]} == {"max", "avg"}
    splits, widths, wos = set(), set(), set()
    for N, Ci, H, Co, F, S, pad in WGRAD_SHAPES:
        Ho = conv_out_hw(H, F, S, pad)
        t = wgrad_tiling(Co, Ci * F * F, N * Ho * Ho)
        splits.add(t.splits > 1)
        widths.add(t.bn)
        wos.add(Ho)
    assert splits == {False, True} and widths == {32, 64, 128}
    assert wos >= {28, 14, 7}
    assert {c[5] for c in WGRAD_SHAPES} >= {1, 2}


def _k2_lane(case, x_dtype):
    """(copy lane, tiling) of K2's bf16 build for a card case."""
    N, Ci, H, W, Co, F, S, pad, pool = problem(case)
    t = nchw_tiling(N, Ci, H, W, Co, F, S, pad, pool)
    pF, pS = (pool[0], pool[1]) if pool else (0, 0)
    lane, nbytes = k2_bf16_layout(
        Ci, F, S, pF, pS, t.bm, t.nb, t.uth, t.utw, t.tr, t.ga,
        xv=k2_bf16_xv(x_dtype, case[10], W), int8_x=x_dtype == torch.int8)
    assert nbytes <= t.smem_bytes, case
    return lane, t


def test_k2_bf16_card_cases_reach_every_producer_lane():
    """The card cases of K2's bf16 builds (tests/
    test_torch_k2_bf16_card.py) reach each lane of the kernel's box copy
    (bf16: 16-, 8- and 4-byte ``cp.async`` and halfwords; int8: 8-byte
    loads widened and bytes), a CHWN source, thin inputs on two lanes, a
    1x1 conv of several 16-channel groups a stage, stages that split the
    tap rows, Ci off multiples of 16 and K off multiples of 8, stride 2,
    dgrads posed from strides 1 and 2, both pools and the residual in both
    layouts."""
    bf16 = {c[0]: _k2_lane(c, torch.bfloat16) for c in K2_BF16_CASES}
    int8 = {c[0]: _k2_lane(c, torch.int8) for c in K2_BF16_CASES}
    assert {lane for lane, _ in bf16.values()} == {8, 4, 2, 1}
    assert {lane for lane, _ in int8.values()} == {8, 1}
    cases = {c[0]: c for c in K2_BF16_CASES}
    thin = [w for w, c in cases.items() if problem(c)[1] < 8]
    assert {bf16[w][0] for w in thin} == {8, 1}
    assert any(t.ga > 1 for _, t in bf16.values())
    assert any(t.tr < problem(cases[w])[5] for w, (_, t) in bf16.items()
               if problem(cases[w])[1] >= 8)
    assert any(problem(c)[1] % 16 and problem(c)[1] * problem(c)[5] ** 2 % 8
               for c in K2_BF16_CASES)
    assert {c[10] for c in K2_BF16_CASES} == {"NCHW", "CHWN"}
    assert {c[6] for c in K2_BF16_CASES if not c[12]} >= {1, 2}
    assert {c[6] for c in K2_BF16_CASES if c[12]} == {1, 2}
    assert {c[8][2] for c in K2_BF16_CASES if c[8]} == {"max", "avg"}
    assert {c[9] for c in K2_BF16_CASES} == {None, "NCHW", "CHWN"}


# sha256 of repr(plan_network_fused(cfg, dtype=...)) on the H100 profile,
# each network at its config's batch: the kernels' narrow builds change no
# tile model, so no plan
H100_PLANS = {
    ("alexnet", "float32"): "d72a53d44275359c",
    ("alexnet", "bfloat16"): "9c99bfe7274d84ff",
    ("cifarnet", "float32"): "607a87ee371e808c",
    ("cifarnet", "bfloat16"): "e27651400ade6392",
    ("lenet", "float32"): "6ed13fca016967da",
    ("lenet", "bfloat16"): "7fae476522ed200b",
    ("resnet18", "float32"): "6ada4d74a2e8ed7b",
    ("resnet18", "bfloat16"): "22e21b5c69c63682",
    ("unet_mini", "float32"): "53be6b30e0dfbf3f",
    ("unet_mini", "bfloat16"): "c3cb062a1e04ff4e",
    ("vgg16", "float32"): "bd4ee4cba2c5f9ec",
    ("vgg16", "bfloat16"): "e2e15d8b8348c12d",
    ("zfnet", "float32"): "554753bb906356e6",
    ("zfnet", "bfloat16"): "51e3631e7f094c91",
}


@pytest.mark.parametrize("network", sorted(CNN_CONFIGS))
def test_h100_plans_of_every_network_are_unchanged(network):
    cfg = CNN_CONFIGS[network]
    for dtype in ("float32", "bfloat16"):
        plan = plan_network_fused(cfg, dtype=dtype)
        got = hashlib.sha256(repr(plan).encode()).hexdigest()[:16]
        assert got == H100_PLANS[(network, dtype)], (network, dtype)


def _loss(logits: torch.Tensor, labels: torch.Tensor, cap):
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    gold = logits.gather(1, labels[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - gold


@pytest.mark.parametrize("D,cap", [(3584, None), (4608, 30.0)],
                         ids=["qwen2_7b-D3584", "gemma2_27b-D4608-softcap"])
def test_k12_fp32_3xtf32_loss_holds_lm_tol(D, cap):
    """K12 fp32's logits h @ tableᵀ as the kernel forms them (3xTF32, a
    flush every 32 of D), then the loss in fp32, against float64 at the
    widths of qwen2-7b and gemma2-27b (h unit scale, table 0.02 as
    ``chip_smoke.py`` draws them)."""
    rng = np.random.default_rng(D)
    T, V = 32, 1024
    h = torch.from_numpy(rng.standard_normal((T, D), np.float32))
    table = torch.from_numpy(rng.standard_normal((V, D), np.float32)
                             * np.float32(0.02))
    labels = torch.from_numpy(rng.integers(0, V, T))
    logits = gemm_emulated(h, table.T)
    want_logits = h.double() @ table.double().T
    assert _scaled_err(logits, want_logits) <= K1_TOL
    torch.testing.assert_close(_loss(logits, labels, cap),
                               _loss(want_logits, labels, cap).float(),
                               rtol=LM_TOL, atol=LM_TOL)


# --------------------------------------------------------------------------
# K1's block tile
# --------------------------------------------------------------------------

# (N, Ci, H, Co, F, S, pad): AlexNet's conv1, conv2 and conv5 at batch 128,
# each followed by its 3/2 max pool
ALEXNET_POOLED = [(128, 3, 227, 96, 11, 4, 0), (128, 96, 27, 256, 5, 1, 2),
                  (128, 384, 13, 256, 3, 1, 1)]
# every pooled shape of the card tests' conv grid (its 3/2 and 2/2 draws
# and the hand-written cases), on K1's tiling whatever engine they test
GRID_POOLED = sorted({(N, Ci, H, Co, F, S, pad, pool)
                      for (_, N, Ci, H, Co, F, S, pad, pool, *_r)
                      in CONV_CASES if pool is not None},
                     key=repr)
POOLED = ([c + ((3, 2, "max"),) for c in ALEXNET_POOLED] + GRID_POOLED)


def _recount(N, Ci, H, Co, F, S, pad, pool, t):
    """Walk K1's blocks as the kernel does (``make_tile`` in
    csrc/conv_chwn.cu): blocks, executed FLOPs, owners of each pooled
    output and save_act writers of each conv output."""
    pF, pS = pool[0], pool[1]
    Ho = conv_out_hw(H, F, S, pad)
    UH = pool_out_hw(Ho, pF, pS)
    K = Ci * F * F
    owners = np.zeros((N, UH, UH), np.int64)
    writers = np.zeros((N, Ho, Ho), np.int64)
    blocks = executed = 0
    for n0 in range(0, N, t.nb):
        nbt = min(t.nb, N - n0)
        for ph0 in range(0, UH, t.ph):
            pht = min(t.ph, UH - ph0)
            rht = (pht - 1) * pS + pF
            own_h = [(rh < pht * pS or ph0 + pht == UH) and rh % pS < pF
                     for rh in range(rht)]
            for pw0 in range(0, UH, t.pw):
                pwt = min(t.pw, UH - pw0)
                rwt = (pwt - 1) * pS + pF
                own_w = [(rw < pwt * pS or pw0 + pwt == UH) and rw % pS < pF
                         for rw in range(rwt)]
                for co0 in range(0, Co, t.bm):
                    blocks += 1
                    executed += 2 * K * min(t.bm, Co - co0) * nbt * rht * rwt
                owners[n0:n0 + nbt, ph0:ph0 + pht, pw0:pw0 + pwt] += 1
                mask = np.outer(own_h, own_w).astype(np.int64)
                writers[n0:n0 + nbt, ph0 * pS:ph0 * pS + rht,
                        pw0 * pS:pw0 * pS + rwt] += mask
    return blocks, executed, owners, writers


def _pooled_id(c):
    N, Ci, H, Co, F, S, pad, pool = c
    return f"N{N}-C{Ci}-H{H}-K{Co}-F{F}-S{S}-P{pad}-{pool[2]}{pool[0]}s{pool[1]}"


@pytest.mark.parametrize("case", POOLED, ids=[_pooled_id(c) for c in POOLED])
def test_k1_pooled_tile_prices_its_blocks_and_owns_each_output_once(case):
    N, Ci, H, Co, F, S, pad, pool = case
    t = conv_tiling(N, Ci, H, H, Co, F, S, pad, pool)
    blocks, executed, owners, writers = _recount(N, Ci, H, Co, F, S, pad,
                                                 pool, t)
    assert (blocks, executed) == (t.blocks, t.executed_flops)
    assert (owners == 1).all()
    pF, pS = pool[0], pool[1]
    Ho = conv_out_hw(H, F, S, pad)
    UH = pool_out_hw(Ho, pF, pS)
    under = np.zeros(Ho, bool)
    for u in range(UH):
        under[u * pS:u * pS + pF] = True
    want = np.broadcast_to(np.outer(under, under), writers.shape)
    assert (writers == want.astype(np.int64)).all()
    assert t.smem_bytes <= SMEM_PER_BLOCK
    assert t.direct_flops == 2 * Ci * F * F * Co * N * Ho * Ho
    assert t.bm in (64, 128) and t.nb >= min(8, N)


@pytest.mark.parametrize("case", [c + ((3, 2, "max"),)
                                  for c in ALEXNET_POOLED],
                         ids=["conv1", "conv2", "conv5"])
def test_k1_alexnet_pooled_layers_execute_at_most_1p3x_direct(case):
    t = conv_tiling(case[0], case[1], case[2], case[2], *case[3:])
    assert t.executed_flops <= 1.3 * t.direct_flops


@pytest.mark.parametrize("case", [(32, 3, 224, 64, 3, 1, 1),
                                  (128, 256, 13, 384, 3, 1, 1),
                                  (32, 64, 55, 128, 1, 2, 0),
                                  (33, 5, 9, 130, 3, 2, 1)],
                         ids=lambda c: f"N{c[0]}-C{c[1]}-H{c[2]}-K{c[3]}")
def test_k1_unpooled_tile_is_128_columns_by_the_channel_tile(case):
    N, Ci, H, Co, F, S, pad = case
    t = conv_tiling(N, Ci, H, H, Co, F, S, pad)
    Ho = conv_out_hw(H, F, S, pad)
    assert t.bm == (64 if Co <= 64 else 128) and t.nb == 0
    assert t.blocks == -(-(N * Ho * Ho) // 128) * -(-Co // t.bm)
    assert t.executed_flops == t.direct_flops
