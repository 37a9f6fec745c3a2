"""K5b (the NCHW conv -> conv stack) and K10 (the tiled matmul) on the
tensor cores, checked on the CPU.

- Their fp32 arithmetic, 3xTF32 with a flush every 32 reduction terms
  (``repro_torch.kernels.tf32``), in the order the kernels reduce: K5b
  steps (8 channels) x (one tap) and flushes every 4 taps of an 8-channel
  group, K10 walks 32-deep slices of each split of K and adds the splits in
  order.  Over their longest main-path reductions (K5b's conv1 and conv2 at
  256 x 9 = 2304, K10's CV12 at 4608) and through a whole stack (conv1,
  bias, ReLU, conv2 on the fp32 mid), within 1e-5 scale-relative to float64
  (the kernels' accuracy gate), where one TF32 product a term misses it.
- K5b's block tile ``stack_tiling("NCHW", ...)``: a block-by-block recount
  of what the kernel executes (its FLOPs, its blocks), that every conv2
  output (pooled output, with a pool) has exactly one owner block per slice
  of Co, that the tile's shared memory fits and its columns fit the tile,
  on every NCHW stack of the packaged plans and every NCHW stack case of
  the card tests; the tile of least modeled time picked; VGG16's and
  ResNet-18's stacks from batch 32 up within 1.25x their direct FLOPs.
- K10's ``matmul_tiling``: every output tile covered once, K cut into
  contiguous non-empty splits in order, the waves priced, on the Table-1
  layers and the card tests' shapes.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from repro_torch.cnn.layers import layer_shapes, resolved_cfg_inputs
from repro_torch.cnn.network import input_shape
from repro_torch.configs import cnn_networks as port_networks
from repro_torch.configs.paper_table1 import CONV_LAYERS
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.kernels.matmul.ops import TILES, matmul_tiling
from repro_torch.kernels.tf32 import gemm_emulated
from repro_torch.serve.plan_cache import PlanCache, packaged_plans
from repro_torch.shapes import conv_out_hw, pool_out_hw
from tests.test_torch_kernels_card import K5B_CASES, STACK_CASES
from tests.test_torch_lm_kernels_card import MATMUL_SHAPES, SPLIT_K_SHAPES

TC_TOL = 1e-5        # scale-relative to float64
SMS = 132


def _scaled_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.double() - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


# -- the arithmetic ---------------------------------------------------------

def _k5b_order(C: int, F: int):
    """The reduction index k = (c, dy, dx) over C x F x F in the order K5b
    reduces it, -1 for a zero term: per 8-channel group, chains of 4 taps
    (an mma k is a channel, its tap fixed), each padded to 32 terms so that
    a 32-term slice of the emulation is one chain of the kernel."""
    FF, order = F * F, []
    for o in range(-(-C // 8)):
        for r0 in range(0, FF, 4):
            chain = [(o * 8 + c) * FF + r if o * 8 + c < C else -1
                     for r in range(r0, min(r0 + 4, FF)) for c in range(8)]
            order += chain + [-1] * (32 - len(chain))
    return torch.tensor(order)


def _k5b_gemm(w: torch.Tensor, p: torch.Tensor, C: int, Fs: int,
              split: bool) -> torch.Tensor:
    """w [M, C*F*F] @ p [C*F*F, P] as K5b forms it."""
    idx = _k5b_order(C, Fs)
    keep = (idx >= 0).float()
    wk = w[:, idx.clamp(min=0)] * keep
    pk = p[idx.clamp(min=0), :] * keep[:, None]
    return gemm_emulated(wk, pk, split=split)


@pytest.mark.parametrize("what,C,Cout",
                         [("conv1-vgg16-conv3_2-width", 256, 64),
                          ("conv2-vgg16-conv3_2", 256, 256)],
                         ids=["conv1", "conv2"])
def test_k5b_3xtf32_holds_1e5_and_one_pass_tf32_does_not(what, C, Cout):
    """out[m, col] = sum_k w[m, k] P[k, col] over K = C x 3 x 3 = 2304, as
    K5b's phases form it: weights at the networks' He scale, activations
    of unit scale."""
    rng = np.random.default_rng(C + Cout)
    K = C * 9
    w = torch.from_numpy(rng.standard_normal((Cout, K), np.float32)
                         * np.float32(np.sqrt(2.0 / K)))
    p = torch.from_numpy(rng.standard_normal((K, 192), np.float32))
    want = w.double() @ p.double()
    err3 = _scaled_err(_k5b_gemm(w, p, C, 3, True), want)
    err1 = _scaled_err(_k5b_gemm(w, p, C, 3, False), want)
    assert err3 <= TC_TOL, (what, err3)
    assert err1 > TC_TOL, (what, err1)


def test_k5b_whole_stack_keeps_the_mid_in_fp32_accuracy():
    """conv1 (+bias, ReLU) into an fp32 mid, then conv2 on it, both as K5b
    forms them, against the same stack in float64: Ci = Cm = 256, so both
    reductions are 2304 deep (VGG16 conv3_1 -> conv3_2's conv2)."""
    rng = np.random.default_rng(7)
    N, Ci, Cm, Co, H = 1, 256, 256, 32, 8
    x = torch.from_numpy(rng.standard_normal((N, Ci, H, H), np.float32))
    w1 = torch.from_numpy(rng.standard_normal((Cm, Ci, 3, 3), np.float32)
                          * np.float32(np.sqrt(2.0 / (Ci * 9))))
    b1 = torch.from_numpy(rng.standard_normal(Cm, np.float32) * 0.1)
    w2 = torch.from_numpy(rng.standard_normal((Co, Cm, 3, 3), np.float32)
                          * np.float32(np.sqrt(2.0 / (Cm * 9))))

    def stack(split):
        p1 = F.unfold(x, 3, padding=1)[0]                     # [Ci*9, H*H]
        mid = _k5b_gemm(w1.reshape(Cm, -1), p1, Ci, 3, split)
        mid = torch.relu(mid + b1[:, None]).reshape(1, Cm, H, H)
        p2 = F.unfold(mid, 3, padding=1)[0]
        return _k5b_gemm(w2.reshape(Co, -1), p2, Cm, 3, split)

    mid64 = torch.relu(F.conv2d(x.double(), w1.double(), b1.double(),
                                padding=1))
    want = F.conv2d(mid64, w2.double(), padding=1).reshape(Co, -1)
    assert _scaled_err(stack(True), want) <= TC_TOL
    assert _scaled_err(stack(False), want) > TC_TOL


def _k10_gemm(x: torch.Tensor, y: torch.Tensor, k_per_split: int,
              split: bool = True) -> torch.Tensor:
    """x @ y as K10 forms it: each split's 32-deep slices summed from zero
    and flushed, the splits' partials added in split order."""
    out = torch.zeros(x.shape[0], y.shape[1], dtype=torch.float32)
    for k0 in range(0, x.shape[1], k_per_split):
        out = out + gemm_emulated(x[:, k0:k0 + k_per_split],
                                  y[k0:k0 + k_per_split], split=split)
    return out


def test_k10_cv12_with_its_split_k_holds_1e5():
    """Table 1's CV12 (VGG16 conv5: the patch matrix [4608, 4608] @ [4608,
    512], K = 512 x 3 x 3) at the tile and split ``matmul_tiling`` picks,
    on a 96 x 80 corner of the product."""
    layer = next(c for c in CONV_LAYERS if c.name == "CV12")
    Ho = layer.out_hw
    M, K, N = layer.N * Ho * Ho, layer.Ci * layer.F ** 2, layer.Co
    t = matmul_tiling(M, N, K)
    assert t.splits > 1
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((96, K), np.float32))
    y = torch.from_numpy(rng.standard_normal((K, 80), np.float32)
                         * np.float32(np.sqrt(2.0 / K)))
    want = x.double() @ y.double()
    assert _scaled_err(_k10_gemm(x, y, t.k_per_split), want) <= TC_TOL
    assert _scaled_err(_k10_gemm(x, y, t.k_per_split, split=False),
                       want) > TC_TOL


# -- K5b's tile ---------------------------------------------------------------

def _packaged_nchw_stacks():
    """(network, bucket, stack shape) of every NCHW stack in the packaged
    stack="auto" plans, at every bucket the files hold."""
    out = []
    for network in ("vgg16", "resnet18", "alexnet"):
        cache = PlanCache(str(packaged_plans(network)))
        b = cache.min_bucket
        while b <= cache.max_bucket:
            cfg = port_networks.CNN_CONFIGS[network].replace(batch=b)
            plan = cache.peek_fused(cfg, b, stack="auto")
            if plan is not None:
                shapes, rins = layer_shapes(cfg), resolved_cfg_inputs(cfg)
                for op in plan.ops:
                    if op.kind != "conv" or op.stack_index is None \
                            or op.layout != "NCHW":
                        continue
                    s1 = cfg.layers[op.index]
                    s2 = cfg.layers[op.stack_index]
                    p = rins[op.index][0]
                    _, ci, h, _ = input_shape(cfg) if p < 0 else shapes[p]
                    pool = None
                    if op.pool_index is not None:
                        ps = cfg.layers[op.pool_index]
                        pool = (ps.kernel, ps.stride, ps.pool_op)
                    out.append((network, b, (
                        b, ci, h, h, s1.out_channels, s1.kernel, s1.stride,
                        s1.pad, s2.out_channels, s2.kernel, s2.stride,
                        s2.pad, pool)))
            b *= 2
    return out


def _card_nchw_stacks():
    """The NCHW stack cases of the card tests, as stack shapes."""
    out = []
    for c in STACK_CASES:
        if c[0] == "NCHW":
            N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool = c[1:13]
            out.append((N, Ci, H, H, Cm, F1, S1, P1, Co, F2, S2, P2, pool))
    for c in K5B_CASES:
        N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool = c[:12]
        out.append((N, Ci, H, H, Cm, F1, S1, P1, Co, F2, S2, P2, pool))
    return out


def _span(o0: int, on: int, S: int, P: int, F: int, M: int) -> int:
    """Mid rows (or columns) that conv2 outputs o0 .. o0 + on - 1 read
    within [0, M)."""
    rows = {o * S - P + d for o in range(o0, o0 + on) for d in range(F)}
    return sum(1 for m in rows if 0 <= m < M)


def _k5b_recount(shape, t):
    """(FLOPs, blocks) of K5b at tile ``t``, counted block by block as the
    kernel runs them: per 32-channel chunk of Cm, phase A's 32 rows x the
    clipped box's 8-position tiles x Ci (in 8-channel groups) x F1^2, and
    phase B's bm rows x the block's conv2 columns in 8-column tiles x the
    chunk's mid channels (in 8-channel groups) x F2^2.  Asserts one owner
    per output unit and Co slice, and that the conv2 outputs fit the
    tile's 16384 // bm columns."""
    N, Ci, H, W, Cm, F1, S1, P1, Co, F2, S2, P2, pool = shape
    Ho1, Wo1 = conv_out_hw(H, F1, S1, P1), conv_out_hw(W, F1, S1, P1)
    Ho2, Wo2 = conv_out_hw(Ho1, F2, S2, P2), conv_out_hw(Wo1, F2, S2, P2)
    pF, pS = (pool[0], pool[1]) if pool else (0, 0)
    UH, UW = ((pool_out_hw(Ho2, pF, pS), pool_out_hw(Wo2, pF, pS)) if pool
              else (Ho2, Wo2))
    owners = np.zeros((-(-Co // t.bm), N, UH, UW), np.int64)
    flops = blocks = 0
    for ct in range(owners.shape[0]):
        for n0 in range(0, N, t.nb):
            for uh0 in range(0, UH, t.uth):
                for uw0 in range(0, UW, t.utw):
                    blocks += 1
                    nbc = min(t.nb, N - n0)
                    uh, uw = min(t.uth, UH - uh0), min(t.utw, UW - uw0)
                    owners[ct, n0:n0 + nbc, uh0:uh0 + uh, uw0:uw0 + uw] += 1
                    oh0, ow0 = (uh0 * pS, uw0 * pS) if pool else (uh0, uw0)
                    oh = (uh - 1) * pS + pF if pool else uh
                    ow = (uw - 1) * pS + pF if pool else uw
                    assert nbc * oh * ow <= 16384 // t.bm
                    box = (nbc * _span(oh0, oh, S2, P2, F2, Ho1)
                           * _span(ow0, ow, S2, P2, F2, Wo1))
                    for c0 in range(0, Cm, 32):
                        cm = min(32, Cm - c0)
                        for ci0 in range(0, Ci, 8):
                            flops += 2 * 32 * 8 * -(-box // 8) * 8 * F1 * F1
                        for _ in range(0, cm, 8):
                            flops += (2 * t.bm * 8 * -(-(nbc * oh * ow) // 8)
                                      * 8 * F2 * F2)
    assert (owners == 1).all()
    return flops, blocks


def _check_k5b_tiling(shape):
    t = conv_ops.stack_tiling("NCHW", *shape)
    N, Ci, H, W, Cm, F1, S1, P1, Co, F2, S2, P2, pool = shape
    pF, pS = (pool[0], pool[1]) if pool else (0, 0)
    assert t.cluster == 1 and t.bm in (64, 128, 256)
    assert t.smem_bytes <= conv_ops.SMEM_PER_BLOCK
    assert t.smem_bytes == conv_ops.k5b_layout(Ci, F1, S1, F2, S2, pF, pS,
                                               t.bm, t.nb, t.uth, t.utw)[1]
    assert (t.executed_flops, t.blocks) == _k5b_recount(shape, t)
    assert t.executed_flops >= t.direct_flops > 0
    return t


PACKAGED = _packaged_nchw_stacks()


@pytest.mark.parametrize("network,bucket,shape", PACKAGED,
                         ids=[f"{n}-b{b}-C{s[1]}-H{s[2]}-K{s[8]}"
                              for n, b, s in PACKAGED])
def test_k5b_tiling_of_every_packaged_nchw_stack(network, bucket, shape):
    t = _check_k5b_tiling(shape)
    if network != "alexnet" and bucket >= 32:
        # one Co slice holds Co (<= 256): conv1 is computed once, with its
        # halo; AlexNet's conv3 -> conv4 (Co 384, off the main path) takes
        # two slices, each recomputing conv1.  Below batch 32 the tiles
        # within 1.25x can leave SMs idle, and the pick may recompute more
        # halo to fill them (ResNet-18 b8's 128 -> 256 / 2 stack: 128
        # blocks at 1.47x against 32 at 1.20x)
        assert t.executed_flops <= 1.25 * t.direct_flops, (
            t.executed_flops / t.direct_flops)


@pytest.mark.parametrize("network,bucket,shape", PACKAGED,
                         ids=[f"{n}-b{b}-C{s[1]}-H{s[2]}-K{s[8]}"
                              for n, b, s in PACKAGED])
def test_k5b_picks_the_tile_of_least_modeled_time(network, bucket, shape):
    cands = conv_ops.k5b_tilings(*shape)
    t = conv_ops.stack_tiling("NCHW", *shape)
    modeled = dict((c, m) for m, c in cands)
    assert modeled[t] == min(m for m, _ in cands)
    assert len({c for _, c in cands}) == len(cands)


CARD = _card_nchw_stacks()


@pytest.mark.parametrize("shape", CARD, ids=str)
def test_k5b_tiling_prices_the_card_cases_exactly(shape):
    _check_k5b_tiling(shape)


def test_k5b_groups_input_channels_where_the_stage_has_room():
    """A phase-A stage holds ga 8-channel groups of Ci: VGG16 conv2_1 ->
    2_2 (Ci 64) two, conv3_1 -> 3_2 (Ci 128, the 256-row tile's larger
    slot) four; a 3-channel input one."""
    for shape, ga in [((32, 64, 112, 112, 128, 3, 1, 1, 128, 3, 1, 1,
                        (2, 2, "max")), 2),
                      ((32, 128, 56, 56, 256, 3, 1, 1, 256, 3, 1, 1, None),
                       4),
                      ((32, 3, 224, 224, 64, 3, 1, 1, 64, 3, 1, 1,
                        (2, 2, "max")), 1)]:
        t = conv_ops.stack_tiling("NCHW", *shape)
        pF, pS = (shape[12][0], shape[12][1]) if shape[12] else (0, 0)
        got, _ = conv_ops.k5b_layout(shape[1], 3, shape[6], 3, 1, pF, pS,
                                     t.bm, t.nb, t.uth, t.utw)
        assert got == ga


# -- K10's tile ---------------------------------------------------------------

def _table1_shapes():
    return [(c.N * c.out_hw ** 2, c.Ci * c.F ** 2, c.Co) for c in CONV_LAYERS]


K10_SHAPES = sorted(set(_table1_shapes() + list(MATMUL_SHAPES)
                        + list(SPLIT_K_SHAPES)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("shape", K10_SHAPES, ids=str)
def test_k10_tiling_covers_every_output_and_k_once(shape, dtype):
    M, K, N = shape
    t = matmul_tiling(M, N, K, dtype)
    assert (t.bm, t.bn) in TILES
    depth = 32 if dtype == torch.float32 else 64
    assert t.k_per_split % depth == 0 and t.k_per_split >= depth
    # the splits: contiguous, in order, none empty, K covered once
    bounds = [(s * t.k_per_split, min(K, (s + 1) * t.k_per_split))
              for s in range(t.splits)]
    assert bounds[0][0] == 0 and bounds[-1][1] == max(K, 0)
    assert all(a < b for a, b in bounds) or K == 0
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(t.splits - 1))
    # the output tiles: every element in exactly one tile per split
    rows = np.zeros(M, np.int64)
    cols = np.zeros(N, np.int64)
    for m0 in range(0, M, t.bm):
        rows[m0:m0 + t.bm] += 1
    for n0 in range(0, N, t.bn):
        cols[n0:n0 + t.bn] += 1
    assert (rows == 1).all() and (cols == 1).all()
    tiles = -(-M // t.bm) * -(-N // t.bn)
    assert t.blocks == tiles * t.splits
    assert t.waves == -(-t.blocks // SMS)


def test_k10_fills_the_card_on_the_short_grids():
    """CV12 (144 tiles of 128 x 128 on 132 SMs) and CV4 (N 64) take a split
    of K or a narrower tile, so no wave runs nearly empty."""
    for name in ("CV12", "CV4"):
        c = next(layer for layer in CONV_LAYERS if layer.name == name)
        M, K, N = c.N * c.out_hw ** 2, c.Ci * c.F ** 2, c.Co
        t = matmul_tiling(M, N, K)
        plain = -(-M // 128) * -(-N // 128)
        assert t.splits > 1 or (t.bm, t.bn) != (128, 128)
        assert t.blocks >= plain
        assert t.blocks / (t.waves * SMS) >= 0.85, (name, t)
