"""K1 (the direct CHWN conv) and K12 (the fused unembed + cross entropy) on
the tensor cores, checked on the CPU.

- Their fp32 arithmetic, 3xTF32 with a flush every 32 reduction terms
  (``repro_torch.kernels.tf32``), over the longest reductions they run:
  K1 within 1e-5 scale-relative to float64 (K6's ``WGRAD_TOL``, the
  accuracy gate of the kernel), where one TF32 product a term misses it;
  K12's loss within ``LM_TOL`` (1e-4 rtol and atol) of float64.
- K1's block tile ``conv_tiling``: a block-by-block recount of what the
  kernel computes (its conv outputs, its FLOPs, its blocks), that every
  pooled output has exactly one owner block and every conv output under a
  window exactly one ``save_act`` writer, on AlexNet's three 3/2 layers
  (which must execute at most 1.3x their direct FLOPs) and on every pooled
  case of the card tests.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels.conv.ops import SMEM_PER_BLOCK, conv_tiling
from repro_torch.kernels.tf32 import gemm_emulated
from repro_torch.shapes import conv_out_hw, pool_out_hw
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
