"""The tiled matmul K10, the flash attention K11 and the fused unembed +
cross entropy K12 against their plain versions, on the card.

Every test needs a CUDA device and ``nvcc`` and skips with the reason where
either is missing.  The module imports neither ``jax`` nor the reference
package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_lm_kernels_card.py

Tolerances: K10 fp32 rtol 2e-5 / atol 2e-4 (the reference's matmul test),
the matrix-expansion conv rtol 1e-4 / atol 1e-3 (its conv tolerance) and
the FFT conv rtol 1e-3 / atol 1e-2; K11 and K12 fp32 rtol / atol 1e-4
(its attention and cross-entropy tests); bf16 8 * BF16_EPS (its bf16
tests), against the plain version on the same bf16 inputs.  TF32 is off.
Each wrapper's launch count rises by one per call, so no CUDA tensor
reached a plain version.
"""
from __future__ import annotations

import math

import pytest
import torch

from repro_torch.cnn.layers import conv_forward
from repro_torch.kernels import _build, launch_counts
from repro_torch.kernels.conv.ops import conv_im2col_nchw
from repro_torch.kernels.conv.ref import conv_ref
from repro_torch.kernels.crossentropy.ops import fused_xent
from repro_torch.kernels.crossentropy.ref import xent_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.kernels.matmul.ops import matmul, matmul_tiling
from repro_torch.kernels.matmul.ref import matmul_ref

BF16_EPS = 2.0 ** -8
DTYPES = [torch.float32, torch.bfloat16]
# (M, K, N): the reference's test shapes, a 3x3 RGB conv's K = 27 and a
# deep layer's K = 4608 with ragged M and N
MATMUL_SHAPES = [(256, 256, 256), (100, 300, 50), (8, 1024, 128), (1, 7, 3),
                 (1000, 27, 64), (130, 4608, 129)]
# (M, K, N) where matmul_tiling splits K in both dtypes: Table 1's CV12, a
# CV4-like N 64, a ragged deep one
SPLIT_K_SHAPES = [(4608, 4608, 512), (4096, 2304, 64), (257, 3001, 77)]
# ragged M, N and K beside the tiles (128, 64) and the slices (32, 64)
RAGGED_SHAPES = [(1001, 33, 77), (129, 100, 65), (64, 65, 64), (300, 25, 16)]
# (Ci, H, W, N, F, Co, S, pad): the reference's CONV_CASES
CONV_CASES = [(1, 28, 28, 32, 5, 16, 1, 0), (16, 14, 14, 64, 5, 16, 1, 2),
              (3, 32, 32, 32, 3, 8, 2, 0), (8, 13, 13, 32, 3, 16, 1, 1)]
# (BH, Sq, Sk, D, causal): full and ragged tiles, Sq != Sk both ways, every
# head-dim tile (64, 128, 256) with D below it; one query row over many
# keys; D 16 and 256 on ragged tiles (the bf16 kernel's 32-key tiles at D
# 256 hold rows whose every key in the tile is masked)
ATTN_CASES = [(4, 256, 256, 64, True), (2, 128, 128, 32, False),
              (6, 512, 512, 128, True), (3, 100, 100, 64, True),
              (3, 100, 100, 64, False), (2, 64, 128, 32, True),
              (2, 130, 70, 96, True), (1, 1, 1, 16, True),
              (2, 200, 200, 200, False), (2, 96, 96, 256, True),
              (2, 1, 300, 64, False), (2, 1, 300, 128, True),
              (3, 130, 130, 16, True), (2, 150, 70, 256, False)]
# (T, V, D, softcap): the reference's cases and ragged T/V beside them
XENT_CASES = [(64, 1000, 128, None), (128, 513, 64, None),
              (32, 2000, 96, 30.0), (16, 128, 32, None), (1, 300, 48, None),
              (300, 5000, 200, 30.0)]


@pytest.fixture
def card():
    reason = _build.toolchain_missing()
    if reason:
        pytest.skip(reason)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype, fp32):
    return (8 * BF16_EPS, 8 * BF16_EPS) if dtype == torch.bfloat16 else fp32


def _counted(name, fn, n=1):
    before = launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert launch_counts()[name] == before + n
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("x_t,y_t", [(False, False), (True, False),
                                     (False, True), (True, True)])
@pytest.mark.parametrize("shape", MATMUL_SHAPES, ids=str)
def test_matmul_kernel_matches_plain(shape, x_t, y_t, dtype, card):
    M, K, N = shape
    gen = torch.Generator(device=card).manual_seed(M + K + N)
    x = torch.randn(M, K, device=card, generator=gen) / math.sqrt(K)
    y = torch.randn(K, N, device=card, generator=gen)
    # a transposed flag feeds the operand as a strided view of its transpose
    x = (x.T.contiguous().T if x_t else x).to(dtype)
    y = (y.T.contiguous().T if y_t else y).to(dtype)
    got = _counted("matmul", lambda: matmul(x, y))
    assert got.dtype == dtype and got.shape == (M, N)
    rtol, atol = _tol(dtype, (2e-5, 2e-4))
    torch.testing.assert_close(got.float(), matmul_ref(x, y).float(),
                               rtol=rtol, atol=atol)


def _f64_err(got, x, y):
    want = x.double() @ y.double()
    return ((got.double() - want).abs().max()
            / max(1.0, want.abs().max().item())).item()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", SPLIT_K_SHAPES, ids=str)
def test_matmul_split_k_holds_float64_and_two_runs_are_bitwise_equal(
        shape, dtype, card):
    """Split K, the partials added in split order by a second launch: one
    counted launch, fp32 within 1e-5 scale-relative of float64 (the 3xTF32
    gate), bf16 within 8 * BF16_EPS of the plain version, and the same bits
    on a second run."""
    M, K, N = shape
    assert matmul_tiling(M, N, K, dtype).splits > 1
    gen = torch.Generator(device=card).manual_seed(M + N)
    x = torch.randn(M, K, device=card, generator=gen).to(dtype)
    y = (torch.randn(K, N, device=card, generator=gen)
         / math.sqrt(K)).to(dtype)
    got = _counted("matmul", lambda: matmul(x, y))
    again = matmul(x, y)
    assert torch.equal(got, again)
    if dtype == torch.float32:
        assert _f64_err(got, x, y) <= 1e-5
    else:
        torch.testing.assert_close(got.float(), matmul_ref(x, y).float(),
                                   rtol=8 * BF16_EPS, atol=8 * BF16_EPS)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", RAGGED_SHAPES, ids=str)
def test_matmul_ragged_edges_and_the_weights_view(shape, dtype, card):
    """Ragged M, N and K, with y as the matrix-expansion conv passes it (a
    transposed view of [N, K] weights, K contiguous), and x strided along
    k (4-byte copies)."""
    M, K, N = shape
    gen = torch.Generator(device=card).manual_seed(M * N + K)
    x = torch.randn(M, K, device=card, generator=gen).to(dtype)
    w = (torch.randn(N, K, device=card, generator=gen)
         / math.sqrt(K)).to(dtype)
    for xx in (x, x.T.contiguous().T):
        got = _counted("matmul", lambda: matmul(xx, w.T))
        if dtype == torch.float32:
            assert _f64_err(got, xx, w.T) <= 1e-5
        torch.testing.assert_close(
            got.float(), matmul_ref(xx, w.T).float(),
            **dict(zip(("rtol", "atol"), _tol(dtype, (2e-5, 2e-4)))))


@pytest.mark.parametrize("Ci,H,W,N,F,Co,S,pad", CONV_CASES)
def test_conv_im2col_runs_its_matmul_on_the_kernel(Ci, H, W, N, F, Co, S,
                                                   pad, card):
    gen = torch.Generator(device=card).manual_seed(Ci + H)
    x = torch.randn(N, Ci, H, W, device=card, generator=gen)
    w = torch.randn(Co, Ci, F, F, device=card, generator=gen) * 0.1
    want = conv_ref(x, w, S, pad)
    got = _counted("matmul", lambda: conv_im2col_nchw(x, w, S, pad))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    plain = _counted("matmul", lambda: conv_im2col_nchw(
        x, w, S, pad, use_kernel_mm=False), n=0)
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-3)
    fft = conv_forward(x, w, "NCHW", S, pad, impl="fft")
    torch.testing.assert_close(fft, want, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_attention_kernel_matches_plain(case, dtype, card):
    BH, Sq, Sk, D, causal = case
    gen = torch.Generator(device=card).manual_seed(BH * Sq + D)
    q = torch.randn(BH, Sq, D, device=card, generator=gen).to(dtype)
    k = torch.randn(BH, Sk, D, device=card, generator=gen).to(dtype)
    v = torch.randn(BH, Sk, D, device=card, generator=gen).to(dtype)
    got = _counted("flash_attention",
                   lambda: flash_attention(q, k, v, causal=causal))
    assert got.dtype == dtype and got.shape == q.shape
    rtol, atol = _tol(dtype, (1e-4, 1e-4))
    torch.testing.assert_close(got.float(),
                               flash_attention_ref(q, k, v, causal).float(),
                               rtol=rtol, atol=atol)


def test_flash_attention_4d_and_the_library_agree(card):
    gen = torch.Generator(device=card).manual_seed(4)
    q, k, v = (torch.randn(2, 3, 128, 64, device=card, generator=gen)
               for _ in range(3))
    got = _counted("flash_attention", lambda: flash_attention(q, k, v))
    lib = torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                           is_causal=True)
    torch.testing.assert_close(got, lib, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_flash_attention_masked_keys_carry_no_weight(dtype, card):
    """Causal row r keeps keys 0..r only.  Every later key scores ~32 above
    key 0 (it would take all the weight if a mask leaked), so row 0 is
    exactly v[0] and row r the softmax over keys 0..r alone."""
    BH, S, D = 2, 80, 64
    gen = torch.Generator(device=card).manual_seed(21)
    q = torch.ones(BH, S, D, device=card)
    k = torch.randn(BH, S, D, device=card, generator=gen) * 0.1
    k[:, 1:] += 4.0                   # later keys score far higher
    v = torch.randn(BH, S, D, device=card, generator=gen)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    got = _counted("flash_attention",
                   lambda: flash_attention(q, k, v, causal=True))
    rtol, atol = _tol(dtype, (1e-4, 1e-4))
    torch.testing.assert_close(got[:, 0].float(), v[:, 0].float(),
                               rtol=rtol, atol=atol)
    torch.testing.assert_close(got.float(),
                               flash_attention_ref(q, k, v, True).float(),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_flash_attention_refused_launch_raises(dtype, card, monkeypatch):
    """Past the wrapper's head-dim check (widened here), the kernel's entry
    refuses D 300; the wrapper raises instead of returning a result, and
    counts no launch."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    monkeypatch.setattr(fa_ops, "MAX_HEAD_DIM", 512)
    q = torch.zeros(1, 8, 300, device=card, dtype=dtype)
    before = launch_counts()["flash_attention"]
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        fa_ops.flash_attention(q, q, q)
    assert launch_counts()["flash_attention"] == before


def test_flash_attention_refuses_head_dims_past_256(card):
    q = torch.zeros(1, 8, 257, device=card)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        flash_attention(*(torch.zeros(1, 8, 16, device=card,
                                      dtype=torch.float16),) * 3)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", XENT_CASES, ids=str)
def test_fused_xent_kernel_matches_plain(case, dtype, card):
    T, V, D, cap = case
    gen = torch.Generator(device=card).manual_seed(T + V + D)
    h = torch.randn(T, D, device=card, generator=gen).to(dtype)
    table = (torch.randn(V, D, device=card, generator=gen) * 0.05).to(dtype)
    labels = torch.randint(0, V, (T,), device=card, generator=gen)
    got = _counted("fused_xent", lambda: fused_xent(h, table, labels, cap))
    assert got.dtype == torch.float32 and got.shape == (T,)
    rtol, atol = _tol(dtype, (1e-4, 1e-4))
    torch.testing.assert_close(got, xent_ref(h, table, labels, cap),
                               rtol=rtol, atol=atol)


def test_fused_xent_two_runs_are_bitwise_equal(card):
    gen = torch.Generator(device=card).manual_seed(11)
    h = torch.randn(1024, 256, device=card, generator=gen)
    table = torch.randn(20000, 256, device=card, generator=gen) * 0.05
    labels = torch.randint(0, 20000, (1024,), device=card, generator=gen)
    a = _counted("fused_xent", lambda: fused_xent(h, table, labels, 30.0))
    b = _counted("fused_xent", lambda: fused_xent(h, table, labels, 30.0))
    assert torch.equal(a, b)


def test_fused_xent_labels_that_hit_no_column(card):
    gen = torch.Generator(device=card).manual_seed(12)
    h = torch.randn(6, 64, device=card, generator=gen)
    table = torch.randn(1000, 64, device=card, generator=gen) * 0.05
    labels = torch.tensor([-1, -500, 1000, 1003, 5000, 7], device=card,
                          dtype=torch.int32)
    got = _counted("fused_xent", lambda: fused_xent(h, table, labels))
    lse = torch.logsumexp(h @ table.T, -1)
    torch.testing.assert_close(got[:5], lse[:5], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got, xent_ref(h, table, labels), rtol=1e-4,
                               atol=1e-4)


# K12 on the tensor cores: (T, V, D, softcap) with T and V no multiple of
# the 128 x 128 tile (T 1, 130; V 1000, 50257) and D no multiple of a
# stage's 64 bf16 / 32 fp32 (D 72, 200)
XENT_TC_CASES = [(1, 1000, 72, None), (130, 1000, 200, 30.0),
                 (1, 50257, 200, None), (130, 50257, 72, 30.0)]


def _xent_inputs(T, V, D, dtype, card, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    h = torch.randn(T, D, device=card, generator=gen).to(dtype)
    table = (torch.randn(V, D, device=card, generator=gen) * 0.02).to(dtype)
    labels = torch.randint(0, V, (T,), device=card, generator=gen)
    return h, table, labels


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("case", XENT_TC_CASES, ids=str)
def test_fused_xent_tensor_core_tiles_match_plain_and_float64(case, dtype,
                                                              card):
    T, V, D, cap = case
    h, table, labels = _xent_inputs(T, V, D, dtype, card, T + V + D)
    got = _counted("fused_xent", lambda: fused_xent(h, table, labels, cap))
    rtol, atol = _tol(dtype, (1e-4, 1e-4))
    torch.testing.assert_close(got, xent_ref(h, table, labels, cap),
                               rtol=rtol, atol=atol)
    z = h.double() @ table.double().T          # float64 logits
    if cap is not None:
        z = cap * torch.tanh(z / cap)
    want64 = torch.logsumexp(z, -1) - z.gather(1, labels[:, None])[:, 0]
    torch.testing.assert_close(got.double(), want64, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_fused_xent_three_runs_bitwise_equal_on_the_tensor_cores(dtype,
                                                                 card):
    h, table, labels = _xent_inputs(130, 50257, 200, dtype, card, 21)
    runs = [_counted("fused_xent", lambda: fused_xent(h, table, labels, 30.0))
            for _ in range(3)]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_fused_xent_labels_outside_the_vocab_on_the_tensor_cores(dtype,
                                                                 card):
    h, table, _ = _xent_inputs(130, 1000, 72, dtype, card, 22)
    labels = torch.arange(130, device=card) * 17 - 600   # -600 .. 1593
    got = _counted("fused_xent", lambda: fused_xent(h, table, labels, 30.0))
    rtol, atol = _tol(dtype, (1e-4, 1e-4))
    torch.testing.assert_close(got, xent_ref(h, table, labels, 30.0),
                               rtol=rtol, atol=atol)
    out = (labels < 0) | (labels >= 1000)
    z = 30.0 * torch.tanh(h.float() @ table.float().T / 30.0)
    torch.testing.assert_close(got[out], torch.logsumexp(z, -1)[out],
                               rtol=rtol, atol=atol)
