"""K1's int8->fp32 build and the bf16 transposes K9a/K9b, on the CPU.

(a) The port's bf16 ``transpose2d`` and ``transpose2d_batched`` (their
plain versions on CPU tensors) against the reference's Pallas kernels in
interpret mode, on the same bf16 bits, at the bf16 kernel's edges: M of
32 and 64 (a tile takes all of it), N not a multiple of 8, N below one
tile, M past one tile.  A transpose copies bits: equality is exact.
(b) A mirror of the bf16 kernel's tile map (``transpose.ops.k9_bf16_*``),
run in Python block by block and thread by thread: every element of y
written once, with x's value; a 16-byte load or store only where the
row's length and base allow it (and then wholly inside the row); and the
shared-memory word map a bijection whose word stores and 16-byte reads
hit 32 different banks a warp (a quarter warp for the reads).
(c) K1 int8->fp32's arithmetic (``bf16_mma.k1_i8f32_emulated``: float32
w in three bf16 parts, three products a term, each k16 step a chain from
zero added to an fp32 total) on a narrow version of the calibration's
case (Fig. 4's base layer: N 8 and Co 32 of N 64 and Co 384; K 2304
whole) within 1e-5 scale-relative of float64, where w rounded once to
bf16 is not.
(d) The port's int8->fp32 conv (the plain version) on that shape against
the reference's ``conv_direct_chwn`` in interpret mode, at the float32
weights' tolerance of ``tests/test_torch_mixed_dtype.py`` (rtol 1e-4,
atol 1e-3), plain and with a pool and a residual; and the build's shared
memory (``ops.k1_i8f32_smem``) within the float32 kernel's at every tile
``conv_tiling`` picks for the calibration sweep, so no tile moves.
``test_torch_k1_i8f32_k9_bf16_card.py`` holds the kernels on the card.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.conv import ops as ref_conv
from repro.kernels.transpose import ops as ref_ops

from repro_torch.kernels import bf16_mma
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.kernels.transpose import ops
from repro_torch.perfmodel.calibration import C_SWEEP, N_SWEEP

CONV_RTOL, CONV_ATOL = 1e-4, 1e-3
TC_FP32_TOL = 1e-5

SHAPES_2D = [(32, 100352 // 392), (32, 100), (64, 37), (32, 7), (64, 130),
             (17, 9), (100, 24), (1, 1000)]
SHAPES_3D = [(3, 64, 37), (2, 32, 300), (1, 64, 8), (2, 65, 10)]


def _bf16(shape, seed: int) -> np.ndarray:
    """bf16 bits (uint16) of seeded normal values."""
    a = np.random.default_rng(seed).standard_normal(shape, np.float32)
    return torch.from_numpy(a).to(torch.bfloat16).view(torch.int16).numpy() \
        .view(np.uint16)


def _torch_bf16(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)


def _ref(fn, bits: np.ndarray) -> np.ndarray:
    x = jnp.asarray(bits).view(jnp.bfloat16)
    return np.asarray(fn(x, interpret=True).view(jnp.uint16))


# -- (a) against the reference ------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES_2D, ids=lambda s: f"{s[0]}x{s[1]}")
def test_bf16_transpose2d_matches_reference(shape):
    bits = _bf16(shape, sum(shape))
    got = ops.transpose2d(_torch_bf16(bits))
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16),
        _ref(ref_ops.transpose2d, bits))


@pytest.mark.parametrize("shape", SHAPES_3D,
                         ids=lambda s: "x".join(map(str, s)))
def test_bf16_transpose2d_batched_matches_reference(shape):
    bits = _bf16(shape, sum(shape))
    got = ops.transpose2d_batched(_torch_bf16(bits))
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16),
        _ref(ref_ops.transpose2d_batched, bits))


# -- (b) the kernel's tile map ------------------------------------------------

def _run_mirror(B: int, M: int, N: int, x_addr: int, y_addr: int):
    """The bf16 kernel in Python: its loads, word writes, reads and stores
    at element granularity.  Returns (y, writes per y element, the widths
    of the loads and of the stores, each with its element offset)."""
    x = np.arange(B * M * N, dtype=np.int64).reshape(B, M, N)
    TM, TN = ops.k9_bf16_tile(M)
    xv, yv = ops.k9_bf16_widths(M, N, x_addr, y_addr)
    tiles_m, tiles_n = -(-M // TM), -(-N // TN)
    y = np.full((B, N, M), -1, np.int64)
    writes = np.zeros((B, N, M), np.int64)
    loads, stores = [], []
    for blk in range(B * tiles_m * tiles_n):
        tn, rest = blk % tiles_n, blk // tiles_n
        tm, b = rest % tiles_m, rest // tiles_m
        m0, n0 = tm * TM, tn * TN
        tile = {}
        for tid in range(ops.K9_BF16_THREADS):
            for p, nc in ops.k9_bf16_units(TM, tid):
                n = n0 + 8 * nc
                for dm in (0, 1):
                    m = m0 + 2 * p + dm
                    if m < M and n < N:
                        loads.append((xv, (b * M + m) * N + n,
                                      min(8, N - n)))
                for j, r in zip(range(8), ops.k9_bf16_unit_rows(TM, nc)):
                    # element r - 8 nc of each row, paired
                    pair = tuple(
                        int(x[b, m0 + 2 * p + dm, n0 + r])
                        if m0 + 2 * p + dm < M and n0 + r < N else 0
                        for dm in (0, 1))
                    w = ops.k9_bf16_word(r, p, TM)
                    assert w not in tile, "a word written twice"
                    tile[w] = pair
        assert len(tile) == TN * TM // 2
        for tid in range(ops.K9_BF16_THREADS):
            for r, c in ops.k9_bf16_reads(TM, TN, tid):
                n, mc = n0 + r, m0 + 8 * c
                if n >= N or mc >= M:
                    continue
                w0 = ops.k9_bf16_word(r, 4 * c, TM)
                vals = [v for q in range(4) for v in tile[w0 + q]]
                cnt = min(8, M - mc)
                stores.append((yv, (b * N + n) * M + mc, cnt))
                y[b, n, mc:mc + cnt] = vals[:cnt]
                writes[b, n, mc:mc + cnt] += 1
    return x, y, writes, loads, stores


@pytest.mark.parametrize("B,M,N,x_addr,y_addr", [
    (1, 32, 600, 0, 0), (1, 32, 50, 0, 0), (2, 64, 300, 0, 0),
    (1, 64, 130, 16, 16), (1, 32, 64, 2, 4), (1, 30, 70, 4, 2),
    (2, 17, 9, 0, 0), (1, 100, 40, 0, 0), (3, 64, 12, 8, 0),
    (1, 1, 33, 0, 0)])
def test_bf16_tile_map_writes_every_element_once(B, M, N, x_addr, y_addr):
    x, y, writes, loads, stores = _run_mirror(B, M, N, x_addr, y_addr)
    np.testing.assert_array_equal(writes, 1)
    np.testing.assert_array_equal(y, x.transpose(0, 2, 1))
    for (width, off, cnt), n_row, addr in (
            [(s, N, x_addr) for s in loads]
            + [(s, M, y_addr) for s in stores]):
        if width == 16:   # a whole aligned run of 8 in one row
            assert n_row % 8 == 0 and addr % 16 == 0
            assert (addr + 2 * off) % 16 == 0 and cnt == 8
        elif width == 4:
            assert n_row % 2 == 0 and (addr + 2 * off) % 4 == 0


@pytest.mark.parametrize("M,N,x_addr,y_addr,want", [
    (32, 100352, 0, 0, (16, 16)), (64, 50176, 256, 512, (16, 16)),
    (32, 100, 2, 0, (2, 16)), (30, 98, 4, 8, (4, 4)), (7, 9, 0, 0, (2, 2))])
def test_bf16_widths(M, N, x_addr, y_addr, want):
    assert ops.k9_bf16_widths(M, N, x_addr, y_addr) == want


@pytest.mark.parametrize("TM", [32, 64])
def test_bf16_shared_words_are_conflict_free(TM):
    _, TN = ops.k9_bf16_tile(TM)
    words = {ops.k9_bf16_word(r, p, TM)
             for r in range(TN) for p in range(TM // 2)}
    assert words == set(range(TN * TM // 2))
    for warp in range(ops.K9_BF16_THREADS // 32):
        lanes = range(32 * warp, 32 * warp + 32)
        units = [ops.k9_bf16_units(TM, t) for t in lanes]
        for u in range(ops.K9_BF16_UNITS):
            for j in range(8):   # the j-th word store of unit u
                banks = {ops.k9_bf16_word(
                    ops.k9_bf16_unit_rows(TM, units[i][u][1])[j],
                    units[i][u][0], TM) % 32 for i in range(32)}
                assert len(banks) == 32
        reads = [ops.k9_bf16_reads(TM, TN, t) for t in lanes]
        for i in range(len(reads[0])):   # 16-byte reads: a quarter warp
            for q in range(4):
                groups = {ops.k9_bf16_word(*reads[8 * q + e][i][:1],
                                           4 * reads[8 * q + e][i][1],
                                           TM) % 32 // 4 for e in range(8)}
                assert len(groups) == 8


# -- (c) K1 int8->fp32's arithmetic -----------------------------------------

# the calibration's case (chip_smoke.CAL_CASE: N 64, Ci 256, 13 x 13, Co
# 384, F 3, stride 1, pad 0, CHWN), narrowed to N 8 and Co 32
NARROW_CAL = (8, 256, 13, 32, 3)


def _cal_operands(seed: int, N=8, Ci=256, H=13, Co=32, F=3):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, (N, Ci, H, H)).astype(np.int8)
    w = (rng.standard_normal((Co, Ci, F, F), np.float32)
         / np.float32(127 * np.sqrt(Ci * F * F)))
    return q, w


def test_k1_i8f32_split3_holds_fp32_accuracy():
    N, Ci, H, Co, F = NARROW_CAL
    q, w = _cal_operands(0)
    # P [K, cols], k = (ci, dy, dx): the kernel's reduction order
    p = torch.nn.functional.unfold(torch.from_numpy(q).double(), F)
    p = p.permute(1, 0, 2).reshape(Ci * F * F, -1)
    wk = torch.from_numpy(w).permute(1, 2, 3, 0).reshape(Ci * F * F, Co)
    want = wk.double().t() @ p
    scale = max(1.0, want.abs().max().item())
    got = bf16_mma.k1_i8f32_emulated(wk, p.float())
    err = (got.double() - want).abs().max().item() / scale
    assert err <= TC_FP32_TOL, err
    # one bf16 product a term (w rounded once) is far from it
    one = bf16_mma.gemm_emulated(p.float().t(), [bf16_mma.to_bf16(wk)],
                                 bf16_mma.K1_I8F32_SLICE).t()
    assert (one.double() - want).abs().max().item() / scale > 10 * TC_FP32_TOL


# -- (d) the port's conv against the reference's kernel ---------------------

@pytest.mark.parametrize("pool,res", [(None, False), ((3, 2, "max"), True)])
def test_k1_i8f32_conv_matches_reference_kernel(pool, res):
    N, Ci, H, Co, F = 8, 64, 13, 32, 3   # Ci narrowed too: interpret mode
    q, w = _cal_operands(1, N, Ci, H, Co, F)
    rng = np.random.default_rng(2)
    b = rng.standard_normal((Co,), np.float32)
    Ho = H - F + 1
    r = rng.standard_normal((Co, Ho, Ho, N), np.float32) if res else None
    x = np.ascontiguousarray(q.transpose(1, 2, 3, 0))   # CHWN
    wk = np.ascontiguousarray(w.transpose(1, 2, 3, 0))
    kw = dict(relu=True, pool=pool, res_layout="CHWN")
    want = ref_conv.conv_direct_chwn(
        jnp.asarray(x), jnp.asarray(wk), 1, 0, 8, True, bias=jnp.asarray(b),
        res=None if r is None else jnp.asarray(r), **kw)
    got = conv_ops.conv_direct_chwn(
        torch.from_numpy(x), torch.from_numpy(wk), 1, 0,
        bias=torch.from_numpy(b),
        res=None if r is None else torch.from_numpy(r), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=CONV_RTOL, atol=CONV_ATOL)


# the calibration sweep (Fig. 4's grid): Ci at N 64, then N at Ci 256 (or
# Ct, where larger); Co 384, 13 x 13, F 3
SWEEP = ([(64, ci) for ci in C_SWEEP]
         + [(n, ci) for n in N_SWEEP for ci in (256, 512)])


@pytest.mark.parametrize("N,Ci", SWEEP)
def test_k1_i8f32_ring_fits_the_float32_tiles(N, Ci):
    t = conv_ops.conv_tiling(N, Ci, 13, 13, 384, 3, 1, 0, None)
    assert conv_ops.k1_i8f32_smem(t.bm, 0) <= t.smem_bytes
    for bm in conv_ops._K1_BMS:
        for cmax in (0, 32, 500, 4000):
            assert (conv_ops.k1_i8f32_smem(bm, cmax)
                    <= conv_ops._k1_smem(bm, cmax))
