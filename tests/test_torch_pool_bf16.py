"""bf16 cross entropy (K8) against the reference, and the lane maps of the
bf16 builds of K3a (``pool_chwn_bf16_kernel``) and K7a
(``pool_backward_direct_bf16`` / ``pool_backward_banded_bf16``), on the
CPU.

- ``softmax_xent`` on seeded bf16 logits (the plain version, as on the
  CPU) against the reference's ``softmax_xent`` in interpret mode on the
  same bf16 values, labels inside [0, C) and outside it: the float32 loss
  within 1e-6.
- The kernels' maps in Python (``pool.ops.k3a_bf16_unit``,
  ``pool.backward.k7a_bf16_direct_unit`` and ``k7a_bf16_banded_unit``,
  ``pool_backward_band(..., itemsize=2)``, ``k7a_bf16_smem_bytes``) for N
  in {1, 3, 8, 32, 33, 64} and (F, S) of 2/2, 3/2 and 3/1: every output
  (every dx element) is written by exactly one thread, a warp's lanes are
  all live where N < 32, and a banded block's windows are those its band
  touches, within the shared memory the band was given.  Then the
  kernels' arithmetic, emulated over those maps on bf16 inputs with ties,
  NaN and all -inf windows, equals the plain versions bit for bit (max)
  or within one bf16 step (avg).

``test_torch_pool_bf16_card.py`` holds the CUDA kernels against the plain
versions on the card.
"""
from __future__ import annotations

import itertools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.softmax import ops as ref_softmax

from repro_torch.kernels.pool import backward as bwd
from repro_torch.kernels.pool.ops import k3a_bf16_unit
from repro_torch.kernels.pool.ref import pool_backward_ref, pool_ref
from repro_torch.kernels.softmax.ops import softmax_xent
from repro_torch.shapes import pool_out_hw

XENT_TOL = 1e-6
BF16_STEP = 2.0 ** -7
SMEM_PER_BLOCK = 232448
NS = (1, 3, 8, 32, 33, 64)
WINDOWS = ((2, 2), (3, 2), (3, 1))
C, H, W = 2, 9, 7


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)


# --------------------------------------------------------------------------
# K8 on bf16 logits
# --------------------------------------------------------------------------
@pytest.mark.parametrize("rows,cols,outside", [(32, 1000, False),
                                               (5, 10, True),
                                               (6, 3, True)])
def test_bf16_softmax_xent_matches_reference(rows, cols, outside):
    rng = np.random.default_rng(rows * cols)
    x = _bf16(rng.standard_normal((rows, cols), np.float32) * 4)
    labels = rng.integers(0, cols, rows)
    if outside:
        labels[::2] = np.array([-1, cols, cols + 7])[
            np.arange(len(labels[::2])) % 3]
    got = softmax_xent(x, torch.from_numpy(labels).long())
    want = ref_softmax.softmax_xent(
        jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(labels, jnp.int32))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=XENT_TOL, atol=XENT_TOL)


# --------------------------------------------------------------------------
# K3a bf16: one output unit a thread, lanes over (wo, n)
# --------------------------------------------------------------------------
def _k3a_units(N, F, S, pair):
    Ho, Wo = pool_out_hw(H, F, S), pool_out_hw(W, F, S)
    U = N // 2 if pair else N
    return [k3a_bf16_unit(u, N, C, Ho, Wo, pair)
            for u in range(C * Ho * Wo * U)]


@pytest.mark.parametrize("N,FS", list(itertools.product(NS, WINDOWS)))
def test_k3a_bf16_lanes_write_every_output_once(N, FS):
    F, S = FS
    Ho, Wo = pool_out_hw(H, F, S), pool_out_hw(W, F, S)
    for pair in {N % 2 == 0, False}:
        units = _k3a_units(N, F, S, pair)
        written = [(c, ho, wo, n) for c, ho, wo, images in units
                   for n in images]
        assert len(written) == len(set(written)) == C * Ho * Wo * N
        assert all(0 <= c < C and 0 <= ho < Ho and 0 <= wo < Wo
                   and 0 <= n < N for c, ho, wo, n in written)
        # n runs fastest, then wo: at N below 32 a warp's lanes take
        # neighbouring outputs of a row (or the next rows), none idles
        for a, b in zip(units, units[1:]):
            if a[:3] == b[:3]:
                assert b[3][0] == a[3][-1] + 1
            else:
                assert b[3][0] == 0 and a[3][-1] == N - 1
                assert (b[0], b[1], b[2]) == (a[0], a[1], a[2] + 1) or \
                    b[2] == 0
        if pair:
            assert all(images[0] % 2 == 0 and len(images) == 2
                       for *_, images in units)


@pytest.mark.parametrize("N,FS,op", [(n, fs, op) for n in (3, 8, 32)
                                     for fs in WINDOWS + ((7, 7),)
                                     for op in ("max", "avg")])
def test_k3a_bf16_emulated_equals_the_plain_version(N, FS, op):
    """The kernel's arithmetic over its map: each image's taps widened,
    max (NaN-propagating) or the float32 sum in row-major order, divided,
    rounded once."""
    F, S = FS
    rng = np.random.default_rng(N * 10 + F)
    x = _bf16(np.round(rng.standard_normal((C, H, W, N)) * 4) / 4)
    x[0, 1, 2, 0] = float("nan")
    x[1, :3, :3, -1] = -float("inf")
    xf = x.float()
    Ho, Wo = pool_out_hw(H, F, S), pool_out_hw(W, F, S)
    y = torch.empty(C, Ho, Wo, N, dtype=torch.bfloat16)
    for c, ho, wo, images in _k3a_units(N, F, S, N % 2 == 0):
        for n in images:
            acc = torch.tensor(0.0 if op == "avg" else -math.inf)
            for dy in range(F):
                for dx in range(F):
                    v = xf[c, ho * S + dy, wo * S + dx, n]
                    if op == "avg":
                        acc = acc + v
                    elif v > acc or v != v:
                        acc = v
            if op == "avg":
                acc = acc / float(F * F)
            y[c, ho, wo, n] = acc.to(torch.bfloat16)
    want = pool_ref(x, F, S, op, "CHWN")
    if op == "max":
        torch.testing.assert_close(y, want, rtol=0, atol=0, equal_nan=True)
    else:
        _within_one_step(y, want)


def _within_one_step(got, want):
    got, want = got.double(), want.double()
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan)
    inf = want.isinf()
    assert torch.equal(got[inf], want[inf])
    got, want = got[~nan & ~inf], want[~nan & ~inf]
    bound = BF16_STEP * want.abs() + 1e-5 * want.abs().max()
    assert bool(((got - want).abs() <= bound).all())


# --------------------------------------------------------------------------
# K7a bf16: the direct kernel (max, F <= S) and the banded one (the rest)
# --------------------------------------------------------------------------
def _direct_units(N, F, S, pair):
    Ho, Wo = pool_out_hw(H, F, S), pool_out_hw(W, F, S)
    U = N // 2 if pair else N
    return [bwd.k7a_bf16_direct_unit(u, N, C, H, W, F, S, pair)
            for u in range(C * Ho * Wo * U)]


def _banded_units(N, F, S, pair):
    """[(block, e, (c, h, w, images))] of the banded kernel's phase 2."""
    grid = bwd.k7a_bf16_banded_grid(N, C, H, W, F, S, pair)
    out = []
    for block in itertools.product(*map(range, grid)):
        e = 0
        while (unit := bwd.k7a_bf16_banded_unit(block, e, N, H, W, F, S,
                                                 pair)) is not None:
            out.append((block, e, unit))
            e += 1
    return out


@pytest.mark.parametrize("N,FS", list(itertools.product(NS, WINDOWS)))
def test_k7a_bf16_lanes_write_every_element_once(N, FS):
    F, S = FS
    for pair in {N % 2 == 0, False}:
        if bwd.k7a_bf16_direct("max", F, S):
            written = []
            for c, (oh, ow), images, owned in _direct_units(N, F, S, pair):
                taps = {(oh * S + dy, ow * S + dx) for dy in range(F)
                        for dx in range(F)}
                assert taps <= set(owned)
                written += [(c, h, w, n) for h, w in owned for n in images]
        else:
            written = [(c, h, w, n) for _, _, (c, h, w, images)
                       in _banded_units(N, F, S, pair) for n in images]
        assert len(written) == len(set(written)) == C * H * W * N
        assert all(0 <= c < C and 0 <= h < H and 0 <= w < W and 0 <= n < N
                   for c, h, w, n in written)


@pytest.mark.parametrize("FS", WINDOWS + ((2, 3), (32, 32), (7, 7)))
def test_k7a_bf16_band_holds_every_window_its_rows_touch(FS):
    """The banded block's shared memory (``k7a_bf16_smem_bytes``: a g word
    and a taps word a window unit, 32 units) holds every window its band's
    rows lie in; the band is the most rows within the aim."""
    F, S = FS
    for Hh, Ww in ((H, W), (32, 32), (55, 55), (224, 224)):
        if pool_out_hw(Hh, F, S) < 1:
            continue
        b = bwd.pool_backward_band(Hh, Ww, F, S, itemsize=2)
        Wo = pool_out_hw(Ww, F, S)
        assert b.smem_bytes == bwd.k7a_bf16_smem_bytes(b.win_rows * Wo)
        assert b.smem_bytes <= SMEM_PER_BLOCK
        assert b.band == 1 or b.smem_bytes <= 32 * 1024
        for h0 in range(0, Hh, b.band):
            lo, hi = bwd.band_windows(h0, min(Hh, h0 + b.band), Hh, F, S)
            assert hi - lo + 1 <= b.win_rows
            for h in range(h0, min(Hh, h0 + b.band)):
                for oh in range(pool_out_hw(Hh, F, S)):
                    if oh * S <= h < oh * S + F:
                        assert lo <= oh <= hi


def test_k7a_bf16_band_of_the_main_path():
    """unet_mini's global average pool (32 x 32 at 32/32) and VGG16's and
    unet_mini's 2/2 pools: the direct kernel takes the max pools, and the
    banded one's band fits the aim."""
    assert bwd.k7a_bf16_direct("max", 2, 2)
    assert not bwd.k7a_bf16_direct("avg", 32, 32)
    b = bwd.pool_backward_band(32, 32, 32, 32, itemsize=2)
    assert b.band == 16 and b.smem_bytes == 256


def _emulate_k7a(x, g, F, S, op, relu, pair):
    """dx of K7a bf16 over its map: each window's first max among the
    widened taps (a NaN window routes nothing), the shares summed in
    float32 in the reference's order, the mask multiplied, rounded once."""
    Cc, Hh, Ww, N = x.shape
    Ho, Wo = pool_out_hw(Hh, F, S), pool_out_hw(Ww, F, S)
    xf, gf = x.float(), g.float()
    dx = torch.full(x.shape, float("nan"), dtype=torch.bfloat16)

    def first_max(c, oh, ow, n):
        m, first, nan = -math.inf, 0, False
        for t in range(F * F):
            v = xf[c, oh * S + t // F, ow * S + t % F, n].item()
            nan |= v != v
            if v > m:
                m, first = v, t
        return None if nan else first

    def mask(v):
        return 0.0 if relu and not v > 0 else 1.0

    if bwd.k7a_bf16_direct(op, F, S):
        for c, (oh, ow), images, owned in [
                bwd.k7a_bf16_direct_unit(u, N, Cc, Hh, Ww, F, S, pair)
                for u in range(Cc * Ho * Wo * (N // 2 if pair else N))]:
            for n in images:
                f = first_max(c, oh, ow, n)
                for h, w in owned:
                    dy, dxx = h - oh * S, w - ow * S
                    tap = dy < F and dxx < F
                    d = torch.tensor(gf[c, oh, ow, n].item()
                                     if tap and f == dy * F + dxx else 0.0)
                    if tap:
                        d = d * mask(xf[c, h, w, n].item())
                    dx[c, h, w, n] = d.to(torch.bfloat16)
        return dx
    area = float(F * F)
    grid = bwd.k7a_bf16_banded_grid(N, Cc, Hh, Ww, F, S, pair)
    for block in itertools.product(*map(range, grid)):
        e = 0
        while (unit := bwd.k7a_bf16_banded_unit(block, e, N, Hh, Ww, F, S,
                                                 pair)) is not None:
            e += 1
            c, h, w, images = unit
            for n in images:
                acc = torch.tensor(0.0)
                for oh in range(min(h // S, Ho - 1), -1, -1):
                    if not oh * S <= h < oh * S + F:
                        continue
                    for ow in range(min(w // S, Wo - 1), -1, -1):
                        if not ow * S <= w < ow * S + F:
                            continue
                        gv = gf[c, oh, ow, n]
                        if op == "avg":
                            acc = acc + gv / area
                        elif first_max(c, oh, ow, n) == \
                                (h - oh * S) * F + w - ow * S:
                            acc = acc + gv
                if relu:
                    acc = acc * mask(xf[c, h, w, n].item())
                dx[c, h, w, n] = acc.to(torch.bfloat16)
    return dx


@pytest.mark.parametrize("N,FS,op,relu", [
    (8, (2, 2), "max", True), (3, (2, 2), "max", False),
    (8, (3, 2), "max", True), (3, (3, 1), "max", False),
    (4, (3, 2), "avg", True), (3, (2, 2), "avg", False),
    (2, (2, 3), "max", True)])
def test_k7a_bf16_emulated_equals_the_plain_version(N, FS, op, relu):
    F, S = FS
    rng = np.random.default_rng(N * 7 + F * 3 + S)
    # few distinct values: ties in most windows
    x = _bf16(rng.integers(-2, 3, (C, H, W, N)).astype(np.float32))
    x[0, 0, 0, 0] = float("nan")
    x[1, :3, :3, 0] = -float("inf")
    Ho, Wo = pool_out_hw(H, F, S), pool_out_hw(W, F, S)
    g = _bf16(rng.standard_normal((C, Ho, Wo, N)).astype(np.float32))
    want = pool_backward_ref(x, g, F, S, op, "CHWN", "CHWN", relu)
    for pair in {N % 2 == 0, False}:
        got = _emulate_k7a(x, g, F, S, op, relu, pair)
        if op == "max":
            torch.testing.assert_close(got, want, rtol=0, atol=0,
                                       equal_nan=True)
        else:
            _within_one_step(got, want)
