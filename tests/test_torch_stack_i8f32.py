"""The int8->fp32 stacks on the CPU: K5b int8->fp32
(``kernels/conv/csrc/conv_stack_nchw.cu``: ``conv_stack_nchw_i8f32_kernel``)
copies int8 x into its float32 box by ``cp.async`` and widens it there;
K5a int8->fp32 (``conv_stack_chwn.cu``: ``cluster_stack_i8f32_kernel``)
runs on the tensor cores at fp32 accuracy.  No card runs here, so numpy
mirrors of what they do are held to:

(a) thread by thread, K5b's copy map (``ops.k5b_i8f32_mode``,
    ``k5b_i8f32_box``, ``k5b_i8f32_units``, ``k5b_i8f32_unit``; the walk
    ``k5b_i8bf16_walk``): every x element of a stage lands once, at its
    float32 slot; zeros fall outside [0, H) x [0, W) and past Ci; each
    ``cp.async`` is 4, 8 or 16 bytes, aligned at both ends and wholly
    inside its x row; each thread widens only the bytes it copied, and a
    unit's bytes lie inside its own span, so its in-place widening reads
    every byte before any float overwrites it.  W 56, 128, 55, 13 and 7,
    pad 0-2, stride 1 and 2, x at an offset; the element path (a CHWN
    source, W % 4 != 0, x misaligned) too;
(b) ``ops.k5a_i8f32_smem`` and ``ops.k5b_i8f32_smem`` stay within their
    float32 twins' (``_cluster_smem_bytes``, ``k5b_layout``) at every tile
    ``stack_tiling`` picks for the networks' stack ops and the two smoke
    cases; K5a's producers' cluster-barrier schedule runs to its end at
    its ring's three stages;
(c) a numpy model of K5a int8->fp32's arithmetic on the smoke case's K1 =
    27 and K2 = 576, values drawn as the smoke draws them: conv1 three bf16
    products a term (``split3``'s parts of w1, x exact), conv2 3xTF32 as
    ``mma.cuh::split_tf32`` cuts, each mma's sum truncated to float32, in
    chains of 32 terms flushed into float32: within the 1e-5 gate of
    float64 with a margin, and the same model without the small parts
    misses it.

No jax, no reference package:

    PYTHONPATH=src python -m pytest -q tests/test_torch_stack_i8f32.py
"""
from __future__ import annotations

import math

import numpy as np
import pytest

import chip_smoke
from repro_torch.kernels.conv import ops
from repro_torch.shapes import conv_out_hw
from tests.test_torch_stack_i8bf16 import (_k5a_rstr, _run_k5a_protocol,
                                           _stack_launches)

RNG = np.random.default_rng(34)
TC_FP32_TOL = 1e-5

# ---- (a) K5b's box -----------------------------------------------------------

# (N, Ci, H = W, F1, S1, P1, F2, S2, P2, pool, x byte offset, src layout)
K5B_MAPS = [
    (32, 64, 56, 3, 1, 1, 3, 1, 1, None, 0, "NCHW"),     # the smoke's block
    (2, 16, 128, 3, 1, 1, 3, 1, 1, None, 0, "NCHW"),     # 16-byte chunks
    (2, 16, 56, 3, 1, 1, 3, 1, 1, None, 4, "NCHW"),      # x at +4: quads
    (2, 8, 24, 3, 1, 1, 3, 1, 1, (2, 2, "max"), 0, "NCHW"),
    (3, 20, 28, 3, 1, 0, 3, 1, 1, None, 0, "NCHW"),      # pad 0, Ci % 8
    (2, 16, 20, 5, 1, 2, 3, 1, 1, None, 0, "NCHW"),      # pad 2
    (2, 16, 32, 3, 2, 1, 3, 1, 1, None, 0, "NCHW"),      # conv1 stride 2
    (2, 16, 55, 3, 1, 1, 3, 1, 1, None, 0, "NCHW"),      # elements
    (3, 8, 13, 3, 1, 1, 3, 1, 1, (2, 2, "max"), 0, "NCHW"),
    (4, 16, 7, 3, 1, 1, 3, 1, 1, None, 0, "NCHW"),
    (2, 16, 16, 3, 1, 1, 3, 1, 1, None, 1, "NCHW"),      # x at +1
    (4, 8, 10, 3, 2, 1, 3, 1, 1, None, 0, "CHWN"),       # a CHWN source
]


def _k5b_setup(case):
    N, Ci, H, F1, S1, P1, F2, S2, P2, pool, off, src = case
    t = ops.stack_tiling("NCHW", N, Ci, H, H, 16, F1, S1, P1, 16, F2, S2,
                         P2, pool)
    pF, pS = (pool[0], pool[1]) if pool else (0, 0)
    ga = ops.k5b_layout(Ci, F1, S1, F2, S2, pF, pS, t.bm, t.nb, t.uth,
                        t.utw)[0]
    _, _, xh, span = ops._k5b_box(F1, S1, F2, S2, pF, pS, t.uth, t.utw)
    xstr = ops._rows8(t.nb * xh * ((3 + span + 3) // 4 * 4))
    return t, ga, xstr, ops.k5b_i8f32_mode(H, 4096 + off, src)


def _k5b_stage(case, t, ga, xstr, mode, blk, oct_):
    """Simulate one phase-A stage's x box of K5b's int8->fp32 producers
    (copies, then each thread's widening) and return (the box's floats,
    what they should be, how often each x element landed, how often it
    should have, the copy sizes)."""
    N, Ci, H, F1, S1, P1, F2, S2, P2, pool, off, src = case
    W = H
    tile = ops.stack_tile(N, H, W, F1, S1, P1, F2, S2, P2, pool, t.nb,
                          t.uth, t.utw, *blk)
    ih0, XH, iw0, XW = ops.k5b_i8f32_box(tile, F1, S1, P1)
    NBc, n0 = tile["NBc"], tile["n0"]
    ch = 8 * ga
    assert NBc * XH * XW <= xstr
    x = RNG.integers(-128, 128, size=(NBc, Ci, H, W)).astype(np.int8)
    flat = x.reshape(-1)
    xs_n, xs_c, xs_h, xs_w = ((Ci * H * W, H * W, W, 1) if src == "NCHW"
                              else (1, H * W * N, W * N, N))
    base = 4096 + off                    # x's global address
    box = np.zeros(4 * ch * xstr, np.uint8)   # the box's bytes
    owner = np.full(box.size, -1, np.int32)
    landed = np.zeros(flat.size, np.int32)
    sizes = set()

    def elem(nl, ci, ih, iw):
        """x element (nl, ci, ih, iw) of the block's images: its offset in
        ``flat`` (NCHW order) and in x (the source layout)."""
        return ((nl * Ci + ci) * H + ih) * W + iw, (
            (n0 + nl) * xs_n + ci * xs_c + ih * xs_h + iw * xs_w)

    if mode:
        XU, phi = ops.k5b_i8f32_units(mode, iw0, XW)
        widen = []
        for pt in range(128):
            for c8, nl, xh, xu in ops.k5b_i8bf16_walk(XU, XH, NBc, ch, pt):
                ci, ih = oct_ * 8 + c8, ih0 + xh
                row_ok = ci < Ci and 0 <= ih < H
                cw = iw0 - 4 * phi + mode * xu
                addr = base + elem(nl, ci, ih, 0)[1] + cw if row_ok else 0
                q0, j0, j1, copies, at = ops.k5b_i8f32_unit(
                    mode, xu, phi, XW, iw0, W, row_ok, addr)
                assert 0 <= j0 < j1 <= mode // 4
                span0 = 4 * (c8 * xstr + (nl * XH + xh) * XW + 4 * q0)
                # the bytes lie inside the unit's own span
                assert 16 * j0 <= at + 4 * j0 and at + 4 * j1 <= 16 * j1
                for o, n, saddr in copies:
                    dst = span0 + o
                    sizes.add(n)
                    assert n in (4, 8, 16) and dst % n == 0
                    assert (owner[dst:dst + n] == -1).all()
                    owner[dst:dst + n] = pt
                    if saddr is None:
                        box[dst:dst + n] = 0
                        continue
                    assert saddr % n == 0
                    e0 = saddr - base - n0 * xs_n
                    assert 0 <= e0 and e0 // W == (e0 + n - 1) // W
                    box[dst:dst + n] = flat[e0:e0 + n].view(np.uint8)
                    landed[e0:e0 + n] += 1
                widen.append((pt, span0, j0, j1, at))
        done = np.zeros(box.size, bool)
        for pt, span0, j0, j1, at in widen:
            lo, hi = span0 + at + 4 * j0, span0 + at + 4 * j1
            # a thread widens only the bytes it copied, in place: all read
            # before any float of the span is written over them
            assert (owner[lo:hi] == pt).all()
            assert not done[lo:hi].any()
            vals = box[lo:hi].view(np.int8).astype(np.float32)
            box[span0 + 16 * j0:span0 + 16 * j1] = vals.view(np.uint8)
            done[span0 + 16 * j0:span0 + 16 * j1] = True
        floats = box.view(np.float32)
    else:
        # elements: 4 columns a copy, each from the thread's walk
        floats = np.zeros(ch * xstr, np.float32)
        XQ = XW // 4
        for pt in range(128):
            for c8, nl, xh, xq in ops.k5b_i8bf16_walk(XQ, XH, NBc, ch, pt):
                ci, ih = oct_ * 8 + c8, ih0 + xh
                d = c8 * xstr + (nl * XH + xh) * XW + 4 * xq
                for j in range(4):
                    iw = iw0 + 4 * xq + j
                    if ci < Ci and 0 <= ih < H and 0 <= iw < W:
                        e, _ = elem(nl, ci, ih, iw)
                        floats[d + j] = flat[e]
                        landed[e] += 1
    got = floats.reshape(ch, xstr)[:, :NBc * XH * XW]
    want = np.zeros((ch, NBc, XH, XW), np.float32)
    hit = np.zeros(flat.size, np.int32)
    for c8 in range(ch):
        ci = oct_ * 8 + c8
        for nl in range(NBc):
            for xh in range(XH):
                ih = ih0 + xh
                if ci >= Ci or not 0 <= ih < H:
                    continue
                lo, hi = max(iw0, 0), min(iw0 + XW, W)
                if lo < hi:
                    want[c8, nl, xh, lo - iw0:hi - iw0] = x[nl, ci, ih,
                                                              lo:hi]
                    e = ((nl * Ci + ci) * H + ih) * W
                    hit[e + lo:e + hi] += 1
    return got, want.reshape(ch, -1), landed, hit, sizes


def _blocks(case, t):
    N, _, H, F1, S1, P1, F2, S2, P2, pool = case[:10]
    Ho2 = conv_out_hw(conv_out_hw(H, F1, S1, P1), F2, S2, P2)
    U = Ho2 if pool is None else (Ho2 - pool[0]) // pool[1] + 1
    ngs, nth, ntw = -(-N // t.nb), -(-U // t.uth), -(-U // t.utw)
    return sorted({(0, 0, 0), (ngs - 1, nth - 1, ntw - 1),
                   (0, nth // 2, ntw // 2), (ngs - 1, 0, ntw - 1)})


@pytest.mark.parametrize("case", K5B_MAPS, ids=[str(i) for i in
                                                 range(len(K5B_MAPS))])
def test_k5b_box_copies_land_once_at_their_float_slots(case):
    t, ga, xstr, mode = _k5b_setup(case)
    Ci = case[1]
    # the smoke's block and the first octet of every case; the other
    # blocks at the first octet only (their rows are the same rows)
    octs = range(0, -(-Ci // 8), ga)
    for i, blk in enumerate(_blocks(case, t)):
        for oct_ in (octs if i == 0 else octs[:1]):
            got, want, landed, hit, _ = _k5b_stage(case, t, ga, xstr, mode,
                                                   blk, oct_)
            np.testing.assert_array_equal(got, want)
            # every x element of the stage's box landed once, no other
            np.testing.assert_array_equal(landed, hit)


def test_k5b_maps_reach_every_copy_form():
    """The cases above reach each chunk size (16, 8, 4), each copy size
    and the element path; W 56 (the smoke's block) copies 8-byte chunks,
    where the float32 twin's rule asked x to be 16-byte aligned."""
    modes, sizes = set(), set()
    for case in K5B_MAPS:
        t, ga, xstr, mode = _k5b_setup(case)
        modes.add(mode)
        if mode:
            for blk in _blocks(case, t)[:2]:
                sizes |= _k5b_stage(case, t, ga, xstr, mode, blk, 0)[4]
    assert modes == {0, 4, 8, 16} and sizes == {4, 8, 16}
    assert _k5b_setup(K5B_MAPS[0])[3] == 8
    for W, off in ((55, 0), (13, 0), (7, 0), (16, 1), (16, 2)):
        assert ops.k5b_i8f32_mode(W, 4096 + off) == 0
    assert ops.k5b_i8f32_mode(16, 4096 + 4) == 4
    assert ops.k5b_i8f32_mode(64, 4096, "CHWN") == 0


# ---- (b) shared memory, the cluster schedule ---------------------------------


def test_int8_fp32_stacks_fit_their_twins_shared_memory_at_every_tile():
    launches = _stack_launches()
    assert {e for e, _ in launches} == {"conv_stack_chwn", "conv_stack_nchw"}
    for engine, case in launches:
        N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool = case[:12]
        t = ops.stack_tiling("CHWN" if engine == "conv_stack_chwn" else
                             "NCHW", N, Ci, H, H, Cm, F1, S1, P1, Co, F2,
                             S2, P2, pool)
        if engine == "conv_stack_chwn":
            rstr = _k5a_rstr(N, H, F1, S1, P1, F2, S2, P2, pool, t)
            twin = ops._cluster_smem_bytes(t.bm, rstr, pool is not None)
            assert twin == t.smem_bytes, case
            ns, slot = ops.k5a_i8f32_stages(t.bm)
            assert ns >= 3 and ns * slot <= ops._cluster_ring_bytes(t.bm)
            assert ops.k5a_i8f32_smem(t.bm, rstr, pool is not None) <= twin
            continue
        pF, pS = (pool[0], pool[1]) if pool else (0, 0)
        tile = (Ci, F1, S1, F2, S2, pF, pS, t.bm, t.nb, t.uth, t.utw)
        twin = ops.k5b_layout(*tile)[1]
        assert twin == t.smem_bytes, case
        assert ops.k5b_i8f32_smem(*tile) <= twin


@pytest.mark.parametrize("bm", [64, 128, 256])
def test_k5a_i8f32_stages(bm):
    """Three stages of a phase-A k16 slice (w1 float32 in rows of 68, x as
    bf16 and as bytes) or 4 // (bm / 64) k8 slices of w2 fit the twin's
    ring at every bm."""
    ns, slot = ops.k5a_i8f32_stages(bm)
    assert ns == 3 and slot == 16 * 68 * 4 + 16 * 128 * 3
    assert (4 // (bm // 64)) * 8 * (bm + 8) * 4 <= slot


@pytest.mark.parametrize("CL,nA,nB,chunks,last_b", [
    (1, 2, 18, 1, 18), (3, 4, 9, 3, 9), (3, 0, 18, 2, 9), (8, 2, 4, 4, 1),
    (2, 6, 1, 3, 1), (4, 1, 36, 8, 9)])
def test_k5a_i8f32_barrier_schedule_runs_to_its_end(CL, nA, nB, chunks,
                                                    last_b):
    """The int8->bf16 kernel's producer schedule at the int8->fp32 ring's
    three stages completes (no wait on a stage it has not announced)."""
    assert _run_k5a_protocol(CL, nA, nB, chunks, last_b, 3)


# ---- (c) K5a int8->fp32's arithmetic -----------------------------------------


def _bf16(v: np.ndarray) -> np.ndarray:
    """float32 -> bf16 (round to nearest even), as float32."""
    b = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def split3(v: np.ndarray):
    """``storage::split3``: hi, md, lo bf16 parts summing to v exactly."""
    hi = _bf16(v)
    r = (v - hi).astype(np.float32)
    md = _bf16(r)
    lo = _bf16((r - md).astype(np.float32))
    return hi, md, lo


def split_tf32(v: np.ndarray):
    """``mma::split_tf32``: big (rounded to TF32, ties away), small (the
    rest, which the mma reads truncated to TF32)."""
    bits = v.astype(np.float32).view(np.uint32)
    big = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)
    small = (v - big).astype(np.float32)
    small = (small.view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    return big, small


def _rz32(v: np.ndarray) -> np.ndarray:
    """float64 -> float32 rounded toward zero (the tensor core truncates
    as it accumulates)."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _mma_chain(parts, K: int, step: int) -> np.ndarray:
    """Sum over k of sum over (a, b) of parts of a[..., k] * b[k, ...],
    as mma.sync runs it: each product (a step-deep slice of one (a, b)
    pair, exact in float64) added to the chain and truncated to float32,
    chains of 32 terms flushed into float32 sums (round to nearest)."""
    out = None
    chain = None
    for k0 in range(0, K, step):
        for a, b in parts:
            s = np.einsum("mk,kn->mn", a[:, k0:k0 + step].astype(np.float64),
                          b[k0:k0 + step].astype(np.float64))
            chain = _rz32((0 if chain is None else chain.astype(np.float64))
                          + s)
        if (k0 + step) % 32 == 0 or k0 + step >= K:
            out = chain if out is None else (out + chain).astype(np.float32)
            chain = None
    return out


def _k5a_model(small_parts: bool):
    """(model, float64) of the smoke case's conv1 -> ReLU -> conv2 terms:
    x quantized per channel from randn (scale folded into w1, as the smoke
    draws them), K1 = 3 x 3 x 3 = 27, Cm = 64, K2 = 64 x 3 x 3 = 576, Co =
    64, 128 conv2 columns of mid values."""
    N, Ci, Cm, Co, F = 2, 3, 64, 64, 3
    H = 18
    x = RNG.standard_normal((N, Ci, H, H)).astype(np.float32)
    amax = np.abs(x).max(axis=(0, 2, 3), keepdims=True)
    scale = (amax / 127).astype(np.float32)
    q = np.clip(np.round(x / scale), -127, 127).astype(np.float32)
    w1 = (RNG.standard_normal((Cm, Ci, F, F)) / math.sqrt(Ci * F * F)
          * scale.reshape(1, Ci, 1, 1)).astype(np.float32)
    w2 = (RNG.standard_normal((Co, Cm, F, F)) / math.sqrt(Cm * F * F)
          ).astype(np.float32)
    b1 = RNG.standard_normal(Cm).astype(np.float32)
    # conv1 as a GEMM over its patches (valid positions of a 16 x 16 map)
    cols = np.stack([q[n, :, i:i + F, j:j + F].reshape(-1)
                     for n in range(N) for i in range(H - F + 1)
                     for j in range(H - F + 1)], axis=1)   # [27, positions]
    A1 = w1.reshape(Cm, -1)
    if small_parts:
        hi, md, lo = split3(A1)
        parts1 = [(lo, cols), (md, cols), (hi, cols)]
    else:
        parts1 = [(_bf16(A1), cols)]
    mid = np.maximum(_mma_chain(parts1, A1.shape[1], 16) + b1[:, None], 0)
    mid64 = np.maximum(A1.astype(np.float64) @ cols + b1[:, None], 0)
    # conv2's columns: 3 x 3 taps of the mid map at 128 output positions
    Hm = H - F + 1
    mm = mid.reshape(Cm, N, Hm, Hm)
    mm64 = mid64.reshape(Cm, N, Hm, Hm)
    outs = [(n, i, j) for n in range(N) for i in range(Hm - F + 1)
            for j in range(Hm - F + 1)][:128]
    B2 = np.stack([mm[:, n, i:i + F, j:j + F].reshape(-1)
                   for n, i, j in outs], axis=1)              # [576, 128]
    B64 = np.stack([mm64[:, n, i:i + F, j:j + F].reshape(-1)
                    for n, i, j in outs], axis=1)
    A2 = w2.reshape(Co, -1)
    abig, asmall = split_tf32(A2)
    bbig, bsmall = split_tf32(B2)
    parts2 = ([(asmall, bbig), (abig, bsmall), (abig, bbig)] if small_parts
              else [(abig, bbig)])
    got = _mma_chain(parts2, A2.shape[1], 8)
    want = A2.astype(np.float64) @ B64
    return got, want


def _scaled_err(got, want) -> float:
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def test_k5a_i8f32_arithmetic_holds_the_fp32_gate():
    got, want = _k5a_model(small_parts=True)
    err = _scaled_err(got, want)
    assert err <= TC_FP32_TOL / 4, err          # with a margin
    got, want = _k5a_model(small_parts=False)
    assert _scaled_err(got, want) > TC_FP32_TOL  # the small parts matter


def test_split3_is_exact_and_tf32_split_is_close():
    v = (RNG.standard_normal(4096) * 10.0 ** RNG.integers(-3, 3, 4096)
         ).astype(np.float32)
    hi, md, lo = split3(v)
    assert np.array_equal(hi.astype(np.float64) + md + lo, v.astype(
        np.float64))
    big, small = split_tf32(v)
    rel = np.abs(big.astype(np.float64) + small - v) / np.abs(v)
    assert rel.max() < 2.0 ** -21


def test_the_smoke_case_is_the_modelled_one():
    """The model's K1 and K2 are the smoke's K5a int8->fp32 case's."""
    case = chip_smoke.STACK_INT8_OFF_PATH["conv_stack_chwn.i8f32"]
    N, Ci, H, Cm, Co, F1, S1, P1, F2 = case[:9]
    assert (Ci * F1 * F1, Cm * F2 * F2, Cm, Co) == (27, 576, 64, 64)
