"""The int8->bf16 stacks' copy paths on the CPU: K5b int8->bf16
(``kernels/conv/csrc/conv_stack_nchw.cu``: ``conv_stack_nchw_i8bf16_kernel``)
and K5a int8->bf16 (``conv_stack_chwn.cu``: ``cluster_stack_i8bf16_kernel``)
copy int8 x into shared memory by ``cp.async`` and widen it there.  No card
runs here, so numpy mirrors of what their producers do are held to:

(a) the widening (``storage::bf16x4`` / ``bf16x8``, bit operations on the
    int8 bytes) equals ``torch``'s int8 -> bf16 conversion for all 256
    values;
(b) thread by thread, each new copy map (K5b's box, ``ops.k5b_i8bf16_walk``
    and ``k5b_i8bf16_unit``; K5a's slice, ``ops.k5a_i8bf16_runs``): every x
    element of a stage lands once, at its bf16 slot; zeros fall outside [0,
    H) x [0, W) (and past Ci or the block's positions); each ``cp.async``
    is 4, 8 or 16 bytes, aligned at both ends and wholly inside its x row
    (K5a: inside its run of 8 images); each thread widens only bytes it
    copied, and every byte is written by one copy;
(c) ``ops.k5b_i8bf16_smem`` and ``ops.k5a_i8bf16_smem`` stay within their
    bf16 twins' shared memory (``k5b_layout``, ``_cluster_smem_bytes``) at
    every tile ``stack_tiling`` picks for the packaged plans' stack ops,
    the smoke's bf16 VGG16 plan and the two smoke cases of the int8 stacks;
    K5a's stage walk (``ops.k5a_i8bf16_stage``) is the consumers' loop
    order, and its producers' cluster-barrier schedule runs to its end.

No jax, no reference package (the reference has no int8 stack copy path
to compare with; its int8 stacks are held in ``test_torch_stack_int8.py``):

    PYTHONPATH=src python -m pytest -q tests/test_torch_stack_i8bf16.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.kernels.conv import ops
from repro_torch.shapes import conv_out_hw

RNG = np.random.default_rng(33)

# ---- (a) the widening -------------------------------------------------------


def _f32_bits(v: np.ndarray) -> np.ndarray:
    return v.astype(np.float32).view(np.uint32)


def _i8_at(r: np.ndarray, i: int) -> np.ndarray:
    """``storage::i8_at``: byte i of a 32-bit word as a signed int8,
    widened to float."""
    return ((r << np.uint32(24 - 8 * i)).view(np.int32) >> 24).astype(
        np.float32)


def bf16x4(words: np.ndarray) -> np.ndarray:
    """``storage::bf16x4``: the 4 int8 bytes of each word (element 0
    lowest) as 4 bf16, two to a word ([..., 2] uint32)."""
    w = words.astype(np.uint32)

    def two(i):
        return ((_f32_bits(_i8_at(w, 2 * i)) >> np.uint32(16))
                | (_f32_bits(_i8_at(w, 2 * i + 1)) & np.uint32(0xffff0000)))

    return np.stack([two(0), two(1)], axis=-1)


def widen_bytes(b: np.ndarray) -> np.ndarray:
    """int8 bytes (a multiple of 4) as the bf16 halfwords the kernels
    write, through ``bf16x4`` on their little-endian words."""
    words = np.ascontiguousarray(b.astype(np.int8)).view(np.uint32)
    return np.ascontiguousarray(bf16x4(words)).view(np.uint16).reshape(-1)


def _torch_bf16_bits(v: np.ndarray) -> np.ndarray:
    t = torch.from_numpy(v.astype(np.int8)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def test_widening_matches_torch_for_every_int8_value():
    vals = np.arange(-128, 128, dtype=np.int16).astype(np.int8)
    got = widen_bytes(vals)
    np.testing.assert_array_equal(got, _torch_bf16_bits(vals))
    # the 8-byte form is two 4-byte ones (bf16x8's words in order)
    pairs = RNG.integers(-128, 128, size=(64, 8)).astype(np.int8)
    np.testing.assert_array_equal(widen_bytes(pairs.reshape(-1)),
                                  _torch_bf16_bits(pairs.reshape(-1)))


# ---- (b) K5b's box ---------------------------------------------------------

# (N, Ci, H = W, F1, S1, P1, F2, S2, P2, pool, x byte offset)
K5B_MAPS = [
    (32, 64, 56, 3, 1, 1, 3, 1, 1, None, 0),          # the smoke's block
    (2, 16, 16, 3, 1, 1, 3, 1, 1, None, 0),
    (2, 8, 24, 3, 1, 1, 3, 1, 1, (2, 2, "max"), 0),
    (3, 20, 28, 3, 1, 0, 3, 1, 1, None, 0),            # pad 0, Ci % 16
    (2, 16, 20, 5, 1, 2, 3, 1, 1, None, 0),            # pad 2
    (2, 16, 32, 3, 2, 1, 3, 1, 1, None, 0),            # conv1 stride 2
    (2, 16, 16, 3, 1, 1, 3, 1, 1, None, 4),            # x at +4: quads
    (4, 32, 8, 3, 1, 1, 3, 1, 1, None, 0),
]


def _k5b_mode(case):
    N, Ci, H, F1, S1, P1, F2, S2, P2, pool, off = case
    t = ops.stack_tiling("NCHW", N, Ci, H, H, 16, F1, S1, P1, 16, F2, S2,
                         P2, pool)
    pF, pS = (pool[0], pool[1]) if pool else (0, 0)
    want8 = H % 8 == 0 and off % 8 == 0
    want4 = H % 4 == 0 and off % 4 == 0
    lay = ops.k5b_i8bf16_layout(Ci, F1, S1, F2, S2, pF, pS, t.bm, t.nb,
                                t.uth, t.utw, want8, want4)
    return t, lay


def _k5b_stage(case, t, lay, blk, oct_):
    """Simulate one phase-A stage's x box of K5b's int8->bf16 producers
    (copies, then each thread's widening) and return (what landed in the
    box, what should have, facts about the copies)."""
    N, Ci, H, F1, S1, P1, F2, S2, P2, pool, off = case
    W = H
    gb, _, _, _, mode, xstr = lay
    tile = ops.stack_tile(N, H, W, F1, S1, P1, F2, S2, P2, pool, t.nb,
                          t.uth, t.utw, *blk)
    ih0, XH, iw0, XW = ops.k5b_i8bf16_box(tile, F1, S1, P1, mode)
    q = 8 if mode == 2 else 4
    XU = -(-XW // (2 * q))
    NBc, n0 = tile["NBc"], tile["n0"]
    ch = 16 * gb
    assert NBc * XH * XW <= xstr
    # the block's images of x (element offsets stay x's own, from n0 on)
    x = RNG.integers(-128, 128, size=(NBc, Ci, H, W)).astype(np.int8)
    flat = x.reshape(-1)
    base = 4096 + off                    # x's global address
    region = np.zeros(2 * ch * xstr, np.uint8)
    owner = np.full(region.size, -1, np.int32)
    landed = np.zeros(flat.size, np.int32)
    units, sizes, halves = [], set(), 0
    for pt in range(128):
        for c16, nl, xh, xu in ops.k5b_i8bf16_walk(XU, XH, NBc, ch, pt):
            ci, ih = oct_ * 16 + c16, ih0 + xh
            row_ok = ci < Ci and 0 <= ih < H
            elem = (nl * Ci + ci) * H * W + ih * W + iw0 + 2 * q * xu
            copies, (woff, wn) = ops.k5b_i8bf16_unit(
                q, XW, xu, iw0, W, row_ok, base + n0 * Ci * H * W + elem)
            span = 2 * (c16 * xstr + (nl * XH + xh) * XW + 2 * q * xu)
            halves += wn == q
            for o, nbytes, src in copies:
                dst = span + o
                sizes.add(nbytes)
                assert nbytes in (4, 8, 16)
                assert dst % nbytes == 0          # the stage is 16-aligned
                assert (owner[dst:dst + nbytes] == -1).all()
                owner[dst:dst + nbytes] = pt
                if src is None:
                    region[dst:dst + nbytes] = 0
                    continue
                assert src % nbytes == 0
                e0 = src - base - n0 * Ci * H * W
                assert 0 <= e0 and e0 // W == (e0 + nbytes - 1) // W
                region[dst:dst + nbytes] = flat[e0:e0 + nbytes].view(np.uint8)
                landed[e0:e0 + nbytes] += 1
            units.append((pt, span, woff, wn))
    for pt, span, woff, wn in units:
        # a thread widens only the bytes it copied, inside its unit's span
        assert (owner[span + woff:span + woff + wn] == pt).all()
        b = region[span + woff:span + woff + wn].view(np.int8).copy()
        region[span:span + 2 * wn] = widen_bytes(b).view(np.uint8)
    got = region.view(np.uint16).reshape(ch, xstr)[:, :NBc * XH * XW]
    want = np.zeros((ch, NBc, XH, XW), np.int8)
    hit = np.zeros(flat.size, np.int32)
    for c16 in range(ch):
        ci = oct_ * 16 + c16
        for nl in range(NBc):
            for xh in range(XH):
                ih = ih0 + xh
                if ci >= Ci or not 0 <= ih < H:
                    continue
                lo, hi = max(iw0, 0), min(iw0 + XW, W)
                if lo < hi:
                    want[c16, nl, xh, lo - iw0:hi - iw0] = x[nl, ci, ih,
                                                              lo:hi]
                    e = (nl * Ci + ci) * H * W + ih * W
                    hit[e + lo:e + hi] += 1
    return (got, _torch_bf16_bits(want.reshape(-1)).reshape(ch, -1),
            landed, hit, sizes, halves)


def _blocks(case, t):
    N, _, H, F1, S1, P1, F2, S2, P2, pool, _ = case
    Ho2 = conv_out_hw(conv_out_hw(H, F1, S1, P1), F2, S2, P2)
    U = Ho2 if pool is None else (Ho2 - pool[0]) // pool[1] + 1
    ngs, nth, ntw = -(-N // t.nb), -(-U // t.uth), -(-U // t.utw)
    return sorted({(0, 0, 0), (ngs - 1, nth - 1, ntw - 1),
                   (0, nth // 2, ntw // 2), (ngs - 1, 0, ntw - 1)})


@pytest.mark.parametrize("case", K5B_MAPS, ids=[str(i) for i in
                                                 range(len(K5B_MAPS))])
def test_k5b_box_copies_land_once_at_their_bf16_slots(case):
    t, lay = _k5b_mode(case)
    assert lay[4] in (1, 2), lay
    Ci = case[1]
    for blk in _blocks(case, t):
        for oct_ in range(0, -(-Ci // 16), lay[0]):
            got, want, landed, hit, sizes, _ = _k5b_stage(case, t, lay, blk,
                                                          oct_)
            np.testing.assert_array_equal(got, want)
            # every x element of the stage's box landed once, no other
            np.testing.assert_array_equal(landed, hit)


def test_k5b_maps_reach_every_copy_form():
    """The cases above reach both box modes, each copy size and the half
    units where a row ends; W % 4 != 0, a CHWN source or x at an odd
    offset take the element path (mode 0)."""
    modes, sizes, halves = set(), set(), 0
    for case in K5B_MAPS:
        t, lay = _k5b_mode(case)
        modes.add(lay[4])
        for blk in _blocks(case, t)[:2]:
            s = _k5b_stage(case, t, lay, blk, 0)
            sizes |= s[4]
            halves += s[5]
    assert modes == {1, 2} and sizes == {4, 8, 16} and halves
    # the smoke's block (W 56: the 8-aligned box does not fit) copies quads
    assert _k5b_mode(K5B_MAPS[0])[1][4] == 1
    for H, off in ((55, 0), (13, 0), (16, 1), (16, 2)):
        assert _k5b_mode((2, 16, H, 3, 1, 1, 3, 1, 1, None, off))[1][4] == 0


# ---- (b) K5a's slice ---------------------------------------------------------

# (N, Ci, H = W, Cm, Co, F1, S1, P1, F2, S2, P2, pool)
K5A_MAPS = [
    (32, 3, 224, 64, 64, 3, 1, 1, 3, 1, 1, (2, 2, "max")),  # the smoke's
    (16, 8, 12, 16, 24, 3, 1, 1, 3, 1, 1, (2, 2, "max")),
    (8, 16, 13, 32, 40, 3, 2, 1, 3, 1, 1, None),            # stride 2
    (8, 4, 10, 160, 192, 3, 1, 0, 3, 1, 1, None),           # pad 0, CL 3
]


def _k5a_kidx(k, F):
    c, r = divmod(k, F * F)
    return c, r // F, r % F


def _k5a_cases():
    for case in K5A_MAPS:
        N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool = case[:12]
        t = ops.stack_tiling("CHWN", N, Ci, H, H, Cm, F1, S1, P1, Co, F2,
                             S2, P2, pool)
        yield case, t


@pytest.mark.parametrize("idx", range(len(K5A_MAPS)))
def test_k5a_slice_runs_land_once_at_their_swizzled_slots(idx):
    case, t = list(_k5a_cases())[idx]
    N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool = case
    W, K1 = H, Ci * F1 * F1
    assert N % 8 == 0 and t.nb % 8 == 0           # runs of n: vec_x
    x = RNG.integers(-128, 128, size=(Ci, H, W, N)).astype(np.int8)
    flat, base = x.reshape(-1), 8192
    Ho2 = conv_out_hw(conv_out_hw(H, F1, S1, P1), F2, S2, P2)
    U = Ho2 if pool is None else (Ho2 - pool[0]) // pool[1] + 1
    blocks = {(0, 0, 0), (-(-N // t.nb) - 1, -(-U // t.uth) - 1,
                          -(-U // t.utw) - 1)}
    for blk in sorted(blocks):
        tile = ops.stack_tile(N, H, W, F1, S1, P1, F2, S2, P2, pool, t.nb,
                              t.uth, t.utw, *blk)
        NBc, MWc = tile["NBc"], tile["MWc"]
        RA = NBc * tile["MHc"] * MWc
        RR = -(-(-(-RA // t.cluster)) // 64) * 64
        for rank in range(t.cluster):
            p_lo = min(RA, rank * RR)
            p_hi = min(RA, p_lo + RR)
            for p0 in range(p_lo, p_hi, 128):
                KRA = 128 if p_hi - p0 > 64 else 64
                for k0 in range(0, K1, 16):
                    stage = np.zeros(ops._K5A_I8_X8 + 16 * 128, np.uint8)
                    owner = np.full(stage.size, -1, np.int32)
                    runs = []
                    for pt in range(128):
                        for xr, xq in ops.k5a_i8bf16_runs(KRA, pt):
                            pp, k = p0 + 8 * xq, k0 + xr
                            c, dy, dx = _k5a_kidx(k, F1)
                            rr = pp if pp < p_hi else p_lo
                            nl, mq = rr % NBc, rr // NBc
                            h = (tile["mh_lo"] + mq // MWc) * S1 - P1 + dy
                            w = (tile["mw_lo"] + mq % MWc) * S1 - P1 + dx
                            ok = (pp < p_hi and k < K1 and 0 <= h < H
                                  and 0 <= w < W)
                            dst = ops._K5A_I8_X8 + xr * KRA + 8 * xq
                            assert dst % 8 == 0
                            assert (owner[dst:dst + 8] == -1).all()
                            owner[dst:dst + 8] = pt
                            if ok:
                                e0 = ((c * H + h) * W + w) * N + tile["n0"] + nl
                                assert (base + e0) % 8 == 0
                                assert e0 % N + 8 <= N   # one run of n
                                stage[dst:dst + 8] = flat[e0:e0 + 8].view(
                                    np.uint8)
                            runs.append((pt, xr, xq, dst))
                    for pt, xr, xq, dst in runs:
                        # a thread widens only the bytes it copied
                        assert (owner[dst:dst + 8] == pt).all()
                        o = ops._K5A_I8_XB + 2 * ops.k5a_i8bf16_swz(KRA, xr,
                                                                    xq)
                        stage[o:o + 16] = widen_bytes(
                            stage[dst:dst + 8].view(np.int8).copy()).view(
                                np.uint8)
                    sl = stage[ops._K5A_I8_XB:ops._K5A_I8_X8].view(np.uint16)
                    want = np.zeros((16, KRA), np.int8)
                    for r in range(16):
                        k = k0 + r
                        c, dy, dx = _k5a_kidx(k, F1)
                        for pos in range(min(KRA, p_hi - p0)):
                            nl = (p0 + pos) % NBc
                            mq = (p0 + pos) // NBc
                            h = (tile["mh_lo"] + mq // MWc) * S1 - P1 + dy
                            w = (tile["mw_lo"] + mq % MWc) * S1 - P1 + dx
                            if k < K1 and 0 <= h < H and 0 <= w < W:
                                want[r, pos] = x[c, h, w, tile["n0"] + nl]
                    wb = _torch_bf16_bits(want.reshape(-1)).reshape(16, KRA)
                    for r in range(16):
                        for cq in range(KRA // 8):
                            o = ops.k5a_i8bf16_swz(KRA, r, cq)
                            np.testing.assert_array_equal(
                                sl[o:o + 8], wb[r, 8 * cq:8 * cq + 8])


# ---- (c) shared memory, the walk, the cluster schedule ----------------------


def _stack_launches():
    """(engine, case) of every stack launch of the packaged plans at the
    smoke's buckets, of the smoke's bf16 VGG16 plan, and the two smoke
    cases of the int8 stacks."""
    seen = set()
    for net, bucket in (("vgg16", 32), ("vgg16", 8), ("alexnet", 128),
                        ("resnet18", 32), ("resnet18", 8)):
        for kern, case in chip_smoke.plan_launches(net, bucket, "auto"):
            if kern.startswith("conv_stack"):
                seen.add((kern.split(".")[0], case))
    cfg, plan = chip_smoke.dtype_plan("vgg16", 32, "uniform", "auto")
    for kern, case in chip_smoke.fused_launches(cfg, plan):
        if kern.startswith("conv_stack"):
            seen.add((kern.split(".")[0], case))
    for kern, case in chip_smoke.STACK_INT8_OFF_PATH.items():
        seen.add((kern.split(".")[0], case))
    return sorted(seen, key=repr)


def _k5a_rstr(N, H, F1, S1, P1, F2, S2, P2, pool, t):
    """The slab row stride K5a's host code gives the tile (``forward`` in
    csrc/conv_stack_chwn.cu)."""
    Ho1 = conv_out_hw(H, F1, S1, P1)
    Ho2 = conv_out_hw(Ho1, F2, S2, P2)
    pF, pS = (pool[0], pool[1]) if pool else (0, 0)
    U = Ho2 if pool is None else (Ho2 - pF) // pS + 1
    hs = ops._mid_spans(U, t.uth, pF, pS, S2, F2, P2, Ho1)
    ws = ops._mid_spans(U, t.utw, pF, pS, S2, F2, P2, Ho1)
    r = min(t.nb, N) * max(h for (_, h), _ in hs) * max(w for (_, w), _
                                                        in ws)
    return -(-r // 4) * 4


def test_int8_stacks_fit_their_twins_shared_memory_at_every_tile():
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
            ns, slot = ops.k5a_i8bf16_stages(t.bm)
            assert ns >= 4 and ns * slot <= ops._cluster_ring_bytes(t.bm)
            assert ops.k5a_i8bf16_smem(t.bm, rstr, pool is not None) <= twin
            continue
        pF, pS = (pool[0], pool[1]) if pool else (0, 0)
        tile = (Ci, F1, S1, F2, S2, pF, pS, t.bm, t.nb, t.uth, t.utw)
        twin = ops.k5b_layout(*tile)[1]
        assert twin == t.smem_bytes, case
        for want8 in (False, True):
            for want4 in (False, True):
                _, stage_a, stage_b, slot, mode, _ = ops.k5b_i8bf16_layout(
                    *tile, want8, want4)
                assert max(stage_a, stage_b) <= slot, case
                assert ops.k5b_i8bf16_smem(*tile, want8, want4) <= twin


@pytest.mark.parametrize("nsl1,passes,Cm,F2,kb", [
    (2, 4, 64, 3, 4), (9, 1, 160, 3, 2), (3, 0, 96, 1, 1), (1, 2, 10, 3, 4)])
def test_k5a_stage_walk_is_the_consumers_order(nsl1, passes, Cm, F2, kb):
    """Per chunk of 64 mid channels: each pass's k16 slices of conv1, then
    conv2's phase-B stages of kb k16 slices each (``IShape::KB``)."""
    nA = passes * nsl1
    nB = -(-64 * F2 * F2 // (16 * kb))
    order = []
    for cm0 in range(0, Cm, 64):
        cmn = min(64, Cm - cm0)
        order += [(cm0 // 64, p, s, -1) for p in range(passes)
                  for s in range(nsl1)]
        order += [(cm0 // 64, 0, 0, q) for q in range(-(-cmn * F2 * F2
                                                         // (16 * kb)))]
    chunks = -(-Cm // 64)
    nsl = ((chunks - 1) * (nA + nB) + nA
           + -(-(Cm - (chunks - 1) * 64) * F2 * F2 // (16 * kb)))
    assert len(order) == nsl
    assert [ops.k5a_i8bf16_stage(sl, nsl1, nA, nB)
            for sl in range(nsl)] == order
    # the producers' division-free walk visits the same stages
    walk = [ops.k5a_i8bf16_stage(0, nsl1, nA, nB)]
    while len(walk) < nsl:
        walk.append(ops.k5a_i8bf16_step(walk[-1], nsl1, nA, nB))
    assert walk == order


def _run_k5a_protocol(CL, nA, nB, chunks, last_b, NS):
    """Run K5a int8->bf16's barrier protocol for one cluster of CL ranks
    (each a producer and a consumer, in lockstep turns): the ring's FULL
    and EMPTY barriers and the cluster barrier's phases (two a chunk), the
    producers' placed as ``phases`` places them.  Returns True when every
    role reaches its end, False on a deadlock."""
    per = nA + nB
    nsl = (chunks - 1) * per + nA + last_b
    first_b = [c * per + nA for c in range(chunks)]
    arrivals = [0] * (2 * chunks)   # of the cluster barrier's phases

    def producer(r):
        announced = [False] * nsl
        yield ("arrive", 0)
        pc = 0
        for sl in range(nsl):
            announced[sl] = True
            yield ("full", sl)
            nx = sl + NS - 1
            if nx < nsl:
                while pc < chunks and first_b[pc] + NS - 1 <= nx:
                    yield ("wait", 2 * pc)
                    yield ("arrive", 2 * pc + 1)
                    yield ("wait", 2 * pc + 1)
                    pc += 1
                    if pc < chunks:
                        yield ("arrive", 2 * pc)
                if nx >= NS:
                    yield ("empty_wait", nx - NS)
        while pc < chunks:
            yield ("wait", 2 * pc)
            yield ("arrive", 2 * pc + 1)
            yield ("wait", 2 * pc + 1)
            pc += 1
            if pc < chunks:
                yield ("arrive", 2 * pc)

    def consumer(r):
        sl = 0
        for c in range(chunks):
            if c:
                yield ("wait", 2 * c - 1)
            for _ in range(nA):
                yield ("full_wait", sl)
                sl += 1
            yield ("arrive", 2 * c)
            yield ("wait", 2 * c)
            yield ("arrive", 2 * c + 1)
            for _ in range(nB if c < chunks - 1 else last_b):
                yield ("full_wait", sl)
                sl += 1
        yield ("wait", 2 * chunks - 1)

    roles = {}
    for r in range(CL):
        roles[("p", r)] = producer(r)
        roles[("c", r)] = consumer(r)
    full = {r: set() for r in range(CL)}
    consumed = {r: 0 for r in range(CL)}
    pending = {k: next(g) for k, g in roles.items()}
    total = 2 * CL                  # every role arrives on every phase
    while pending:
        moved = False
        for key in list(pending):
            kind, v = pending[key]
            r = key[1]
            if kind == "arrive":
                arrivals[v] += 1
                ok = True
            elif kind == "wait":
                ok = arrivals[v] == total
            elif kind == "full":
                full[r].add(v)
                ok = True
            elif kind == "full_wait":
                ok = v in full[r]
                if ok:
                    consumed[r] = v + 1
            else:                   # empty_wait: stage v consumed
                ok = consumed[r] > v
            if ok:
                moved = True
                try:
                    pending[key] = next(roles[key])
                except StopIteration:
                    del pending[key]
        if not moved:
            return False
    return True


@pytest.mark.parametrize("CL,nA,nB,chunks,last_b,NS", [
    (1, 8, 9, 1, 9, 5), (3, 4, 9, 3, 9, 5), (3, 0, 18, 2, 9, 4),
    (8, 2, 4, 4, 1, 5), (2, 6, 1, 3, 1, 4), (4, 1, 36, 8, 9, 5)])
def test_k5a_barrier_schedule_runs_to_its_end(CL, nA, nB, chunks, last_b,
                                              NS):
    """The producers' cluster phases (``phases`` in the kernel, NS - 1
    stages after each chunk's first phase-B stage) never wait on a stage
    they have not announced: the protocol completes, also where a rank has
    no phase-A share (nA 0) or a chunk fewer B stages than the ring."""
    assert _run_k5a_protocol(CL, nA, nB, chunks, last_b, NS)
