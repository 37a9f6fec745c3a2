#!/usr/bin/env python3
"""Time the port's tensor-core kernels K1, K2, K5b, K10 and K12 and the
softmax kernels K4 and K8 against variants of their sources, and the
tensor-core kernels under other block tiles, on one CUDA card.

    python3 tools/kernel_variants.py [--tiles] [VARIANT.cu ...]

Each VARIANT stands in for ``conv/csrc/conv_chwn.cu`` (K1, the direct
CHWN conv), ``conv/csrc/conv_nchw.cu`` (K2, the virtual-im2col NCHW
conv), ``conv/csrc/conv_stack_nchw.cu`` (K5b, the NCHW conv -> conv
stack), ``matmul/csrc/matmul.cu`` (K10, the tiled matmul),
``crossentropy/csrc/crossentropy.cu`` (K12, the fused unembed + cross
entropy) or ``softmax/csrc/softmax.cu`` (K4, the row softmax, and K8, the
row cross entropy), whichever entry points it defines: it is built by nvcc
into a library of its own and swapped in for those entry points.  K1, K2,
K4 and K5b variants run each distinct launch of that kernel on
``chip_smoke.py``'s main path (fused serving, the unfused modes,
training), K4 also Fig. 13's twelve shapes, K8 the smoke's one case, K10
variants the 12 Table-1 layers' matmuls, K12 variants the smoke's three LM
head cases;
the checkout's kernel and the variants run in turns (checkout, variants,
variants reversed, checkout), each held against the plain version as
``chip_smoke.py`` holds it, and the mean ms of each launch and the totals
are printed (for K4 and K8 the device time, ``chip_smoke.device_ms``: a
CUDA graph of 100 launches replayed, and the library call's beside it).
The kernels compared are those a variant is given for; with no variant
and no ``--tiles``, the checkout's seven.

``--tiles`` times the checkout's kernels under other block tiles beside
the one their tiling picks, each launch held against the plain version
(K2, K5b) or the float64 product (K10): AlexNet's conv2 with its 3/2 max
pool (N 128) under a few K1 tiles; each distinct K2 main-path shape under
some ten tiles (the six of least modeled time from ``conv_ops.k2_tilings``
and the best-modeled of several kinds for each bm), with the pick's time
over the fastest's; each K5b main-path shape under the four
tiles of least modeled time and the best one within 1.25x the direct
FLOPs; each Table-1 matmul under K10's three tiles and split counts of K
up to 16; and least-squares fits of K2's and ``matmul_tilings``' cost
constants to those times.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.layout import perm_between  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv import ops as conv_ops  # noqa: E402
from repro_torch.kernels.conv.backward import dgrad_shape  # noqa: E402
from repro_torch.kernels.conv.ref import conv_ref, conv_stack_ref  # noqa: E402
from repro_torch.kernels.crossentropy.ops import fused_xent  # noqa: E402
from repro_torch.kernels.crossentropy.ref import xent_ref  # noqa: E402
from repro_torch.kernels.matmul import ops as matmul_ops  # noqa: E402
from repro_torch.shapes import conv_out_hw  # noqa: E402

K1, K2, K12 = "conv_chwn_forward", "conv_nchw_forward", "xent_forward"
K5B, K10 = "conv_stack_nchw_forward", "matmul_forward"
K4, K8 = "softmax_forward", "softmax_xent_forward"
# the csrc directory of the source that defines each entry point
_SRC_DIR = {K1: "conv/csrc", K2: "conv/csrc", K5B: "conv/csrc",
            K10: "matmul/csrc", K12: "crossentropy/csrc",
            K4: "softmax/csrc", K8: "softmax/csrc"}
# AlexNet conv2 (N, Ci, H, Co, F, S, pad) with its 3/2 max pool, and the
# block tiles (bm, nb, ph, pw) timed beside conv_tiling's
CONV2 = (128, 96, 27, 256, 5, 1, 2)
TILES = [(64, 8, 3, 4), (64, 8, 4, 3), (128, 8, 2, 2), (64, 16, 2, 3),
         (128, 4, 3, 3), (64, 8, 2, 2), (64, 32, 1, 2)]
# K10's split counts of K timed under each tile
SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


class _Swapped:
    """The kernel library with one entry point taken from ``variant``."""

    def __init__(self, main, entry, variant):
        self.main, self.entry, self.variant = main, entry, variant

    def __getattr__(self, name):
        return getattr(self.variant if name == self.entry else self.main,
                       name)


def build_variant(src: Path, out_dir: Path):
    """(entry points, loaded library) of one variant source."""
    so = out_dir / (src.stem + ".so")
    text = src.read_text()
    entries = [e for e in _SRC_DIR if f"int {e}(" in text]
    inc = REPO / "src/repro_torch/kernels" / _SRC_DIR[entries[0]]
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(inc),
                    "-shared", "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    for entry in entries:
        fn = getattr(lib, entry)
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
    return entries, lib


def main_path_cases(kernel: str):
    """{case: launches} of ``kernel`` over chip_smoke.py's main path (Table
    1 aside)."""
    mult = {}

    def add(keys, times=1):
        for kern, case in keys:
            if kern == kernel:
                mult[case] = mult.get(case, 0) + times

    for network, cap, n_req, stack in cs.SERVED:
        for B in cs.batch_sizes(n_req, cap):
            bucket = cs.PlanCache(str(cs.packaged_plans(network)),
                                  max_bucket=cap).bucket(B)
            add(cs.plan_launches(network, bucket, stack))
    for network, batch in cs.UNFUSED:
        for mode in cs.MODES:
            add(cs.unfused_launches(network, batch, mode)[1])
    for network, batch in cs.TRAINED:
        add(cs.train_launches(network, batch), cs.TRAIN_STEPS)
    return mult


def k1_launch(case, dev, seed) -> dict:
    if case[0] == "save_act":
        return cs.save_act_case("conv_chwn", case, dev, seed)
    if case[0] == "dgrad":
        return cs.dgrad_case("conv_chwn", case, dev, seed)
    return cs.conv_case("conv_chwn", case, dev, seed)


def k2_launch(case, dev, seed) -> dict:
    if case[0] == "save_act":
        return cs.save_act_case("conv_nchw", case, dev, seed)
    if case[0] == "dgrad":
        return cs.dgrad_case("conv_nchw", case, dev, seed)
    return cs.conv_case("conv_nchw", case, dev, seed)


def k5b_launch(case, dev, seed) -> dict:
    return cs.stack_case("conv_stack_nchw", case, dev, seed)


def k10_cases():
    return {layer.name: 1 for layer in cs.CONV_LAYERS}


def k10_launch(name, dev, seed) -> dict:
    """One Table-1 layer's matmul (its patch matrix @ the weights' view),
    held against the float64 product, beside ``torch.matmul``."""
    layer = next(c for c in cs.CONV_LAYERS if c.name == name)
    gen = torch.Generator(device=dev).manual_seed(100 + seed)
    x = torch.randn(layer.N, layer.Ci, layer.HW, layer.HW, device=dev,
                    generator=gen)
    w = torch.randn(layer.Co, layer.Ci, layer.F, layer.F, device=dev,
                    generator=gen) / math.sqrt(layer.Ci * layer.F ** 2)
    patches, _ = cs.im2col_nchw(x, layer.F, layer.S, layer.pad)
    wmat = w.reshape(layer.Co, -1).T
    got = cs.matmul(patches, wmat)
    err = cs._scaled_err(got, patches.double() @ wmat.double())
    assert err <= cs.TC_FP32_TOL, (name, err)
    return {"ms": cs.cuda_ms(lambda: cs.matmul(patches, wmat)),
            "library_ms": cs.cuda_ms(lambda: torch.matmul(patches, wmat))}


def k12_launch(case, dev, seed) -> dict:
    h, table, labels = cs._xent_inputs(case, dev, seed)
    cap, bf16 = case[4], case[5] == torch.bfloat16
    tol = (0.0, cs.BF16_ATOL) if bf16 else (cs.LM_TOL, cs.LM_TOL)
    torch.testing.assert_close(fused_xent(h, table, labels, cap),
                               xent_ref(h, table, labels, cap), rtol=tol[0],
                               atol=tol[1])

    def library():
        z = h @ table.T
        if cap is not None:
            z = cap * torch.tanh(z / cap)
        return torch.nn.functional.cross_entropy(z.float(), labels,
                                                 reduction="none")

    return {"ms": cs.cuda_ms(lambda: fused_xent(h, table, labels, cap)),
            "library_ms": cs.cuda_ms(library)}


def k4_launch(case, dev, seed, scale: float = 4.0) -> dict:
    """One K4 case (chip_smoke's logits: randn x 4 on the main path,
    standard normal, ``scale`` 1, for Fig. 13's) held against the plain
    version; device times of the kernel and ``torch.softmax``."""
    rows, cols = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, cols, device=dev, generator=gen) * scale
    torch.testing.assert_close(cs.softmax(x), cs.softmax_ref(x), rtol=0,
                               atol=cs.SOFTMAX_ATOL)
    return {"ms": cs.device_ms(lambda: cs.softmax(x)),
            "library_ms": cs.device_ms(lambda: torch.softmax(x, dim=-1))}


def k8_launch(case, dev, seed) -> dict:
    """K8 on chip_smoke's case, labels inside and outside [0, C), held
    against the plain version; device times of the kernel and
    ``cross_entropy``."""
    rows, cols = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, cols, device=dev, generator=gen) * 4
    labels = torch.randint(-1, cols + 1, (rows,), device=dev, generator=gen)
    torch.testing.assert_close(cs.softmax_xent(x, labels),
                               cs.softmax_xent_ref(x, labels), rtol=1e-5,
                               atol=1e-5)
    inside = labels.clamp(0, cols - 1)
    return {"ms": cs.device_ms(lambda: cs.softmax_xent(x, labels)),
            "library_ms": cs.device_ms(lambda: torch.nn.functional
                                       .cross_entropy(x, inside,
                                                      reduction="none"))}


def compare(label, entry, cases, launch, variants, dev):
    """Each case through the checkout's kernel and the variants of
    ``entry``, in turns; prints mean ms per case and the totals."""
    main = _build.library()
    libs = {"checkout": None, **variants}
    total = {k: 0.0 for k in libs}
    lib_total = 0.0
    order = list(libs) + list(libs)[::-1]
    for i, (case, n) in enumerate(cases.items()):
        ms = {k: [] for k in libs}
        for name in order:
            _build._lib = (main if libs[name] is None
                           else _Swapped(main, entry, libs[name]))
            try:
                m = launch(case, dev, i)
                ms[name].append(m["ms"])
                lib_ms = m["library_ms"]
            except (AssertionError, RuntimeError) as e:
                print(f"  {name}: FAILED {e!r:.200}", flush=True)
                ms[name].append(float("nan"))
        _build._lib = main
        for k, v in ms.items():
            total[k] += n * sum(v) / len(v)
        lib_total += n * lib_ms
        print(f"{label} {case} x{n}: " + " ".join(
            f"{k}={sum(v) / len(v):.4f}" for k, v in ms.items())
            + f" library={lib_ms:.4f}", flush=True)
    print(f"{label} over {sum(cases.values())} launches, ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in total.items())
        + f"; library {lib_total:.3f}", flush=True)


def k1_tiles(dev):
    N, Ci, H, Co, F, S, pad = CONV2
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(Ci, H, H, N, device=dev, generator=gen)
    wk = torch.randn(Ci, F, F, Co, device=dev, generator=gen) \
        / math.sqrt(Ci * F * F)
    pool = (3, 2, "max")
    want = conv_ref(x, wk.permute(3, 0, 1, 2), S, pad, relu=True, pool=pool,
                    src_layout="CHWN", dst_layout="CHWN")
    y = torch.empty_like(want)
    fn = getattr(_build.library(), K1)
    st = _build.stream_of(x.get_device())
    t = conv_ops.conv_tiling(N, Ci, H, H, Co, F, S, pad, pool)
    print(f"AlexNet conv2 + 3/2 pool: conv_tiling picks "
          f"{(t.bm, t.nb, t.ph, t.pw)}", flush=True)
    for tile in TILES:
        def run():
            return fn(x.data_ptr(), wk.data_ptr(), None, None, y.data_ptr(),
                      None, N, Ci, H, H, Co, F, S, pad, 3, 2, 0, 1, 0, 0, 0,
                      *tile, st)
        _build.check(K1, run())
        torch.testing.assert_close(y, want, rtol=cs.CONV_RTOL,
                                   atol=cs.CONV_ATOL)
        print(f"  tile (bm, nb, ph, pw) {tile}: {cs.cuda_ms(run):.4f} ms",
              flush=True)


class _Forced:
    """``module.<name>`` (a tiling function) answers ``tiling`` while the
    block runs."""

    def __init__(self, module, name, tiling):
        self.module, self.name, self.tiling = module, name, tiling

    def __enter__(self):
        self.saved = getattr(self.module, self.name)
        setattr(self.module, self.name, lambda *a, **k: self.tiling)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.saved)


def k5b_tiles(dev):
    """Each K5b main-path shape under the four tiles of least modeled time
    (``conv_ops.k5b_tilings``) and the best one that executes at most 1.25x
    the direct FLOPs, beside the one ``stack_tiling`` picks."""
    for i, (case, n) in enumerate(main_path_cases("conv_stack_nchw")
                                  .items()):
        (N, Ci, H, Cm, Co, F1, S1, P1, F2, S2, P2, pool, relu1, relu2,
         rlay, src, dst) = case
        shape = (N, Ci, H, H, Cm, F1, S1, P1, Co, F2, S2, P2, pool)
        cands = sorted(conv_ops.k5b_tilings(*shape), key=lambda c: c[0])
        picked = conv_ops.stack_tiling("NCHW", *shape)
        within = [c for c in cands
                  if c[1].executed_flops <= 1.25 * c[1].direct_flops][:1]
        chosen = [c for c in cands if c[1] == picked] + cands[:4] + within
        gen = torch.Generator(device=dev).manual_seed(200 + i)
        Ho2 = conv_out_hw(conv_out_hw(H, F1, S1, P1), F2, S2, P2)
        x = torch.randn(N, Ci, H, H, device=dev, generator=gen) \
            .permute(perm_between("NCHW", src)).contiguous()
        w1 = torch.randn(Cm, Ci, F1, F1, device=dev, generator=gen) \
            / math.sqrt(Ci * F1 * F1)
        w2 = torch.randn(Co, Cm, F2, F2, device=dev, generator=gen) \
            / math.sqrt(Cm * F2 * F2)
        r = (torch.randn(N, Co, Ho2, Ho2, device=dev, generator=gen)
             .permute(perm_between("NCHW", rlay)).contiguous()
             if rlay else None)
        kw = dict(relu1=relu1, relu2=relu2, pool=pool, res=r,
                  res_layout=rlay or "NCHW", src_layout=src, dst_layout=dst)
        want = conv_stack_ref(x, w1, w2, S1, P1, S2, P2, **kw)
        print(f"K5b {shape} x{n}:", flush=True)
        seen = set()
        for modeled, t in chosen:
            key = (t.bm, t.nb, t.uth, t.utw)
            if key in seen:
                continue
            seen.add(key)
            with _Forced(conv_ops, "stack_tiling", t):
                def run():
                    return conv_ops.conv_stack_nchw(x, w1, w2, S1, P1, S2,
                                                    P2, **kw)
                torch.testing.assert_close(run(), want, rtol=cs.CONV_RTOL,
                                           atol=cs.CONV_ATOL)
                ms = cs.cuda_ms(run)
            print(f"  tile (bm, nb, uth, utw) {key}: blocks {t.blocks}, "
                  f"executed/direct "
                  f"{t.executed_flops / t.direct_flops:.4f}, modeled "
                  f"{modeled:.1f}: {ms:.4f} ms"
                  + (" [picked]" if t == picked else ""), flush=True)


def _k2_shape(case):
    """The ``nchw_tiling`` shape of one K2 launch of the main path: a
    forward or save_act case as the conv it runs, a dgrad case as the
    stride-1 conv of the dilated gradient (``dgrad_problem``)."""
    if case[0] == "dgrad":
        N, Ci, H, Co, F, S, pad = case[1:8]
        return (*dgrad_shape(N, Ci, H, H, Co, F, S, pad), None)
    if case[0] == "save_act":
        case = case[1:]
    N, Ci, H, Co, F, S, pad, pool = case[:8]
    return (N, Ci, H, H, Co, F, S, pad, tuple(pool) if pool else None)


def _k2_problem(case, dev, seed):
    """(x, w, S, pad, kwargs) of ``_conv("NCHW", ...)`` for one K2 launch
    of the main path, seeded data."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    if case[0] == "dgrad":
        N, Ci, H, Co, F, S, pad, g_lay, dst = case[1:]
        Ho = conv_out_hw(H, F, S, pad)
        g = torch.randn(N, Co, Ho, Ho, device=dev, generator=gen) \
            .permute(perm_between("NCHW", g_lay)).contiguous()
        w = torch.randn(Co, Ci, F, F, device=dev, generator=gen) \
            / math.sqrt(Ci * F * F)
        gd, wt, p = cs.dgrad_problem(g, w, (H, H), S, pad, g_lay)
        return gd, wt, 1, p, dict(src_layout=g_lay, dst_layout=dst)
    if case[0] == "save_act":
        case = case[1:]
    N, Ci, H, Co, F, S, pad, pool, relu, rlay, src, dst = case
    Ho = conv_out_hw(H, F, S, pad)
    x = torch.randn(N, Ci, H, H, device=dev, generator=gen) \
        .permute(perm_between("NCHW", src)).contiguous()
    w = torch.randn(Co, Ci, F, F, device=dev, generator=gen) \
        / math.sqrt(Ci * F * F)
    r = (torch.randn(N, Co, Ho, Ho, device=dev, generator=gen)
         .permute(perm_between("NCHW", rlay)).contiguous() if rlay else None)
    return x, w, S, pad, dict(relu=relu, pool=pool, res=r,
                              res_layout=rlay or "NCHW", src_layout=src,
                              dst_layout=dst)


def _k2_sweep(cands, picked):
    """The tiles timed for one K2 shape: the one picked, the six of least
    modeled time,
    then for each bm the least-modeled tile overall, with 2 or 4 channel
    groups a stage, of one image, of 4 or more, of the full width, of one
    unit row, and of at most 64 units."""
    cands = sorted(cands, key=lambda c: c[0])
    out, seen = [], set()

    def add(c):
        t = c[1]
        key = (t.bm, t.nb, t.uth, t.utw, t.tr, t.ga)
        if key not in seen:
            seen.add(key)
            out.append(c)

    for c in [c for c in cands if c[1] == picked] + cands[:6]:
        add(c)
    full = max(c[1].utw for c in cands)
    preds = [lambda t: True, lambda t: t.ga == 2, lambda t: t.ga == 4,
             lambda t: t.nb == 1, lambda t: t.nb >= 4,
             lambda t: t.utw == full, lambda t: t.uth == 1,
             lambda t: t.nb * t.uth * t.utw <= 64]
    for bm in conv_ops._K2_BMS:
        for pred in preds:
            m = [c for c in cands if c[1].bm == bm and pred(c[1])]
            if m:
                add(m[0])
    return out


def k2_tiles(dev):
    """Each distinct K2 shape of the main path (forward, save_act and
    dgrad launches alike) under the tiles of ``_k2_sweep`` (from
    ``conv_ops.k2_tilings``), the one ``nchw_tiling`` picks among them; then
    the pick's time over the fastest tile's, shape by shape and over the
    launches, and ``fit_k2`` of the times."""
    groups = {}
    for case, n in main_path_cases("conv_nchw").items():
        first, count = groups.get(_k2_shape(case), (case, 0))
        groups[_k2_shape(case)] = (first, count + n)
    ratios, tot_pick, tot_best, timed = [], 0.0, 0.0, []
    for i, (shape, (case, launches)) in enumerate(groups.items()):
        x, w, S, pad, kw = _k2_problem(case, dev, 400 + i)
        cands = conv_ops.k2_tilings(*shape)
        picked = conv_ops.nchw_tiling(*shape)
        want = conv_ref(x, w, S, pad, **kw)
        print(f"K2 {shape} x{launches}:", flush=True)
        # each tile timed twice, the list forwards then backwards, so that
        # the order (the pick comes first) biases none: the mean is kept
        sweep = _k2_sweep(cands, picked)
        runs = {}
        for modeled, t in sweep + sweep[::-1]:
            key = (t.bm, t.nb, t.uth, t.utw, t.tr, t.ga)
            with _Forced(conv_ops, "nchw_tiling", t):
                def run():
                    return conv_ops._conv("NCHW", x, w, S, pad, **kw)
                if key not in runs:
                    torch.testing.assert_close(run(), want,
                                               rtol=cs.CONV_RTOL,
                                               atol=cs.CONV_ATOL)
                runs.setdefault(key, []).append(cs.cuda_ms(run))
        times = {}
        for modeled, t in sweep:
            key = (t.bm, t.nb, t.uth, t.utw, t.tr, t.ga)
            times[key] = sum(runs[key]) / len(runs[key])
            timed.append((shape, t, times[key]))
            print(f"  tile (bm, nb, uth, utw, tr, ga) {key}: "
                  f"blocks {t.blocks}, executed/direct "
                  f"{t.executed_flops / t.direct_flops:.4f}, modeled "
                  f"{modeled:.1f}: {times[key]:.4f} ms"
                  + (" [picked]" if t == picked else ""), flush=True)
        pick = times[(picked.bm, picked.nb, picked.uth, picked.utw,
                      picked.tr, picked.ga)]
        best = min(times.values())
        ratios.append((pick / best, shape))
        tot_pick += launches * pick
        tot_best += launches * best
        print(f"  pick {pick / best:.3f}x the fastest tile timed", flush=True)
    worst = max(ratios, key=lambda r: r[0])
    print(f"K2 tiles over {len(ratios)} shapes: the pick within "
          f"{100 * (worst[0] - 1):.1f} % of the fastest tile timed on every "
          f"shape (worst {worst[1]}); over the main path's launches "
          f"{tot_pick:.3f} ms picked, {tot_best:.3f} ms fastest", flush=True)
    fit_k2(timed)


# the constants of K2's tile model (``conv_ops._k2_block_cost``) that
# fit_k2 fits, beside the seconds of its unit
K2_MODEL = ("_K2_STAGE_COST", "_K2_COPY_COST", "_K2_BYTE_COST",
            "_K2_XBYTE_COST", "_K2_BLOCK_COST", "_K2_OVERLAP")


def _k2_modeled(shape, t) -> float:
    """``k2_tilings``' modeled time of tile ``t`` alone (units of the
    model), with the constants as ``conv_ops`` holds them now."""
    N, Ci, H, W, Co, F, S, pad, pool = shape
    Ho, Wo = conv_out_hw(H, F, S, pad), conv_out_hw(W, F, S, pad)
    pF, pS = (pool[0], pool[1]) if pool else (0, 0)
    UH, UW = (((Ho - pF) // pS + 1, (Wo - pF) // pS + 1) if pool
              else (Ho, Wo))
    hs = [(conv_ops._unit_rows(u, pF, pS), c)
          for u, c in conv_ops._spans(UH, t.uth)]
    ws = [(conv_ops._unit_rows(u, pF, pS), c)
          for u, c in conv_ops._spans(UW, t.utw)]
    tiles = work = 0
    for nbc, cn in conv_ops._spans(N, t.nb):
        for rh, ch in hs:
            for rw, cw in ws:
                tiles += cn * ch * cw
                work += cn * ch * cw * conv_ops._k2_block_cost(
                    Ci, W, F, S, t.bm, t.tr, t.ga, nbc, rh, rw,
                    conv_ops._k2_xw(rw, S, F), Ci * F * F)
    blocks = tiles * -(-Co // t.bm)
    return -(-blocks // conv_ops._SMS) * work / tiles


def fit_k2(rows):
    """Least-squares fit (in log time) of K2's tile-model constants
    (``K2_MODEL``) and the seconds of its unit to timed tiles ``(shape,
    NchwTiling, ms)``; prints them, the rms log error, and per shape the
    fitted model's pick among the timed tiles over the fastest."""
    import numpy as np
    from scipy.optimize import least_squares

    def use(p):
        for name, v in zip(K2_MODEL, p[1:]):
            setattr(conv_ops, name, v)

    def resid(p):
        use(p)
        return [math.log(p[0] * _k2_modeled(s, t) / (ms * 1e-3))
                for s, t, ms in rows]

    saved = [getattr(conv_ops, n) for n in K2_MODEL]
    fit = least_squares(resid, [1e-8] + saved,
                        bounds=([1e-10, 0, 0, 0, 0, 0, 1.0],
                                [1e-5, 2000, 100, 1, 1, 1e5, 64]))
    rms = float(np.sqrt(np.mean(np.square(fit.fun))))
    print("K2 fit over {} tiles: unit {:.4g} s; ".format(len(rows), fit.x[0])
          + ", ".join(f"{n} {v:.4g}" for n, v in zip(K2_MODEL, fit.x[1:]))
          + f"; rms log error {rms:.3f}", flush=True)
    use(fit.x)
    by = {}
    for s, t, ms in rows:
        by.setdefault(s, []).append((_k2_modeled(s, t), ms, t))
    for s, v in by.items():
        pick, best = min(v, key=lambda r: r[0]), min(v, key=lambda r: r[1])
        print(f"  fitted pick {s}: {pick[1] / best[1]:.3f}x the fastest",
              flush=True)
    use([None] + saved)
    return fit.x


def k10_tiles(dev):
    """Each Table-1 layer's matmul (fp32) under K10's three tiles and the
    split counts of ``SPLITS``, beside the one ``matmul_tiling`` picks;
    then ``fit_k10`` of the times."""
    rows = []
    for i, layer in enumerate(cs.CONV_LAYERS):
        gen = torch.Generator(device=dev).manual_seed(300 + i)
        x = torch.randn(layer.N, layer.Ci, layer.HW, layer.HW, device=dev,
                        generator=gen)
        w = torch.randn(layer.Co, layer.Ci, layer.F, layer.F, device=dev,
                        generator=gen) / math.sqrt(layer.Ci * layer.F ** 2)
        patches, _ = cs.im2col_nchw(x, layer.F, layer.S, layer.pad)
        wmat = w.reshape(layer.Co, -1).T
        (M, K), N = patches.shape, wmat.shape[1]
        want = patches.double() @ wmat.double()
        picked = matmul_ops.matmul_tiling(M, N, K)
        print(f"K10 {layer.name} [{M}, {K}] @ [{K}, {N}]:", flush=True)
        for t in matmul_ops.matmul_tilings(M, N, K):
            if t.splits not in SPLITS and t != picked:
                continue
            with _Forced(matmul_ops, "matmul_tiling", t):
                err = cs._scaled_err(cs.matmul(patches, wmat), want)
                assert err <= cs.TC_FP32_TOL, (layer.name, t, err)
                ms = cs.cuda_ms(lambda: cs.matmul(patches, wmat))
            rows.append((M, N, t, ms))
            print(f"  tile {t.bm}x{t.bn} splits {t.splits}: blocks "
                  f"{t.blocks}, waves {t.waves}, modeled "
                  f"{1e3 * t.seconds:.4f} ms: {ms:.4f} ms"
                  + (" [picked]" if t == picked else ""), flush=True)
    fit_k10(rows)


def fit_k10(rows):
    """Least-squares fit (in log time) of ``matmul_tilings``' fp32 cost
    constants to timed launches ``(M, N, MatmulTiling, ms)``: the seconds of
    a 128 x 128 slice, the two narrower tiles' slice costs beside it, a
    block's fill in slices and the rate the split partials move at."""
    import numpy as np
    from scipy.optimize import least_squares

    def model(p, M, N, t):
        slice_s, c_wide, c_narrow, fill, tbs = p
        cost = {(128, 128): 1.0, (128, 64): c_wide,
                (64, 64): c_narrow}[(t.bm, t.bn)]
        per = t.k_per_split // matmul_ops._DEPTH[torch.float32]
        sec = t.waves * (per * cost + fill) * slice_s
        if t.splits > 1:
            sec += (t.splits + 1) * 4.0 * M * N / (tbs * 1e12)
        return sec

    def resid(p):
        return [math.log(model(p, M, N, t) / (ms * 1e-3))
                for M, N, t, ms in rows]

    fit = least_squares(resid, [2.8e-6, 0.6, 0.4, 2.0, 3.0],
                        bounds=([1e-7, 0.1, 0.05, 0.0, 0.3],
                                [1e-4, 2.0, 2.0, 50.0, 10.0]))
    rms = float(np.sqrt(np.mean(np.square(fit.fun))))
    print("K10 fit over {} launches: slice {:.3e} s, 128x64 {:.3f}, 64x64 "
          "{:.3f}, fill {:.3f} slices, partials {:.3f} TB/s; rms log error "
          "{:.3f}".format(len(rows), *fit.x, rms), flush=True)
    return fit.x


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*", type=Path)
    ap.add_argument("--tiles", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"card: {cs.card_line()}", flush=True)
    out = _build.build().parent / "variants"
    out.mkdir(exist_ok=True)
    built = {v.stem: build_variant(v, out) for v in args.variants}
    by_entry = {e: {k: lib for k, (ens, lib) in built.items() if e in ens}
                for e in _SRC_DIR}
    runs = {"K1": (K1, lambda: main_path_cases("conv_chwn"), k1_launch),
            "K2": (K2, lambda: main_path_cases("conv_nchw"), k2_launch),
            "K5b": (K5B, lambda: main_path_cases("conv_stack_nchw"),
                    k5b_launch),
            "K10": (K10, k10_cases, k10_launch),
            "K12": (K12, lambda: {c: 1 for c in cs.lm_cases()[1]},
                    k12_launch),
            "K4": (K4, lambda: main_path_cases("softmax"), k4_launch),
            "K4 Fig. 13": (K4, lambda: {(l.N, l.C): 1
                                        for l in cs.SOFTMAX_LAYERS},
                           lambda c, d, i: k4_launch(c, d, i, 1.0)),
            "K8": (K8, lambda: {cs.K8_CASE: 1}, k8_launch)}
    chosen = [k for k, (e, _, _) in runs.items() if by_entry[e]]
    if not chosen and not args.tiles:
        chosen = list(runs)
    with torch.inference_mode():
        for label in chosen:
            entry, cases, launch = runs[label]
            compare(label, entry, cases(), launch, by_entry[entry], dev)
        if args.tiles:
            k1_tiles(dev)
            k2_tiles(dev)
            k5b_tiles(dev)
            k10_tiles(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
