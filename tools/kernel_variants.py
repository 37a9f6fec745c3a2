#!/usr/bin/env python3
"""Time the port's tensor-core kernels K1 and K12 against variants of
their sources, on one CUDA card.

    python3 tools/kernel_variants.py [--tiles] [VARIANT.cu ...]

Each VARIANT stands in for ``conv/csrc/conv_chwn.cu`` (K1, the direct
CHWN conv) or ``crossentropy/csrc/crossentropy.cu`` (K12, the fused
unembed + cross entropy), whichever entry point it defines: it is built
by nvcc into a library of its own and swapped in for that entry point.
K1 variants run each distinct K1 launch of ``chip_smoke.py``'s main path
(fused serving, the unfused modes, training: 34 shapes, 85 launches), K12
variants the smoke's three LM head cases; the checkout's kernel and the
variants run in turns (checkout, variants, variants reversed, checkout),
each held against the plain version as ``chip_smoke.py`` holds it, and
the mean ms of each launch and the totals are printed.  ``--tiles`` also
times AlexNet's conv2 with its 3/2 max pool (N 128) under a few K1 block
tiles beside the one ``conv_tiling`` picks.  Needs a CUDA device and
nvcc.
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
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv.ops import conv_tiling  # noqa: E402
from repro_torch.kernels.conv.ref import conv_ref  # noqa: E402
from repro_torch.kernels.crossentropy.ops import fused_xent  # noqa: E402
from repro_torch.kernels.crossentropy.ref import xent_ref  # noqa: E402

K1, K12 = "conv_chwn_forward", "xent_forward"
# AlexNet conv2 (N, Ci, H, Co, F, S, pad) with its 3/2 max pool, and the
# block tiles (bm, nb, ph, pw) timed beside conv_tiling's
CONV2 = (128, 96, 27, 256, 5, 1, 2)
TILES = [(64, 8, 3, 4), (64, 8, 4, 3), (128, 8, 2, 2), (64, 16, 2, 3),
         (128, 4, 3, 3), (64, 8, 2, 2), (64, 32, 1, 2)]


class _Swapped:
    """The kernel library with one entry point taken from ``variant``."""

    def __init__(self, main, entry, variant):
        self.main, self.entry, self.variant = main, entry, variant

    def __getattr__(self, name):
        return getattr(self.variant if name == self.entry else self.main,
                       name)


def build_variant(src: Path, out_dir: Path):
    """(entry point, loaded library) of one variant source."""
    so = out_dir / (src.stem + ".so")
    inc = REPO / "src/repro_torch/kernels" / (
        "conv/csrc" if K1 in src.read_text() else "crossentropy/csrc")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(inc),
                    "-shared", "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    entry = K1 if hasattr(lib, K1) else K12
    fn = getattr(lib, entry)
    fn.argtypes = _build.SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return entry, lib


def k1_cases():
    """{K1 case: launches} over chip_smoke.py's main path (Table 1 aside)."""
    mult = {}

    def add(keys, times=1):
        for kern, case in keys:
            if kern == "conv_chwn":
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


def tiles(dev):
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
    st = _build.stream_of(dev)
    t = conv_tiling(N, Ci, H, H, Co, F, S, pad, pool)
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
    by_entry = {e: {k: lib for k, (en, lib) in built.items() if en == e}
                for e in (K1, K12)}
    with torch.inference_mode():
        compare("K1", K1, k1_cases(), k1_launch, by_entry[K1], dev)
        compare("K12", K12, {c: 1 for c in cs.lm_cases()[1]}, k12_launch,
                by_entry[K12], dev)
        if args.tiles:
            tiles(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
