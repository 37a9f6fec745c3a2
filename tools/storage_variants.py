#!/usr/bin/env python3
"""Time one storage variant of a kernel against variants of its source,
over that variant's launches on ``chip_smoke.py``'s main path, on one CUDA
card.

    python3 tools/storage_variants.py KERNEL.VARIANT [SOURCE.cu ...]

KERNEL.VARIANT names a row of the smoke's kernels line (``wgrad.bf16``,
``conv_stack_nchw.bf16``, ``pool_backward_chwn.bf16``, ...).  Its cases
are every distinct launch of that row on the bf16 training path
(``chip_smoke.plan_train_launches`` of ``BF16_TRAINED``) and the dtype
phase's served plans (``fused_launches`` of ``DTYPE_SERVED``), with the
launches each makes, and the row's one calibration or off-path case
(``CALIBRATION_ONLY``, ``DTYPE_OFF_PATH``, ``BF16_OFF_PATH``) once, as the
kernels line weighs it.  Each SOURCE stands in for the checkout's source of
that entry point: it is compiled by nvcc with the variant's flag
(``-DREPRO_VARIANT_<VARIANT>``) into a library of its own (all the
sources at once), and its entry point is swapped in for the checkout's.
The checkout's build and the sources run in turns (checkout, sources,
sources reversed, checkout);
each case is held against its plain version as the smoke holds it
(``chip_smoke.dtype_case``), and the ms summed over each network's
launches (a case's ms times its launches) is printed beside the library
call's (and, for the rows the smoke times by graph replay too, K3a bf16,
K7a bf16 and K8 bf16, the device ms; for the int8 stacks, the float
twin's ms on the same values, ``twin_ms``); ``--per-case`` also prints each
distinct launch's ms (its case, the launches it makes, ms and library ms
a launch) and, for a conv
row, the sums over the launches of each map width W the kernel reads (a
dgrad's: the width of the conv it poses).
``--timing-only`` skips the checks, for variants that time a part of the
kernel (producers that copy nothing, consumers that multiply nothing) and
so compute nothing to check.  Needs a CUDA device and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import tempfile
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "src"))
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv.backward import dgrad_shape  # noqa: E402


def main_path_cases(name: str) -> Counter:
    """{(network, case): launches} of kernels-line row ``name``."""
    cases = Counter()
    for network, batch, profile in cs.BF16_TRAINED:
        cfg, plan = cs.bf16_train_plan(network, batch, profile)
        for kern, case in cs.plan_train_launches(cfg, plan):
            if kern == name:
                cases[(network, case)] += cs.BF16_TRAIN_STEPS
    for network, bucket, policy, stack in cs.DTYPE_SERVED:
        cfg, plan = cs.dtype_plan(network, bucket, policy, stack)
        for kern, case in cs.fused_launches(cfg, plan):
            if kern == name:
                cases[(network, case)] += 1
    for label, one in (("calibration", cs.CALIBRATION_ONLY),
                       ("off path", {**cs.DTYPE_OFF_PATH,
                                     **cs.BF16_OFF_PATH,
                                     **cs.STACK_INT8_OFF_PATH})):
        if name in one:
            cases[(label, one[name])] += 1
    return cases


def map_width(name: str, case):
    """The width of the map a conv row's launch reads (a dgrad's: that
    of the conv it poses), or None for another kernel."""
    if not name.startswith(("conv_chwn.", "conv_nchw.")):
        return None
    if case[0] == "dgrad":
        N, Ci, H, Co, F, S, pad = case[1:8]
        return dgrad_shape(N, Ci, H, H, Co, F, S, pad)[3]
    return case[case[0] == "save_act":][2]


# a kernels-line row's wrapper -> the C entry point it launches
_ENTRY = {"conv_chwn": "conv_chwn_forward", "conv_nchw": "conv_nchw_forward",
          "conv_stack_chwn": "conv_stack_chwn_forward",
          "conv_stack_nchw": "conv_stack_nchw_forward",
          "wgrad": "wgrad_forward", "softmax": "softmax_forward",
          "softmax_xent": "softmax_xent_forward",
          "pool_chwn": "pool_chwn_forward", "pool_nchw": "pool_nchw_forward",
          "pool_backward_chwn": "pool_backward_chwn",
          "pool_backward_nchw": "pool_backward_nchw",
          "transpose2d": "transpose_forward",
          "transpose2d_batched": "transpose_forward"}


def entry_of(name: str, variant: str):
    """(C entry point, the checkout's source defining it) of row
    ``name``."""
    entry = _ENTRY[name.split(".")[0]]
    for rel in _build.VARIANTS[variant][0]:
        src = _build._KERNELS_DIR / rel
        if f"REPRO_ENTRY({entry})" in src.read_text():
            return entry, src
    raise SystemExit(f"no {variant} build defines {entry}")


def build(srcs, variant: str, entry: str, include: Path, out: Path) -> dict:
    """The entry point of each source of ``srcs`` built for ``variant``,
    every nvcc started at once (each into a directory of its own under
    ``out``: two sources of one name are two libraries); {str(src):
    entry}."""
    procs = {}
    for src in srcs:
        so = Path(tempfile.mkdtemp(dir=out)) / f"{src.stem}_{variant}.so"
        procs[str(src)] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS,
             f"-DREPRO_VARIANT_{variant.upper()}", "-I", str(include),
             "-shared", "-o", str(so), str(src)]))
    fns = {}
    for key, (so, proc) in procs.items():
        if proc.wait() != 0:
            raise SystemExit(f"{key}: nvcc failed")
        fn = getattr(ctypes.CDLL(str(so)), f"{entry}_{variant}")
        fn.argtypes = _build.SIGNATURES[entry]
        fn.restype = ctypes.c_int
        fns[key] = fn
    return fns


def timed(name: str, cases: Counter, dev, per_case: bool = False
          ) -> Counter:
    tot = Counter()
    with torch.inference_mode():
        for i, ((network, case), n) in enumerate(cases.items()):
            m = cs.dtype_case(name, case, dev, i)
            tot[network] += n * m["ms"]
            tot[f"{network} library"] += n * m["library_ms"]
            if "device_ms" in m:   # rows the smoke also times by graph replay
                tot[f"{network} device"] += n * m["device_ms"]
            if "twin_ms" in m:     # the int8 stacks' float twin
                tot[f"{network} twin"] += n * m["twin_ms"]
            if per_case:
                dev_ms = (f" device_ms={m['device_ms']:.5f}"
                          if "device_ms" in m else "")
                twin = (f" twin_ms={m['twin_ms']:.4f} "
                        f"twin_bitwise={m['twin_bitwise']}" if "twin_ms" in m
                        else "")
                print(f"  {network} {case} x{n}: ms={m['ms']:.4f}{dev_ms} "
                      f"library_ms={m['library_ms']:.4f}{twin}", flush=True)
                W = map_width(name, case)
                if W is not None:
                    tot[f"{network} W{W}"] += n * m["ms"]
                    tot[f"{network} W{W} library"] += n * m["library_ms"]
    return tot


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", help="a kernels-line row, KERNEL.VARIANT")
    ap.add_argument("sources", nargs="*", type=Path)
    ap.add_argument("--per-case", action="store_true",
                    help="print each distinct launch's times")
    ap.add_argument("--timing-only", action="store_true",
                    help="time without holding outputs against the plain "
                         "version")
    args = ap.parse_intermixed_args()
    if args.timing_only:
        cs.bf16_check = cs.exact_check = cs.conv_check = (
            lambda got, want: None)
        cs.bitwise_runs = lambda *a, **k: None
        cs.WGRAD_TOL = cs.TC_FP32_TOL = float("inf")
        measure = cs._measure

        def unchecked(*a, **k):   # float32 outputs (int8 x): no check
            k["check"] = lambda got, want: None
            return measure(*a, **k)

        cs._measure = unchecked
    if not torch.cuda.is_available():
        print("storage_variants: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    variant = args.name.split(".")[1]
    entry, checkout_src = entry_of(args.name, variant)
    cases = main_path_cases(args.name)
    print(f"{args.name}: {len(cases)} distinct launches, "
          f"{sum(cases.values())} on the main path; {cs.card_line()}")
    own = _build.entry(entry, variant)
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"checkout": own, **build(args.sources, variant, entry,
                                        checkout_src.parent, Path(tmp))}
        order = ["checkout"] + [str(s) for s in args.sources]
        for label in order + order[::-1]:
            _build._entries[variant][entry] = fns[label]
            tot = timed(args.name, cases, dev, args.per_case)
            print(f"{label}: " + ", ".join(f"{k} {v:.3f} ms"
                                           for k, v in tot.items()),
                  flush=True)
        _build._entries[variant][entry] = own
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
