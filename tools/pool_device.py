#!/usr/bin/env python3
"""Time the bf16 pools K3a and K3b and their backwards K7a and K7b, the
bf16 transposes K9a and K9b, and K1 on the calibration's case (int8 x
with float32 w, and float32), on their main-path launches, through the
tree in the current directory, on one CUDA card.

    cd TREE && python3 /path/to/tools/pool_device.py [pools] [transposes] [k1]

(no group named: all three).

TREE is a checkout (or a ``git archive`` of one under ``build/``): its
``src`` and its ``chip_smoke.py`` are the ones imported, so the same
script times two trees' kernels in one call (run it in each, in turns).
Each launch of unet_mini b8's standalone pools (K3a bf16, 6 a run of the
smoke), of K3b bf16's one case (unet_mini's first pool in NCHW, off every
path) and of the float32 K3b row's eight shapes cast to bf16 (AlexNet
b128's and VGG16 b32's unfused pools), and of the bf16 pool backwards of
VGG16 b32's and unet_mini b8's training steps (K7a bf16, 5 each) and of
ResNet-18 b32's (K7b bf16, 5 each), of the float32 K7b row's VGG16 b32
2/2 shapes cast to bf16, and of the float32 K7a row's AlexNet b128
launches (3 each), is timed back to back (``cuda_ms``) and by graph
replay (``device_ms``), each beside the library call on the same data in
NCHW (``max_pool2d`` / ``avg_pool2d``, their aten backwards times the ReLU
mask); the totals weigh each launch by its count.  The transposes: the
ResNet-18 b32 bf16 training step's K9a launches (``[32, X] -> [X, 32]``,
5 each in a run of the smoke) and K9b's one case (off every path)
against ``permute(...).contiguous()``.  K1: the Fig. 4 base layer
(``chip_smoke.CAL_CASE``, CHWN) on int8 x with float32 w and on float32
x, against cuDNN's float32 conv (TF32 off).  Needs a CUDA device and
nvcc.
"""
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd() / "src"))
sys.path.insert(0, str(Path.cwd()))

import torch  # noqa: E402
from torch.nn import functional as nnf  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.layout import perm_between  # noqa: E402
from repro_torch.kernels.pool.backward import (  # noqa: E402
    pool_backward_chwn, pool_backward_nchw)
from repro_torch.kernels.conv.ops import conv_direct_chwn  # noqa: E402
from repro_torch.kernels.pool.ops import pool_chwn, pool_nchw  # noqa: E402
from repro_torch.kernels.transpose.ops import (  # noqa: E402
    transpose2d, transpose2d_batched)

# (label, wrapper, layout): [(((N, C, H, W), F, S, op), launches)]
POOLS = [
    (("K3a bf16", pool_chwn, "CHWN"),
     [(((8, 8, 32, 32), 2, 2, "max"), 6), (((8, 16, 16, 16), 2, 2, "max"), 6),
      (((8, 8, 32, 32), 32, 32, "avg"), 6)]),
    (("K3b bf16", pool_nchw, "NCHW"), [(((8, 32, 32, 32), 2, 2, "max"), 1)]),
    (("K3b bf16 fp32-row", pool_nchw, "NCHW"),
     [(((128, 96, 55, 55), 3, 2, "max"), 1),
      (((128, 256, 27, 27), 3, 2, "max"), 1),
      (((128, 256, 13, 13), 3, 2, "max"), 1),
      (((32, 64, 224, 224), 2, 2, "max"), 1),
      (((32, 128, 112, 112), 2, 2, "max"), 1),
      (((32, 256, 56, 56), 2, 2, "max"), 1),
      (((32, 512, 28, 28), 2, 2, "max"), 1),
      (((32, 512, 14, 14), 2, 2, "max"), 1)])]
# (label, wrapper, layout, dtype): [((N, C, H, F, S, op, g_layout,
# relu_mask), launches)]
BACKWARDS = [
    (("K7a bf16", pool_backward_chwn, "CHWN", torch.bfloat16),
     [((32, 64, 224, 2, 2, "max", "CHWN", True), 5),
      ((32, 128, 112, 2, 2, "max", "CHWN", True), 5),
      ((32, 256, 56, 2, 2, "max", "CHWN", True), 5),
      ((32, 512, 28, 2, 2, "max", "CHWN", True), 5),
      ((32, 512, 14, 2, 2, "max", "NCHW", True), 5),
      ((8, 8, 32, 2, 2, "max", "CHWN", False), 5),
      ((8, 16, 16, 2, 2, "max", "CHWN", False), 5),
      ((8, 8, 32, 32, 32, "avg", "NCHW", False), 5)]),
    (("K7b bf16", pool_backward_nchw, "NCHW", torch.bfloat16),
     [((32, 64, 112, 3, 2, "max", "NCHW", True), 5),
      ((32, 512, 7, 7, 7, "avg", "NCHW", True), 5)]),
    (("K7b bf16 fp32-row", pool_backward_nchw, "NCHW", torch.bfloat16),
     [((32, 64, 224, 2, 2, "max", "NCHW", True), 1),
      ((32, 128, 112, 2, 2, "max", "NCHW", True), 1),
      ((32, 256, 56, 2, 2, "max", "NCHW", True), 1),
      ((32, 512, 28, 2, 2, "max", "NCHW", True), 1),
      ((32, 512, 14, 2, 2, "max", "NCHW", True), 1)]),
    (("K7a fp32", pool_backward_chwn, "CHWN", torch.float32),
     [((128, 96, 55, 3, 2, "max", "CHWN", True), 3),
      ((128, 256, 27, 3, 2, "max", "CHWN", True), 3),
      ((128, 256, 13, 3, 2, "max", "NCHW", True), 3)])]

# (label, wrapper): [(shape, launches)], bf16
TRANSPOSES = [
    (("K9a bf16", transpose2d), [((32, 100352), 5), ((32, 50176), 5)]),
    (("K9b bf16", transpose2d_batched), [(cs.K9B_CASE, 1)])]
GROUPS = ("pools", "transposes", "k1")


def main() -> int:
    groups = [a for a in sys.argv[1:] if a in GROUPS] or list(GROUPS)
    if not torch.cuda.is_available():
        print("pool_device: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(Path.cwd().name, cs.card_line(), flush=True)
    tot = {}

    def add(kern, n, r):
        for k, v in r.items():
            tot[f"{kern} {k}"] = tot.get(f"{kern} {k}", 0.0) + n * v

    def timed(kernel, library):
        return {"ms": cs.cuda_ms(kernel), "device_ms": cs.device_ms(kernel),
                "library_ms": cs.cuda_ms(library),
                "library_device_ms": cs.device_ms(library)}

    def show(label, case, n, r):
        print(f"{label} {case} x{n}: "
              + " ".join(f"{k}={v:.5f}" for k, v in r.items()), flush=True)
        add(label, n, r)

    with torch.inference_mode():
        for (label, wrapper, layout), cases in (
                POOLS if "pools" in groups else []):
            for (shape, F, S, op), n in cases:
                xn = torch.randn(*shape, device=dev).to(torch.bfloat16)
                x = xn.permute(perm_between("NCHW", layout)).contiguous()
                pool_fn = nnf.max_pool2d if op == "max" else nnf.avg_pool2d
                show(label, (shape, F, S, op), n, timed(
                    lambda: wrapper(x, F, S, op),
                    lambda: pool_fn(xn, F, S)))
        for (label, wrapper, layout, dtype), cases in (
                BACKWARDS if "pools" in groups else []):
            for case, n in cases:
                N, C, H, F, S, op, g_lay, relu = case
                Ho = (H - F) // S + 1
                zn = torch.randn(N, C, H, H, device=dev).to(dtype)
                gn = torch.randn(N, C, Ho, Ho, device=dev).to(dtype)
                z = zn.permute(perm_between("NCHW", layout)).contiguous()
                g = gn.permute(perm_between("NCHW", g_lay)).contiguous()
                show(label, case, n, timed(
                    lambda: wrapper(z, g, F, S, op, g_layout=g_lay,
                                    relu_mask=relu),
                    cs._pool_bwd_library(zn, gn, F, S, op, relu)))
        for (label, wrapper), cases in (
                TRANSPOSES if "transposes" in groups else []):
            for shape, n in cases:
                x = torch.randn(*shape, device=dev).to(torch.bfloat16)
                perm = (1, 0) if len(shape) == 2 else (0, 2, 1)
                show(label, shape, n, timed(
                    lambda: wrapper(x),
                    lambda: x.permute(perm).contiguous()))
        if "k1" in groups:
            N, Ci, H, Co, F, S, pad = cs.CAL_CASE["CHWN"][:7]
            q = torch.randint(-127, 128, (Ci, H, H, N), device=dev,
                              dtype=torch.int8)
            w = torch.randn(Co, Ci, F, F, device=dev) / math.sqrt(Ci * F * F)
            wk = w.permute(1, 2, 3, 0).contiguous()
            for label, x in (("K1 int8->fp32", q), ("K1 fp32", q.float())):
                xn = x.permute(3, 0, 1, 2).float()
                show(label, cs.CAL_CASE["CHWN"], 1, timed(
                    lambda: conv_direct_chwn(x, wk, S, pad),
                    lambda: nnf.conv2d(xn, w, stride=S, padding=pad)))
    print("total: " + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
