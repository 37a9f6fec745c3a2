#!/usr/bin/env python3
"""Time K3a bf16 and K7a bf16 on their main-path launches, through the
tree in the current directory, on one CUDA card.

    cd TREE && python3 /path/to/tools/pool_device.py

TREE is a checkout (or a ``git archive`` of one under ``build/``): its
``src`` and its ``chip_smoke.py`` are the ones imported, so the same
script times two trees' kernels in one call (run it in each, in turns).
Each launch of unet_mini b8's standalone pools (K3a bf16, 6 a run of the
smoke) and of the bf16 pool backwards of VGG16 b32's and unet_mini b8's
training steps (K7a bf16, 5 each) is timed back to back (``cuda_ms``) and
by graph replay (``device_ms``), K3a bf16 beside ``max_pool2d`` /
``avg_pool2d`` on the same data in NCHW; the totals weigh each launch by
its count.  Needs a CUDA device and nvcc.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path.cwd() / "src"))
sys.path.insert(0, str(Path.cwd()))

import torch  # noqa: E402
from torch.nn import functional as nnf  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.layout import perm_between  # noqa: E402
from repro_torch.kernels.pool.backward import pool_backward_chwn  # noqa: E402
from repro_torch.kernels.pool.ops import pool_chwn  # noqa: E402

# ((N, C, H, W), F, S, op), launches
K3A = [(((8, 8, 32, 32), 2, 2, "max"), 6), (((8, 16, 16, 16), 2, 2, "max"), 6),
       (((8, 8, 32, 32), 32, 32, "avg"), 6)]
# (N, C, H, F, S, op, g_layout, relu_mask), launches
K7A = [((32, 64, 224, 2, 2, "max", "CHWN", True), 5),
       ((32, 128, 112, 2, 2, "max", "CHWN", True), 5),
       ((32, 256, 56, 2, 2, "max", "CHWN", True), 5),
       ((32, 512, 28, 2, 2, "max", "CHWN", True), 5),
       ((32, 512, 14, 2, 2, "max", "NCHW", True), 5),
       ((8, 8, 32, 2, 2, "max", "CHWN", False), 5),
       ((8, 16, 16, 2, 2, "max", "CHWN", False), 5),
       ((8, 8, 32, 32, 32, "avg", "NCHW", False), 5)]


def main() -> int:
    if not torch.cuda.is_available():
        print("pool_device: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(Path.cwd().name, cs.card_line(), flush=True)
    tot = {}

    def add(kern, n, r):
        for k, v in r.items():
            tot[f"{kern} {k}"] = tot.get(f"{kern} {k}", 0.0) + n * v

    with torch.inference_mode():
        for (shape, F, S, op), n in K3A:
            N, C, H, W = shape
            xn = torch.randn(N, C, H, W, device=dev).to(torch.bfloat16)
            x = xn.permute(1, 2, 3, 0).contiguous()
            pool_fn = nnf.max_pool2d if op == "max" else nnf.avg_pool2d

            def kernel():
                return pool_chwn(x, F, S, op)

            def library():
                return pool_fn(xn, F, S)

            r = {"ms": cs.cuda_ms(kernel), "device_ms": cs.device_ms(kernel),
                 "library_ms": cs.cuda_ms(library),
                 "library_device_ms": cs.device_ms(library)}
            print(f"K3a bf16 {shape} {F}/{S} {op} x{n}: "
                  + " ".join(f"{k}={v:.5f}" for k, v in r.items()),
                  flush=True)
            add("K3a bf16", n, r)
        for (N, C, H, F, S, op, g_lay, relu), n in K7A:
            Ho = (H - F) // S + 1
            zn = torch.randn(N, C, H, H, device=dev).to(torch.bfloat16)
            gn = torch.randn(N, C, Ho, Ho, device=dev).to(torch.bfloat16)
            z = zn.permute(1, 2, 3, 0).contiguous()
            g = gn.permute(perm_between("NCHW", g_lay)).contiguous()

            def kernel():
                return pool_backward_chwn(z, g, F, S, op, g_layout=g_lay,
                                          relu_mask=relu)

            r = {"ms": cs.cuda_ms(kernel), "device_ms": cs.device_ms(kernel)}
            print(f"K7a bf16 {(N, C, H, F, S, op, g_lay, relu)} x{n}: "
                  + " ".join(f"{k}={v:.5f}" for k, v in r.items()),
                  flush=True)
            add("K7a bf16", n, r)
    print("total: " + ", ".join(f"{k} {v:.4f}" for k, v in tot.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
