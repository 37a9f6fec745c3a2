#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py [--json OUT]

1. Prints the card (``nvidia-smi`` name and power limit) and builds the
   kernels from this checkout's CUDA sources with nvcc (sm_90a), timed.
2. Kernel phase: for every distinct conv and softmax launch of the served
   plans (full-width VGG16 at buckets 32 and 8, AlexNet at bucket 128), runs
   the kernel and its plain PyTorch version on the same inputs on the card,
   holds them together (conv rtol 1e-4 / atol 1e-3, softmax atol 1e-6) and
   times the kernel, the plain version and one library call for the same
   function (cuDNN conv + ReLU + pool; torch.softmax) with CUDA events.
3. Serving phase, the main path: 40 seeded requests of full-width VGG16
   through ``CNNServer(max_bucket=32)`` (one batch at bucket 32, one at 8)
   and 128 of AlexNet (one batch at bucket 128).  Every answer is held
   against the torch engine on the card (max abs 1e-5), and each kernel's
   launch count must equal what the plans call for.  Afterwards each
   batch's whole forward is timed warm (CUDA events) through the kernels
   and through the torch engine.
4. Prints one JSON line of every kernel (launches, error, times, bound),
   the card line, and ``{"ok": true, "device": {...}}`` last.

TF32 is off throughout.  Any failure raises: the script then exits
nonzero without the last line.  ``--json`` also writes every measured
case, and the compiler's register/spill report, to OUT.
"""
from __future__ import annotations

import argparse
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.nn import functional as nnf

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

from repro_torch import kernels as K  # noqa: E402
from repro_torch.cnn.layers import layer_shapes, resolved_cfg_inputs  # noqa: E402
from repro_torch.cnn.network import forward_fused, input_shape  # noqa: E402
from repro_torch.configs.cnn_networks import CNN_CONFIGS  # noqa: E402
from repro_torch.core.layout import perm_between  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv.ops import (conv_direct_chwn,  # noqa: E402
                                          conv_im2col_nchw_fused)
from repro_torch.kernels.conv.ref import conv_ref  # noqa: E402
from repro_torch.kernels.softmax.ops import softmax  # noqa: E402
from repro_torch.kernels.softmax.ref import softmax_ref  # noqa: E402
from repro_torch.launch.cnn_serve import (CNNServer,  # noqa: E402
                                          ImageRequest, packaged_plans)
from repro_torch.serve.plan_cache import PlanCache, pad_to_bucket  # noqa: E402
from repro_torch.shapes import conv_out_hw  # noqa: E402

# NVIDIA H100 SXM data sheet (dense, at the full 700 W power limit)
PEAK_FP32_FLOPS = 67e12          # CUDA cores, fp32
PEAK_HBM_BYTES = 3.35e12         # HBM3 bytes/s

CONV_RTOL, CONV_ATOL = 1e-4, 1e-3
SOFTMAX_ATOL = 1e-6
PROBS_ATOL = 1e-5

# the main path: (network, max_bucket, requests)
SERVED = [("vgg16", 32, 40), ("alexnet", 128, 128)]

KERNELS = {
    "conv_chwn": {"route": "cuda",
                  "source": "src/repro_torch/kernels/conv/csrc/conv_chwn.cu",
                  "replaces": "src/repro/kernels/conv/conv.py:144"},
    "conv_nchw": {"route": "cuda",
                  "source": "src/repro_torch/kernels/conv/csrc/conv_nchw.cu",
                  "replaces": "src/repro/kernels/conv/im2col_mm.py:97"},
    "softmax": {"route": "cuda",
                "source": "src/repro_torch/kernels/softmax/csrc/softmax.cu",
                "replaces": "src/repro/kernels/softmax/softmax.py:27"},
}


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def batch_sizes(n_requests: int, cap: int):
    """The admitted batch sizes of a FIFO server draining ``n_requests``."""
    sizes, left = [], n_requests
    while left:
        sizes.append(min(cap, left))
        left -= sizes[-1]
    return sizes


def cuda_ms(fn, min_reps: int = 3, max_reps: int = 50,
            budget_s: float = 0.25) -> float:
    """Mean device time of ``fn`` in ms: CUDA events around a run of
    launches after one warm-up, the run sized to about ``budget_s``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    probe = time.perf_counter() - t0
    reps = max(min_reps, min(max_reps, int(budget_s / max(probe, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float):
    """(least time in ms, what sets it) on the card's published peaks."""
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


# -- the launches the served plans make ------------------------------------

def plan_launches(network: str, bucket: int):
    """(kernel, case) for every kernel launch of the packaged plan of
    ``network`` at ``bucket``, in plan order."""
    cfg = CNN_CONFIGS[network].replace(batch=bucket)
    plan = PlanCache(str(packaged_plans(network))).peek_fused(
        cfg, bucket, stack="off")
    if plan is None:
        raise LookupError(f"no packaged {network} plan at bucket {bucket}")
    shapes, rins = layer_shapes(cfg), resolved_cfg_inputs(cfg)
    out = []
    for op in plan.ops:
        if op.kind == "conv":
            spec = cfg.layers[op.index]
            p = rins[op.index][0]
            _, ci, h, _ = input_shape(cfg) if p < 0 else shapes[p]
            pool = None
            if op.pool_index is not None:
                ps = cfg.layers[op.pool_index]
                pool = (ps.kernel, ps.stride, ps.pool_op)
            kern = "conv_chwn" if op.layout == "CHWN" else "conv_nchw"
            out.append((kern, (bucket, ci, h, spec.out_channels, spec.kernel,
                               spec.stride, spec.pad, pool, op.relu,
                               op.src_layout, op.dst_layout)))
        elif op.kind == "softmax":
            out.append(("softmax", (bucket, cfg.num_classes)))
    return out


def conv_case(kern: str, case, dev, seed: int) -> dict:
    N, Ci, H, Co, F, S, pad, pool, relu, src, dst = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    x_nchw = torch.randn(N, Ci, H, H, device=dev, generator=gen)
    w = torch.randn(Co, Ci, F, F, device=dev, generator=gen) \
        / math.sqrt(Ci * F * F)
    x = x_nchw.permute(perm_between("NCHW", src)).contiguous()
    kw = dict(relu=relu, pool=pool, src_layout=src, dst_layout=dst)
    if kern == "conv_chwn":
        wk = w.permute(1, 2, 3, 0).contiguous()

        def kernel():
            return conv_direct_chwn(x, wk, S, pad, **kw)
    else:
        def kernel():
            return conv_im2col_nchw_fused(x, w, S, pad, **kw)

    def plain():
        return conv_ref(x, w, S, pad, **kw)

    def library():
        y = nnf.conv2d(x_nchw, w, stride=S, padding=pad)
        if relu:
            y = torch.relu_(y)
        if pool is not None:
            y = (nnf.max_pool2d(y, pool[0], pool[1]) if pool[2] == "max"
                 else nnf.avg_pool2d(y, pool[0], pool[1]))
        return y

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rel = err / max(want.abs().max().item(), 1e-30)
    torch.testing.assert_close(got, want, rtol=CONV_RTOL, atol=CONV_ATOL)
    Ho = conv_out_hw(H, F, S, pad)
    flops = 2.0 * N * Co * Ho * Ho * Ci * F * F
    nbytes = 4.0 * (x.numel() + w.numel() + got.numel())
    b_ms, b_by = bound_ms(flops, nbytes)
    return {"max_abs_err": err, "max_rel_err": rel, "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library),
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "bytes": nbytes}


def softmax_case(case, dev, seed: int) -> dict:
    rows, cols = case
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(rows, cols, device=dev, generator=gen) * 4

    def kernel():
        return softmax(x)

    def plain():
        return softmax_ref(x)

    def library():
        return torch.softmax(x, dim=-1)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=SOFTMAX_ATOL)
    # max, shift, exp, sum, normalize: ~5 operations per element
    flops, nbytes = 5.0 * rows * cols, 4.0 * 2 * rows * cols
    b_ms, b_by = bound_ms(flops, nbytes)
    return {"max_abs_err": err, "max_rel_err": err / want.abs().max().item(),
            "ms": cuda_ms(kernel), "plain_ms": cuda_ms(plain),
            "library_ms": cuda_ms(library), "bound_ms": b_ms,
            "bound_by": b_by, "flops": flops, "bytes": nbytes}


def kernel_phase(dev):
    """Measure every distinct launch of the main path once; returns the
    cases with their multiplicity (launches on the main path)."""
    mult, batches = {}, []
    for network, cap, n_req in SERVED:
        for B in batch_sizes(n_req, cap):
            bucket = PlanCache(str(packaged_plans(network)),
                               max_bucket=cap).bucket(B)
            keys = plan_launches(network, bucket)
            batches.append((network, bucket, keys))
            for kern, case in keys:
                row = mult.setdefault((kern, case), {
                    "network": network, "kernel": kern, "case": case,
                    "launches": 0})
                row["launches"] += 1
    for i, ((kern, case), row) in enumerate(mult.items()):
        t0 = time.perf_counter()
        m = (softmax_case(case, dev, i) if kern == "softmax"
             else conv_case(kern, case, dev, i))
        row.update(m)
        print(f"kernel {kern:<9s} {row['network']:<7s} case={case} "
              f"x{row['launches']}: max_abs_err={m['max_abs_err']:.3g} "
              f"max_rel_err={m['max_rel_err']:.3g} ms={m['ms']:.4f} "
              f"plain_ms={m['plain_ms']:.4f} "
              f"library_ms={m['library_ms']:.4f} "
              f"bound_ms={m['bound_ms']:.4f} ({m['bound_by']}) "
              f"[{time.perf_counter() - t0:.1f}s]", flush=True)
    # per served forward: each kernel's launches summed
    for network, bucket, keys in batches:
        for kern in KERNELS:
            rows = [mult[k] for k in keys if k[0] == kern]
            if rows:
                tot = {f: sum(r[f] for r in rows)
                       for f in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "flops", "bytes")}
                print(f"forward {network} bucket={bucket} {kern}: "
                      f"launches={len(rows)} ms={tot['ms']:.4f} "
                      f"plain_ms={tot['plain_ms']:.4f} "
                      f"library_ms={tot['library_ms']:.4f} "
                      f"bound_ms={tot['bound_ms']:.4f} "
                      f"GFLOP={tot['flops'] / 1e9:.2f} "
                      f"MB={tot['bytes'] / 1e6:.1f}")
    return list(mult.values())


# -- the main path ----------------------------------------------------------

def serving_phase(dev):
    """Serve the main path through CNNServer; returns launches per kernel
    over the whole main path."""
    total = {k: 0 for k in K.WRAPPERS}
    for network, cap, n_req in SERVED:
        srv = CNNServer(network, reduced=False, max_bucket=cap, seed=0)
        rng = np.random.default_rng(1)
        c, h = srv.cfg.in_channels, srv.cfg.image_hw
        images = [rng.standard_normal((c, h, h), np.float32)
                  for _ in range(n_req)]
        K.reset_launch_counts()
        t0 = time.perf_counter()
        done = srv.run([ImageRequest(i, im) for i, im in enumerate(images)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()

        want_counts = {k: 0 for k in K.WRAPPERS}
        start, worst, warm = 0, 0.0, []
        params = srv.model.params()
        for B in batch_sizes(n_req, cap):
            bucket = srv.cache.bucket(B)
            for kern, _ in plan_launches(network, bucket):
                want_counts[kern] += 1
            plan = srv.cache.peek_fused(srv.cfg, B, stack="off")
            x = torch.from_numpy(np.stack(images[start:start + B])).to(dev)
            xb = pad_to_bucket(x, bucket)
            y, _ = forward_fused(params, xb, srv.cfg, plan, impl="torch")
            want = y[:B].cpu().numpy()
            # warm whole-forward device time of both engines on this batch
            # (after the counted run: these launches are not the main path's)
            warm.append((bucket, *(cuda_ms(
                lambda impl=impl: forward_fused(params, xb, srv.cfg, plan,
                                                impl=impl), max_reps=20)
                for impl in ("cuda", "torch"))))
            got = np.stack([done[i] for i in range(start, start + B)])
            if got.shape != (B, srv.cfg.num_classes):
                raise AssertionError(f"{network}: answers of shape "
                                     f"{got.shape}")
            if not np.isfinite(got).all():
                raise AssertionError(f"{network}: non-finite answers")
            err = float(np.abs(got - want).max())
            if err > PROBS_ATOL:
                raise AssertionError(
                    f"{network} bucket {bucket}: served probabilities differ "
                    f"from the torch engine by {err:.3g} > {PROBS_ATOL}")
            worst = max(worst, err)
            start += B
        if counts != want_counts:
            raise AssertionError(f"{network}: launches {counts} != the "
                                 f"plans' {want_counts}")
        print(f"serve {network}: {n_req} requests in {wall:.3f}s, launches "
              f"{counts} (= the plans'), max |probs - torch engine| = "
              f"{worst:.3g}")
        for line in srv.report_lines():
            print(line)
        for bucket, ms_k, ms_t in warm:
            print(f"warm forward {network} bucket={bucket}: kernels "
                  f"{ms_k:.3f} ms ({1e3 * bucket / ms_k:.1f} img/s), torch "
                  f"engine (cuDNN, TF32 off) {ms_t:.3f} ms "
                  f"({1e3 * bucket / ms_t:.1f} img/s)")
        for k, v in counts.items():
            total[k] += v
        del srv
        torch.cuda.empty_cache()
    return total


def kernels_line(cases, launches) -> dict:
    """One entry per kernel: times and bound summed over the main path's
    launches (each distinct launch timed once, times its multiplicity)."""
    out = []
    for kern, meta in KERNELS.items():
        rows = [r for r in cases if r["kernel"] == kern]
        if sum(r["launches"] for r in rows) != launches[kern]:
            raise AssertionError(f"{kern}: measured cases cover "
                                 f"{sum(r['launches'] for r in rows)} "
                                 f"launches, the main path made "
                                 f"{launches[kern]}")
        if launches[kern] == 0:
            raise AssertionError(f"{kern} was not launched on the main path")

        def total(key):
            return sum(r[key] * r["launches"] for r in rows)

        t_ops = total("flops") / PEAK_FP32_FLOPS
        t_bytes = total("bytes") / PEAK_HBM_BYTES
        out.append({"name": kern, **meta, "launches": launches[kern],
                    "max_abs_err": max(r["max_abs_err"] for r in rows),
                    "ms": total("ms"), "plain_ms": total("plain_ms"),
                    "bound_ms": total("bound_ms"),
                    "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                    "library_ms": total("library_ms")})
    return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None,
                    help="also write every measured case here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda})", flush=True)

    t0 = time.perf_counter()
    ptxas = io.StringIO()
    lib = _build.build(log=ptxas)
    _build.library()
    print(f"build: {time.perf_counter() - t0:.1f}s -> "
          f"{lib.relative_to(REPO)}", flush=True)

    with torch.inference_mode():
        t0 = time.perf_counter()
        cases = kernel_phase(dev)
        print(f"kernel phase: {time.perf_counter() - t0:.1f}s", flush=True)
        t0 = time.perf_counter()
        launches = serving_phase(dev)
        print(f"serving phase: {time.perf_counter() - t0:.1f}s", flush=True)
    line = kernels_line(cases, launches)
    if args.json:
        out = Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"card": card, "cases": cases, **line,
                                   "ptxas": ptxas.getvalue()}, indent=1))
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
