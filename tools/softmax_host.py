#!/usr/bin/env python3
"""Time K4's and K8's launches back to back through the softmax wrappers
of two or more checkouts of this repository, on one CUDA card, in turns.

    python3 tools/softmax_host.py TREE [TREE ...] [--rounds 4]

For a launch of a few microseconds a back-to-back reading is the host's
time a launch, which drifts by tens of percent between processes on a
shared host; so the trees are taken in turns.  Each round starts one
worker process a tree, in order and then reversed (two trees over four
rounds: A B, B A, A B, B A), with ``PYTHONPATH=TREE/src`` and TREE as its
directory: the worker imports that tree's ``repro_torch`` (its kernels
build under TREE) and, for each of K4's launches on ``chip_smoke.py``'s
main path (``tools/kernel_variants.main_path_cases``; logits randn x 4),
holds the wrapper to ``torch.softmax`` (atol 1e-6) and times both, then
K8 on (32, 1000) with labels inside [0, C) against ``F.cross_entropy``
(rtol/atol 1e-5).  Each time is taken two ways: one ``cuda_ms`` reading
(as ``chip_smoke.py`` times every kernel line) and the median of 5 taken
in turns with the library call (``b2b_ms``); the host microseconds of one
K4 launch and of ``torch.softmax`` at (32, 1000) are taken too.  Printed:
each worker's totals over the main path, then each tree's median over its
workers.  ``cuda_ms``, ``b2b_ms`` and ``host_us`` are those of
``chip_smoke.py``, copied: a worker must not import this checkout's
package.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from statistics import median

REPO = Path(__file__).resolve().parents[1]
K8_CASE = (32, 1000)


def cuda_ms(fn, min_reps: int = 3, max_reps: int = 50,
            budget_s: float = 0.25) -> float:
    import torch
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


def b2b_ms(fns: dict, rounds: int = 5) -> dict:
    got = {k: [] for k in fns}
    for r in range(rounds):
        for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
            got[k].append(cuda_ms(fns[k]))
    return {k: sorted(v)[len(v) // 2] for k, v in got.items()}


def host_us(fn, reps: int = 500) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def worker(cases) -> dict:
    """Times of this process's ``repro_torch`` softmax wrappers."""
    import torch
    from torch.nn import functional as nnf

    from repro_torch.kernels.softmax.ops import softmax, softmax_xent
    dev = torch.device("cuda")
    k4 = {"single": {"k4": 0.0, "torch": 0.0},
          "median5": {"k4": 0.0, "torch": 0.0}}
    for i, ((rows, cols), n) in enumerate(cases):
        gen = torch.Generator(device=dev).manual_seed(i)
        x = torch.randn(rows, cols, device=dev, generator=gen) * 4
        torch.testing.assert_close(softmax(x), torch.softmax(x, dim=-1),
                                   rtol=0, atol=1e-6)
        fns = {"k4": lambda: softmax(x),
               "torch": lambda: torch.softmax(x, dim=-1)}
        for k, fn in fns.items():
            k4["single"][k] += n * cuda_ms(fn)
        for k, v in b2b_ms(fns).items():
            k4["median5"][k] += n * v
    rows, cols = K8_CASE
    gen = torch.Generator(device=dev).manual_seed(len(cases))
    x = torch.randn(rows, cols, device=dev, generator=gen) * 4
    labels = torch.randint(0, cols, (rows,), device=dev, generator=gen)
    torch.testing.assert_close(softmax_xent(x, labels),
                               nnf.cross_entropy(x, labels,
                                                 reduction="none"),
                               rtol=1e-5, atol=1e-5)
    fns = {"k8": lambda: softmax_xent(x, labels),
           "cross_entropy": lambda: nnf.cross_entropy(x, labels,
                                                      reduction="none")}
    k8 = {"single": {k: cuda_ms(fn) for k, fn in fns.items()},
          "median5": b2b_ms(fns)}
    x = torch.randn(32, 1000, device=dev)
    host = {"k4": host_us(lambda: softmax(x)),
            "torch": host_us(lambda: torch.softmax(x, dim=-1))}
    return {"k4": k4, "k8": k8, "host_us": host}


def _flat(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        cases = [(tuple(c), n) for c, n in json.loads(args.worker)]
        print(json.dumps(worker(cases)))
        return 0
    sys.path.insert(0, str(REPO / "tools"))
    from kernel_variants import main_path_cases
    cases = [[list(c), n] for c, n in main_path_cases("softmax").items()]
    print(f"K4 main-path launches (rows, cols) x n: {cases}", flush=True)
    trees = [Path(t).resolve() for t in args.trees or [REPO]]
    got = {str(t): [] for t in trees}
    for r in range(args.rounds):
        for tree in (trees if r % 2 == 0 else trees[::-1]):
            env = {**os.environ, "PYTHONPATH": str(tree / "src")}
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--worker",
                 json.dumps(cases)], cwd=tree, env=env, capture_output=True,
                text=True, timeout=900)
            if proc.returncode != 0:
                print(proc.stdout[-2000:], proc.stderr[-4000:])
                raise RuntimeError(f"worker in {tree} failed")
            m = _flat(json.loads(proc.stdout.strip().splitlines()[-1]))
            got[str(tree)].append(m)
            print(f"round {r} {tree}: " + " ".join(
                f"{k}={v:.5f}" for k, v in m.items()), flush=True)
    for tree, runs in got.items():
        med = {k: median(m[k] for m in runs) for k in runs[0]}
        print(f"median over {len(runs)} workers, {tree}: " + " ".join(
            f"{k}={v:.5f}" for k, v in med.items()) + " | xlib single "
            f"{med['k4.single.k4'] / med['k4.single.torch']:.3f} median5 "
            f"{med['k4.median5.k4'] / med['k4.median5.torch']:.3f}",
            flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
