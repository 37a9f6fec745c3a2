#!/usr/bin/env python3
"""Compare the ``chip_smoke.py --json`` outputs of two trees run in one
call on one card.

    python3 tools/smoke_compare.py --before P1.json P2.json \\
        --after C1.json C2.json [--before-logs P1.log P2.log \\
        --after-logs C1.log C2.log]

Run the trees in turns (before, after, after, before) so that a drift of
the card or its shared host falls on both.  Each tree's runs are averaged.
Printed: every kernel of the kernels line (ms, the back-to-back reading
summed over the main path; library_ms; ms over library_ms) with each
run's ms and the change of the mean in percent; K4's main-path launches
one by one; the fused forwards (``stack_compare``), the unfused forwards
and the training steps, each with its change; with the runs' printed
output (``--before-logs``, ``--after-logs``), also the serving phase's
warm forwards (its ``warm forward`` lines).
"""
from __future__ import annotations

import argparse
import json
import re
from statistics import mean


def _load(paths):
    return [json.loads(open(p).read()) for p in paths]


def _pct(a: float, b: float) -> str:
    return f"{100.0 * (b - a) / a:+.2f}%" if a else "n/a"


def _row(label: str, before, after) -> None:
    a, b = mean(before), mean(after)
    print(f"{label}: before {a:.5f} {[round(v, 5) for v in before]} "
          f"after {b:.5f} {[round(v, 5) for v in after]} {_pct(a, b)}")


WARM = re.compile(r"^warm forward (\S+) bucket=(\d+) stack=(\S+): kernels "
                  r"([\d.]+) ms")


def _warm_forwards(path: str) -> dict:
    """{(network, bucket, stack): kernels ms} from a run's printed lines."""
    with open(path) as f:
        return {m.group(1, 2, 3): float(m.group(4))
                for m in map(WARM.match, f) if m}


def _kernels(runs) -> dict:
    return {k["name"]: k for k in runs["kernels"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--before", nargs="+", required=True)
    ap.add_argument("--after", nargs="+", required=True)
    ap.add_argument("--before-logs", nargs="*", default=[])
    ap.add_argument("--after-logs", nargs="*", default=[])
    args = ap.parse_args()
    before, after = _load(args.before), _load(args.after)
    for tree, runs in (("before", before), ("after", after)):
        print(f"{tree}: " + "; ".join(
            f"{r['card']} build {r['build_s']:.1f} s, run {r['seconds']:.1f}"
            f" s" for r in runs))

    print("-- kernels line (ms summed over the main path's launches)")
    kb, ka = [_kernels(r) for r in before], [_kernels(r) for r in after]
    for name in kb[0]:
        _row(f"{name} ms", [k[name]["ms"] for k in kb],
             [k[name]["ms"] for k in ka])
        _row(f"{name} library_ms", [k[name]["library_ms"] for k in kb],
             [k[name]["library_ms"] for k in ka])
        xb = mean(k[name]["ms"] / k[name]["library_ms"] for k in kb)
        xa = mean(k[name]["ms"] / k[name]["library_ms"] for k in ka)
        print(f"{name} xlib: before {xb:.3f} after {xa:.3f}")

    print("-- K4's main-path launches (back-to-back ms a launch)")

    def k4(run):
        return {(r["network"], tuple(r["case"])): r for r in run["cases"]
                if r["kernel"] == "softmax"}

    cb, ca = [k4(r) for r in before], [k4(r) for r in after]
    for key, row in cb[0].items():
        _row(f"softmax {key} x{row['launches']} ms",
             [c[key]["ms"] for c in cb], [c[key]["ms"] for c in ca])
        _row(f"softmax {key} library_ms",
             [c[key]["library_ms"] for c in cb],
             [c[key]["library_ms"] for c in ca])

    print("-- fused forwards (ms)")
    for i, row in enumerate(before[0]["stack_compare"]):
        for stack in ("off", "auto"):
            _row(f"{row['network']} b{row['bucket']} {stack}",
                 [r["stack_compare"][i][stack]["ms"] for r in before],
                 [r["stack_compare"][i][stack]["ms"] for r in after])
    print("-- unfused forwards (ms)")
    for i, row in enumerate(before[0]["unfused"]):
        _row(f"{row['network']} b{row['batch']} {row['mode']}",
             [r["unfused"][i]["ms"] for r in before],
             [r["unfused"][i]["ms"] for r in after])
    print("-- training steps (ms, on the kernels)")
    for i, row in enumerate(before[0]["training"]):
        _row(f"{row['network']} b{row['batch']}",
             [r["training"][i]["cuda_ms"] for r in before],
             [r["training"][i]["cuda_ms"] for r in after])
    if args.before_logs and args.after_logs:
        print("-- serving phase, warm forwards on the kernels (ms)")
        wb = [_warm_forwards(p) for p in args.before_logs]
        wa = [_warm_forwards(p) for p in args.after_logs]
        for key in wb[0]:
            _row(" ".join(key), [w[key] for w in wb], [w[key] for w in wa])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
