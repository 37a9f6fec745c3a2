#!/usr/bin/env python3
"""Where the LM server's steps spend their time on the card.

    python3 tools/lm_serve_profile.py [--arch qwen2_7b] [--periods N] [--dtype float32]

Builds ``launch/serve.Server(reduced=False)`` at full width (seed-0
weights, ``--periods`` keeps that many periods), prefills the smoke's 4
requests (``chip_smoke._lm_requests``) and, in each KV layout, runs the
server's own decode step (``chip_smoke._lm_step_fns``): the host clock
over 10 warm steps, then ``torch.profiler`` over 3 more and over one
prefill.  Prints, per layout: the wall ms a decode step, the device ms a
step (the sum of the kernels' self time), the device's busy share of the
wall time, and the ops by device time; the prefill's device ms; and the
head alone (``logits_fwd``) beside the same product of float32 copies of
its operands, by CUDA events (``chip_smoke.b2b_ms``).
TF32 and bf16 reduced-precision reductions are off.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as cs  # noqa: E402

WARM_STEPS, TIMED_STEPS, PROFILED_STEPS = 3, 10, 3


def device_ms(prof) -> float:
    """The kernels' self time in a profile, in ms."""
    return sum(e.self_device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation) / 1e3


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--periods", type=int, default=None)
    ap.add_argument("--dtype", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lm_serve_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(f"card: {cs.card_line()} (torch {torch.__version__})", flush=True)
    srv = cs.LMServer(args.arch, reduced=False, batch=len(cs.LM_PROMPTS),
                      max_len=cs.LM_MAX_LEN, periods=args.periods,
                      dtype=args.dtype)
    cfg = srv.cfg
    reqs = cs._lm_requests(cfg.vocab_size)
    print(f"{cfg.name} {cfg.num_layers} layers {cfg.dtype}, B={len(reqs)} "
          f"S0={max(len(r.prompt) for r in reqs)}", flush=True)
    with torch.inference_mode():
        for layout in ("bksd", "sbkd"):
            fns = cs._lm_step_fns(srv, reqs, layout)
            step, prefill = fns[("decode_ms", layout)], fns[("prefill_ms",
                                                             layout)]
            for _ in range(WARM_STEPS):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TIMED_STEPS):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / TIMED_STEPS
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILED_STEPS):
                    step()
                torch.cuda.synchronize()
            dev = device_ms(prof) / PROFILED_STEPS
            print(f"{layout} decode: wall {wall:.3f} ms a step (host clock, "
                  f"{TIMED_STEPS} steps), device {dev:.3f} ms a step "
                  f"(profiler, {PROFILED_STEPS} steps), busy "
                  f"{100 * dev / wall:.1f} %", flush=True)
            print(prof.key_averages().table(
                sort_by="self_device_time_total", row_limit=14,
                max_name_column_width=48), flush=True)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                prefill()
                torch.cuda.synchronize()
            print(f"{layout} prefill: device {device_ms(prof):.3f} ms",
                  flush=True)
            del fns, step, prefill
        table = cs.LMT.unembed_table(srv.params, cfg)
        h = torch.randn(len(reqs), cfg.d_model, device=srv.device).to(
            table.dtype)
        # the head as the server runs it (float32 results of the bf16
        # operands as they lie) beside the same product of float32 copies
        ms = cs.b2b_ms({
            "head": lambda: cs.LMT.logits_fwd(srv.params, h, cfg),
            "upcast": lambda: h.float() @ table.float().T})
        print(f"head: logits_fwd {ms['head']:.3f} ms; the same product of "
              f"float32 copies of h and the table {ms['upcast']:.3f} ms "
              f"(CUDA events, medians of 5 rounds in turns)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
