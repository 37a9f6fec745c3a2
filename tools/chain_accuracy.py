#!/usr/bin/env python3
"""Hold K1's bf16 build at its longest reductions against variant sources
of ``conv_chwn.cu``, on one CUDA card.

    python3 tools/chain_accuracy.py [VARIANT.cu ...]

The reductions are VGG16 conv5's forward (K = 512 x 3 x 3), the dgrad of
VGG16 conv4_3 (K = 512 x 3 x 3) and of AlexNet conv2 (K = 256 x 5 x 5):
the longest K1 runs on the main path.  Inputs are unit-scale bf16
activations or gradients and He-scale bf16 weights, made from a seed on
the card.  For the checkout's build and each variant (compiled by nvcc
with ``-DREPRO_VARIANT_BF16``, its entry point swapped in), each case
prints the largest |got - want| over one bf16 step (2^-7 |want| + 1e-5
max|want|, at most 1 within the gate) against the plain version, how many
outputs differ from the plain version's bits, and the largest error
against a float64 conv over the largest |want|, beside the plain
version's own.  A variant that sums its chain longer than the checkout's
shows there whether the tensor core's accumulation holds the gate.
"""
from __future__ import annotations

import math
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "src"), str(REPO), str(REPO / "tools")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.conv.backward import dgrad_problem  # noqa: E402
from repro_torch.kernels.conv.ops import _conv  # noqa: E402
from repro_torch.kernels.conv.ref import conv_ref  # noqa: E402
from repro_torch.shapes import conv_out_hw  # noqa: E402
from storage_variants import build, entry_of  # noqa: E402


def cases(dev):
    """(what, x, w [Ci, F, F, Co], stride, pad), CHWN x."""
    gen = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16
    x = torch.randn(512, 14, 14, 32, device=dev, generator=gen).to(bf)
    w = (torch.randn(512, 3, 3, 512, device=dev, generator=gen)
         / math.sqrt(4608)).to(bf)
    out = [("vgg16 conv5 forward, K 4608", x, w, 1, 1)]
    for N, Ci, H, Co, F, S, pad in [(32, 512, 28, 512, 3, 1, 1),
                                    (128, 96, 27, 256, 5, 1, 2)]:
        Ho = conv_out_hw(H, F, S, pad)
        g = torch.randn(Co, Ho, Ho, N, device=dev, generator=gen).to(bf)
        wc = (torch.randn(Co, Ci, F, F, device=dev, generator=gen)
              / math.sqrt(Ci * F * F)).to(bf)
        gd, wt, pd = dgrad_problem(g, wc, (H, H), S, pad, "CHWN")
        out.append((f"dgrad of Co {Co} x {F}x{F}, K {Co * F * F}", gd,
                    wt.permute(1, 2, 3, 0).contiguous(), 1, pd))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chain_accuracy: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    entry, src = entry_of("conv_chwn.bf16", "bf16")
    print(cs.card_line())
    runs = []
    for what, x, w, S, pad in cases(dev):
        w_oihw = w.permute(3, 0, 1, 2)
        kw = dict(src_layout="CHWN", dst_layout="CHWN")
        runs.append((what, x, w, S, pad,
                     conv_ref(x, w_oihw, S, pad, **kw).double(),
                     conv_ref(x, w_oihw.double(), S, pad, **kw).double()))
    with tempfile.TemporaryDirectory() as tmp:
        fns = {"checkout": _build.entry(entry, "bf16")}
        for s in sys.argv[1:]:
            fns[s] = build(Path(s), "bf16", entry, src.parent, Path(tmp))
        for label, fn in fns.items():
            _build._entries["bf16"][entry] = fn
            for what, x, w, S, pad, want, want64 in runs:
                got = _conv("CHWN", x, w, S, pad).double()
                bound = 2.0 ** -7 * want.abs() + 1e-5 * want.abs().max()
                gate = ((got - want).abs() / bound).max().item()
                scale = want64.abs().max()
                print(f"{label} {what}: gate {gate:.3f}, "
                      f"{int((got != want).sum())} of {want.numel()} "
                      f"outputs off the plain version's bits, error vs "
                      f"float64 {((got - want64).abs().max() / scale):.3g} "
                      f"(plain {((want - want64).abs().max() / scale):.3g})",
                      flush=True)
        _build._entries["bf16"][entry] = fns["checkout"]
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
