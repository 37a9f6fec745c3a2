"""CNN request-serving driver: batch-adaptive fused inference on the card.

The counterpart of ``repro/launch/cnn_serve.py``.  Requests (single
images) wait in a queue; each ``step`` drains up to ``max_bucket`` of
them, rounds the batch up to its pow-2 bucket, pads, and runs ONE fused
forward under the bucket's plan.  Plans come from a plan-cache file that
the reference planner wrote (``serve.plan_cache``); by default the one
packaged for the network in ``repro_torch/plans/``.  The port has no
planner yet, so a bucket without a plan in the file raises.

The plans served are the reference's plans at the uniform float32 dtype,
at the server's ``stack`` policy: ``"auto"`` (the reference's top rung,
``pallas+stacks``) fuses conv->conv pairs into one K5a (CHWN) or K5b
(NCHW) launch, ``"off"`` (its second rung) does not.  Every other conv op
is one K1 (CHWN) or K2 (NCHW) launch and the classifier softmax one K4
launch.  There is no degradation ladder: a failing kernel raises, and the
admitted batch returns to the front of the queue first.  The report
shows per-bucket plan-cache hit rates, the plans' conv layouts and stacks,
modeled device-memory bytes and images/s.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.cnn.layers import init_cnn
from repro_torch.cnn.network import FusedCNN, batch_output_ok
from repro_torch.configs.cnn_networks import (CNN_BUILDERS, CNN_CONFIGS,
                                              reduced_cnn)
from repro_torch.serve.plan_cache import (PlanCache, packaged_plans,
                                          pad_to_bucket)

DTYPE = "float32"
STACK_POLICIES = ("auto", "off")


class NonFiniteOutput(RuntimeError):
    """The batch output failed the finite check (``batch_output_ok``)."""


def resolve_device(device=None) -> torch.device:
    """``device`` as given, or the CUDA device when it is None.  With no
    CUDA device and no explicit device this raises: the port never moves
    to the CPU by itself."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card; pass device='cpu' "
            "to run the kernels' plain versions on the CPU")
    return torch.device("cuda")


@dataclasses.dataclass
class ImageRequest:
    rid: int
    image: np.ndarray                  # [C, H, W] float32
    probs: Optional[np.ndarray] = None # filled by the server


@dataclasses.dataclass
class BucketReport:
    bucket: int
    batches: int = 0
    images: int = 0
    padded: int = 0                    # pad rows executed (bucket waste)
    hits: int = 0
    misses: int = 0
    hbm_bytes: int = 0                 # modeled bytes, summed over batches
    seconds: float = 0.0               # host clock, each batch synchronized

    @property
    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0


class CNNServer:
    """Queue-draining batch-adaptive server over the fused CNN engine.

    ``reduced`` shrinks the big nets to 96 px as the reference server does
    by default; ``reduced=False`` serves the published widths.  The
    weights are random, from ``init_cnn(cfg, seed)``.  ``cache_path``
    defaults to the packaged plan file of ``network``.  ``stack`` is the
    plans' stack policy: "auto" (conv->conv stacks, the reference's
    operating point) or "off"."""

    def __init__(self, network: str = "lenet", *, reduced: bool = True,
                 max_bucket: int = 64, cache_path: Optional[str] = None,
                 device=None, seed: int = 0, stack: str = "auto"):
        if stack not in STACK_POLICIES:
            raise ValueError(f"unknown stack policy {stack!r}; known: "
                             f"{STACK_POLICIES}")
        self.stack = stack
        self.device = resolve_device(device)
        cfg = CNN_CONFIGS[network]
        if reduced and cfg.image_hw > 96:
            if cfg.name in CNN_BUILDERS:
                cfg = reduced_cnn(cfg, batch=cfg.batch)
            else:
                cfg = cfg.replace(image_hw=96)
        self.cfg = cfg
        # fp32 means fp32: cuBLAS (fc) and cuDNN (the oracle's conv) would
        # otherwise be free to round through TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.cache = PlanCache(str(cache_path or packaged_plans(network)),
                               max_bucket=max_bucket)
        self.model = FusedCNN(cfg, init_cnn(cfg, seed), self.device)
        self.queue: Deque[ImageRequest] = deque()
        self.reports: Dict[int, BucketReport] = {}

    # -- admission -----------------------------------------------------------

    def submit(self, req: ImageRequest) -> None:
        c, h = self.cfg.in_channels, self.cfg.image_hw
        if req.image.shape != (c, h, h):
            raise ValueError(
                f"request {req.rid}: image shape {req.image.shape} != "
                f"{(c, h, h)}")
        self.queue.append(req)

    # -- serving loop --------------------------------------------------------

    def step(self) -> List[ImageRequest]:
        """Drain up to ``max_bucket`` queued requests as one fused batch.
        On any failure the admitted batch returns to the FRONT of the queue
        in its original order before the exception propagates."""
        if not self.queue:
            return []
        batch = [self.queue.popleft()
                 for _ in range(min(len(self.queue), self.cache.max_bucket))]
        B = len(batch)
        try:
            t0 = time.perf_counter()
            plan, bucket, hit = self.cache.fused_plan(
                self.cfg, B, dtype=DTYPE, stack=self.stack)
            x = torch.from_numpy(np.stack([r.image for r in batch]))
            x = pad_to_bucket(x.to(self.device, torch.float32), bucket)
            with torch.inference_mode():
                y, stats = self.model(x, plan)
                ok = bool(batch_output_ok(y[:B]))  # synchronizes
            probs = y[:B].float().cpu().numpy()
            seconds = time.perf_counter() - t0
            if not ok:
                raise NonFiniteOutput(
                    f"non-finite batch output (bucket={bucket})")
        except BaseException:
            self.queue.extendleft(reversed(batch))
            raise
        rep = self.reports.setdefault(bucket, BucketReport(bucket))
        rep.hits += int(hit)
        rep.misses += int(not hit)
        for r, p in zip(batch, probs):
            r.probs = p
        rep.batches += 1
        rep.images += B
        rep.padded += bucket - B
        rep.hbm_bytes += stats.hbm_bytes
        rep.seconds += seconds
        return batch

    def run(self, requests: List[ImageRequest]) -> Dict[int, np.ndarray]:
        """Serve ``requests`` to completion: rid -> class probabilities."""
        for r in requests:
            self.submit(r)
        done: Dict[int, np.ndarray] = {}
        while self.queue:
            for r in self.step():
                done[r.rid] = r.probs
        return done

    # -- reporting -----------------------------------------------------------

    def report_lines(self) -> List[str]:
        dev = (torch.cuda.get_device_name(self.device)
               if self.device.type == "cuda" else "cpu")
        lines = [f"net={self.cfg.name} image_hw={self.cfg.image_hw} "
                 f"dtype={DTYPE} stack={self.stack} device={dev} "
                 f"planner_calls={self.cache.planner_calls}"]
        for b in sorted(self.reports):
            rep = self.reports[b]
            plan = self.cache.peek_fused(self.cfg, b, dtype=DTYPE,
                                         stack=self.stack)
            ips = rep.images / rep.seconds if rep.seconds else 0.0
            lines.append(
                f"  bucket={b:<4d} batches={rep.batches:<4d} "
                f"images={rep.images:<5d} pad_waste={rep.padded:<4d} "
                f"hit_rate={rep.hit_rate:.2f} "
                f"conv_layouts={plan.conv_signature} "
                f"conv_dtypes={plan.dtype_signature} "
                f"stacks={plan.stacked_convs} "
                f"modeled_MB={rep.hbm_bytes / 1e6:.1f} img/s={ips:.1f}")
        return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--network", default="vgg16", choices=list(CNN_CONFIGS))
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--max-bucket", type=int, default=32)
    ap.add_argument("--reduced", action="store_true",
                    help="serve big nets at 96 px (needs a plan file made "
                         "at that size: --cache-path)")
    ap.add_argument("--cache-path", default=None,
                    help="plan-cache JSON (default: the packaged plans)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "versions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    srv = CNNServer(args.network, reduced=args.reduced,
                    max_bucket=args.max_bucket, cache_path=args.cache_path,
                    device=args.device, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    c, h = srv.cfg.in_channels, srv.cfg.image_hw
    reqs = [ImageRequest(i, rng.standard_normal((c, h, h), np.float32))
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = srv.run(reqs)
    dt = time.perf_counter() - t0
    print(f"served {len(done)}/{len(reqs)} requests in {dt:.2f}s "
          f"({len(done) / dt:.1f} img/s overall)")
    for line in srv.report_lines():
        print(line)


if __name__ == "__main__":
    main()
