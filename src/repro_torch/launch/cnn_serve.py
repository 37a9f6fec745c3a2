"""CNN request-serving driver: batch-adaptive fused inference on the card.

The counterpart of ``repro/launch/cnn_serve.py``.  Requests (single
images) wait in a queue; each ``step`` drains up to ``max_bucket`` of
them, rounds the batch up to its pow-2 bucket, pads, and runs ONE fused
forward under the bucket's plan.  Plans come from the plan cache
(``serve.plan_cache``): loaded from ``cache_path`` (by default the plan
file packaged for the network in ``repro_torch/plans/``, when there is
one), and planned on a miss, once per bucket, by the port's planner on the
H100 profile (``planner_calls`` counts those).

Thresholds are planning inputs too, one-time per (hardware id, dtype):
``calibration="measured"`` times K1 and K2 on the card over the paper's
Fig. 4 sweep (``perfmodel.card_conv_measure``) and persists the row beside
the cache; ``"analytic"`` runs ``calibrate()`` on the H100 profile.  The
paper's heuristic plans under them (``PlanCache.heuristic_layouts``).

The plans served are uniform float32 plans at the server's ``stack``
policy: ``"auto"`` (the reference's top rung) fuses conv->conv pairs into
one K5a (CHWN) or K5b (NCHW) launch, ``"off"`` (its second rung) does
not.  Every other conv op is one K1 (CHWN) or K2 (NCHW) launch and the
classifier softmax one K4 launch.  There is no degradation ladder: a
failing kernel raises, and the admitted batch returns to the front of the
queue first.  The report shows the plan cache's hit rate and planner
calls, per bucket the hit rate, the plans' conv layouts and stacks,
modeled device-memory bytes and images/s.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.cnn.layers import init_cnn
from repro_torch.cnn.network import FusedCNN, batch_output_ok
from repro_torch.configs.cnn_networks import (CNN_BUILDERS, CNN_CONFIGS,
                                              reduced_cnn)
from repro_torch.dtypes import dtype_bytes
from repro_torch.perfmodel import (CostModel, Thresholds, calibrate,
                                   card_conv_measure, default_cost_model,
                                   hardware_id, measured_thresholds)
from repro_torch.serve.plan_cache import (PlanCache, packaged_plans,
                                          pad_to_bucket)

DTYPE = "float32"
STACK_POLICIES = ("auto", "off")
CALIBRATIONS = ("measured", "analytic")


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
    weights are random, from ``init_cnn(cfg, seed)``.  ``cache_path`` is
    the plan-cache file: read when it exists, written back after ``run``;
    without one the server starts from the packaged plan file of
    ``network`` (never written) or from an empty cache.  ``stack`` is the
    plans' stack policy: "auto" (conv->conv stacks, the reference's
    operating point) or "off".  ``calibration`` and ``thresholds`` set the
    float32 threshold row of this card (module docstring); ``calib_path``
    (default: ``thresholds.json`` beside ``cache_path``) persists a
    measured row.  ``cost_model`` prices the plans a miss makes (default:
    the H100 profile)."""

    def __init__(self, network: str = "lenet", *, reduced: bool = True,
                 max_bucket: int = 64, cache_path: Optional[str] = None,
                 device=None, seed: int = 0, stack: str = "auto",
                 calibration: str = "measured",
                 thresholds: Optional[Thresholds] = None,
                 calib_path: Optional[str] = None,
                 cost_model: Optional[CostModel] = None):
        if stack not in STACK_POLICIES:
            raise ValueError(f"unknown stack policy {stack!r}; known: "
                             f"{STACK_POLICIES}")
        if calibration not in CALIBRATIONS:
            raise ValueError(f"unknown calibration {calibration!r}; known: "
                             f"{CALIBRATIONS}")
        self.stack = stack
        self.device = resolve_device(device)
        self._hw = hardware_id(self.device)
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
        self._persist = cache_path is not None
        if cache_path is None and packaged_plans(network).exists():
            cache_path = str(packaged_plans(network))
        self.cache = PlanCache(
            None if cache_path is None else str(cache_path),
            thresholds=thresholds, max_bucket=max_bucket,
            cost_model=cost_model or default_cost_model())
        if self.cache.thresholds_for(DTYPE, self._hw) is None:
            if calibration == "measured":
                if calib_path is None and self._persist:
                    calib_path = os.path.join(
                        os.path.dirname(os.path.abspath(cache_path)),
                        "thresholds.json")
                th = measured_thresholds(
                    calib_path, dtype=DTYPE, hardware=self._hw,
                    measure=card_conv_measure(device=self.device))
            else:
                th = calibrate(dtype_bytes=dtype_bytes(DTYPE),
                               hw=self.cache.cost_model.hw)
            self.cache.set_thresholds(th, DTYPE, hardware=self._hw)
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
        if self._persist:
            self.cache.save()
        return done

    # -- reporting -----------------------------------------------------------

    def report_lines(self) -> List[str]:
        dev = (torch.cuda.get_device_name(self.device)
               if self.device.type == "cuda" else "cpu")
        th = self.cache.thresholds_for(DTYPE, self._hw)
        lines = [f"net={self.cfg.name} image_hw={self.cfg.image_hw} "
                 f"dtype={DTYPE} stack={self.stack} device={dev} "
                 f"hw={self._hw} thresholds=Ct:{th.Ct},Nt:{th.Nt} "
                 f"hit_rate={self.cache.stats.hit_rate:.2f} "
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
    ap.add_argument("--network", default="lenet", choices=list(CNN_CONFIGS))
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--max-bucket", type=int, default=32)
    ap.add_argument("--reduced", action="store_true",
                    help="serve big nets at 96 px")
    ap.add_argument("--cache-path", default=None,
                    help="plan-cache JSON, read if it exists and written "
                         "after the run (default: the packaged plans, "
                         "never written)")
    ap.add_argument("--calibration", default="measured",
                    choices=list(CALIBRATIONS),
                    help="thresholds: time K1/K2 on the card (persisted "
                         "beside --cache-path) or sweep the H100 model")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "versions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    srv = CNNServer(args.network, reduced=args.reduced,
                    max_bucket=args.max_bucket, cache_path=args.cache_path,
                    device=args.device, seed=args.seed,
                    calibration=args.calibration)
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
