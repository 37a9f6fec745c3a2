"""CNN request server: batch-adaptive, guarded fused inference on the
card.

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
Fig. 4 sweep (``perfmodel.card_conv_measure``, at the row's storage dtype)
and persists the row beside the cache; ``"analytic"`` runs ``calibrate()``
on the H100 profile at the row's element size.  The paper's heuristic
plans under them (``PlanCache.heuristic_layouts``).

The server stores activations and weights in its ``dtype`` (float32 or
bf16: half the bytes, every kernel still accumulating in float32), and
requests are cast to it.  ``dtype_policy="mixed"`` plans per layer
(layout, storage dtype): interior conv chains store int8 (the conv kernels
take it with the scale folded into the weights), so a mixed server also
keeps, and measures, the int8 threshold row.  ``stack="auto"`` fuses
conv->conv pairs into one K5a (CHWN) or K5b (NCHW) launch where the plan
is uniform; ``"off"`` does not.  Every other conv op is one K1 (CHWN) or
K2 (NCHW) launch and the classifier softmax one K4 launch.

Execution is guarded, as the reference's is: every batch runs under a
degradation ladder (``runtime.resilience.degradation_ladder``: stacks ->
stacks off -> mixed -> uniform dtype) with a finite check on its output.
A failing rung (an exception, a non-finite batch, an injected fault)
quarantines that (bucket, policy, stack, engine) plan variant and the
batch retries on the next rung, after an exponential backoff; later
batches of the bucket start at the first rung not quarantined (its plan a
cache key, never an ad-hoc replan).  If every rung fails, the admitted
requests return to the FRONT of the queue in their order and
``ServingFault`` is raised; ``run`` retries such a step, within
``max_step_failures``.  ``injector`` drives the seeded fault harness;
every incident is counted and reported.

Two differences from the reference are deliberate:

  * the ladder never leaves its engine.  The ``"cuda"`` server's last rung
    is ``cuda`` (uniform, no stacks), still on the kernels: the reference's
    terminal decomposed rung would hide a kernel that fails on the card
    behind the plain engine.  ``impl="torch"`` serves the plain engine's
    ladder;
  * a kernel that fails to build (``KernelBuildError``) or to launch
    (``KernelLaunchError``) is not a rung's fault to step over: the
    admitted batch goes back to the front of the queue and the error
    propagates at once, with no lower rung tried.

``devices`` > 1 serves over a data-parallel mesh
(``distributed.cnn_mesh``): a step drains up to ``max_bucket * devices``
requests, the batch is padded to ``bucket * devices`` and split batch-wise
over the first ``devices`` cards, the weights replicated, and every shard
runs the plan of the PER-SHARD bucket (``max_bucket`` bounds the shard
bucket; plans are keyed on it and on ``devices``).  Every rung of the
ladder runs sharded.  ``devices=1`` is the single-card server unchanged.

The report shows the dtype and policy, the plan cache's hit rate and
planner calls, per bucket the hit rate, the plans' conv layouts, storage
dtypes and stacks, modeled device-memory bytes (all cards, and a card's
a batch), images/s, the prediction
error of the plan's modeled seconds, the rung that served, degraded
batches, failed rung attempts and stragglers, then the incident totals.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.cnn.layers import init_cnn
from repro_torch.cnn.network import FusedCNN, batch_output_ok
from repro_torch.configs.cnn_networks import (CNN_BUILDERS, CNN_CONFIGS,
                                              reduced_cnn)
from repro_torch.distributed.cnn_mesh import (cnn_data_mesh,
                                              forward_fused_sharded,
                                              replicate_params)
from repro_torch.dtypes import (INT8_DTYPE, canon_dtype, dtype_bytes,
                                torch_dtype)
from repro_torch.kernels._build import KERNEL_ERRORS
from repro_torch.perfmodel import (CostModel, Thresholds, calibrate,
                                   card_conv_measure, default_cost_model,
                                   hardware_id, measured_thresholds)
from repro_torch.runtime.fault_tolerance import StragglerWatchdog
from repro_torch.runtime.resilience import (ENGINES, FaultInjector,
                                            IncidentLog, Rung, ServingFault,
                                            degradation_ladder,
                                            parse_inject_spec)
from repro_torch.serve.plan_cache import (PlanCache, packaged_plans,
                                          pad_to_bucket)

log = logging.getLogger("repro_torch.cnn_serve")

DTYPES = ("float32", "bfloat16")   # what the port's kernels serve
DTYPE_POLICIES = ("uniform", "mixed")
STACK_POLICIES = ("auto", "off")
CALIBRATIONS = ("measured", "analytic")
# what the guard never steps over: a kernel that cannot run on the card


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
    hbm_bytes: int = 0                 # modeled bytes of all cards, summed
                                       # over batches
    per_chip_bytes: int = 0            # modeled bytes of one card, summed
    seconds: float = 0.0               # host clock, each batch synchronized
    degraded: int = 0                  # batches served below the top rung
    failures: int = 0                  # rung attempts that failed
    rung: str = ""                     # the rung that served the LAST batch

    @property
    def hit_rate(self) -> float:
        t = self.hits + self.misses
        return self.hits / t if t else 0.0


@dataclasses.dataclass
class _GuardResult:
    """One guarded batch: where it landed and what it cost."""
    bucket: int
    rung: Rung
    rung_index: int
    probs: np.ndarray                  # [bucket, classes], pad rows too
    seconds: float
    hit: bool                          # plan-cache hit for the serving rung


class CNNServer:
    """Queue-draining batch-adaptive server over the fused CNN engine,
    guarded by a degradation ladder (module docstring).

    ``reduced`` shrinks the big nets to 96 px as the reference server does
    by default; ``reduced=False`` serves the published widths.  The
    weights are random, from ``init_cnn(cfg, seed)``.  ``cache_path`` is
    the plan-cache file: read when it exists (a corrupt one is renamed
    aside and counted), written back after ``run``; without one the server
    starts from the packaged plan file of ``network`` (never written) or
    from an empty cache.  ``impl`` is the engine of every rung: "cuda"
    (the kernels; their plain versions on a CPU ``device``) or "torch".
    ``stack`` is the top rung's stack policy: "auto" (conv->conv stacks,
    the reference's operating point) or "off".  ``dtype`` is the storage
    dtype (float32 or bf16) and ``dtype_policy`` "uniform" or "mixed"
    (int8 interior boundaries).  ``calibration`` sets the threshold rows
    this server plans under, its dtype's and, mixed, int8's (module
    docstring); ``thresholds``, when given, is its dtype's row;
    ``calib_path`` (default: ``thresholds.json`` beside ``cache_path``)
    persists measured rows.  ``cost_model`` prices the plans a miss makes
    (default: the H100 profile); ``max_plans`` bounds the cached plans
    (least-recently-hit eviction).  ``injector`` injects faults;
    ``backoff_s`` is the first delay between rungs (doubling down the
    ladder; 0 for none); ``run`` gives up after ``max_step_failures``
    consecutive fully failed steps.  ``devices`` > 1 shards every batch
    over ``cnn_data_mesh(devices, device)`` (module docstring); ``mesh``,
    a tuple of devices, names the shards' devices instead (two shards on
    one card rehearse the split), and ``devices`` is then its length."""

    def __init__(self, network: str = "lenet", *, reduced: bool = True,
                 max_bucket: int = 64, cache_path: Optional[str] = None,
                 device=None, seed: int = 0, impl: str = "cuda",
                 stack: str = "auto", calibration: str = "measured",
                 thresholds: Optional[Thresholds] = None,
                 calib_path: Optional[str] = None,
                 cost_model: Optional[CostModel] = None,
                 dtype: str = "float32", dtype_policy: str = "uniform",
                 max_plans: Optional[int] = None,
                 injector: Optional[FaultInjector] = None,
                 backoff_s: float = 0.0, max_step_failures: int = 8,
                 devices: int = 1, mesh=None):
        self.dtype = canon_dtype(dtype)
        if self.dtype not in DTYPES:
            raise ValueError(f"the port serves {DTYPES}, not {dtype!r}")
        if dtype_policy not in DTYPE_POLICIES:
            raise ValueError(f"unknown dtype policy {dtype_policy!r}; "
                             f"known: {DTYPE_POLICIES}")
        self.dtype_policy = dtype_policy
        if stack not in STACK_POLICIES:
            raise ValueError(f"unknown stack policy {stack!r}; known: "
                             f"{STACK_POLICIES}")
        if calibration not in CALIBRATIONS:
            raise ValueError(f"unknown calibration {calibration!r}; known: "
                             f"{CALIBRATIONS}")
        if impl not in ENGINES:
            raise ValueError(f"unknown impl {impl!r}; known: {ENGINES}")
        self.stack = stack
        self.impl = impl
        self.injector = injector
        self.backoff_s = backoff_s
        self.max_step_failures = max_step_failures
        self.incidents = IncidentLog()
        # rung 0 is normal service; every rung runs on ``impl``
        self.ladder = degradation_ladder(impl, dtype_policy, stack)
        # quarantined (bucket, policy, stack, impl) plan variants: later
        # batches of the bucket skip them.  The plan stays cached: lifting
        # a quarantine costs no replan
        self._quarantine: set = set()
        self.device = resolve_device(device)
        if mesh is not None:
            devices = len(mesh)
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        self.devices = devices
        # the shards' devices; devices == 1 keeps the single-card path
        self.mesh = (None if devices == 1 else tuple(mesh) if mesh is not None
                     else cnn_data_mesh(devices, self.device))
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
            thresholds=(None if thresholds is None
                        else {self.dtype: thresholds}),
            max_bucket=max_bucket, max_entries=max_plans,
            cost_model=cost_model or default_cost_model())
        for dst in self.cache.corrupt_recoveries:
            self.incidents.record("corrupt_state",
                                  f"plan cache quarantined to {dst}")
        # a row for every storage dtype the plans use: the server's, and
        # int8's where the plans are mixed
        self.rows = [self.dtype] + (
            [INT8_DTYPE] if dtype_policy == "mixed" else [])
        if calib_path is None and self._persist:
            calib_path = os.path.join(
                os.path.dirname(os.path.abspath(cache_path)),
                "thresholds.json")
        for row in self.rows:
            if self.cache.thresholds_for(row, self._hw) is not None:
                continue
            if calibration == "measured":
                th = measured_thresholds(
                    calib_path, dtype=row, hardware=self._hw,
                    measure=card_conv_measure(dtype=row,
                                              device=self.device),
                    on_corrupt=lambda dst, e: self.incidents.record(
                        "corrupt_state",
                        f"threshold table quarantined to {dst}"))
            else:
                th = calibrate(dtype_bytes=dtype_bytes(row),
                               hw=self.cache.cost_model.hw)
            self.cache.set_thresholds(th, row, hardware=self._hw)
        self.model = FusedCNN(cfg, init_cnn(cfg, seed), self.device,
                              self.dtype)
        # replicate once, serve forever
        self._replicas = (None if self.mesh is None else
                          replicate_params(self.model.params(), self.mesh))
        self.queue: Deque[ImageRequest] = deque()
        self.reports: Dict[int, BucketReport] = {}
        self._fwd: Dict[Tuple[int, str], Callable] = {}
        self._plan_stats: Dict[Tuple[int, str], int] = {}  # modeled bytes
        self._watchdogs: Dict[int, StragglerWatchdog] = {}

    # -- admission -----------------------------------------------------------

    def submit(self, req: ImageRequest) -> None:
        c, h = self.cfg.in_channels, self.cfg.image_hw
        if req.image.shape != (c, h, h):
            raise ValueError(
                f"request {req.rid}: image shape {req.image.shape} != "
                f"{(c, h, h)}")
        self.queue.append(req)

    def _forward_for(self, bucket: int, rung: Rung) -> Callable:
        """The forward of (shard bucket, rung): the rung's plan from the
        cache (``_run_guarded`` has just planned it) on the rung's engine,
        sharded over the mesh where there is one, returning
        (probabilities, the finite check); each run files one card's
        modeled bytes under (bucket, rung name)."""
        key = (bucket, rung.name)
        if key not in self._fwd:
            # ``bucket`` is the per-shard bucket: pre_sharded, or the key
            # would divide by devices a second time
            plan = self.cache.peek_fused(self.cfg, bucket, dtype=self.dtype,
                                         policy=rung.policy,
                                         stack=rung.stack,
                                         devices=self.devices,
                                         pre_sharded=True)
            if plan is None:
                plan, _, _ = self.cache.fused_plan(self.cfg, bucket,
                                                   dtype=self.dtype,
                                                   policy=rung.policy,
                                                   stack=rung.stack,
                                                   devices=self.devices,
                                                   pre_sharded=True)
            scfg = self.cfg.replace(batch=bucket)   # the shard's config

            def fwd(x: torch.Tensor):
                if self.mesh is None:
                    y, stats = self.model(x, plan, rung.impl)
                else:
                    y, stats = forward_fused_sharded(
                        self._replicas, x, scfg, plan, self.mesh,
                        impl=rung.impl)
                self._plan_stats[key] = stats.hbm_bytes
                return y, batch_output_ok(y)

            self._fwd[key] = fwd
        return self._fwd[key]

    # -- guarded execution ---------------------------------------------------

    def _qkey(self, bucket: int, rung: Rung) -> Tuple[int, str, str, str]:
        """Quarantine key: the (bucket, policy, stack) plan variant and the
        engine running it."""
        return (bucket, rung.policy, rung.stack, rung.impl)

    def _shard_bucket(self, B: int) -> int:
        """The per-shard bucket an admitted batch of ``B`` lands in (the
        bucket itself where devices == 1)."""
        return self.cache.bucket(-(-B // self.devices))

    def _run_guarded(self, x_np: np.ndarray, B: int) -> _GuardResult:
        """Run one admitted batch down the ladder.  Raises ``ServingFault``
        when every rung failed, and a kernel's build or launch error at
        once; the caller re-queues the batch either way."""
        bucket = self._shard_bucket(B)
        # the first rung not quarantined; a fully quarantined bucket still
        # serves on the last rung
        start = next((i for i, r in enumerate(self.ladder)
                      if self._qkey(bucket, r) not in self._quarantine),
                     len(self.ladder) - 1)
        delay = self.backoff_s
        errors: List[str] = []
        for i in range(start, len(self.ladder)):
            rung = self.ladder[i]
            quals = (rung.name, rung.policy, rung.impl)
            t0 = time.perf_counter()
            try:
                if self.injector is not None:
                    self.injector.maybe_slow(quals)
                    self.injector.maybe_kernel_fault(quals)
                _, _, hit = self.cache.fused_plan(
                    self.cfg, B, dtype=self.dtype, policy=rung.policy,
                    stack=rung.stack, devices=self.devices)
                fwd = self._forward_for(bucket, rung)
                x = torch.from_numpy(x_np).to(self.device,
                                              torch_dtype(self.dtype))
                with torch.inference_mode():
                    # global pad: every shard gets exactly ``bucket`` rows
                    y, ok = fwd(pad_to_bucket(x, bucket * self.devices))
                    ok = bool(ok)              # synchronizes
                probs = y.float().cpu().numpy()
                if self.injector is not None:
                    probs = self.injector.maybe_poison(probs, quals)
                if not (ok and np.isfinite(probs[:B]).all()):
                    raise NonFiniteOutput(
                        f"non-finite batch output (bucket={bucket}, "
                        f"rung={rung.name})")
                return _GuardResult(bucket, rung, i, probs,
                                    time.perf_counter() - t0, hit)
            except KERNEL_ERRORS:
                raise
            except Exception as e:     # noqa: BLE001 — the guard IS the
                # handler: any other failure steps down the ladder
                kind = ("nonfinite" if isinstance(e, NonFiniteOutput)
                        else "kernel_fault")
                self.incidents.record(
                    kind, f"bucket={bucket} rung={rung.name}: {e}")
                rep = self.reports.setdefault(bucket, BucketReport(bucket))
                rep.failures += 1
                qk = self._qkey(bucket, rung)
                if qk not in self._quarantine:
                    self._quarantine.add(qk)
                    self.incidents.record(
                        "quarantine",
                        f"bucket={bucket} variant=({rung.policy},"
                        f"{rung.stack},{rung.impl})")
                errors.append(f"{rung.name}: {type(e).__name__}: {e}")
                if i + 1 < len(self.ladder) and delay > 0.0:
                    time.sleep(min(delay, 2.0))
                    delay *= 2.0       # exponential backoff down the chain
        raise ServingFault(
            f"all rungs failed for bucket {bucket}: {'; '.join(errors)}")

    # -- serving loop --------------------------------------------------------

    def step(self) -> List[ImageRequest]:
        """Drain up to ``max_bucket * devices`` queued requests as one
        fused batch.
        The batch completes on some rung of the ladder, or returns to the
        FRONT of the queue in its order before the error propagates: a
        failed step loses no request."""
        if not self.queue:
            return []
        batch = [self.queue.popleft()
                 for _ in range(min(len(self.queue),
                                    self.cache.max_bucket * self.devices))]
        B = len(batch)
        x_np = np.stack([r.image for r in batch])
        try:
            res = self._run_guarded(x_np, B)
        except BaseException:
            self.queue.extendleft(reversed(batch))
            self.incidents.record(
                "requeue", f"{B} in-flight requests re-queued (front, "
                f"original order)")
            raise
        rep = self.reports.setdefault(res.bucket, BucketReport(res.bucket))
        rep.hits += int(res.hit)
        rep.misses += int(not res.hit)
        for i, r in enumerate(batch):
            r.probs = res.probs[i]
        rep.batches += 1
        rep.images += B
        rep.padded += res.bucket * self.devices - B
        per_chip = self._plan_stats[(res.bucket, res.rung.name)]
        rep.per_chip_bytes += per_chip
        rep.hbm_bytes += per_chip * self.devices
        rep.seconds += res.seconds
        rep.rung = res.rung.name
        if res.rung_index > 0:
            rep.degraded += 1
            self.incidents.record("degraded")
        # serving and training share one anomaly detector: each batch's
        # time feeds its bucket's watchdog; a flagged batch is an incident
        wd = self._watchdogs.setdefault(
            res.bucket, StragglerWatchdog(
                on_straggler=lambda step, dt, mean: log.warning(
                    "serving straggler: bucket=%d step=%d %.3fs (mean "
                    "%.3fs)", res.bucket, step, dt, mean)))
        if wd.observe(rep.batches, res.seconds):
            self.incidents.record("straggler",
                                  f"bucket={res.bucket} {res.seconds:.3f}s")
        return batch

    def run(self, requests: List[ImageRequest],
            rng: Optional[np.random.Generator] = None,
            on_batch: Optional[Callable[[List[ImageRequest]], None]] = None
            ) -> Dict[int, np.ndarray]:
        """Serve ``requests`` to completion: rid -> class probabilities.
        Without ``rng`` they are queued at once; with it they arrive in
        bursts, the reference's bursty arrivals: chunks of 1..max_bucket
        requests (sizes drawn from ``rng``), one step a chunk, then the
        queue drained.  A fully failed step re-queues its batch and is
        retried (the quarantine starts it at a lower rung), up to
        ``max_step_failures`` failures in a row.  ``on_batch`` sees each
        served batch.  A server that owns its cache file saves it at the
        end."""
        done: Dict[int, np.ndarray] = {}
        i = failures = 0
        while i < len(requests) or self.queue:
            if i < len(requests):
                n = (len(requests) if rng is None else
                     int(rng.integers(1, self.cache.max_bucket + 1)))
                for r in requests[i:i + n]:
                    self.submit(r)
                i += n
            try:
                served = self.step()
            except ServingFault as e:
                failures += 1
                if failures > self.max_step_failures:
                    raise
                log.warning("step failed on every rung (%s); requests "
                            "re-queued", e)
                continue
            failures = 0
            if on_batch is not None:
                on_batch(served)
            for r in served:
                done[r.rid] = r.probs
        if self._persist:
            self.cache.save()
        return done

    # -- reporting -----------------------------------------------------------

    def _top_plan(self, bucket: int):
        """The top rung's cached plan of ``bucket``: None once evicted, or
        when the rung failed before it planned."""
        top = self.ladder[0]
        return self.cache.peek_fused(self.cfg, bucket, dtype=self.dtype,
                                     policy=top.policy, stack=top.stack,
                                     devices=self.devices, pre_sharded=True)

    def prediction_errors(self) -> Dict[int, float]:
        """Per-bucket relative error of the top rung's plan's modeled
        seconds against the measured seconds a batch.  Modeled seconds are
        not any one machine's clock, so ONE global scale, the geomean of
        measured/modeled across buckets, is fitted first: the error says
        how well the model shapes the buckets, which is what the planner
        relies on."""
        pairs: Dict[int, Tuple[float, float]] = {}
        for b, rep in self.reports.items():
            plan = self._top_plan(b)
            if plan is None or not rep.batches or rep.seconds <= 0.0:
                continue
            if plan.total_s <= 0.0:
                continue
            pairs[b] = (plan.total_s, rep.seconds / rep.batches)
        if not pairs:
            return {}
        scale = float(np.exp(np.mean(
            [np.log(m / a) for a, m in pairs.values()])))
        return {b: abs(scale * a - m) / m for b, (a, m) in pairs.items()}

    def report_lines(self) -> List[str]:
        dev = (torch.cuda.get_device_name(self.device)
               if self.device.type == "cuda" else "cpu")
        rows = " ".join(
            f"thresholds[{row}]=Ct:{th.Ct},Nt:{th.Nt}"
            for row in self.rows
            for th in [self.cache.thresholds_for(row, self._hw)])
        lines = [f"net={self.cfg.name} image_hw={self.cfg.image_hw} "
                 f"dtype={self.dtype} policy={self.dtype_policy} "
                 f"stack={self.stack} impl={self.impl} device={dev} "
                 f"devices={self.devices} "
                 f"hw={self._hw} {rows} "
                 f"hit_rate={self.cache.stats.hit_rate:.2f} "
                 f"planner_calls={self.cache.planner_calls} "
                 f"ladder={','.join(r.name for r in self.ladder)}"]
        errs = self.prediction_errors()
        for b in sorted(self.reports):
            rep = self.reports[b]
            plan = self._top_plan(b)
            # the report must not plan what is not cached
            sig, dsig, stacks = (("(not cached)",) * 3 if plan is None else
                                 (plan.conv_signature, plan.dtype_signature,
                                  plan.stacked_convs))
            ips = rep.images / rep.seconds if rep.seconds else 0.0
            pcmb = (rep.per_chip_bytes / rep.batches / 1e6 if rep.batches
                    else 0.0)
            perr = f"{errs[b]:.2f}" if b in errs else "n/a"
            wd = self._watchdogs.get(b)
            lines.append(
                f"  bucket={b:<4d} batches={rep.batches:<4d} "
                f"images={rep.images:<5d} pad_waste={rep.padded:<4d} "
                f"hit_rate={rep.hit_rate:.2f} "
                f"conv_layouts={sig} conv_dtypes={dsig} stacks={stacks} "
                f"modeled_MB={rep.hbm_bytes / 1e6:.1f} "
                f"per_chip_MB={pcmb:.1f} img/s={ips:.1f} "
                f"pred_err={perr} rung={rep.rung or 'n/a'} "
                f"degraded={rep.degraded} failures={rep.failures} "
                f"stragglers={len(wd.flagged) if wd else 0}")
        lines.append(f"  {self.incidents.summary()} "
                     f"quarantined_variants={len(self._quarantine)}")
        return lines


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--network", default="lenet", choices=list(CNN_CONFIGS))
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--max-bucket", type=int, default=32)
    ap.add_argument("--reduced", action="store_true",
                    help="serve big nets at 96 px")
    ap.add_argument("--impl", default="cuda", choices=list(ENGINES),
                    help="the engine of every rung: cuda (the kernels; "
                         "their plain versions on --device cpu) or torch "
                         "(the plain engine)")
    ap.add_argument("--cache-path", default=None,
                    help="plan-cache JSON, read if it exists and written "
                         "after the run (default: the packaged plans, "
                         "never written)")
    ap.add_argument("--max-plans", type=int, default=None,
                    help="bound on cached plans (least-recently-hit "
                         "eviction; default: unbounded)")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "fp32", "bfloat16", "bf16"],
                    help="storage dtype: bf16 halves every activation and "
                         "weight byte and plans under its own threshold "
                         "row")
    ap.add_argument("--dtype-policy", default="uniform",
                    choices=list(DTYPE_POLICIES),
                    help="mixed: per-layer (layout, dtype) plans whose "
                         "interior conv chains store int8; boundaries stay "
                         "--dtype")
    ap.add_argument("--calibration", default="measured",
                    choices=list(CALIBRATIONS),
                    help="thresholds: time K1/K2 on the card (persisted "
                         "beside --cache-path) or sweep the H100 model")
    ap.add_argument("--inject", default="",
                    help="fault-injection spec 'site=rate,...', e.g. "
                         "'kernel=0.1,nan@mixed=1.0,slow=0.05'; sites are "
                         "kernel/nan/slow, optionally qualified @rung-name, "
                         "@policy or @impl; empty = injection off")
    ap.add_argument("--inject-seed", type=int, default=0,
                    help="seed of the fault injector")
    ap.add_argument("--backoff", type=float, default=0.0,
                    help="first delay (s) between rungs of the ladder, "
                         "doubling down it")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard each batch data-parallel over this many "
                         "cards (the first ones; with --device cpu, CPU "
                         "copies); plans are made for the per-shard bucket")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device; 'cpu' runs the plain "
                         "versions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    srv = CNNServer(args.network, reduced=args.reduced,
                    max_bucket=args.max_bucket, cache_path=args.cache_path,
                    device=args.device, seed=args.seed, impl=args.impl,
                    calibration=args.calibration, dtype=args.dtype,
                    dtype_policy=args.dtype_policy, max_plans=args.max_plans,
                    injector=parse_inject_spec(args.inject,
                                               seed=args.inject_seed),
                    backoff_s=args.backoff, devices=args.devices)
    rng = np.random.default_rng(args.seed)
    c, h = srv.cfg.in_channels, srv.cfg.image_hw
    reqs = [ImageRequest(i, rng.standard_normal((c, h, h), np.float32))
            for i in range(args.requests)]
    t0 = time.perf_counter()
    done = srv.run(reqs, rng=rng)
    dt = time.perf_counter() - t0
    dropped = len(reqs) - len(done)
    # replans of a key already planned once (a bounded cache's evictions)
    rr = sum(max(0, st.misses - 1) for st in srv.cache.per_key.values())
    print(f"served {len(done)}/{len(reqs)} requests in {dt:.2f}s "
          f"({len(done) / dt:.1f} img/s overall, dropped={dropped}, "
          f"devices={srv.devices}, replans_repeat={rr})")
    for line in srv.report_lines():
        print(line)


if __name__ == "__main__":
    main()
