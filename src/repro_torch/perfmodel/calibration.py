"""Threshold calibration and predicted-vs-measured cross-validation
(``repro/perfmodel/calibration.py``; paper §IV.A-B, Fig. 4; DeLTA, Lym et
al. 2019).

1. **The paper's (Ct, Nt) thresholds.**  ``calibrate`` is the one-time
   profiling sweep of Fig. 4: over the cost model (a ``Hardware``
   profile), or over a ``measure(layer, layout) -> seconds`` callback;
   ``card_conv_measure`` times the port's conv kernels K1 (CHWN) and K2
   (NCHW) on the card with CUDA events.  ``select_conv_layout`` /
   ``select_pool_layout`` apply the two-rule decision per layer.
   Thresholds persist as rows keyed by (hardware id, storage dtype), in
   the reference's file format: ``hardware_id`` is the CUDA device's name
   (or "cpu"); legacy files (flat {Ct, Nt} or per-dtype ``rows``) load as
   the unversioned ``default`` row, which lookups fall back to.

2. **Cross-validation.**  ``cross_validate`` times the kernels on the
   sweep, fits the ``CalibratedCostModel`` overlay (``t = a * s^b`` per
   layout) and reports each point's predicted-vs-measured error.
"""
from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.paper_table1 import ConvLayer, PoolLayer
from repro_torch.dtypes import DEFAULT_DTYPE, canon_dtype, dtype_bytes
from repro_torch.perfmodel.hardware import Hardware, hardware_id
from repro_torch.perfmodel.traffic import DEFAULT_DTYPE_BYTES, conv_cost
from repro_torch.runtime.resilience import atomic_json_dump, load_json

# Row key for threshold files that predate hardware versioning (and for
# callers that do not say where their measurements came from).
DEFAULT_HARDWARE = "default"


# ---------------------------------------------------------------------------
# the paper's two-threshold heuristic + calibration sweep
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Thresholds:
    Ct: int
    Nt: int


def select_conv_layout(l: ConvLayer, th: Thresholds) -> str:
    """Verbatim paper heuristic (§IV.A): CHWN for few input channels or a
    large batch, NCHW otherwise."""
    if l.Ci < th.Ct:
        return "CHWN"
    if l.N >= th.Nt:
        return "CHWN"
    return "NCHW"


def select_pool_layout(l: Optional[PoolLayer] = None) -> str:
    """Paper §IV.B: pooling always prefers CHWN (its windows slide along
    the contiguous W in NCHW, which the GPU reads uncoalesced)."""
    return "CHWN"


def _cal_base() -> ConvLayer:
    return ConvLayer("CAL", 128, 384, 13, 3, 256, 1, "cal")


# the sweep points of Fig. 4: C at N = 64, then N at C = max(256, Ct)
C_SWEEP = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
N_SWEEP = (16, 32, 64, 128, 256, 512)


def calibrate(measure: Optional[Callable[[ConvLayer, str], float]] = None,
              base: Optional[ConvLayer] = None,
              dtype_bytes: int = DEFAULT_DTYPE_BYTES,
              hw: Optional[Hardware] = None) -> Thresholds:
    """One-time per-hardware calibration (paper Fig. 4).

    Sweeps C with fixed N (Ct = the first C where NCHW wins) and N at
    mid-size C (Nt = the first N where CHWN wins again), over the cost
    model on ``hw`` (the port's default profile unless given) or over the
    ``measure(layer, layout) -> seconds`` callback.  ``dtype_bytes`` is the
    storage element size the thresholds are valid for.
    """
    base = base or _cal_base()
    cost = measure or (lambda l, lay: conv_cost(l, lay, dtype_bytes,
                                                hw).total_s)

    Ct = 1
    for c in C_SWEEP:
        l = ConvLayer("CAL", 64, base.Co, base.HW, base.F, c, base.S, "cal")
        if cost(l, "NCHW") < cost(l, "CHWN"):
            Ct = c
            break
    else:
        Ct = 512

    Nt = None
    for n in N_SWEEP:
        l = ConvLayer("CAL", n, base.Co, base.HW, base.F, max(base.Ci, Ct),
                      base.S, "cal")
        if cost(l, "CHWN") <= cost(l, "NCHW"):
            Nt = n
            break
    if Nt is None:
        Nt = 1 << 30     # CHWN never wins at high C on this hardware
    return Thresholds(Ct=Ct, Nt=Nt)


# ---------------------------------------------------------------------------
# persisted threshold rows: {hardware id: {dtype: {Ct, Nt}}}
# ---------------------------------------------------------------------------

def _parse_table(obj: Dict) -> Dict[str, Dict[str, Dict]]:
    if "hardware" in obj:
        return {hw: {canon_dtype(k): v for k, v in ent.get("rows", {}).items()}
                for hw, ent in obj["hardware"].items()}
    if "rows" in obj:
        return {DEFAULT_HARDWARE:
                {canon_dtype(k): v for k, v in obj["rows"].items()}}
    if "Ct" in obj:                    # legacy single-row file
        return {DEFAULT_HARDWARE:
                {DEFAULT_DTYPE: {"Ct": obj["Ct"], "Nt": obj["Nt"]}}}
    return {}


def _load_table(path: str) -> Dict[str, Dict[str, Dict]]:
    """All persisted rows keyed (hardware id, canonical dtype), from the
    v3 hardware-versioned format, the v2 per-dtype format or the legacy
    flat file (both pre-v3 shapes become the ``DEFAULT_HARDWARE`` row).  A
    missing file is an empty table; a corrupt one raises
    ``CorruptStateError``."""
    if not os.path.exists(path):
        return {}
    return _parse_table(load_json(path))


def save_thresholds(th: Thresholds, path: str, *,
                    dtype: str = DEFAULT_DTYPE,
                    source: str = "measured",
                    hardware: Optional[str] = None) -> str:
    """Merge one (hardware, dtype) row into the persisted threshold table
    (``hardware=None``: the unversioned default row), crash-safely."""
    dtype = canon_dtype(dtype)
    hw = hardware or DEFAULT_HARDWARE
    table = _load_table(path)
    table.setdefault(hw, {})[dtype] = {**dataclasses.asdict(th),
                                       "source": source}
    atomic_json_dump({"version": 3,
                      "hardware": {h: {"rows": rows}
                                   for h, rows in table.items()}}, path)
    return path


def load_thresholds(path: str, dtype: str = DEFAULT_DTYPE,
                    hardware: Optional[str] = None) -> Thresholds:
    """The persisted row for (``hardware``, ``dtype``), falling back to the
    unversioned default row; KeyError when neither exists (the caller
    calibrates).  ``hardware=None`` means this machine (``hardware_id``)."""
    table = _load_table(path)
    dtype = canon_dtype(dtype)
    cands = [hardware or hardware_id(), DEFAULT_HARDWARE]
    for hw in cands:
        row = table.get(hw, {}).get(dtype)
        if row is not None:
            return Thresholds(Ct=row["Ct"], Nt=row["Nt"])
    raise KeyError(f"no threshold row for dtype={dtype!r} under any of "
                   f"{cands} in {path}")


def card_conv_measure(*, proxy_hw: Optional[int] = None,
                      proxy_co: Optional[int] = None, reps: int = 10,
                      dtype: str = DEFAULT_DTYPE, device="cuda"
                      ) -> Callable[[ConvLayer, str], float]:
    """A ``measure(layer, layout) -> seconds`` callback that times the
    port's conv kernels on the card: K1 (``conv_direct_chwn``) for "CHWN"
    on a CHWN input, K2 (``conv_im2col_nchw_fused``) for "NCHW".  After one
    warm-up launch, three rounds of ``reps`` launches each run between CUDA
    events; the fastest round's mean is the time (the sweep's crossovers
    sit on differences of a few percent, which one short round misses).

    N and Ci come from the layer; HW and Co too unless ``proxy_hw`` /
    ``proxy_co`` clamp them (``proxied_layer``).  Operands are seeded
    random fp32 (the only dtype the conv kernels take).  Raises unless
    ``device`` is a CUDA device: the measure times kernels, never their
    plain versions."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"card_conv_measure times the conv kernels on a CUDA device, "
            f"not on {device}")
    if canon_dtype(dtype) != "float32":
        raise ValueError(f"the conv kernels take float32, not {dtype!r}")
    from repro_torch.kernels.conv.ops import (conv_direct_chwn,
                                              conv_im2col_nchw_fused)

    def measure(l: ConvLayer, layout: str) -> float:
        hw = l.HW if proxy_hw is None else max(min(l.HW, proxy_hw), l.F)
        co = l.Co if proxy_co is None else min(l.Co, proxy_co)
        g = torch.Generator(device=device).manual_seed(0)
        w = 0.1 * torch.randn((co, l.Ci, l.F, l.F), generator=g,
                              device=device)
        if layout == "CHWN":
            x = torch.randn((l.Ci, hw, hw, l.N), generator=g, device=device)
            wk = w.permute(1, 2, 3, 0).contiguous()

            def f():
                return conv_direct_chwn(x, wk, l.S, 0)
        elif layout == "NCHW":
            x = torch.randn((l.N, l.Ci, hw, hw), generator=g, device=device)

            def f():
                return conv_im2col_nchw_fused(x, w, l.S, 0)
        else:
            raise ValueError(layout)
        f()                                 # warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        best = float("inf")
        for _ in range(3):
            start.record()
            for _ in range(reps):
                f()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / reps / 1e3)
        return best

    return measure


def proxied_layer(l: ConvLayer, *, proxy_hw: int = 8,
                  proxy_co: int = 32) -> ConvLayer:
    """The layer a proxied measurement times: N and Ci verbatim, HW/Co
    clamped to the proxy.  Analytic predictions compared against such a
    measurement are computed on this layer."""
    hw = max(min(l.HW, proxy_hw), l.F)
    co = min(l.Co, proxy_co)
    return dataclasses.replace(l, HW=hw, Co=co)


def measured_thresholds(path: Optional[str] = None, *,
                        dtype: str = DEFAULT_DTYPE, force: bool = False,
                        measure: Optional[Callable[[ConvLayer, str], float]]
                        = None, hardware: Optional[str] = None
                        ) -> Thresholds:
    """Serving-default thresholds for one storage dtype: the persisted
    measurement for this hardware + ``dtype`` when ``path`` has it (unless
    ``force``), else ``calibrate`` with ``measure`` (default: the card
    measure) merged into ``path`` under this machine's hardware id."""
    dtype = canon_dtype(dtype)
    hw = hardware or hardware_id()
    if path and os.path.exists(path) and not force:
        try:
            return load_thresholds(path, dtype, hardware=hw)
        except KeyError:
            pass                        # file exists but lacks this row
    th = calibrate(measure or card_conv_measure(dtype=dtype),
                   dtype_bytes=dtype_bytes(dtype))
    if path:
        save_thresholds(th, path, dtype=dtype, source="measured",
                        hardware=hw)
    return th


# ---------------------------------------------------------------------------
# predicted-vs-measured cross-validation (the DeLTA loop)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class CalibrationPoint:
    """One sweep point: the layer timed next to what the (calibrated)
    analytic model predicted for it."""
    Ci: int
    N: int
    layout: str
    analytic_s: float        # raw roofline seconds, no measured overlay
    predicted_s: float       # after the fitted per-layout scale
    measured_s: float
    rel_err: float           # |predicted - measured| / measured

    def to_obj(self) -> Dict:
        return dataclasses.asdict(self)


@dataclass
class CrossValidation:
    """The fitted overlay + its residuals for one (hardware, dtype)."""
    hardware: str
    dtype: str
    scales: Dict[str, Tuple[float, float]]   # layout -> (a, b): t = a * s^b
    points: List[CalibrationPoint]
    mean_rel_err: float
    max_rel_err: float

    def to_obj(self) -> Dict:
        return {"hardware": self.hardware, "dtype": self.dtype,
                "scales": {k: list(v) for k, v in self.scales.items()},
                "mean_rel_err": self.mean_rel_err,
                "max_rel_err": self.max_rel_err,
                "points": [p.to_obj() for p in self.points]}


def _fit_overlay(pairs: List[Tuple[float, float]]) -> Tuple[float, float]:
    """Fit measured ≈ a * analytic^b in log space (geometric-mean
    residuals: a 2x error on a fast point weighs the same as on a slow
    one)."""
    lp = [math.log(max(p, 1e-12)) for p, _ in pairs]
    lm = [math.log(max(m, 1e-12)) for _, m in pairs]
    n = len(pairs)
    mp, mm = sum(lp) / n, sum(lm) / n
    var = sum((x - mp) ** 2 for x in lp)
    if var < 1e-12:
        return math.exp(mm - mp), 1.0      # all analytic values equal
    b = sum((x - mp) * (y - mm) for x, y in zip(lp, lm)) / var
    a = math.exp(mm - b * mp)
    return a, b


def cross_validate(measure: Optional[Callable[[ConvLayer, str], float]]
                   = None, *, dtype: str = DEFAULT_DTYPE,
                   hardware: Optional[str] = None,
                   proxy_hw: int = 8, proxy_co: int = 32,
                   reps: int = 10,
                   c_points: Tuple[int, ...] = (4, 32, 128),
                   n_points: Tuple[int, ...] = (16, 64, 256),
                   hw: Optional[Hardware] = None) -> CrossValidation:
    """Time the kernels on the calibration sweep (``measure``, default the
    card measure at the proxy size) and score the analytic model on ``hw``
    against them: per layout a two-parameter overlay (``_fit_overlay``)
    maps analytic roofline seconds onto the measured clock (what
    ``CalibratedCostModel`` applies), and each point reports the relative
    error of the calibrated prediction.  The analytic side is computed on
    ``proxied_layer``, the layer the measurement ran."""
    dtype = canon_dtype(dtype)
    db = dtype_bytes(dtype)
    hw_id = hardware or hardware_id()
    measure = measure or card_conv_measure(
        proxy_hw=proxy_hw, proxy_co=proxy_co, reps=reps, dtype=dtype)
    base = _cal_base()
    sweep = ([ConvLayer("CAL", 64, base.Co, base.HW, base.F, c, base.S,
                        "cal") for c in c_points] +
             [ConvLayer("CAL", n, base.Co, base.HW, base.F, base.Ci, base.S,
                        "cal") for n in n_points])
    raw: Dict[str, List[Tuple[ConvLayer, float, float]]] = {}
    for l in sweep:
        proxy = proxied_layer(l, proxy_hw=proxy_hw, proxy_co=proxy_co)
        for lay in ("CHWN", "NCHW"):
            analytic = conv_cost(proxy, lay, db, hw).total_s
            measured = measure(l, lay)
            raw.setdefault(lay, []).append((l, analytic, measured))
    scales: Dict[str, Tuple[float, float]] = {}
    points: List[CalibrationPoint] = []
    for lay, rows in raw.items():
        a, b = _fit_overlay([(an, me) for _, an, me in rows])
        scales[lay] = (a, b)
        for l, an, me in rows:
            pred = a * (an ** b)
            err = abs(pred - me) / max(me, 1e-12)
            points.append(CalibrationPoint(
                Ci=l.Ci, N=l.N, layout=lay, analytic_s=an,
                predicted_s=pred, measured_s=me, rel_err=err))
    errs = [p.rel_err for p in points]
    return CrossValidation(hardware=hw_id, dtype=dtype, scales=scales,
                           points=points,
                           mean_rel_err=sum(errs) / len(errs),
                           max_rel_err=max(errs))
