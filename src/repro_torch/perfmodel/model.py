"""The ``CostModel`` interface (``repro/perfmodel/model.py``), over a
``Hardware`` profile.

Everything that prices a planner decision (the selector DPs, the serving
report) asks one of these:

* ``AnalyticCostModel``: the analytic priors of ``perfmodel.traffic`` on
  its profile ``hw`` (the port's default, the H100, unless given), so a
  plan produced through it equals one produced against the bare
  functions on the same profile.
* ``CalibratedCostModel``: those priors with a measured overlay from
  ``perfmodel.cross_validate``: per layout, seconds are mapped through the
  fitted ``t = a * s^b`` curve; bytes pass through untouched.

``plan_bytes`` replays a ``FusedPlan``'s op stream through the byte
models: the total bytes the fused engine moves, which the planner stored
in ``plan.fused_bytes`` and the executor's ``RunStats`` reports.

This module does not import ``repro_torch.core`` at module scope (the
selector imports this module); ``transform_bytes`` is pulled inside
``plan_bytes``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.paper_table1 import ConvLayer, PoolLayer
from repro_torch.dtypes import dtype_bytes as _dtype_bytes
from repro_torch.perfmodel import traffic
from repro_torch.perfmodel.calibration import (CrossValidation, Thresholds,
                                               select_conv_layout,
                                               select_pool_layout)
from repro_torch.perfmodel.hardware import Hardware
from repro_torch.perfmodel.traffic import ConvCost, DEFAULT_DTYPE_BYTES
from repro_torch.shapes import pool_out_hw


class CostModel:
    """One interface for every byte/seconds question the planner asks, on
    the device profile ``hw``.  Methods mirror the traffic functions'
    signatures so the selector's call sites stay mechanical."""

    def __init__(self, hw: Optional[Hardware] = None):
        self.hw = traffic._hw(hw)

    # --- seconds (roofline ConvCost) ------------------------------------
    def conv_cost(self, l: ConvLayer, layout: str,
                  dtype_bytes: int = DEFAULT_DTYPE_BYTES,
                  **kw) -> ConvCost:
        return self._seconds(traffic.conv_cost(l, layout, dtype_bytes,
                                               self.hw, **kw))

    def fused_chain_cost(self, l: ConvLayer, layout: str,
                         dtype_bytes: int = DEFAULT_DTYPE_BYTES,
                         **kw) -> ConvCost:
        return self._seconds(traffic.fused_chain_cost(
            l, layout, dtype_bytes, hw=self.hw, **kw))

    def stack_fused_cost(self, l1: ConvLayer, l2: ConvLayer, layout: str,
                         dtype_bytes: int = DEFAULT_DTYPE_BYTES,
                         **kw) -> ConvCost:
        return self._seconds(traffic.stack_fused_cost(
            l1, l2, layout, dtype_bytes, hw=self.hw, **kw))

    def conv_backward_cost(self, l: ConvLayer, layout: str,
                           dtype_bytes: int = DEFAULT_DTYPE_BYTES,
                           **kw) -> ConvCost:
        return self._seconds(traffic.conv_backward_cost(
            l, layout, dtype_bytes, hw=self.hw, **kw))

    def cast_cost(self, shape: Tuple[int, ...], src_dtype_bytes: int,
                  dst_dtype_bytes: int) -> float:
        return traffic.cast_cost(shape, src_dtype_bytes, dst_dtype_bytes,
                                 self.hw)

    # --- bytes (exact against the fused executor) -----------------------
    def chain_bytes(self, l: ConvLayer,
                    dtype_bytes: int = DEFAULT_DTYPE_BYTES, **kw) -> int:
        return traffic.chain_bytes(l, dtype_bytes, **kw)

    def stack_bytes(self, l1: ConvLayer, l2: ConvLayer,
                    dtype_bytes: int = DEFAULT_DTYPE_BYTES, **kw) -> int:
        return traffic.stack_bytes(l1, l2, dtype_bytes, **kw)

    def conv_backward_bytes(self, l: ConvLayer, layout: str = "CHWN",
                            dtype_bytes: int = DEFAULT_DTYPE_BYTES,
                            **kw) -> int:
        return traffic.conv_backward_bytes(l, layout, dtype_bytes, **kw)

    def cast_bytes(self, shape: Tuple[int, ...], src_dtype_bytes: int,
                   dst_dtype_bytes: int) -> int:
        return traffic.cast_bytes(shape, src_dtype_bytes, dst_dtype_bytes)

    def stack_nt(self, l1: ConvLayer, l2: ConvLayer, layout: str,
                 dtype_bytes: int = DEFAULT_DTYPE_BYTES, **kw) -> int:
        """The stack gate of ``hw`` (geometry, not a price)."""
        return traffic.stack_nt(l1, l2, layout, dtype_bytes, hw=self.hw,
                                **kw)

    def chain_fits(self, l: ConvLayer, layout: str,
                   pool: Optional[Tuple[int, int]] = None) -> bool:
        """The chain gate of ``hw``: one launch of the ``layout`` engine
        can run conv[->pool] ``l``."""
        return traffic.chain_fits(l, layout, pool, self.hw)

    # --- the paper's threshold heuristic --------------------------------
    def select_conv_layout(self, l: ConvLayer, th: Thresholds) -> str:
        return select_conv_layout(l, th)

    def select_pool_layout(self, l: Optional[PoolLayer] = None) -> str:
        return select_pool_layout(l)

    # --- measurement overlay hooks --------------------------------------
    def _seconds(self, c: ConvCost) -> ConvCost:
        """Hook for subclasses to overlay measurement on an analytic cost."""
        return c

    def predict_seconds(self, analytic_s: float,
                        layout: Optional[str] = None) -> float:
        """Wall-clock prediction for ``analytic_s`` modeled seconds (a plan's
        ``total_s``, a ConvCost total).  Analytic model: identity."""
        return analytic_s

    # --- whole-plan prediction ------------------------------------------
    def plan_bytes(self, layers: Sequence, plan, *,
                   input_shape: Optional[Tuple[int, ...]] = None,
                   input_layout: str = "NCHW",
                   training: bool = False) -> int:
        """Replay a ``FusedPlan``'s op stream through the byte models: the
        bytes the fused engine moves executing it (the planner's
        ``plan.fused_bytes``, the executor's ``RunStats.hbm_bytes``)."""
        from repro_torch.core.layout import transform_bytes
        tx = 2 if training else 1
        in_shape = tuple(input_shape) if input_shape else (
            tuple(layers[0].out_shape) if len(layers) else ())

        def shape_of(p: int) -> Tuple[int, ...]:
            return in_shape if p < 0 else tuple(layers[p].out_shape)

        stored_lay: Dict[int, str] = {-1: input_layout}
        total = 0
        flat = False
        for op in plan.ops:
            l = layers[op.index]
            db = l.dtype_bytes
            in_db = _dtype_bytes(op.src_dtype) if op.src_dtype else db
            out_db = _dtype_bytes(op.dst_dtype) if op.dst_dtype else db
            p = op.inputs[0] if op.inputs else (
                op.index - 1 if op.index else -1)
            if op.out_index >= 0:
                stored_lay[op.out_index] = op.dst_layout
            if op.kind == "conv":
                pool_t = None
                if op.pool_index is not None:
                    pl = layers[op.pool_index].pool
                    pool_t = (pl.F, pl.S)
                res = op.res_index is not None
                if op.stack_index is not None:
                    total += self.stack_bytes(
                        l.conv, layers[op.stack_index].conv, db, pool=pool_t,
                        residual=res, in_dtype_bytes=in_db,
                        out_dtype_bytes=out_db)
                    continue
                total += self.chain_bytes(
                    l.conv, db, relu=op.relu, pool=pool_t, fused=True,
                    in_dtype_bytes=in_db, out_dtype_bytes=out_db,
                    residual=res)
                if training:
                    total += self.conv_backward_bytes(
                        l.conv, op.layout, db, relu=op.relu, pool=pool_t,
                        fused=True, trainable=l.trainable, residual=res)
                continue
            if op.kind == "pool" and l.pool is not None and not flat:
                if op.index in plan.transforms:   # standalone re-layout pass
                    total += tx * transform_bytes(shape_of(p), db)
                pl = l.pool
                ho = pool_out_hw(pl.HW, pl.F, pl.S)
                in_b = pl.N * pl.C * pl.HW * pl.HW * db
                out_b = pl.N * pl.C * ho * ho * db
                total += in_b + out_b + ((2 * in_b + out_b)
                                         if training else 0)
                continue
            sz = int(np.prod(l.out_shape)) if l.out_shape else 0
            if op.kind in ("add", "concat", "upsample"):
                for pi in op.inputs:    # standalone merge: every mismatch pays
                    if stored_lay.get(pi, input_layout) != op.layout:
                        total += tx * transform_bytes(shape_of(pi), db)
                total += (3 if op.kind == "add"
                          else (4 if training else 2)) * sz * db
                continue
            if op.kind == "act" and not flat and op.index in plan.transforms:
                total += tx * transform_bytes(shape_of(p), db)
            if op.kind == "flatten":
                flat = True
                if op.src_layout == "CHWN":   # CHWN->2D: one real transpose
                    total += tx * 2 * sz * db
            elif op.kind == "fc":
                in_f = (int(np.prod(shape_of(p))) // l.out_shape[0]
                        if p >= 0 else l.out_shape[1])
                io_b = (int(np.prod(l.out_shape)) + in_f * l.out_shape[1] +
                        l.out_shape[1] + in_f * l.out_shape[0]) * db
                total += io_b * (2 if training else 1)
            else:                        # act / softmax (incl. post-flatten)
                total += (5 if training else 2) * sz * db
        return total


class AnalyticCostModel(CostModel):
    """The pure analytic priors on a profile: ``CostModel``'s base
    behaviour, named."""


class CalibratedCostModel(AnalyticCostModel):
    """Analytic priors with a measured per-layout overlay.

    ``cv.scales[layout] = (a, b)`` maps analytic roofline seconds onto the
    measured clock as ``t = a * s^b``.  Seconds-returning methods scale
    BOTH roofline components by ``overlay(total)/total``, so every
    compute-against-memory arbitration keeps its balance; byte models are
    inherited untouched."""

    def __init__(self, cv: CrossValidation, hw: Optional[Hardware] = None):
        super().__init__(hw)
        self.cv = cv
        self.scales = dict(cv.scales)

    def _overlay(self, s: float, layout: Optional[str]) -> float:
        ab = self.scales.get(layout or "")
        if ab is None and self.scales:      # no row for this layout: average
            ab = tuple(np.mean(list(self.scales.values()), axis=0))
        if ab is None or s <= 0.0:
            return s
        a, b = ab
        return a * (s ** b)

    def _seconds(self, c: ConvCost) -> ConvCost:
        t = c.total_s
        if t <= 0.0:
            return c
        k = self._overlay(t, c.layout) / t
        return ConvCost(c.layout, c.compute_s * k, c.memory_s * k)

    def predict_seconds(self, analytic_s: float,
                        layout: Optional[str] = None) -> float:
        return self._overlay(analytic_s, layout)


_DEFAULT: Optional[AnalyticCostModel] = None


def default_cost_model() -> AnalyticCostModel:
    """The process-wide analytic model on the port's default profile (the
    H100's); stateless, so one instance serves every caller that did not
    pass its own."""
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = AnalyticCostModel()
    return _DEFAULT
