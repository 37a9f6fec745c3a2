"""Layout-aware CNN executors (``repro/cnn/network.py``).

Two executors, as in the reference:

* The paper's unfused executor.  ``plan_network`` assigns a layout per
  layer in one of the paper's §VI modes ("cuda-convnet": every layer CHWN;
  "cudnn": every layer NCHW; "opt": per layer, by the layout DP or the
  §IV.D heuristic, priced on the H100 profile unless a cost model is
  given).  ``forward`` runs each conv and pool natively in its layout
  (a bare conv: no bias, no epilogue) and inserts a standalone transform
  wherever consecutive layers disagree; on the "cuda" engine that
  transform is the tiled transpose kernel K9.
* The fused executor.  ``plan_network_fused`` plans a ``FusedPlan``;
  ``forward_fused`` runs it op by op:
  each conv op is ONE kernel launch that folds its ReLU, its pool and every
  re-layout into the conv's output write (or its input read), so no
  standalone transform pass runs on a stock plan.  A stack op
  (``op.stack_index``) runs two convs in one launch, and their mid
  activation is never stored.

Both report ``RunStats``: the modeled device-memory traffic with the
reference's accounting, so the two packages report the same bytes for the
same plan; ``training=True`` adds the backward pass's bytes
(``bwd_hbm_bytes``).  Both run at one uniform dtype; int8 storage
boundaries raise ``NotImplementedError``.  ``FusedCNN`` owns the
parameters for a server.

Training, as the reference's: ``make_train_step_fused`` is SGD with
momentum over ``loss_fn_fused``, the fused forward whose backward flows
through the kernels' autograd Functions (K1/K2 with ``save_act``, dgrad on
K1/K2, K6, K7, the stack recompute); ``make_train_step`` autodiffs the
unfused ``forward`` (on the plain engine by default, as the reference
autodiffs its XLA forward).  Parameters are a plain {layer: {"w", "b"}}
dict of tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import CNNConfig
from repro_torch.configs.paper_table1 import ConvLayer, PoolLayer
from repro_torch.cnn import layers as CL
from repro_torch.core.selector import (FusedPlan, LayerDesc,
                                       assign_layouts,
                                       paper_heuristic_layouts, plan_fused)
from repro_torch.core.transform import apply_transform
from repro_torch.dtypes import (DEFAULT_DTYPE, INT8_DTYPE, canon_dtype,
                                dtype_bytes)
from repro_torch.perfmodel import (CostModel, Thresholds, calibrate,
                                   conv_backward_bytes, default_cost_model)

MODES = ("cuda-convnet", "cudnn", "opt")


def network_descs(cfg: CNNConfig,
                  dtype: str = DEFAULT_DTYPE) -> List[LayerDesc]:
    """Selector LayerDescs for ``cfg`` at a storage ``dtype``, as the
    reference makes them: linear configs carry no explicit edges, graph
    configs name the producers that differ from "the previous layer"."""
    db = dtype_bytes(dtype)
    descs = []
    rins = CL.resolved_cfg_inputs(cfg)
    shapes = CL.layer_shapes(cfg)
    in_shp = input_shape(cfg)
    for i, (spec, shp) in enumerate(zip(cfg.layers, shapes)):
        s0 = in_shp if rins[i][0] < 0 else shapes[rins[i][0]]
        lin = (i - 1,) if i else (-1,)
        ins = () if rins[i] == lin else rins[i]
        if spec.kind == "conv":
            conv = ConvLayer(spec.name, cfg.batch, spec.out_channels, s0[2],
                             spec.kernel, s0[1], spec.stride, cfg.name,
                             pad=spec.pad)
            descs.append(LayerDesc(spec.name, "conv", conv=conv,
                                   out_shape=shp, dtype_bytes=db,
                                   inputs=ins))
        elif spec.kind == "pool":
            pool = PoolLayer(spec.name, cfg.batch, s0[1], s0[2], spec.kernel,
                             spec.stride, cfg.name)
            descs.append(LayerDesc(spec.name, "pool", pool=pool,
                                   out_shape=shp, dtype_bytes=db,
                                   inputs=ins))
        else:
            if spec.kind not in ("relu", "fc", "softmax", "flatten",
                                 "add", "concat", "upsample"):
                raise ValueError(f"unsupported layer kind: {spec.kind!r}")
            kind = "act" if spec.kind == "relu" else spec.kind
            descs.append(LayerDesc(spec.name, kind, out_shape=shp,
                                   dtype_bytes=db, inputs=ins))
    return descs


def input_shape(cfg: CNNConfig) -> Tuple[int, int, int, int]:
    return (cfg.batch, cfg.in_channels, cfg.image_hw, cfg.image_hw)


def plan_network(cfg: CNNConfig, mode: str = "opt",
                 thresholds: Optional[Thresholds] = None,
                 use_dp: bool = True,
                 dtype: str = DEFAULT_DTYPE,
                 cost_model: Optional[CostModel] = None) -> List[str]:
    """Per-layer layout list for the unfused ``forward``, in one of the
    paper's modes, planned at the storage ``dtype``.  "opt" with ``use_dp``
    is the layout DP (``assign_layouts``); without it, the paper's
    single-scan heuristic under ``thresholds``, or under ``calibrate()``'s
    on the cost model's device when none are given.  The cost model is the
    port's default (the H100 profile) unless one is passed."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; known: {MODES}")
    descs = network_descs(cfg, dtype)
    if mode == "cuda-convnet":
        return ["CHWN"] * len(descs)
    if mode == "cudnn":
        return ["NCHW"] * len(descs)
    cm = cost_model or default_cost_model()
    if use_dp:
        return assign_layouts(descs, input_layout="NCHW",
                              input_shape=input_shape(cfg),
                              cost_model=cm).layouts
    th = thresholds or calibrate(dtype_bytes=dtype_bytes(dtype), hw=cm.hw)
    return paper_heuristic_layouts(descs, th)


def plan_network_fused(cfg: CNNConfig, dtype: str = DEFAULT_DTYPE,
                       policy: str = "uniform",
                       stack_policy: str = "auto",
                       cost_model: Optional[CostModel] = None) -> FusedPlan:
    """Fused execution plan: the layout DP with fold-aware edges and chain
    fusion (``plan_fused``), at the storage ``dtype`` (it scales every byte
    model and the granules).  ``policy="mixed"`` searches per-layer (layout,
    storage dtype) states (the executors here run uniform plans only);
    ``stack_policy="auto"`` fuses the conv->conv stacks the cost model's
    stack gate admits and finds profitable, ``"off"`` none.  The cost model
    is the port's default (the H100 profile) unless one is passed."""
    return plan_fused(network_descs(cfg, dtype), input_layout="NCHW",
                      input_shape=input_shape(cfg), dtype_policy=policy,
                      base_dtype=dtype, stack_policy=stack_policy,
                      cost_model=cost_model)


@dataclass
class RunStats:
    transforms: int = 0             # STANDALONE re-layout passes executed
    transform_bytes: int = 0        # device-memory bytes those passes moved
    fused_ops: int = 0              # kernels that folded an epilogue/layout
    hbm_bytes: int = 0              # modeled forward traffic of the run
    bwd_hbm_bytes: int = 0          # modeled backward traffic (training)

    @property
    def total_hbm_bytes(self) -> int:
        return self.hbm_bytes + self.bwd_hbm_bytes


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _conv_desc(spec, x: torch.Tensor, layout: str, batch: int,
               net: str) -> ConvLayer:
    """The cost model's ConvLayer of a conv from its input ``x`` (in
    ``layout``), as the reference's executor makes it."""
    hw = x.shape[2] if layout == "NCHW" else x.shape[1]
    ci = x.shape[1] if layout == "NCHW" else x.shape[0]
    return ConvLayer(spec.name, batch, spec.out_channels, hw, spec.kernel,
                     ci, spec.stride, net, pad=spec.pad)


# Per-kind traffic accounting, as the reference prices each layer kind.
def _acct(stats: RunStats, fwd_b: int, bwd_b: int, training: bool) -> None:
    stats.hbm_bytes += fwd_b
    if training:
        stats.bwd_hbm_bytes += bwd_b


def _acct_eltwise(stats: RunStats, x: torch.Tensor, training: bool) -> None:
    """relu / softmax: fwd read+write; bwd read g + read mask/out + write."""
    _acct(stats, 2 * _nbytes(x), 3 * _nbytes(x), training)


def _acct_flatten(stats: RunStats, x: torch.Tensor, cur_layout: str,
                  training: bool) -> None:
    """Free reshape from NCHW; a real re-layout from CHWN (both ways)."""
    b = 2 * _nbytes(x) if cur_layout == "CHWN" else 0
    _acct(stats, b, b, training)


def _acct_fc(stats: RunStats, io_b: int, training: bool) -> None:
    """bwd dx = g W^T, dW = x^T g, db: the same traffic again."""
    _acct(stats, io_b, io_b, training)


def _acct_pool(stats: RunStats, in_b: int, out_b: int,
               training: bool) -> None:
    """bwd: read g + read input (max mask) + write dx."""
    _acct(stats, in_b + out_b, 2 * in_b + out_b, training)


def _is_int8(dtype_name: str) -> bool:
    return bool(dtype_name) and canon_dtype(dtype_name) == INT8_DTYPE


def forward(params: Dict, x_nchw: torch.Tensor, cfg: CNNConfig,
            layouts: List[str], impl: str = "cuda",
            training: bool = False) -> Tuple[torch.Tensor, RunStats]:
    """Run the network unfused in the per-layer ``layouts``; x enters as
    NCHW.  Returns (class probabilities [N, classes], stats).

    ``impl="cuda"`` runs each conv as a bare K1 (CHWN) or K2 (NCHW) launch,
    each pool as K3a (CHWN) or K3b (NCHW), each re-layout as the
    transpose kernel K9 and the softmax as K4; ``impl="torch"`` is the
    plain engine (the oracle), whose re-layouts are
    ``permute().contiguous()``.  A re-layout happens only before a conv or
    a pool whose layout differs from its input's (never after flatten),
    and at add/concat/upsample.  ``training`` also accounts the plain
    autograd backward in ``stats.bwd_hbm_bytes`` (shape arithmetic, as the
    reference prices it)."""
    stats = RunStats()
    rins = CL.resolved_cfg_inputs(cfg)
    last_use: Dict[int, int] = {}
    for i, ins in enumerate(rins):
        for p in ins:
            last_use[p] = i
    # produced tensors by layer index (-1 = the network input); a write is
    # counted once at its producer, every consumer counts its own read
    outs: Dict[int, Tuple[torch.Tensor, str]] = {-1: (x_nchw, "NCHW")}
    flat = False
    x = x_nchw

    def retuned(t: torch.Tensor, t_lay: str, lay: str) -> torch.Tensor:
        """Re-layout ``t`` into ``lay``, counting the standalone pass."""
        if t_lay == lay:
            return t
        stats.transforms += 1
        stats.transform_bytes += 2 * _nbytes(t)
        _acct(stats, 2 * _nbytes(t), 2 * _nbytes(t), training)
        return apply_transform(t, t_lay, lay, use_kernel=impl == "cuda")

    for i, (spec, lay) in enumerate(zip(cfg.layers, layouts)):
        x, cur = outs[rins[i][0]]
        if spec.kind in ("conv", "pool") and lay != cur and not flat:
            x = retuned(x, cur, lay)
            cur = lay
        if spec.kind == "conv":
            w = params[spec.name]["w"]
            in_b = _nbytes(x)
            if training:
                desc = _conv_desc(spec, x, cur, cfg.batch, cfg.name)
                stats.bwd_hbm_bytes += conv_backward_bytes(
                    desc, cur, x.element_size(), fused=False)
            x = CL.conv_forward(x, w, cur, spec.stride, spec.pad, impl=impl)
            stats.hbm_bytes += in_b + _nbytes(w) + _nbytes(x)
        elif spec.kind == "pool":
            in_b = _nbytes(x)
            x = CL.pool_forward(x, cur, spec.kernel, spec.stride,
                                spec.pool_op, impl=impl)
            _acct_pool(stats, in_b, _nbytes(x), training)
        elif spec.kind == "relu":
            x = CL.relu_forward(x)
            _acct_eltwise(stats, x, training)
        elif spec.kind == "flatten":
            _acct_flatten(stats, x, cur, training)
            x = CL.flatten_forward(x, cur)
            flat = True
        elif spec.kind == "fc":
            p = params[spec.name]
            in_b = _nbytes(x)
            x = CL.fc_forward(x, p["w"], p["b"])
            _acct_fc(stats, in_b + _nbytes(p["w"]) + _nbytes(p["b"])
                     + _nbytes(x), training)
        elif spec.kind == "softmax":
            x = CL.softmax_forward(x, impl=impl)
            _acct_eltwise(stats, x, training)
        elif spec.kind == "add":
            b2, b_lay = outs[rins[i][1]]
            x = retuned(x, cur, lay) + retuned(b2, b_lay, lay)
            cur = lay
            # fwd: read both operands + write; bwd: pure gradient fan-out
            _acct(stats, 3 * _nbytes(x), 0, training)
        elif spec.kind == "concat":
            parts = [retuned(x, cur, lay)]
            parts += [retuned(*outs[p], lay) for p in rins[i][1:]]
            x = CL.concat_forward(parts, lay)
            cur = lay
            _acct(stats, 2 * _nbytes(x), 2 * _nbytes(x), training)
        elif spec.kind == "upsample":
            x = CL.upsample_forward(retuned(x, cur, lay), lay, spec.kernel)
            cur = lay
            _acct(stats, 2 * _nbytes(x), 2 * _nbytes(x), training)
        else:
            raise ValueError(f"unsupported layer kind: {spec.kind!r}")
        outs[i] = (x, cur)
        for p in set(rins[i]):
            if last_use[p] == i:
                outs.pop(p, None)
    return x, stats


def forward_fused(params: Dict, x_nchw: torch.Tensor, cfg: CNNConfig,
                  plan: FusedPlan, impl: str = "cuda",
                  training: bool = False) -> Tuple[torch.Tensor, RunStats]:
    """Run the network through the fused plan; x enters as NCHW.  Returns
    (class probabilities [N, classes], stats).

    ``impl="cuda"`` executes each conv op as one kernel (K1 for a CHWN op,
    K2 for an NCHW op, K5a/K5b for a stack op) and the softmax as K4;
    ``impl="torch"`` decomposes them into plain PyTorch (the oracle).
    Tensors are addressed by producer layer index (``op.inputs``/
    ``op.out_index``) and refcounted, so a branch buffer lives exactly
    until its last consumer.  The forward is differentiable on both
    engines; ``training`` also accounts its backward (activation stash,
    one-kernel pool+mask backward, dgrad/wgrad with the re-layouts folded,
    the stack's replay) in ``stats.bwd_hbm_bytes``, as the reference
    prices it."""
    stats = RunStats()
    nref: Dict[int, int] = {}
    for op in plan.ops:
        for p in op.inputs:
            nref[p] = nref.get(p, 0) + 1
        if op.res_index is not None:
            nref[op.res_index] = nref.get(op.res_index, 0) + 1
    outs: Dict[int, Tuple[torch.Tensor, str]] = {-1: (x_nchw, "NCHW")}
    prev_key = -1

    def take(p: int) -> Tuple[torch.Tensor, str]:
        t, t_lay = outs[p]
        left = nref.get(p, 1) - 1    # legacy plans: single consumer
        nref[p] = left
        if left <= 0:
            outs.pop(p, None)
        return t, t_lay

    def retuned(t: torch.Tensor, t_lay: str, lay: str) -> torch.Tensor:
        """Standalone re-layout (no kernel absorbed it), with accounting."""
        if t_lay == lay:
            return t
        stats.transforms += 1
        stats.transform_bytes += 2 * _nbytes(t)
        _acct(stats, 2 * _nbytes(t), 2 * _nbytes(t), training)
        return apply_transform(t, t_lay, lay, use_kernel=impl == "cuda")

    for op in plan.ops:
        spec = cfg.layers[op.index]
        x, cur = take(op.inputs[0] if op.inputs else prev_key)
        if _is_int8(op.src_dtype) or _is_int8(op.dst_dtype):
            raise NotImplementedError(
                f"op {op.name!r} stores int8; mixed-dtype plans are not "
                "ported yet: run a policy='uniform' plan")
        if op.kind == "conv" and op.stack_index is not None:
            # conv->conv stack: ``op.index`` is conv1, ``op.stack_index``
            # conv2; the mid activation stays on chip, so the bytes are the
            # input, both weights and the final output (+ the skip's read)
            spec2 = cfg.layers[op.stack_index]
            p1, p2 = params[spec.name], params[spec2.name]
            pool = None
            if op.pool_index is not None:
                ps = cfg.layers[op.pool_index]
                pool = (ps.kernel, ps.stride, ps.pool_op)
            res = res_lay = None
            if op.res_index is not None:   # residual folds into conv2
                res, res_lay = take(op.res_index)
                stats.hbm_bytes += _nbytes(res)
            in_b = _nbytes(x)
            if training:
                # a training run over a stack replays the unfused pair, so
                # price both convs plus the rematerialized mid round trip
                d1 = _conv_desc(spec, x, cur, cfg.batch, cfg.name)
                d2 = ConvLayer(spec2.name, cfg.batch, spec2.out_channels,
                               d1.out_hw, spec2.kernel, spec.out_channels,
                               spec2.stride, cfg.name, pad=spec2.pad)
                db = x.element_size()
                mid_b = cfg.batch * spec.out_channels * d1.out_hw ** 2 * db
                stats.bwd_hbm_bytes += (
                    conv_backward_bytes(d1, op.layout, db,
                                        relu=op.stack_relu, fused=True)
                    + conv_backward_bytes(d2, op.layout, db, relu=op.relu,
                                          pool=pool[:2] if pool else None,
                                          fused=True,
                                          residual=res is not None)
                    + 2 * mid_b)
            x = CL.fused_conv_stack(x, p1["w"], p2["w"], op.layout,
                                    spec.stride, spec.pad, spec2.stride,
                                    spec2.pad, relu1=op.stack_relu,
                                    relu2=op.relu, pool=pool, res=res,
                                    res_layout=res_lay, src_layout=cur,
                                    dst_layout=op.dst_layout, impl=impl)
            stats.hbm_bytes += (in_b + _nbytes(p1["w"]) + _nbytes(p2["w"])
                                + _nbytes(x))
            stats.fused_ops += 1
            cur = op.dst_layout
        elif op.kind == "conv":
            p = params[spec.name]
            pool = None
            if op.pool_index is not None:
                ps = cfg.layers[op.pool_index]
                pool = (ps.kernel, ps.stride, ps.pool_op)
            res = res_lay = None
            if op.res_index is not None:   # folded residual add: the skip
                res, res_lay = take(op.res_index)
                stats.hbm_bytes += _nbytes(res)   # epilogue's second read
            in_b = _nbytes(x)
            if training:
                desc = _conv_desc(spec, x, cur, cfg.batch, cfg.name)
                stats.bwd_hbm_bytes += conv_backward_bytes(
                    desc, op.layout, x.element_size(), relu=op.relu,
                    pool=pool[:2] if pool else None, bias="b" in p,
                    fused=True, residual=res is not None)
            x = CL.fused_conv_block(x, p["w"], op.layout, spec.stride,
                                    spec.pad, bias=p.get("b"), relu=op.relu,
                                    pool=pool, res=res, res_layout=res_lay,
                                    src_layout=cur, dst_layout=op.dst_layout,
                                    impl=impl)
            stats.hbm_bytes += in_b + _nbytes(p["w"]) + _nbytes(x)
            if "b" in p:
                stats.hbm_bytes += _nbytes(p["b"])
            if op.is_fused:          # folded an epilogue or a re-layout
                stats.fused_ops += 1
            cur = op.dst_layout
        elif op.kind == "pool":
            x = retuned(x, cur, op.layout)   # no producer absorbed it
            cur = op.layout
            in_b = _nbytes(x)
            x = CL.pool_forward(x, cur, spec.kernel, spec.stride,
                                spec.pool_op, impl=impl,
                                dst_layout=op.dst_layout)
            _acct_pool(stats, in_b, _nbytes(x), training)
            if op.dst_layout != op.layout:
                stats.fused_ops += 1
            cur = op.dst_layout
        elif spec.kind == "relu":    # un-folded act (post-flatten)
            x = CL.relu_forward(x)
            _acct_eltwise(stats, x, training)
        elif op.kind == "flatten":
            _acct_flatten(stats, x, cur, training)
            x = CL.flatten_forward(x, cur)
        elif op.kind == "fc":
            p = params[spec.name]
            in_b = _nbytes(x)
            x = CL.fc_forward(x, p["w"], p["b"])
            _acct_fc(stats, in_b + _nbytes(p["w"]) + _nbytes(p["b"])
                     + _nbytes(x), training)
        elif op.kind == "softmax":
            x = CL.softmax_forward(x, impl=impl)
            _acct_eltwise(stats, x, training)
        elif op.kind == "add":       # standalone residual add (un-folded)
            b2, b_lay = take(op.inputs[1])
            x = retuned(x, cur, op.layout) + retuned(b2, b_lay, op.layout)
            cur = op.layout
            # fwd: read both operands + write; bwd: pure gradient fan-out
            _acct(stats, 3 * _nbytes(x), 0, training)
        elif op.kind == "concat":
            parts = [retuned(x, cur, op.layout)]
            parts += [retuned(*take(p), op.layout) for p in op.inputs[1:]]
            x = CL.concat_forward(parts, op.layout)
            cur = op.layout
            _acct(stats, 2 * _nbytes(x), 2 * _nbytes(x), training)
        elif op.kind == "upsample":
            x = CL.upsample_forward(retuned(x, cur, op.layout), op.layout,
                                    spec.kernel)
            cur = op.layout
            _acct(stats, 2 * _nbytes(x), 2 * _nbytes(x), training)
        else:
            raise ValueError(f"unknown op kind {op.kind!r}")
        prev_key = op.out_index if op.out_index >= 0 else op.index
        outs[prev_key] = (x, cur)
    return x, stats


def batch_output_ok(y: torch.Tensor) -> torch.Tensor:
    """One all-finite reduction over the class probabilities: a 0-d bool
    tensor (on y's device) that is False for a poisoned batch."""
    return torch.isfinite(y.float()).all()


# ---------------------------------------------------------------------------
# training: SGD with momentum over the fused or the unfused forward
# ---------------------------------------------------------------------------

def _nll(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under the class
    probabilities, as the reference takes it (log of probabilities clipped
    at 1e-20)."""
    logp = torch.log(torch.clamp(probs.float(), min=1e-20))
    return -torch.gather(logp, 1, labels[:, None]).mean()


def loss_fn(params: Dict, x_nchw: torch.Tensor, labels: torch.Tensor,
            cfg: CNNConfig, layouts: List[str],
            impl: str = "torch") -> torch.Tensor:
    """Differentiable NLL over the unfused ``forward`` (the reference
    autodiffs its XLA forward, hence the plain engine by default)."""
    probs, _ = forward(params, x_nchw, cfg, layouts, impl=impl)
    return _nll(probs, labels)


def loss_fn_fused(params: Dict, x_nchw: torch.Tensor, labels: torch.Tensor,
                  cfg: CNNConfig, plan: FusedPlan,
                  impl: str = "cuda") -> torch.Tensor:
    """Differentiable NLL over the FUSED engine: the forward runs the fused
    kernels and the backward flows through their autograd Functions
    (dgrad on K1/K2, K6, the one-kernel pool+mask backward K7, the stack
    recompute)."""
    probs, _ = forward_fused(params, x_nchw, cfg, plan, impl=impl)
    return _nll(probs, labels)


def value_and_grad(loss, params: Dict, *args) -> Tuple[torch.Tensor, Dict]:
    """(loss(params, *args), its gradient as a tree like ``params``), with
    ``torch.autograd.grad``; ``params`` itself is left untouched."""
    leaves = {layer: {k: v.detach().requires_grad_(True)
                      for k, v in p.items()}
              for layer, p in params.items()}
    keys = [(layer, k) for layer, p in leaves.items() for k in p]
    with torch.enable_grad():
        value = loss(leaves, *args)
        grads = torch.autograd.grad(value, [leaves[l][k] for l, k in keys])
    tree: Dict[str, Dict[str, torch.Tensor]] = {layer: {} for layer in params}
    for (layer, k), gr in zip(keys, grads):
        tree[layer][k] = gr
    return value.detach(), tree


def _sgd_step(loss, lr: float, momentum: float):
    def step(params: Dict, vel: Dict, x: torch.Tensor, y: torch.Tensor):
        value, grads = value_and_grad(loss, params, x, y)
        new_vel = {layer: {k: momentum * vel[layer][k] - lr * g
                           for k, g in gs.items()}
                   for layer, gs in grads.items()}
        new_params = {layer: {k: params[layer][k] + v for k, v in vs.items()}
                      for layer, vs in new_vel.items()}
        return new_params, new_vel, value
    return step


def make_train_step(cfg: CNNConfig, layouts: List[str], lr: float = 0.01,
                    momentum: float = 0.9, impl: str = "torch"):
    """``step(params, vel, x, labels) -> (params, vel, loss)``: one SGD step
    with momentum (vel = momentum*vel - lr*grad; params += vel) over the
    unfused ``forward``."""
    return _sgd_step(lambda p, x, y: loss_fn(p, x, y, cfg, layouts, impl),
                     lr, momentum)


def make_train_step_fused(cfg: CNNConfig, plan: FusedPlan, lr: float = 0.01,
                          momentum: float = 0.9, impl: str = "cuda"):
    """The layout-aware twin of ``make_train_step``: the same SGD step over
    the fused engine (``loss_fn_fused``)."""
    return _sgd_step(lambda p, x, y: loss_fn_fused(p, x, y, cfg, plan, impl),
                     lr, momentum)


def init_velocity(params: Dict) -> Dict:
    """Zero momentum, shaped like ``params``."""
    return {layer: {k: torch.zeros_like(v) for k, v in p.items()}
            for layer, p in params.items()}


class FusedCNN(nn.Module):
    """The parameters of one network, for a server: ``forward`` runs a
    fused plan over them.  On a CPU ``device`` the "cuda" engine runs the
    kernels' plain versions."""

    def __init__(self, cfg: CNNConfig, tree: Dict[str, Dict[str, np.ndarray]],
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleDict({
            name: nn.ParameterDict({
                k: nn.Parameter(torch.as_tensor(v, device=device),
                                requires_grad=False)
                for k, v in p.items()})
            for name, p in tree.items()})

    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The parameters as the executor's {layer: {"w", "b"}} tree."""
        return {name: dict(pd.items()) for name, pd in self.layers.items()}

    def forward(self, x_nchw: torch.Tensor,
                plan: FusedPlan) -> Tuple[torch.Tensor, RunStats]:
        return forward_fused(self.params(), x_nchw, self.cfg, plan)
