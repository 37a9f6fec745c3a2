"""Fused CNN executor (``repro/cnn/network.py``, the fused half).

``forward_fused`` runs a ``FusedPlan`` op by op: each conv op is ONE
kernel launch that folds its ReLU, its pool and every re-layout into the
conv's output write (or its input read), so no standalone transform pass
runs on a stock plan.  A stack op (``op.stack_index``) runs two convs in
one launch, and their mid activation is never stored.  ``RunStats``
reports the modeled device-memory traffic with the reference's accounting,
so the two packages report the same bytes for the same plan.

Inference at one uniform dtype is what runs here; int8 storage boundaries
and training raise ``NotImplementedError``.  ``FusedCNN`` owns the
parameters for a server.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import CNNConfig
from repro_torch.cnn import layers as CL
from repro_torch.core.selector import FusedPlan
from repro_torch.core.transform import apply_transform
from repro_torch.dtypes import INT8_DTYPE, canon_dtype


def input_shape(cfg: CNNConfig) -> Tuple[int, int, int, int]:
    return (cfg.batch, cfg.in_channels, cfg.image_hw, cfg.image_hw)


@dataclass
class RunStats:
    transforms: int = 0             # STANDALONE re-layout passes executed
    transform_bytes: int = 0        # device-memory bytes those passes moved
    fused_ops: int = 0              # kernels that folded an epilogue/layout
    hbm_bytes: int = 0              # modeled forward traffic of the run


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# Per-kind traffic accounting, as the reference prices each layer kind.
def _acct_eltwise(stats: RunStats, x: torch.Tensor) -> None:
    """relu / softmax: read + write."""
    stats.hbm_bytes += 2 * _nbytes(x)


def _acct_flatten(stats: RunStats, x: torch.Tensor, cur_layout: str) -> None:
    """Free reshape from NCHW; a real re-layout from CHWN."""
    stats.hbm_bytes += 2 * _nbytes(x) if cur_layout == "CHWN" else 0


def _acct_fc(stats: RunStats, io_b: int) -> None:
    stats.hbm_bytes += io_b


def _acct_pool(stats: RunStats, in_b: int, out_b: int) -> None:
    stats.hbm_bytes += in_b + out_b


def _is_int8(dtype_name: str) -> bool:
    return bool(dtype_name) and canon_dtype(dtype_name) == INT8_DTYPE


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
    until its last consumer."""
    if training:
        raise NotImplementedError(
            "fused training needs the backward kernels (K6 wgrad, K7 pool "
            "backward, K8 softmax cross-entropy), which are not ported yet")
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
        stats.hbm_bytes += 2 * _nbytes(t)
        return apply_transform(t, t_lay, lay)

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
            _acct_pool(stats, in_b, _nbytes(x))
            if op.dst_layout != op.layout:
                stats.fused_ops += 1
            cur = op.dst_layout
        elif spec.kind == "relu":    # un-folded act (post-flatten)
            x = CL.relu_forward(x)
            _acct_eltwise(stats, x)
        elif op.kind == "flatten":
            _acct_flatten(stats, x, cur)
            x = CL.flatten_forward(x, cur)
        elif op.kind == "fc":
            p = params[spec.name]
            in_b = _nbytes(x)
            x = CL.fc_forward(x, p["w"], p["b"])
            _acct_fc(stats, in_b + _nbytes(p["w"]) + _nbytes(p["b"])
                     + _nbytes(x))
        elif op.kind == "softmax":
            x = CL.softmax_forward(x, impl=impl)
            _acct_eltwise(stats, x)
        elif op.kind == "add":       # standalone residual add (un-folded)
            b2, b_lay = take(op.inputs[1])
            x = retuned(x, cur, op.layout) + retuned(b2, b_lay, op.layout)
            cur = op.layout
            stats.hbm_bytes += 3 * _nbytes(x)
        elif op.kind == "concat":
            parts = [retuned(x, cur, op.layout)]
            parts += [retuned(*take(p), op.layout) for p in op.inputs[1:]]
            x = CL.concat_forward(parts, op.layout)
            cur = op.layout
            stats.hbm_bytes += 2 * _nbytes(x)
        elif op.kind == "upsample":
            x = CL.upsample_forward(retuned(x, cur, op.layout), op.layout,
                                    spec.kernel)
            cur = op.layout
            stats.hbm_bytes += 2 * _nbytes(x)
        else:
            raise ValueError(f"unknown op kind {op.kind!r}")
        prev_key = op.out_index if op.out_index >= 0 else op.index
        outs[prev_key] = (x, cur)
    return x, stats


def batch_output_ok(y: torch.Tensor) -> torch.Tensor:
    """One all-finite reduction over the class probabilities: a 0-d bool
    tensor (on y's device) that is False for a poisoned batch."""
    return torch.isfinite(y.float()).all()


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
