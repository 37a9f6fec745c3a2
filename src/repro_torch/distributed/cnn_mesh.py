"""Data-parallel CNN serving mesh: the admitted batch split along its batch
dim over several cards, each shard running the same fused plan.

The counterpart of ``repro/distributed/cnn_mesh.py``.  The planning
invariant is the reference's: the plan is made for the SHARD batch, never
the global one.  The paper's Nt threshold makes the CHWN/NCHW choice
batch-dependent (§IV.A), so a global batch of 128 on 8 cards is sixteen
images a card, below the crossover where the 128-image plan lives.
``PlanCache`` keys plans on (per-shard bucket, devices) and plans at
``cfg.replace(batch=shard_bucket)``; this module gives the mesh, the
sharded executor and the check that the invariant holds.

The mesh is a tuple of ``torch.device``s, one a shard: the first
``devices`` cards, or, for a caller on the CPU, ``devices`` copies of the
CPU device (the counterpart of the reference's forced host devices).  Any
tuple will do for ``forward_fused_sharded``: two shards on one card
rehearse the split, the padding and the gather on the kernels.

Each shard runs ``forward_fused`` of the one per-shard plan on its own
replica of the weights, on its own card.  Every shard's forward is issued
before any is gathered, with no host synchronisation between shards: the
kernels of one card queue on its current stream while the host moves on
to the next card.  Conv, pool, fc and softmax are row-independent and
inference has no cross-shard reduction, so no process group and no
collective is needed: the shards' outputs are concatenated on the first
device.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.configs.base import CNNConfig
from repro_torch.perfmodel import CostModel

Mesh = Tuple[torch.device, ...]


def shard_batch_for(global_batch: int, devices: int) -> int:
    """Per-shard batch: the ceiling, so every request fits (the last
    shard's shortfall is padding, sliced off after the forward)."""
    if devices < 1:
        raise ValueError(f"devices must be >= 1, got {devices}")
    if global_batch < 1:
        raise ValueError(f"batch must be >= 1, got {global_batch}")
    return math.ceil(global_batch / devices)


def cnn_data_mesh(devices: Optional[int] = None, device=None) -> Mesh:
    """The first ``devices`` CUDA cards (default: all of them), or, where
    ``device`` is the CPU, ``devices`` copies of it (default 1).  Raises
    ``ValueError`` when fewer cards exist, and on a machine with none
    unless the CPU is asked for: the port never moves to the CPU by
    itself."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cpu":
        d = 1 if devices is None else devices
        if d < 1:
            raise ValueError(f"devices must be >= 1, got {d}")
        return (dev,) * d
    avail = torch.cuda.device_count()
    d = avail if devices is None else devices
    if d < 1 or d > avail:
        raise ValueError(
            f"devices={d} but torch sees {avail} CUDA device(s); pass "
            "device='cpu' for a mesh of CPU copies")
    return tuple(torch.device("cuda", i) for i in range(d))


def replicate_params(params: Dict, mesh: Mesh) -> Tuple[Dict, ...]:
    """One replica of the weight tree a shard (weights are read-only at
    serving time).  Shards on one device share one replica: ``to`` a
    tensor's own device is the tensor itself."""
    replicas: Dict[torch.device, Dict] = {}
    for d in mesh:
        if d not in replicas:
            replicas[d] = {layer: {k: v.to(d) for k, v in p.items()}
                           for layer, p in params.items()}
    return tuple(replicas[d] for d in mesh)


def _on(device: torch.device):
    """The launch context of ``device``: its card is the current one (the
    kernels' C entries launch on the current card)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def forward_fused_sharded(params: Sequence[Dict], x: torch.Tensor,
                          shard_cfg: CNNConfig, plan, mesh: Mesh, *,
                          impl: str = "cuda"):
    """Data-parallel ``forward_fused``: ``x`` is the GLOBAL padded batch
    ``[shard_cfg.batch * len(mesh), C, H, W]``, ``params`` the replicas of
    ``replicate_params``; shard i runs the fused plan on rows
    ``[i * shard_cfg.batch, (i + 1) * shard_cfg.batch)`` on ``mesh[i]``.
    Returns (the global ``[N, classes]`` probabilities on ``x``'s device,
    one shard's ``RunStats``: every shard's are equal, the per-card
    traffic).

    The plan MUST be the per-shard plan (``shard_cfg.batch`` is the shard
    batch); ``verify_shard_plan`` is the planner-side check."""
    from repro_torch.cnn.network import forward_fused
    devices = len(mesh)
    if x.shape[0] != shard_cfg.batch * devices:
        raise ValueError(
            f"global batch {x.shape[0]} != shard batch {shard_cfg.batch} x "
            f"{devices} devices; pad to the shard bucket before sharding")
    if len(params) != devices:
        raise ValueError(f"{len(params)} replicas for {devices} shards")
    outs, stats = [], None
    # issue every shard, then gather: no host synchronisation in between
    for d, p, xs in zip(mesh, params, x.split(shard_cfg.batch)):
        with _on(d):
            y, stats = forward_fused(p, xs.to(d, non_blocking=True),
                                     shard_cfg, plan, impl=impl)
        outs.append(y)
    return torch.cat([y.to(x.device, non_blocking=True) for y in outs]), stats


class ShardPlanError(AssertionError):
    """A sharded bucket is running a plan that was not made for its shard
    batch (the global batch's plan leaked through)."""


def verify_shard_plan(plan, cfg: CNNConfig, shard_bucket: int, *,
                      dtype: str = "float32", policy: str = "uniform",
                      stack: str = "auto",
                      cost_model: Optional[CostModel] = None) -> None:
    """Raise ``ShardPlanError`` unless ``plan`` equals a fresh plan at the
    SHARD batch in layouts, conv signature and modeled fused bytes, so any
    per-shard Nt flip was taken rather than inherited from the global
    batch.  ``cost_model`` prices the fresh plan (default: the port's, the
    H100 profile); pass the one the plan was made with."""
    from repro_torch.cnn.network import plan_network_fused
    fresh = plan_network_fused(cfg.replace(batch=shard_bucket), dtype=dtype,
                               policy=policy, stack_policy=stack,
                               cost_model=cost_model)
    if (plan.layouts != fresh.layouts
            or plan.conv_signature != fresh.conv_signature
            or plan.fused_bytes != fresh.fused_bytes):
        raise ShardPlanError(
            f"plan for shard bucket {shard_bucket} is not the shard-batch "
            f"plan: {plan.conv_signature} ({plan.fused_bytes}B) vs fresh "
            f"{fresh.conv_signature} ({fresh.fused_bytes}B); the planner "
            f"must plan for the shard batch, not the global one")


def shard_flip(cfg: CNNConfig, global_batch: int, devices: int, *,
               dtype: str = "float32",
               cost_model: Optional[CostModel] = None) -> Tuple[str, str]:
    """(global-batch conv signature, shard-batch conv signature) for a fixed
    global batch: where sharding itself flips the layout choice (the
    per-shard N below Nt while the global N sits above it)."""
    from repro_torch.cnn.network import plan_network_fused
    gsig = plan_network_fused(cfg.replace(batch=global_batch), dtype=dtype,
                              cost_model=cost_model).conv_signature
    ssig = plan_network_fused(
        cfg.replace(batch=shard_batch_for(global_batch, devices)),
        dtype=dtype, cost_model=cost_model).conv_signature
    return gsig, ssig
