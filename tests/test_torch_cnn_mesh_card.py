"""The data-parallel serving mesh (``distributed/cnn_mesh``) on the card.

- ``CNNServer(devices=1)`` answers bit for bit as the kernels' forward
  of its plan on the padded batch: the single-card path, unchanged.
- A mesh of two shards on one card (``mesh=(cuda, cuda)``) rehearses the
  split, the padding and the gather on the kernels: ``forward_fused_sharded``
  is bit-equal to the per-shard forwards, and so is the sharded server's
  every answer; its plans are the shard buckets', its launches twice a
  shard's, ``hbm_bytes == per_chip_bytes * 2``.
- A launch the card refuses raises through the sharded server: the batch
  is back in the queue and no lower rung ran.
- Where more than one card exists, ``devices=torch.cuda.device_count()``
  serves the same answers as the single-card server within 1e-5.

Every test needs a CUDA device and ``nvcc`` and skips with the reason
where either is missing.  No jax, no reference package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cnn_mesh_card.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.cnn.network import forward_fused
from repro_torch.distributed.cnn_mesh import (forward_fused_sharded,
                                              replicate_params,
                                              verify_shard_plan)
from repro_torch.kernels import _build
from repro_torch.launch.cnn_serve import CNNServer, ImageRequest
from repro_torch.serve.plan_cache import pad_to_bucket


@pytest.fixture
def card():
    reason = _build.toolchain_missing()
    if reason:
        pytest.skip(reason)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _requests(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    c, h = cfg.in_channels, cfg.image_hw
    return [ImageRequest(i, rng.standard_normal((c, h, h), np.float32))
            for i in range(n)]


def _batch(srv, reqs, dev):
    return torch.from_numpy(np.stack([r.image for r in reqs])).to(dev)


@pytest.mark.parametrize("network,policy", [("alexnet", "uniform"),
                                            ("resnet18", "uniform"),
                                            ("alexnet", "mixed")])
def test_one_device_is_the_unsharded_path(card, network, policy):
    srv = CNNServer(network, max_bucket=8, calibration="analytic",
                    dtype_policy=policy, devices=1)
    assert srv.mesh is None
    reqs = _requests(srv.cfg, 6)
    done = srv.run(reqs)
    plan = srv.cache.peek_fused(srv.cfg, 8, policy=policy)
    with torch.inference_mode():
        y, _ = forward_fused(srv.model.params(),
                             pad_to_bucket(_batch(srv, reqs, card), 8),
                             srv.cfg, plan, impl="cuda")
    y = y.float().cpu().numpy()
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(done[r.rid], y[i])


@pytest.mark.parametrize("network,policy", [("alexnet", "uniform"),
                                            ("resnet18", "uniform"),
                                            ("alexnet", "mixed")])
def test_two_shards_on_one_card_are_the_per_shard_forwards(card, network,
                                                            policy):
    mesh = (card, card)
    srv = CNNServer(network, max_bucket=4, calibration="analytic",
                    dtype_policy=policy, mesh=mesh)
    assert srv.devices == 2
    reqs = _requests(srv.cfg, 7)
    K.reset_launch_counts()
    done = srv.run(reqs)                          # 7 -> shard bucket 4
    torch.cuda.synchronize()
    served = K.launch_counts()
    rep = srv.reports[4]
    assert rep.images == 7 and rep.padded == 1
    assert rep.hbm_bytes == 2 * rep.per_chip_bytes > 0
    plan = srv.cache.peek_fused(srv.cfg, 4, policy=policy, devices=2,
                                pre_sharded=True)
    verify_shard_plan(plan, srv.cfg, 4, policy=policy,
                      cost_model=srv.cache.cost_model)
    scfg = srv.cfg.replace(batch=4)
    x = pad_to_bucket(_batch(srv, reqs, card), 8)
    params = srv.model.params()
    with torch.inference_mode():
        K.reset_launch_counts()
        y1, _ = forward_fused(params, x[:4], scfg, plan, impl="cuda")
        torch.cuda.synchronize()
        one_shard = K.launch_counts()
        y2, _ = forward_fused(params, x[4:], scfg, plan, impl="cuda")
        ys, stats = forward_fused_sharded(replicate_params(params, mesh), x,
                                          scfg, plan, mesh)
    assert served == {k: 2 * v for k, v in one_shard.items()}
    want = torch.cat([y1, y2])
    assert torch.equal(ys, want)
    assert stats.hbm_bytes == rep.per_chip_bytes
    want = want.float().cpu().numpy()
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(done[r.rid], want[i])


def test_a_refused_launch_surfaces_through_the_sharded_server(card,
                                                             monkeypatch):
    srv = CNNServer("alexnet", max_bucket=4, calibration="analytic",
                    mesh=(card, card))
    _build.library("")
    for r in _requests(srv.cfg, 5):
        srv.submit(r)
    monkeypatch.setattr(_build, "entry", lambda name, variant="": (
        lambda *a: 1))                            # cudaErrorInvalidValue
    with pytest.raises(_build.KernelLaunchError):
        srv.step()
    assert [r.rid for r in srv.queue] == list(range(5))
    assert srv.incidents.counts == {"requeue": 1}
    assert not srv._quarantine
    monkeypatch.undo()
    assert len(srv.run([])) == 5


def test_every_card_serves_the_single_card_answers(card):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"one CUDA device; devices={n} is the single-card path")
    srv = CNNServer("alexnet", max_bucket=4, calibration="analytic",
                    devices=n)
    one = CNNServer("alexnet", max_bucket=4, calibration="analytic")
    reqs = _requests(srv.cfg, 4 * n - 1)
    got, want = srv.run(reqs), one.run(_requests(srv.cfg, 4 * n - 1))
    assert srv.mesh == tuple(torch.device("cuda", i) for i in range(n))
    for rid, probs in got.items():
        np.testing.assert_allclose(probs, want[rid], rtol=0, atol=1e-5)
