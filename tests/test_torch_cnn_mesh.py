"""The port's data-parallel serving mesh (``distributed/cnn_mesh``) against
the reference's (``tests/test_cnn_mesh.py``'s cases).

Planning and the plan cache are arithmetic: under the reference's device
profile (``REF_CM``) ``shard_flip`` gives the reference's signatures,
``verify_shard_plan`` passes the shard-batch plan (its bytes the
reference's) and refuses the leaked global one, and the plan cache keys
(per-shard bucket, devices) as the reference's does, in a file both
packages read.  The sharded forward runs on a mesh of CPU copies (the
port's counterpart of forced host devices, so no subprocess and no
``multidevice`` marker): at 2 and 4 shards, uniform and mixed, within 1e-5
of the reference's per-shard ``forward_fused(impl="xla")``.  The sharded
server drops nothing, replans nothing twice, keys every plan on an
admitted shard bucket and reports ``hbm_bytes == per_chip_bytes *
devices``.

``test_torch_cnn_mesh_card.py`` runs the mesh on the card.
"""
from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cnn.network import forward_fused as ref_forward_fused
from repro.cnn.network import plan_network_fused as ref_plan_network_fused
from repro.configs.cnn_networks import CNN_CONFIGS as REF_CONFIGS
from repro.configs.cnn_networks import reduced_cnn as ref_reduced_cnn
from repro.distributed import cnn_mesh as ref_mesh
from repro.serve.plan_cache import PlanCache as RefPlanCache

from repro_torch.cnn.layers import init_cnn, params_from_numpy
from repro_torch.cnn.network import input_shape, plan_network_fused
from repro_torch.configs.cnn_networks import CNN_CONFIGS, reduced_cnn
from repro_torch.distributed.cnn_mesh import (ShardPlanError, cnn_data_mesh,
                                              forward_fused_sharded,
                                              replicate_params,
                                              shard_batch_for, shard_flip,
                                              verify_shard_plan)
from repro_torch.launch.cnn_serve import CNNServer, ImageRequest
from repro_torch.serve.plan_cache import PlanCache
from tests.test_torch_planner_plans import REF_CM

PROB_ATOL = 1e-5
LENET, REF_LENET = CNN_CONFIGS["lenet"], REF_CONFIGS["lenet"]


def test_shard_batch_for_matches_reference():
    for g in (1, 7, 8, 9, 16, 128, 133):
        for d in (1, 2, 3, 4, 8):
            assert shard_batch_for(g, d) == ref_mesh.shard_batch_for(g, d)
    assert shard_batch_for(128, 8) == 16 and shard_batch_for(9, 4) == 3
    for g, d in ((0, 1), (8, 0)):
        with pytest.raises(ValueError):
            shard_batch_for(g, d)
        with pytest.raises(ValueError):
            ref_mesh.shard_batch_for(g, d)


@pytest.mark.parametrize("network", ["lenet", "alexnet"])
def test_shard_flip_and_verify_match_reference(network):
    """The property of the mesh: a global batch above Nt whose shard
    batch falls below it replans.  lenet at float32 flips at 128 over 8
    cards; the port's signatures, and the shard plan's bytes, are the
    reference's."""
    cfg, ref_cfg = CNN_CONFIGS[network], REF_CONFIGS[network]
    got = shard_flip(cfg, 128, 8, cost_model=REF_CM)
    assert got == ref_mesh.shard_flip(ref_cfg, 128, 8)
    if network == "lenet":
        assert got[0] != got[1]
    splan = plan_network_fused(cfg.replace(batch=16), cost_model=REF_CM)
    ref_splan = ref_plan_network_fused(ref_cfg.replace(batch=16))
    assert splan.fused_bytes == ref_splan.fused_bytes
    assert splan.conv_signature == ref_splan.conv_signature
    verify_shard_plan(splan, cfg, 16, cost_model=REF_CM)
    # the leaked global plan fails in both packages (its bytes are the
    # global batch's even where its layouts are not flipped)
    gplan = plan_network_fused(cfg.replace(batch=128), cost_model=REF_CM)
    with pytest.raises(ShardPlanError):
        verify_shard_plan(gplan, cfg, 16, cost_model=REF_CM)
    with pytest.raises(ref_mesh.ShardPlanError):
        ref_mesh.verify_shard_plan(
            ref_plan_network_fused(ref_cfg.replace(batch=128)), ref_cfg, 16)


def test_plan_cache_devices_key_hit_miss():
    cache = PlanCache(cost_model=REF_CM)
    ref = RefPlanCache()
    # sharded admission plans the PER-SHARD bucket
    p1, b1, hit1 = cache.fused_plan(LENET, 128, devices=8)
    r1, rb1, _ = ref.fused_plan(REF_LENET, 128, devices=8)
    assert (b1, hit1, cache.planner_calls) == (rb1, False, 1) == (16, False,
                                                                  1)
    assert p1.conv_signature == r1.conv_signature
    assert p1.fused_bytes == r1.fused_bytes
    # re-admission at the same (bucket, devices) hits: planned once
    p2, b2, hit2 = cache.fused_plan(LENET, 128, devices=8)
    assert hit2 and b2 == 16 and cache.planner_calls == 1 and p2 is p1
    # the pre-sharded entry resolves to the SAME key: dividing by devices
    # twice would miss into a bogus bucket-2 key
    p1s, b1s, hit1s = cache.fused_plan(LENET, 16, devices=8,
                                       pre_sharded=True)
    assert hit1s and b1s == 16 and cache.planner_calls == 1 and p1s is p1
    assert cache.peek_fused(LENET, 16, devices=8, pre_sharded=True) is p1
    assert cache.peek_fused(LENET, 16, devices=8) is None
    # the same shard bucket at another mesh width is a key of its own
    _, b3, hit3 = cache.fused_plan(LENET, 64, devices=4)
    assert b3 == 16 and not hit3 and cache.planner_calls == 2
    # unsharded admission of the same global batch plans the global bucket
    # and takes the other side of the Nt flip
    p4, b4, hit4 = cache.fused_plan(LENET, 128)
    assert b4 == 128 and not hit4
    assert p4.conv_signature != p1.conv_signature
    assert p4.conv_signature == ref.fused_plan(REF_LENET, 128)[0]\
        .conv_signature
    with pytest.raises(ValueError):
        cache.fused_plan(LENET, 16, devices=0)
    with pytest.raises(ValueError):
        ref.fused_plan(REF_LENET, 16, devices=0)


def test_plan_cache_devices_file_read_by_both(tmp_path):
    """Single-card keys are saved without ``devices`` (files older than
    the mesh load unchanged); a mesh key carries it.  Either package reads
    the other's file and plans nothing."""
    path = str(tmp_path / "port.json")
    cache = PlanCache(path, cost_model=REF_CM)
    cache.fused_plan(LENET, 8)
    cache.fused_plan(LENET, 64, devices=4)
    cache.save()
    keys = [e["key"] for e in json.load(open(path))["fused"]]
    assert sum("devices" in k for k in keys) == 1
    assert {k.get("devices", 1) for k in keys} == {1, 4}
    ref = RefPlanCache(path=path)
    _, _, h1 = ref.fused_plan(REF_LENET, 8)
    _, _, h2 = ref.fused_plan(REF_LENET, 64, devices=4)
    assert h1 and h2 and ref.planner_calls == 0

    rpath = str(tmp_path / "ref.json")
    ref = RefPlanCache(path=rpath)
    ref.fused_plan(REF_LENET, 8)
    ref.fused_plan(REF_LENET, 32, devices=2)
    ref.save()
    loaded = PlanCache(rpath, cost_model=REF_CM)
    _, b, h1 = loaded.fused_plan(LENET, 8)
    _, b2, h2 = loaded.fused_plan(LENET, 16, devices=2, pre_sharded=True)
    assert h1 and h2 and b2 == 16 and loaded.planner_calls == 0


# (network, policy, devices): lenet as the reference's tests; reduced VGG16
# so that "mixed" stores int8 between convs (lenet's mixed plan is uniform)
SHARDED = [("lenet", "uniform", 2), ("lenet", "uniform", 4),
           ("lenet", "mixed", 2), ("lenet", "mixed", 4),
           ("vgg16", "mixed", 2)]


@pytest.mark.parametrize("network,policy,devices", SHARDED,
                         ids=[f"{n}-{p}-{d}" for n, p, d in SHARDED])
def test_sharded_forward_matches_reference(network, policy, devices):
    shard = 2
    if network == "lenet":
        scfg, ref_scfg = LENET.replace(batch=shard), REF_LENET.replace(
            batch=shard)
    else:
        scfg = reduced_cnn(CNN_CONFIGS[network], batch=shard)
        ref_scfg = ref_reduced_cnn(REF_CONFIGS[network], batch=shard)
    ref_plan = ref_plan_network_fused(ref_scfg, policy=policy)
    plan = plan_network_fused(scfg, policy=policy, cost_model=REF_CM)
    assert plan.conv_signature == ref_plan.conv_signature
    assert plan.dtype_signature == ref_plan.dtype_signature
    if network == "vgg16":
        assert "8" in plan.dtype_signature    # int8 boundaries do run
    tree = init_cnn(scfg, seed=devices)
    n = shard * devices
    x = np.random.default_rng(devices).standard_normal(
        (n,) + input_shape(scfg)[1:], np.float32)
    mesh = cnn_data_mesh(devices, "cpu")
    assert mesh == (torch.device("cpu"),) * devices
    params = replicate_params(params_from_numpy(tree, "cpu"), mesh)
    y, stats = forward_fused_sharded(params, torch.from_numpy(x), scfg,
                                     plan, mesh)
    assert y.shape == (n, scfg.num_classes)
    ref_params = jax.tree.map(jnp.asarray, tree)
    want = np.concatenate([np.asarray(ref_forward_fused(
        ref_params, jnp.asarray(x[i * shard:(i + 1) * shard]), ref_scfg,
        ref_plan, impl="xla")[0]) for i in range(devices)])
    np.testing.assert_allclose(y.numpy(), want, rtol=0, atol=PROB_ATOL)
    assert stats.hbm_bytes > 0


def test_mesh_and_replicas():
    assert cnn_data_mesh(device="cpu") == (torch.device("cpu"),)
    with pytest.raises(ValueError):
        cnn_data_mesh(0, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="CUDA device"):
            cnn_data_mesh(2)
    mesh = cnn_data_mesh(3, "cpu")
    tree = params_from_numpy(init_cnn(LENET, 0), "cpu")
    reps = replicate_params(tree, mesh)
    # shards on one device share one replica: the tensors themselves
    assert len(reps) == 3 and reps[0] is reps[2]
    assert reps[0]["conv1"]["w"] is tree["conv1"]["w"]
    scfg = LENET.replace(batch=2)
    plan = plan_network_fused(scfg)
    with pytest.raises(ValueError, match="global batch"):
        forward_fused_sharded(reps, torch.zeros(5, 1, 28, 28), scfg, plan,
                              mesh)


def _requests(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    c, h = cfg.in_channels, cfg.image_hw
    return [ImageRequest(i, rng.standard_normal((c, h, h), np.float32))
            for i in range(n)]


@pytest.mark.parametrize("devices", [2, 4])
def test_sharded_server(devices, tmp_path):
    """``CNNServer(devices=)`` end to end on a mesh of CPU copies:
    per-shard bucket admission, no drops, no repeat replans, per-card
    accounting, and the answers of the single-card server."""
    srv = CNNServer("lenet", max_bucket=8, device="cpu", devices=devices,
                    calibration="analytic",
                    cache_path=str(tmp_path / "plans.json"))
    assert srv.mesh == (torch.device("cpu"),) * devices
    reqs = _requests(srv.cfg, 3 * devices + 1)
    done = srv.run(reqs)
    assert len(done) == len(reqs)
    rr = sum(max(0, st.misses - 1) for st in srv.cache.per_key.values())
    assert rr == 0
    assert all(k.devices == devices for k in srv.cache.per_key)
    # every cached key's bucket is an ADMITTED shard bucket: dividing by
    # devices twice would mint a smaller key
    assert {k.bucket for k in srv.cache.per_key} == set(srv.reports)
    assert any(rep.per_chip_bytes > 0 for rep in srv.reports.values())
    for b, rep in srv.reports.items():
        assert rep.hbm_bytes == rep.per_chip_bytes * devices
        plan = srv.cache.peek_fused(srv.cfg, b, devices=devices,
                                    pre_sharded=True)
        assert plan is not None
        assert plan is srv.cache.peek_fused(srv.cfg, b * devices,
                                            devices=devices)
        verify_shard_plan(plan, srv.cfg, b, cost_model=srv.cache.cost_model)
    assert f"devices={devices}" in srv.report_lines()[0]
    assert "per_chip_MB=" in srv.report_lines()[1]
    one = CNNServer("lenet", max_bucket=8, device="cpu",
                    calibration="analytic")
    want = one.run(_requests(srv.cfg, 3 * devices + 1))
    for rid, probs in done.items():
        np.testing.assert_allclose(probs, want[rid], rtol=0, atol=PROB_ATOL)


def test_sharded_server_drains_max_bucket_times_devices():
    srv = CNNServer("lenet", max_bucket=4, device="cpu", devices=2,
                    calibration="analytic")
    for r in _requests(srv.cfg, 11):
        srv.submit(r)
    assert len(srv.step()) == 8                   # 4 a shard, 2 shards
    assert len(srv.queue) == 3
    served = srv.step()                           # 3 -> shard bucket 2
    assert len(served) == 3 and set(srv.reports) == {4, 2}
    assert srv.reports[2].padded == 2 * 2 - 3
    with pytest.raises(ValueError):
        CNNServer("lenet", device="cpu", devices=0, calibration="analytic")
