"""The port's planner (``core.selector``, ``cnn.network.plan_network*``,
``serve.plan_cache``) against the reference's.

Under the reference's own device profile (``reference_hardware``) the
port's ``assign_layouts`` (inference and training) and ``plan_fused`` give
the reference's plans field for field, ``total_s`` floats included: every
network of ``CNN_CONFIGS`` at buckets 1, 8, 32 and 128, float32 and bf16,
dtype policies uniform and mixed, stack policies auto and off; and every
fused and unfused key of the three packaged plan files, replanned, equals
the file's entry.  A plan-cache miss plans (``planner_calls`` + 1) the
reference's plan; files either package saves load in the other; the LRU
bound, the stats and ``heuristic_layouts`` behave as the reference's.
"""
from __future__ import annotations

import dataclasses
import json

import pytest

from repro.cnn import network as ref_network
from repro.configs.cnn_networks import CNN_CONFIGS
from repro.core.selector import assign_layouts as ref_assign_layouts
from repro.core.selector import plan_fused as ref_plan_fused
from repro.perfmodel import Thresholds as RefThresholds
from repro.serve.plan_cache import PlanCache as RefPlanCache

from repro_torch.cnn.network import (input_shape, network_descs,
                                     plan_network, plan_network_fused)
from repro_torch.configs import cnn_networks as port_networks
from repro_torch.core.selector import (LayerDesc, assign_layouts,
                                       layer_cost, plan_fused)
from repro_torch.perfmodel import AnalyticCostModel, Thresholds
from repro_torch.serve.plan_cache import (PlanCache, network_id,
                                          packaged_plans)
from tests.test_torch_planner import REF_HW
from tests.test_torch_plans import PACKAGED

NETWORKS = sorted(CNN_CONFIGS)
BUCKETS = (1, 8, 32, 128)
REF_CM = AnalyticCostModel(REF_HW)


def _asdict(p) -> dict:
    return dataclasses.asdict(p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("net", NETWORKS)
def test_fused_plans_match_reference(net, dtype):
    for b in BUCKETS:
        ref_cfg = CNN_CONFIGS[net].replace(batch=b)
        cfg = port_networks.CNN_CONFIGS[net].replace(batch=b)
        for policy in ("uniform", "mixed"):
            for stack in ("auto", "off"):
                want = ref_network.plan_network_fused(
                    ref_cfg, dtype=dtype, policy=policy, stack_policy=stack)
                got = plan_network_fused(cfg, dtype=dtype, policy=policy,
                                         stack_policy=stack,
                                         cost_model=REF_CM)
                assert _asdict(got) == _asdict(want), (b, policy, stack)
        # training plans and the graph DP on a linear network
        for training in (False, True):
            kw = dict(input_layout="NCHW", input_shape=input_shape(cfg),
                      training=training, base_dtype=dtype)
            want = ref_plan_fused(ref_network.network_descs(ref_cfg, dtype),
                                  _force_graph=True, **kw)
            got = plan_fused(network_descs(cfg, dtype), _force_graph=True,
                             cost_model=REF_CM, **kw)
            assert _asdict(got) == _asdict(want), (b, training)


@pytest.mark.parametrize("net", NETWORKS)
def test_assignments_match_reference(net):
    for b in BUCKETS:
        ref_cfg = CNN_CONFIGS[net].replace(batch=b)
        cfg = port_networks.CNN_CONFIGS[net].replace(batch=b)
        for dtype in ("float32", "bfloat16"):
            for training in (False, True):
                for policy in ("uniform", "mixed"):
                    kw = dict(input_layout="NCHW",
                              input_shape=input_shape(cfg),
                              training=training, dtype_policy=policy,
                              base_dtype=dtype)
                    want = ref_assign_layouts(
                        ref_network.network_descs(ref_cfg, dtype), **kw)
                    got = assign_layouts(network_descs(cfg, dtype),
                                         cost_model=REF_CM, **kw)
                    assert _asdict(got) == _asdict(want), (b, dtype,
                                                           training, policy)
        assert (plan_network(cfg, "opt", cost_model=REF_CM)
                == ref_network.plan_network(ref_cfg, "opt"))
        for nt in (1, 64):
            assert (plan_network(cfg, "opt", use_dp=False,
                                 thresholds=Thresholds(4, nt))
                    == ref_network.plan_network(ref_cfg, "opt",
                                                RefThresholds(4, nt),
                                                use_dp=False))


@pytest.mark.parametrize("net", NETWORKS)
def test_heuristic_mode_calibrates_as_the_reference(net):
    """``use_dp=False`` without thresholds calibrates on the cost model's
    device; on the reference profile that is the reference's sweep."""
    for b in (1, 128):
        for dtype in ("float32", "bf16"):
            cfg = port_networks.CNN_CONFIGS[net].replace(batch=b)
            assert (plan_network(cfg, "opt", use_dp=False, dtype=dtype,
                                 cost_model=REF_CM)
                    == ref_network.plan_network(
                        CNN_CONFIGS[net].replace(batch=b), "opt",
                        use_dp=False, dtype=dtype))
            assert len(plan_network(cfg, "opt", use_dp=False,
                                    dtype=dtype)) == len(cfg.layers)


@pytest.mark.parametrize("network", sorted(PACKAGED))
def test_every_packaged_key_replans_to_the_files_entry(network):
    obj = json.loads(packaged_plans(network).read_text())
    cfg = port_networks.CNN_CONFIGS[network]
    nid = network_id(cfg)
    fresh = PlanCache(cost_model=REF_CM, max_bucket=PACKAGED[network])
    for kind in ("fused", "unfused"):
        assert obj[kind]
        for ent in obj[kind]:
            key = ent["key"]
            assert key["network"] == nid and not key["training"]
            if kind == "fused":
                got, bucket, hit = fresh.fused_plan(
                    cfg, key["bucket"], dtype=key["dtype"],
                    policy=key["policy"], stack=key.get("stack", "auto"))
            else:
                got, bucket, hit = fresh.assignment(
                    cfg, key["bucket"], dtype=key["dtype"],
                    policy=key["policy"])
            assert (bucket, hit) == (key["bucket"], False)
            assert json.loads(json.dumps(_asdict(got))) == ent["plan"]
    assert fresh.planner_calls == len(obj["fused"]) + len(obj["unfused"])


def test_plan_cache_miss_plans_the_reference_plan(tmp_path):
    cfg = port_networks.CNN_CONFIGS["vgg16"]
    cache = PlanCache(str(packaged_plans("vgg16")), cost_model=REF_CM,
                      max_bucket=256)
    plan, bucket, hit = cache.fused_plan(cfg, 5, stack="off")
    assert (bucket, hit, cache.planner_calls) == (8, True, 0)
    # bf16 and bucket 64 are in no file: each miss plans once
    ref = RefPlanCache(max_bucket=256)
    for batch, dtype in ((4, "bfloat16"), (40, "float32"), (20, "bf16")):
        before = cache.planner_calls
        got, bucket, hit = cache.fused_plan(cfg, batch, dtype=dtype)
        want, ref_bucket, _ = ref.fused_plan(CNN_CONFIGS["vgg16"], batch,
                                             dtype=dtype)
        assert (bucket, hit) == (ref_bucket, False)
        assert cache.planner_calls == before + 1
        assert _asdict(got) == _asdict(want)
        assert cache.fused_plan(cfg, batch, dtype=dtype)[2]    # now a hit
        assert cache.planner_calls == before + 1
    assert cache.stats.misses == 3 and cache.stats.hits == 4
    # the port's plans, saved, load in the reference (and back)
    out = cache.save(str(tmp_path / "resaved.json"))
    back = RefPlanCache(out)
    assert back.corrupt_recoveries == []
    assert _asdict(back.peek_fused(CNN_CONFIGS["vgg16"], 64)) == _asdict(
        cache.peek_fused(cfg, 64))
    again = PlanCache(back.save(str(tmp_path / "again.json")))
    assert _asdict(again.peek_fused(cfg, 4, dtype="bf16")) == _asdict(
        cache.peek_fused(cfg, 4, dtype="bf16"))


def test_unfused_miss_plans_the_reference_assignment():
    cfg = port_networks.CNN_CONFIGS["alexnet"]
    cache = PlanCache(str(packaged_plans("alexnet")), cost_model=REF_CM)
    a, bucket, hit = cache.assignment(cfg, 100)
    assert (bucket, hit, cache.planner_calls) == (128, True, 0)
    ref = RefPlanCache()
    for kw in ({"dtype": "bf16"}, {"training": True},
               {"policy": "mixed"}):
        got, bucket, hit = cache.assignment(cfg, 8, **kw)
        want, _, _ = ref.assignment(CNN_CONFIGS["alexnet"], 8, **kw)
        assert (bucket, hit) == (8, False) and _asdict(got) == _asdict(want)
    assert cache.planner_calls == 3
    assert cache.per_key[cache._key(cfg, 8, "bf16", False)].misses == 1


def test_bounded_cache_evicts_least_recently_hit_and_persists_order(
        tmp_path):
    cfg = port_networks.CNN_CONFIGS["lenet"]
    ref_cfg = CNN_CONFIGS["lenet"]
    path = str(tmp_path / "lru.json")
    cache = PlanCache(path, max_entries=2, cost_model=REF_CM)
    ref = RefPlanCache(str(tmp_path / "ref.json"), max_entries=2)
    for c, conf in ((cache, cfg), (ref, ref_cfg)):
        for b in (1, 2, 1, 4, 8, 2):
            c.fused_plan(conf, b)
    assert cache.planner_calls == ref.planner_calls == 5
    assert cache.evictions == ref.evictions == 3
    assert [k.bucket for k in cache._fused] == [k.bucket for k in ref._fused]
    assert {k.bucket: (s.hits, s.misses) for k, s in cache.per_key.items()} \
        == {k.bucket: (s.hits, s.misses) for k, s in ref.per_key.items()}
    cache.save()
    ref.save()
    with open(path) as f, open(str(tmp_path / "ref.json")) as g:
        assert json.load(f) == json.load(g)
    reloaded = PlanCache(path)
    assert reloaded.max_entries == 2
    reloaded.fused_plan(cfg, 16)          # evicts bucket 8, the LRU one
    assert [k.bucket for k in reloaded._fused] == [2, 16]
    with pytest.raises(ValueError, match="max_entries"):
        PlanCache(max_entries=0)


def test_threshold_rows_and_heuristic_layouts(tmp_path):
    path = str(tmp_path / "cache.json")
    json.dump({"version": 2, "thresholds": {"f32": {"Ct": 32, "Nt": 64}},
               "fused": [], "unfused": []}, open(path, "w"))
    cache = PlanCache(path)
    assert cache.thresholds == Thresholds(32, 64)
    assert cache.thresholds_for("f32", "NVIDIA H100 80GB HBM3") == \
        Thresholds(32, 64)                     # falls back to the default
    cache.set_thresholds(Thresholds(4, 128), "f32",
                         hardware="NVIDIA H100 80GB HBM3")
    cfg = port_networks.CNN_CONFIGS["alexnet"]
    ref_cfg = CNN_CONFIGS["alexnet"]
    ref_cache = RefPlanCache(cache.save())
    for hw in (None, "NVIDIA H100 80GB HBM3"):
        for batch in (5, 100):
            assert cache.heuristic_layouts(cfg, batch, hardware=hw) == \
                ref_cache.heuristic_layouts(ref_cfg, batch, hardware=hw)
    assert ref_cache.thresholds_for("f32", "NVIDIA H100 80GB HBM3") == \
        RefThresholds(4, 128)
    obj = json.load(open(path))
    assert obj["thresholds"] == {"float32": {"Ct": 32, "Nt": 64}}
    assert obj["thresholds_hw"] == {
        "NVIDIA H100 80GB HBM3": {"float32": {"Ct": 4, "Nt": 128}}}
    with pytest.raises(ValueError, match="calibrated thresholds"):
        PlanCache().heuristic_layouts(cfg, 8)
    # caller-given rows win over the file's
    assert PlanCache(path, thresholds=Thresholds(1, 2)).thresholds == \
        Thresholds(1, 2)


def test_layer_costs_match_reference_and_refuse_unknown_kinds():
    from repro.core.selector import layer_cost as ref_layer_cost
    for net in NETWORKS:
        cfg = port_networks.CNN_CONFIGS[net].replace(batch=8)
        ref_descs = ref_network.network_descs(
            CNN_CONFIGS[net].replace(batch=8))
        for d, rd in zip(network_descs(cfg), ref_descs):
            for lay in ("CHWN", "NCHW"):
                for training in (False, True):
                    assert (layer_cost(d, lay, training, REF_CM)
                            == ref_layer_cost(rd, lay, training))
    with pytest.raises(ValueError, match="not executable"):
        layer_cost(LayerDesc("n", "lrn", out_shape=(1, 2, 3, 3)), "NCHW")
    with pytest.raises(ValueError, match="dtype_policy"):
        plan_fused([], dtype_policy="fp8")


def test_buckets_up_to_256_stay_inside_32_bit_indexing():
    """The kernels index with 32-bit ints: every activation of every
    network at the plan cache's largest bucket stays under 2**31
    elements (VGG16's conv1 output at 256 is the largest)."""
    from repro_torch.cnn.layers import layer_shapes
    biggest = 0
    for net, cfg in port_networks.CNN_CONFIGS.items():
        cfg = cfg.replace(batch=PlanCache().max_bucket)
        for shape in [input_shape(cfg)] + list(layer_shapes(cfg)):
            n = 1
            for d in shape:
                n *= d
            biggest = max(biggest, n)
    assert biggest == 256 * 64 * 224 * 224 < 2 ** 31
