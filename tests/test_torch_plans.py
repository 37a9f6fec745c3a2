"""The port's packaged plan files are the reference planner's own output.

``repro_torch/plans/{vgg16,alexnet,resnet18}.plans.json`` are written by
the reference ``repro.serve.plan_cache.PlanCache.save`` (fp32, uniform,
full-size network ids, every pow-2 bucket up to the network's Table-1
batch): the fused plans at both stack policies and the unfused executor's
"opt" assignment.  Regenerate them with

    PYTHONPATH=src python tests/test_torch_plans.py
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import pytest

from repro import dtypes as ref_dtypes
from repro.configs import paper_table1 as ref_table1
from repro.configs.cnn_networks import CNN_CONFIGS, reduced_cnn
from repro.serve.plan_cache import PlanCache, network_id

from repro_torch import dtypes as port_dtypes

from repro_torch.configs import cnn_networks as port_networks
from repro_torch.configs import paper_table1 as port_table1
from repro_torch.serve.plan_cache import packaged_plans
from repro_torch.serve import plan_cache as port_plan_cache

# network -> largest bucket the packaged file holds (the Table-1 batch)
PACKAGED = {"vgg16": 32, "alexnet": 128, "resnet18": 32}


def write_reference_plans(network: str, max_bucket: int, path: str) -> str:
    """Plan every pow-2 bucket up to ``max_bucket`` with the reference
    planner (fp32, uniform; fused at stacks "auto" and "off", and the
    unfused assignment) and save the cache to ``path``."""
    cfg = CNN_CONFIGS[network]
    cache = PlanCache(max_bucket=max_bucket)
    b = 1
    while b <= max_bucket:
        for stack in ("auto", "off"):
            cache.fused_plan(cfg, b, dtype="float32", stack=stack)
        cache.assignment(cfg, b, dtype="float32")
        b *= 2
    return cache.save(path)


@pytest.mark.parametrize("network", sorted(PACKAGED))
def test_packaged_plans_match_reference(network, tmp_path):
    fresh = write_reference_plans(network, PACKAGED[network],
                                  str(tmp_path / f"{network}.plans.json"))
    with open(fresh) as f, open(packaged_plans(network)) as g:
        assert json.load(g) == json.load(f)


@pytest.mark.parametrize("network", sorted(CNN_CONFIGS))
def test_network_id_matches_reference(network):
    ref = CNN_CONFIGS[network]
    port = port_networks.CNN_CONFIGS[network]
    assert repr(port.layers) == repr(ref.layers)
    assert port_plan_cache.network_id(port) == network_id(ref)
    assert (port_plan_cache.network_id(port_networks.reduced_cnn(port))
            == network_id(reduced_cnn(ref)))


@pytest.mark.parametrize("name", ["float32", "fp32", "f32", "bf16",
                                  "bfloat16", "fp16", "int8", "i8"])
def test_dtype_names_match_reference(name):
    canon = port_dtypes.canon_dtype(name)
    assert canon == ref_dtypes.canon_dtype(name)
    assert port_dtypes.dtype_bytes(name) == ref_dtypes.dtype_bytes(name)
    assert (port_dtypes.torch_dtype(name).itemsize
            == port_dtypes.dtype_bytes(name))
    with pytest.raises(ValueError, match="unknown storage dtype"):
        port_dtypes.canon_dtype("fp8")


def test_vgg16_bucket32_flips_conv1_1_to_chwn():
    cache = port_plan_cache.PlanCache(str(packaged_plans("vgg16")))
    cfg = port_networks.CNN_CONFIGS["vgg16"]
    big = cache.peek_fused(cfg, 32, stack="off")
    assert big.conv_signature == "C" + "N" * 12
    conv1_1 = big.ops[0]
    assert (conv1_1.name, conv1_1.kind) == ("conv1_1", "conv")
    assert (conv1_1.src_layout, conv1_1.layout,
            conv1_1.dst_layout) == ("NCHW", "CHWN", "NCHW")
    assert cache.peek_fused(cfg, 8, stack="off").conv_signature == "N" * 13
    assert big.transforms == [] and big.stacked_convs == 0


def test_alexnet_bucket128_runs_every_conv_on_chwn():
    cache = port_plan_cache.PlanCache(str(packaged_plans("alexnet")))
    plan = cache.peek_fused(port_networks.CNN_CONFIGS["alexnet"], 128,
                            stack="off")
    assert plan.conv_signature == "CCCCC"
    convs = [op for op in plan.ops if op.kind == "conv"]
    assert [(op.src_layout, op.dst_layout) for op in convs] == [
        ("NCHW", "CHWN"), ("CHWN", "CHWN"), ("CHWN", "CHWN"),
        ("CHWN", "CHWN"), ("CHWN", "NCHW")]


def test_vgg16_bucket32_auto_stacks_three_nchw_pairs():
    cache = port_plan_cache.PlanCache(str(packaged_plans("vgg16")))
    plan = cache.peek_fused(port_networks.CNN_CONFIGS["vgg16"], 32)
    assert plan.conv_signature == "N" * 13 and plan.stacked_convs == 3
    stacks = [op for op in plan.ops if op.stack_index is not None]
    assert [(op.name, op.pool_index is not None) for op in stacks] == [
        ("conv1_1", True), ("conv2_1", True), ("conv3_1", False)]
    assert all(op.stack_relu and op.relu for op in stacks)


def test_alexnet_bucket128_auto_stacks_conv3_conv4_on_chwn():
    cache = port_plan_cache.PlanCache(str(packaged_plans("alexnet")))
    cfg = port_networks.CNN_CONFIGS["alexnet"]
    plan = cache.peek_fused(cfg, 128)
    assert plan.conv_signature == "CCCCC" and plan.stacked_convs == 1
    (op,) = [op for op in plan.ops if op.stack_index is not None]
    assert (op.name, cfg.layers[op.stack_index].name) == ("conv3", "conv4")
    assert (op.src_layout, op.layout, op.dst_layout) == ("CHWN",) * 3


def test_resnet18_bucket32_auto_plan():
    cache = port_plan_cache.PlanCache(str(packaged_plans("resnet18")))
    cfg = port_networks.CNN_CONFIGS["resnet18"]
    plan = cache.peek_fused(cfg, 32)
    stacks = {op.name: op for op in plan.ops if op.stack_index is not None}
    assert sorted(stacks) == ["l1b1_convA", "l1b2_convA", "l2b1_convA",
                              "l2b2_convA", "l3b1_convA"]
    assert all(op.layout == "NCHW" and op.res_index is not None
               for op in stacks.values())
    assert {n: op.res_layout for n, op in stacks.items()} == {
        "l1b1_convA": "NCHW", "l1b2_convA": "NCHW", "l2b1_convA": "CHWN",
        "l2b2_convA": "NCHW", "l3b1_convA": "CHWN"}
    # the global average pool folds into the last conv's epilogue
    last = [op for op in plan.ops if op.kind == "conv"][-1]
    assert last.name == "l4b2_convB"
    assert cfg.layers[last.pool_index].name == "gap"
    assert not any(op.kind == "pool" for op in plan.ops)


def test_plan_cache_miss_plans_once_and_hits_after(tmp_path):
    """A miss plans, as the reference's does: ``planner_calls`` goes up by
    one, and under the reference's profile the plan is the reference's;
    the same key again is a hit."""
    from tests.test_torch_planner_plans import REF_CM
    cache = port_plan_cache.PlanCache(str(packaged_plans("vgg16")),
                                      cost_model=REF_CM)
    cfg = port_networks.CNN_CONFIGS["vgg16"]
    plan, bucket, hit = cache.fused_plan(cfg, 4, dtype="bfloat16")
    assert (bucket, hit, cache.planner_calls) == (4, False, 1)
    want, _, _ = PlanCache().fused_plan(CNN_CONFIGS["vgg16"], 4,
                                        dtype="bfloat16")
    assert dataclasses.asdict(plan) == dataclasses.asdict(want)
    assert cache.fused_plan(cfg, 3, dtype="bf16")[2]
    plan, bucket, hit = cache.fused_plan(cfg, 5, stack="off")
    assert (bucket, hit) == (8, True) and cache.planner_calls == 1
    # what the port saves, the reference loads to the same plans
    out = cache.save(str(tmp_path / "resaved.json"))
    ref = PlanCache(out)
    assert ref.corrupt_recoveries == []
    ref_plan = ref.peek_fused(CNN_CONFIGS["vgg16"], 5, stack="off")
    assert ref_plan.conv_signature == plan.conv_signature
    assert dataclasses.asdict(ref.peek_fused(
        CNN_CONFIGS["vgg16"], 4, dtype="bf16")) == dataclasses.asdict(want)


@pytest.mark.parametrize("network", sorted(PACKAGED))
def test_plan_cache_round_trips_the_reference_file(network, tmp_path):
    """Fused plans and unfused assignments load and save back to the
    reference's own JSON."""
    src = packaged_plans(network)
    cache = port_plan_cache.PlanCache(str(src))
    out = cache.save(str(tmp_path / f"{network}.plans.json"))
    with open(src) as f, open(out) as g:
        want, got = json.load(f), json.load(g)
    assert got == want and len(got["unfused"]) > 0


def test_unfused_assignment_hit_and_miss():
    cache = port_plan_cache.PlanCache(str(packaged_plans("alexnet")))
    cfg = port_networks.CNN_CONFIGS["alexnet"]
    a, bucket, hit = cache.assignment(cfg, 100)
    assert (bucket, hit) == (128, True) and cache.planner_calls == 0
    assert a.layouts == ["CHWN"] * len(cfg.layers) and a.transforms == [0]
    assert a.dtypes == ["float32"] * len(cfg.layers)
    ref, _, _ = PlanCache(str(packaged_plans("alexnet"))).assignment(
        CNN_CONFIGS["alexnet"], 100)
    assert (a.layouts, a.transforms, a.total_s) == (ref.layouts,
                                                    ref.transforms,
                                                    ref.total_s)
    # a miss plans (the port's default profile here), once
    for kw in ({"dtype": "bf16"}, {"training": True}):
        a, bucket, hit = cache.assignment(cfg, 8, **kw)
        assert (bucket, hit) == (8, False)
        assert len(a.layouts) == len(cfg.layers)
        assert cache.assignment(cfg, 7, **kw)[2]
    assert cache.planner_calls == 2


def test_paper_table1_reprs_match_reference():
    assert repr(port_table1.CONV_LAYERS) == repr(ref_table1.CONV_LAYERS)
    assert repr(port_table1.POOL_LAYERS) == repr(ref_table1.POOL_LAYERS)
    for port_l, ref_l in zip(port_table1.CONV_LAYERS, ref_table1.CONV_LAYERS):
        assert port_l.out_hw == ref_l.out_hw
    assert ([l.overlapped for l in port_table1.POOL_LAYERS]
            == [l.overlapped for l in ref_table1.POOL_LAYERS])


def test_corrupt_plan_file_raises(tmp_path):
    path = tmp_path / "vgg16.plans.json"
    obj = json.loads(packaged_plans("vgg16").read_text())
    obj["fused"][0]["plan"]["total_s"] += 1.0     # stale checksum
    path.write_text(json.dumps(obj))
    with pytest.raises(port_plan_cache.CorruptStateError, match="checksum"):
        port_plan_cache.PlanCache(str(path))


if __name__ == "__main__":
    for net, mb in PACKAGED.items():
        dst = packaged_plans(net)
        os.makedirs(dst.parent, exist_ok=True)
        print(write_reference_plans(net, mb, str(dst)), file=sys.stderr)
