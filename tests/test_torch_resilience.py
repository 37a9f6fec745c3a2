"""The port's serving and training resilience against the reference's.

Fault injection fires the same faults for the same seed and spec in both
packages; the ladders have the reference's shapes with the port's two
engines (the ``"cuda"`` ladder ends on the kernels, with no rung on the
plain engine); a corrupt plan cache or threshold file is renamed aside and
rebuilt, a corrupt packaged plan file raises; each package restores the
other's checkpoints bit for bit; and a guarded port server (the kernels'
plain versions on the CPU) walks its ladder as the reference's server does
on the same weights, requests and faults: the same incidents, rungs,
quarantines and plans, answers within 1e-5.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.launch.cnn_serve import CNNServer as RefServer
from repro.launch.cnn_serve import ImageRequest as RefRequest
from repro.perfmodel.calibration import \
    measured_thresholds as ref_measured_thresholds
from repro.runtime import resilience as ref_res
from repro.serve.plan_cache import PlanCache as RefPlanCache

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.cnn.layers import init_cnn, params_from_numpy
from repro_torch.cnn.network import forward_fused, plan_network_fused
from repro_torch.configs.cnn_networks import CNN_CONFIGS, LENET
from repro_torch.kernels._build import KernelBuildError, KernelLaunchError
from repro_torch.launch.cnn_serve import CNNServer, ImageRequest
from repro_torch.perfmodel import calibrate
from repro_torch.perfmodel.calibration import measured_thresholds
from repro_torch.perfmodel.traffic import conv_cost
from repro_torch.runtime import resilience as res
from repro_torch.runtime.fault_tolerance import (FaultTolerantRunner,
                                                 StepFailure,
                                                 StragglerWatchdog)
from repro_torch.serve import plan_cache as port_plan_cache
from repro_torch.serve.plan_cache import PlanCache, pad_to_bucket
from tests.test_torch_planner_plans import REF_CM

PROB_ATOL = 1e-5
TH4 = calibrate(dtype_bytes=4)
CORRUPTIONS = ("truncate", "garbage", "version", "checksum")
SPEC = "kernel=0.1,nan@mixed=1.0"
REF_IMPL = {"cuda": "pallas", "torch": "xla"}


def _images(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    c, h = cfg.in_channels, cfg.image_hw
    return [rng.standard_normal((c, h, h), np.float32) for _ in range(n)]


def make_requests(cfg, n, seed=0):
    return [ImageRequest(i, im) for i, im in enumerate(_images(cfg, n, seed))]


def make_server(tmp_path=None, **kw):
    kw.setdefault("max_bucket", 8)
    kw.setdefault("device", "cpu")
    kw.setdefault("thresholds", TH4)
    kw.setdefault("calibration", "analytic")
    kw.setdefault("cost_model", REF_CM)
    if tmp_path is not None:
        kw.setdefault("cache_path", str(tmp_path / "plans.json"))
    return CNNServer("lenet", **kw)


# ---------------------------------------------------------------------------
# parts: the injector, the spec, the incident log, the ladders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,rates", [
    (0, {"kernel": 0.1, "nan@mixed": 1.0}),
    (7, {"kernel": 0.5, "nan": 0.3, "slow@cuda": 0.0}),
    (3, {"kernel@cuda+stacks": 0.4, "kernel": 0.2, "nan@uniform": 0.6}),
])
def test_injector_fires_as_the_reference(seed, rates):
    """The same seed and rates fire the same faults at every site, in any
    interleaving of the sites, with the same counts and draws."""
    port = res.FaultInjector(seed=seed, rates=rates, slow_s=0.0)
    ref = ref_res.FaultInjector(seed=seed, rates=rates, slow_s=0.0)
    quals = [("cuda+stacks-mixed", "mixed", "cuda"),
             ("cuda-mixed", "mixed", "cuda"), ("cuda", "uniform", "cuda"),
             ("cuda+stacks", "uniform", "cuda")]
    rnd = np.random.default_rng(seed)
    got, want = [], []
    for _ in range(200):
        kind = ("kernel", "nan", "slow")[int(rnd.integers(3))]
        q = quals[int(rnd.integers(len(quals)))]
        got.append(port.fire(kind, q))
        want.append(ref.fire(kind, q))
    assert got == want and any(got)
    assert (port.counts, port.draws, port.fired) == (ref.counts, ref.draws,
                                                     ref.fired)


def test_injector_sites_and_poison():
    inj = res.FaultInjector(seed=0, rates={"nan@mixed": 1.0})
    y = np.ones(4, np.float32)
    out = inj.maybe_poison(y, ("cuda-mixed", "mixed", "cuda"))
    assert np.isnan(out[0]) and np.isfinite(y).all()   # a copy
    assert np.isfinite(inj.maybe_poison(y, ("cuda", "uniform",
                                            "cuda"))).all()
    inj2 = res.FaultInjector(seed=0, rates={"kernel@torch": 1.0})
    with pytest.raises(res.InjectedKernelFault):
        inj2.maybe_kernel_fault(("torch", "uniform", "torch"))
    inj2.maybe_kernel_fault(("cuda", "uniform", "cuda"))   # no match
    assert res.FaultInjector(rates={"slow": 1.0},
                             slow_s=0.0).maybe_slow() == 0.0
    with pytest.raises(ValueError):
        res.FaultInjector(rates={"kernel": 1.5})


@pytest.mark.parametrize("spec", ["", "kernel=0.1,nan@mixed=1.0",
                                  " kernel=0.5 , ,slow=0.05", "kernel",
                                  "nan@cuda=0.25,slow@mixed=1"])
def test_parse_inject_spec_as_the_reference(spec):
    try:
        want = ref_res.parse_inject_spec(spec, seed=3)
    except ValueError:
        with pytest.raises(ValueError):
            res.parse_inject_spec(spec, seed=3)
        return
    got = res.parse_inject_spec(spec, seed=3)
    if want is None:
        assert got is None
    else:
        assert (got.rates, got.seed, got.slow_s) == (want.rates, want.seed,
                                                     want.slow_s)


def test_incident_log_summary_as_the_reference():
    port, ref = res.IncidentLog(), ref_res.IncidentLog()
    assert port.summary() == ref.summary() == "incidents=0"
    assert res.INCIDENT_KINDS == ref_res.INCIDENT_KINDS
    for kind, n in (("degraded", 1), ("kernel_fault", 2), ("requeue", 1),
                    ("straggler", 3), ("corrupt_state", 1)):
        port.record(kind, n=n)
        ref.record(kind, n=n)
    assert port.summary() == ref.summary()
    assert port.summary().startswith("incidents=8 (kernel_fault:2,")
    with pytest.raises(ValueError):
        port.record("typo_kind")


@pytest.mark.parametrize("policy", ["uniform", "mixed"])
@pytest.mark.parametrize("stack", ["auto", "off"])
def test_ladders_are_the_reference_ladders_within_one_engine(policy, stack):
    """"cuda" is the reference's "pallas" ladder without its terminal
    decomposed rung; "torch" is its "xla" ladder.  No rung leaves its
    engine."""
    def mapped(rungs, impl):
        return [(r.name.replace(REF_IMPL[impl], impl), impl, r.stack,
                 r.policy) for r in rungs]

    for impl in ("cuda", "torch"):
        got = [(r.name, r.impl, r.stack, r.policy)
               for r in res.degradation_ladder(impl, policy, stack)]
        want = ref_res.degradation_ladder(REF_IMPL[impl], policy, stack)
        if impl == "cuda":
            assert want[-1].impl == "xla"
            want = want[:-1]
        assert got == mapped(want, impl)
        assert {r[1] for r in got} == {impl}
    assert [r.name for r in res.degradation_ladder("cuda", "mixed")] == [
        "cuda+stacks-mixed", "cuda-mixed", "cuda"]
    with pytest.raises(ValueError):
        res.degradation_ladder("pallas", policy)
    with pytest.raises(ValueError):
        res.degradation_ladder("cuda", "int8")


@pytest.mark.parametrize("mode", CORRUPTIONS)
def test_corrupt_json_as_the_reference(tmp_path, mode):
    a, b = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    res.atomic_json_dump({"version": 2, "rows": list(range(40))}, a)
    shutil.copy(a, b)
    res.FaultInjector.corrupt_json(a, mode)
    ref_res.FaultInjector.corrupt_json(b, mode)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
    with pytest.raises(res.CorruptStateError):
        res.load_json(a)
    assert os.path.exists(a)                    # load_json renames nothing


def test_checksum_atomic_dump_and_guarded_load(tmp_path):
    obj = res.with_checksum({"version": 1, "rows": [1, 2, 3]})
    assert obj == ref_res.with_checksum({"version": 1, "rows": [1, 2, 3]})
    res.verify_checksum(dict(obj))
    with pytest.raises(res.CorruptStateError):
        res.verify_checksum({**obj, "rows": [1, 2, 4]})
    res.verify_checksum({"version": 1, "rows": []})   # legacy: accepted
    path = str(tmp_path / "state.json")
    res.atomic_json_dump({"version": 1, "x": 5}, path)
    assert ref_res.load_json_guarded(path) == \
        ref_res.with_checksum({"version": 1, "x": 5})
    assert res.load_json_guarded(path, lambda o: None) == \
        res.with_checksum({"version": 1, "x": 5})
    assert not any(p.name.startswith("state.json.tmp")
                   for p in tmp_path.iterdir())
    hits = []
    assert res.load_json_guarded(
        path, lambda o: (_ for _ in ()).throw(ValueError("bad")),
        on_corrupt=lambda dst, e: hits.append(dst)) is None
    assert hits == [path + ".corrupt"] and not os.path.exists(path)
    res.atomic_json_dump({"version": 1}, path)
    res.FaultInjector.corrupt_json(path, "garbage")
    assert res.load_json_guarded(path) is None
    assert os.path.exists(path + ".corrupt.1")  # the first one kept
    assert res.load_json_guarded(path) is None  # missing: None, no rename


# ---------------------------------------------------------------------------
# crash-safe state: the plan cache and the threshold table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", CORRUPTIONS)
def test_plan_cache_corruption_matrix(tmp_path, mode):
    """A corrupt server-owned cache file is renamed aside and the cache
    starts empty (the reference's cache does the same with the same file),
    replans once, and loads clean after it saves."""
    path = str(tmp_path / "plans.json")
    cache = PlanCache(path, thresholds=TH4, cost_model=REF_CM)
    cache.fused_plan(LENET, 8)
    cache.save()
    res.FaultInjector.corrupt_json(path, mode)
    twin = str(tmp_path / "twin.json")
    shutil.copy(path, twin)
    assert RefPlanCache(twin).corrupt_recoveries == [twin + ".corrupt"]
    cache2 = PlanCache(path, thresholds=TH4, cost_model=REF_CM)
    assert cache2.corrupt_recoveries == [path + ".corrupt"]
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
    _, _, hit = cache2.fused_plan(LENET, 8)
    assert not hit and cache2.planner_calls == 1
    cache2.save()
    cache3 = PlanCache(path, thresholds=TH4, cost_model=REF_CM)
    _, _, hit = cache3.fused_plan(LENET, 8)
    assert hit and cache3.planner_calls == 0 and not cache3.corrupt_recoveries


def test_plan_cache_malformed_entry_is_renamed_aside(tmp_path):
    """Valid JSON with no checksum whose entries do not deserialize."""
    path = str(tmp_path / "plans.json")
    cache = PlanCache(path, thresholds=TH4, cost_model=REF_CM)
    cache.fused_plan(LENET, 8)
    obj = cache.to_json()
    del obj["fused"][0]["plan"]["ops"]
    with open(path, "w") as f:
        json.dump(obj, f)
    cache2 = PlanCache(path, cost_model=REF_CM)
    assert cache2.corrupt_recoveries == [path + ".corrupt"]
    assert cache2.peek_fused(LENET, 8) is None
    assert cache2.thresholds is None          # nothing half-loaded


@pytest.mark.parametrize("mode", CORRUPTIONS)
def test_corrupt_packaged_plan_file_raises_and_stays(tmp_path, monkeypatch,
                                                     mode):
    """A packaged plan file is part of the repo: never renamed."""
    src = port_plan_cache.packaged_plans("alexnet").read_bytes()
    monkeypatch.setattr(port_plan_cache, "PLANS_DIR", tmp_path)
    path = port_plan_cache.packaged_plans("alexnet")
    path.write_bytes(src)
    assert PlanCache(str(path)).peek_fused(CNN_CONFIGS["alexnet"], 128)
    res.FaultInjector.corrupt_json(str(path), mode)
    with pytest.raises(res.CorruptStateError):
        PlanCache(str(path))
    assert path.exists() and not list(tmp_path.glob("*.corrupt*"))


def _port_measure(calls):
    def measure(l, lay):
        calls.append(1)
        return conv_cost(l, lay, 4).total_s
    return measure


@pytest.mark.parametrize("mode", CORRUPTIONS)
def test_thresholds_corruption_matrix(tmp_path, mode):
    """A corrupt threshold file is renamed aside and the row measured
    again, as the reference does with the same file."""
    path = str(tmp_path / "thresholds.json")
    calls = []
    th = measured_thresholds(path, dtype="float32",
                             measure=_port_measure(calls))
    assert calls
    res.FaultInjector.corrupt_json(path, mode)
    twin = str(tmp_path / "twin.json")
    shutil.copy(path, twin)
    ref_hits = []
    ref_measured_thresholds(twin, dtype="float32",
                            measure=lambda l, lay: 1.0,
                            on_corrupt=lambda dst, e: ref_hits.append(dst))
    calls.clear()
    hits = []
    th2 = measured_thresholds(path, dtype="float32",
                              measure=_port_measure(calls),
                              on_corrupt=lambda dst, e: hits.append(dst))
    assert th2 == th and calls                     # measured again
    assert [os.path.basename(h) for h in hits] == [
        os.path.basename(h).replace("twin", "thresholds") for h in ref_hits]
    assert hits == [path + ".corrupt"] and os.path.exists(hits[0])
    calls.clear()
    assert measured_thresholds(path, dtype="float32",
                               measure=_port_measure(calls)) == th
    assert not calls                               # the new file loads


# ---------------------------------------------------------------------------
# checkpoints: across the packages, and the runner's restarts
# ---------------------------------------------------------------------------

def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _port_bits(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("network", ["lenet", "cifarnet"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_the_packages_bit_for_bit(tmp_path, network,
                                                    dtype):
    cfg = CNN_CONFIGS[network]
    tree = params_from_numpy(init_cnn(cfg, 3), "cpu", dtype)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jtree = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(jdt),
                         tree)
    # the port writes, the reference reads
    Checkpointer(str(tmp_path / "port"), async_write=False).save(5, tree)
    step, got = RefCheckpointer(str(tmp_path / "port")).restore(jtree)
    assert step == 5
    for layer, p in tree.items():
        for k, t in p.items():
            g = np.asarray(got[layer][k])
            assert g.dtype == np.asarray(jtree[layer][k]).dtype
            np.testing.assert_array_equal(_bits(g), _port_bits(t))
    # the reference writes, the port reads
    RefCheckpointer(str(tmp_path / "ref"), async_write=False).save(7, jtree)
    like = jax.tree.map(torch.zeros_like, tree)
    step, back = Checkpointer(str(tmp_path / "ref")).restore(like)
    assert step == 7
    for layer, p in tree.items():
        for k, t in p.items():
            assert back[layer][k].dtype == t.dtype
            np.testing.assert_array_equal(_port_bits(back[layer][k]),
                                          _port_bits(t))
    # one manifest format
    man = [json.loads((tmp_path / d / f"step_{s:010d}" /
                       "manifest.json").read_text())
           for d, s in (("port", 5), ("ref", 7))]
    for key in ("paths", "dtypes", "shapes"):
        assert man[0][key] == man[1][key]
    assert man[0]["paths"][0].startswith("['")


def test_checkpointer_async_steps_gc_and_errors(tmp_path):
    ck = Checkpointer(str(tmp_path))
    assert ck.steps() == [] and ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore({"x": torch.zeros(2)})
    state = {"x": torch.arange(3.0), "n": [np.int64(4), 2.5], "z": None}
    for s in (4, 2, 8):
        ck.save(s, state)
        state["x"].add_(1.0)                    # after save: not in it
    ck.wait()
    assert ck.steps() == [2, 4, 8] and ck.latest_step() == 8
    step, got = ck.restore(state, step=2)
    assert step == 2 and got["z"] is None
    assert torch.equal(got["x"], torch.arange(3.0) + 1)
    assert got["n"][0] == 4 and isinstance(got["n"][0], np.int64)
    assert got["n"][1] == 2.5 and isinstance(got["n"][1], float)
    with pytest.raises(ValueError, match="structure"):
        ck.restore({"y": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"x": torch.zeros(4), "n": [np.int64(0), 0.0]})
    ck.gc(keep=2)
    assert ck.steps() == [4, 8]
    # an asynchronous write's error is raised at the next wait
    ck.save(9, {"x": torch.zeros(1)})
    ck.wait()
    (tmp_path / "blocker").write_text("")
    ck.dir = tmp_path / "blocker"
    ck.save(10, {"x": torch.zeros(1)})
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ck.wait()


def _counting_step(fail_at):
    """state['x'] += 1; fails ONCE at each step in ``fail_at``."""
    seen = {}

    def step_fn(state, step):
        if step in fail_at and not seen.get(step):
            seen[step] = True
            raise StepFailure(f"injected at {step}")
        return {"x": state["x"] + 1}, {}

    return step_fn


def test_runner_restart_without_checkpoint_resets_to_initial(tmp_path):
    runner = FaultTolerantRunner(Checkpointer(str(tmp_path),
                                              async_write=False),
                                 save_every=100)
    step, state = runner.run({"x": 0}, _counting_step({2}), total_steps=4)
    assert step == 4 and state["x"] == 4


@pytest.mark.parametrize("leaf", ["int", "tensor"])
def test_runner_restart_protects_against_inplace_mutation(tmp_path, leaf):
    """A step that mutates its state in place before failing does not
    poison the replay baseline: the snapshot clones tensors."""
    attempts = {"n": 0}

    def step_fn(state, step):
        if step == 0 and attempts["n"] == 0:
            attempts["n"] = 1
            state["x"] += 999                     # in place, then fail
            raise StepFailure("boom")
        return {"x": state["x"] + 10}, {}

    x0 = 0 if leaf == "int" else torch.zeros(2)
    runner = FaultTolerantRunner(Checkpointer(str(tmp_path),
                                              async_write=False),
                                 save_every=100)
    _, state = runner.run({"x": x0}, step_fn, total_steps=3)
    assert bool((torch.as_tensor(state["x"]) == 30).all())


def test_runner_falls_back_to_next_oldest_checkpoint(tmp_path):
    ck = Checkpointer(str(tmp_path), async_write=False)
    runner = FaultTolerantRunner(ck, save_every=2, keep=5)
    step_fn = _counting_step({5})
    state = {"x": torch.tensor(0)}
    for s in range(4):
        state, _ = step_fn(state, s)
        if (s + 1) % 2 == 0:
            ck.save(s + 1, state)
    (tmp_path / "step_0000000004" / "manifest.json").write_text("not json")
    restores = []
    real = ck.restore
    ck.restore = lambda *a, **k: restores.append(k["step"]) or real(*a, **k)
    step, state = runner.run(state, step_fn, total_steps=6, start_step=4,
                             device="cpu")
    assert step == 6 and int(state["x"]) == 6
    assert restores == [4, 2]                    # newest first, then back
    assert ck.steps() == [2, 4, 6]


@pytest.mark.parametrize("err", [KernelBuildError, KernelLaunchError])
def test_runner_reraises_kernel_errors_at_once(tmp_path, err):
    """A kernel that fails to build or launch is not a step's fault to
    restart over: the runner re-raises it on the first failure, with no
    restore and no replay."""
    ck = Checkpointer(str(tmp_path), async_write=False)
    runner = FaultTolerantRunner(ck, save_every=1, max_restarts=5)
    calls = []

    def step_fn(state, step):
        calls.append(step)
        if step == 2:
            raise err("conv_chwn: CUDA launch failed: too many resources")
        return {"x": state["x"] + 1}, {}

    with pytest.raises(err, match="CUDA launch failed"):
        runner.run({"x": torch.tensor(0)}, step_fn, total_steps=5)
    assert calls == [0, 1, 2]
    assert ck.steps() == [1, 2]


def test_watchdog_flags_a_slow_step():
    seen = []
    wd = StragglerWatchdog(warmup=3, on_straggler=lambda *a: seen.append(a))
    assert not any(wd.observe(i, 0.1 + 0.001 * (i % 2)) for i in range(50))
    assert wd.observe(50, 1.0) and wd.flagged == [(50, 1.0)] and seen


# ---------------------------------------------------------------------------
# the guarded server against the reference's
# ---------------------------------------------------------------------------

def _drive_reference(srv, requests, seed=0):
    """The reference server under the port's ``run(rng=)`` arrivals: bursty
    chunks (1..max_bucket, seeded), one step a chunk, then drained; a
    fully failed step is retried."""
    rng = np.random.default_rng(seed)
    done, i, cap = {}, 0, srv.cache.max_bucket
    while i < len(requests) or srv.queue:
        if i < len(requests):
            n = int(rng.integers(1, cap + 1))
            for rid, im in requests[i:i + n]:
                srv.submit(RefRequest(rid, im))
            i += n
        try:
            for r in srv.step():
                done[r.rid] = r.probs
        except ref_res.ServingFault:
            pass
    return done


def test_guarded_server_walks_the_ladder_as_the_reference(tmp_path):
    """lenet, mixed, "kernel=0.1,nan@mixed=1.0" at seed 0: equal incident
    counts (stragglers follow the host clock), the same rung per bucket,
    quarantine set and plans, answers within 1e-5."""
    srv = make_server(tmp_path, dtype_policy="mixed", thresholds=None,
                      injector=res.parse_inject_spec(SPEC, seed=0), seed=5)
    ref = RefServer("lenet", max_bucket=8, impl="xla",
                    calibration="analytic", dtype_policy="mixed",
                    injector=ref_res.parse_inject_spec(SPEC, seed=0))
    ref.params = jax.tree.map(jnp.asarray, init_cnn(srv.cfg, seed=5))
    requests = list(enumerate(_images(srv.cfg, 48, seed=1)))
    got = srv.run([ImageRequest(rid, im) for rid, im in requests],
                  rng=np.random.default_rng(0))
    want = _drive_reference(ref, requests)
    assert sorted(got) == sorted(want) == list(range(48))
    for rid in range(48):
        assert np.isfinite(got[rid]).all()
        np.testing.assert_allclose(got[rid], want[rid], rtol=0,
                                   atol=PROB_ATOL)
    counts = {k: v for k, v in srv.incidents.counts.items()
              if k != "straggler"}
    assert counts == {k: v for k, v in ref.incidents.counts.items()
                      if k != "straggler"}
    assert counts["kernel_fault"] == srv.injector.counts["kernel"]
    assert counts["nonfinite"] == srv.injector.counts["nan@mixed"]
    assert srv.injector.counts == ref.injector.counts
    assert sorted(srv.reports) == sorted(ref.reports)
    for b, rep in srv.reports.items():
        r = ref.reports[b]
        assert rep.rung == r.rung.replace("xla", "cuda") == "cuda"
        assert (rep.batches, rep.images, rep.degraded, rep.failures,
                rep.hits, rep.misses) == (r.batches, r.images, r.degraded,
                                          r.failures, r.hits, r.misses)
    assert srv._quarantine == {(b, p, s, "cuda")
                               for b, p, s, _ in ref._quarantine}
    assert srv.cache.planner_calls == ref.cache.planner_calls
    for key, plan in srv.cache._fused.items():
        want_plan = ref.cache.peek_fused(ref.cfg, key.bucket,
                                         policy=key.policy, stack=key.stack)
        assert dataclasses.asdict(plan) == dataclasses.asdict(want_plan)
    lines = srv.report_lines()
    assert lines[-1].strip().startswith(srv.incidents.summary())
    assert all("rung=cuda " in ln for ln in lines[1:-1])


@pytest.mark.parametrize("rung_idx", [0, 1, 2])
def test_degraded_output_bit_equal_to_rung(tmp_path, rung_idx):
    """Every rung above ``rung_idx`` forced to fail: the served batch is
    bit-equal to the landing rung's own plan run directly."""
    ladder = res.degradation_ladder("cuda", "mixed")
    rates = {f"kernel@{ladder[i].name}": 1.0 for i in range(rung_idx)}
    srv = make_server(tmp_path, dtype_policy="mixed",
                      injector=res.FaultInjector(seed=0, rates=rates)
                      if rates else None)
    reqs = make_requests(srv.cfg, 5)
    done = srv.run(reqs)
    assert set(done) == {r.rid for r in reqs}
    rung = ladder[rung_idx]
    assert srv.reports[8].rung == rung.name
    assert srv.reports[8].failures == rung_idx
    plan = plan_network_fused(srv.cfg.replace(batch=8), dtype=srv.dtype,
                              policy=rung.policy, stack_policy=rung.stack,
                              cost_model=REF_CM)
    x = torch.from_numpy(np.stack([r.image for r in reqs]))
    with torch.inference_mode():
        y, _ = forward_fused(srv.model.params(), pad_to_bucket(x, 8),
                             srv.cfg, plan, impl=rung.impl)
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(done[r.rid], y[i].numpy())


def test_quarantine_skips_without_replanning(tmp_path):
    srv = make_server(tmp_path, dtype_policy="mixed",
                      injector=res.FaultInjector(seed=0,
                                                 rates={"nan@mixed": 1.0}))
    srv.run(make_requests(srv.cfg, 8))           # one bucket-8 batch
    calls = srv.cache.planner_calls
    fails = srv.reports[8].failures
    assert calls == 3 and fails == 2 and len(srv._quarantine) == 2
    srv.run(make_requests(srv.cfg, 24, seed=1))  # three more batches
    assert srv.cache.planner_calls == calls
    assert srv.reports[8].failures == fails
    assert srv.reports[8].degraded == 4


def test_clean_server_stays_on_top_rung(tmp_path):
    srv = make_server(tmp_path)
    done = srv.run(make_requests(srv.cfg, 24))
    assert len(done) == 24
    assert srv.incidents.total == 0 and not srv._quarantine
    for rep in srv.reports.values():
        assert rep.rung == "cuda+stacks" and rep.degraded == 0
    assert srv.cache.planner_calls == len(srv.reports)
    assert "incidents=0" in srv.report_lines()[-1]
    assert set(srv.prediction_errors()) == set(srv.reports)


def test_watchdog_hook_wired_into_step(tmp_path):
    class AlwaysFlag:
        flagged = [(1, 9.9)]

        def observe(self, step, dt):
            return True

    srv = make_server(tmp_path)
    srv._watchdogs[8] = AlwaysFlag()
    srv.run(make_requests(srv.cfg, 8))
    assert srv.incidents.counts["straggler"] == 1
    assert any("stragglers=1" in ln for ln in srv.report_lines())


def test_total_failure_requeues_in_original_order(tmp_path):
    srv = make_server(tmp_path, injector=res.FaultInjector(
        seed=0, rates={"kernel": 1.0}))
    for r in make_requests(srv.cfg, 6):
        srv.submit(r)
    for i, r in enumerate(make_requests(srv.cfg, 2, seed=9)):
        r.rid = 100 + i
        srv.submit(r)
    with pytest.raises(res.ServingFault):
        srv.step()
    assert [r.rid for r in srv.queue] == [0, 1, 2, 3, 4, 5, 100, 101]
    assert srv.incidents.counts["requeue"] == 1
    srv.injector = None
    srv._quarantine.clear()
    done = srv.run([])
    assert set(done) == {0, 1, 2, 3, 4, 5, 100, 101}


def test_run_retries_through_step_failures(tmp_path):
    srv = make_server(tmp_path, injector=res.FaultInjector(
        seed=0, rates={"kernel@cuda+stacks": 1.0, "nan@cuda": 0.3}))
    reqs = make_requests(srv.cfg, 24)
    assert set(srv.run(reqs)) == {r.rid for r in reqs}
    assert srv.incidents.counts["degraded"] >= 1
    srv2 = make_server(injector=res.FaultInjector(seed=0,
                                                  rates={"kernel": 1.0}),
                       max_step_failures=2)
    with pytest.raises(res.ServingFault):
        srv2.run(make_requests(srv2.cfg, 3))
    assert len(srv2.queue) == 3 and srv2.incidents.counts["requeue"] == 3


def test_server_recovers_from_corrupt_state_and_restarts_clean(tmp_path):
    """Both files corrupted: the server constructs, counts two
    corrupt_state incidents, renames both aside, re-measures its rows and
    replans; a restart after that is clean."""
    measure_calls = []
    kw = dict(calibration="measured", thresholds=None,
              calib_path=str(tmp_path / "thresholds.json"),
              dtype_policy="mixed")
    import repro_torch.launch.cnn_serve as cs

    def card_measure(dtype, device):
        def measure(l, lay):
            measure_calls.append(dtype)
            return conv_cost(l, lay, 4 if dtype == "float32" else 1).total_s
        return measure

    orig = cs.card_conv_measure
    cs.card_conv_measure = card_measure
    try:
        srv = make_server(tmp_path, **kw)
        srv.run(make_requests(srv.cfg, 16))
        buckets = sorted(srv.reports)
        assert set(measure_calls) == {"float32", "int8"}
        res.FaultInjector.corrupt_json(str(tmp_path / "plans.json"),
                                       "garbage")
        res.FaultInjector.corrupt_json(str(tmp_path / "thresholds.json"),
                                       "truncate")
        measure_calls.clear()
        srv2 = make_server(tmp_path, **kw)
        assert srv2.incidents.counts == {"corrupt_state": 2}
        assert os.path.exists(tmp_path / "plans.json.corrupt")
        assert os.path.exists(tmp_path / "thresholds.json.corrupt")
        assert set(measure_calls) == {"float32", "int8"}
        assert len(srv2.run(make_requests(srv2.cfg, 16))) == 16
        assert srv2.cache.planner_calls == len(buckets)
        measure_calls.clear()
        srv3 = make_server(tmp_path, **kw)
        assert srv3.incidents.total == 0 and not measure_calls
        srv3.run(make_requests(srv3.cfg, 16))
        assert srv3.cache.planner_calls == 0
    finally:
        cs.card_conv_measure = orig


# ---------------------------------------------------------------------------
# the guard never hides a kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("err", [KernelBuildError, KernelLaunchError])
def test_kernel_errors_propagate_with_the_batch_requeued(tmp_path,
                                                         monkeypatch, err):
    """A kernel that fails to build or launch: the admitted batch goes
    back, in order; the error propagates from the top rung, and no lower
    rung runs."""
    srv = make_server(tmp_path, dtype_policy="mixed")
    for r in make_requests(srv.cfg, 5):
        srv.submit(r)
    calls = []

    def fail(x, plan, impl="cuda"):
        calls.append(impl)
        raise err("conv_chwn: CUDA launch failed: too many resources")

    monkeypatch.setattr(srv.model, "forward", fail)
    with pytest.raises(err, match="CUDA launch failed"):
        srv.step()
    assert calls == ["cuda"]
    assert [r.rid for r in srv.queue] == [0, 1, 2, 3, 4]
    assert srv.incidents.counts == {"requeue": 1}
    assert not srv._quarantine and not srv.reports
    with pytest.raises(err):
        srv.run([])
    assert len(srv.queue) == 5


def test_a_cuda_server_ladder_holds_no_torch_rung():
    for policy in ("uniform", "mixed"):
        for stack in ("auto", "off"):
            srv = make_server(dtype_policy=policy, stack=stack)
            assert {r.impl for r in srv.ladder} == {"cuda"}
            assert srv.ladder[-1].name == "cuda"
            torch_srv = make_server(dtype_policy=policy, stack=stack,
                                    impl="torch")
            assert {r.impl for r in torch_srv.ladder} == {"torch"}
    with pytest.raises(ValueError, match="impl"):
        make_server(impl="xla")


def test_torch_engine_server_answers_as_the_cuda_server(tmp_path):
    reqs = make_requests(LENET, 12)
    a = make_server(tmp_path, seed=2).run(reqs)
    b = make_server(seed=2, impl="torch").run(make_requests(LENET, 12))
    for rid in a:
        np.testing.assert_allclose(a[rid], b[rid], rtol=0, atol=PROB_ATOL)


def test_command_line_with_injection(tmp_path, capsys):
    from repro_torch.launch import cnn_serve
    path = str(tmp_path / "plans.json")
    args = ["--network", "lenet", "--requests", "24", "--max-bucket", "8",
            "--device", "cpu", "--calibration", "analytic", "--cache-path",
            path, "--inject", SPEC, "--inject-seed", "0", "--backoff", "0",
            "--dtype-policy", "mixed", "--max-plans", "4"]
    cnn_serve.main(args)
    out = capsys.readouterr().out
    assert "served 24/24 requests" in out and "dropped=0" in out
    assert "nonfinite:" in out and "rung=cuda " in out
    assert os.path.exists(path)
    cnn_serve.main(args[:-10] + ["--impl", "torch"])
    assert "ladder=torch+stacks,torch" in capsys.readouterr().out
