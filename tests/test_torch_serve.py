"""The port's ``CNNServer`` answers as the reference ``CNNServer`` does.

The reference planner writes a plan file with both stack policies; the
port's server (on the CPU, where its kernels' plain versions run) loads it
and plans nothing more.  A bucket the file lacks is planned once, and
under the reference's device profile that plan is the reference's.  At ``stack="auto"`` it serves the plans of the reference
server's top rung (``pallas+stacks``, here executed by the reference's xla
engine), conv->conv stacks included.  Both servers carry the same weights
(the port's ``init_cnn`` tree) and answer the same seeded requests;
probabilities agree within 1e-5.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.cnn_serve import CNNServer as RefServer
from repro.launch.cnn_serve import ImageRequest as RefRequest
from repro.serve.plan_cache import PlanCache as RefPlanCache

from repro_torch.cnn.layers import init_cnn
from repro_torch.launch.cnn_serve import CNNServer, ImageRequest
from repro_torch.runtime.resilience import ServingFault
from tests.test_torch_planner_plans import REF_CM

PROB_ATOL = 1e-5


def _reference_plan_file(ref_srv, path, max_bucket: int) -> str:
    cache = RefPlanCache(max_bucket=max_bucket)
    b = 1
    while b <= max_bucket:
        for stack in ("auto", "off"):
            cache.fused_plan(ref_srv.cfg, b, dtype="float32", stack=stack)
        b *= 2
    return cache.save(str(path))


@pytest.mark.parametrize("network,n_requests", [("lenet", 12),
                                                ("alexnet", 6),
                                                ("resnet18", 6)])
def test_server_answers_like_reference(network, n_requests, tmp_path):
    max_bucket = 8
    ref = RefServer(network, max_bucket=max_bucket, impl="xla",
                    calibration="analytic")
    assert (ref.ladder[0].stack, ref.ladder[0].impl) == ("auto", "xla")
    path = _reference_plan_file(ref, tmp_path / "plans.json", max_bucket)
    srv = CNNServer(network, max_bucket=max_bucket, cache_path=path,
                    device="cpu", seed=5, calibration="analytic")
    assert srv.stack == "auto"
    assert repr(srv.cfg.layers) == repr(ref.cfg.layers)
    ref.params = jax.tree.map(jnp.asarray, init_cnn(srv.cfg, seed=5))

    rng = np.random.default_rng(11)
    c, h = srv.cfg.in_channels, srv.cfg.image_hw
    images = [rng.standard_normal((c, h, h), np.float32)
              for _ in range(n_requests)]
    want = ref.run([RefRequest(i, im) for i, im in enumerate(images)])
    got = srv.run([ImageRequest(i, im) for i, im in enumerate(images)])
    assert sorted(got) == list(range(n_requests))
    for rid in range(n_requests):
        np.testing.assert_allclose(got[rid], want[rid], rtol=0,
                                   atol=PROB_ATOL)
    assert srv.cache.planner_calls == 0
    lines = srv.report_lines()
    assert "planner_calls=0" in lines[0] and "stack=auto" in lines[0]
    # the second rung's plans answer the same
    off = CNNServer(network, max_bucket=max_bucket, cache_path=path,
                    device="cpu", seed=5, stack="off",
                    calibration="analytic")
    got_off = off.run([ImageRequest(i, im) for i, im in enumerate(images)])
    for rid in range(n_requests):
        np.testing.assert_allclose(got_off[rid], want[rid], rtol=0,
                                   atol=PROB_ATOL)
    assert "stack=off" in off.report_lines()[0]
    with pytest.raises(ValueError, match="stack policy"):
        CNNServer(network, cache_path=path, device="cpu", stack="on")
    with pytest.raises(ValueError, match="calibration"):
        CNNServer(network, cache_path=path, device="cpu",
                  calibration="guess")
    assert all("hit_rate=1.00" in ln for ln in lines[1:-1])
    assert lines[-1].strip() == "incidents=0 quarantined_variants=0"
    # fp32 means fp32 on the card too: the server turns TF32 off
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_server_plans_a_missing_bucket_and_keeps_requests(tmp_path,
                                                           monkeypatch):
    ref = RefServer("lenet", max_bucket=4, impl="xla",
                    calibration="analytic")
    cache = RefPlanCache(max_bucket=4)
    cache.fused_plan(ref.cfg, 4)                    # bucket 4 only
    path = cache.save(str(tmp_path / "plans.json"))
    srv = CNNServer("lenet", max_bucket=4, cache_path=path, device="cpu",
                    calibration="analytic", cost_model=REF_CM, seed=2)
    ref.params = jax.tree.map(jnp.asarray, init_cnn(srv.cfg, seed=2))
    rng = np.random.default_rng(3)
    images = [rng.standard_normal((1, 28, 28), np.float32)
              for _ in range(6)]
    got = srv.run([ImageRequest(i, im) for i, im in enumerate(images)])
    want = ref.run([RefRequest(i, im) for i, im in enumerate(images)])
    for rid in range(6):                            # buckets 4, then 2
        np.testing.assert_allclose(got[rid], want[rid], rtol=0,
                                   atol=PROB_ATOL)
    assert srv.cache.planner_calls == 1             # bucket 2, once
    assert (srv.reports[4].hits, srv.reports[2].misses) == (1, 1)
    plan = dataclasses.asdict(srv.cache.peek_fused(srv.cfg, 2))
    assert plan == dataclasses.asdict(ref.cache.peek_fused(ref.cfg, 2))
    # the planned bucket was saved beside the reference's own
    assert dataclasses.asdict(RefPlanCache(path).peek_fused(ref.cfg,
                                                            2)) == plan
    # a forward that fails on every rung of the guarded server's ladder
    # (both run the kernels): ServingFault, the admitted batch back in
    # order, and one planner call for the rung variant not yet planned
    # (bucket 2 at stack "off")
    for i in range(2):
        srv.submit(ImageRequest(10 + i, images[i]))

    def boom(*args, **kwargs):
        raise RuntimeError("kernel failed")

    assert [r.name for r in srv.ladder] == ["cuda+stacks", "cuda"]
    monkeypatch.setattr(srv.model, "forward", boom)
    with pytest.raises(ServingFault, match="kernel failed") as err:
        srv.step()
    assert "cuda+stacks: RuntimeError" in str(err.value)
    assert "cuda: RuntimeError" in str(err.value)
    assert [r.rid for r in srv.queue] == [10, 11]
    assert srv.cache.planner_calls == 2
    assert srv.incidents.counts == {"kernel_fault": 2, "quarantine": 2,
                                    "requeue": 1}
    with pytest.raises(ValueError, match="image shape"):
        srv.submit(ImageRequest(9, np.zeros((3, 28, 28), np.float32)))



def test_server_command_line_on_cpu(tmp_path, capsys):
    from repro_torch.launch import cnn_serve
    ref = RefServer("lenet", max_bucket=4, impl="xla",
                    calibration="analytic")
    path = _reference_plan_file(ref, tmp_path / "plans.json", 4)
    cnn_serve.main(["--network", "lenet", "--requests", "6",
                    "--max-bucket", "4", "--cache-path", path,
                    "--device", "cpu", "--calibration", "analytic"])
    out = capsys.readouterr().out
    assert "served 6/6 requests" in out
    assert "bucket=2 " in out and "bucket=4 " in out
