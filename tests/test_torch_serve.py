"""The port's ``CNNServer`` answers as the reference ``CNNServer`` does.

The reference planner writes a plan file with both stack policies; the
port's server (on the CPU, where its kernels' plain versions run) loads it
and never plans.  At ``stack="auto"`` it serves the plans of the reference
server's top rung (``pallas+stacks``, here executed by the reference's xla
engine), conv->conv stacks included.  Both servers carry the same weights
(the port's ``init_cnn`` tree) and answer the same seeded requests;
probabilities agree within 1e-5.
"""
from __future__ import annotations

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
from repro_torch.serve.plan_cache import PlanMissError

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
                    device="cpu", seed=5)
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
                    device="cpu", seed=5, stack="off")
    got_off = off.run([ImageRequest(i, im) for i, im in enumerate(images)])
    for rid in range(n_requests):
        np.testing.assert_allclose(got_off[rid], want[rid], rtol=0,
                                   atol=PROB_ATOL)
    assert "stack=off" in off.report_lines()[0]
    with pytest.raises(ValueError, match="stack policy"):
        CNNServer(network, cache_path=path, device="cpu", stack="on")
    assert all("hit_rate=1.00" in ln for ln in lines[1:])
    # fp32 means fp32 on the card too: the server turns TF32 off
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


def test_server_without_plan_raises_and_keeps_requests(tmp_path):
    ref = RefServer("lenet", max_bucket=4, impl="xla",
                    calibration="analytic")
    cache = RefPlanCache(max_bucket=4)
    cache.fused_plan(ref.cfg, 4, stack="off")       # bucket 4 only
    path = cache.save(str(tmp_path / "plans.json"))
    srv = CNNServer("lenet", max_bucket=4, cache_path=path, device="cpu")
    img = np.zeros((1, 28, 28), np.float32)
    for i in range(2):                              # bucket 2: no plan
        srv.submit(ImageRequest(i, img))
    with pytest.raises(PlanMissError, match="no planner"):
        srv.step()
    assert [r.rid for r in srv.queue] == [0, 1]
    assert srv.cache.planner_calls == 0
    with pytest.raises(ValueError, match="image shape"):
        srv.submit(ImageRequest(9, np.zeros((3, 28, 28), np.float32)))



def test_server_command_line_on_cpu(tmp_path, capsys):
    from repro_torch.launch import cnn_serve
    ref = RefServer("lenet", max_bucket=4, impl="xla",
                    calibration="analytic")
    path = _reference_plan_file(ref, tmp_path / "plans.json", 4)
    cnn_serve.main(["--network", "lenet", "--requests", "6",
                    "--max-bucket", "4", "--cache-path", path,
                    "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 6/6 requests" in out
    assert "bucket=2 " in out and "bucket=4 " in out
