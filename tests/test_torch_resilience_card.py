"""The guarded server and the checkpoints on the card.

A batch that lands on a lower rung of the ladder is bit-equal to that
rung's plan run on the kernels; a kernel launch the card refuses surfaces
as ``KernelLaunchError`` through the server, with the batch re-queued and
no lower rung tried; checkpoints of CUDA tensors (fp32 and bf16) round
trip bit for bit; a training run restarted from a checkpoint ends where
the uninterrupted run does.

Every test needs a CUDA device and ``nvcc`` and skips with the reason
where either is missing.  No jax, no reference package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_resilience_card.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.cnn.layers import init_cnn, params_from_numpy
from repro_torch.cnn.network import (forward_fused, init_velocity,
                                     input_shape, make_train_step_fused,
                                     plan_network_fused)
from repro_torch.configs.cnn_networks import CNN_CONFIGS
from repro_torch.kernels import _build
from repro_torch.kernels.conv import ops as conv_ops
from repro_torch.launch.cnn_serve import CNNServer, ImageRequest
from repro_torch.runtime.fault_tolerance import (FaultTolerantRunner,
                                                 StepFailure)
from repro_torch.runtime.resilience import FaultInjector, degradation_ladder
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


@pytest.mark.parametrize("rung_idx", [0, 1, 2])
def test_ladder_answers_bit_equal_to_the_landing_rungs_kernels(card,
                                                               rung_idx):
    """alexnet at 96 px, mixed: every rung above ``rung_idx`` fails; the
    served batch is bit-equal to the landing rung's plan on the kernels,
    and the kernels launched are exactly the ones of the rungs whose
    forward ran (an injected kernel fault fires before any launch)."""
    ladder = degradation_ladder("cuda", "mixed")
    rates = {f"kernel@{ladder[i].name}": 1.0 for i in range(rung_idx)}
    srv = CNNServer("alexnet", max_bucket=8, calibration="analytic",
                    dtype_policy="mixed",
                    injector=FaultInjector(seed=0, rates=rates))
    reqs = _requests(srv.cfg, 6)
    K.reset_launch_counts()
    done = srv.run(reqs)
    torch.cuda.synchronize()
    rung = ladder[rung_idx]
    assert srv.reports[8].rung == rung.name
    assert srv.incidents.counts.get("kernel_fault", 0) == rung_idx
    plan = srv.cache.peek_fused(srv.cfg, 8, policy=rung.policy,
                                stack=rung.stack)
    launched = K.launch_counts()
    x = torch.from_numpy(np.stack([r.image for r in reqs])).to(card)
    with torch.inference_mode():
        K.reset_launch_counts()
        y, _ = forward_fused(srv.model.params(), pad_to_bucket(x, 8),
                             srv.cfg, plan, impl="cuda")
        torch.cuda.synchronize()
        assert launched == K.launch_counts()
        y = y.float().cpu().numpy()
        want, _ = forward_fused(srv.model.params(), pad_to_bucket(x, 8),
                                srv.cfg, plan, impl="torch")
    for i, r in enumerate(reqs):
        np.testing.assert_array_equal(done[r.rid], y[i])
        np.testing.assert_allclose(done[r.rid], want[i].cpu().numpy(),
                                   rtol=0, atol=1e-5)


def test_a_refused_launch_surfaces_through_the_server(card, monkeypatch):
    """AlexNet at full width, stack "auto": its K5a stack launched as a
    cluster of 16 blocks, past the portable 8, is refused by the card.
    ``KernelLaunchError`` propagates from the top rung; the batch is back
    in order, nothing is quarantined and no lower rung ran."""
    srv = CNNServer("alexnet", reduced=False, max_bucket=128,
                    calibration="analytic")
    plan = srv.cache.peek_fused(srv.cfg, 128)
    assert plan.stacked_convs >= 1 and srv.ladder[0].name == "cuda+stacks"
    forced = conv_ops.StackTiling(64, 8, 2, 2, 0, 0, 0, 0, cluster=16)
    monkeypatch.setattr(conv_ops, "stack_tiling", lambda *a, **k: forced)
    for r in _requests(srv.cfg, 128):
        srv.submit(r)
    K.reset_launch_counts()
    with pytest.raises(_build.KernelLaunchError, match="CUDA launch failed"):
        srv.step()
    assert K.launch_counts()["conv_stack_chwn"] == 0
    assert [r.rid for r in srv.queue] == list(range(128))
    assert srv.incidents.counts == {"requeue": 1}
    assert not srv._quarantine
    monkeypatch.undo()
    done = srv.run([])
    assert len(done) == 128 and srv.reports[128].rung == "cuda+stacks"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_round_trip_on_cuda(card, tmp_path, dtype):
    cfg = CNN_CONFIGS["cifarnet"]
    params = params_from_numpy(init_cnn(cfg, 1), card, dtype)
    state = {"params": params, "vel": init_velocity(params), "step": 3}
    for p in state["vel"].values():
        for v in p.values():
            v.normal_()
    ck = Checkpointer(str(tmp_path))
    ck.save(3, state)
    ck.wait()
    like = {"params": {l: {k: torch.empty_like(v) for k, v in p.items()}
                       for l, p in params.items()},
            "vel": init_velocity(params), "step": 0}
    for device in (None, "cpu"):
        step, back = ck.restore(like, device=device)
        assert step == 3 and back["step"] == 3
        for part in ("params", "vel"):
            for l, p in state[part].items():
                for k, v in p.items():
                    b = back[part][l][k]
                    assert b.dtype == v.dtype
                    assert b.device.type == (device or "cuda")
                    assert torch.equal(b.cpu().view(torch.int16 if dtype
                                                    == "bfloat16" else
                                                    torch.int32),
                                       v.cpu().view(torch.int16 if dtype
                                                    == "bfloat16" else
                                                    torch.int32))


def test_runner_resumes_training_bit_exactly(card, tmp_path):
    """cifarnet b16 on the kernels: 6 steps with a failure at step 3
    restore from step 2 and end where the uninterrupted 6 steps do."""
    cfg = CNN_CONFIGS["cifarnet"].replace(batch=16)
    plan = plan_network_fused(cfg)
    step_fn_k = make_train_step_fused(cfg, plan)
    rng = np.random.default_rng(0)
    xs = [torch.from_numpy(rng.standard_normal(input_shape(cfg),
                                               np.float32)).to(card)
          for _ in range(6)]
    ys = [torch.from_numpy(rng.integers(0, cfg.num_classes, 16)).to(card)
          for _ in range(6)]
    failed = set()

    def step_fn(state, step, fail_at=None):
        if step == fail_at and step not in failed:
            failed.add(step)
            raise StepFailure(f"injected at {step}")
        p, v, loss = step_fn_k(state["params"], state["vel"], xs[step],
                               ys[step])
        return {"params": p, "vel": v}, {"loss": loss.item()}

    def start():
        params = params_from_numpy(init_cnn(cfg, 0), card)
        return {"params": params, "vel": init_velocity(params)}

    _, want = FaultTolerantRunner(Checkpointer(str(tmp_path / "a")),
                                  save_every=2).run(start(), step_fn, 6)
    runner = FaultTolerantRunner(Checkpointer(str(tmp_path / "b")),
                                 save_every=2)
    step, got = runner.run(start(), lambda s, i: step_fn(s, i, fail_at=3),
                           6)
    assert step == 6 and failed == {3}
    for part in ("params", "vel"):
        for l, p in want[part].items():
            for k, v in p.items():
                assert torch.equal(got[part][l][k], v), (part, l, k)
