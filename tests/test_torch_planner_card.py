"""The planner's card paths: the K1/K2 measure and a default server.

Every test here needs a CUDA device and ``nvcc`` and skips with the reason
where either is missing.  The module imports neither ``jax`` nor the
reference package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_planner_card.py

``card_conv_measure`` times K1 (CHWN) and K2 (NCHW) on the card and
returns finite positive seconds, launching the kernels (their launch
counts move) and never the plain versions; ``CNNServer()`` with its
default network (lenet, which no packaged file plans) measures its
thresholds, plans each bucket on a miss and serves on the kernels,
within 1e-5 of the torch engine.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.cnn.network import forward_fused
from repro_torch.configs.paper_table1 import ConvLayer
from repro_torch.kernels import _build
from repro_torch.launch.cnn_serve import CNNServer, ImageRequest
from repro_torch.perfmodel import (calibrate, card_conv_measure,
                                   hardware_id)
from repro_torch.serve.plan_cache import pad_to_bucket

PROBS_ATOL = 1e-5


@pytest.fixture
def card():
    reason = _build.toolchain_missing()
    if reason:
        pytest.skip(reason)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("layer", [
    ConvLayer("CAL", 64, 384, 13, 3, 1, 1, "cal"),
    ConvLayer("CAL", 16, 384, 13, 3, 256, 1, "cal"),
    ConvLayer("CAL", 512, 384, 13, 3, 512, 1, "cal"),
    ConvLayer("T", 3, 20, 11, 5, 7, 2, "t")], ids=str)
def test_card_measure_times_k1_and_k2(layer, card):
    measure = card_conv_measure()
    for layout, kern in (("CHWN", "conv_chwn"), ("NCHW", "conv_nchw")):
        K.reset_launch_counts()
        t = measure(layer, layout)
        assert math.isfinite(t) and t > 0, (layout, t)
        counts = K.launch_counts()
        assert counts[kern] >= 2 and sum(counts.values()) == counts[kern]
    proxied = card_conv_measure(proxy_hw=8, proxy_co=32, reps=2)
    assert proxied(layer, "NCHW") > 0


def test_card_calibration_gives_thresholds_on_the_sweep(card):
    th = calibrate(measure=card_conv_measure(), dtype_bytes=4)
    assert th.Ct in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
    assert th.Nt in (16, 32, 64, 128, 256, 512, 1 << 30)
    assert hardware_id() == torch.cuda.get_device_name(0)


def test_default_server_plans_and_serves_on_the_card(card):
    srv = CNNServer()
    assert srv.cfg.name == "lenet" and srv.device.type == "cuda"
    rng = np.random.default_rng(0)
    c, h = srv.cfg.in_channels, srv.cfg.image_hw
    images = [rng.standard_normal((c, h, h), np.float32) for _ in range(70)]
    K.reset_launch_counts()
    done = srv.run([ImageRequest(i, im) for i, im in enumerate(images)])
    counts = K.launch_counts()
    assert srv.cache.planner_calls == 2            # buckets 64 and 8
    assert counts["softmax"] == 2 and (counts["conv_chwn"]
                                       + counts["conv_nchw"]) == 4
    params = srv.model.params()
    start = 0
    for B in (64, 6):
        bucket = srv.cache.bucket(B)
        plan = srv.cache.peek_fused(srv.cfg, bucket)
        x = torch.from_numpy(np.stack(images[start:start + B])).to(card)
        with torch.inference_mode():
            y, _ = forward_fused(params, pad_to_bucket(x, bucket), srv.cfg,
                                 plan, impl="torch")
        got = np.stack([done[i] for i in range(start, start + B)])
        assert np.abs(got - y[:B].cpu().numpy()).max() <= PROBS_ATOL
        start += B
    lines = srv.report_lines()
    assert "planner_calls=2" in lines[0]
    assert f"hw={torch.cuda.get_device_name(0)}" in lines[0]
