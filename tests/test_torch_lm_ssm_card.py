"""The LM server on the card for the four recurrent and MoE architectures
(rwkv6, dbrx, llama4, jamba), reduced, served through
``launch/serve.Server`` on the CUDA device, and every step's logits
(prefill's, then each decode step's) held against one teacher-forced
``forward`` over the left-padded prompts and the generated tokens: in
both KV layouts where the model holds a KV cache (rwkv6 holds none: one
layout), in float32 within 1e-4 (rtol and atol) and in bf16 within the
reference's decode tolerance (atol 0.15 / rtol 0.05).  An MoE model is
served at its published capacity (tokens in [0, V), prefill against a
forward over the prompts alone: the same token count, so the same
capacity), then at the drop-free capacity factor E/k (cap = T: prefill,
decode and the forward drop no token) through the server's own prefill
and decode steps (``chip_smoke.lm_nodrop_run``): the generated tokens fed
back with every MoE layer dispatching as the forward did, and every
step held.  In bf16 decode and the forward round hidden states
differently, so a layer's own choice may leave the forward's, but only
where the forward's router margin (k-th minus (k+1)-th probability) is
under 1e-2; float32 allows none.  No kernel of the port launches.

Then the full-width mixers alone, bf16, on seeded weights: jamba's Mamba
mixer (d_inner 16384), ``mamba_fwd`` over a prompt and ``mamba_decode``
steps against ``mamba_fwd`` over the whole sequence, and rwkv6's WKV
scan against its chunk-parallel form within the reference's 5e-3.

Every test needs a CUDA device and skips with the reason where there is
none (the path is plain torch: no kernel to build).  No jax, no reference
package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_lm_ssm_card.py

(from the repository's root: the drop-free run is ``chip_smoke.py``'s).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch import kernels as K
from repro_torch.configs import get_config
from repro_torch.launch.serve import Request, Server
from repro_torch.models import mamba as M
from repro_torch.models import rwkv as R
from repro_torch.models import transformer as T

RUNS = [("rwkv6_7b", "bksd"), ("dbrx_132b", "bksd"), ("dbrx_132b", "sbkd"),
        ("llama4_maverick_400b", "bksd"), ("llama4_maverick_400b", "sbkd"),
        ("jamba_1p5_large_398b", "bksd"), ("jamba_1p5_large_398b", "sbkd")]
LENS = (5, 9, 12, 7)
MAX_NEW = 6
TOL = {"bfloat16": dict(rtol=0.05, atol=0.15),
       "float32": dict(rtol=1e-4, atol=1e-4)}
ROUTE_MARGIN = 1e-2


@pytest.fixture
def card():
    """The CUDA device, with TF32 and bf16 reduced-precision reductions off
    for the test and restored after it."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    mm, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (mm.allow_tf32, cudnn.allow_tf32,
             mm.allow_bf16_reduced_precision_reduction)
    mm.allow_tf32 = cudnn.allow_tf32 = False
    mm.allow_bf16_reduced_precision_reduction = False
    yield torch.device("cuda")
    (mm.allow_tf32, cudnn.allow_tf32,
     mm.allow_bf16_reduced_precision_reduction) = saved


def _requests():
    return [Request(i, np.random.default_rng(i).integers(
                0, 256, size=(n,), dtype=np.int32), max_new=MAX_NEW)
            for i, n in enumerate(LENS)]


def _forward_logits(srv, toks, cfg):
    B = toks.shape[0]
    with torch.inference_mode():
        tok = torch.from_numpy(toks).to(srv.device)
        pos = torch.arange(tok.shape[1], device=srv.device)[None].expand(
            B, -1)
        h, _ = T.forward(srv.params, tok, pos, cfg)
        return T.logits_fwd(srv.params, h, cfg)


def _serve_and_hold(srv, layout):
    """The server's run in ``layout``, its tokens in [0, V); without MoE
    every step's logits against the forward's, with MoE prefill's against
    a forward over the prompts alone, then the drop-free run's every
    step.  Returns the served tokens."""
    K.reset_launch_counts()
    cfg = srv.cfg
    out = srv.run(_requests(), keep_logits=True, kv_layout=layout)
    B, S0 = len(LENS), max(LENS)
    for i in range(B):
        assert len(out[i]) == MAX_NEW
        assert all(0 <= t < cfg.vocab_size for t in out[i])
    prompts = srv.pad(_requests())
    assert len(srv.logits) == MAX_NEW + 1
    for got in srv.logits:
        assert got.is_cuda and bool(torch.isfinite(got).all())
    if cfg.num_experts:
        want = _forward_logits(srv, prompts, cfg)
        torch.testing.assert_close(srv.logits[0], want[:, S0 - 1],
                                   **TOL[cfg.dtype])
        with torch.inference_mode():
            run = chip_smoke.lm_nodrop_run(srv, _requests(), layout)
        assert run["cap"] == run["tokens"]
        if cfg.dtype == "float32":
            assert run["flips"] == 0, "float32 routing left the forward's"
        assert run["flip_margin"] < ROUTE_MARGIN, run["flip_margin"]
        torch.testing.assert_close(run["got"], run["want"], **TOL[cfg.dtype])
    else:
        toks = np.concatenate(
            [prompts, np.array([out[i] for i in range(B)], np.int32)], 1)
        want = _forward_logits(srv, toks, cfg)
        for t, got in enumerate(srv.logits):
            torch.testing.assert_close(got, want[:, srv.front + S0 - 1 + t],
                                       **TOL[cfg.dtype])
    torch.cuda.synchronize()
    # the path is plain torch: none of the port's kernels launched
    assert not any(K.launch_counts().values())
    return out


@pytest.mark.parametrize("arch,layout", RUNS)
def test_bf16_decode_follows_the_forward(card, arch, layout):
    srv = Server(arch, batch=len(LENS), max_len=128)
    assert srv.params["embed"]["table"].is_cuda
    _serve_and_hold(srv, layout)
    assert srv.kv_layout == layout


@pytest.mark.parametrize("arch", sorted({a for a, _ in RUNS}))
def test_float32_decode_follows_the_forward(card, arch):
    srv = Server(arch, batch=len(LENS), max_len=128, dtype="float32")
    outs = [_serve_and_hold(srv, layout)
            for layout in sorted({lay for a, lay in RUNS if a == arch})]
    assert all(o == outs[0] for o in outs)


def test_full_width_mamba_mixer_decodes_as_it_prefills(card):
    cfg = get_config("jamba_1p5_large_398b")
    gen = torch.Generator(device=card).manual_seed(0)
    with torch.inference_mode():
        p = M.init_mamba(gen, cfg, card)
        x = torch.randn((2, 40, cfg.d_model), generator=gen,
                        device=card).to(torch.bfloat16)
        whole, st_whole = M.mamba_fwd(p, x, cfg, return_state=True)
        y, st = M.mamba_fwd(p, x[:, :32], cfg, return_state=True)
        ys = [y]
        for t in range(32, 40):
            y, st = M.mamba_decode(p, x[:, t:t + 1], st, cfg)
            ys.append(y)
    got = torch.cat(ys, dim=1)
    assert got.is_cuda and bool(torch.isfinite(got.float()).all())
    torch.testing.assert_close(got.float(), whole.float(),
                               **TOL["bfloat16"])
    err = (st["ssm"] - st_whole["ssm"]).abs().max()
    assert err <= TOL["bfloat16"]["rtol"] * st_whole["ssm"].abs().max()


def test_full_width_wkv_scan_matches_the_chunked_form(card):
    cfg = get_config("rwkv6_7b")
    gen = torch.Generator(device=card).manual_seed(0)
    with torch.inference_mode():
        p = R.init_rwkv_time(gen, cfg, card)
        H, N = R._heads(cfg)
        u = torch.randn((H, N), generator=gen, device=card) * 0.1
        x = torch.randn((2, 48, cfg.d_model), generator=gen,
                        device=card).to(torch.bfloat16)
        r, k, v, w, _ = R._time_inputs(p, x, cfg)
        s0 = torch.zeros((2, H, N, N), device=card)
        y1, s1 = R._wkv_scan(r, k, v, w, u, s0, 16)
        y2, s2 = R._wkv_chunked_parallel(r, k, v, w, u, s0, 16)
    torch.testing.assert_close(y2, y1, rtol=5e-3, atol=5e-3)
    torch.testing.assert_close(s2, s1, rtol=5e-3, atol=5e-3)
