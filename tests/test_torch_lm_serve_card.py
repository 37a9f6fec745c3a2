"""The LM server on the card: each of the six ported architectures,
reduced, served through ``launch/serve.Server`` on the CUDA device, and
every step's logits (prefill's, then each decode step's) held against one
teacher-forced ``forward`` over the left-padded prompts and the generated
tokens, in both KV layouts: bf16 within the reference's decode tolerance
(atol 0.15 / rtol 0.05, ``tests/test_models.py``), float32 within 1e-4
(rtol and atol).  ``layers.f32_matmul``'s bf16 products with float32
results and the product of their float32 copies are both held within
1e-5 of float64, scale-relative (the same exact products, summed in
float32 in other orders).  TF32 and bf16
reduced-precision reductions are off.

Every test needs a CUDA device and skips with the reason where there is
none (the path is plain torch: no kernel to build).  No jax, no reference
package:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_lm_serve_card.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.launch.serve import Request, Server
from repro_torch.models import transformer as T

ARCHS = ["qwen2_7b", "yi_9b", "phi3_mini_3p8b", "gemma2_27b",
         "phi3_vision_4p2b", "whisper_base"]
LENS = (5, 9, 12, 7)
MAX_NEW = 6
TOL = {"bfloat16": dict(rtol=0.05, atol=0.15),
       "float32": dict(rtol=1e-4, atol=1e-4)}


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


def _serve_and_hold(srv, kv_layout=None):
    out = srv.run(_requests(), keep_logits=True, kv_layout=kv_layout)
    S0, front = max(LENS), srv.front
    for i in range(len(LENS)):
        assert len(out[i]) == MAX_NEW
        assert all(0 <= t < srv.cfg.vocab_size for t in out[i])
    toks = np.concatenate([srv.pad(_requests()),
                           np.array([out[i] for i in range(len(LENS))],
                                    np.int32)], axis=1)
    with torch.inference_mode():
        tok = torch.from_numpy(toks).to(srv.device)
        pos = torch.arange(tok.shape[1], device=srv.device)[None].expand(
            len(LENS), -1)
        h, _ = T.forward(srv.params, tok, pos, srv.cfg,
                         **srv.stubs(len(LENS)))
        want = T.logits_fwd(srv.params, h, srv.cfg)
    assert len(srv.logits) == MAX_NEW + 1
    for t, got in enumerate(srv.logits):
        assert got.is_cuda and bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want[:, front + S0 - 1 + t],
                                   **TOL[srv.cfg.dtype])
    return out


@pytest.mark.parametrize("case", ["head", "bksd", "sbkd", "prefill"])
def test_f32_matmul_reads_bf16_operands_as_they_lie(card, case):
    """``layers.f32_matmul`` on bf16 operands (one cuBLAS product with
    float32 results) against the product of their float32 copies, on the
    views the server hands it: the unembedding table transposed, each
    cache layout as [B, K, Dh, S] and prefill's grouped queries."""
    from repro_torch.models.layers import f32_matmul
    gen = torch.Generator(device=card).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, device=card, generator=gen).bfloat16()

    B, K, G, Dh, S = 4, 4, 7, 128, 256
    if case == "head":
        a, b = rnd(B, 1, 3584), rnd(152064 // 8, 3584).T
    elif case == "bksd":
        a, b = rnd(B, K, G, Dh), rnd(B, K, S, Dh).transpose(2, 3)
    elif case == "sbkd":
        a, b = rnd(B, K, G, Dh), rnd(S, B, K, Dh).permute(1, 2, 3, 0)
    else:
        a, b = rnd(B, K, G * 96, Dh), rnd(B, 96, K, Dh).permute(0, 2, 3, 1)
    got = f32_matmul(a, b)
    assert got.dtype == torch.float32 and got.shape == (a @ b).shape
    want = a.double() @ b.double()

    def err(x):                      # scale-relative, from float64
        return ((x.double() - want).abs().max() / want.abs().max()).item()

    # the same exact products as the float32 copies', summed in float32 in
    # another order: both lie within float32 sums' reach of float64 (a
    # bf16-rounded result would lie ~4e-3 away)
    assert err(got) <= 1e-5 and err(a.float() @ b.float()) <= 1e-5


def test_server_lands_on_the_card(card):
    srv = Server("qwen2_7b")
    assert srv.device.type == "cuda"
    assert srv.params["embed"]["table"].is_cuda
    assert srv.params["blocks"][0]["b0"]["attn"]["wq"].is_cuda


@pytest.mark.parametrize("layout", ["bksd", "sbkd"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_decode_follows_the_forward(card, arch, layout):
    srv = Server(arch, batch=len(LENS), max_len=128, kv_layout=layout)
    K.reset_launch_counts()
    _serve_and_hold(srv)
    torch.cuda.synchronize()
    assert srv.kv_layout == layout
    # the path is plain torch: none of the port's kernels launched
    assert not any(K.launch_counts().values())


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_decode_follows_the_forward(card, arch):
    srv = Server(arch, batch=len(LENS), max_len=128, dtype="float32")
    outs = []
    for layout in ("bksd", "sbkd"):
        outs.append(_serve_and_hold(srv, layout))
    assert outs[0] == outs[1]
