"""The port's LM serving path against the reference's: configs, accounting,
the KV-layout selector, the step factories and the server.

* ``ParallelConfig``'s repr equals the reference's letter for letter;
* ``param_count`` (all, active, without embeddings; the config methods)
  and ``model_flops`` equal the reference's for the ten architectures at
  their published widths and reduced;
* ``select_kv_layout`` on ``reference_hardware()`` picks what the
  reference picks over a grid of (batch, kv heads, seq, head dim, element
  size);
* the port's ``Server`` on the reference server's own weights (carried by
  ``models.convert``) returns the reference server's tokens for the
  requests of ``tests/test_system.py`` (yi-9b, phi3-mini; rwkv6 and dbrx
  on the same kind of requests; bf16, so tokens, not logits, are
  compared);
* the server's kept logits follow one teacher-forced forward in float32
  (rtol / atol 1e-4) in both KV layouts, as the card's smoke holds them
  at full width; the step factories read ``window_kv_cache``;
  ``init_cache`` has the reference's shapes;
* the expert-parallel MoE raises and names itself; no model tree is built
  without a device named; a server with no CUDA device and no
  device given raises; the server's KV layout comes from its constructor
  or from ``run``; ``main`` serves on the CPU when asked.
"""
from __future__ import annotations

import functools
import sys

import jax
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.launch import serve as ref_serve
from repro.models import registry as ref_registry
from repro.perfmodel import select_kv_layout as ref_select_kv_layout

import repro_torch.configs as configs
from repro_torch.launch import serve
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_reference, unstack
from repro_torch.perfmodel import reference_hardware, select_kv_layout
from repro_torch.train.steps import make_decode_step, make_prefill_step

ARCHS = list(configs.ARCH_IDS)


def _both(arch, reduced):
    ref, port = ref_configs.get_config(arch), configs.get_config(arch)
    if reduced:
        ref = ref_configs.reduced_config(ref)
        port = configs.reduced_config(port)
    return ref, port


@pytest.mark.parametrize("kw", [
    {}, {"fsdp": False, "seq_shard_saved": False},
    {"window_kv_cache": True, "kv_cache_layout": "sbkd", "microbatches": 4,
     "accum_dtype": "bfloat16", "grad_compression": "int8"}])
def test_parallel_config_repr_matches_reference(kw):
    assert repr(configs.ParallelConfig(**kw)) == \
        repr(ref_configs.ParallelConfig(**kw))


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_matches_reference(arch, reduced):
    ref, port = _both(arch, reduced)
    for kw in ({}, {"active_only": True}, {"include_embed": False}):
        assert registry.param_count(port, **kw) == \
            ref_registry.param_count(ref, **kw), kw
    assert port.param_count() == registry.param_count(port)
    assert port.active_param_count() == registry.param_count(
        port, active_only=True)


def test_qwen2_7b_has_its_published_size():
    assert configs.get_config("qwen2_7b").param_count() == 7_615_616_512


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_match_reference(arch, monkeypatch):
    # each shape's flops count the same parameters: count them once
    for mod in (registry, ref_registry):
        monkeypatch.setattr(mod, "param_count",
                            functools.lru_cache(maxsize=None)(
                                mod.param_count))
    ref, port = _both(arch, False)
    for shape in configs.shapes_for(port):
        assert registry.model_flops(port, shape) == \
            ref_registry.model_flops(ref, shape)


def test_expert_parallel_moe_raises_naming_itself():
    """One card serves MoE through the local dispatch; the reference's
    all-to-all over a mesh (``moe_fwd_a2a``) is not ported."""
    from repro_torch.models import layers as L
    cfg = configs.reduced_config(configs.get_config("dbrx_132b"))
    with pytest.raises(NotImplementedError, match="moe_fwd_a2a"):
        L.moe_fwd_a2a({}, torch.zeros((1, 2, cfg.d_model)), cfg, None)


@pytest.mark.parametrize("dtype_bytes", [2, 4])
@pytest.mark.parametrize("head_dim", [16, 64, 96, 128, 256])
def test_select_kv_layout_matches_reference(head_dim, dtype_bytes):
    hw = reference_hardware()
    picks = set()
    for batch in (1, 2, 4, 8, 32, 128):
        for kv_heads in (1, 4, 8, 32):
            for seq in (7, 128, 256, 4096, 32768):
                for spr in (1.0, 0.25):
                    want = ref_select_kv_layout(batch, kv_heads, seq,
                                                head_dim, spr, dtype_bytes)
                    got = select_kv_layout(batch, kv_heads, seq, head_dim,
                                           spr, dtype_bytes, hw=hw)
                    assert got == want, (batch, kv_heads, seq)
                    picks.add(got)
    assert picks == {"bksd", "sbkd"}


def test_select_kv_layout_on_the_h100_profile():
    # qwen2-7b's cache at the smoke's batch: a decode write of one row of
    # 4 x 4 x 128 bf16 fills whole granule tiles in sbkd
    assert select_kv_layout(4, 4, 256, 128) == "sbkd"
    # one head of 8: bksd reads whole granules, sbkd pads its row
    assert select_kv_layout(1, 1, 4096, 8, 8.0) == "bksd"


def _requests(lens, max_new=4, vocab=256):
    return [serve.Request(i, np.random.default_rng(i).integers(
                0, vocab, size=(n,), dtype=np.int32), max_new=max_new)
            for i, n in enumerate(lens)]


def _ref_requests(lens, max_new=4, vocab=256):
    return [ref_serve.Request(r.rid, r.prompt, r.max_new)
            for r in _requests(lens, max_new, vocab)]


@pytest.mark.parametrize("arch,batch,max_len,lens", [
    ("yi_9b", 2, 64, (6, 6)),            # tests/test_system.py's requests
    ("phi3_mini_3p8b", 1, 32, (5,)),
    ("yi_9b", 2, 64, (9, 4)),            # left-padded
    ("rwkv6_7b", 2, 64, (6, 6)),
    ("dbrx_132b", 2, 64, (9, 4))])
def test_server_returns_the_reference_servers_tokens(arch, batch, max_len,
                                                     lens):
    ref_srv = ref_serve.Server(arch, reduced=True, batch=batch,
                               max_len=max_len)
    want = ref_srv.run(_ref_requests(lens))
    srv = serve.Server(arch, reduced=True, batch=batch, max_len=max_len,
                       device="cpu")
    srv.params = params_from_reference(
        jax.tree.map(np.asarray, ref_srv.params), "cpu")
    got = srv.run(_requests(lens))
    assert got == want
    assert all(len(v) == 4 for v in got.values())
    assert srv.kv_layout in ("bksd", "sbkd")
    again = srv.run(_requests(lens))                 # greedy: deterministic
    assert again == got


@pytest.mark.parametrize("arch", ARCHS)
def test_server_logits_follow_the_teacher_forced_forward(arch):
    """What the card's smoke holds at full width, here reduced and in
    float32: each kept step's logits against one forward over the padded
    prompt and the generated tokens, in both KV layouts."""
    srv = serve.Server(arch, batch=3, max_len=48, device="cpu",
                       dtype="float32")
    runs = {}
    for layout in ("bksd", "sbkd"):
        out = srv.run(_requests((7, 3, 11), max_new=5), keep_logits=True,
                      kv_layout=layout)
        runs[layout] = (out, [lg.clone() for lg in srv.logits])
    (out, logits), (out2, logits2) = runs["bksd"], runs["sbkd"]
    assert out == out2 and len(logits) == 6
    S0, front = 11, srv.front
    prompts = np.concatenate([srv.pad(_requests((7, 3, 11))),
                              np.array([out[i] for i in range(3)],
                                       np.int32)], axis=1)
    with torch.inference_mode():
        tok = torch.from_numpy(prompts)
        pos = torch.arange(tok.shape[1])[None].expand(3, -1)
        h, _ = T.forward(srv.params, tok, pos, srv.cfg, **srv.stubs(3))
        full = T.logits_fwd(srv.params, h, srv.cfg)
    for t, (a, b) in enumerate(zip(logits, logits2)):
        want = full[:, front + S0 - 1 + t]
        torch.testing.assert_close(a, want, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(b, want, rtol=1e-4, atol=1e-4)


def test_step_factories_read_window_kv_cache():
    """gemma2's local layers cache only the window when the parallel
    config says so; the decode step then reads the ring buffer."""
    cfg = configs.reduced_config(configs.get_config("gemma2_27b"))
    params = T.init_params(cfg, seed=1, device="cpu")
    shape = configs.ShapeConfig("s", "prefill", 32, 2)
    tok = torch.randint(0, cfg.vocab_size, (2, 12),
                        generator=torch.Generator().manual_seed(0))
    for window in (False, True):
        par = configs.ParallelConfig(window_kv_cache=window)
        logits, cache = make_prefill_step(cfg, par, shape, "sbkd")(
            params, {"tokens": tok})
        assert cache[0]["b0"]["k"].shape[0] == (8 if window else 32)
        assert cache[0]["b1"]["k"].shape[0] == 32
        decode = make_decode_step(cfg, par, "sbkd")
        step_logits, cache = decode(params, cache, tok[:, -1:], 12)
        with torch.inference_mode():
            _, ref_cache, _ = T.prefill(params, tok, cfg, 32,
                                        kv_layout="sbkd", kv_window=window)
            want, _ = T.decode_step(params, ref_cache, tok[:, -1:], 12, cfg,
                                    kv_layout="sbkd", kv_window=window)
        torch.testing.assert_close(step_logits, want, rtol=0, atol=0)


@pytest.mark.parametrize("window", [False, True])
@pytest.mark.parametrize("layout", ["bksd", "sbkd"])
def test_init_cache_matches_the_references_shapes(layout, window):
    """Per period, the reference's stacked cache's shapes and dtype; with
    ``kv_window`` gemma2's local layers hold only the window."""
    from repro.models import transformer as ref_T
    ref_cfg, cfg = _both("gemma2_27b", True)
    want = ref_T.init_cache(ref_cfg, 3, 20, layout, kv_window=window)
    got = T.init_cache(cfg, 3, 20, layout, kv_window=window,
                       device="cpu")
    assert len(got) == cfg.num_periods
    for period in got:
        for b, kv in want.items():
            for n, arr in kv.items():
                assert tuple(period[b][n].shape) == arr.shape[1:]
                assert period[b][n].dtype == torch.bfloat16
                assert not period[b][n].any()


@pytest.mark.parametrize("build", [
    lambda cfg: T.init_params(cfg),
    lambda cfg: T.init_cache(cfg, 2, 16),
    lambda cfg: params_from_reference({"embed": {"table": np.zeros((2, 2))}}),
    lambda cfg: unstack({"k": np.zeros((2, 3))})],
    ids=["init_params", "init_cache", "params_from_reference", "unstack"])
def test_model_trees_are_built_only_on_a_device_named(build):
    """No model tree lands on the CPU by default: the caller names the
    device (the server names the card unless asked for the CPU)."""
    cfg = configs.reduced_config(configs.get_config("qwen2_7b"))
    with pytest.raises(TypeError, match="device"):
        build(cfg)


def test_server_takes_its_kv_layout_from_the_constructor_or_the_run():
    srv = serve.Server("qwen2_7b", batch=2, max_len=32, device="cpu",
                       kv_layout="sbkd", dtype="float32")
    want = srv.run(_requests((5, 3), max_new=3))
    assert srv.kv_layout == "sbkd"
    got = srv.run(_requests((5, 3), max_new=3), kv_layout="bksd")
    assert srv.kv_layout == "bksd" and got == want
    srv.run(_requests((5, 3), max_new=3))
    assert srv.kv_layout == "sbkd"
    assert srv.pad(_requests((5, 3))).tolist()[1][:2] == [0, 0]


def test_server_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.Server("qwen2_7b")


def test_main_serves_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "whisper_base",
                                      "--requests", "2", "--device", "cpu"])
    serve.main()
    out = capsys.readouterr().out
    assert "device=cpu" in out and "generated 16 tokens" in out
