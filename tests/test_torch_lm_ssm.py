"""The port's Mamba mixer and RWKV-6 block against the reference's: each
function alone, and the two recurrent architectures (jamba: Mamba, MoE
and attention blocks in one period of 8; rwkv6: RWKV blocks, no KV
cache), on the reference's weights.

Module level, on seeded numpy inputs and the reference's seeded
parameters through both packages, at the reduced widths (d_model 64,
d_state 8, RWKV heads of 16): ``_causal_conv`` (with and without the
carried context), ``mamba_fwd`` with its returned state, from zeros and
from a carried state, whole and in chunks of 8, ``mamba_decode``,
``_wkv_scan``, ``_wkv_chunked_parallel``, ``_group_norm``, and the time
and channel mixes with their states (``rwkv_chunked`` on and off); the
deterministic leaves of the inits, ``dt_rank`` and the states' shapes.
The chunk-parallel WKV also against the port's own scan, within the
reference's 5e-3 (``tests/test_perf_features.py``).  Lengths the
reference asserts against raise ``ValueError``.

Model level, jamba as ``reduced_config(cfg, 1)`` (the reference marks its
2-period decode test slow, ``tests/test_models.py:85``) and rwkv6 at 2
periods: the helpers of ``tests/test_torch_lm_models.py`` hold the
forward (hidden states, balance loss), prefill (logits and the hybrid
cache list: KV caches and recurrent states, both layouts), 4 decode
steps and greedy decoding.  jamba in bf16 holds its hidden states and
caches block by block (``_blockwise``: each block of both packages fed
the reference's input to it), its logits end to end.

Tolerances: float32 rtol / atol 1e-4; bf16 the reference's decode
tolerance, atol 0.15 / rtol 0.05.  jamba's MoE blocks follow the
routing-margin rule of ``tests/test_torch_lm_moe.py``: the port's layers
dispatch to the reference's experts, and in bf16 their own choice may
differ only where the reference's k-th and (k+1)-th router probabilities
lie within 1e-2; in float32 every choice is identical.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as ref_M
from repro.models import rwkv as ref_R
from repro.models import transformer as ref_T

from repro_torch.models import mamba as M
from repro_torch.models import rwkv as R
from repro_torch.models import transformer as T
from repro_torch.models.convert import tensor_from_numpy
from tests.test_torch_lm_models import (B, CPU, DTYPES, LAYOUTS, MAX_LEN,
                                        N_PROMPT, S, TOL, _cfgs, _close,
                                        _close_caches, _flips, _inputs,
                                        _port, _port_recording,
                                        _ref_recording, _reference,
                                        check_decode, check_forward,
                                        check_greedy, check_meta_device,
                                        check_prefill)

ARCHS = ["rwkv6_7b", "jamba_1p5_large_398b"]
# rwkv6 holds no KV cache: one layout
RUNS = [("rwkv6_7b", "bksd"), ("jamba_1p5_large_398b", "bksd"),
        ("jamba_1p5_large_398b", "sbkd")]
NB, NS = 2, 32
JAMBA = "jamba_1p5_large_398b"
# one block of the reference, compiled once a kind, mode and shape (run
# only inside ``_ref_recording``, which its MoE layers report to)
_ref_block = jax.jit(ref_T._block_fwd, static_argnames=(
    "kind", "cfg", "mode", "kv_layout", "max_len"))
WKV_TOL = dict(rtol=5e-3, atol=5e-3)       # tests/test_perf_features.py


def _t(a):
    return tensor_from_numpy(np.asarray(a), CPU)


def _rand(seed, shape, dtype, scale=1.0):
    """Seeded normal values as (jax array, tensor), bit for bit."""
    a = jnp.asarray(np.random.default_rng(seed).standard_normal(shape)
                    * scale, dtype)
    return a, _t(a)


@functools.lru_cache(maxsize=None)
def _mamba(dtype):
    ref_cfg, cfg = _cfgs("jamba_1p5_large_398b", dtype)
    p = ref_M.init_mamba(jax.random.PRNGKey(3), ref_cfg)
    return ref_cfg, cfg, p, jax.tree.map(_t, p)


@functools.lru_cache(maxsize=None)
def _rwkv(dtype, chunked=False):
    ref_cfg, cfg = _cfgs("rwkv6_7b", dtype)
    ref_cfg = ref_cfg.replace(rwkv_chunked=chunked)
    cfg = cfg.replace(rwkv_chunked=chunked)
    pt_ = ref_R.init_rwkv_time(jax.random.PRNGKey(4), ref_cfg)
    pc_ = ref_R.init_rwkv_channel(jax.random.PRNGKey(5), ref_cfg)
    # the zero-initialised mixes and bonus made nonzero, so that they count
    rng = np.random.default_rng(6)
    for k in ("mu_x", "mu_rkvwg", "u"):
        pt_[k] = jnp.asarray(rng.uniform(-0.5, 0.5, pt_[k].shape),
                             jnp.float32)
    for k in ("mu_k", "mu_r"):
        pc_[k] = jnp.asarray(rng.uniform(-0.5, 0.5, pc_[k].shape),
                             jnp.float32)
    return (ref_cfg, cfg, pt_, jax.tree.map(_t, pt_), pc_,
            jax.tree.map(_t, pc_))


def test_dt_rank_and_deterministic_leaves_match_reference():
    for dtype in DTYPES:
        ref_cfg, cfg, p, _ = _mamba(dtype)
        assert M.dt_rank(cfg) == ref_M.dt_rank(ref_cfg)
        got = M.init_mamba(torch.Generator().manual_seed(0), cfg, CPU)
        assert got.keys() == p.keys()
        for k in p:
            assert tuple(got[k].shape) == p[k].shape, k
            assert str(got[k].dtype).split(".")[1] == str(p[k].dtype), k
        for k in ("D", "dt_proj_b", "conv_b"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(p[k]))
        # to the ulp: XLA's float32 log(7) lies one ulp below the
        # correctly rounded value, which torch's log returns
        np.testing.assert_array_max_ulp(got["A_log"].numpy(),
                                        np.asarray(p["A_log"]), maxulp=1)
    _, cfg, _, _, _, _ = _rwkv("bfloat16")
    ref_cfg = _cfgs("rwkv6_7b", "bfloat16")[0]
    gen = torch.Generator().manual_seed(0)
    for got, want in ((R.init_rwkv_time(gen, cfg, CPU),
                       ref_R.init_rwkv_time(jax.random.PRNGKey(0), ref_cfg)),
                      (R.init_rwkv_channel(gen, cfg, CPU),
                       ref_R.init_rwkv_channel(jax.random.PRNGKey(0),
                                               ref_cfg))):
        assert got.keys() == want.keys()
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).split(".")[1] == str(want[k].dtype), k
            if k.startswith(("mu", "ln", "w0", "u")):
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_the_references_shapes(arch):
    """The hybrid cache list: per period, the reference's stacked leaves'
    shapes and dtypes (KV caches and Mamba/RWKV states), all zeros."""
    ref_cfg, cfg = _cfgs(arch, "bfloat16")
    for layout in LAYOUTS:
        want = ref_T.init_cache(ref_cfg, 3, 20, layout)
        got = T.init_cache(cfg, 3, 20, layout, device=CPU)
        assert len(got) == cfg.num_periods
        for period in got:
            assert period.keys() == want.keys()
            for b, leaves in want.items():
                assert period[b].keys() == leaves.keys()
                for n, arr in leaves.items():
                    t = period[b][n]
                    assert tuple(t.shape) == arr.shape[1:], (b, n)
                    assert str(t.dtype).split(".")[1] == str(arr.dtype)
                    assert not t.any()


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    _, cfg, p, pt = _mamba("float32")
    dI, dC = cfg.mamba_d_inner, cfg.mamba_d_conv
    u, ut = _rand(10, (NB, 7, dI), jnp.float32)
    st, stt = (_rand(11, (NB, dC - 1, dI), jnp.bfloat16) if with_state
               else (None, None))
    y, s = ref_M._causal_conv(u, p["conv_w"], p["conv_b"], st)
    yt, s_t = M._causal_conv(ut, pt["conv_w"], pt["conv_b"], stt)
    _close(yt, y, "float32", "y")
    _close(s_t, s, "float32", "state")


@pytest.mark.parametrize("chunk", [256, 8])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_fwd_and_state_match_reference(dtype, carried, chunk):
    ref_cfg, cfg, p, pt = _mamba(dtype)
    dt = jnp.dtype(ref_cfg.dtype)
    x, xt = _rand(12, (NB, NS, cfg.d_model), dt)
    st = stt = None
    if carried:
        c = _rand(13, (NB, cfg.mamba_d_conv - 1, cfg.mamba_d_inner), dt)
        h = _rand(14, (NB, cfg.mamba_d_inner, cfg.mamba_d_state),
                  jnp.float32, 0.5)
        st, stt = {"conv": c[0], "ssm": h[0]}, {"conv": c[1], "ssm": h[1]}
    y, s = ref_M.mamba_fwd(p, x, ref_cfg, chunk=chunk, state=st,
                           return_state=True)
    yt, s_t = M.mamba_fwd(pt, xt, cfg, chunk=chunk, state=stt,
                          return_state=True)
    assert yt.dtype == xt.dtype and s_t["ssm"].dtype == torch.float32
    assert s_t["conv"].dtype == xt.dtype
    _close(yt, y, dtype, "y")
    for n in ("conv", "ssm"):
        _close(s_t[n], s[n], dtype, n)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_decode_matches_reference(dtype):
    """Four steps from a prompt's state, each against the reference's."""
    ref_cfg, cfg, p, pt = _mamba(dtype)
    dt = jnp.dtype(ref_cfg.dtype)
    x, xt = _rand(15, (NB, 12, cfg.d_model), dt)
    _, st = ref_M.mamba_fwd(p, x[:, :8], ref_cfg, return_state=True)
    _, stt = M.mamba_fwd(pt, xt[:, :8], cfg, return_state=True)
    for t in range(8, 12):
        y, st = ref_M.mamba_decode(p, x[:, t:t + 1], st, ref_cfg)
        yt, stt = M.mamba_decode(pt, xt[:, t:t + 1], stt, cfg)
        _close(yt, y, dtype, f"step {t}")
        for n in ("conv", "ssm"):
            _close(stt[n], st[n], dtype, f"step {t} {n}")


def test_mamba_scan_refuses_what_the_reference_asserts_against():
    _, cfg, _, pt = _mamba("float32")
    x = torch.zeros((1, 9, cfg.d_model))
    M.mamba_fwd(pt, x, cfg, chunk=8)          # one chunk of 9: accepted
    with pytest.raises(ValueError, match="chunks"):
        M.mamba_fwd(pt, x, cfg, chunk=2)      # 4 chunks of 9


@functools.lru_cache(maxsize=None)
def _wkv_inputs(seed, S=NS, H=2, N=8):
    """The reference test's distributions (tests/test_perf_features.py)."""
    f32 = jnp.float32
    r = _rand(seed, (NB, S, H, N), f32)
    k = _rand(seed + 1, (NB, S, H, N), f32, 0.5)
    v = _rand(seed + 2, (NB, S, H, N), f32)
    g = np.random.default_rng(seed + 3).standard_normal((NB, S, H, N))
    w = jnp.exp(-jnp.exp(jnp.asarray(g, f32) * 0.5 - 2))
    u = _rand(seed + 4, (H, N), f32, 0.1)
    s0 = _rand(seed + 5, (NB, H, N, N), f32, 0.2)
    return r, k, v, (w, _t(w)), u, s0


@pytest.mark.parametrize("chunk", [4, 8, 16, 128])
@pytest.mark.parametrize("fn", ["_wkv_scan", "_wkv_chunked_parallel"])
def test_wkv_matches_reference(fn, chunk):
    args = _wkv_inputs(20)
    y, st = getattr(ref_R, fn)(*(a[0] for a in args), chunk=chunk)
    yt, stt = getattr(R, fn)(*(a[1] for a in args), chunk=chunk)
    _close(yt, y, "float32", "y")
    _close(stt, st, "float32", "state")


@pytest.mark.parametrize("seed,chunk", [(0, 4), (1, 8), (1234, 16)])
def test_wkv_chunked_parallel_matches_the_scan(seed, chunk):
    args = [a[1] for a in _wkv_inputs(seed)]
    y1, s1 = R._wkv_scan(*args, chunk=chunk)
    y2, s2 = R._wkv_chunked_parallel(*args, chunk=chunk)
    torch.testing.assert_close(y2, y1, **WKV_TOL)
    torch.testing.assert_close(s2, s1, **WKV_TOL)


def test_wkv_refuses_what_the_reference_asserts_against():
    args = [a[1] for a in _wkv_inputs(30, S=12)]
    R._wkv_scan(*args, chunk=8)                    # one chunk of 12
    with pytest.raises(ValueError, match="chunk"):
        R._wkv_chunked_parallel(*args, chunk=8)    # 8 does not divide 12
    args = [a[1] for a in _wkv_inputs(31, S=9)]
    with pytest.raises(ValueError, match="chunks"):
        R._wkv_scan(*args, chunk=4)                # 2 chunks of 9


def test_group_norm_matches_reference():
    _, _, p, pt, _, _ = _rwkv("float32")
    H, N = ref_R._heads(_cfgs("rwkv6_7b", "float32")[0])
    y, yt = _rand(40, (NB, NS, H, N), jnp.float32, 3.0)
    _close(R._group_norm(pt, yt, H, N), ref_R._group_norm(p, y, H, N),
           "float32")


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv_time_and_channel_mix_match_reference(dtype, carried, chunked):
    ref_cfg, cfg, p, pt, pc, pct = _rwkv(dtype, chunked)
    H, N = R._heads(cfg)
    dt = jnp.dtype(ref_cfg.dtype)
    x, xt = _rand(41, (NB, NS, cfg.d_model), dt)
    tm = tmt = cm = cmt = None
    if carried:
        sh, sht = _rand(42, (NB, 1, cfg.d_model), dt)
        wkv, wkvt = _rand(43, (NB, H, N, N), jnp.float32, 0.3)
        tm, tmt = {"shift": sh, "wkv": wkv}, {"shift": sht, "wkv": wkvt}
        csh, csht = _rand(44, (NB, 1, cfg.d_model), dt)
        cm, cmt = {"shift": csh}, {"shift": csht}
    y, st = ref_R.rwkv_time_fwd(p, x, ref_cfg, chunk=8, state=tm,
                                return_state=True)
    yt, stt = R.rwkv_time_fwd(pt, xt, cfg, chunk=8, state=tmt,
                              return_state=True)
    assert yt.dtype == xt.dtype and stt["wkv"].dtype == torch.float32
    assert stt["shift"].dtype == xt.dtype
    _close(yt, y, dtype, "time mix")
    _close(stt["wkv"], st["wkv"], dtype, "wkv")
    _close(stt["shift"], st["shift"], dtype, "shift")
    y, st = ref_R.rwkv_channel_fwd(pc, x, ref_cfg, state=cm,
                                   return_state=True)
    yt, stt = R.rwkv_channel_fwd(pct, xt, cfg, state=cmt, return_state=True)
    _close(yt, y, dtype, "channel mix")
    _close(stt["shift"], st["shift"], dtype, "channel shift")


@pytest.mark.parametrize("arch", ARCHS)
def test_every_tensor_follows_the_inputs_device(arch):
    check_meta_device(arch)


def _blockwise_bf16(arch, dtype):
    """jamba in bf16 is held block by block: its reduced model at random
    init amplifies a rounding through its 8 blocks, so far that the
    reference's own bf16 forward lies 4.43 times the decode tolerance
    from its float32 forward on the same weights (hidden states; the
    port's bf16 lies 1.54 from the reference's bf16, and its float32
    within 1e-4).  The logits still hold end to end."""
    return arch == JAMBA and dtype == "bfloat16"


def _block_routes(ref_fn, port_fn, dtype):
    """One block in both packages, the port's MoE dispatching as the
    reference's (``_flips`` judges the port's own choices)."""
    with _ref_recording() as rr:
        want = ref_fn()
        jax.effects_barrier()          # the routing callbacks have run
    ref_calls = rr.take()
    with _port_recording() as pr:
        pr.lead(ref_calls)
        got = port_fn()
        _flips(pr.take(), ref_calls, dtype)
    return got, want


@functools.lru_cache(maxsize=None)
def _blockwise(arch, dtype):
    """Each block of both packages fed the same input, the reference's
    teacher-forced input to that block (so no rounding compounds through
    depth): its forward output over the whole sequence and its balance
    loss; per layout its prefill cache over the first ``N_PROMPT``
    positions, then ``S - N_PROMPT`` decode steps, each fed that block's
    forward input at the position, with their outputs and the final
    cache.  A list over blocks of {what: (port, reference)}."""
    ref_cfg, cfg = _cfgs(arch, dtype)
    params = jax.tree.map(jnp.asarray, _reference(arch, dtype)["params"])
    port = _port(arch, dtype)["params"]
    _, _, tokens = _inputs(arch, dtype)
    x = ref_T.embed_tokens(params, jnp.asarray(tokens), ref_cfg)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    tpos = torch.from_numpy(np.array(pos))
    out = []
    for p_i, period in enumerate(port["blocks"]):
        for i, kind in enumerate(cfg.block_pattern):
            bp = jax.tree.map(lambda a: a[p_i], params["blocks"][f"b{i}"])
            tbp, xt = period[f"b{i}"], _t(x)
            res = {}
            (y, _, aux), (y_r, _, aux_r) = _block_routes(
                lambda: _ref_block(bp, kind=kind, x=x, positions=pos,
                                   cfg=ref_cfg, mode="train"),
                lambda: T._block_fwd(tbp, kind, xt, tpos, cfg, "train"),
                dtype)
            res["forward"], res["aux"] = (y, y_r), (aux, aux_r)
            for layout in (LAYOUTS if kind.startswith("attn") else
                           LAYOUTS[:1]):
                (_, c, _), (_, c_r, _) = _block_routes(
                    lambda: _ref_block(
                        bp, kind=kind, x=x[:, :N_PROMPT],
                        positions=pos[:, :N_PROMPT], cfg=ref_cfg,
                        mode="prefill", kv_layout=layout, max_len=MAX_LEN),
                    lambda: T._block_fwd(
                        tbp, kind, xt[:, :N_PROMPT], tpos[:, :N_PROMPT],
                        cfg, "prefill", kv_layout=layout, max_len=MAX_LEN),
                    dtype)
                # a "dus" decode writes the port's cache in place
                res[layout, "prefill_cache"] = (
                    {"b": {n: v.clone() for n, v in c.items()}}, {"b": c_r})
                steps = []
                for t in range(N_PROMPT, S):
                    (yd, c, _), (yd_r, c_r, _) = _block_routes(
                        lambda: _ref_block(
                            bp, kind=kind, x=x[:, t:t + 1], positions=None,
                            cfg=ref_cfg, mode="decode", cache=c_r,
                            cache_len=jnp.int32(t), kv_layout=layout),
                        lambda: T._block_fwd(
                            tbp, kind, xt[:, t:t + 1], None, cfg, "decode",
                            cache=c, cache_len=t, kv_layout=layout),
                        dtype)
                    steps.append((yd, yd_r))
                res[layout, "decode"] = steps
                res[layout, "decode_cache"] = ({"b": c}, {"b": c_r})
            out.append(res)
            x = y_r
    return out


def _layout_of(res, layout):
    """A block's runs in ``layout`` (a block without a KV cache ran one)."""
    return layout if (layout, "decode") in res else LAYOUTS[0]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_states_and_aux(arch, dtype):
    blockwise = _blockwise_bf16(arch, dtype)
    check_forward(arch, dtype, hidden=not blockwise)
    if blockwise:
        for n, res in enumerate(_blockwise(arch, dtype)):
            _close(*res["forward"], dtype, f"block {n}")
            _close(*res["aux"], dtype, f"block {n} aux")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,layout", RUNS)
def test_prefill_logits_and_cache(arch, layout, dtype):
    blockwise = _blockwise_bf16(arch, dtype)
    check_prefill(arch, dtype, layout, caches=not blockwise)
    if blockwise:
        for res in _blockwise(arch, dtype):
            _close_caches(*res[_layout_of(res, layout), "prefill_cache"],
                          dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch,layout", RUNS)
def test_decode_steps(arch, layout, dtype):
    blockwise = _blockwise_bf16(arch, dtype)
    check_decode(arch, dtype, layout, caches=not blockwise)
    if blockwise:
        for n, res in enumerate(_blockwise(arch, dtype)):
            lay = _layout_of(res, layout)
            for t, (g, w) in enumerate(res[lay, "decode"]):
                _close(g, w, dtype, f"block {n} decode step {t}")
            _close_caches(*res[lay, "decode_cache"], dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_where_the_margin_is_clear(arch, dtype):
    check_greedy(arch, dtype)
