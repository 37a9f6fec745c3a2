"""The port's LM stack against the reference's, on the reference's weights.

For each of the six architectures whose blocks are ported (dense and
local attention, the VLM stub, the encoder-decoder) the reduced config
(d_model 64, 2 periods, vocab 256) is built by ``repro.models`` from
PRNGKey(0), carried over by ``repro_torch.models.convert``, and both
packages run the same seeded numpy inputs: the teacher-forced ``forward``
(hidden states), ``prefill`` of the first 12 tokens (logits and caches, in
both KV layouts) and 4 ``decode_step`` s (logits and caches), and greedy
decoding.  gemma2 also runs with ``kv_window=True`` (a window cache of 8
slots) over the 12-token prompt, which takes the ring roll.

Tolerances: float32 (``cfg.replace(dtype="float32",
param_dtype="float32")``) rtol / atol 1e-4; bf16 the reference's own
decode tolerance, atol 0.15 / rtol 0.05 (``tests/test_models.py``).
Greedy tokens must be equal while the reference's top-2 logit margin
exceeds 1e-3 in float32 (every step of these runs does) and twice the
decode tolerance in bf16 (past a closer call the two may part, and
everything after differs).

The helpers here (``_reference``, ``_port``, the ``check_*`` functions)
also serve ``tests/test_torch_lm_moe.py`` and ``tests/test_torch_lm_ssm.py``:
they record every MoE layer's routing in both packages, have the port's
layers dispatch to the reference's experts (``layers.record_routes``), so
that every token is held, and judge the port's own choices (``_flips``).
A masked cache write gives the dus write's
logits and cache exactly; query chunking gives the unchunked attention's
output (rtol / atol 1e-6).
"""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

import repro.configs as ref_configs
from repro.models import layers as ref_L
from repro.models import transformer as ref_T

import repro_torch.configs as configs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.convert import (params_from_reference,
                                        tensor_from_numpy, unstack)

ARCHS = ["qwen2_7b", "yi_9b", "phi3_mini_3p8b", "gemma2_27b",
         "phi3_vision_4p2b", "whisper_base"]
DTYPES = ["float32", "bfloat16"]
LAYOUTS = ["bksd", "sbkd"]
CPU = torch.device("cpu")
B, S, N_PROMPT = 2, 16, 12
MAX_LEN = 40                 # the VLM's 8 prefix positions + 16 + room
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=0.05, atol=0.15)}
MARGIN = 1e-3      # float32; bf16: twice its decode tolerance (_margin)
# the top-k routing margin under which bf16 may pick other experts
MOE_MARGIN = 1e-2
# jamba's 8-block period runs once: the reference marks its 2-period
# decode test slow (tests/test_models.py:85)
PERIODS = {"jamba_1p5_large_398b": 1}


def _layouts(arch):
    """The KV layouts a run takes: one where no block holds a KV cache
    (rwkv6), where the layout changes nothing."""
    pattern = configs.get_config(arch).block_pattern
    return LAYOUTS if any(k.startswith("attn") for k in pattern) else \
        LAYOUTS[:1]


def _cfgs(arch, dtype):
    n = PERIODS.get(arch, 2)
    ref = ref_configs.reduced_config(ref_configs.get_config(arch), n)
    port = configs.reduced_config(configs.get_config(arch), n)
    if dtype == "float32":
        ref = ref.replace(dtype="float32", param_dtype="float32")
        port = port.replace(dtype="float32", param_dtype="float32")
    return ref, port


def _np(x):
    """A tensor or jax array as float32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype, what=""):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what,
                               **TOL[dtype])


@functools.lru_cache(maxsize=None)
def _inputs(arch, dtype):
    """Seeded inputs in both packages, bit for bit: (jax kwargs, torch
    kwargs, tokens as numpy)."""
    ref_cfg, _ = _cfgs(arch, dtype)
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, ref_cfg.vocab_size, size=(B, S), dtype=np.int32)
    jkw = {}
    dt = jnp.dtype(ref_cfg.dtype)
    if ref_cfg.frontend == "clip_stub":
        jkw["embeds"] = jnp.asarray(rng.standard_normal(
            (B, ref_cfg.frontend_tokens, ref_T.CLIP_DIM)), dt)
    if ref_cfg.family == "encdec":
        jkw["frames"] = jnp.asarray(rng.standard_normal(
            (B, ref_cfg.encoder_seq, ref_cfg.d_model)), dt)
    tkw = {k: tensor_from_numpy(np.asarray(v), CPU) for k, v in jkw.items()}
    return jkw, tkw, tokens


def _front(cfg):
    return cfg.frontend_tokens if cfg.frontend == "clip_stub" else 0


def _stack(cache):
    """The port's per-period cache as the reference's stacked numpy tree."""
    return {b: {n: np.stack([_np(c[b][n]) for c in cache])
                for n in cache[0][b]} for b in cache[0]}


def _reference(arch, dtype, window=False):
    return _reference_run(arch, dtype, window)


def _port(arch, dtype, window=False):
    return _port_run(arch, dtype, window)


class _Routes:
    """Every MoE layer's routing in call order.  ``take`` hands the calls
    so far over, as numpy, and starts anew; ``lead`` gives the port's
    layers the reference's choices to dispatch to (``follow``)."""

    def __init__(self, calls=None, follow=None):
        self.calls = [] if calls is None else calls
        self.follow = follow

    def lead(self, ref_calls):
        self.follow.extend(torch.from_numpy(np.ascontiguousarray(
            sel[:, :-1])) for sel, _ in ref_calls)

    def take(self):
        out = [tuple(np.asarray(a) for a in c) for c in self.calls]
        self.calls.clear()
        assert not self.follow, "a routing to follow went unused"
        return out


_REF_ROUTES = []     # the innermost ``_ref_recording``'s routes last


@contextlib.contextmanager
def _ref_recording():
    """The reference's ``moe_fwd`` records its routing while the context
    lasts: (experts [T, k+1] by falling probability, their probabilities),
    computed as it routes, in float32 (``jax.debug.callback``: the
    reference's own routing is not handed out).  A function jitted in one
    such context records into the context it runs in."""
    routes, orig = _Routes(), ref_L.moe_fwd

    def moe_fwd(p, x, cfg):
        probs = jax.nn.softmax(x.reshape(-1, x.shape[-1]).astype(jnp.float32)
                               @ p["router"], axis=-1)
        vals, sel = lax.top_k(probs, cfg.experts_per_token + 1)
        jax.debug.callback(
            lambda s_, v_: _REF_ROUTES[-1].calls.append((s_, v_)),
            sel, vals, ordered=True)
        return orig(p, x, cfg)

    ref_L.moe_fwd = moe_fwd
    _REF_ROUTES.append(routes)
    try:
        yield routes
    finally:
        ref_L.moe_fwd = orig
        _REF_ROUTES.pop()


@contextlib.contextmanager
def _port_recording():
    """The port's MoE layers' own routing (``layers.record_routes``):
    (experts [T, k] as chosen, the router's probabilities [T, E]); each
    call dispatches to the experts ``_Routes.lead`` gave it."""
    follow = []
    with L.record_routes(follow=follow) as log:
        yield _Routes(log, follow)


@functools.lru_cache(maxsize=None)
def _reference_run(arch, dtype, window):
    """The reference's params (numpy) and every result the tests hold,
    with each run's MoE routing (``routes``)."""
    cfg, _ = _cfgs(arch, dtype)
    jkw, _, tokens = _inputs(arch, dtype)
    params = ref_T.init_params(jax.random.PRNGKey(0), cfg)
    tok = jnp.asarray(tokens)
    out = {"params": jax.tree.map(np.asarray, params), "routes": {}}
    with _ref_recording() as routes:
        if not window:
            pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None],
                                   (B, S))
            h, aux = jax.jit(lambda p, t, kw: ref_T.forward(
                p, t, pos, cfg, **kw))(params, tok, jkw)
            out["hidden"], out["aux"] = _np(h), float(aux)
            out["routes"]["forward"] = routes.take()
        front = _front(cfg)
        for layout in (["bksd"] if window else _layouts(arch)):
            prefill = jax.jit(lambda p, t, kw: ref_T.prefill(
                p, t, cfg, max_len=MAX_LEN, kv_layout=layout,
                kv_window=window, **kw))
            decode = jax.jit(lambda p, c, t, n, x: ref_T.decode_step(
                p, c, t, n, cfg, kv_layout=layout, cross=x,
                kv_window=window))
            lg, cache, cross = prefill(params, tok[:, :N_PROMPT], jkw)
            res = {"prefill": _np(lg),
                   "prefill_cache": jax.tree.map(_np, cache), "decode": [],
                   "start": jax.tree.map(np.asarray, (cache, cross)),
                   "routes": {"prefill": routes.take(), "decode": [],
                              "greedy": []}}
            gl, gcache, toks, margins, tops = lg, cache, [], [], []
            for t in range(N_PROMPT, S):
                n = jnp.int32(front + t)
                lg, cache = decode(params, cache, tok[:, t:t + 1], n, cross)
                res["decode"].append(_np(lg))
                res["routes"]["decode"].append(routes.take())
                # greedy: from the prompt, the reference's own argmax fed
                # back
                top2 = np.sort(_np(gl), axis=-1)[:, -2:]
                margins.append(top2[:, 1] - top2[:, 0])
                tops.append(top2[:, 1])
                g = jnp.argmax(gl, axis=-1).astype(jnp.int32)
                toks.append(np.asarray(g))
                gl, gcache = decode(params, gcache, g[:, None], n, cross)
                jax.block_until_ready(gl)
                res["routes"]["greedy"].append(routes.take())
            res["decode_cache"] = jax.tree.map(_np, cache)
            res["greedy"], res["margins"], res["tops"] = toks, margins, tops
            out[layout] = res
    return out


@functools.lru_cache(maxsize=None)
def _port_run(arch, dtype, window):
    """The port on the reference's weights, the same runs."""
    ref = _reference(arch, dtype, window)
    _, cfg = _cfgs(arch, dtype)
    _, tkw, tokens = _inputs(arch, dtype)
    params = params_from_reference(ref["params"], CPU)
    tok = torch.from_numpy(tokens)
    out = {"params": params, "routes": {}}
    rr = ref["routes"]
    with _port_recording() as routes:
        if not window:
            pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
            routes.lead(rr["forward"])
            out["hidden"], out["aux"] = T.forward(params, tok, pos, cfg,
                                                  **tkw)
            out["routes"]["forward"] = routes.take()
        front = _front(cfg)
        for layout in (["bksd"] if window else _layouts(arch)):
            wr = ref[layout]["routes"]
            routes.lead(wr["prefill"])
            lg, cache, cross = T.prefill(params, tok[:, :N_PROMPT], cfg,
                                         max_len=MAX_LEN, kv_layout=layout,
                                         kv_window=window, **tkw)
            res = {"prefill": lg, "prefill_cache": _stack(cache),
                   "decode": [], "start": (cache, cross),
                   "routes": {"prefill": routes.take(), "decode": [],
                              "greedy": []}}
            cache, gl, gcache, toks = _clone(cache), lg, _clone(cache), []
            for i, t in enumerate(range(N_PROMPT, S)):
                routes.lead(wr["decode"][i])
                lg, cache = T.decode_step(params, cache, tok[:, t:t + 1],
                                          front + t, cfg, kv_layout=layout,
                                          cross=cross, kv_window=window)
                res["decode"].append(lg)
                res["routes"]["decode"].append(routes.take())
                g = torch.argmax(gl, dim=-1).to(torch.int32)
                toks.append(g.numpy())
                routes.lead(wr["greedy"][i])
                gl, gcache = T.decode_step(params, gcache, g[:, None],
                                           front + t, cfg, kv_layout=layout,
                                           cross=cross, kv_window=window)
                res["routes"]["greedy"].append(routes.take())
            res["decode_cache"] = _stack(cache)
            res["greedy"] = toks
            out[layout] = res
    return out


def _clone(cache):
    return [{b: {n: t.clone() for n, t in c.items()} for b, c in pc.items()}
            for pc in cache]


def _flips(port_calls, ref_calls, dtype, rows=None):
    """Where the port's MoE layers would have sent a token to another set
    of experts than the reference did (the port dispatches as the
    reference: ``_Routes.lead``), over the rows in ``rows`` ([B] bool,
    all by default).  In float32 the choices, in their order, are
    identical; in bf16 the sets may differ only where the reference's
    k-th and (k+1)-th probabilities lie within ``MOE_MARGIN``: hidden
    states that differ by a bf16 rounding can pick another expert there.
    Returns the number of (layer, token) pairs that differ."""
    assert len(port_calls) == len(ref_calls)
    mine = np.ones(B, bool) if rows is None else rows
    n = 0
    for (ps, _), (rs, rv) in zip(port_calls, ref_calls):
        k = ps.shape[1]
        held = np.repeat(mine, ps.shape[0] // B)
        if dtype == "float32":
            np.testing.assert_array_equal(ps[held], rs[held, :k])
        d = (np.sort(ps, -1) != np.sort(rs[:, :k], -1)).any(-1) & held
        near = rv[:, k - 1] - rv[:, k] < MOE_MARGIN
        assert not (d & ~near).any(), "experts differ away from a near-tie"
        n += int(d.sum())
    return n


def _close_caches(got, want, dtype):
    """Every cache leaf of a (period-stacked, or one block's) cache.  In a bf16 model the recurrent states kept in
    float32 (RWKV's ``wkv``, Mamba's ``ssm``) sum the whole sequence's
    bf16 products, so a bf16 rounding of one input stays in them: they
    are held at the decode tolerance's rtol of each head's (``wkv``
    [P, B, H, N, N]) or row's (``ssm`` [P, B, d_inner, d_state]) largest
    magnitude, where the logits hold an absolute 0.15."""
    assert got.keys() == want.keys()
    for b, kv in want.items():
        assert got[b].keys() == kv.keys()
        for n, arr in kv.items():
            assert got[b][n].shape == arr.shape, (b, n)
            g, arr = _np(got[b][n]), _np(arr)
            if dtype == "bfloat16" and n in ("wkv", "ssm"):
                rtol = TOL[dtype]["rtol"]
                scale = np.abs(arr).max(axis=(-2, -1), keepdims=True)
                assert (np.abs(g - arr) <= rtol * (np.abs(arr) + scale)
                        ).all(), f"{b}.{n}"
            else:
                _close(g, arr, dtype, f"{b}.{n}")


def check_forward(arch, dtype, hidden=True):
    """Hidden states at every token (the port dispatching as the
    reference: ``_flips``), but not with ``hidden=False`` (a caller that
    holds each block alone), and the balance loss."""
    got, want = _port(arch, dtype), _reference(arch, dtype)
    _flips(got["routes"]["forward"], want["routes"]["forward"], dtype)
    if hidden:
        _close(got["hidden"], want["hidden"], dtype, "hidden")
    np.testing.assert_allclose(float(got["aux"]), want["aux"], err_msg="aux",
                               **TOL[dtype])


def check_prefill(arch, dtype, layout, caches=True):
    got, want = _port(arch, dtype)[layout], _reference(arch, dtype)[layout]
    _flips(got["routes"]["prefill"], want["routes"]["prefill"], dtype)
    _close(got["prefill"], want["prefill"], dtype, "logits")
    if caches:
        _close_caches(got["prefill_cache"], want["prefill_cache"], dtype)


def check_decode(arch, dtype, layout, caches=True):
    got, want = _port(arch, dtype)[layout], _reference(arch, dtype)[layout]
    for t, (g, w) in enumerate(zip(got["decode"], want["decode"])):
        _flips(got["routes"]["decode"][t], want["routes"]["decode"][t],
               dtype)
        _close(g, w, dtype, f"decode step {t}")
    if caches:
        _close_caches(got["decode_cache"], want["decode_cache"], dtype)


def check_greedy(arch, dtype):
    """Greedy tokens equal while the reference's top-2 logit margin is
    clear (``_margin``)."""
    for layout in _layouts(arch):
        got, want = _port(arch, dtype)[layout], _reference(arch, dtype)[layout]
        clear = np.ones(B, bool)
        for t, (g, w, m, top) in enumerate(zip(
                got["greedy"], want["greedy"], want["margins"],
                want["tops"])):
            clear &= m > _margin(dtype, top)
            np.testing.assert_array_equal(g[clear], w[clear])
            # the step that makes the next logits, from these tokens
            _flips(got["routes"]["greedy"][t], want["routes"]["greedy"][t],
                   dtype, clear)
        if dtype == "float32":
            assert clear.all()


def check_meta_device(arch):
    """The forward, prefill and a decode step on the meta device, where a
    tensor made on the CPU (an ``arange`` or ``zeros`` without
    ``device=``) refuses to meet the activations, as it would on the
    card."""
    _, cfg = _cfgs(arch, "bfloat16")
    meta = torch.device("meta")
    params = T.init_params(cfg, device=meta)
    tok = torch.zeros((B, 6), dtype=torch.int64, device=meta)
    pos = torch.zeros((B, 6), dtype=torch.int32, device=meta)
    h, aux = T.forward(params, tok, pos, cfg)
    lg, cache, _ = T.prefill(params, tok, cfg, MAX_LEN)
    lg2, cache = T.decode_step(params, cache, tok[:, :1], 6, cfg)
    assert {t.device for t in (h, aux, lg, lg2)} == {meta}
    assert lg2.shape == (B, cfg.vocab_size)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_states(arch, dtype):
    check_forward(arch, dtype)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache(arch, dtype, layout):
    check_prefill(arch, dtype, layout)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps(arch, dtype, layout):
    check_decode(arch, dtype, layout)


def _margin(dtype, top):
    """The top-2 margin past which the argmax must agree: 1e-3 in float32;
    in bf16 twice the decode tolerance at the top logit, since a bf16
    logit may lie that far from the reference's (0.07 measured) and two
    such can swap a closer pair (phi3-mini swaps one at a margin of 0.023)."""
    if dtype == "float32":
        return MARGIN
    return 2 * (TOL[dtype]["atol"] + TOL[dtype]["rtol"] * np.abs(top))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_where_the_margin_is_clear(arch, dtype):
    check_greedy(arch, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_window_cache_rolls_like_the_reference(dtype):
    """gemma2 with ``kv_window``: its local layers keep an 8-slot ring;
    the 12-token prompt takes the roll, the decode steps wrap the ring."""
    got, want = (_port("gemma2_27b", dtype, True)["bksd"],
                 _reference("gemma2_27b", dtype, True)["bksd"])
    assert got["prefill_cache"]["b0"]["k"].shape[3] == 8      # local: window
    assert got["prefill_cache"]["b1"]["k"].shape[3] == MAX_LEN
    _close(got["prefill"], want["prefill"], dtype)
    for b, kv in want["prefill_cache"].items():
        for n, arr in kv.items():
            _close(got["prefill_cache"][b][n], arr, dtype, f"{b}.{n}")
    for g, w in zip(got["decode"], want["decode"]):
        _close(g, w, dtype)
    for b, kv in want["decode_cache"].items():
        for n, arr in kv.items():
            _close(got["decode_cache"][b][n], arr, dtype, f"{b}.{n}")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("arch", ARCHS)
def test_masked_cache_write_equals_dus(arch, layout):
    """The select write (new tensors) gives the in-place write's logits
    and cache exactly, and the reference's dus logits within 1e-4."""
    port = _port(arch, "float32")
    _, cfg = _cfgs(arch, "float32")
    _, _, tokens = _inputs(arch, "float32")
    start, cross = port[layout]["start"]
    tok = torch.from_numpy(tokens)
    front = _front(cfg)
    dus, masked = _clone(start), _clone(start)
    for t in range(N_PROMPT, S):
        lg_d, dus = T.decode_step(port["params"], dus, tok[:, t:t + 1],
                                  front + t, cfg, kv_layout=layout,
                                  cross=cross)
        lg_m, masked = T.decode_step(port["params"], masked,
                                     tok[:, t:t + 1], front + t, cfg,
                                     kv_layout=layout, cross=cross,
                                     kv_update="masked")
        torch.testing.assert_close(lg_m, lg_d, rtol=0, atol=0)
        _close(lg_m, _reference(arch, "float32")[layout]["decode"][
            t - N_PROMPT], "float32")
    for pd, pm in zip(dus, masked):
        for b in pd:
            for n in pd[b]:
                torch.testing.assert_close(pm[b][n], pd[b][n], rtol=0,
                                           atol=0)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["qwen2_7b", "gemma2_27b", "whisper_base"])
def test_decode_from_the_references_own_cache(arch, dtype, layout):
    """The reference's prefill cache (and whisper's cross K/V), carried
    over by ``models.convert.unstack``, decodes in the port to the
    reference's logits."""
    ref = _reference(arch, dtype)
    _, cfg = _cfgs(arch, dtype)
    _, _, tokens = _inputs(arch, dtype)
    cache, cross = ref[layout]["start"]
    cache = unstack(cache, CPU)
    cross = None if cross is None else unstack(cross, CPU)
    assert cache[0]["b0"]["k"].dtype == L._dtype(cfg)
    tok = torch.from_numpy(tokens)
    for t in range(N_PROMPT, S):
        lg, cache = T.decode_step(_port(arch, dtype)["params"], cache,
                                  tok[:, t:t + 1], _front(cfg) + t, cfg,
                                  kv_layout=layout, cross=cross)
        _close(lg, ref[layout]["decode"][t - N_PROMPT], dtype)


@pytest.mark.parametrize("local", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_query_chunking_matches_the_unchunked_attention(dtype, local):
    """attention_fwd over 32 positions in chunks of 8 against one block,
    and both against the reference's (gemma2's layer: softcap, window)."""
    ref_cfg, cfg = _cfgs("gemma2_27b", dtype)
    params = _port("gemma2_27b", dtype)["params"]["blocks"][0]["b0"]["attn"]
    ref_p = jax.tree.map(lambda a: a[0], _reference(
        "gemma2_27b", dtype)["params"]["blocks"]["b0"]["attn"])
    rng = np.random.default_rng(3)
    x_j = jnp.asarray(rng.standard_normal((B, 32, cfg.d_model)),
                      jnp.dtype(ref_cfg.dtype))
    x = tensor_from_numpy(np.asarray(x_j), CPU)
    pos = torch.arange(32, dtype=torch.int32)[None].expand(B, 32)
    whole = L.attention_fwd(params, x, pos, cfg, local=local)
    chunked = L.attention_fwd(params, x, pos, cfg, local=local, q_chunk=8)
    torch.testing.assert_close(chunked.float(), whole.float(), rtol=1e-6,
                               atol=1e-6)
    want = ref_L.attention_fwd(ref_p, x_j, jnp.asarray(pos.numpy()),
                               ref_cfg, local=local, q_chunk=8)
    _close(chunked, want, dtype)
