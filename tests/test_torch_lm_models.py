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
everything after differs).  A masked cache write gives the dus write's
logits and cache exactly; query chunking gives the unchunked attention's
output (rtol / atol 1e-6).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _cfgs(arch, dtype):
    ref = ref_configs.reduced_config(ref_configs.get_config(arch))
    port = configs.reduced_config(configs.get_config(arch))
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


@functools.lru_cache(maxsize=None)
def _reference_run(arch, dtype, window):
    """The reference's params (numpy) and every result the tests hold."""
    cfg, _ = _cfgs(arch, dtype)
    jkw, _, tokens = _inputs(arch, dtype)
    params = ref_T.init_params(jax.random.PRNGKey(0), cfg)
    tok = jnp.asarray(tokens)
    out = {"params": jax.tree.map(np.asarray, params)}
    if not window:
        pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
        h, _ = jax.jit(lambda p, t, kw: ref_T.forward(p, t, pos, cfg, **kw))(
            params, tok, jkw)
        out["hidden"] = _np(h)
    front = _front(cfg)
    layouts = ["bksd"] if window else LAYOUTS
    for layout in layouts:
        prefill = jax.jit(lambda p, t, kw: ref_T.prefill(
            p, t, cfg, max_len=MAX_LEN, kv_layout=layout, kv_window=window,
            **kw))
        decode = jax.jit(lambda p, c, t, n, x: ref_T.decode_step(
            p, c, t, n, cfg, kv_layout=layout, cross=x, kv_window=window))
        lg, cache, cross = prefill(params, tok[:, :N_PROMPT], jkw)
        res = {"prefill": _np(lg), "prefill_cache": jax.tree.map(_np, cache),
               "decode": [], "start": jax.tree.map(np.asarray, (cache, cross))}
        gl, gcache, toks, margins, tops = lg, cache, [], [], []
        for t in range(N_PROMPT, S):
            n = jnp.int32(front + t)
            lg, cache = decode(params, cache, tok[:, t:t + 1], n, cross)
            res["decode"].append(_np(lg))
            # greedy: from the prompt, the reference's own argmax fed back
            top2 = np.sort(_np(gl), axis=-1)[:, -2:]
            margins.append(top2[:, 1] - top2[:, 0])
            tops.append(top2[:, 1])
            g = jnp.argmax(gl, axis=-1).astype(jnp.int32)
            toks.append(np.asarray(g))
            gl, gcache = decode(params, gcache, g[:, None], n, cross)
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
    out = {"params": params}
    if not window:
        pos = torch.arange(S, dtype=torch.int32)[None].expand(B, S)
        out["hidden"], _ = T.forward(params, tok, pos, cfg, **tkw)
    front = _front(cfg)
    for layout in (["bksd"] if window else LAYOUTS):
        lg, cache, cross = T.prefill(params, tok[:, :N_PROMPT], cfg,
                                     max_len=MAX_LEN, kv_layout=layout,
                                     kv_window=window, **tkw)
        res = {"prefill": lg, "prefill_cache": _stack(cache), "decode": [],
               "start": (cache, cross)}
        cache, gl, gcache, toks = _clone(cache), lg, _clone(cache), []
        for t in range(N_PROMPT, S):
            lg, cache = T.decode_step(params, cache, tok[:, t:t + 1],
                                      front + t, cfg, kv_layout=layout,
                                      cross=cross, kv_window=window)
            res["decode"].append(lg)
            g = torch.argmax(gl, dim=-1).to(torch.int32)
            toks.append(g.numpy())
            gl, gcache = T.decode_step(params, gcache, g[:, None], front + t,
                                       cfg, kv_layout=layout, cross=cross,
                                       kv_window=window)
        res["decode_cache"] = _stack(cache)
        res["greedy"] = toks
        out[layout] = res
    return out


def _clone(cache):
    return [{b: {n: t.clone() for n, t in c.items()} for b, c in pc.items()}
            for pc in cache]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_states(arch, dtype):
    _close(_port(arch, dtype)["hidden"], _reference(arch, dtype)["hidden"],
           dtype)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache(arch, dtype, layout):
    got, want = _port(arch, dtype)[layout], _reference(arch, dtype)[layout]
    _close(got["prefill"], want["prefill"], dtype, "logits")
    assert got["prefill_cache"].keys() == want["prefill_cache"].keys()
    for b, kv in want["prefill_cache"].items():
        for n, arr in kv.items():
            assert got["prefill_cache"][b][n].shape == arr.shape
            _close(got["prefill_cache"][b][n], arr, dtype, f"{b}.{n}")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps(arch, dtype, layout):
    got, want = _port(arch, dtype)[layout], _reference(arch, dtype)[layout]
    for t, (g, w) in enumerate(zip(got["decode"], want["decode"])):
        _close(g, w, dtype, f"decode step {t}")
    for b, kv in want["decode_cache"].items():
        for n, arr in kv.items():
            _close(got["decode_cache"][b][n], arr, dtype, f"{b}.{n}")


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
    for layout in LAYOUTS:
        got, want = _port(arch, dtype)[layout], _reference(arch, dtype)[layout]
        clear = np.ones(B, bool)
        for g, w, m, top in zip(got["greedy"], want["greedy"],
                                want["margins"], want["tops"]):
            clear &= m > _margin(dtype, top)
            np.testing.assert_array_equal(g[clear], w[clear])
        if dtype == "float32":
            assert clear.all()


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
