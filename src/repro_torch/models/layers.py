"""Core LM layers (``repro/models/layers.py``): norms, RoPE, softcap,
(GQA / local / softcapped / cross) attention with its KV cache, the dense
MLP and the capacity-bounded top-k MoE FFN.

Plain functions over tensors: ``init_*`` builds a dict of parameters from
an explicit ``torch.Generator``, ``*_fwd`` applies it.  Every ``x @ w``
and the value product run in the storage dtype (bf16 by default), as the
reference's; norms, RoPE, the scores, the softmax and the logits run in
float32.  The attention's large products are plain matrix products,
``torch.matmul`` / ``torch.einsum``: the reference computes them outside
any Pallas kernel, so this path has no kernel of its own.

Where the reference's numerics would be lost in a literal translation,
the code says so:

* fp32 products (``preferred_element_type=jnp.float32``, the scores at
  ``layers.py:147``, ``:290``, ``:293``): a torch bf16 product returns
  bf16 and rounds the scores, so ``f32_matmul`` asks cuBLAS for float32
  results of the bf16 operands (``out_dtype``: no float32 copy of the
  KV cache or of the unembedding table); on the CPU, which has no such
  product, both operands are upcast first (products of bf16 values are
  exact in float32; TF32 stays off);
* GQA grouping: q is viewed as ``[B, S, K, G, Dh]``, so query head ``h``
  reads KV head ``h // G`` (``repeat_interleave`` order, not ``repeat``);
* masked scores are ``-1e30``, not ``-inf``, and the softmax runs in
  float32 before the cast;
* ``jax.nn.gelu`` is the tanh approximation (``F.gelu(approximate="tanh")``);
* a product of two dtypes promotes as JAX's does (bf16 @ f32 -> f32:
  ``mm``), where torch's matmul would refuse it.

The KV cache has the reference's two layouts, ``bksd`` = [B, K, S, Dh] and
``sbkd`` = [S, B, K, Dh].  A "dus" write updates the cache in place and
returns it (the reference's ``dynamic_update_slice``, start clamped the
same way); a "masked" write returns new tensors, as the reference's
select does.

The MoE FFN (``init_moe``, ``moe_fwd``, ``_moe_local_dispatch``) routes
in float32 and runs its expert products in the storage dtype, as the
reference's.  The expert-parallel ``moe_fwd_a2a`` needs a mesh of cards
and raises.  ``record_routes`` hands out the routing each MoE layer
computed, for checks that hold one run's routing against another's.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.dtypes import torch_dtype

NEG_INF = -1e30       # the reference's masked score (not -inf)
# while ``record_routes`` lasts: the list it hands out, and the expert
# choices to follow (None: each layer follows its own)
_ROUTE_LOG: Optional[list] = None
_ROUTE_FOLLOW: Optional[list] = None

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's promotion of mixed dtypes (bf16 @ f32 -> f32),
    which torch's matmul refuses."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with float32 results, as the reference's
    ``preferred_element_type=jnp.float32``.  ``a``: [..., M, K]; ``b``:
    [K, N] or [..., K, N] with ``a``'s batch dims.  A bf16 (or fp16) pair
    on the card is one cuBLAS product with float32 output and float32
    accumulation, reading the operands as they lie; elsewhere both are
    upcast first."""
    low = (torch.bfloat16, torch.float16)
    if not (a.is_cuda and a.dtype in low and b.dtype == a.dtype):
        return a.float() @ b.float()
    M, N = a.shape[-2], b.shape[-1]
    if b.dim() == 2:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
    else:
        out = torch.bmm(a.reshape(-1, M, a.shape[-1]),
                        b.reshape(-1, b.shape[-2], N),
                        out_dtype=torch.float32)
    return out.reshape(*a.shape[:-2], M, N)


def dense_init(gen: torch.Generator, shape, in_axis: int, dtype,
               device) -> torch.Tensor:
    """Normal(0, 1/fan_in) drawn in float32 from ``gen``, then cast once.
    JAX's generator cannot be reproduced: parity with the reference goes
    through ``models.convert``."""
    std = 1.0 / math.sqrt(shape[in_axis])
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    # in place: one float32 temporary (a full-width expert stack's is 21 GB)
    return x.mul_(std).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, dim: Optional[int] = None, *, device):
    d = dim or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def norm_fwd(p, x: torch.Tensor, cfg: ModelConfig,
             eps: Optional[float] = None) -> torch.Tensor:
    """RMSNorm or LayerNorm computed in float32, cast back to x's dtype."""
    eps = eps or cfg.norm_eps
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, n_heads, head_dim]; positions: [..., S].  Split halves
    (not interleaved pairs), in float32."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # [half]
    ang = positions[..., None].float() * freqs              # [..., S, half]
    cos = torch.cos(ang)[..., None, :]                      # [..., S, 1, half]
    sin = torch.sin(ang)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin],
                     dim=-1).to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, device):
    dt = _dtype(cfg)
    D, Q, KV = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": dense_init(gen, (D, Q), 0, dt, device),
        "wk": dense_init(gen, (D, KV), 0, dt, device),
        "wv": dense_init(gen, (D, KV), 0, dt, device),
        "wo": dense_init(gen, (Q, D), 0, dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((Q,), dtype=dt, device=device)
        p["bk"] = torch.zeros((KV,), dtype=dt, device=device)
        p["bv"] = torch.zeros((KV,), dtype=dt, device=device)
    return p


def _qkv(p, x: torch.Tensor, cfg: ModelConfig):
    B, S, _ = x.shape
    H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = mm(x, p["wq"])
    k = mm(x, p["wk"])
    v = mm(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, H, Dh), k.reshape(B, S, K, Dh),
            v.reshape(B, S, K, Dh))


def _scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                 local_window: Optional[int]) -> torch.Tensor:
    """[Sq, Sk] bool mask: causal, optionally sliding-window."""
    m = k_pos[None, :] <= q_pos[:, None]
    if local_window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < local_window
    return m


def _sdpa(q, k, v, mask, cfg: ModelConfig) -> torch.Tensor:
    """q: [B,Sq,H,Dh], k/v: [B,Sk,K,Dh], mask: [Sq,Sk] or [B,1,1,Sq,Sk]."""
    B, Sq, H, Dh = q.shape
    K = k.shape[2]
    G = H // K
    # GQA: head h = k * G + g reads KV head h // G
    qg = q.reshape(B, Sq, K, G, Dh)
    scale = 1.0 / math.sqrt(Dh)
    # fp32 scores of storage-dtype operands (layers.py:147): f32_matmul of
    # [B, K, G*Sq, Dh] by [B, K, Dh, Sk]
    qk = qg.permute(0, 2, 3, 1, 4).reshape(B, K, G * Sq, Dh)
    s = f32_matmul(qk, k.permute(0, 2, 3, 1)).reshape(B, K, G, Sq, -1)
    s = s * scale
    s = softcap(s, cfg.attn_logit_softcap)
    if mask.dim() == 2:
        mask = mask[None, None, None]
    s = torch.where(mask, s, NEG_INF)
    pr = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", pr, v)
    return o.reshape(B, Sq, H, Dh)


def attention_fwd(p, x: torch.Tensor, positions: torch.Tensor,
                  cfg: ModelConfig, *, local: bool = False,
                  q_chunk: int = 1024, cross_kv=None) -> torch.Tensor:
    """Training/prefill attention.  Returns [B,S,D].

    Chunked over queries when S > q_chunk (a loop in place of the
    reference's scan): each chunk computes a bounded [B,H,Cq,S] score
    block.  ``cross_kv``: optional (k, v) ([B,T,K,Dh]) for encoder-decoder
    cross attention (no causal mask, no RoPE)."""
    B, S, D = x.shape
    H, Dh = cfg.num_heads, cfg.head_dim
    window = cfg.local_window if local else None
    if cross_kv is not None:
        q = mm(x, p["wq"]).reshape(B, S, H, Dh)
        if cfg.qkv_bias:
            q = q + p["bq"].reshape(H, Dh)
        k, v = cross_kv
        mask = torch.ones((S, k.shape[1]), dtype=torch.bool, device=x.device)
        o = _sdpa(q, k, v, mask, cfg)
        return mm(o.reshape(B, S, cfg.q_dim), p["wo"])

    q, k, v = _qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = _attend(q, k, v, positions[0], window, q_chunk, cfg)
    return mm(o.reshape(B, S, cfg.q_dim), p["wo"])


def _attend(q, k, v, pos: torch.Tensor, window: Optional[int],
            q_chunk: int, cfg: ModelConfig) -> torch.Tensor:
    """Causal self attention of q over k/v at positions ``pos`` ([S]),
    whole when S <= q_chunk, else one query chunk at a time."""
    S = q.shape[1]
    if S <= q_chunk:
        return _sdpa(q, k, v, _scores_mask(pos, pos, window), cfg)
    if S % q_chunk:
        raise ValueError(f"sequence {S} is not a multiple of q_chunk "
                         f"{q_chunk}")
    return torch.cat([
        _sdpa(q[:, i:i + q_chunk], k, v,
              _scores_mask(pos[i:i + q_chunk], pos, window), cfg)
        for i in range(0, S, q_chunk)], dim=1)


# -- KV cache ----------------------------------------------------------------


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, layout: str,
                  dtype, device):
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    shape = ((batch, K, max_len, Dh) if layout == "bksd"
             else (max_len, batch, K, Dh))
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _cache_cap(cache, layout: str) -> int:
    return cache["k"].shape[2] if layout == "bksd" else cache["k"].shape[0]


def _to_layout(t: torch.Tensor, layout: str) -> torch.Tensor:
    """[B, S, K, Dh] -> the cache layout's [B, K, S, Dh] or [S, B, K, Dh]."""
    return t.transpose(1, 2) if layout == "bksd" else t.transpose(0, 1)


def _cache_write_masked(cache, k_new, v_new, pos: int, layout: str):
    """Single-token cache write via a one-hot select along S (the
    reference's write for a sequence-sharded cache): new tensors, one
    extra cache-sized write."""
    if k_new.shape[1] != 1:
        raise ValueError("the masked write is decode-only")
    S = _cache_cap(cache, layout)
    hit = torch.arange(S, device=k_new.device) == pos % S
    hit = hit[None, None, :, None] if layout == "bksd" else \
        hit[:, None, None, None]
    return {"k": torch.where(hit, _to_layout(k_new, layout).to(
                cache["k"].dtype), cache["k"]),
            "v": torch.where(hit, _to_layout(v_new, layout).to(
                cache["v"].dtype), cache["v"])}


def _cache_write(cache, k_new, v_new, pos: int, layout: str):
    """k_new/v_new: [B, S_new, K, Dh]; pos: start index, taken modulo the
    cache capacity (ring-buffer semantics for window caches).  Written in
    place; the start is clamped into [0, cap - S_new] as
    ``dynamic_update_slice`` clamps it."""
    cap = _cache_cap(cache, layout)
    n = k_new.shape[1]
    start = min(max(pos % cap, 0), cap - n)
    for name, new in (("k", k_new), ("v", v_new)):
        dst = cache[name]
        new = _to_layout(new, layout).to(dst.dtype)
        if layout == "bksd":
            dst[:, :, start:start + n] = new
        else:
            dst[start:start + n] = new
    return cache


def attention_decode(p, x: torch.Tensor, cache, cache_len: int,
                     cfg: ModelConfig, *, layout: str = "bksd",
                     local: bool = False, cross: bool = False,
                     update: str = "dus", windowed: bool = False):
    """One-token decode.  x: [B,1,D]; cache_len: tokens already in the
    cache.  ``update``: "dus" (in place) or "masked" (select).
    Returns (y [B,1,D], new_cache)."""
    B = x.shape[0]
    H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // K
    if cross:
        q = mm(x, p["wq"]).reshape(B, 1, H, Dh)
        new_cache = cache
    else:
        q, k_new, v_new = _qkv(p, x, cfg)
        pos = torch.full((B, 1), cache_len, dtype=torch.int32,
                         device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k_new = apply_rope(k_new, pos, cfg.rope_theta)
        writer = _cache_write_masked if update == "masked" else _cache_write
        new_cache = writer(cache, k_new, v_new, cache_len, layout)

    kc, vc = new_cache["k"], new_cache["v"]
    S = _cache_cap(new_cache, layout)
    qg = q.reshape(B, K, G, Dh)
    scale = 1.0 / math.sqrt(Dh)
    # fp32 scores of storage-dtype operands (layers.py:290, :293):
    # f32_matmul of [B, K, G, Dh] by the cache as [B, K, Dh, S], a view
    kd = "bksd" if layout == "bksd" else "sbkd"
    kt = kc.transpose(2, 3) if layout == "bksd" else kc.permute(1, 2, 3, 0)
    s = f32_matmul(qg, kt) * scale
    s = softcap(s, cfg.attn_logit_softcap)
    k_pos = torch.arange(S, device=x.device)
    if cross:
        valid = k_pos >= 0
    elif windowed:
        # ring-buffer window cache: every filled slot is in-window
        valid = k_pos < min(cache_len + 1, S)
    else:
        valid = k_pos <= cache_len
        if local and cfg.local_window is not None:
            valid &= (cache_len - k_pos) < cfg.local_window
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    pr = torch.softmax(s, dim=-1).to(x.dtype)
    o = torch.einsum(f"bkgs,{kd}->bkgd", pr, vc)
    y = mm(o.reshape(B, 1, cfg.q_dim), p["wo"])
    return y, new_cache


def attention_prefill(p, x: torch.Tensor, positions: torch.Tensor,
                      cfg: ModelConfig, max_len: int, *,
                      layout: str = "bksd", local: bool = False,
                      q_chunk: int = 1024):
    """Prefill: full forward + populate a KV cache of capacity ``max_len``."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    cache = init_kv_cache(cfg, B, max_len, layout, x.dtype, x.device)
    if S > max_len:
        # a window cache keeps the last `max_len` tokens, ring-rolled so
        # that token t lives in slot t % max_len
        shift = (S - max_len) % max_len
        kw = torch.roll(k[:, S - max_len:], shift, dims=1)
        vw = torch.roll(v[:, S - max_len:], shift, dims=1)
        cache = _cache_write(cache, kw, vw, 0, layout)
    else:
        cache = _cache_write(cache, k, v, 0, layout)
    window = cfg.local_window if local else None
    o = _attend(q, k, v, positions[0], window, q_chunk, cfg)
    y = mm(o.reshape(B, S, cfg.q_dim), p["wo"])
    return y, cache


# ---------------------------------------------------------------------------
# dense MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None, *, device):
    dt = _dtype(cfg)
    F_ = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, (cfg.d_model, F_), 0, dt, device),
        "w_up": dense_init(gen, (cfg.d_model, F_), 0, dt, device),
        "w_down": dense_init(gen, (F_, cfg.d_model), 0, dt, device),
    }


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation (layers.py:369)
    return F.gelu(x, approximate="tanh")


def _act(cfg: ModelConfig):
    return _gelu_tanh if cfg.act == "gelu" else F.silu


def mlp_fwd(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    g = _act(cfg)(mm(x, p["w_gate"]))
    return mm(g * mm(x, p["w_up"]), p["w_down"])


# ---------------------------------------------------------------------------
# MoE (top-k, capacity-bounded, scatter/gather dispatch)
# ---------------------------------------------------------------------------


def init_moe(gen: torch.Generator, cfg: ModelConfig, device):
    dt = _dtype(cfg)
    E, D, F_ = cfg.num_experts, cfg.d_model, cfg.expert_d_ff
    p = {
        "router": dense_init(gen, (D, E), 0, torch.float32, device),
        "w_gate": dense_init(gen, (E, D, F_), 1, dt, device),
        "w_up": dense_init(gen, (E, D, F_), 1, dt, device),
        "w_down": dense_init(gen, (E, F_, D), 1, dt, device),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, F_ * cfg.num_shared_experts,
                               device=device)
    return p


def moe_capacity(cfg: ModelConfig, T: int) -> int:
    """Slots per expert for ``T`` tokens: the reference's expression, in
    the same order, in Python floats (layers.py:406-407)."""
    cap = int(cfg.capacity_factor * T * cfg.experts_per_token
              / cfg.num_experts)
    return max(8, min(cap, T))


@contextlib.contextmanager
def record_routes(follow: Optional[list] = None):
    """While the context lasts, every MoE routing (``_route``) appends what
    it computed to the list handed out, in call order: (the experts it
    chose [T, k], largest first; the router's probabilities [T, E],
    float32), on the tokens' device.

    ``follow``, a list of [T, k] expert choices, one a call in the same
    order, makes each call dispatch to the next of them instead, weighted
    by its own probabilities of those experts: a run held against
    another then routes as that one did, and what is recorded stays each
    layer's own choice.  Every choice in it must be used."""
    global _ROUTE_LOG, _ROUTE_FOLLOW
    saved = _ROUTE_LOG, _ROUTE_FOLLOW
    _ROUTE_LOG, _ROUTE_FOLLOW = [], follow
    try:
        yield _ROUTE_LOG
        if follow:
            raise ValueError(f"{len(follow)} routings to follow were not "
                             f"used")
    finally:
        _ROUTE_LOG, _ROUTE_FOLLOW = saved


def _route(xt: torch.Tensor, router: torch.Tensor, cfg: ModelConfig,
           cap: int):
    """Top-k routing of ``xt`` [T, D] in float32 and each (token, slot)'s
    row in the [E*cap + 1, D] expert buffer.  Returns (weights [T, k],
    slot [T, k], keep [T, k], aux).

    The slots are taken sorted, largest first (``lax.top_k``'s order): it
    decides which pairs overflow and the aux loss's first choice.  A pair's
    place in its expert is the exclusive cumsum over the flattened
    [T*k, E] one-hot, token-major then slot; past ``cap`` it goes to the
    spare row E*cap."""
    T = xt.shape[0]
    E, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(xt.float() @ router, dim=-1)        # [T, E]
    weights, sel = torch.topk(probs, k, dim=-1, sorted=True)  # [T, k]
    if _ROUTE_LOG is not None:
        _ROUTE_LOG.append((sel, probs))
        if _ROUTE_FOLLOW is not None:
            sel = _ROUTE_FOLLOW.pop(0).to(device=sel.device, dtype=sel.dtype)
            weights = probs.gather(-1, sel)
    weights = weights / weights.sum(-1, keepdim=True).clamp(min=1e-9)
    flat = F.one_hot(sel, E).reshape(T * k, E)
    pos = ((flat.cumsum(0) - flat) * flat).sum(-1).reshape(T, k)
    keep = pos < cap
    slot = torch.where(keep, sel * cap + pos, E * cap)
    # Switch-style load-balance loss over each token's first choice
    density = F.one_hot(sel[:, 0], E).float().mean(0)
    aux = E * (density * probs.mean(0)).sum()
    return weights, slot, keep, aux


def _scatter(xt: torch.Tensor, slot: torch.Tensor, E: int,
             cap: int) -> torch.Tensor:
    """Each token copied to its k slots of a [E, cap, D] buffer; the
    overflow pairs land on the spare row, which is cut off."""
    T, D = xt.shape
    buf = torch.zeros((E * cap + 1, D), dtype=xt.dtype, device=xt.device)
    k = slot.shape[1]
    buf.index_copy_(0, slot.reshape(-1), xt.repeat_interleave(k, dim=0))
    return buf[:E * cap].reshape(E, cap, D)


def moe_fwd(p, x: torch.Tensor, cfg: ModelConfig):
    """Capacity-bounded top-k MoE with scatter dispatch and gather
    combine.  x: [B, S, D] -> ([B, S, D], aux)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    cap = moe_capacity(cfg, T)
    xt = x.reshape(T, D)
    weights, slot, keep, aux = _route(xt, p["router"], cfg, cap)
    expert_in = _scatter(xt, slot, E, cap)
    h = _act(cfg)(mm(expert_in, p["w_gate"])) * mm(expert_in, p["w_up"])
    expert_out = mm(h, p["w_down"])                            # [E, cap, D]
    # the spare row gathers back as zeros
    flat_out = torch.cat([expert_out.reshape(E * cap, D),
                          expert_out.new_zeros((1, D))])
    gathered = flat_out[slot.reshape(-1)].reshape(T, k, D)
    y = (gathered * (weights * keep).to(x.dtype)[..., None]).sum(1)
    if cfg.num_shared_experts:
        y = y + mlp_fwd(p["shared"], xt, cfg)
    return y.reshape(B, S, D), aux


def _moe_local_dispatch(xt: torch.Tensor, p, cfg: ModelConfig, cap: int):
    """Local top-k routing + scatter into per-expert buffers.  xt: [T, D].
    Returns (buf [E, cap, D], slot, weights, keep, aux)."""
    weights, slot, keep, aux = _route(xt, p["router"], cfg, cap)
    return (_scatter(xt, slot, cfg.num_experts, cap), slot, weights, keep,
            aux)


def moe_fwd_a2a(p, x: torch.Tensor, cfg: ModelConfig, ctx):
    """The reference's expert-parallel MoE (all-to-all over a mesh's model
    axis) needs several cards; one card serves through ``moe_fwd``."""
    raise NotImplementedError(
        "moe_fwd_a2a (expert-parallel MoE over a mesh) is not ported: it "
        "needs several cards (ROADMAP queue 1 item 4)")
