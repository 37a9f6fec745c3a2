"""The LM stack (``repro/models/transformer.py``): embedding -> blocks ->
norm -> head, for all six block kinds: dense and local attention, MoE
attention blocks, the Mamba and Mamba-MoE blocks, and RWKV-6; with the
VLM stub and the encoder-decoder.

Parameters are a nested dict of tensors laid out per layer: ``blocks`` is
a list over periods, each a dict ``{"b<i>": block}`` over
``cfg.block_pattern`` (the reference stacks every leaf over periods and
scans; here a Python loop walks the list, without remat and without
sharding hints: one card needs neither).  Caches are lists over periods
too: a KV cache for an attention block, the recurrent state for a Mamba
or RWKV block.  ``models.convert`` carries the reference's stacked trees
over.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs.base import (ATTN, ATTN_LOCAL, ATTN_MOE, MAMBA,
                                      MAMBA_MOE, RWKV, ModelConfig)
from repro_torch.dtypes import torch_dtype
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import rwkv as R

CLIP_DIM = 1024   # stubbed vision-tower output width
ATTN_KINDS = (ATTN, ATTN_LOCAL, ATTN_MOE)
MAMBA_KINDS = (MAMBA, MAMBA_MOE)
MOE_KINDS = (ATTN_MOE, MAMBA_MOE)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(gen, kind: str, cfg: ModelConfig, device):
    p: Dict[str, Any] = {"norm1": L.init_norm(cfg, device=device)}
    if kind in ATTN_KINDS:
        p["attn"] = L.init_attention(gen, cfg, device)
    elif kind in MAMBA_KINDS:
        p["mamba"] = M.init_mamba(gen, cfg, device)
    elif kind == RWKV:
        p["time"] = R.init_rwkv_time(gen, cfg, device)
    else:
        raise ValueError(kind)
    p["norm2"] = L.init_norm(cfg, device=device)
    if kind in MOE_KINDS:
        p["moe"] = L.init_moe(gen, cfg, device)
    elif kind == RWKV:
        p["channel"] = R.init_rwkv_channel(gen, cfg, device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, device=device)
    if cfg.post_norm:
        p["post_norm1"] = L.init_norm(cfg, device=device)
        p["post_norm2"] = L.init_norm(cfg, device=device)
    return p


def _generator(seed: int, device: torch.device) -> torch.Generator:
    # the meta device draws nothing: any generator will do
    gen = torch.Generator(device="cpu" if device.type == "meta" else device)
    gen.manual_seed(seed)
    return gen


def init_params(cfg: ModelConfig, seed: int = 0, *, device,
                generator: Optional[torch.Generator] = None):
    """Random parameters of ``cfg`` on ``device`` (required: the card, the
    CPU or the meta device, on which nothing is allocated and which
    ``models.registry`` counts), drawn from ``generator`` or a new one
    seeded with ``seed``."""
    device = torch.device(device)
    gen = generator if generator is not None else _generator(seed, device)
    dt = torch_dtype(cfg.param_dtype)
    params: Dict[str, Any] = {
        "embed": {"table": L.dense_init(gen, (cfg.vocab_size, cfg.d_model),
                                        1, dt, device)},
        "final_norm": L.init_norm(cfg, device=device),
    }
    params["blocks"] = [
        {f"b{i}": _init_block(gen, kind, cfg, device)
         for i, kind in enumerate(cfg.block_pattern)}
        for _ in range(cfg.num_periods)]
    if not cfg.tie_embeddings:
        params["unembed"] = {"table": L.dense_init(
            gen, (cfg.vocab_size, cfg.d_model), 1, dt, device)}
    if cfg.frontend == "clip_stub":
        params["frontend"] = {"proj": L.dense_init(
            gen, (CLIP_DIM, cfg.d_model), 0, dt, device)}
    if cfg.family == "encdec":
        params["encoder"] = {
            "blocks": [{"norm1": L.init_norm(cfg, device=device),
                        "attn": L.init_attention(gen, cfg, device),
                        "norm2": L.init_norm(cfg, device=device),
                        "mlp": L.init_mlp(gen, cfg, device=device)}
                       for _ in range(cfg.encoder_layers)],
            "final_norm": L.init_norm(cfg, device=device),
        }
        # per-decoder-layer cross attention
        params["cross"] = [{"norm": L.init_norm(cfg, device=device),
                            "attn": L.init_attention(gen, cfg, device)}
                           for _ in range(cfg.num_periods)]
    return params


# ---------------------------------------------------------------------------
# block forward (shared by train / prefill / decode)
# ---------------------------------------------------------------------------

def _apply_sub(x, sub_out, post_norm_p, cfg: ModelConfig):
    if cfg.post_norm and post_norm_p is not None:
        sub_out = L.norm_fwd(post_norm_p, sub_out, cfg)
    return x + sub_out


def _block_fwd(bp, kind: str, x, positions, cfg: ModelConfig, mode: str,
               cache=None, cache_len: Optional[int] = None, cross_kv=None,
               kv_layout: str = "bksd", max_len: int = 0,
               kv_update: str = "dus", kv_window: bool = False):
    """``mode``: "train" | "prefill" | "decode".  Returns (x, new_cache,
    aux_loss); aux is the MoE balance loss, 0 without MoE."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    new_cache = cache
    h = L.norm_fwd(bp["norm1"], x, cfg)
    local = kind == ATTN_LOCAL
    if kind in ATTN_KINDS:
        if mode == "train":
            y = L.attention_fwd(bp["attn"], h, positions, cfg, local=local)
        elif mode == "prefill":
            cap = max_len
            if kv_window and local and cfg.local_window:
                cap = min(max_len, cfg.local_window)
            y, new_cache = L.attention_prefill(bp["attn"], h, positions, cfg,
                                               cap, layout=kv_layout,
                                               local=local)
        else:
            win = kv_window and local and cfg.local_window is not None
            y, new_cache = L.attention_decode(
                bp["attn"], h, cache, cache_len, cfg, layout=kv_layout,
                local=local, update=kv_update, windowed=win)
    elif kind in MAMBA_KINDS:
        if mode == "decode":
            y, new_cache = M.mamba_decode(bp["mamba"], h, cache, cfg)
        elif mode == "prefill":
            y, new_cache = M.mamba_fwd(bp["mamba"], h, cfg,
                                       return_state=True)
        else:
            y = M.mamba_fwd(bp["mamba"], h, cfg)
    elif kind == RWKV:
        if mode == "train":
            y = R.rwkv_time_fwd(bp["time"], h, cfg)
        else:
            state = (None if mode == "prefill" else
                     {"shift": cache["tm_shift"], "wkv": cache["wkv"]})
            y, tm = R.rwkv_time_fwd(bp["time"], h, cfg, state=state,
                                    return_state=True)
    else:
        raise ValueError(kind)
    x = _apply_sub(x, y, bp.get("post_norm1"), cfg)

    # cross attention (encoder-decoder only)
    if cross_kv is not None:
        hc = L.norm_fwd(cross_kv["norm"], x, cfg)
        if mode == "decode":
            yc, _ = L.attention_decode(cross_kv["attn"], hc, cross_kv["kv"],
                                       cache_len, cfg, cross=True,
                                       layout="bksd")
        else:
            # cross KV is stored decode-friendly [B,K,T,Dh]; full-sequence
            # attention wants [B,T,K,Dh]
            kv = cross_kv["kv"]
            yc = L.attention_fwd(cross_kv["attn"], hc, positions, cfg,
                                 cross_kv=(kv["k"].transpose(1, 2),
                                           kv["v"].transpose(1, 2)))
        x = x + yc

    h2 = L.norm_fwd(bp["norm2"], x, cfg)
    if kind in MOE_KINDS:
        # one card: the local dispatch (the reference's all-to-all path
        # runs only under an expert-parallel mesh)
        y2, aux = L.moe_fwd(bp["moe"], h2, cfg)
    elif kind == RWKV:
        if mode == "train":
            y2 = R.rwkv_channel_fwd(bp["channel"], h2, cfg)
        else:
            state = (None if mode == "prefill" else
                     {"shift": cache["cm_shift"]})
            y2, cm = R.rwkv_channel_fwd(bp["channel"], h2, cfg, state=state,
                                        return_state=True)
            new_cache = {"tm_shift": tm["shift"], "wkv": tm["wkv"],
                         "cm_shift": cm["shift"]}
    else:
        y2 = L.mlp_fwd(bp["mlp"], h2, cfg)
    x = _apply_sub(x, y2, bp.get("post_norm2"), cfg)
    return x, new_cache, aux


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               kv_layout: str = "bksd", dtype=torch.bfloat16,
               kv_window: bool = False, *, device) -> List[Dict]:
    """Per-period caches on ``device`` (required), a list over periods: a
    KV cache per attention block, a recurrent state per Mamba or RWKV
    block.  With ``kv_window``, sliding-window layers allocate only the
    window (a ring buffer)."""
    def one_block(kind):
        if kind in ATTN_KINDS:
            cap = max_len
            if kv_window and kind == ATTN_LOCAL and cfg.local_window:
                cap = min(max_len, cfg.local_window)
            return L.init_kv_cache(cfg, batch, cap, kv_layout, dtype, device)
        if kind in MAMBA_KINDS:
            return M.init_mamba_state(cfg, batch, dtype, device=device)
        if kind == RWKV:
            return R.init_rwkv_state(cfg, batch, dtype, device=device)
        raise ValueError(kind)

    return [{f"b{i}": one_block(k) for i, k in enumerate(cfg.block_pattern)}
            for _ in range(cfg.num_periods)]


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig):
    e = params["embed"]["table"][tokens]
    if cfg.tie_embeddings:          # gemma-style scaled embeddings
        # the scale is rounded to the table's dtype first (transformer.py:339:
        # jnp.asarray(d ** 0.5, e.dtype)): sqrt(4608) is 68.0 in bf16
        e = e * torch.tensor(cfg.d_model ** 0.5, dtype=e.dtype)
    return e


def unembed_table(params, cfg: ModelConfig) -> torch.Tensor:
    return (params["embed"]["table"] if cfg.tie_embeddings
            else params["unembed"]["table"])


def logits_fwd(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """float32 logits.  The reference's product has fp32 results of bf16
    operands (transformer.py:351): ``layers.f32_matmul``, which on the card
    reads the bf16 table as it lies (no float32 copy of it)."""
    t = unembed_table(params, cfg)
    lg = L.f32_matmul(h, t.T)
    return L.softcap(lg, cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# full forward passes
# ---------------------------------------------------------------------------

def _encoder_fwd(params, frames: torch.Tensor, cfg: ModelConfig):
    """Whisper encoder: frames [B,T,D] (stub embeddings) -> [B,T,D];
    bidirectional, no RoPE."""
    B, T, _ = frames.shape
    H, K, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mask = torch.ones((T, T), dtype=torch.bool, device=frames.device)
    x = frames
    for bp in params["encoder"]["blocks"]:
        h = L.norm_fwd(bp["norm1"], x, cfg)
        q = L.mm(h, bp["attn"]["wq"]).reshape(B, T, H, Dh)
        k = L.mm(h, bp["attn"]["wk"]).reshape(B, T, K, Dh)
        v = L.mm(h, bp["attn"]["wv"]).reshape(B, T, K, Dh)
        o = L._sdpa(q, k, v, mask, cfg).reshape(B, T, cfg.q_dim)
        x = x + L.mm(o, bp["attn"]["wo"])
        h2 = L.norm_fwd(bp["norm2"], x, cfg)
        x = x + L.mlp_fwd(bp["mlp"], h2, cfg)
    return L.norm_fwd(params["encoder"]["final_norm"], x, cfg)


def _cross_kv_from_encoder(params, enc_out: torch.Tensor,
                           cfg: ModelConfig) -> List[Dict]:
    """Per-decoder-layer cross K/V, a list over periods, each stored in the
    decode-friendly bksd layout [B,K,T,Dh]."""
    B, T, _ = enc_out.shape
    K, Dh = cfg.num_kv_heads, cfg.head_dim
    out = []
    for cp in params["cross"]:
        k = L.mm(enc_out, cp["attn"]["wk"]).reshape(B, T, K, Dh)
        v = L.mm(enc_out, cp["attn"]["wv"]).reshape(B, T, K, Dh)
        out.append({"k": k.transpose(1, 2).contiguous(),
                    "v": v.transpose(1, 2).contiguous()})
    return out


def _front(params, tokens, cfg: ModelConfig, embeds):
    """Token embeddings, with the CLIP-stub prefix prepended (VLM)."""
    x = embed_tokens(params, tokens, cfg)
    if embeds is not None and cfg.frontend == "clip_stub":
        pe = L.mm(embeds, params["frontend"]["proj"]).to(x.dtype)
        x = torch.cat([pe, x], dim=1)
    return x


def _cross(params, cfg: ModelConfig, frames):
    if cfg.family != "encdec":
        return None
    return _cross_kv_from_encoder(params, _encoder_fwd(params, frames, cfg),
                                  cfg)


def _cross_at(params, cross, p_i: int):
    if cross is None:
        return None
    c = params["cross"][p_i]
    return {"norm": c["norm"], "attn": c["attn"], "kv": cross[p_i]}


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


def forward(params, tokens: torch.Tensor, positions: torch.Tensor,
            cfg: ModelConfig, *, embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None):
    """Teacher-forced forward -> (final hidden states [B,S,D], aux).

    ``embeds``: optional [B,T_front,CLIP_DIM] stubbed patch embeddings
    (VLM), prepended to the token embeddings.  ``frames``: optional
    [B,T_enc,D] stubbed audio frames (enc-dec).  aux: the MoE balance
    loss summed over the layers and divided by ``cfg.num_layers``."""
    x = _front(params, tokens, cfg, embeds)
    B, S, _ = x.shape
    if positions.shape[1] != S:
        positions = _positions(B, S, x.device)
    cross = _cross(params, cfg, frames)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p_i, period in enumerate(params["blocks"]):
        for i, kind in enumerate(cfg.block_pattern):
            x, _, a = _block_fwd(period[f"b{i}"], kind, x, positions, cfg,
                                 "train", cross_kv=_cross_at(params, cross,
                                                             p_i))
            aux = aux + a
    x = L.norm_fwd(params["final_norm"], x, cfg)
    return x, aux / cfg.num_layers


def prefill(params, tokens: torch.Tensor, cfg: ModelConfig, max_len: int, *,
            kv_layout: str = "bksd", embeds: Optional[torch.Tensor] = None,
            frames: Optional[torch.Tensor] = None, kv_window: bool = False):
    """Process a prompt: (last-token logits [B,V] float32, cache (a list
    over periods), encoder cross K/V or None)."""
    x = _front(params, tokens, cfg, embeds)
    B, S, _ = x.shape
    positions = _positions(B, S, x.device)
    cross = _cross(params, cfg, frames)
    cache = []
    for p_i, period in enumerate(params["blocks"]):
        caches = {}
        for i, kind in enumerate(cfg.block_pattern):
            x, caches[f"b{i}"], _ = _block_fwd(
                period[f"b{i}"], kind, x, positions, cfg, "prefill",
                kv_layout=kv_layout, max_len=max_len,
                cross_kv=_cross_at(params, cross, p_i), kv_window=kv_window)
        cache.append(caches)
    x = L.norm_fwd(params["final_norm"], x, cfg)
    logits = logits_fwd(params, x[:, -1:, :], cfg)[:, 0]
    return logits, cache, cross


def decode_step(params, cache: List[Dict], token: torch.Tensor,
                cache_len: int, cfg: ModelConfig, *,
                kv_layout: str = "bksd", cross: Optional[List[Dict]] = None,
                kv_update: str = "dus", kv_window: bool = False):
    """One decode step.  token: [B,1] int; cache_len: tokens already in
    the cache.  Returns (logits [B,V] float32, new cache); a "dus" update
    writes the given cache in place."""
    x = embed_tokens(params, token, cfg)
    new_cache = []
    for p_i, (period, pc) in enumerate(zip(params["blocks"], cache)):
        new_pc = {}
        for i, kind in enumerate(cfg.block_pattern):
            x, new_pc[f"b{i}"], _ = _block_fwd(
                period[f"b{i}"], kind, x, None, cfg, "decode",
                cache=pc[f"b{i}"], cache_len=cache_len, kv_layout=kv_layout,
                cross_kv=_cross_at(params, cross, p_i), kv_update=kv_update,
                kv_window=kv_window)
        new_cache.append(new_pc)
    x = L.norm_fwd(params["final_norm"], x, cfg)
    logits = logits_fwd(params, x[:, 0, :], cfg)
    return logits, new_cache
