"""Mamba (S6) mixer for the Jamba hybrid (``repro/models/mamba.py``).

Selective state-space model with input-dependent (dt, B, C).  The
recurrence runs in float32 as the reference's does.  The reference scans
it in chunks so that only chunk-boundary states are saved (remat) and
shards its carry over a mesh; one card serving needs neither, so here a
chunk bounds only the memory of its precomputed [B, c, d_inner, d_state]
decay and input terms, and a loop walks its steps.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dtype, dense_init, mm


def dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def init_mamba(gen: torch.Generator, cfg: ModelConfig, device):
    dt = _dtype(cfg)
    D, dI = cfg.d_model, cfg.mamba_d_inner
    dS, dC = cfg.mamba_d_state, cfg.mamba_d_conv
    R = dt_rank(cfg)
    # S4D-real initialization for A
    A = torch.arange(1, dS + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(dI, 1)
    return {
        "in_proj": dense_init(gen, (D, 2 * dI), 0, dt, device),
        "conv_w": dense_init(gen, (dC, dI), 0, torch.float32, device),
        "conv_b": torch.zeros((dI,), dtype=torch.float32, device=device),
        "x_proj": dense_init(gen, (dI, R + 2 * dS), 0, dt, device),
        "dt_proj_w": dense_init(gen, (R, dI), 0, torch.float32, device),
        "dt_proj_b": torch.full((dI,), math.log(math.e - 1) * 0.01,
                                dtype=torch.float32, device=device),
        "A_log": torch.log(A),
        "D": torch.ones((dI,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, (dI, D), 0, dt, device),
    }


def _ssm_inputs(p, u: torch.Tensor, cfg: ModelConfig):
    """u: [B,S,dI] post-conv activations -> (dt [B,S,dI], Bm [B,S,dS], Cm),
    all float32."""
    dS, R = cfg.mamba_d_state, dt_rank(cfg)
    proj = mm(u, p["x_proj"])                                 # [B,S,R+2dS]
    dt_r, Bm, Cm = torch.split(proj, [R, dS, dS], dim=-1)
    dt = F.softplus(dt_r.float() @ p["dt_proj_w"] + p["dt_proj_b"])
    return dt, Bm.float(), Cm.float()


def _scan_chunked(dt, Bm, Cm, u, A, h0, chunk: int):
    """The SSM recurrence in float32.  dt, u: [B,S,dI]; Bm, Cm: [B,S,dS];
    A (``A_log``): [dI,dS]; h0: [B,dI,dS].  Returns (y [B,S,dI], hT).

    The reference's n = max(1, S // chunk) chunks of c = S // n steps,
    with its condition that they tile S."""
    S = u.shape[1]
    n = max(1, S // chunk)
    if S % n:
        raise ValueError(f"sequence {S} does not split into {n} chunks")
    c = S // n
    neg_a = -torch.exp(A)
    dt, u = dt.float(), u.float()
    h, ys = h0, []
    for s0 in range(0, S, c):
        dt_c = dt[:, s0:s0 + c]
        dA = torch.exp(dt_c[..., None] * neg_a)               # [B,c,dI,dS]
        dBu = (dt_c * u[:, s0:s0 + c])[..., None] * Bm[:, s0:s0 + c, None]
        hs = []
        for i in range(c):
            h = dA[:, i] * h + dBu[:, i]
            hs.append(h)
        ys.append(torch.einsum("bcds,bcs->bcd", torch.stack(hs, 1),
                               Cm[:, s0:s0 + c]))
    return torch.cat(ys, 1), h


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along S in float32.  u: [B,S,dI]; w: [dC,dI];
    state: [B,dC-1,dI] trailing context (decode, prefill continuation).
    Returns (y, new state)."""
    dC, S = w.shape[0], u.shape[1]
    uf = u.float()
    if state is None:
        pad = uf.new_zeros((u.shape[0], dC - 1, u.shape[2]))
    else:
        pad = state.float()
    x = torch.cat([pad, uf], dim=1)                    # [B, S+dC-1, dI]
    y = sum(x[:, i:i + S, :] * w[i] for i in range(dC))
    new_state = x[:, -(dC - 1):, :] if dC > 1 else torch.zeros_like(pad)
    return y + b, new_state


def mamba_fwd(p, x: torch.Tensor, cfg: ModelConfig, *, chunk: int = 256,
              state: Optional[dict] = None, return_state: bool = False):
    """Full-sequence mamba mixer.  x: [B,S,D] -> [B,S,D].

    ``state`` (optional): {"conv": [B,dC-1,dI], "ssm": [B,dI,dS]} carried
    across segments; returned updated when ``return_state``."""
    B = x.shape[0]
    dI, dS = cfg.mamba_d_inner, cfg.mamba_d_state
    u, z = mm(x, p["in_proj"]).chunk(2, dim=-1)        # [B,S,dI] each
    u_c, new_conv = _causal_conv(u, p["conv_w"], p["conv_b"],
                                 None if state is None else state["conv"])
    u_c = F.silu(u_c).to(x.dtype)
    dt, Bm, Cm = _ssm_inputs(p, u_c, cfg)
    h0 = (torch.zeros((B, dI, dS), dtype=torch.float32, device=x.device)
          if state is None else state["ssm"].float())
    y, hT = _scan_chunked(dt, Bm, Cm, u_c, p["A_log"], h0, chunk)
    y = y + u_c.float() * p["D"]
    y = (y * F.silu(z.float())).to(x.dtype)
    out = mm(y, p["out_proj"])
    if return_state:
        return out, {"conv": new_conv.to(x.dtype), "ssm": hT}
    return out


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, *,
                     device):
    dI, dS, dC = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.mamba_d_conv
    return {"conv": torch.zeros((batch, dC - 1, dI), dtype=dtype,
                                device=device),
            "ssm": torch.zeros((batch, dI, dS), dtype=torch.float32,
                               device=device)}


def mamba_decode(p, x: torch.Tensor, state, cfg: ModelConfig):
    """Single-token decode.  x: [B,1,D] -> ([B,1,D], new state)."""
    u, z = mm(x, p["in_proj"]).chunk(2, dim=-1)        # [B,1,dI]
    u_c, new_conv = _causal_conv(u, p["conv_w"], p["conv_b"], state["conv"])
    u_c = F.silu(u_c).to(x.dtype)
    dt, Bm, Cm = _ssm_inputs(p, u_c, cfg)
    dt0, B0, C0, u0 = dt[:, 0], Bm[:, 0], Cm[:, 0], u_c[:, 0].float()
    dA = torch.exp(dt0[..., None] * -torch.exp(p["A_log"]))
    dBu = (dt0 * u0)[..., None] * B0[:, None, :]
    h = dA * state["ssm"] + dBu
    y = torch.einsum("bds,bs->bd", h, C0) + u0 * p["D"]
    y = (y * F.silu(z[:, 0].float())).to(x.dtype)
    out = mm(y, p["out_proj"])[:, None, :]
    return out, {"conv": new_conv.to(x.dtype), "ssm": h}
