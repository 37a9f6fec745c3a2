"""RWKV-6 "Finch" block (``repro/models/rwkv.py``): time mixing with
data-dependent decay, and the channel mix.

ddlerp token shift with low-rank data-dependent mixes, per-channel decay
w_t, bonus u, a per-head WKV state [N_key, N_value] kept in float32,
group norm over heads, gated output; squared-ReLU channel mix.  The WKV
recurrence is either the sequential scan (a loop over S; the reference
scans it in chunks for remat only) or the chunk-parallel form
(``cfg.rwkv_chunked``), whose chunks change the arithmetic.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.nn import functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import _dtype, dense_init, mm

LORA_R = 32     # low-rank size of the ddlerp / decay adapters
GATE_R = 64


def _heads(cfg: ModelConfig):
    N = cfg.rwkv_head_dim
    return cfg.d_model // N, N


def init_rwkv_time(gen: torch.Generator, cfg: ModelConfig, device):
    dt = _dtype(cfg)
    D = cfg.d_model
    H, N = _heads(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # ddlerp base mixes (mu) for x and the five streams
        "mu_x": torch.zeros((D,), **f32),
        "mu_rkvwg": torch.zeros((5, D), **f32),
        "lora_a": dense_init(gen, (D, 5 * LORA_R), 0, torch.float32, device),
        "lora_b": dense_init(gen, (5, LORA_R, D), 1, torch.float32, device),
        # decay: w = exp(-exp(w0 + tanh(xw @ wa) @ wb))
        "w0": torch.full((D,), -6.0, **f32),
        "wa": dense_init(gen, (D, GATE_R), 0, torch.float32, device),
        "wb": dense_init(gen, (GATE_R, D), 0, torch.float32, device),
        "u": torch.zeros((H, N), **f32),                  # bonus
        "wr": dense_init(gen, (D, D), 0, dt, device),
        "wk": dense_init(gen, (D, D), 0, dt, device),
        "wv": dense_init(gen, (D, D), 0, dt, device),
        "wg": dense_init(gen, (D, D), 0, dt, device),
        "wo": dense_init(gen, (D, D), 0, dt, device),
        "ln_scale": torch.ones((D,), **f32),              # group norm
        "ln_bias": torch.zeros((D,), **f32),
    }


def init_rwkv_channel(gen: torch.Generator, cfg: ModelConfig, device):
    dt = _dtype(cfg)
    D, F_ = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.zeros((D,), dtype=torch.float32, device=device),
        "mu_r": torch.zeros((D,), dtype=torch.float32, device=device),
        "wk": dense_init(gen, (D, F_), 0, dt, device),
        "wv": dense_init(gen, (F_, D), 0, dt, device),
        "wr": dense_init(gen, (D, D), 0, dt, device),
    }


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor]):
    """sx[t] = x[t-1]; last: [B,1,D] carried context (None: zeros)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def _ddlerp(p, x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """Data-dependent lerp producing the five mixed streams [5,B,S,D]
    (float32).  The shift difference is taken in the storage dtype first,
    as the reference's."""
    dx = (sx - x).float()
    xf = x.float()
    xxx = xf + dx * p["mu_x"]
    lo = torch.tanh(xxx @ p["lora_a"])                 # [B,S,5R]
    B, S, _ = lo.shape
    lo = lo.reshape(B, S, 5, LORA_R)
    mix = torch.einsum("bsfr,frd->fbsd", lo, p["lora_b"])   # [5,B,S,D]
    mus = p["mu_rkvwg"][:, None, None, :]
    return xf[None] + dx[None] * (mus + mix)


def _chunks(S: int, chunk: int, *, parallel: bool):
    """The reference's chunk length c: the chunk-parallel form takes
    c = min(chunk, S) and needs c | S; the scan takes n = max(1, S //
    chunk) chunks of S // n and needs n | S."""
    if parallel:
        c = min(chunk, S)
        if S % c:
            raise ValueError(f"sequence {S} is not a multiple of the WKV "
                             f"chunk {c}")
        return c
    n = max(1, S // chunk)
    if S % n:
        raise ValueError(f"sequence {S} does not split into {n} chunks")
    return S // n


def _wkv_chunked_parallel(r, k, v, w, u, state0, chunk: int):
    """Chunk-parallel WKV: within a chunk of c tokens, with L the
    per-channel cumulative log decay,

      y_t = r_t (S_in * e^{L_{t-1}}) + sum_{s<t} (r_t e^{L_{t-1}-L_s}) k_s v_s
            + (r_t * u * k_t) v_t
      S_out = S_in * e^{L_c} + sum_s (k_s e^{L_c - L_s}) v_s

    r, k, v, w: [B,S,H,N]; u: [H,N]; state0: [B,H,N,N].  Returns
    (y [B,S,H,N], stateT), in float32."""
    S = r.shape[1]
    c = _chunks(S, chunk, parallel=True)
    # [B,S,H,N] -> [S,B,H,N], float32
    r, k, v, w = (t.float().transpose(0, 1) for t in (r, k, v, w))
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    Sm, ys = state0, []
    for s0 in range(0, S, c):
        rc, kc, vc, wc = (t[s0:s0 + c] for t in (r, k, v, w))
        logw = torch.log(torch.clamp(wc, min=1e-30))
        L = torch.cumsum(logw, dim=0)            # L_t = sum_{u<=t} log w_u
        Lprev = L - logw                         # L_{t-1} (L_0 = 0)
        r_hat = rc * torch.exp(Lprev)
        k_hat = kc * torch.exp(-L)
        # intra-chunk term: A[t,s] = sum_n r'_t k'_s (s < t)
        A = torch.einsum("tbhn,sbhn->bhts", r_hat, k_hat)
        A = torch.where(mask, A, 0.0)
        y_intra = torch.einsum("bhts,sbhm->tbhm", A, vc)
        y_diag = (rc * u * kc).sum(-1, keepdim=True) * vc   # bonus term
        y_state = torch.einsum("tbhn,bhnm->tbhm", r_hat, Sm)
        Lc = L[-1]                                # [B,H,N]
        k_tail = kc * torch.exp(Lc[None] - L)     # k_s e^{L_c - L_s}
        Sm = Sm * torch.exp(Lc)[..., None] + \
            torch.einsum("sbhn,sbhm->bhnm", k_tail, vc)
        ys.append(y_intra + y_diag + y_state)
    return torch.cat(ys).transpose(0, 1), Sm


def _wkv_scan(r, k, v, w, u, state0, chunk: int):
    """The sequential WKV recurrence.  r, k, v: [B,S,H,N]; w: [B,S,H,N]
    decay in (0,1); u: [H,N]; state0: [B,H,N,N].  Returns (y [B,S,H,N],
    stateT), in float32."""
    S = r.shape[1]
    _chunks(S, chunk, parallel=False)
    r, k, v, w = (t.float() for t in (r, k, v, w))
    ub = u[..., :, None]
    Sm, ys = state0, []
    for t in range(S):
        a = k[:, t, ..., :, None] * v[:, t, ..., None, :]  # [B,H,N,N]
        ys.append(torch.einsum("bhn,bhnm->bhm", r[:, t], Sm + ub * a))
        Sm = w[:, t, ..., :, None] * Sm + a
    return torch.stack(ys, 1), Sm


def _group_norm(p, y: torch.Tensor, H: int, N: int, eps: float = 1e-5):
    """Per-head layer norm (RWKV's ``ln_x``) with the population variance.
    y: [B,S,H,N] -> [B,S,H*N]."""
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    yn = (y - mu) * torch.rsqrt(var + eps)
    B, S = y.shape[:2]
    return yn.reshape(B, S, H * N) * p["ln_scale"] + p["ln_bias"]


def _time_inputs(p, x: torch.Tensor, cfg: ModelConfig,
                 shift: Optional[torch.Tensor] = None):
    """The time mix's WKV inputs r, k, v [B,S,H,N] (storage dtype) and
    decay w [B,S,H,N] (float32), and its gate g [B,S,D]."""
    B, S, _ = x.shape
    H, N = _heads(cfg)
    xr, xk, xv, xw, xg = _ddlerp(p, x, _token_shift(x, shift))
    r = mm(xr.to(x.dtype), p["wr"]).reshape(B, S, H, N)
    k = mm(xk.to(x.dtype), p["wk"]).reshape(B, S, H, N)
    v = mm(xv.to(x.dtype), p["wv"]).reshape(B, S, H, N)
    g = F.silu(mm(xg.to(x.dtype), p["wg"]))
    w = torch.exp(-torch.exp(p["w0"] + torch.tanh(xw @ p["wa"]) @ p["wb"]))
    return r, k, v, w.reshape(B, S, H, N), g


def rwkv_time_fwd(p, x: torch.Tensor, cfg: ModelConfig, *, chunk: int = 128,
                  state: Optional[dict] = None, return_state: bool = False):
    """x: [B,S,D] -> [B,S,D].  state: {"shift": [B,1,D] (storage dtype),
    "wkv": [B,H,N,N] (float32)}."""
    B = x.shape[0]
    H, N = _heads(cfg)
    r, k, v, w, g = _time_inputs(p, x, cfg,
                                 None if state is None else state["shift"])
    s0 = (torch.zeros((B, H, N, N), dtype=torch.float32, device=x.device)
          if state is None else state["wkv"].float())
    scan = _wkv_chunked_parallel if cfg.rwkv_chunked else _wkv_scan
    y, sT = scan(r, k, v, w, p["u"], s0, chunk)
    y = _group_norm(p, y, H, N).to(x.dtype)
    out = mm(y * g, p["wo"])
    if return_state:
        return out, {"shift": x[:, -1:], "wkv": sT}
    return out


def rwkv_channel_fwd(p, x: torch.Tensor, cfg: ModelConfig, *,
                     state: Optional[dict] = None,
                     return_state: bool = False):
    sx = _token_shift(x, None if state is None else state["shift"])
    dx = (sx - x).float()
    xf = x.float()
    xk = (xf + dx * p["mu_k"]).to(x.dtype)
    xr = (xf + dx * p["mu_r"]).to(x.dtype)
    h = torch.square(F.relu(mm(xk, p["wk"])))
    out = torch.sigmoid(mm(xr, p["wr"])) * mm(h, p["wv"])
    if return_state:
        return out, {"shift": x[:, -1:]}
    return out


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, *,
                    device):
    H, N = _heads(cfg)
    return {
        "tm_shift": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                                device=device),
        "cm_shift": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                                device=device),
        "wkv": torch.zeros((batch, H, N, N), dtype=torch.float32,
                           device=device),
    }
