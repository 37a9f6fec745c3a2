"""The LM server (``repro/launch/serve.py``): batched prefill + greedy
decode with a laid-out KV cache, on the card.

One static batch per ``run`` call: every admitted request prefills
together (prompts left-padded with token 0, no padding mask, as the
reference's), then decodes in lockstep.  The KV-cache layout is chosen by
``perfmodel.select_kv_layout`` per run, from the ACTUAL number of admitted
requests (the selector's update-vs-read arbitration depends on the batch)
on the port's device profile (the H100's); the decode step is built once
per distinct layout and reused.  A model with no KV cache
(rwkv6's recurrent states) picks a layout all the same, as the
reference's server does; it reads none.

The device is the card unless the caller passes one (``device="cpu"``
runs the same code on the CPU, as the tests do); with no CUDA device and
none given the server raises.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_7b
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ParallelConfig, get_config, reduced_config
from repro_torch.dtypes import canon_dtype, dtype_bytes
from repro_torch.launch.cnn_serve import resolve_device
from repro_torch.models import transformer as T
from repro_torch.perfmodel import select_kv_layout
from repro_torch.train.steps import make_decode_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                # [S] int32
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)


class Server:
    """``periods`` cuts the stack to that many periods (depth only: every
    width stays); ``dtype`` overrides the config's compute and parameter
    dtypes ("float32" runs the whole model in float32)."""

    def __init__(self, arch: str, *, reduced: bool = True, batch: int = 4,
                 max_len: int = 256, device=None, kv_layout: str = "auto",
                 seed: int = 0, periods: Optional[int] = None,
                 dtype: Optional[str] = None):
        cfg = get_config(arch)
        if reduced:
            cfg = reduced_config(cfg, periods or 2)
        elif periods:
            cfg = cfg.replace(num_layers=periods * len(cfg.block_pattern))
        if dtype is not None:
            cfg = cfg.replace(dtype=canon_dtype(dtype),
                              param_dtype=canon_dtype(dtype))
        self.cfg = cfg
        self.device = resolve_device(device)
        self.batch = batch                 # admission capacity, not the
        self.max_len = max_len             # layout-selection batch
        self._kv_mode = kv_layout          # "auto" | a forced layout
        self.kv_layout: Optional[str] = (None if kv_layout == "auto"
                                         else kv_layout)
        # the VLM's stub patch tokens stand before the prompt
        self.front = cfg.frontend_tokens if cfg.frontend else 0
        self.parallel = ParallelConfig(fsdp=False, seq_shard_saved=False)
        self._decode_by_layout: Dict[str, object] = {}
        # per step of the last run(keep_logits=True): prefill's logits,
        # then each decode step's, [B, V] float32 on the device
        self.logits: List[torch.Tensor] = []
        self.params = T.init_params(cfg, seed=seed, device=self.device)

    def _layout_for(self, B: int) -> str:
        """KV layout for an ACTUAL batch of ``B`` requests (the selector's
        update-waste term scales with B*K)."""
        if self._kv_mode != "auto":
            return self._kv_mode
        return select_kv_layout(B, self.cfg.num_kv_heads, self.max_len,
                                self.cfg.head_dim,
                                dtype_bytes=dtype_bytes(self.cfg.dtype))

    def _decode_for(self, layout: str):
        """Decode step, built once per distinct KV layout and reused."""
        if layout not in self._decode_by_layout:
            self._decode_by_layout[layout] = make_decode_step(
                self.cfg, self.parallel, layout,
                with_cross=self.cfg.family == "encdec")
        return self._decode_by_layout[layout]

    def stubs(self, B: int) -> Dict[str, torch.Tensor]:
        """The zero frontend inputs the reference's server feeds: CLIP-stub
        patch embeddings (VLM) and audio frames (enc-dec), in bf16."""
        cfg, kw = self.cfg, {}
        if cfg.frontend == "clip_stub":
            kw["embeds"] = torch.zeros((B, cfg.frontend_tokens, T.CLIP_DIM),
                                       dtype=torch.bfloat16,
                                       device=self.device)
        if cfg.family == "encdec":
            kw["frames"] = torch.zeros((B, cfg.encoder_seq, cfg.d_model),
                                       dtype=torch.bfloat16,
                                       device=self.device)
        return kw

    @staticmethod
    def pad(requests: List[Request]) -> np.ndarray:
        """The prompts left-padded with token 0 to the longest, [B, S0]
        int32 (no padding mask, as the reference's)."""
        S0 = max(len(r.prompt) for r in requests)
        prompts = np.zeros((len(requests), S0), np.int32)
        for i, r in enumerate(requests):
            prompts[i, S0 - len(r.prompt):] = r.prompt
        return prompts

    @torch.inference_mode()
    def prefill(self, prompts: np.ndarray, kv_layout: str):
        """prompts: [B, S0] -> (logits [B, V] float32, cache, cross).  The
        first decode step then writes cache slot ``S0 + self.front``."""
        tokens = torch.from_numpy(prompts).to(self.device)
        return T.prefill(self.params, tokens, self.cfg, max_len=self.max_len,
                         kv_layout=kv_layout, **self.stubs(prompts.shape[0]))

    def decode(self, kv_layout: str, cache, tok: torch.Tensor,
               cache_len: int, cross=None):
        """One decode step of tokens ``tok`` [B, 1] in ``kv_layout`` ->
        (logits [B, V] float32, cache)."""
        step = self._decode_for(kv_layout)
        args = (self.params, cache, tok, cache_len)
        return step(*args) if cross is None else step(*args, cross)

    @torch.inference_mode()
    def run(self, requests: List[Request], greedy: bool = True,
            keep_logits: bool = False, kv_layout: Optional[str] = None):
        """One static batch of generation; returns {rid: token list}.
        ``keep_logits`` keeps each step's logits in ``self.logits``;
        ``kv_layout`` overrides the server's layout for this run."""
        if len(requests) > self.batch:
            raise ValueError(f"{len(requests)} requests exceed the batch "
                             f"capacity {self.batch}")
        kv_layout = kv_layout or self._layout_for(len(requests))
        self.kv_layout = kv_layout         # last-used, for reporting
        prompts = self.pad(requests)
        logits, cache, cross = self.prefill(prompts, kv_layout)
        self.logits = [logits] if keep_logits else []
        pos = prompts.shape[1] + self.front
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        for t in range(max(r.max_new for r in requests)):
            toks = tok.tolist()
            for i, r in enumerate(requests):
                if t < r.max_new:
                    r.out.append(toks[i])
            logits, cache = self.decode(kv_layout, cache, tok[:, None],
                                        pos + t, cross)
            if keep_logits:
                self.logits.append(logits)
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return {r.rid: r.out for r in requests}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2_7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA device (cpu: the plain run)")
    args = ap.parse_args()
    srv = Server(args.arch, reduced=True, batch=args.batch,
                 max_len=args.max_len, device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, srv.cfg.vocab_size, size=(8 + i,),
                                    dtype=np.int32), max_new=8)
            for i in range(args.requests)]
    t0 = time.time()
    out = srv.run(reqs)
    if srv.device.type == "cuda":
        torch.cuda.synchronize(srv.device)
    dt = time.time() - t0
    n_tok = sum(len(v) for v in out.values())
    print(f"device={srv.device} kv_layout={srv.kv_layout} generated "
          f"{n_tok} tokens in {dt:.2f}s ({n_tok/dt:.1f} tok/s)")
    for rid, toks in out.items():
        print(f"  req {rid}: {toks}")


if __name__ == "__main__":
    main()
