"""Step functions (``repro/train/steps.py``): prefill_step / decode_step.

The factories close over (cfg, parallel, shape) and return plain functions
run under ``torch.inference_mode`` (a decode step writes its cache in
place, so the prefill's cache must be an inference tensor too).  One card
has no mesh: the reference's sharding context is gone, and the cache write
is the reference's choice at a model-axis size of 1.  ``make_train_step``
waits for the LM training slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ModelConfig, parallel: ParallelConfig,
                      shape: ShapeConfig, kv_layout: str = "bksd"):
    @torch.inference_mode()
    def prefill_step(params, batch):
        logits, cache, cross = T.prefill(
            params, batch["tokens"], cfg, max_len=shape.seq_len,
            kv_layout=kv_layout, embeds=batch.get("embeds"),
            frames=batch.get("frames"), kv_window=parallel.window_kv_cache)
        if cross is None:
            return logits, cache
        return logits, cache, cross

    return prefill_step


def make_decode_step(cfg: ModelConfig, parallel: ParallelConfig,
                     kv_layout: str = "bksd", with_cross: bool = False):
    # the reference picks "dus" where the KV heads divide over the model
    # axis (steps.py:144): always, on one device
    kv_update = "dus"

    if with_cross:
        @torch.inference_mode()
        def decode_step(params, cache, token, cache_len, cross):
            return T.decode_step(params, cache, token, cache_len, cfg,
                                 kv_layout=kv_layout, cross=cross,
                                 kv_update=kv_update,
                                 kv_window=parallel.window_kv_cache)
        return decode_step

    @torch.inference_mode()
    def decode_step(params, cache, token, cache_len):
        return T.decode_step(params, cache, token, cache_len, cfg,
                             kv_layout=kv_layout, kv_update=kv_update,
                             kv_window=parallel.window_kv_cache)

    return decode_step
