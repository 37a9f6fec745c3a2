"""The paper's CNN layer and network descriptors.

``ConvSpec`` and ``CNNConfig`` mirror ``repro/configs/base.py`` field for
field, and keep the same class names: ``serve.plan_cache.network_id``
hashes ``repr(cfg.layers)``, so a plan file written by either package
resolves in the other only while the two reprs agree letter for letter.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple


@dataclass(frozen=True)
class ConvSpec:
    name: str
    kind: str                      # conv | pool | fc | softmax | relu | lrn |
                                   # flatten | add | concat | upsample
    out_channels: int = 0
    kernel: int = 0                # also: upsample factor for kind="upsample"
    stride: int = 1
    pad: int = 0
    pool_op: str = "max"           # max | avg
    fc_out: int = 0
    # Graph edges: names of the producer layers this layer consumes.  Empty
    # means "the previous layer".  ``repr=False`` keeps the linear
    # ``network_id`` fingerprints independent of it; the edge structure is
    # fingerprinted separately (only when present).
    inputs: Tuple[str, ...] = field(default=(), repr=False)


@dataclass(frozen=True)
class CNNConfig:
    name: str
    batch: int
    in_channels: int
    image_hw: int
    num_classes: int
    layers: Tuple[ConvSpec, ...]

    def replace(self, **kw) -> "CNNConfig":
        return dataclasses.replace(self, **kw)
