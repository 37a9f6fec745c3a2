"""Plan cache: one fused plan per (network, batch bucket, dtype, policy,
stack policy).

The CHWN/NCHW choice is batch-dependent (paper §IV.A, the Nt threshold),
so a server keeps one plan per pow-2 batch bucket and pads each admitted
batch up to its bucket; conv/pool/fc/softmax are row-independent, so the
padded rows never touch the real ones.

The port has no planner yet.  Its ``PlanCache`` reads the plan-cache JSON
that the reference's ``repro.serve.plan_cache.PlanCache.save`` writes
(versions 1 and 2) and serves what is in it: the fused plans
(``fused_plan``) and the unfused executor's layout assignments
(``assignment``).  A key that is in the file is a hit, a key that is not
raises ``PlanMissError``.  This is the reference's warm-restart path, where
``planner_calls`` stays 0.  What else the file carries (threshold rows) is
kept verbatim so ``save`` writes it back unchanged.  The plan files
packaged with the port are in ``repro_torch/plans/`` (``packaged_plans``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import CNNConfig
from repro_torch.core.selector import Assignment, FusedOp, FusedPlan
from repro_torch.dtypes import DEFAULT_DTYPE, canon_dtype
from repro_torch.runtime.resilience import (CorruptStateError,
                                            atomic_json_dump,
                                            verify_checksum)

# the parts of a plan-cache file this port does not use; they are carried
# through load -> save unchanged
_PASSTHROUGH = ("max_entries", "thresholds", "thresholds_hw")

PLANS_DIR = Path(__file__).resolve().parents[1] / "plans"


def packaged_plans(network: str) -> Path:
    """The plan file packaged for ``network`` (it may not exist)."""
    return PLANS_DIR / f"{network}.plans.json"


class PlanMissError(KeyError):
    """The cache holds no plan for the key, and the port cannot plan one."""


def bucket_for(batch: int, *, min_bucket: int = 1,
               max_bucket: Optional[int] = None) -> int:
    """Smallest pow-2 bucket >= ``batch`` (clamped below by ``min_bucket``).

    Raises when the batch exceeds ``max_bucket``: admission control must
    split oversized batches *before* bucketing, padding can't help there.
    """
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    b = max(min_bucket, 1 << (batch - 1).bit_length())
    if max_bucket is not None and b > max_bucket:
        if batch <= max_bucket:
            return max_bucket           # min(pow2, cap): cap is the bucket
        raise ValueError(
            f"batch {batch} exceeds max_bucket {max_bucket}; split the "
            "admission before bucketing")
    return b


def pad_to_bucket(x_nchw: torch.Tensor, bucket: int) -> torch.Tensor:
    """Zero-pad the batch (leading) dim up to ``bucket`` rows."""
    B = x_nchw.shape[0]
    if B > bucket:
        raise ValueError(f"batch {B} larger than bucket {bucket}")
    if B == bucket:
        return x_nchw
    # F.pad lists (before, after) pairs from the LAST dim backwards
    return F.pad(x_nchw, [0, 0] * (x_nchw.dim() - 1) + [0, bucket - B])


def network_id(cfg: CNNConfig) -> str:
    """Cache identity of a network: the name plus a fingerprint of its
    layer structure (a reduced 96px "alexnet" must not collide with the
    full 227px one).  Graph edges are folded in only when some layer
    carries them.  Same digest as the reference's ``network_id``."""
    desc = repr((cfg.name, cfg.in_channels, cfg.image_hw, cfg.num_classes,
                 cfg.layers))
    edges = tuple((s.name, s.inputs) for s in cfg.layers if s.inputs)
    if edges:
        desc += repr(edges)
    return f"{cfg.name}@{hashlib.sha1(desc.encode()).hexdigest()[:10]}"


@dataclass(frozen=True)
class PlanKey:
    network: str                       # network_id(), not the bare name
    bucket: int                        # per-shard batch bucket
    dtype: str                         # canonical storage dtype name
    training: bool
    policy: str = "uniform"            # "uniform" | "mixed"
    stack: str = "auto"                # "auto" | "off"
    devices: int = 1                   # data-parallel mesh width

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        # defaults are omitted, as the reference writes them
        if d.get("stack") == "auto":
            d.pop("stack")
        if d.get("devices") == 1:
            d.pop("devices")
        return d


def _plan_from_obj(obj: Dict) -> FusedPlan:
    return FusedPlan(layouts=list(obj["layouts"]),
                     ops=[FusedOp(**op) for op in obj["ops"]],
                     transforms=list(obj["transforms"]),
                     total_s=obj["total_s"], fused_bytes=obj["fused_bytes"],
                     unfused_bytes=obj["unfused_bytes"],
                     dtypes=list(obj.get("dtypes", [])),
                     base_dtype=obj.get("base_dtype", ""),
                     intermediate_roundtrip_bytes=obj.get(
                         "intermediate_roundtrip_bytes", 0))


def _assignment_from_obj(obj: Dict) -> Assignment:
    return Assignment(layouts=list(obj["layouts"]),
                      transforms=list(obj["transforms"]),
                      total_s=obj["total_s"],
                      dtypes=list(obj.get("dtypes", [])))


def _key_from_obj(obj: Dict) -> PlanKey:
    return PlanKey(**{**obj, "dtype": canon_dtype(obj["dtype"])})


class PlanCache:
    """Fused plans and unfused assignments by ``PlanKey``, loaded from a
    reference plan-cache file.

    ``planner_calls`` exists for the serving report's sake and stays 0:
    every plan served came from the file.  Caller-supplied
    ``min_bucket``/``max_bucket`` win over the persisted ones."""

    def __init__(self, path: Optional[str] = None, *,
                 min_bucket: Optional[int] = None,
                 max_bucket: Optional[int] = None):
        self.path = path
        self._explicit = {"min_bucket": min_bucket is not None,
                          "max_bucket": max_bucket is not None}
        self.min_bucket = 1 if min_bucket is None else min_bucket
        self.max_bucket = 256 if max_bucket is None else max_bucket
        self.planner_calls = 0
        self._fused: "OrderedDict[PlanKey, FusedPlan]" = OrderedDict()
        self._unfused: "OrderedDict[PlanKey, Assignment]" = OrderedDict()
        self._passthrough: Dict[str, Any] = {}
        if path:
            self.load(path)

    def bucket(self, batch: int) -> int:
        return bucket_for(batch, min_bucket=self.min_bucket,
                          max_bucket=self.max_bucket)

    def _key(self, cfg: CNNConfig, batch: Optional[int], dtype: str,
             training: bool, policy: str, stack: str) -> PlanKey:
        if policy not in ("uniform", "mixed"):
            raise ValueError(f"unknown dtype policy {policy!r}")
        if stack not in ("auto", "off"):
            raise ValueError(f"unknown stack policy {stack!r}")
        b = self.bucket(cfg.batch if batch is None else batch)
        return PlanKey(network_id(cfg), b, canon_dtype(dtype), training,
                       policy, stack)

    def fused_plan(self, cfg: CNNConfig, batch: Optional[int] = None, *,
                   dtype: str = DEFAULT_DTYPE, training: bool = False,
                   policy: str = "uniform", stack: str = "auto"
                   ) -> Tuple[FusedPlan, int, bool]:
        """The cached plan for ``batch``'s bucket: (plan, bucket, hit).
        The only possible outcome besides a hit is ``PlanMissError``."""
        key = self._key(cfg, batch, dtype, training, policy, stack)
        plan = self._fused.get(key)
        if plan is None:
            raise PlanMissError(
                f"no cached plan for {key} in {self.path!r}, and the port "
                "has no planner yet: write the plan with the reference's "
                "repro.serve.plan_cache.PlanCache.save")
        self._fused.move_to_end(key)     # recency order, as saved
        return plan, key.bucket, True

    def assignment(self, cfg: CNNConfig, batch: Optional[int] = None, *,
                   dtype: str = DEFAULT_DTYPE, training: bool = False,
                   policy: str = "uniform") -> Tuple[Assignment, int, bool]:
        """The cached unfused layout assignment for ``batch``'s bucket:
        (assignment, bucket, hit).  A miss raises ``PlanMissError``."""
        key = self._key(cfg, batch, dtype, training, policy, "auto")
        a = self._unfused.get(key)
        if a is None:
            raise PlanMissError(
                f"no cached unfused assignment for {key} in {self.path!r}, "
                "and the port has no planner yet: write it with the "
                "reference's repro.serve.plan_cache.PlanCache.save")
        self._unfused.move_to_end(key)
        return a, key.bucket, True

    def peek_fused(self, cfg: CNNConfig, batch: Optional[int] = None, *,
                   dtype: str = DEFAULT_DTYPE, training: bool = False,
                   policy: str = "uniform", stack: str = "auto"
                   ) -> Optional[FusedPlan]:
        """Cached plan or None; no recency refresh."""
        return self._fused.get(self._key(cfg, batch, dtype, training,
                                         policy, stack))

    # -- persistence ---------------------------------------------------------

    def to_json(self) -> Dict:
        obj = {
            "version": 2,
            "min_bucket": self.min_bucket,
            "max_bucket": self.max_bucket,
            "max_entries": self._passthrough.get("max_entries"),
            "thresholds": self._passthrough.get("thresholds", {}),
            "fused": [{"key": k.as_dict(), "plan": dataclasses.asdict(p)}
                      for k, p in self._fused.items()],
            "unfused": [{"key": k.as_dict(),
                         "plan": dataclasses.asdict(a)}
                        for k, a in self._unfused.items()],
        }
        if "thresholds_hw" in self._passthrough:
            obj["thresholds_hw"] = self._passthrough["thresholds_hw"]
        return obj

    def save(self, path: Optional[str] = None) -> str:
        """Crash-safe persist: payload checksum + fsync + atomic rename."""
        path = path or self.path
        if not path:
            raise ValueError("no cache path configured")
        atomic_json_dump(self.to_json(), path)
        self.path = path
        return path

    def load(self, path: str) -> None:
        """Load a plan-cache file.  A missing file, malformed JSON, an
        unknown version, a checksum mismatch or an entry that does not
        deserialize raises (``CorruptStateError`` for the last four)."""
        with open(path) as f:
            try:
                obj = json.load(f)
            except json.JSONDecodeError as e:
                raise CorruptStateError(f"{path}: not JSON ({e})") from e
        if not isinstance(obj, dict):
            raise CorruptStateError(f"{path}: top level is not an object")
        verify_checksum(obj, path)
        if obj.get("version") not in (1, 2):
            raise CorruptStateError(
                f"unknown plan-cache version {obj.get('version')!r} in "
                f"{path!r}")
        try:
            fused = [(_key_from_obj(ent["key"]), _plan_from_obj(ent["plan"]))
                     for ent in obj.get("fused", ())]
            unfused = [(_key_from_obj(ent["key"]),
                        _assignment_from_obj(ent["plan"]))
                       for ent in obj.get("unfused", ())]
        except (KeyError, TypeError, ValueError) as e:
            raise CorruptStateError(
                f"{path}: malformed plan entry ({e})") from e
        if not self._explicit["min_bucket"]:
            self.min_bucket = obj.get("min_bucket", self.min_bucket)
        if not self._explicit["max_bucket"]:
            self.max_bucket = obj.get("max_bucket", self.max_bucket)
        self._fused.update(fused)
        self._unfused.update(unfused)
        self._passthrough = {k: obj[k] for k in _PASSTHROUGH if k in obj}
        self.path = path
