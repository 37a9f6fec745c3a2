"""Plan cache: one fused plan per (network, batch bucket, dtype, policy,
stack policy), as ``repro/serve/plan_cache.py`` keeps them.

The CHWN/NCHW choice is batch-dependent (paper §IV.A, the Nt threshold),
so a server keeps one plan per pow-2 batch bucket and pads each admitted
batch up to its bucket; conv/pool/fc/softmax are row-independent, so the
padded rows never touch the real ones.

A key that is in the cache is a hit.  A miss plans: ``fused_plan`` runs
``plan_network_fused`` and ``assignment`` runs ``assign_layouts`` at the
bucket size and the key's dtype, policy and stack policy, priced by the
cache's cost model (the port's default, the H100 profile, unless one is
given), and counts ``planner_calls``.  ``CacheStats`` count hits and
misses over all keys and per key; ``max_entries`` bounds each plan map
with least-recently-hit eviction, and the recency order is persisted.

A data-parallel server (``distributed.cnn_mesh``) keys its plans on
``devices`` too, and on the per-shard bucket, ceil(batch / devices):
the per-shard batch is what crosses the Nt threshold or not, so a global
batch of 128 on 8 cards gets the 16-image plan.  ``devices == 1`` is left
out of the saved key, so single-card files stay as they were.

The cache reads and writes the reference's plan-cache JSON (versions 1
and 2): plans, the calibrated (Ct, Nt) threshold rows keyed by (hardware
id, dtype) that ``heuristic_layouts`` plans under, and the bounds.  A file
either package saves loads in the other.  The plan files packaged with
the port (``packaged_plans``: VGG16, AlexNet and ResNet-18 at full width,
both stack policies) were written by the reference planner.

A corrupt cache file (torn or garbage JSON, an unknown version, a
checksum mismatch, an entry that does not deserialize) is renamed aside
as ``*.corrupt``, recorded in ``corrupt_recoveries``, and the cache
starts empty, as the reference's does.  A packaged plan file is part of
the repo and is never renamed: a corrupt one raises ``CorruptStateError``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import logging
import os
from collections import OrderedDict
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import CNNConfig
from repro_torch.core.selector import Assignment, FusedOp, FusedPlan
from repro_torch.dtypes import DEFAULT_DTYPE, canon_dtype
from repro_torch.perfmodel import CostModel, DEFAULT_HARDWARE, Thresholds
from repro_torch.runtime.resilience import (CorruptStateError,
                                            atomic_json_dump, load_json,
                                            load_json_guarded,
                                            quarantine_file)

log = logging.getLogger("repro_torch.plan_cache")

PLANS_DIR = Path(__file__).resolve().parents[1] / "plans"


def packaged_plans(network: str) -> Path:
    """The plan file packaged for ``network`` (it may not exist)."""
    return PLANS_DIR / f"{network}.plans.json"


def is_packaged(path: str) -> bool:
    """True for a file in the packaged plans' directory (part of the repo:
    never renamed, never written by a server)."""
    return Path(path).resolve().parent == PLANS_DIR.resolve()


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


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


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


ThresholdsArg = Union[Thresholds, Dict[str, Thresholds], None]


class PlanCache:
    """Memoized layout planning over batch buckets, with persistence.

    ``planner_calls`` counts actual planning work: it stays flat while the
    same buckets recur.  ``thresholds`` is one ``Thresholds`` (filed as the
    float32 row) or a dict of per-dtype rows, under the unversioned
    ``DEFAULT_HARDWARE`` id; ``thresholds_for(dtype, hardware)`` reads a
    row.  ``max_entries`` bounds each plan map (fused and unfused
    separately): inserting beyond it evicts the least-recently-hit entry.
    Evicted keys keep their stats; a re-seen evicted key replans.
    ``cost_model`` prices every plan a miss makes (default: the port's
    default model, on the H100 profile).  Caller-supplied settings win
    over persisted ones."""

    def __init__(self, path: Optional[str] = None,
                 thresholds: ThresholdsArg = None, *,
                 min_bucket: Optional[int] = None,
                 max_bucket: Optional[int] = None,
                 max_entries: Optional[int] = None,
                 cost_model: Optional[CostModel] = None):
        self.path = path
        if isinstance(thresholds, Thresholds):
            thresholds = {DEFAULT_DTYPE: thresholds}
        self._thresholds: Dict[Tuple[str, str], Thresholds] = {
            (DEFAULT_HARDWARE, canon_dtype(k)): v
            for k, v in (thresholds or {}).items()}
        self._explicit = {"thresholds": set(self._thresholds),
                          "min_bucket": min_bucket is not None,
                          "max_bucket": max_bucket is not None,
                          "max_entries": max_entries is not None}
        self.min_bucket = 1 if min_bucket is None else min_bucket
        self.max_bucket = 256 if max_bucket is None else max_bucket
        if max_entries is not None and max_entries < 1:
            raise ValueError(
                f"max_entries must be >= 1 (or None for unbounded), got "
                f"{max_entries}")
        self.max_entries = max_entries          # None: unbounded
        self.cost_model = cost_model
        self.planner_calls = 0
        self.evictions = 0
        self.stats = CacheStats()
        self.per_key: Dict[PlanKey, CacheStats] = {}
        # in recency order (least-recently-hit first)
        self._fused: "OrderedDict[PlanKey, FusedPlan]" = OrderedDict()
        self._unfused: "OrderedDict[PlanKey, Assignment]" = OrderedDict()
        self.corrupt_recoveries: List[str] = []   # files renamed aside
        if path and os.path.exists(path):
            self.load(path)

    # -- thresholds ----------------------------------------------------------

    @property
    def thresholds(self) -> Optional[Thresholds]:
        """The float32 row of the unversioned hardware id."""
        return self._thresholds.get((DEFAULT_HARDWARE, DEFAULT_DTYPE))

    def thresholds_for(self, dtype: str = DEFAULT_DTYPE,
                       hardware: Optional[str] = None
                       ) -> Optional[Thresholds]:
        """Row for (``hardware``, ``dtype``); a hardware id with no row of
        its own falls back to the ``DEFAULT_HARDWARE`` row."""
        dtype = canon_dtype(dtype)
        if hardware is not None:
            row = self._thresholds.get((hardware, dtype))
            if row is not None:
                return row
        return self._thresholds.get((DEFAULT_HARDWARE, dtype))

    def set_thresholds(self, th: Thresholds, dtype: str = DEFAULT_DTYPE,
                       hardware: Optional[str] = None) -> None:
        key = (hardware or DEFAULT_HARDWARE, canon_dtype(dtype))
        self._thresholds[key] = th
        self._explicit["thresholds"].add(key)

    # -- bucketing -----------------------------------------------------------

    def bucket(self, batch: int) -> int:
        return bucket_for(batch, min_bucket=self.min_bucket,
                          max_bucket=self.max_bucket)

    def _key(self, cfg: CNNConfig, batch: Optional[int], dtype: str,
             training: bool, policy: str = "uniform",
             stack: str = "auto", devices: int = 1,
             pre_sharded: bool = False) -> PlanKey:
        if policy not in ("uniform", "mixed"):
            raise ValueError(f"unknown dtype policy {policy!r}")
        if stack not in ("auto", "off"):
            raise ValueError(f"unknown stack policy {stack!r}")
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        # the bucket is the per-shard batch's, divided by devices exactly
        # once: a pre-sharded batch is already the per-shard one
        g = cfg.batch if batch is None else batch
        b = self.bucket(g if pre_sharded else -(-g // devices))
        return PlanKey(network_id(cfg), b, canon_dtype(dtype), training,
                       policy, stack, devices)

    def _record(self, key: PlanKey, hit: bool) -> None:
        ks = self.per_key.setdefault(key, CacheStats())
        if hit:
            self.stats.hits += 1
            ks.hits += 1
        else:
            self.stats.misses += 1
            ks.misses += 1

    def _touch(self, store: OrderedDict, key: PlanKey, hit: bool) -> None:
        """Refresh recency on a hit; evict the LRU entry past the bound."""
        if hit:
            store.move_to_end(key)
            return
        if self.max_entries is not None:
            while len(store) > self.max_entries:
                store.popitem(last=False)
                self.evictions += 1

    # -- planning entry points ----------------------------------------------

    def fused_plan(self, cfg: CNNConfig, batch: Optional[int] = None, *,
                   dtype: str = DEFAULT_DTYPE, training: bool = False,
                   policy: str = "uniform", stack: str = "auto",
                   devices: int = 1, pre_sharded: bool = False
                   ) -> Tuple[FusedPlan, int, bool]:
        """Fused-engine plan for ``batch``'s bucket (default: cfg.batch),
        planned on a miss at the bucket size and the key's storage dtype,
        policy and stack policy.  ``devices`` > 1 buckets and plans the
        per-shard batch, ceil(batch / devices): every shard of a
        data-parallel mesh runs the one plan.  ``pre_sharded`` says
        ``batch`` is already the per-shard batch; the key still carries
        ``devices``, so it is the entry the global batch resolves to.
        Returns (plan, shard bucket, cache_hit)."""
        from repro_torch.cnn.network import plan_network_fused
        key = self._key(cfg, batch, dtype, training, policy, stack, devices,
                        pre_sharded)
        hit = key in self._fused
        self._record(key, hit)
        if not hit:
            self.planner_calls += 1
            self._fused[key] = plan_network_fused(
                cfg.replace(batch=key.bucket), dtype=key.dtype,
                policy=key.policy, stack_policy=key.stack,
                cost_model=self.cost_model)
        self._touch(self._fused, key, hit)
        return self._fused[key], key.bucket, hit

    def assignment(self, cfg: CNNConfig, batch: Optional[int] = None, *,
                   dtype: str = DEFAULT_DTYPE, training: bool = False,
                   policy: str = "uniform") -> Tuple[Assignment, int, bool]:
        """Unfused-engine layout assignment, same keying and memoization."""
        from repro_torch.cnn.network import input_shape, network_descs
        from repro_torch.core.selector import assign_layouts
        key = self._key(cfg, batch, dtype, training, policy)
        hit = key in self._unfused
        self._record(key, hit)
        if not hit:
            self.planner_calls += 1
            bcfg = cfg.replace(batch=key.bucket)
            self._unfused[key] = assign_layouts(
                network_descs(bcfg, key.dtype), input_layout="NCHW",
                input_shape=input_shape(bcfg), training=training,
                dtype_policy=key.policy, base_dtype=key.dtype,
                cost_model=self.cost_model)
        self._touch(self._unfused, key, hit)
        return self._unfused[key], key.bucket, hit

    def peek_fused(self, cfg: CNNConfig, batch: Optional[int] = None, *,
                   dtype: str = DEFAULT_DTYPE, training: bool = False,
                   policy: str = "uniform", stack: str = "auto",
                   devices: int = 1, pre_sharded: bool = False
                   ) -> Optional[FusedPlan]:
        """Cached fused plan or None: no stats, no planning, no recency
        refresh.  ``devices`` and ``pre_sharded`` as in ``fused_plan``."""
        return self._fused.get(self._key(cfg, batch, dtype, training,
                                         policy, stack, devices,
                                         pre_sharded))

    def heuristic_layouts(self, cfg: CNNConfig,
                          batch: Optional[int] = None,
                          dtype: str = DEFAULT_DTYPE,
                          hardware: Optional[str] = None) -> List[str]:
        """The paper's single-scan §IV.D heuristic under the cache's
        thresholds for ``dtype`` (and ``hardware``), at ``batch``'s bucket:
        the O(L) planning fast path, not memoized."""
        from repro_torch.cnn.network import network_descs
        from repro_torch.core.selector import paper_heuristic_layouts
        dtype = canon_dtype(dtype)
        th = self.thresholds_for(dtype, hardware)
        if th is None:
            raise ValueError(
                f"heuristic planning needs calibrated thresholds for "
                f"dtype {dtype!r}")
        bcfg = cfg.replace(batch=self.bucket(
            cfg.batch if batch is None else batch))
        return paper_heuristic_layouts(network_descs(bcfg, dtype), th)

    # -- persistence ---------------------------------------------------------

    def to_json(self) -> Dict:
        hw_rows: Dict[str, Dict[str, Dict]] = {}
        for (hw, dt), v in self._thresholds.items():
            if hw != DEFAULT_HARDWARE:
                hw_rows.setdefault(hw, {})[dt] = dataclasses.asdict(v)
        obj = {
            "version": 2,
            "min_bucket": self.min_bucket,
            "max_bucket": self.max_bucket,
            "max_entries": self.max_entries,
            # the unversioned rows keep the legacy field's shape; the rows
            # of named hardware ride in "thresholds_hw"
            "thresholds": {dt: dataclasses.asdict(v)
                           for (hw, dt), v in self._thresholds.items()
                           if hw == DEFAULT_HARDWARE},
            # in recency order, so a reloaded bounded cache evicts alike
            "fused": [{"key": k.as_dict(), "plan": dataclasses.asdict(p)}
                      for k, p in self._fused.items()],
            "unfused": [{"key": k.as_dict(),
                         "plan": dataclasses.asdict(a)}
                        for k, a in self._unfused.items()],
        }
        if hw_rows:
            obj["thresholds_hw"] = hw_rows
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
        """Load a plan-cache file, or recover from its corruption.  Torn or
        garbage JSON, an unknown version, a checksum mismatch or an entry
        that does not deserialize renames the file aside as ``*.corrupt``
        (recorded in ``corrupt_recoveries``) and leaves the cache empty: a
        server constructs and replans.  A packaged plan file raises
        ``CorruptStateError`` instead and stays where it is."""
        packaged = is_packaged(path)

        def _validate(o: Dict) -> None:
            if o.get("version") not in (1, 2):
                raise CorruptStateError(
                    f"unknown plan-cache version {o.get('version')!r} in "
                    f"{path!r}")

        if packaged:
            obj = load_json(path)
            _validate(obj)
        else:
            obj = load_json_guarded(
                path, validate=_validate,
                on_corrupt=lambda dst, e: self.corrupt_recoveries.append(
                    dst))
            if obj is None:
                return
        try:
            self._load_obj(obj)
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            if packaged:
                raise CorruptStateError(
                    f"{path}: malformed plan entry ({e})") from e
            # valid JSON whose entries do not deserialize (a legacy,
            # checksum-free file): _load_obj changed nothing before it
            # raised, so renaming the file aside is all there is to do
            dst = quarantine_file(path)
            log.warning("malformed plan-cache payload %s (%s): renamed "
                        "aside to %s; rebuilding", path, e, dst)
            self.corrupt_recoveries.append(dst)
            return
        self.path = path

    def _load_obj(self, obj: Dict) -> None:
        fused = [(_key_from_obj(ent["key"]), _plan_from_obj(ent["plan"]))
                 for ent in obj.get("fused", ())]
        unfused = [(_key_from_obj(ent["key"]),
                    _assignment_from_obj(ent["plan"]))
                   for ent in obj.get("unfused", ())]
        rows: Dict[Tuple[str, str], Thresholds] = {}
        th = obj.get("thresholds")
        if th is not None:
            if "Ct" in th:             # v1: one flat (float32) row
                th = {DEFAULT_DTYPE: th}
            for k, v in th.items():
                rows[(DEFAULT_HARDWARE, canon_dtype(k))] = Thresholds(
                    Ct=v["Ct"], Nt=v["Nt"])
        for hw, hrows in (obj.get("thresholds_hw") or {}).items():
            for k, v in hrows.items():
                rows[(hw, canon_dtype(k))] = Thresholds(Ct=v["Ct"],
                                                        Nt=v["Nt"])
        if not self._explicit["min_bucket"]:
            self.min_bucket = obj.get("min_bucket", self.min_bucket)
        if not self._explicit["max_bucket"]:
            self.max_bucket = obj.get("max_bucket", self.max_bucket)
        if (not self._explicit["max_entries"]
                and obj.get("max_entries") is not None):
            self.max_entries = obj["max_entries"]
        for key, v in rows.items():
            if key not in self._explicit["thresholds"]:
                self._thresholds[key] = v
        for key, plan in fused:
            self._fused[key] = plan
            self._touch(self._fused, key, hit=False)
        for key, a in unfused:
            self._unfused[key] = a
            self._touch(self._unfused, key, hit=False)
