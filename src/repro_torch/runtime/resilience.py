"""Serving-grade resilience: fault injection, the degradation ladder and
crash-safe persisted state, as ``repro/runtime/resilience.py`` has them.

  * ``FaultInjector``: seeded, per-site injection of kernel exceptions,
    NaN outputs and slow steps, and ``corrupt_json`` to tear a persisted
    file.  Each site draws from its own generator, seeded by
    ``sha256(f"{seed}:{site}")`` as the reference seeds it, so one seed and
    spec fire the same faults in both packages.
  * ``degradation_ladder``: the ordered execution variants (``Rung``: impl
    x stack policy x dtype policy) a guarded server walks down when a
    batch fails.  The port's engines are ``"cuda"`` (the kernels; on a CPU
    tensor their plain versions) and ``"torch"`` (the plain engine).  A
    ladder never leaves its engine: the ``"cuda"`` ladder is the
    reference's ``"pallas"`` ladder without its terminal decomposed rung,
    so no fallback hides a kernel on the card; the ``"torch"`` ladder is
    the reference's ``"xla"`` ladder.  That is a deliberate difference
    from the reference.
  * ``IncidentLog``: the incident taxonomy, counted over a server's life,
    with the reference's ``summary()`` text.
  * crash-safe JSON: ``atomic_json_dump`` (a sha256 checksum of the
    canonical payload under ``"checksum"``, fsync before the atomic
    rename), ``load_json`` (raises ``CorruptStateError``: for files that
    are part of the repo, which are never renamed) and
    ``load_json_guarded`` (renames an unreadable file aside as
    ``*.corrupt`` and returns None, so the caller rebuilds).  Files
    written by either package verify in the other.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger("repro_torch.resilience")

CHECKSUM_FIELD = "checksum"
ENGINES = ("cuda", "torch")


class InjectedKernelFault(RuntimeError):
    """A fault-injection kernel exception (it stands in for a kernel that
    failed while it executed)."""


class ServingFault(RuntimeError):
    """Every rung of the degradation ladder failed for one batch.  The
    admitted requests are back at the front of the queue, in their order,
    before this is raised."""


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

class FaultInjector:
    """Seeded, per-site Bernoulli fault injection.

    ``rates`` maps sites to firing probabilities in [0, 1].  A site is a
    fault kind (``"kernel"``, ``"nan"``, ``"slow"``), optionally qualified
    as ``"kind@qualifier"``: the server passes the rung's name, dtype
    policy and engine as qualifiers, so ``{"nan@mixed": 1.0}`` poisons only
    the mixed-dtype rungs while ``{"kernel": 0.1}`` hits every rung.  The
    first qualifier with a rate wins, then the bare kind.

    Each site key draws from its own ``np.random.Generator`` seeded by
    (seed, site key): whether a site fires is a function of the seed and
    that site's count of draws alone."""

    def __init__(self, seed: int = 0,
                 rates: Optional[Dict[str, float]] = None,
                 slow_s: float = 0.05):
        self.seed = seed
        self.rates = dict(rates or {})
        for site, r in self.rates.items():
            if not 0.0 <= r <= 1.0:
                raise ValueError(f"rate for {site!r} must be in [0,1], "
                                 f"got {r}")
        self.slow_s = slow_s
        self.counts: Dict[str, int] = {}       # fired, by resolved site key
        self.draws: Dict[str, int] = {}        # draws, by site key
        self._rngs: Dict[str, np.random.Generator] = {}

    @property
    def fired(self) -> int:
        return sum(self.counts.values())

    def _resolve(self, kind: str,
                 quals: Sequence[str]) -> Optional[Tuple[str, float]]:
        for q in quals:
            key = f"{kind}@{q}"
            if key in self.rates:
                return key, self.rates[key]
        if kind in self.rates:
            return kind, self.rates[kind]
        return None

    def _rng(self, key: str) -> np.random.Generator:
        if key not in self._rngs:
            digest = hashlib.sha256(f"{self.seed}:{key}".encode()).digest()
            self._rngs[key] = np.random.default_rng(
                int.from_bytes(digest[:8], "little"))
        return self._rngs[key]

    def fire(self, kind: str, quals: Sequence[str] = ()) -> bool:
        """One Bernoulli draw for ``kind`` under ``quals``; counts the draw
        and, when it fires, the fault."""
        hit = self._resolve(kind, quals)
        if hit is None:
            return False
        key, rate = hit
        self.draws[key] = self.draws.get(key, 0) + 1
        if rate <= 0.0:
            return False
        fired = rate >= 1.0 or bool(self._rng(key).random() < rate)
        if fired:
            self.counts[key] = self.counts.get(key, 0) + 1
        return fired

    def maybe_kernel_fault(self, quals: Sequence[str] = ()) -> None:
        """Raises ``InjectedKernelFault`` when the kernel site fires."""
        if self.fire("kernel", quals):
            raise InjectedKernelFault(
                f"injected kernel fault (site=kernel, quals={list(quals)})")

    def maybe_slow(self, quals: Sequence[str] = ()) -> float:
        """Sleeps ``slow_s`` when the slow site fires; returns the delay
        (0.0 when it did not fire)."""
        if self.fire("slow", quals):
            time.sleep(self.slow_s)
            return self.slow_s
        return 0.0

    def maybe_poison(self, y: np.ndarray,
                     quals: Sequence[str] = ()) -> np.ndarray:
        """``y`` with its first element NaN when the nan site fires (a
        copy; the finite check downstream must catch it)."""
        if self.fire("nan", quals) and y.size:
            y = np.array(y, dtype=np.float32, copy=True)
            y.flat[0] = np.nan
        return y

    @staticmethod
    def corrupt_json(path: str, mode: str = "truncate") -> str:
        """Corrupt a persisted JSON file in place.  Modes: ``truncate``
        (cut mid-payload: a torn write), ``garbage`` (non-JSON bytes),
        ``version`` (an unknown schema version), ``checksum`` (the payload
        changed under a stale checksum)."""
        if mode == "truncate":
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.truncate(max(size // 2, 1))
        elif mode == "garbage":
            with open(path, "wb") as f:
                f.write(b"\x00\xffnot json {]")
        elif mode == "version":
            with open(path) as f:
                obj = json.load(f)
            obj["version"] = 999999
            with open(path, "w") as f:
                json.dump(obj, f)
        elif mode == "checksum":
            with open(path) as f:
                obj = json.load(f)
            if CHECKSUM_FIELD not in obj:
                raise ValueError(f"{path} carries no checksum to violate")
            obj["_tampered"] = True
            with open(path, "w") as f:
                json.dump(obj, f)
        else:
            raise ValueError(f"unknown corruption mode {mode!r}")
        return path


def parse_inject_spec(spec: str, seed: int = 0,
                      slow_s: float = 0.05) -> Optional[FaultInjector]:
    """``"kernel=0.1,nan@mixed=1.0,slow=0.05"`` -> an injector; an empty
    spec gives None (injection off)."""
    if not spec:
        return None
    rates: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        site, _, rate = part.partition("=")
        if not rate:
            raise ValueError(f"--inject entry {part!r} is not site=rate")
        rates[site.strip()] = float(rate)
    return FaultInjector(seed=seed, rates=rates, slow_s=slow_s)


# ---------------------------------------------------------------------------
# the degradation ladder
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Rung:
    """One execution variant of the fused serving path.  ``(policy,
    stack)`` are plan-cache key coordinates: a rung's plan is the planner's
    own plan for that variant, never an ad-hoc replan."""
    name: str
    impl: str                     # "cuda" | "torch"
    stack: str                    # stack policy: "auto" | "off"
    policy: str                   # dtype policy: "uniform" | "mixed"


def _rung_name(impl: str, stack: str, policy: str) -> str:
    name = impl + ("+stacks" if stack == "auto" else "")
    if policy == "mixed":
        name += "-mixed"
    return name


def degradation_ladder(impl: str, policy: str,
                       stack: str = "auto") -> List[Rung]:
    """The guarded server's fallback chain, most capable first, within one
    engine: stacks -> stacks off -> mixed -> uniform dtype.

    Each rung relaxes one lever of the configured operating point, so a
    server already on a lower rung gets only the rungs at or below it, and
    equal variants collapse.  Unlike the reference's, the ladder has no
    terminal rung on another engine: a ``"cuda"`` server's last rung still
    runs the kernels, so a kernel that fails on the card is never hidden
    behind the plain engine."""
    if impl not in ENGINES:
        raise ValueError(f"unknown impl {impl!r}; known: {ENGINES}")
    if policy not in ("uniform", "mixed"):
        raise ValueError(f"unknown dtype policy {policy!r}")
    if stack not in ("auto", "off"):
        raise ValueError(f"unknown stack policy {stack!r}")
    coords = [
        (impl, stack, policy),            # configured operating point
        (impl, "off", policy),            # stack fusion off
        (impl, "off", "uniform"),         # mixed -> uniform dtype
    ]
    rungs: List[Rung] = []
    for i, s, p in coords:
        if all((i, s, p) != (r.impl, r.stack, r.policy) for r in rungs):
            rungs.append(Rung(_rung_name(i, s, p), i, s, p))
    return rungs


# ---------------------------------------------------------------------------
# incident accounting
# ---------------------------------------------------------------------------

# the taxonomy, in the order ``summary()`` prints it
INCIDENT_KINDS = ("kernel_fault", "nonfinite", "quarantine", "requeue",
                  "corrupt_state", "straggler", "degraded")


@dataclass
class IncidentLog:
    """Counts every resilience event over a server's lifetime; ``record``
    rejects a kind outside ``INCIDENT_KINDS``."""
    counts: Dict[str, int] = field(default_factory=dict)

    def record(self, kind: str, detail: str = "", n: int = 1) -> None:
        if kind not in INCIDENT_KINDS:
            raise ValueError(f"unknown incident kind {kind!r} "
                             f"(taxonomy: {INCIDENT_KINDS})")
        self.counts[kind] = self.counts.get(kind, 0) + n
        if detail:
            log.warning("incident %s: %s", kind, detail)

    @property
    def total(self) -> int:
        return sum(self.counts.values())

    def summary(self) -> str:
        if not self.counts:
            return "incidents=0"
        parts = [f"{k}:{self.counts[k]}" for k in INCIDENT_KINDS
                 if k in self.counts]
        return f"incidents={self.total} ({','.join(parts)})"


# ---------------------------------------------------------------------------
# crash-safe JSON persistence
# ---------------------------------------------------------------------------

class CorruptStateError(ValueError):
    """A persisted state file failed schema or checksum validation."""


def payload_checksum(obj: Dict[str, Any]) -> str:
    """sha256 over the canonical (sorted-key) JSON of ``obj`` minus the
    checksum field itself."""
    payload = {k: v for k, v in obj.items() if k != CHECKSUM_FIELD}
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def with_checksum(obj: Dict[str, Any]) -> Dict[str, Any]:
    return {**obj, CHECKSUM_FIELD: payload_checksum(obj)}


def verify_checksum(obj: Dict[str, Any], path: str = "<mem>") -> None:
    """Raises ``CorruptStateError`` on mismatch.  Files written before the
    checksum era (no field) pass."""
    stored = obj.get(CHECKSUM_FIELD)
    if stored is None:
        return
    actual = payload_checksum(obj)
    if stored != actual:
        raise CorruptStateError(
            f"{path}: payload checksum mismatch "
            f"(stored {stored[:12]}…, actual {actual[:12]}…)")


def load_json(path: str) -> Dict[str, Any]:
    """Read a JSON state file and verify its checksum.  Malformed JSON, a
    top level that is not an object, or a checksum mismatch raises
    ``CorruptStateError``; the file is left where it is."""
    with open(path) as f:
        try:
            obj = json.load(f)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CorruptStateError(f"{path}: not JSON ({e})") from e
    if not isinstance(obj, dict):
        raise CorruptStateError(f"{path}: top level is not an object")
    verify_checksum(obj, path)
    return obj


def atomic_json_dump(obj: Dict[str, Any], path: str) -> str:
    """Write ``obj`` to ``path`` crash-safely: checksum stamped into the
    payload, contents fsynced BEFORE the atomic rename, so a crash leaves
    either the previous generation or the new one, never a torn file.
    Written with ``indent=1``, as the reference writes it."""
    obj = with_checksum(obj)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    # fsync the directory so the rename itself survives a power cut
    dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)
    return path


def quarantine_file(path: str) -> str:
    """Rename an unreadable state file aside as ``<path>.corrupt`` (then
    ``.corrupt.1``, ... : an earlier generation is never overwritten)."""
    dst = f"{path}.corrupt"
    n = 0
    while os.path.exists(dst):
        n += 1
        dst = f"{path}.corrupt.{n}"
    os.replace(path, dst)
    return dst


def load_json_guarded(path: str,
                      validate: Optional[Callable[[Dict[str, Any]], None]]
                      = None,
                      on_corrupt: Optional[Callable[[str, Exception], None]]
                      = None) -> Optional[Dict[str, Any]]:
    """Load a persisted JSON state file, or recover from its corruption.

    Returns the parsed object.  On any failure (unreadable bytes, torn or
    garbage JSON, a checksum mismatch, ``validate(obj)`` raising) the file
    is renamed aside by ``quarantine_file``, ``on_corrupt(dst, error)`` is
    called and None returned: the caller rebuilds.  A missing file also
    gives None."""
    if not os.path.exists(path):
        return None
    try:
        obj = load_json(path)
        if validate is not None:
            validate(obj)
        return obj
    except (OSError, ValueError, KeyError, TypeError) as e:
        dst = quarantine_file(path)
        log.warning("corrupt state file %s (%s): renamed aside to %s; "
                    "rebuilding", path, e, dst)
        if on_corrupt is not None:
            on_corrupt(dst, e)
        return None
