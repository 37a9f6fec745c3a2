"""Crash-safe JSON persistence for the port's state files.

The checksum scheme of ``repro/runtime/resilience.py``: a sha256 over the
canonical (sorted-key) JSON of the payload, stored under ``"checksum"``,
and an fsync before the atomic rename.  Files written by either package
verify in the other.  A file that fails its checksum raises
``CorruptStateError`` here (the reference renames it aside and rebuilds;
that recovery belongs with its serving ladder, not yet ported).
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict

CHECKSUM_FIELD = "checksum"


class CorruptStateError(ValueError):
    """A persisted state file failed schema or checksum validation."""


def payload_checksum(obj: Dict[str, Any]) -> str:
    """sha256 over the canonical (sorted-key) JSON of ``obj`` minus the
    checksum field itself."""
    payload = {k: v for k, v in obj.items() if k != CHECKSUM_FIELD}
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


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
    ``CorruptStateError``."""
    with open(path) as f:
        try:
            obj = json.load(f)
        except json.JSONDecodeError as e:
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
    obj = {**obj, CHECKSUM_FIELD: payload_checksum(obj)}
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
