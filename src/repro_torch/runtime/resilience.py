"""Crash-safe JSON persistence for the port's state files.

The checksum scheme of ``repro/runtime/resilience.py``: a sha256 over the
canonical (sorted-key) JSON of the payload, stored under ``"checksum"``,
and an fsync before the atomic rename.  Files written by either package
verify in the other.  A file that fails its checksum raises
``CorruptStateError`` here; renaming it aside and rebuilding needs a
planner, which the port does not have yet.
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
