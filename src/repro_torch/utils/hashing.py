"""Stable content hashing for search-plan keys and checkpoint addressing.

Everything that identifies a computation (hyper-parameter functions, trial
prefixes, study keys) is hashed through a canonical JSON encoding so that
equality is structural, reproducible across processes, and journal-safe.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any


def _canon(obj: Any) -> Any:
    """Recursively convert to a canonical JSON-encodable form."""
    if isinstance(obj, dict):
        return {str(k): _canon(v) for k, v in sorted(obj.items(), key=lambda kv: str(kv[0]))}
    if isinstance(obj, (list, tuple)):
        return [_canon(v) for v in obj]
    if isinstance(obj, float):
        # canonical float formatting (repr round-trips in python3)
        return float(repr(obj))
    if isinstance(obj, (str, int, bool)) or obj is None:
        return obj
    # objects exposing a canonical encoding
    to_json = getattr(obj, "to_json", None)
    if callable(to_json):
        return _canon(to_json())
    raise TypeError(f"cannot canonically hash object of type {type(obj)!r}: {obj!r}")


def stable_hash(obj: Any) -> str:
    """SHA-1 hex digest of the canonical JSON encoding of ``obj``."""
    payload = json.dumps(_canon(obj), sort_keys=True, separators=(",", ":"))
    return hashlib.sha1(payload.encode("utf-8")).hexdigest()


def short_hash(obj: Any, n: int = 10) -> str:
    return stable_hash(obj)[:n]
