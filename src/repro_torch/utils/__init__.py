"""Shared utilities: stable hashing, id generation, simple logging."""

from repro_torch.utils.hashing import stable_hash, short_hash
from repro_torch.utils.ids import IdGen

__all__ = ["stable_hash", "short_hash", "IdGen"]
