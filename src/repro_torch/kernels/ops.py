"""Kernel-plane accounting: counted calls, counted and warned-once fallbacks.

Every kernel wrapper of this package reports here.  ``KERNEL_STATS.calls``
counts kernel-plane **calls** — one per ``fused_apply_update`` that went
through its kernel, i.e. one per training step — and
``KERNEL_STATS.fallbacks`` counts calls that took the plain PyTorch
version instead, tagged with a reason and warned once per (kernel,
reason).  The only reason a wrapper may fall back is that its tensors lie
on the CPU; on a CUDA tensor it launches its kernel or raises.

(The JAX package counts at trace time, once per compilation; this package
runs eagerly, so its counts move per call.  ``kernel_calls > 0`` and
``kernel_fallbacks == 0`` mean the same thing in both.)  Surfaced via
``TorchTrainer.kernel_calls`` / ``EngineStats.kernel_fallbacks``.  Each
wrapper additionally keeps its own plain integer ``launches`` counter of
kernel launches (for the optimizer: one per parameter leaf per step).
"""

from __future__ import annotations

import warnings
from collections import Counter
from dataclasses import dataclass, field
from typing import Tuple

__all__ = ["KernelFallbackWarning", "KernelStats", "KERNEL_STATS",
           "reset_kernel_stats", "note_call", "note_fallback"]


class KernelFallbackWarning(UserWarning):
    """A kernel-plane call took the plain PyTorch version."""


@dataclass
class KernelStats:
    """Module-global kernel-plane accounting."""
    calls: int = 0
    fallbacks: int = 0
    reasons: Counter = field(default_factory=Counter)

    def snapshot(self) -> Tuple[int, int]:
        return (self.calls, self.fallbacks)


KERNEL_STATS = KernelStats()
_WARNED: set = set()


def reset_kernel_stats() -> None:
    KERNEL_STATS.calls = 0
    KERNEL_STATS.fallbacks = 0
    KERNEL_STATS.reasons.clear()
    _WARNED.clear()


def note_call(kernel: str) -> None:
    KERNEL_STATS.calls += 1


def note_fallback(kernel: str, reason: str) -> None:
    KERNEL_STATS.fallbacks += 1
    KERNEL_STATS.reasons[f"{kernel}:{reason}"] += 1
    if (kernel, reason) not in _WARNED:
        _WARNED.add((kernel, reason))
        warnings.warn(
            f"kernel {kernel!r} took its plain PyTorch version "
            f"({reason}); the kernel plane is inactive for these calls",
            KernelFallbackWarning, stacklevel=3)
