"""Admission control — per-tenant weighted fair-share quotas at the door.

The engine's :class:`~repro_torch.core.scheduler.FairShareScheduler` already
split-charges stage execution across the studies it serves; this
module adds the *cluster-level* layer PipeTune motivates: studies arrive
continuously from many tenants, and the system — not the submitter —
decides who runs now, who waits, and what can never run at all.

Three mechanisms, in decision order:

* **capacity gate** — work the fleet can *never* place (a study whose
  stages need more devices than the widest worker slot) is refused
  outright with :class:`CapacityError`; queueing it would be a silent
  forever-wait.
* **bounded queues** — each tenant has ``max_queued`` admission slots;
  beyond them :class:`AdmissionQueueFull` pushes back on the submitter
  (back-pressure beats unbounded memory growth).
* **weighted fair-share dequeue** — when a running slot frees, the queued
  submission of the tenant with the lowest *weighted* usage (split-charged
  GPU-seconds / quota weight) is admitted; ``priority`` breaks ties within
  a tenant's and across equal-usage tenants' submissions, then arrival
  order.  A tenant with weight 2 is charged half, so it reaches "most
  served" twice as late — weighted shares without starving anyone
  (usage only grows while you run; a starved tenant's weighted usage
  stays minimal and wins every future dequeue).

The controller is deliberately engine-agnostic: *usage* is injected per
decision by the gateway (computed live from ``EngineStats.by_study`` via
the tenant ledger), so the controller itself carries only quotas, the
queue and counters — exactly what the gateway snapshot persists.  The
counters are plain ``int``s: this state is pickled into the snapshot.

The JAX package's ``repro.frontdoor.admission``, copied (it imports
nothing of either package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["TenantQuota", "Submission", "AdmissionController",
           "AdmissionQueueFull", "CapacityError"]


class CapacityError(RuntimeError):
    """The fleet can never place this work — refused, not queued."""


class AdmissionQueueFull(RuntimeError):
    """The tenant's bounded admission queue is full (back-pressure)."""


@dataclass(frozen=True)
class TenantQuota:
    """Per-tenant admission policy.

    ``weight`` scales the tenant's fair share (2.0 = twice the share —
    applied both at the admission dequeue and, through
    ``FairShareScheduler.set_study_weights``, inside shared sessions).
    ``max_queued`` bounds the tenant's admission queue.  ``max_running``
    caps the tenant's concurrently *running* studies (None = only the
    gateway-wide ``max_concurrent`` applies).
    """

    weight: float = 1.0
    max_queued: int = 16
    max_running: Optional[int] = None

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"quota weight must be > 0, got {self.weight}")
        if self.max_queued < 0:
            raise ValueError("max_queued must be >= 0")

    def to_json(self) -> Dict[str, Any]:
        return {"weight": self.weight, "max_queued": self.max_queued,
                "max_running": self.max_running}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "TenantQuota":
        return cls(weight=d.get("weight", 1.0),
                   max_queued=d.get("max_queued", 16),
                   max_running=d.get("max_running"))


@dataclass
class Submission:
    """One study waiting at (or passing through) the door."""

    tenant: str
    priority: int          # larger = more urgent; breaks fair-share ties
    seq: int               # global arrival order (final tie-break)
    key: str               # plan key (routing target)
    tuner: Any
    study_id: Optional[str] = None
    min_devices: int = 1   # devices one worker must offer this study
    arrival: Optional[float] = None   # requested at= on the global clock


class AdmissionController:
    """Quota bookkeeping + the admission queue.  The gateway drives it:
    ``offer`` at submit time, ``pop_admissible`` whenever running slots
    may have freed, ``on_started`` / ``on_finished`` around each study's
    life cycle."""

    def __init__(self, quotas: Optional[Dict[str, TenantQuota]] = None,
                 max_concurrent: Optional[int] = None,
                 default_quota: Optional[TenantQuota] = None):
        self.quotas: Dict[str, TenantQuota] = dict(quotas or {})
        self.max_concurrent = max_concurrent
        self.default_quota = default_quota or TenantQuota()
        self.queue: List[Submission] = []
        # (plan key, study id) -> tenant, for every currently-running study
        self.running: Dict[Tuple[str, str], str] = {}
        self.seq = 0
        self.admission_faults = 0      # deferred-by-injected-fault count

    # ------------------------------------------------------------- quotas
    def quota(self, tenant: str) -> TenantQuota:
        return self.quotas.get(tenant, self.default_quota)

    def _running_of(self, tenant: str) -> int:
        return sum(1 for t in self.running.values() if t == tenant)

    def _queued_of(self, tenant: str) -> int:
        return sum(1 for s in self.queue if s.tenant == tenant)

    # ------------------------------------------------------------ the gate
    def check_capacity(self, min_devices: int,
                       slot_widths: List[int]) -> None:
        """Refuse work the fleet can never place: no slot at all, or every
        slot narrower than the study's per-worker device requirement.
        Queueing such work would be a silent forever-wait — the error is
        the honest answer."""
        if not slot_widths:
            raise CapacityError("the fleet has no worker slots")
        widest = max(slot_widths)
        if min_devices > widest:
            raise CapacityError(
                f"study needs {min_devices} devices per worker but the "
                f"widest fleet slot has {widest} — no rebalancing can ever "
                "place it")

    def can_admit(self, sub: Submission) -> bool:
        """Would admitting ``sub`` right now violate a concurrency cap?"""
        if (self.max_concurrent is not None
                and len(self.running) >= self.max_concurrent):
            return False
        cap = self.quota(sub.tenant).max_running
        return cap is None or self._running_of(sub.tenant) < cap

    # ---------------------------------------------------------- life cycle
    def offer(self, sub: Submission) -> bool:
        """Route one submission: True = admit now, False = queued
        (``queued_admission``).  Raises :class:`AdmissionQueueFull` when
        the tenant's bounded queue cannot hold it either."""
        if self.can_admit(sub):
            return True
        if self._queued_of(sub.tenant) >= self.quota(sub.tenant).max_queued:
            raise AdmissionQueueFull(
                f"tenant {sub.tenant!r} admission queue is full "
                f"({self.quota(sub.tenant).max_queued} waiting) — retry "
                "after a study finishes")
        self.queue.append(sub)
        return False

    def defer(self, sub: Submission) -> None:
        """Force one submission into the queue (gateway-level injected
        admission fault): the control plane lost the request this round;
        the next pump retries it.  Bypasses the bounded-queue check — the
        work was already accepted, dropping it would lose it."""
        self.admission_faults += 1
        self.queue.append(sub)

    def pop_admissible(self, weighted_usage) -> Optional[Submission]:
        """Remove and return the queued submission to admit next, or None.

        ``weighted_usage(tenant)`` is injected by the gateway (tenant
        ledger GPU-seconds / quota weight).  Order: least weighted usage
        first (weighted fair share), then higher priority, then arrival
        sequence — deterministic for equal inputs."""
        candidates = [s for s in self.queue if self.can_admit(s)]
        if not candidates:
            return None
        best = min(candidates, key=lambda s: (weighted_usage(s.tenant),
                                              -s.priority, s.seq))
        self.queue.remove(best)
        return best

    def on_started(self, key: str, study_id: str, tenant: str) -> None:
        self.running[(key, study_id)] = tenant

    def on_finished(self, key: str, study_id: str) -> None:
        self.running.pop((key, study_id), None)

    def next_seq(self) -> int:
        """Next global arrival sequence number (0-based: the gateway also
        derives default study ids ``study-<seq>`` from it, matching the
        legacy session's ``study-0``-first naming)."""
        seq = self.seq
        self.seq += 1
        return seq
