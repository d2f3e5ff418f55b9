"""Worker leases — one fleet, many sessions, boundary-safe rebalancing.

The gateway owns a fixed fleet of worker *slots* (each optionally a
:class:`~repro_torch.dist.meshes.WorkerMesh`); sessions own none.  Every
worker a session runs is a **lease** of one slot, granted and revoked
here, and carries its slot's mesh.  The fault plane makes revocation
lossless: the engine only ever releases
a worker at a *chain boundary* (``ExecutionEngine.remove_worker`` marks a
busy worker draining; it departs when its idle event fires), and every
boundary checkpoint is committed by then — so moving a worker between
sessions never forfeits work, it only moves future capacity.

``rebalance`` recomputes a target allocation proportional to each live
session's demand (its unfinished studies), floor-of-share plus
largest-remainder so targets always sum to the fleet, with every
demanding session guaranteed one slot when the fleet is large enough.
Surplus sessions drain their latest-granted (idle-first) leases; freed
slots are granted to deficit sessions in creation order.  The pump is
eventually consistent: a draining lease frees its slot at the next
``reap`` after the chain boundary, and the following rebalance hands it
on — capacity follows demand at chain granularity.

All iteration orders are explicit (slot order, session creation order,
wid order), so a gateway run — and its snapshot/restore — is
deterministic.

The JAX package's ``repro.frontdoor.leases``, copied (it imports nothing
of either package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

__all__ = ["Lease", "WorkerLeaseManager"]


@dataclass
class Lease:
    """One fleet slot currently (or still, while draining) owned by a
    session."""

    slot: int              # fleet slot index (mesh descriptor lives there)
    key: str               # plan key of the owning session
    wid: int               # worker id inside the session's engine
    draining: bool = False  # revoked; departs at its chain boundary


class WorkerLeaseManager:
    """Owns the fleet's slots and the lease table over them."""

    def __init__(self, slot_meshes: List[Optional[object]]):
        self.slot_meshes = list(slot_meshes)
        self.leases: Dict[int, Lease] = {}    # slot -> lease

    # ----------------------------------------------------------- inspection
    @property
    def n_slots(self) -> int:
        return len(self.slot_meshes)

    def slot_widths(self) -> List[int]:
        """Device width of every slot (1 for classic thread workers) —
        the admission capacity gate's input."""
        return [m.n_devices if m is not None else 1
                for m in self.slot_meshes]

    def free_slots(self) -> List[int]:
        return [s for s in range(self.n_slots) if s not in self.leases]

    def held(self, key: str, include_draining: bool = False) -> List[Lease]:
        return [l for l in self.leases.values()
                if l.key == key and (include_draining or not l.draining)]

    # ---------------------------------------------------------- grant/revoke
    def grant(self, slot: int, key: str, engine,
              at: Optional[float] = None) -> Lease:
        """Lease ``slot`` to ``key``'s engine: the engine grows a worker
        that cannot start before global time ``at`` (a worker moved over
        from another session must not compute in the receiver's past)."""
        if slot in self.leases:
            raise RuntimeError(f"slot {slot} is already leased "
                               f"to {self.leases[slot].key!r}")
        w = engine.add_worker(mesh=self.slot_meshes[slot], at=at)
        lease = Lease(slot, key, w.wid)
        self.leases[slot] = lease
        return lease

    def revoke(self, lease: Lease, engine) -> bool:
        """Revoke one lease.  An idle worker leaves immediately (slot
        freed, True); a busy one drains to its chain boundary (False) and
        frees the slot at a later :meth:`reap`."""
        if engine is None or engine.remove_worker(lease.wid):
            del self.leases[lease.slot]
            return True
        lease.draining = True
        return False

    def release_key(self, key: str, engine) -> None:
        """Revoke every lease a (retiring) session holds."""
        for lease in sorted(self.held(key, include_draining=True),
                            key=lambda l: l.slot):
            if not lease.draining:
                self.revoke(lease, engine)
            elif engine is None or engine.worker(lease.wid) is None:
                del self.leases[lease.slot]

    def reap(self, engines: Dict[str, object]) -> List[int]:
        """Free the slots of draining leases whose worker has departed
        (its chain boundary passed); returns the freed slot ids."""
        freed = []
        for slot in sorted(self.leases):
            lease = self.leases[slot]
            if not lease.draining:
                continue
            eng = engines.get(lease.key)
            if eng is None or eng.worker(lease.wid) is None:
                del self.leases[slot]
                freed.append(slot)
        return freed

    # ------------------------------------------------------------ rebalance
    def targets(self, demands: Dict[str, int]) -> Dict[str, int]:
        """Slot targets proportional to demand (floor + largest
        remainder), each demanding key guaranteed one slot when the fleet
        has enough.  ``demands`` iterates in session-creation order, which
        breaks every tie deterministically."""
        active = [k for k, d in demands.items() if d > 0]
        if not active:
            return {k: 0 for k in demands}
        total = self.n_slots
        floor_each = 1 if total >= len(active) else 0
        spare = total - floor_each * len(active)
        weight = sum(demands[k] for k in active)
        shares = [(k, spare * demands[k] / weight) for k in active]
        out = {k: floor_each + int(s) for k, s in shares}
        leftover = total - sum(out.values())
        # largest fractional remainder first; creation order breaks ties
        by_rem = sorted(shares, key=lambda ks: -(ks[1] - int(ks[1])))
        for k, _ in by_rem:
            if leftover <= 0:
                break
            out[k] += 1
            leftover -= 1
        for k in demands:
            out.setdefault(k, 0)
        return out

    def rebalance(self, demands: Dict[str, int], engines: Dict[str, object],
                  at: Optional[float] = None) -> int:
        """One rebalance pump: reap drained leases, revoke surpluses,
        grant free slots to deficits.  Returns the number of lease moves
        (revocations + grants) — zero when the allocation already matches
        the targets."""
        self.reap(engines)
        target = self.targets(demands)
        moves = 0
        # shrink surpluses first so their slots can serve deficits (idle
        # workers free immediately; busy ones free at their boundary)
        for key in demands:
            eng = engines.get(key)
            held = sorted(self.held(key), key=lambda l: l.slot)
            surplus = len(held) - target.get(key, 0)
            if surplus <= 0 or eng is None:
                continue
            # idle workers first (their slot frees right now), then the
            # latest-granted — the longest-held leases keep their locality
            def _order(l):
                w = eng.worker(l.wid)
                return (0 if (w is not None and w.idle) else 1, -l.slot)
            for lease in sorted(held, key=_order)[:surplus]:
                self.revoke(lease, eng)
                moves += 1
        # grow deficits from whatever is free, creation order first
        free = self.free_slots()
        for key in demands:
            eng = engines.get(key)
            if eng is None:
                continue
            deficit = target.get(key, 0) - len(self.held(key))
            while deficit > 0 and free:
                self.grant(free.pop(0), key, eng, at=at)
                moves += 1
                deficit -= 1
        return moves
