"""Fault plane — deterministic fault injection for the execution engine.

Hippo's stage trees make failure *expensive*: a stage executes once per
tree, so a lost stage forfeits work that many trials (and studies) were
going to share.  The fault plane turns failure into a first-class,
testable input: a seeded :class:`FaultInjector` drives reproducible fault
schedules through :class:`FaultyBackend` / :class:`FaultyStore` wrappers,
and the dispatcher's failure domains (``repro_torch.core.engine.dispatch``)
absorb them — transient faults retry from the boundary checkpoint with
capped virtual-clock exponential backoff, repeatedly-crashing workers are
quarantined with probation re-admission, failed batched groups degrade to
per-member solo execution, and every failed attempt's cost lands in
``EngineStats.wasted_gpu_seconds`` (never split-charged to the sharing
studies' fair-share accounts).

Fault taxonomy (all derive from :class:`FaultError`, and deliberately NOT
from ``ValueError`` — the dispatcher and backends use ``ValueError`` as
the in-flight "fall back to unfused/unbatched execution" signal, which
must stay distinguishable from an injected failure):

* :class:`TransientStageError` — one execution attempt failed (flaky
  kernel, OOM race, preempted slice); retry is expected to succeed.
* :class:`WorkerCrashed` — the executing worker died mid-attempt; the
  work retries elsewhere and the worker's crash count feeds quarantine.
* :class:`StoreOutageError` — the checkpoint store refused a window of
  operations (network blip to the remote tier); transient.
* :class:`FatalStageError` — non-retryable (deterministic assertion,
  poison input); classified fatal and propagated after accounting.

Everything is deterministic: one ``random.Random(seed)`` stream, drawn in
the engine's (deterministic) execution order, so the same seed replays
the same fault schedule — the property the retry-bitwise tests rely on.
The draws are the JAX package's draw for draw: the same seed, rates and
execution order give the same ``log``.  Errors PyTorch raises (a
``torch.OutOfMemoryError``, say) do not derive from :class:`FaultError`
and carry no ``transient`` tag, so they are fatal, as in the JAX package.
"""

from __future__ import annotations

import random
from typing import Any, Dict, List, Optional

__all__ = [
    "FaultError", "TransientStageError", "WorkerCrashed", "StoreOutageError",
    "FatalStageError", "is_transient", "FaultInjector", "FaultyBackend",
    "FaultyStore", "raw_store",
]


# --------------------------------------------------------------- exceptions
class FaultError(Exception):
    """Base of all injected/recognized faults.

    ``transient`` marks whether a retry of the same work is expected to
    succeed; the dispatcher also honors a truthy ``transient`` attribute
    on foreign exception types (real backends can tag their own).
    """

    transient = True


class TransientStageError(FaultError):
    """One execution attempt failed; retrying from the boundary
    checkpoint is expected to succeed."""


class WorkerCrashed(TransientStageError):
    """The executing worker died mid-attempt.  The work retries like any
    transient fault; the worker additionally accrues a crash toward
    quarantine."""


class StoreOutageError(FaultError):
    """The checkpoint store refused an operation (outage window)."""


class FatalStageError(FaultError):
    """Non-retryable failure — propagated after the books are balanced."""

    transient = False


def is_transient(exc: BaseException) -> bool:
    """Classify an exception caught in a dispatcher failure domain."""
    return bool(getattr(exc, "transient", False))


# ----------------------------------------------------------------- injector
class FaultInjector:
    """Seeded, deterministic fault schedule.

    One ``random.Random(seed)`` stream is drawn at every injection site in
    execution order, so a given seed replays the identical schedule.  Per
    site one draw happens per *rate knob* (crash, stage, outage,
    straggler) whether or not it fires — rates can be tuned independently
    without perturbing each other's draw positions... within a fixed set
    of enabled knobs.

    ``outage_ops``: a fired store outage opens a window in which that many
    subsequent store operations also fail (one logical outage, counted
    once) — modelling a remote-tier blip rather than a single lost call.

    ``max_faults`` bounds the total injections (None = unbounded) so soak
    schedules terminate even at aggressive rates.
    """

    def __init__(self, seed: int = 0, *,
                 stage_fault_rate: float = 0.0,
                 crash_rate: float = 0.0,
                 outage_rate: float = 0.0,
                 straggler_rate: float = 0.0,
                 straggler_factor: float = 4.0,
                 admission_fault_rate: float = 0.0,
                 outage_ops: int = 3,
                 max_faults: Optional[int] = None):
        self.seed = seed
        self.stage_fault_rate = stage_fault_rate
        self.crash_rate = crash_rate
        self.outage_rate = outage_rate
        self.straggler_rate = straggler_rate
        self.straggler_factor = straggler_factor
        self.admission_fault_rate = admission_fault_rate
        self.outage_ops = outage_ops
        self.max_faults = max_faults
        self._rng = random.Random(seed)
        self._outage_left = 0
        self.injected = 0                      # faults fired (windows count 1)
        self.by_kind: Dict[str, int] = {}
        self.retries_verified = 0              # re-puts proven bit-identical
        self.log: List[Dict[str, Any]] = []    # one entry per fired fault

    # ------------------------------------------------------------- plumbing
    def _draw(self, rate: float) -> bool:
        if rate <= 0.0:
            return False
        hit = self._rng.random() < rate
        if hit and (self.max_faults is not None
                    and self.injected >= self.max_faults):
            return False
        return hit

    def _record(self, kind: str, site: str) -> None:
        self.injected += 1
        self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
        self.log.append({"seed": self.seed, "n": self.injected,
                         "kind": kind, "site": site})

    # ------------------------------------------------------ injection sites
    def before_execute(self, site: str) -> None:
        """One backend execution attempt (stage/chain/batched group) is
        about to run: maybe crash the worker, maybe fail the attempt."""
        if self._draw(self.crash_rate):
            self._record("crash", site)
            raise WorkerCrashed(f"injected worker crash at {site}")
        if self._draw(self.stage_fault_rate):
            self._record("stage", site)
            raise TransientStageError(f"injected stage failure at {site}")

    def on_store_op(self, op: str, key: str) -> None:
        """One checkpoint-store get/put is about to run."""
        if self._outage_left > 0:
            self._outage_left -= 1
            raise StoreOutageError(
                f"injected store outage (window) at {op} {key}")
        if self._draw(self.outage_rate):
            self._record("outage", f"{op}:{key}")
            self._outage_left = max(0, self.outage_ops - 1)
            raise StoreOutageError(f"injected store outage at {op} {key}")

    def on_admission(self, site: str) -> bool:
        """One gateway admission decision is about to commit (front door).
        True = the admission is *deferred*: the control plane lost the
        request this round, the study stays queued (``queued_admission``)
        and is retried at the next admission pump — a transient
        control-plane fault, not lost work.  Drawn from the same seeded
        stream as the data-plane sites, so a gateway run with admission
        faults is exactly replayable."""
        if self._draw(self.admission_fault_rate):
            self._record("admission", site)
            return True
        return False

    # ---------------------------------------------------- stream snapshot
    def snapshot_state(self) -> Dict[str, Any]:
        """Picklable mid-run state of the fault schedule (front-door
        snapshots carry it so a restored gateway *continues* the schedule
        instead of replaying it from the seed)."""
        return {"rng": self._rng.getstate(), "outage_left": self._outage_left,
                "injected": self.injected, "by_kind": dict(self.by_kind),
                "retries_verified": self.retries_verified,
                "log": list(self.log)}

    def restore_state(self, state: Dict[str, Any]) -> None:
        self._rng.setstate(state["rng"])
        self._outage_left = state["outage_left"]
        self.injected = state["injected"]
        self.by_kind = dict(state["by_kind"])
        self.retries_verified = state["retries_verified"]
        self.log = list(state["log"])

    def straggle(self, seconds: Optional[float], site: str) -> Optional[float]:
        """Maybe stretch a stage's virtual duration (slow node, thermal
        throttle).  Stragglers complete — they are a performance fault,
        not a correctness one."""
        if seconds is None:
            return None
        if self._draw(self.straggler_rate):
            self._record("straggler", site)
            return seconds * self.straggler_factor
        return seconds


# ----------------------------------------------------------------- wrappers
class FaultyBackend:
    """Injects faults in front of a
    :class:`~repro_torch.core.trainer.TrainerBackend`.

    Deliberately NOT a ``TrainerBackend`` subclass: the base class carries
    capability class attributes (``supports_batched_stages``,
    ``supports_chain_fusion``) whose defaults would shadow the inner
    backend's values behind ``__getattr__`` delegation.  Everything not
    explicitly overridden delegates to the wrapped backend.
    """

    def __init__(self, inner, injector: FaultInjector):
        self.inner = inner
        self.fault_injector = injector

    def __getattr__(self, name):
        return getattr(self.inner, name)

    # ------------------------------------------------------ execution sites
    def run_stage(self, state, ctx):
        self.fault_injector.before_execute(
            f"stage:{ctx.node_id}@{ctx.stop}")
        return self.inner.run_stage(state, ctx)

    def run_chain(self, state, ctxs):
        self.fault_injector.before_execute(
            f"chain:{ctxs[0].node_id}@{ctxs[0].start}-{ctxs[-1].stop}")
        return self.inner.run_chain(state, ctxs)

    def run_stages_batched(self, states, ctxs):
        self.fault_injector.before_execute(
            f"group:{ctxs[0].node_id}@{ctxs[0].stop}x{len(ctxs)}")
        return self.inner.run_stages_batched(states, ctxs)

    def run_chains_batched(self, states, ctx_chains):
        self.fault_injector.before_execute(
            f"group-chain:{ctx_chains[0][0].node_id}"
            f"@{ctx_chains[0][0].start}x{len(ctx_chains)}")
        return self.inner.run_chains_batched(states, ctx_chains)

    def stage_seconds(self, ctx):
        return self.fault_injector.straggle(
            self.inner.stage_seconds(ctx),
            f"stage:{ctx.node_id}@{ctx.stop}")


class FaultyStore:
    """Injects outages in front of a checkpoint store.

    Only ``get``/``put``/``put_async`` are injection sites — eviction, GC
    and ``flush`` stay reliable so fault schedules never corrupt the
    store's own invariants (an outage loses *access*, not data).
    ``put_async`` raises synchronously (the outage hits the enqueue), so
    failures surface inside the executing chain's failure domain instead
    of at the flush barrier.
    """

    def __init__(self, inner, injector: FaultInjector):
        self.inner = inner
        self.fault_injector = injector

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __len__(self):  # dunders bypass __getattr__
        return len(self.inner)

    def get(self, cid):
        self.fault_injector.on_store_op("get", cid)
        return self.inner.get(cid)

    def put(self, path_key, step, tree, parent_cid=None):
        self.fault_injector.on_store_op("put", f"{path_key}@{step}")
        return self.inner.put(path_key, step, tree, parent_cid=parent_cid)

    def put_async(self, path_key, step, tree, parent_cid=None):
        self.fault_injector.on_store_op("put", f"{path_key}@{step}")
        return self.inner.put_async(path_key, step, tree,
                                    parent_cid=parent_cid)


def raw_store(store):
    """The underlying store of a possibly-wrapped store (outage-free
    access for verification/GC paths that must not draw from the fault
    schedule)."""
    return store.inner if isinstance(store, FaultyStore) else store
