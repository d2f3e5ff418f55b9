"""Schema'd session/gateway snapshots — the v5 on-disk format.

The container is the JAX package's (``repro.frontdoor.snapshot_v5``), so
a manifest written by either package can be compared key for key::

    [8-byte big-endian header length]
    [UTF-8 JSON header:
        {"magic": "hippo-snapshot", "version": 5,
         "kind": "session" | "gateway",
         "manifest": {... typed, kind-specific ...},
         "records": [{"name", "kind", "offset", "length", "digest"}, ...]}]
    [payload records, concatenated]

Everything with a stable schema lives **typed in the JSON manifest** —
plan key, engine knobs, the full :class:`EngineStats` (including
``by_study``), worker rows, the committed-checkpoint index, tenant maps,
quotas, leases, the admission queue's metadata.  Components that are
inherently Python object graphs (the search plan, the event heap, tuners,
scheduling-policy memory, a memory tier's trees) ride as named **pickle
records**, each independently blake2b-digested, so a torn tail or bit rot
is detected at load (and the rotation reader falls back a slot) instead of
surfacing as a confusing unpickle error.  A **gateway** envelope nests one
complete session record per plan key plus the front-door control state
(:class:`GatewayState`), so one SIGKILL'd file restores the whole
deployment.

Reading never imports a package outside ``repro_torch``, ``torch``,
``numpy`` and the standard library: the records are read by an unpickler
whose ``find_class`` admits only those (:func:`restricted_loads`) and
raises ``ValueError`` for anything else.  A snapshot the JAX package wrote
names ``repro.*`` classes, so reading it here raises instead of importing
the JAX package.

Cross-version story: the manifest's typed fields migrate like dataclass
defaults — a reader fills fields the file lacks and ignores fields it
does not know — and legacy v2-v4 *pickle* files are read by
:func:`repro_torch.core.engine.session.load_session` (sniffed, then
migrated forward by ``migrate_session``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import pickle
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.engine.session import (SESSION_FORMAT_VERSION,
                                             SessionState)

__all__ = ["GatewayState", "encode_snapshot", "decode_snapshot",
           "is_v5_snapshot", "restricted_loads", "SNAPSHOT_MAGIC"]

SNAPSHOT_MAGIC = "hippo-snapshot"

# packages whose classes a snapshot may name (prefix match), and the
# standard-library modules the session graph's pickles reach
_ADMITTED_PACKAGES = ("repro_torch", "torch", "numpy")
_ADMITTED_MODULES = frozenset({"builtins", "collections"})


def _digest(buf: bytes) -> str:
    return hashlib.blake2b(buf, digest_size=16).hexdigest()


class _RestrictedUnpickler(pickle.Unpickler):
    """An unpickler that imports nothing outside the admitted packages."""

    def find_class(self, module: str, name: str):
        root = module.split(".", 1)[0]
        if root in _ADMITTED_PACKAGES or module in _ADMITTED_MODULES:
            return super().find_class(module, name)
        raise ValueError(
            f"snapshot names {module}.{name}, outside repro_torch, torch, "
            "numpy and the standard library — not a repro_torch snapshot "
            "(one the JAX package wrote names repro.* classes)")


def restricted_loads(data: bytes) -> Any:
    """``pickle.loads`` through the restricted unpickler; any failure to
    read (a refused class, a torn stream) raises ``ValueError``."""
    try:
        return _RestrictedUnpickler(io.BytesIO(data)).load()
    except ValueError:
        raise
    except Exception as exc:
        raise ValueError(f"unreadable snapshot record: "
                         f"{type(exc).__name__}: {exc}") from exc


# --------------------------------------------------------------------------
# Gateway envelope state
# --------------------------------------------------------------------------


@dataclass
class GatewayState:
    """Complete front-door state: every per-key session plus the control
    plane around them (admission queues, quotas, tenant map, worker
    leases, the global clock, and the mid-run fault-schedule state)."""

    version: int
    time: float                                  # global virtual clock
    max_concurrent: Optional[int]
    seq: int                                     # admission sequence counter
    quotas: Dict[str, Dict[str, Any]]            # tenant -> quota fields
    default_quota: Dict[str, Any]
    tenants: Dict[str, Dict[str, str]]           # plan key -> {study: tenant}
    sessions: List[Tuple[str, SessionState]]     # (key, state), creation order
    slot_meshes: List[Any]                       # fleet slots (WorkerMesh|None)
    leases: List[Tuple[int, str, int, bool]]     # (slot, key, wid, draining)
    queued: List[Any]                            # admission.Submission objects
    retired: List[Tuple[str, Any, List[Any]]]    # (key, EngineStats, futures)
    injector_state: Optional[Dict[str, Any]] = None
    service: Dict[str, Any] = field(default_factory=dict)


# --------------------------------------------------------------------------
# Record container
# --------------------------------------------------------------------------


class _Records:
    """The payload: named, digested records after the JSON header."""

    def __init__(self):
        self.metas: List[Dict[str, Any]] = []
        self.chunks: List[bytes] = []
        self._off = 0

    def add(self, name: str, kind: str, payload: bytes) -> None:
        self.metas.append({"name": name, "kind": kind, "offset": self._off,
                           "length": len(payload),
                           "digest": _digest(payload)})
        self.chunks.append(payload)
        self._off += len(payload)

    def pickle(self, name: str, obj: Any) -> None:
        self.add(name, "pickle", pickle.dumps(obj))

    def pack(self, kind: str, manifest: Dict[str, Any]) -> bytes:
        header = json.dumps({
            "magic": SNAPSHOT_MAGIC, "version": SESSION_FORMAT_VERSION,
            "kind": kind, "manifest": manifest,
            "records": self.metas}).encode("utf-8")
        return (len(header).to_bytes(8, "big") + header
                + b"".join(self.chunks))


def _read_container(data: bytes) -> Tuple[Dict[str, Any],
                                          Dict[str, Tuple[str, bytes]]]:
    """(header, {record name: (kind, verified payload bytes)})."""
    if len(data) < 8:
        raise ValueError("snapshot truncated before the header length")
    hlen = int.from_bytes(data[:8], "big")
    if hlen <= 0 or 8 + hlen > len(data):
        raise ValueError("snapshot header length out of bounds")
    try:
        header = json.loads(data[8:8 + hlen])
    except Exception:
        raise ValueError("unreadable snapshot header")
    if not isinstance(header, dict) or header.get("magic") != SNAPSHOT_MAGIC:
        raise ValueError("not a repro snapshot (bad magic)")
    base = 8 + hlen
    records: Dict[str, Tuple[str, bytes]] = {}
    for meta in header.get("records", []):
        lo = base + meta["offset"]
        hi = lo + meta["length"]
        if hi > len(data):
            raise ValueError(
                f"snapshot record {meta['name']!r} truncated")
        payload = data[lo:hi]
        if _digest(payload) != meta["digest"]:
            raise ValueError(
                f"snapshot record {meta['name']!r} failed digest check "
                "(torn write or bit rot)")
        records[meta["name"]] = (meta["kind"], payload)
    return header, records


def _record(records, name: str, default=None):
    entry = records.get(name)
    if entry is None:
        return default
    kind, payload = entry
    if kind == "pickle":
        return restricted_loads(payload)
    return payload                               # "blob": raw bytes


def is_v5_snapshot(data: bytes) -> bool:
    """Cheap sniff: is this the v5 container (vs a legacy pickle, whose
    first byte is pickle's ``\\x80`` protocol marker)?"""
    try:
        if len(data) < 8:
            return False
        hlen = int.from_bytes(data[:8], "big")
        if hlen <= 0 or 8 + hlen > len(data):
            return False
        header = json.loads(data[8:8 + hlen])
        return (isinstance(header, dict)
                and header.get("magic") == SNAPSHOT_MAGIC)
    except Exception:
        return False


# --------------------------------------------------------------------------
# EngineStats <-> typed JSON
# --------------------------------------------------------------------------


def _stats_to_json(stats) -> Dict[str, Any]:
    return dataclasses.asdict(stats)


def _build_dataclass(cls, values: Dict[str, Any]):
    """Instantiate ``cls`` from a JSON dict: unknown fields are ignored,
    missing ones keep their dataclass defaults — the typed counterpart of
    ``migrate_session``'s stats backfill."""
    obj = cls()
    for name in cls.__dataclass_fields__:
        if name in values and name != "by_study":
            setattr(obj, name, values[name])
    return obj


def _stats_from_json(d: Dict[str, Any]):
    from repro_torch.core.engine.engine import EngineStats, StudyStats

    stats = _build_dataclass(EngineStats, d)
    stats.by_study = {sid: _build_dataclass(StudyStats, sd)
                      for sid, sd in (d.get("by_study") or {}).items()}
    return stats


# --------------------------------------------------------------------------
# Session encode/decode
# --------------------------------------------------------------------------

_KNOBS = ("n_workers", "gpus_per_worker", "share", "max_steps_per_chain",
          "batch_siblings", "chain_fusion")

# the object-graph components that ride together as ONE pickle record:
# event payloads, the waiter table, handles, trials and the scheduler all
# alias the same live objects (a stage event's handle IS the handle the
# service re-wires) — pickling them separately would sever that sharing
# and restore a session whose events update orphaned copies
_SESSION_GRAPH = ("plan", "events", "scheduler", "waiters", "killed",
                  "trials", "handles", "study_trials", "started",
                  "cancelled", "store_mem", "service")


def _encode_session(state: SessionState) -> bytes:
    recs = _Records()
    recs.pickle("graph", {name: getattr(state, name)
                          for name in _SESSION_GRAPH})
    # worker rows: typed scalars in the manifest, mesh objects (WorkerMesh
    # descriptors with their ShardingRules, or None) in one aligned pickle
    # record
    rows = [tuple(row) for row in state.workers]
    recs.pickle("worker_meshes", [row[3] for row in rows])
    manifest = {
        "plan_key": state.plan_key,
        "knobs": {k: getattr(state, k) for k in _KNOBS},
        "stats": _stats_to_json(state.stats),
        "workers": [[row[0], row[1], row[2], row[4], row[5], row[6],
                     bool(row[7])] for row in rows],
        "store_cids": sorted(state.store_cids),
    }
    return recs.pack("session", manifest)


def _decode_session(header: Dict[str, Any],
                    records: Dict[str, Tuple[str, bytes]]) -> SessionState:
    man = header["manifest"]
    knobs = man.get("knobs", {})
    meshes = _record(records, "worker_meshes", [])
    workers = []
    for i, row in enumerate(man.get("workers", [])):
        mesh = meshes[i] if i < len(meshes) else None
        wid, busy, idle, fails, quars, quntil, draining = row
        workers.append((wid, busy, idle, mesh, fails, quars, quntil,
                        bool(draining)))
    graph = _record(records, "graph", {})
    return SessionState(
        version=int(header.get("version", SESSION_FORMAT_VERSION)),
        plan_key=man["plan_key"],
        n_workers=knobs.get("n_workers", len(workers)),
        gpus_per_worker=knobs.get("gpus_per_worker", 1),
        share=knobs.get("share", True),
        max_steps_per_chain=knobs.get("max_steps_per_chain"),
        batch_siblings=knobs.get("batch_siblings", False),
        chain_fusion=knobs.get("chain_fusion", False),
        plan=graph.get("plan"),
        events=graph.get("events"),
        scheduler=graph.get("scheduler"),
        stats=_stats_from_json(man.get("stats", {})),
        workers=workers,
        waiters=graph.get("waiters", {}),
        killed=graph.get("killed", set()),
        trials=graph.get("trials", {}),
        handles=graph.get("handles", []),
        study_trials=graph.get("study_trials", {}),
        started=graph.get("started", set()),
        cancelled=graph.get("cancelled", set()),
        store_cids=set(man.get("store_cids", [])),
        store_mem=graph.get("store_mem"),
        service=graph.get("service", {}),
    )


# --------------------------------------------------------------------------
# Gateway encode/decode
# --------------------------------------------------------------------------


def _encode_gateway(state: GatewayState) -> bytes:
    recs = _Records()
    for i, (key, sess) in enumerate(state.sessions):
        recs.add(f"session.{i}", "blob", _encode_session(sess))
    recs.pickle("slot_meshes", state.slot_meshes)
    recs.pickle("queued_tuners", [sub.tuner for sub in state.queued])
    recs.pickle("retired_futures", [futs for _, _, futs in state.retired])
    recs.pickle("injector_state", state.injector_state)
    recs.pickle("service", state.service)
    manifest = {
        "time": state.time,
        "max_concurrent": state.max_concurrent,
        "seq": state.seq,
        "quotas": state.quotas,
        "default_quota": state.default_quota,
        "tenants": state.tenants,
        "session_keys": [key for key, _ in state.sessions],
        "leases": [list(lease) for lease in state.leases],
        "queued": [{"tenant": sub.tenant, "priority": sub.priority,
                    "seq": sub.seq, "key": sub.key,
                    "study_id": sub.study_id,
                    "min_devices": sub.min_devices,
                    "arrival": sub.arrival} for sub in state.queued],
        "retired": [{"key": key, "stats": _stats_to_json(stats)}
                    for key, stats, _ in state.retired],
    }
    return recs.pack("gateway", manifest)


def _decode_gateway(header: Dict[str, Any],
                    records: Dict[str, Tuple[str, bytes]]) -> GatewayState:
    from repro_torch.frontdoor.admission import Submission

    man = header["manifest"]
    sessions = []
    for i, key in enumerate(man.get("session_keys", [])):
        blob = _record(records, f"session.{i}")
        if blob is None:
            raise ValueError(f"gateway record session.{i} is missing")
        shdr, srecs = _read_container(blob)
        if shdr.get("kind") != "session":
            raise ValueError(f"gateway record session.{i} is not a session")
        sessions.append((key, _decode_session(shdr, srecs)))
    tuners = _record(records, "queued_tuners", [])
    queued = []
    for i, row in enumerate(man.get("queued", [])):
        queued.append(Submission(
            tenant=row["tenant"], priority=row["priority"], seq=row["seq"],
            key=row["key"], tuner=tuners[i] if i < len(tuners) else None,
            study_id=row.get("study_id"),
            min_devices=row.get("min_devices", 1),
            arrival=row.get("arrival")))
    retired_futs = _record(records, "retired_futures", [])
    retired = []
    for i, row in enumerate(man.get("retired", [])):
        futs = retired_futs[i] if i < len(retired_futs) else []
        retired.append((row["key"], _stats_from_json(row["stats"]), futs))
    return GatewayState(
        version=int(header.get("version", SESSION_FORMAT_VERSION)),
        time=man.get("time", 0.0),
        max_concurrent=man.get("max_concurrent"),
        seq=man.get("seq", 0),
        quotas=man.get("quotas", {}),
        default_quota=man.get("default_quota", {}),
        tenants=man.get("tenants", {}),
        sessions=sessions,
        slot_meshes=_record(records, "slot_meshes", []),
        leases=[tuple(lease) for lease in man.get("leases", [])],
        queued=queued,
        retired=retired,
        injector_state=_record(records, "injector_state"),
        service=_record(records, "service", {}),
    )


# --------------------------------------------------------------------------
# Public entry points
# --------------------------------------------------------------------------


def encode_snapshot(state) -> bytes:
    """Serialize a :class:`SessionState` or :class:`GatewayState` into the
    v5 container."""
    if isinstance(state, SessionState):
        return _encode_session(state)
    if isinstance(state, GatewayState):
        return _encode_gateway(state)
    raise TypeError(
        f"cannot snapshot {type(state).__name__!r} — expected SessionState "
        "or GatewayState")


def decode_snapshot(data: bytes):
    """Parse a v5 container into a :class:`SessionState` or
    :class:`GatewayState` (dispatched on the header's ``kind``); every
    record is digest-verified and read by the restricted unpickler.
    Raises ``ValueError`` on corruption or a foreign class, so rotation
    readers fall back to an older slot."""
    header, records = _read_container(data)
    kind = header.get("kind")
    if kind == "session":
        return _decode_session(header, records)
    if kind == "gateway":
        return _decode_gateway(header, records)
    raise ValueError(f"unknown snapshot kind {kind!r}")
