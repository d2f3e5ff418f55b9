"""Content-addressed checkpoint store (the GlusterFS analogue, §5 / §4.1).

Checkpoints are arbitrary trees (model params, optimizer state, data
pipeline cursor, simulated-trainer state, ...) addressed by the
*computation that produced them*: ``key = (search-plan path hash, step)``.
Any two trials — in the same study or different studies — whose
hyper-parameter values coincide up to ``step`` resolve to the same key and
therefore share the checkpoint, which is the entire reuse mechanism.

This package has the **memory tier** only: trees are kept as live objects,
so a ``TorchTrainer`` state stays on its device while it waits to be
forked from.  The serialized tiers of the JAX package (delta-encoded
single-file blobs on disk, a remote object store below it) are not ported
yet; ``CheckpointStore(directory=...)`` or ``remote=...`` raises
``NotImplementedError`` rather than silently keeping everything in
memory.  The byte and disk / remote counters exist and stay 0, as they do
for a directory-less store in the JAX package.

Write-behind layer (chain-fused execution): :meth:`put_async` records the
checkpoint in a *pending* cache and hands the commit to a background
writer thread, so stage boundaries inside a fused chain never stall on the
store.  Pending entries are indistinguishable from committed ones to every
reader — ``get`` / ``contains`` / ``__len__`` serve them, and ``evict``
cancels them (a kill that races an in-flight write discards the write).
:meth:`flush` is the barrier: it blocks until every pending write has
committed (engine shutdown).

Reference-counted eviction (``evict``) with recompute-on-miss handled
upstream: the engine simply re-derives the stage from the search plan if
a resume checkpoint is gone.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.utils.tree import tree_map

__all__ = ["CheckpointStore", "stack_pytrees", "unstack_pytree"]


# ---------------------------------------------------------------------------
# stacked-trial helpers (sibling batching)
# ---------------------------------------------------------------------------


def stack_pytrees(trees: Sequence[Any]) -> Any:
    """Stack structurally-identical tensor trees along a new leading axis
    (trial axis of a batched sibling group)."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def unstack_pytree(tree: Any, n: int) -> List[Any]:
    """Split a leading-axis-stacked tree back into ``n`` per-trial trees
    (the inverse of :func:`stack_pytrees`)."""
    return [tree_map(lambda x, g=g: x[g], tree) for g in range(n)]


class CheckpointStore:
    """put/get trees by (path_key, step) — memory tier.

    ``parent_cid`` on the put paths names the fork-point checkpoint; the
    serialized tiers delta-encode against it, the memory tier stores live
    objects and has nothing to encode."""

    def __init__(self, directory: Optional[str] = None,
                 remote: Optional[Any] = None):
        if directory is not None or remote is not None:
            raise NotImplementedError(
                "repro_torch has the memory tier only: the disk / delta / "
                "tiered checkpoint store is ROADMAP queue A, slice 5")
        self.directory = None
        self.remote = None
        self._mem: Dict[str, Any] = {}
        # ---- traffic counters (byte / disk / remote ones stay 0 here) ----
        self.bytes_written = 0
        self.bytes_read = 0
        self.logical_bytes = 0
        self.delta_bytes = 0
        self.full_bytes = 0
        self.delta_commits = 0
        self.full_commits = 0
        self.delta_rebases = 0
        self.delta_fallbacks = 0
        self.puts = 0
        self.async_puts = 0
        self.gets = 0
        self.hits = 0
        # ---- per-tier read accounting ----
        self.mem_hits = 0           # pending cache / memory map
        self.disk_hits = 0
        self.remote_hits = 0
        self.store_misses = 0
        self.tier_promotions = 0
        self.tier_demotions = 0
        self.tier_demotion_errors = 0
        self.remote_bytes_read = 0
        self.remote_bytes_written = 0
        self.tmp_reclaimed = 0
        # ---- write-behind state (all guarded by _cv's lock) ----
        self._pending: Dict[str, Any] = {}   # cid -> tree awaiting commit
        self._work: deque = deque()          # commit order
        self._cancelled: set = set()         # evicted while commit in flight
        self._cv = threading.Condition()
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None

    # -------------------------------------------------------------- keys
    @staticmethod
    def ckpt_id(path_key: str, step: int) -> str:
        return f"{path_key}@{step}"

    @property
    def dedup_ratio(self) -> float:
        """Full-serialization bytes per physical byte written; 1.0 with
        nothing written, as always in the memory tier."""
        return (self.logical_bytes / self.bytes_written
                if self.bytes_written else 1.0)

    # --------------------------------------------------------------- put
    def put(self, path_key: str, step: int, tree: Any,
            parent_cid: Optional[str] = None) -> str:
        cid = self.ckpt_id(path_key, step)
        self.puts += 1
        if self._revoke_or_dedup(cid):
            return cid  # content already produced by a sibling — dedup
        self._mem[cid] = tree
        return cid

    def put_async(self, path_key: str, step: int, tree: Any,
                  parent_cid: Optional[str] = None) -> str:
        """Write-behind ``put``: the tree enters the pending cache (served
        to readers immediately) and the commit happens on the background
        writer thread.  Returns the cid exactly like :meth:`put`;
        :meth:`flush` is the barrier."""
        cid = self.ckpt_id(path_key, step)
        self.puts += 1
        if self._revoke_or_dedup(cid):
            return cid
        with self._cv:
            self._pending[cid] = tree
            self._work.append(cid)
            self.async_puts += 1
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._writer_loop, name="ckpt-writer", daemon=True)
                self._writer.start()
            self._cv.notify_all()
        return cid

    def _revoke_or_dedup(self, cid: str) -> bool:
        """True when ``cid`` is already held (pending / committed) and the
        put can dedup.  A cid whose in-flight commit was cancelled by an
        eviction is NOT deduped — that commit is about to be dropped — but
        the cancellation is revoked so the re-deposited content (same cid
        == same content) commits after all."""
        with self._cv:
            if cid in self._pending:
                return True
            if cid in self._cancelled:
                self._cancelled.discard(cid)
                return False
        return cid in self._mem

    def _known(self, cid: str) -> bool:
        with self._cv:
            if cid in self._pending:
                return True
            if cid in self._cancelled:
                return False
        return cid in self._mem

    # --------------------------------------------------------- writer thread
    _IDLE_EXIT_SECONDS = 5.0   # idle writer threads retire themselves

    def _writer_loop(self) -> None:
        cid = None
        try:
            while True:
                cid = None
                with self._cv:
                    while not self._work:
                        if not self._cv.wait(timeout=self._IDLE_EXIT_SECONDS):
                            if not self._work:
                                # idle too long: retire so the thread (and
                                # the store it pins) can be reclaimed;
                                # put_async spawns a fresh writer on the
                                # next deposit
                                self._writer = None
                                return
                    cid = self._work.popleft()
                    tree = self._pending.get(cid)
                if tree is None:
                    continue  # superseded (a revoked re-put already committed)
                with self._cv:
                    if cid in self._cancelled:
                        # evicted between pick-up and commit: never publish
                        self._cancelled.discard(cid)
                    else:
                        # publish + state transition in ONE critical section
                        # so __len__ never counts a cid twice
                        if cid in self._pending:
                            self._mem[cid] = tree
                        self._pending.pop(cid, None)
                    self._cv.notify_all()
        except BaseException as e:
            # unexpected thread death: surface at the next flush() and make
            # sure the in-flight cid is not stranded
            with self._cv:
                self._write_error = e
                if cid is not None:
                    self._pending.pop(cid, None)
                    self._cancelled.discard(cid)
        finally:
            # thread exit — expected (idle retire) or not — must never leave
            # self._writer pointing at a dead thread: put_async would skip
            # spawning a replacement and flush() would hang on the queue
            with self._cv:
                if self._writer is threading.current_thread():
                    self._writer = None
                    if self._work:
                        self._writer = threading.Thread(
                            target=self._writer_loop, name="ckpt-writer",
                            daemon=True)
                        self._writer.start()
                self._cv.notify_all()

    def flush(self) -> None:
        """Block until every pending write has committed and every
        cancelled in-flight commit has been dropped.  Raises if the writer
        thread failed."""
        with self._cv:
            while self._pending or self._cancelled:
                self._cv.wait()
            if self._write_error is not None:
                err, self._write_error = self._write_error, None
                raise RuntimeError("checkpoint write-behind failed") from err

    def close(self) -> None:
        """Flush; the memory tier holds nothing else to release."""
        self.flush()

    @property
    def pending_writes(self) -> int:
        with self._cv:
            return len(self._pending)

    # --------------------------------------------------------------- get
    def get(self, cid: str) -> Any:
        """The tree committed under ``cid``, or ``KeyError``.

        Returned trees are SHARED with the pending / in-memory map, so
        treat them as read-only; copy before mutating.  Trainers are
        functional (stages return new state, optimizer updates write fresh
        tensors), so nothing in the engine mutates a restored tree in
        place."""
        self.gets += 1
        with self._cv:
            tree = self._pending.get(cid)
            cancelled = cid in self._cancelled
        if tree is not None:        # in-flight write: serve the live object
            self.hits += 1
            self.mem_hits += 1
            return tree
        if cancelled:               # evicted mid-commit: gone to readers
            self.store_misses += 1
            raise KeyError(f"checkpoint {cid!r} not in store")
        if cid in self._mem:
            self.hits += 1
            self.mem_hits += 1
            return self._mem[cid]
        self.store_misses += 1
        raise KeyError(f"checkpoint {cid!r} not in store")

    def contains(self, cid: str) -> bool:
        return self._known(cid)

    def committed_ids(self) -> set:
        """Ids of every held checkpoint (call :meth:`flush` first so
        nothing is left pending)."""
        with self._cv:
            ids = set(self._pending) - self._cancelled
        ids |= set(self._mem)
        return ids

    # ------------------------------------------------------------- evict
    def evict(self, cid: str) -> bool:
        with self._cv:
            if cid in self._pending:
                del self._pending[cid]
                try:
                    # not yet picked up by the writer: nothing to undo
                    self._work.remove(cid)
                except ValueError:
                    # commit in flight: the writer drops it on completion
                    self._cancelled.add(cid)
                self._cv.notify_all()
                return True
        if cid in self._mem:
            del self._mem[cid]
            return True
        return False

    def __len__(self) -> int:
        # NB: an empty store is falsy — callers test ``store is None``
        with self._cv:
            return len(self._mem) + len(self._pending)
