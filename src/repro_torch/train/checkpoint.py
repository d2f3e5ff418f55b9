"""Content-addressed checkpoint store (the GlusterFS analogue, §5 / §4.1).

Checkpoints are arbitrary trees (model params, optimizer state, data
pipeline cursor, simulated-trainer state, ...) addressed by the
*computation that produced them*: ``key = (search-plan path hash, step)``.
Any two trials — in the same study or different studies — whose
hyper-parameter values coincide up to ``step`` resolve to the same key and
therefore share the checkpoint, which is the entire reuse mechanism.

Three composable layers over one public API (``put`` / ``put_async`` /
``get`` / ``evict`` / ``flush``), as in the JAX package:

**Delta encoding.**  ``put(..., parent_cid=...)`` (threaded from the
dispatcher, which knows every boundary's fork point) splits each leaf into
``chunk_bytes`` chunks, hashes them (blake2b, 16-byte digests) against the
parent's chunk index, and commits only the changed chunks plus a reference
map.  A commit whose parent already sits at ``max_delta_depth`` is
*rebased* to a full snapshot; a delta whose parent has vanished reads as
missing (``KeyError``) and recompute-on-miss upstream re-derives it.

**Single-file blob** (``BLOB_FORMAT = 2``): an 8-byte header length, a
JSON header (``v``, ``kind``, ``parent``, ``depth``, ``chunk``,
``tree_len`` and per leaf ``d`` dtype, ``s`` shape, ``n`` bytes, ``c``
chunk list of ``[digest, bytes, inline]``), the pickled tree structure,
then the inline chunks.  Reads build leaves over the blob's bytes
(``torch.frombuffer``): no copy.

**Tiers.**  host LRU read cache → a directory → an injectable remote
:class:`ObjectStore` (a directory-backed one is provided).  With
``disk_capacity_bytes`` and a remote tier, least-recently-used blobs past
the capacity demote to the remote tier in the background; a read that
misses the directory fetches from the remote and promotes the blob back.
Every tier is safely lossy: recompute-on-miss re-derives what a tier
dropped.  Without ``directory`` the store is the memory tier: trees are
kept as live objects, so a ``TorchTrainer`` state stays on its device.

Where this package's blobs differ from the JAX package's, and why:

* **Leaf bytes and dtypes.**  A tensor leaf is detached, made contiguous
  (a view such as a group member ``x[g]`` or a strided leaf included) and
  copied to the host; ``d`` is numpy's ``dtype.str`` of the same bytes
  (``'<f4'``, ``'<i8'``, ``'|b1'``, ...), so headers, chunk digests and
  payloads equal the JAX package's for every dtype both can read.  bf16
  has no numpy dtype: its bytes are read as 16-bit integers and ``d`` is
  ``"bfloat16"`` (ml_dtypes' name), which reads back as
  ``torch.bfloat16``.  The JAX package records ml_dtypes' ``'<V2'`` there,
  which reads back as void bytes, so its bf16 checkpoints do not
  round-trip; that tag is not copied.
* **The tree section** pickles this package's own containers (dict
  insertion order, lists, tuples, ``None``) with a tag per leaf — a
  tensor, a numpy array or scalar, or a Python ``int`` / ``float`` /
  ``bool`` / ``str`` — and holds no torch object.  A trainer state's
  ``step``, ``opt_name`` and ``data`` (four ints) come back as the same
  Python values.  Dicts flatten in insertion order here and in sorted key
  order in the JAX package; a delta matches leaves by position, which is
  consistent within either package.
* **Restored tensors** live on the CPU, over the blob's bytes, and share
  them with the read cache.  A blob on the directory is mapped, not read
  (the JAX package reads it into a ``bytearray``): a writable private
  mapping whose pages are the file system's, so a 16 GB blob in a
  memory-backed directory does not take 16 GB more of host memory.  Torch has no read-only tensors, so a restored
  tree is safe to share only because no trainer mutates one (each stage
  returns a new state; ``tests/test_torch_checkpoint.py`` checks it).
* **Write-behind from a CUDA device.**  ``put_async`` on a tree with CUDA
  leaves starts their device-to-host copy at once: on a side stream
  ordered after the producer's stream by an event, into one pinned host
  buffer per tree (PyTorch's caching host allocator reuses the buffers),
  with ``record_stream`` on every source, so the device memory is free for
  reuse as soon as its copy has landed — the pending entry keeps only the
  host copy.  Readers of a pending entry get that host copy after its copy
  event; so does the writer.  A deposit waits (inside ``put_async``, so
  the dispatcher counts it in ``ckpt_save_seconds``) while earlier host
  copies awaiting their commit would exceed a quarter of the host's
  memory (one 16 GB mamba2-2.7b state on a 100 GB host).
* **``serializer_procs``** runs the same :func:`_encode_leaves` on a pool
  of that many *threads*, over chunk-aligned ranges of the leaves
  (``hashlib`` releases the GIL for each 64 KiB chunk), and writes the
  blob's pieces from the same pool with ``os.pwritev``; the blob is byte
  for byte the inline encoder's.  The JAX package uses a process pool,
  which pickles every buffer into a worker.

Write-behind layer (chain-fused execution): :meth:`put_async` records the
checkpoint in a *pending* cache and hands the commit (serialize, write,
publish) to a background writer thread, so stage boundaries never stall on
checkpoint I/O.  Pending entries are indistinguishable from committed ones
to every reader — ``get`` / ``contains`` / ``__len__`` serve them, and
``evict`` cancels them (a kill that races an in-flight write discards the
write).  :meth:`flush` is the barrier: it blocks until every pending write
has committed and raises if the writer failed.

Directory hygiene: construction sweeps stale ``*.tmp`` files into
``tmp_reclaimed`` and indexes the directory once; the index is maintained
by publish / evict / demote / promote.
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os
import pickle
import threading
from collections import OrderedDict, deque
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

__all__ = ["CheckpointStore", "ObjectStore", "DirectoryObjectStore",
           "stack_pytrees", "unstack_pytree"]

BLOB_FORMAT = 2                     # single-file header+payload layout
DEFAULT_CHUNK = 1 << 16             # 64 KiB content-hash granularity
BF16 = "bfloat16"                   # ``d`` of a bf16 leaf (ml_dtypes' name)
_PIECE = 1 << 26                    # bytes of one pooled encode / write task
_IOV_MAX = 1024                     # buffers per os.pwritev (Linux's bound)
_PY_LEAVES = {"int": int, "float": float, "bool": bool, "str": str}


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


# ---------------------------------------------------------------------------
# remote tier interface
# ---------------------------------------------------------------------------


class ObjectStore:
    """Injectable remote-tier interface (S3/GCS in a deployment).

    Keys are checkpoint cids, values are opaque blob bytes.  ``get`` /
    ``delete`` raise ``KeyError`` for absent keys; ``keys()`` enumerates
    (used once at attach time to seed the remote index)."""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def contains(self, key: str) -> bool:
        raise NotImplementedError

    def keys(self) -> Iterable[str]:
        raise NotImplementedError


class DirectoryObjectStore(ObjectStore):
    """Directory-backed :class:`ObjectStore` — the test/dev stand-in for a
    real object store (atomic publish via tmp + rename)."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _p(self, key: str) -> str:
        return os.path.join(self.directory, key.replace("/", "_") + ".blob")

    def put(self, key: str, data: bytes) -> None:
        tmp = f"{self._p(key)}.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, self._p(key))

    def get(self, key: str) -> bytes:
        try:
            with open(self._p(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(key)

    def delete(self, key: str) -> None:
        try:
            os.remove(self._p(key))
        except FileNotFoundError:
            raise KeyError(key)

    def contains(self, key: str) -> bool:
        return os.path.exists(self._p(key))

    def keys(self) -> Iterable[str]:
        return [f[:-len(".blob")] for f in os.listdir(self.directory)
                if f.endswith(".blob")]


# ---------------------------------------------------------------------------
# leaves and blob encoding (pure functions, shared by the inline and the
# pooled serializers)
# ---------------------------------------------------------------------------


def _leaf_kind(x: Any) -> str:
    """The tree section's tag of a leaf: how :meth:`CheckpointStore.get`
    rebuilds it."""
    if isinstance(x, torch.Tensor):
        return "tensor"
    if isinstance(x, np.ndarray):
        return "ndarray"
    if isinstance(x, np.generic):
        return "numpy"
    kind = type(x).__name__
    if kind not in _PY_LEAVES:
        raise TypeError(f"cannot checkpoint a leaf of type {kind}")
    return kind


def _leaf_view(x: Any) -> Tuple[str, tuple, memoryview]:
    """``(d, shape, bytes)`` of a leaf: its dtype tag, its shape and a
    zero-copy byte view of its contiguous host copy."""
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            arr, d = t.view(torch.int16).numpy(), BF16
        else:
            arr = t.numpy()
            d = arr.dtype.str
    else:
        arr = np.asarray(x)
        if not arr.flags["C_CONTIGUOUS"]:
            # not unconditional ascontiguousarray: it promotes 0-d scalars
            # to 1-d, corrupting the recorded leaf shape
            arr = np.ascontiguousarray(arr)
        d = arr.dtype.str
    return d, arr.shape, memoryview(arr.reshape(-1).view(np.uint8))


def _torch_dtype(d: str) -> torch.dtype:
    if d == BF16:
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, np.dtype(d))).dtype


def _restore_leaf(kind: str, meta: dict, buf) -> Any:
    """Rebuild one leaf of tag ``kind`` over ``buf`` (its ``n`` bytes)."""
    d, shape = meta["d"], meta["s"]
    if kind == "tensor":
        dt = _torch_dtype(d)
        t = (torch.frombuffer(buf, dtype=dt) if meta["n"]
             else torch.empty(0, dtype=dt))
        return t.reshape(shape)
    arr = np.frombuffer(buf, dtype=np.dtype(d)).reshape(shape)
    arr.flags.writeable = False          # shared with the read cache
    if kind == "ndarray":
        return arr
    if kind == "numpy":
        return arr[()]
    return _PY_LEAVES[kind](arr.item())


def _digest(buf) -> str:
    return hashlib.blake2b(buf, digest_size=16).hexdigest()


def _encode_leaves(bufs: Sequence, dtypes: Sequence[str],
                   shapes: Sequence[tuple],
                   parent: Optional[List[List[Tuple[str, int]]]],
                   chunk: int):
    """Chunk + hash every leaf buffer; against ``parent`` (per-leaf chunk
    digest lists) emit references instead of inline bytes for unchanged
    chunks.  Returns ``(leaf_metas, parts, digests, any_ref, logical)``
    where ``parts`` are the inline payload buffers in write order."""
    leaf_metas, parts, digests = [], [], []
    any_ref, logical = False, 0
    for i, (buf, dt, shape) in enumerate(zip(bufs, dtypes, shapes)):
        size = len(buf)
        logical += size
        pdigs = (parent[i] if parent is not None and i < len(parent)
                 else None)
        chunks, ldigs = [], []
        for ci, off in enumerate(range(0, size, chunk)):
            n = min(chunk, size - off)
            piece = buf[off:off + n]
            h = _digest(piece)
            ldigs.append((h, n))
            if pdigs is not None and ci < len(pdigs) and pdigs[ci] == (h, n):
                chunks.append([h, n, 0])          # reference into parent
                any_ref = True
            else:
                chunks.append([h, n, 1])          # inline
                parts.append(piece)
        leaf_metas.append({"d": dt, "s": list(shape), "n": size,
                           "c": chunks})
        digests.append(ldigs)
    return leaf_metas, parts, digests, any_ref, logical


def _encode_leaves_pooled(pool, bufs: Sequence, dtypes: Sequence[str],
                          shapes: Sequence[tuple],
                          parent: Optional[List[List[Tuple[str, int]]]],
                          chunk: int):
    """:func:`_encode_leaves` run on a thread ``pool`` over chunk-aligned
    pieces of at most ``_PIECE`` bytes of each leaf, merged in order: the
    same result, element for element."""
    span = max(chunk, _PIECE // chunk * chunk)
    tasks = []
    for i, buf in enumerate(bufs):
        pdigs = (parent[i] if parent is not None and i < len(parent)
                 else None)
        for off in range(0, len(buf), span) if len(buf) else (0,):
            c0 = off // chunk
            sub = None if pdigs is None else [pdigs[c0:c0 + span // chunk]]
            tasks.append((i, pool.submit(_encode_leaves,
                                         [buf[off:off + span]], [dtypes[i]],
                                         [shapes[i]], sub, chunk)))
    leaf_metas, parts, digests = [], [], []
    any_ref, logical = False, 0
    for i, fut in tasks:
        metas, p, digs, ref, n = fut.result()
        if len(leaf_metas) == i:
            leaf_metas.append({"d": dtypes[i], "s": list(shapes[i]),
                               "n": len(bufs[i]), "c": []})
            digests.append([])
        leaf_metas[i]["c"] += metas[0]["c"]
        digests[i] += digs[0]
        parts += p
        any_ref |= ref
        logical += n
    return leaf_metas, parts, digests, any_ref, logical


def _pwrite_all(fd: int, pieces: Sequence, offset: int) -> None:
    """Write ``pieces`` back to back at ``offset`` (``os.pwritev``, at most
    ``_IOV_MAX`` buffers a call), resuming after short writes."""
    pieces, i = list(pieces), 0
    while i < len(pieces):
        n = os.pwritev(fd, pieces[i:i + _IOV_MAX], offset)
        offset += n
        while i < len(pieces) and n >= len(pieces[i]):
            n -= len(pieces[i])
            i += 1
        if n:
            pieces[i] = memoryview(pieces[i])[n:]


def _write_blob(path: str, pieces: Sequence, pool=None) -> int:
    """Write ``pieces`` as the file ``path``, in ``_PIECE``-byte runs on
    ``pool`` when given; returns the file's length."""
    runs, run, off, size = [], [], 0, 0
    for p in pieces:
        run.append(p)
        size += len(p)
        if size - off >= _PIECE:
            runs.append((run, off))
            run, off = [], size
    if run:
        runs.append((run, off))
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        if pool is None or len(runs) < 2:
            for run, off in runs:
                _pwrite_all(fd, run, off)
        else:
            for fut in [pool.submit(_pwrite_all, fd, run, off)
                        for run, off in runs]:
                fut.result()
    finally:
        os.close(fd)
    return size


def _map_file(path: str):
    """The whole file as a writable private mapping (``mmap.ACCESS_COPY``):
    its pages are the file system's own until written, so a blob read from
    a memory-backed directory costs no second copy of host memory."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if not size:
            return bytearray()
        return mmap.mmap(f.fileno(), size, access=mmap.ACCESS_COPY)


class _Staged(tuple):
    """Serialized-but-unpublished commit: ``(kind, depth, digests,
    payload_len, logical_len, file_len, tmp_path)``."""
    __slots__ = ()

    kind = property(lambda s: s[0])
    depth = property(lambda s: s[1])
    digests = property(lambda s: s[2])
    payload_len = property(lambda s: s[3])
    logical_len = property(lambda s: s[4])
    file_len = property(lambda s: s[5])
    tmp = property(lambda s: s[6])


class _HostCopy:
    """A pending tree whose CUDA leaves are being copied to one pinned host
    buffer: ``tree`` is the host tree, valid once the ``done`` event has
    completed (:meth:`wait`); ``nbytes`` the buffer's size."""
    __slots__ = ("tree", "done", "nbytes")

    def __init__(self, tree: Any, done, nbytes: int):
        self.tree, self.done, self.nbytes = tree, done, nbytes

    def wait(self) -> Any:
        self.done.synchronize()
        return self.tree


def _copy_to_host(tree: Any, streams: Dict[torch.device, Any]) -> Any:
    """``tree`` itself when no leaf is a CUDA tensor, else a
    :class:`_HostCopy` whose copies run on a side stream of the leaves'
    device (kept in ``streams``), ordered after the producer's current
    stream."""
    cuda = [x for x in tree_leaves(tree)
            if isinstance(x, torch.Tensor) and x.is_cuda]
    if not cuda:
        return tree
    dev = cuda[0].device
    offsets, total = [], 0
    for x in cuda:                      # 64-byte aligned leaf offsets
        offsets.append(total)
        total += -(-x.numel() * x.element_size() // 64) * 64
    buf = torch.empty(total, dtype=torch.uint8, pin_memory=True)
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(dev))
    side = streams.get(dev)
    if side is None:
        side = streams[dev] = torch.cuda.Stream(dev)
    host = {}
    with torch.cuda.stream(side):
        side.wait_event(ready)
        for x, off in zip(cuda, offsets):
            n = x.numel() * x.element_size()
            h = buf[off:off + n].view(x.dtype).view(x.shape)
            h.copy_(x.detach(), non_blocking=True)
            x.record_stream(side)       # its memory waits for this copy
            host[id(x)] = h
        done = torch.cuda.Event()
        done.record(side)
    return _HostCopy(tree_map(lambda x: host.get(id(x), x), tree), done,
                     total)


def _on_host(x: Any) -> Any:
    """A CUDA tensor's host copy; any other leaf itself."""
    return x.detach().cpu() if isinstance(x, torch.Tensor) and x.is_cuda \
        else x


def _cuda_bytes(tree: Any) -> int:
    """Bytes of ``tree``'s CUDA leaves: what its host copy pins."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor) and x.is_cuda)


def _host_budget() -> int:
    """Bytes of host copies that may await their commit at once: a
    quarter of the host's memory."""
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 4


class CheckpointStore:
    """put/get trees by (path_key, step); optionally spill to tiers.

    ``directory`` selects the serialized tiers (else the memory tier);
    ``read_cache_entries`` bounds their LRU read cache (0 disables it).
    ``remote`` attaches an :class:`ObjectStore` tier below the directory;
    with ``disk_capacity_bytes`` set, LRU blobs past the capacity demote to
    it in the background.  ``parent_cid`` on the put paths enables delta
    encoding (serialized tiers only — the memory tier stores live objects
    and needs no encoding).  ``serializer_procs > 0`` hashes and writes on
    a pool of that many threads (module docstring)."""

    def __init__(self, directory: Optional[str] = None,
                 read_cache_entries: int = 32,
                 remote: Optional[ObjectStore] = None,
                 disk_capacity_bytes: Optional[int] = None,
                 max_delta_depth: int = 4,
                 chunk_bytes: int = DEFAULT_CHUNK,
                 serializer_procs: int = 0):
        self.directory = directory
        if directory:
            os.makedirs(directory, exist_ok=True)
        self._mem: Dict[str, Any] = {}
        self.remote = remote
        self.disk_capacity_bytes = disk_capacity_bytes
        self.max_delta_depth = int(max_delta_depth)
        self.chunk_bytes = int(chunk_bytes)
        # ---- traffic counters ----
        self.bytes_written = 0      # physical file bytes committed to disk
        self.bytes_read = 0         # physical file bytes read off disk
        self.logical_bytes = 0      # full-serialization-equivalent bytes
        self.delta_bytes = 0        # file bytes of delta-kind commits
        self.full_bytes = 0         # file bytes of full-kind commits
        self.delta_commits = 0
        self.full_commits = 0
        self.delta_rebases = 0      # depth-bound hits rebased to full
        self.delta_fallbacks = 0    # parent meta unavailable -> full
        self.puts = 0
        self.async_puts = 0
        self.gets = 0
        self.hits = 0
        # ---- per-tier read accounting ----
        self.mem_hits = 0           # pending cache / memory map / LRU cache
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
        self._pending_parent: Dict[str, Optional[str]] = {}
        self._work: deque = deque()          # commit order
        self._cancelled: set = set()         # evicted while commit in flight
        self._cv = threading.Condition()
        self._writer: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self._host_bytes = 0                 # pending host copies' bytes
        self._copy_streams: Dict[torch.device, Any] = {}  # device -> stream
        # ---- directory read path ----
        self.read_cache_entries = int(read_cache_entries)
        self._read_cache: "OrderedDict[str, Any]" = OrderedDict()
        # ---- tier indexes (guarded by _cv) ----
        # disk index doubles as the demotion LRU: cid -> file bytes
        self._disk_cids: "OrderedDict[str, int]" = OrderedDict()
        self._disk_bytes = 0
        self._remote_cids: set = set()
        self._demoting: set = set()          # demotion uploads in flight
        # cid -> (delta depth, per-leaf chunk digests) for delta encoding
        self._blob_meta: Dict[str, Tuple[int, List[List[Tuple[str, int]]]]] = {}
        self._serializer_procs = int(serializer_procs)
        self._pool = None
        if directory:
            self._init_scan()
        if remote is not None:
            self._remote_cids.update(remote.keys())

    def _init_scan(self) -> None:
        """One-time directory scan: build the incremental disk-cid index
        and reap stale temp files a reaped writer thread left behind."""
        for f in sorted(os.listdir(self.directory)):
            p = os.path.join(self.directory, f)
            if f.endswith(".tmp"):
                try:
                    os.remove(p)
                    self.tmp_reclaimed += 1
                except OSError:  # pragma: no cover - racing sweeper
                    pass
            elif f.endswith(".ckpt"):
                try:
                    size = os.path.getsize(p)
                except OSError:  # pragma: no cover - racing eviction
                    continue
                self._disk_cids[f[:-len(".ckpt")]] = size
                self._disk_bytes += size

    # -------------------------------------------------------------- keys
    @staticmethod
    def ckpt_id(path_key: str, step: int) -> str:
        return f"{path_key}@{step}"

    @property
    def dedup_ratio(self) -> float:
        """Full-serialization bytes per physical byte written (>= 1 when
        delta encoding is saving storage; 1.0 with nothing written)."""
        return (self.logical_bytes / self.bytes_written
                if self.bytes_written else 1.0)

    # --------------------------------------------------------------- put
    def put(self, path_key: str, step: int, tree: Any,
            parent_cid: Optional[str] = None) -> str:
        cid = self.ckpt_id(path_key, step)
        self.puts += 1
        if self._revoke_or_dedup(cid):
            return cid  # content already produced by a sibling — dedup
        if self.directory:
            staged = self._serialize_disk(cid, tree, parent_cid)
            with self._cv:   # counters/publish shared with the writer thread
                self._publish_disk(cid, staged)
            self._demote_excess()
        else:
            self._mem[cid] = tree
        return cid

    def put_async(self, path_key: str, step: int, tree: Any,
                  parent_cid: Optional[str] = None) -> str:
        """Write-behind ``put``: the tree enters the pending cache (served
        to readers immediately) and the commit happens on the background
        writer thread — for the serialized tiers, after the device-to-host
        copy this call starts (module docstring).  Returns the cid exactly
        like :meth:`put`; :meth:`flush` is the durability barrier."""
        cid = self.ckpt_id(path_key, step)
        self.puts += 1
        if self._revoke_or_dedup(cid):
            return cid
        if self.directory:
            self._await_host_room(_cuda_bytes(tree))
            tree = _copy_to_host(tree, self._copy_streams)
        with self._cv:
            self._pending[cid] = tree
            self._pending_parent[cid] = parent_cid
            if isinstance(tree, _HostCopy):
                self._host_bytes += tree.nbytes
            self._work.append(cid)
            self.async_puts += 1
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._writer_loop, name="ckpt-writer", daemon=True)
                self._writer.start()
            self._cv.notify_all()
        return cid

    def _await_host_room(self, need: int) -> None:
        """Back-pressure on host copies: wait while the pending ones and a
        new one of ``need`` bytes would pass the host budget (one pending
        copy is always allowed)."""
        if not need:
            return
        budget = _host_budget()
        with self._cv:
            while self._host_bytes and self._host_bytes + need > budget:
                if self._write_error is not None or self._writer is None:
                    return          # surfaced by the next flush()
                self._cv.wait()

    def _unpend(self, cid: str) -> None:
        """Drop ``cid``'s pending entry (caller holds ``_cv``)."""
        tree = self._pending.pop(cid, None)
        self._pending_parent.pop(cid, None)
        if isinstance(tree, _HostCopy):
            self._host_bytes -= tree.nbytes

    def _revoke_or_dedup(self, cid: str) -> bool:
        """True when ``cid`` is already held (pending / committed) and the
        put can dedup.  A cid whose in-flight commit was cancelled by an
        eviction is NOT deduped — its disk bytes are about to be undone —
        but the cancellation is revoked so the undo never happens to the
        re-deposited content (same cid == same content)."""
        with self._cv:
            if cid in self._pending:
                return True
            if cid in self._cancelled:
                self._cancelled.discard(cid)
                return False
            if cid in self._disk_cids or cid in self._remote_cids:
                return True
        return cid in self._mem

    def _known(self, cid: str) -> bool:
        with self._cv:
            if cid in self._pending:
                return True
            if cid in self._cancelled:
                # an in-flight commit of this content is being undone; its
                # disk bytes are untrustworthy until the undo lands
                return False
            if cid in self._disk_cids or cid in self._remote_cids:
                return True
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
                    parent_cid = self._pending_parent.get(cid)
                if tree is None:
                    continue  # superseded (a revoked re-put already committed)
                try:
                    staged = (self._serialize_disk(cid, _settled(tree),
                                                   parent_cid)
                              if self.directory else None)
                except BaseException as e:  # surfaced at the next flush()
                    with self._cv:
                        self._write_error = e
                        self._unpend(cid)
                        self._cancelled.discard(cid)
                        self._cv.notify_all()
                    continue
                with self._cv:
                    try:
                        if cid in self._cancelled:
                            # evicted while serializing: the commit never
                            # publishes — the final path is untouched, only
                            # temps to discard
                            self._cancelled.discard(cid)
                            if staged is not None:
                                os.remove(staged.tmp)
                        else:
                            # publish + state transition in ONE critical
                            # section so __len__ never sees a cid as both
                            # pending and on disk
                            if staged is not None:
                                self._publish_disk(cid, staged)
                            elif cid in self._pending:
                                self._mem[cid] = tree
                            self._unpend(cid)
                    except BaseException as e:
                        # a publish/cancel failure must never strand the
                        # cid in _pending/_cancelled: flush() would
                        # deadlock instead of surfacing the error
                        self._write_error = e
                        self._unpend(cid)
                        self._cancelled.discard(cid)
                    finally:
                        self._cv.notify_all()
                del tree
                self._demote_excess()
        except BaseException as e:
            # unexpected thread death (anything the per-item handlers above
            # did not catch): surface at the next flush() and make sure the
            # in-flight cid is not stranded in _pending/_cancelled
            with self._cv:
                self._write_error = e
                if cid is not None:
                    self._unpend(cid)
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
        cancelled in-flight commit has been undone.  Raises if the writer
        thread failed."""
        with self._cv:
            while self._pending or self._cancelled:
                self._cv.wait()
            if self._write_error is not None:
                err, self._write_error = self._write_error, None
                raise RuntimeError("checkpoint write-behind failed") from err

    def close(self) -> None:
        """Flush, then release the optional serializer thread pool."""
        self.flush()
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    @property
    def pending_writes(self) -> int:
        with self._cv:
            return len(self._pending)

    # --------------------------------------------------------------- get
    def get(self, cid: str) -> Any:
        """The tree committed under ``cid`` (any tier), or ``KeyError``.

        Returned trees are SHARED — with the pending / in-memory map on the
        memory paths and with the LRU read cache on the serialized paths —
        so treat them as read-only; copy before mutating.  Trainers are
        functional (stages return new state, optimizer updates write fresh
        tensors), so nothing in the engine mutates a restored tree in
        place.  The serialized tiers return CPU tensors (a pending entry's
        in pinned memory); a trainer moves them to its device."""
        self.gets += 1
        with self._cv:
            tree = self._pending.get(cid)
            cancelled = cid in self._cancelled
        if tree is not None:        # in-flight write: serve the live object
            self.hits += 1
            self.mem_hits += 1
            return _settled(tree)
        if cancelled:               # evicted mid-commit: gone to readers
            self.store_misses += 1
            raise KeyError(f"checkpoint {cid!r} not in store")
        if cid in self._mem:
            self.hits += 1
            self.mem_hits += 1
            return self._mem[cid]
        if self.directory:
            cached = self._read_cache.get(cid)
            if cached is not None:
                self._read_cache.move_to_end(cid)
                self.hits += 1
                self.mem_hits += 1
                return cached
            try:
                tree = self._read_disk(cid)
            except KeyError:
                self.store_misses += 1
                raise
            self.hits += 1
            self._cache_read(cid, tree)
            return tree
        self.store_misses += 1
        raise KeyError(f"checkpoint {cid!r} not in store")

    def contains(self, cid: str) -> bool:
        return self._known(cid)

    # ---------------------------------------------------- session persistence
    def committed_ids(self) -> set:
        """Ids of every durably-committed checkpoint (session snapshots:
        call :meth:`flush` first so nothing is left pending).  Served from
        the incrementally-maintained tier indexes — no directory scan."""
        with self._cv:
            ids = set(self._pending) - self._cancelled
            ids |= set(self._disk_cids)
            ids |= self._remote_cids
        ids |= set(self._mem)
        return ids

    def snapshot_trees(self) -> Optional[Dict[str, Any]]:
        """Memory tier only: the committed cid→tree map with every tensor
        leaf a host copy, for embedding into a session snapshot — a
        pickled CUDA tensor would tie the snapshot to a CUDA process (a
        directory store returns None: its blobs are already durable on
        disk)."""
        if self.directory:
            return None
        return {cid: tree_map(_on_host, tree)
                for cid, tree in self._mem.items()}

    def load_trees(self, trees: Dict[str, Any]) -> None:
        """Seed the memory tier from a session snapshot.  The trees stay on
        the host; a trainer moves a restored tree to its device."""
        self._mem.update(trees)

    def _cache_read(self, cid: str, tree: Any) -> None:
        if self.read_cache_entries <= 0:
            return
        self._read_cache[cid] = tree
        self._read_cache.move_to_end(cid)
        while len(self._read_cache) > self.read_cache_entries:
            self._read_cache.popitem(last=False)

    # ------------------------------------------------------------- evict
    def evict(self, cid: str) -> bool:
        with self._cv:
            if cid in self._pending:
                self._unpend(cid)
                try:
                    # not yet picked up by the writer: nothing to undo
                    self._work.remove(cid)
                except ValueError:
                    # commit in flight: the writer undoes it on completion
                    self._cancelled.add(cid)
                self._cv.notify_all()
                return True
        self._read_cache.pop(cid, None)
        if cid in self._mem:
            del self._mem[cid]
            return True
        removed = False
        with self._cv:
            self._blob_meta.pop(cid, None)
            size = self._disk_cids.pop(cid, None)
            if size is not None:
                self._disk_bytes -= size
                removed = True
            on_remote = cid in self._remote_cids
            self._remote_cids.discard(cid)
        if size is not None:
            try:
                os.remove(self._path(cid))
            except FileNotFoundError:  # pragma: no cover - demote race
                pass
        if on_remote:
            try:
                self.remote.delete(cid)
                removed = True
            except KeyError:  # pragma: no cover - external cleanup
                pass
        return removed

    def __len__(self) -> int:
        # one critical section: publish + pending-removal are atomic on the
        # writer side, so a cid is never counted as both pending and on
        # disk.  NB: an empty store is falsy — callers test ``store is None``
        with self._cv:
            n = len(self._mem) + len(self._pending)
            if self.directory or self.remote is not None:
                n += len(self._disk_cids.keys() | self._remote_cids)
        return n

    # ---------------------------------------------------------- disk I/O
    def _path(self, cid: str) -> str:
        safe = cid.replace("/", "_")
        return os.path.join(self.directory, safe + ".ckpt")

    def _parent_meta(self, parent_cid: Optional[str]):
        """(depth, chunk digests) of a committed parent blob, for delta
        encoding — from the in-memory meta map, else recovered from the
        parent's on-disk header (a reopened store deltas against blobs it
        never wrote).  None when the parent can't serve as a base."""
        if parent_cid is None:
            return None
        with self._cv:
            meta = self._blob_meta.get(parent_cid)
            on_disk = parent_cid in self._disk_cids
            on_remote = parent_cid in self._remote_cids
        if meta is None and on_disk:
            try:
                hdr = self._read_header(parent_cid)
            except (KeyError, OSError, ValueError):
                return None
            if hdr.get("chunk") != self.chunk_bytes:
                # parent was encoded at a different chunk size (store
                # reopened with another chunk_bytes): its digests index
                # different byte ranges, so a digest match at chunk ci
                # would splice the WRONG parent offset — degrade to full
                return None
            meta = (hdr["depth"],
                    [[(h, n) for h, n, _ in leaf["c"]]
                     for leaf in hdr["leaves"]])
            with self._cv:
                self._blob_meta[parent_cid] = meta
        if meta is None or not (on_disk or on_remote):
            return None
        return meta

    def _serialize_disk(self, cid: str, tree: Any,
                        parent_cid: Optional[str] = None) -> _Staged:
        """Serialize to a thread-unique temp file (no lock held; the final
        path is untouched).  Delta-encodes against ``parent_cid`` when its
        chunk index is available and its delta chain is under the depth
        bound; otherwise commits a full snapshot."""
        leaves = tree_leaves(tree)
        tree_blob = pickle.dumps(tree_map(_leaf_kind, tree))
        views = [_leaf_view(x) for x in leaves]
        dtypes = [v[0] for v in views]
        shapes = [v[1] for v in views]
        bufs = [v[2] for v in views]

        parent = self._parent_meta(parent_cid)
        depth = 0
        if parent is not None and parent[0] >= self.max_delta_depth:
            self.delta_rebases += 1     # chain at the bound: rebase to full
            parent = None
        elif parent_cid is not None and parent is None:
            self.delta_fallbacks += 1   # parent gone / unreadable / pending
        pdigs = parent[1] if parent is not None else None

        pool = self._pool_if_any()
        if pool is not None and bufs:
            leaf_metas, parts, digests, any_ref, logical = \
                _encode_leaves_pooled(pool, bufs, dtypes, shapes, pdigs,
                                      self.chunk_bytes)
        else:
            leaf_metas, parts, digests, any_ref, logical = _encode_leaves(
                bufs, dtypes, shapes, pdigs, self.chunk_bytes)

        if any_ref:
            kind, depth = "delta", parent[0] + 1
        else:
            # nothing referenced (fully divergent, or no usable parent):
            # commit as a self-contained snapshot with no chain dependency
            kind, depth, parent_cid = "full", 0, None
            for leaf in leaf_metas:
                for c in leaf["c"]:
                    c[2] = 1

        header = json.dumps({
            "v": BLOB_FORMAT, "kind": kind, "parent": parent_cid,
            "depth": depth, "chunk": self.chunk_bytes,
            "tree_len": len(tree_blob),
            "leaves": leaf_metas}).encode("utf-8")
        tmp = f"{self._path(cid)}.{threading.get_ident()}.tmp"
        file_len = _write_blob(
            tmp, [len(header).to_bytes(8, "little"), header, tree_blob,
                  *parts], pool)
        payload_len = file_len - 8 - len(header) - len(tree_blob)
        # logical = what a *full* commit of this state would have written
        # (same header/treedef framing, every chunk inline), so
        # logical/physical is exactly 1.0 without deltas and the dedup
        # ratio isolates the delta layer's savings
        logical_len = 8 + len(header) + len(tree_blob) + logical
        return _Staged((kind, depth, digests, payload_len,
                        logical_len, file_len, tmp))

    def _pool_if_any(self):
        """The serializer thread pool, when ``serializer_procs > 0``."""
        if self._serializer_procs <= 0:
            return None
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self._serializer_procs,
                thread_name_prefix="ckpt-serializer")
        return self._pool

    def _publish_disk(self, cid: str, staged: _Staged) -> None:
        """Atomically publish a staged temp file (caller holds ``_cv``):
        one ``os.replace`` — header, treedef and payload travel in a single
        blob, so a crash (or the daemon writer being reaped at interpreter
        exit) can never leave a half-written file at the address readers
        probe."""
        path = self._path(cid)
        os.replace(staged.tmp, path)
        prev = self._disk_cids.pop(cid, None)
        if prev is not None:
            self._disk_bytes -= prev
        self._disk_cids[cid] = staged.file_len
        self._disk_bytes += staged.file_len
        self._blob_meta[cid] = (staged.depth, staged.digests)
        self.bytes_written += staged.file_len
        self.logical_bytes += staged.logical_len
        if staged.kind == "delta":
            self.delta_bytes += staged.file_len
            self.delta_commits += 1
        else:
            self.full_bytes += staged.file_len
            self.full_commits += 1

    # ------------------------------------------------------------ tiering
    def _demote_excess(self) -> None:
        """Move LRU disk blobs past ``disk_capacity_bytes`` to the remote
        tier (remote copy lands *before* the local file goes, so readers
        always find the blob somewhere).

        Best-effort and concurrency-safe: a failing ``remote.put`` (or an
        unreadable local file) is counted in ``tier_demotion_errors`` and
        demotion stops for this pass — it must never propagate into the
        writer thread, a synchronous put, or a promoting read.  Cids with
        a demotion in flight are claimed in ``_demoting`` so two
        concurrent passes never double-demote (and double-count) the same
        blob, and an eviction landing mid-demotion wins: the freshly
        uploaded remote copy is deleted instead of indexed, so evicted
        checkpoints are never resurrected."""
        if self.remote is None or not self.disk_capacity_bytes:
            return
        while True:
            with self._cv:
                if self._disk_bytes <= self.disk_capacity_bytes:
                    return
                cid = next((c for c in self._disk_cids
                            if c not in self._demoting), None)
                if cid is None or len(self._disk_cids) <= 1:
                    return
                self._demoting.add(cid)
            try:
                try:
                    with open(self._path(cid), "rb") as f:
                        data = f.read()
                except FileNotFoundError:  # pragma: no cover - evict race
                    with self._cv:
                        prev = self._disk_cids.pop(cid, None)
                        if prev is not None:
                            self._disk_bytes -= prev
                    continue
                except OSError:  # pragma: no cover - unreadable, not absent
                    with self._cv:
                        self.tier_demotion_errors += 1
                    return
                try:
                    self.remote.put(cid, data)
                except Exception:
                    # remote outage: keep the blob local (capacity is
                    # temporarily exceeded) and stop demoting this pass
                    with self._cv:
                        self.tier_demotion_errors += 1
                    return
                with self._cv:
                    evicted = cid not in self._disk_cids
                    if not evicted:
                        self._remote_cids.add(cid)
                        self._disk_bytes -= self._disk_cids.pop(cid)
                        self.tier_demotions += 1
                        self.remote_bytes_written += len(data)
                if evicted:
                    # evict() removed the cid while the upload was in
                    # flight: honor the eviction — drop the remote copy
                    try:
                        self.remote.delete(cid)
                    except KeyError:  # pragma: no cover - already gone
                        pass
                    continue
                try:
                    os.remove(self._path(cid))
                except FileNotFoundError:  # pragma: no cover - evict race
                    pass
            finally:
                with self._cv:
                    self._demoting.discard(cid)

    def _fetch_blob(self, cid: str, count_hit: bool = False):
        """Raw blob bytes — a writable private mapping of the directory's
        file, else a ``bytearray`` fetched from the remote tier (and
        promoted back to the directory).  Raises ``KeyError`` when no tier
        holds the cid."""
        with self._cv:
            on_disk = cid in self._disk_cids
        if on_disk:
            try:
                data = _map_file(self._path(cid))
                with self._cv:
                    self.bytes_read += len(data)
                    if cid in self._disk_cids:
                        self._disk_cids.move_to_end(cid)
                    if count_hit:
                        self.disk_hits += 1
                return data
            except FileNotFoundError:
                pass        # demoted (or evicted) underfoot: try remote
        if self.remote is not None:
            with self._cv:
                on_remote = cid in self._remote_cids
            if on_remote:
                try:
                    data = bytearray(self.remote.get(cid))
                except KeyError:
                    raise KeyError(f"checkpoint {cid!r} not in store")
                with self._cv:
                    self.remote_bytes_read += len(data)
                    if count_hit:
                        self.remote_hits += 1
                self._promote(cid, data)
                return data
        raise KeyError(f"checkpoint {cid!r} not in store")

    def _promote(self, cid: str, data: bytes) -> None:
        """Write a remote-fetched blob back to the disk tier (the remote
        copy stays — it is the replica)."""
        path = self._path(cid)
        tmp = f"{path}.promote.{threading.get_ident()}.tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        with self._cv:
            os.replace(tmp, path)
            prev = self._disk_cids.pop(cid, None)
            if prev is not None:
                self._disk_bytes -= prev
            self._disk_cids[cid] = len(data)
            self._disk_bytes += len(data)
            self.tier_promotions += 1
        self._demote_excess()

    # ----------------------------------------------------------- disk read
    @staticmethod
    def _parse_header(data: bytes) -> Tuple[dict, int]:
        """(header dict, offset of the treedef pickle).  Raises KeyError
        for blobs this format cannot read (legacy v1 files degrade to
        recompute-on-miss instead of crashing)."""
        hlen = int.from_bytes(data[:8], "little")
        try:
            hdr = json.loads(data[8:8 + hlen])
        except Exception:
            raise KeyError("unreadable checkpoint header")
        if not isinstance(hdr, dict) or hdr.get("v") != BLOB_FORMAT:
            raise KeyError(
                f"checkpoint blob format {hdr.get('v') if isinstance(hdr, dict) else '?'}"
                f" != {BLOB_FORMAT}")
        return hdr, 8 + hlen

    def _read_header(self, cid: str) -> dict:
        """Header only (no payload decode) — delta-encoding recovery."""
        with open(self._path(cid), "rb") as f:
            hlen = int.from_bytes(f.read(8), "little")
            hdr, _ = self._parse_header(
                hlen.to_bytes(8, "little") + f.read(hlen))
        return hdr

    def _leaf_buffers(self, cid: str, depth_left: int,
                      count_hit: bool = False) -> List:
        """Raw per-leaf byte buffers of ``cid``, resolving delta chains
        recursively (bounded by ``depth_left``)."""
        if depth_left < 0:
            raise KeyError(f"delta chain under {cid!r} exceeds the depth "
                           "bound — refusing to recurse")
        data = self._fetch_blob(cid, count_hit=count_hit)
        hdr, off = self._parse_header(data)
        return _splice(hdr, memoryview(data)[off + hdr["tree_len"]:],
                       lambda: self._leaf_buffers(hdr["parent"],
                                                  depth_left - 1))

    def _read_disk(self, cid: str) -> Any:
        """Reconstruct the tree of ``cid`` from the serialized tiers (delta
        chains resolved against ancestors; leaves are zero-copy views over
        the blob's buffer)."""
        data = self._fetch_blob(cid, count_hit=True)
        hdr, off = self._parse_header(data)
        skeleton = pickle.loads(data[off:off + hdr["tree_len"]])
        bufs = _splice(hdr, memoryview(data)[off + hdr["tree_len"]:],
                       lambda: self._leaf_buffers(hdr["parent"],
                                                  self.max_delta_depth))
        kinds = tree_leaves(skeleton)
        return tree_unflatten(skeleton, [
            _restore_leaf(k, leaf, buf)
            for k, leaf, buf in zip(kinds, hdr["leaves"], bufs)])


def _splice(hdr: dict, payload: memoryview, parent_bufs) -> List:
    """Per-leaf byte buffers of a blob: slices of its payload for a full
    blob; for a delta, each leaf's inline chunks interleaved with the
    referenced chunks of ``parent_bufs()`` (the parent's leaf buffers)."""
    out, pos = [], 0
    if hdr["kind"] == "full":
        for leaf in hdr["leaves"]:
            out.append(payload[pos:pos + leaf["n"]])
            pos += leaf["n"]
        return out
    parents = parent_bufs()
    for i, leaf in enumerate(hdr["leaves"]):
        buf = bytearray(leaf["n"])
        loff = 0
        for _, n, inline in leaf["c"]:
            if inline:
                buf[loff:loff + n] = payload[pos:pos + n]
                pos += n
            else:
                buf[loff:loff + n] = parents[i][loff:loff + n]
            loff += n
        out.append(buf)
    return out


def _settled(tree: Any) -> Any:
    """A pending entry's tree, its host copy landed first."""
    return tree.wait() if isinstance(tree, _HostCopy) else tree
