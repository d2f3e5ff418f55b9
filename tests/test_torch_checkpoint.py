"""The PyTorch package's checkpoint store held against the JAX package's.

Ports of ``tests/test_checkpoint_async.py`` (the write-behind layer and the
directory read path) and of ``tests/test_ckptplane.py`` (delta encoding,
tiering and their crash paths; its session snapshot/restore case goes with
the service's snapshots) on torch trees, then the two stores side by side
on the same seeded arrays: equal headers but for ``tree_len``, equal
payload bytes, equal counters.  bf16 round-trips here; the JAX package's
store writes the same bytes and digests but reads them back as void bytes
(a fault of the reference, kept as it is).
"""

import json
import os
import pickletools
import threading
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train.checkpoint import CheckpointStore as RefStore
from repro_torch.core import (Constant, MultiStep, SearchPlanDB, StudyService,
                              StudySpec)
from repro_torch.core.trainer import SimulatedTrainer
from repro_torch.core.tuners import GridSearchSpace, GridTuner
from repro_torch.train import checkpoint as ckpt_mod
from repro_torch.train.checkpoint import (CheckpointStore, DirectoryObjectStore,
                                          ObjectStore)

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)


def tree(i: int):
    return {"w": torch.arange(4, dtype=torch.float32) + i, "step": i}


def big_tree(i: int, mutate_from=None, frac: float = 0.25):
    """~1 MB two-leaf state; with ``mutate_from``, only the leading
    ``frac`` of the big leaf differs (a stage advancing part of a model)."""
    if mutate_from is None:
        rng = np.random.default_rng(i)
        w = torch.from_numpy(rng.standard_normal(250_000).astype(np.float32))
    else:
        w = mutate_from["w"].clone()
        n = int(len(w) * frac)
        w[:n] += float(1 + i)
    return {"w": w, "step": i}


def assert_tree_equal(a, b):
    assert torch.equal(a["w"], b["w"])
    assert a["step"] == b["step"] and type(a["step"]) is int


def stall_writer(monkeypatch):
    """Keep put_async entries pending forever: the writer thread is
    replaced by a no-op, so tests can observe the pending state
    deterministically."""
    monkeypatch.setattr(
        ckpt_mod.threading, "Thread",
        lambda **kw: types.SimpleNamespace(start=lambda: None))


# ---------------------------------------------------------------------------
# write-behind: pending entries are indistinguishable from committed ones
# ---------------------------------------------------------------------------


def test_pending_served_to_readers_before_commit(monkeypatch, tmp_path):
    stall_writer(monkeypatch)
    store = CheckpointStore(str(tmp_path))
    cid = store.put_async("pk", 3, tree(3))
    assert store.pending_writes == 1
    assert not os.path.exists(store._path(cid))   # nothing on disk yet
    assert store.contains(cid)
    assert_tree_equal(store.get(cid), tree(3))
    assert len(store) == 1


def test_put_async_dedups_against_pending_and_disk(monkeypatch, tmp_path):
    stall_writer(monkeypatch)
    store = CheckpointStore(str(tmp_path))
    store.put("pk", 1, tree(1))                   # committed synchronously
    assert store.put_async("pk", 1, tree(1)) == store.ckpt_id("pk", 1)
    assert store.pending_writes == 0              # disk dedup
    store.put_async("pk", 2, tree(2))
    store.put_async("pk", 2, tree(2))             # pending dedup
    assert store.pending_writes == 1
    assert store.async_puts == 1
    assert store.puts == 4


def test_evict_cancels_pending_write(monkeypatch, tmp_path):
    stall_writer(monkeypatch)
    store = CheckpointStore(str(tmp_path))
    cid = store.put_async("pk", 5, tree(5))
    assert store.evict(cid) is True
    assert store.pending_writes == 0
    assert not store.contains(cid)
    assert len(store) == 0
    store.flush()                                 # nothing left: no hang


# ---------------------------------------------------------------------------
# flush barrier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tier", ["directory", "memory"])
def test_flush_commits_everything(tmp_path, tier):
    store = CheckpointStore(str(tmp_path) if tier == "directory" else None)
    cids = [store.put_async("pk", i, tree(i)) for i in range(8)]
    assert_tree_equal(store.get(cids[0]), tree(0))  # pending or committed
    store.flush()
    assert store.pending_writes == 0
    for i, cid in enumerate(cids):
        if tier == "directory":
            assert os.path.exists(store._path(cid))
        else:
            assert cid in store._mem
        assert_tree_equal(store.get(cid), tree(i))
    assert len(store) == 8
    assert (store.bytes_written > 0) == (tier == "directory")


def test_flush_surfaces_writer_failure(tmp_path):
    d = tmp_path / "gone"
    store = CheckpointStore(str(d))
    os.rmdir(str(d))                               # commit target vanishes
    store.put_async("pk", 1, tree(1))
    with pytest.raises(RuntimeError, match="write-behind"):
        store.flush()
    store.flush()                                  # error is one-shot


# ---------------------------------------------------------------------------
# directory read path: LRU cache, bytes_read, incremental index
# ---------------------------------------------------------------------------


def test_read_cache_bounds_and_bytes_read(tmp_path):
    store = CheckpointStore(str(tmp_path), read_cache_entries=2)
    cids = [store.put("pk", i, tree(i)) for i in range(3)]
    assert store.bytes_read == 0

    store.get(cids[0])
    after_first = store.bytes_read
    assert after_first > 0
    store.get(cids[0])                             # cache hit: no disk read
    assert store.bytes_read == after_first

    store.get(cids[1])                             # cache: {0, 1}
    store.get(cids[2])                             # evicts 0 (bound 2)
    assert len(store._read_cache) == 2
    b = store.bytes_read
    store.get(cids[0])                             # re-read from disk
    assert store.bytes_read > b


def test_evicted_checkpoint_leaves_read_cache(tmp_path):
    store = CheckpointStore(str(tmp_path))
    cid = store.put("pk", 1, tree(1))
    store.get(cid)
    assert store.evict(cid)
    with pytest.raises(KeyError):
        store.get(cid)


def test_disk_index_is_incremental_no_rescans(tmp_path, monkeypatch):
    """The disk-cid index is built once at construction and maintained
    incrementally: ``__len__``/``committed_ids`` never re-``listdir``."""
    seed = CheckpointStore(str(tmp_path))
    for i in range(3):
        seed.put("pk", i, tree(i))

    scans = {"n": 0}
    real_listdir = os.listdir

    def counting_listdir(path):
        scans["n"] += 1
        return real_listdir(path)

    monkeypatch.setattr(ckpt_mod.os, "listdir", counting_listdir)
    store = CheckpointStore(str(tmp_path))      # re-open over existing blobs
    assert scans["n"] == 1                      # the one init-time scan
    assert len(store) == 3
    assert len(store.committed_ids()) == 3
    store.put("pk", 3, tree(3))                 # incremental maintenance
    assert len(store) == 4
    store.evict(store.ckpt_id("pk", 0))
    assert len(store) == 3
    cid = store.put_async("pk", 9, tree(9))
    store.flush()
    assert len(store) == 4
    assert cid in store.committed_ids()
    assert scans["n"] == 1                      # still only the init scan


def test_single_file_commit_no_sidecar_and_tmp_sweep(tmp_path):
    """A commit is exactly one file, and evict removes exactly it.  Stale
    temp files (a writer reaped between serialize and publish) are swept
    at construction and counted."""
    store = CheckpointStore(str(tmp_path))
    cid = store.put("pk", 1, tree(1))
    assert os.listdir(str(tmp_path)) == [os.path.basename(store._path(cid))]
    store.evict(cid)
    assert os.listdir(str(tmp_path)) == []

    cid2 = store.put("pk", 2, tree(2))
    for j in range(2):
        with open(store._path(cid) + f".{j}.tmp", "wb") as f:
            f.write(b"partial")
    reopened = CheckpointStore(str(tmp_path))
    assert reopened.tmp_reclaimed == 2
    assert not any(f.endswith(".tmp") for f in os.listdir(str(tmp_path)))
    assert len(reopened) == 1                   # the committed blob survives
    assert_tree_equal(reopened.get(cid2), tree(2))


def test_evict_then_reput_of_same_content_survives(tmp_path):
    """Kill-then-recompute of the same content: an eviction must not undo
    a subsequent re-put of the same cid (same cid == same content)."""
    store = CheckpointStore(str(tmp_path))
    cid = store.put_async("pk", 1, tree(1))
    store.flush()
    assert store.evict(cid)
    assert store.put_async("pk", 1, tree(1)) == cid
    store.flush()
    assert os.path.exists(store._path(cid))
    assert_tree_equal(store.get(cid), tree(1))


def test_disk_files_published_atomically(tmp_path):
    """Every .ckpt that exists is fully readable, and no temp files
    survive a flush."""
    store = CheckpointStore(str(tmp_path))
    cids = [store.put_async("pk", i, tree(i)) for i in range(6)]
    store.flush()
    for f in os.listdir(str(tmp_path)):
        assert not f.endswith(".tmp"), f
    for i, cid in enumerate(cids):
        assert_tree_equal(store._read_disk(cid), tree(i))


def test_idle_writer_retires_and_respawns(tmp_path):
    import time
    store = CheckpointStore(str(tmp_path))
    store._IDLE_EXIT_SECONDS = 0.05
    store.put_async("pk", 1, tree(1))
    store.flush()
    deadline = time.time() + 2.0
    while store._writer is not None and time.time() < deadline:
        time.sleep(0.02)
    assert store._writer is None          # thread retired, store unpinned
    cid = store.put_async("pk", 2, tree(2))   # respawns a fresh writer
    store.flush()
    assert os.path.exists(store._path(cid))


# ---------------------------------------------------------------------------
# delta encoding
# ---------------------------------------------------------------------------


def test_delta_commit_writes_less_and_restores_identically(tmp_path):
    store = CheckpointStore(str(tmp_path))
    base = big_tree(0)
    cid0 = store.put("pk", 10, base)
    full_written = store.bytes_written
    child = big_tree(1, mutate_from=base)
    cid1 = store.put("pk", 20, child, parent_cid=cid0)
    delta_written = store.bytes_written - full_written

    assert store.full_commits == 1 and store.delta_commits == 1
    assert delta_written < full_written / 2
    assert store.dedup_ratio > 1.3

    store._read_cache.clear()
    assert_tree_equal(store.get(cid1), child)
    assert_tree_equal(store.get(cid0), base)


def test_fully_divergent_child_falls_back_to_full(tmp_path):
    store = CheckpointStore(str(tmp_path))
    cid0 = store.put("pk", 10, big_tree(0))
    cid1 = store.put("pk", 20, big_tree(99), parent_cid=cid0)   # unrelated
    assert store.delta_commits == 0 and store.full_commits == 2
    assert store._read_header(cid1)["kind"] == "full"
    store.evict(cid0)
    store._read_cache.clear()
    assert_tree_equal(store.get(cid1), big_tree(99))   # no parent needed


def test_delta_chain_rebases_at_depth_bound(tmp_path):
    store = CheckpointStore(str(tmp_path), max_delta_depth=3)
    t = big_tree(0)
    cid = store.put("pk", 0, t)
    for i in range(1, 8):
        t = big_tree(i, mutate_from=t, frac=0.1)
        cid = store.put("pk", i * 10, t, parent_cid=cid)
    assert store.delta_rebases == 1
    assert store.full_commits == 2          # the root + one rebase
    assert store._read_header(cid)["depth"] <= 3
    store._read_cache.clear()
    assert_tree_equal(store.get(cid), t)    # deepest chain resolves


def test_missing_parent_meta_falls_back_to_full(tmp_path):
    store = CheckpointStore(str(tmp_path))
    cid = store.put("pk", 10, big_tree(0), parent_cid="ghost@0")
    assert store.delta_fallbacks == 1
    assert store.full_commits == 1
    store._read_cache.clear()
    assert_tree_equal(store.get(cid), big_tree(0))


def test_delta_whose_parent_was_evicted_reads_as_missing(tmp_path):
    base = big_tree(0)
    store = CheckpointStore(str(tmp_path))
    cid0 = store.put("pk", 10, base)
    cid1 = store.put("pk", 20, big_tree(1, mutate_from=base),
                     parent_cid=cid0)
    assert store.delta_commits == 1
    store.evict(cid0)
    store._read_cache.clear()
    with pytest.raises(KeyError):
        store.get(cid1)
    assert store.store_misses >= 1


def test_evict_during_delta_commit_discards_the_write(monkeypatch, tmp_path):
    """An eviction landing while the writer thread serializes a delta
    cancels the publish: no file appears, readers see a miss, and a later
    re-put of the same cid commits cleanly."""
    store = CheckpointStore(str(tmp_path))
    base = big_tree(0)
    cid0 = store.put("pk", 10, base)
    child = big_tree(1, mutate_from=base)

    in_serialize = threading.Event()
    release = threading.Event()
    real_serialize = store._serialize_disk

    def stalling_serialize(cid, tree, parent_cid=None):
        in_serialize.set()
        assert release.wait(timeout=10)
        return real_serialize(cid, tree, parent_cid)

    monkeypatch.setattr(store, "_serialize_disk", stalling_serialize)
    cid1 = store.put_async("pk", 20, child, parent_cid=cid0)
    assert in_serialize.wait(timeout=10)     # writer is mid-serialization
    assert store.evict(cid1)                 # eviction races the commit
    release.set()
    store.flush()

    assert not os.path.exists(store._path(cid1))
    assert not any(f.endswith(".tmp") for f in os.listdir(str(tmp_path)))
    with pytest.raises(KeyError):
        store.get(cid1)
    monkeypatch.setattr(store, "_serialize_disk", real_serialize)
    assert store.put_async("pk", 20, child, parent_cid=cid0) == cid1
    store.flush()
    store._read_cache.clear()
    assert_tree_equal(store.get(cid1), child)


# ---------------------------------------------------------------------------
# tiered backend
# ---------------------------------------------------------------------------


def test_delta_restore_with_parent_demoted_to_remote(tmp_path):
    remote = DirectoryObjectStore(str(tmp_path / "remote"))
    store = CheckpointStore(str(tmp_path / "disk"), remote=remote,
                            disk_capacity_bytes=1_200_000)
    base = big_tree(0)
    cid0 = store.put("pk", 10, base)
    children = []
    t = base
    for i in range(1, 4):
        t = big_tree(i, mutate_from=t, frac=0.2)
        children.append((store.put("pk", 10 + i, t, parent_cid=cid0
                                   if i == 1 else children[-1][0]), t))
    assert store.tier_demotions >= 1
    assert remote.contains(cid0)
    assert not os.path.exists(store._path(cid0))

    store._read_cache.clear()
    cid_last, t_last = children[-1]
    assert_tree_equal(store.get(cid_last), t_last)     # chain via remote
    assert store.remote_hits + store.tier_promotions >= 1
    assert store.remote_bytes_read > 0


def test_eviction_removes_remote_replica(tmp_path):
    remote = DirectoryObjectStore(str(tmp_path / "remote"))
    store = CheckpointStore(str(tmp_path / "disk"), remote=remote,
                            disk_capacity_bytes=1)     # demote everything
    cid = store.put("pk", 10, big_tree(0))
    store.put("pk", 20, big_tree(1))                   # pressure: 10 demotes
    if not remote.contains(cid):                       # ordering safety
        store._demote_excess()
    assert store.evict(cid)
    assert not remote.contains(cid)
    assert cid not in store.committed_ids()


def test_reopened_store_indexes_remote_tier(tmp_path):
    remote = DirectoryObjectStore(str(tmp_path / "remote"))
    store = CheckpointStore(str(tmp_path / "disk"), remote=remote,
                            disk_capacity_bytes=600_000)
    cids = [store.put("pk", i, big_tree(i)) for i in range(3)]
    assert store.tier_demotions >= 2

    reopened = CheckpointStore(str(tmp_path / "disk"), remote=remote)
    assert set(cids) <= reopened.committed_ids()
    assert len(reopened) == 3
    for i, cid in enumerate(cids):
        assert reopened.contains(cid)
        assert_tree_equal(reopened.get(cid), big_tree(i))


class FlakyRemote(ObjectStore):
    """Remote whose blobs vanish (external lifecycle policy)."""

    def __init__(self):
        self.blobs = {}

    def put(self, key, data):
        self.blobs[key] = data

    def get(self, key):
        if key not in self.blobs:
            raise KeyError(key)
        return self.blobs[key]

    def delete(self, key):
        del self.blobs[key]

    def contains(self, key):
        return key in self.blobs

    def keys(self):
        return list(self.blobs)


def test_remote_losing_blobs_degrades_to_key_error(tmp_path):
    remote = FlakyRemote()
    store = CheckpointStore(str(tmp_path), remote=remote,
                            disk_capacity_bytes=1)
    cid = store.put("pk", 10, big_tree(0))
    store.put("pk", 20, big_tree(1))
    assert remote.contains(cid)
    remote.blobs.clear()                   # lifecycle policy reaped it
    store._read_cache.clear()
    with pytest.raises(KeyError):
        store.get(cid)


def test_legacy_format_blob_degrades_to_miss(tmp_path):
    store = CheckpointStore(str(tmp_path))
    cid = store.ckpt_id("pk", 10)
    with open(store._path(cid), "wb") as f:
        f.write(b"PK\x03\x04 this is not a v2 blob" * 10)
    reopened = CheckpointStore(str(tmp_path))
    assert reopened.contains(cid)          # indexed by extension...
    with pytest.raises(KeyError):
        reopened.get(cid)                  # ...but unreadable -> miss


class FailingPutRemote(FlakyRemote):
    """Remote whose uploads fail (an outage) until ``healed`` is set."""

    def __init__(self):
        super().__init__()
        self.healed = False

    def put(self, key, data):
        if not self.healed:
            raise OSError("remote tier unavailable")
        super().put(key, data)


def test_failed_demotion_put_does_not_kill_writer(tmp_path):
    remote = FailingPutRemote()
    store = CheckpointStore(str(tmp_path), remote=remote,
                            disk_capacity_bytes=1)
    cids = [store.put_async("pk", i * 10, big_tree(i)) for i in range(3)]
    store.flush()                      # would deadlock behind a dead writer
    assert store.tier_demotion_errors >= 1
    assert store.tier_demotions == 0
    for i, cid in enumerate(cids):     # everything still served locally
        store._read_cache.clear()
        assert_tree_equal(store.get(cid), big_tree(i))
    remote.healed = True
    store._demote_excess()             # outage over: demotion resumes
    assert store.tier_demotions >= 1


def test_writer_thread_death_is_survivable(monkeypatch, tmp_path):
    store = CheckpointStore(str(tmp_path))
    monkeypatch.setattr(
        store, "_demote_excess",
        lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    store.put_async("pk", 10, big_tree(0))
    writer = store._writer             # None if it already died and cleared
    if writer is not None:
        writer.join(timeout=10)
        assert not writer.is_alive()   # the hook killed the thread
    with pytest.raises(RuntimeError):
        store.flush()
    monkeypatch.setattr(store, "_demote_excess", lambda: None)
    cid = store.put_async("pk", 20, big_tree(1))
    store.flush()                      # a replacement writer committed it
    store._read_cache.clear()
    assert_tree_equal(store.get(cid), big_tree(1))


def test_evict_during_demotion_does_not_resurrect(tmp_path):
    uploading = threading.Event()
    release = threading.Event()

    class StallingRemote(FlakyRemote):
        def put(self, key, data):
            uploading.set()
            assert release.wait(timeout=10)
            super().put(key, data)

    remote = StallingRemote()
    store = CheckpointStore(str(tmp_path), remote=remote,
                            disk_capacity_bytes=1)
    cid0 = store.put("pk", 10, big_tree(0))
    t = threading.Thread(target=store.put, args=("pk", 20, big_tree(1)))
    t.start()
    assert uploading.wait(timeout=10)          # upload in flight
    assert store.evict(cid0)                   # eviction races it
    release.set()
    t.join(timeout=10)
    assert not t.is_alive()
    assert not remote.contains(cid0)           # upload was rolled back
    assert cid0 not in store.committed_ids()
    with pytest.raises(KeyError):
        store.get(cid0)
    assert store.tier_demotions == 0           # rolled back, not counted


# ---------------------------------------------------------------------------
# read-path sharing, re-chunked reopen, the pooled serializer
# ---------------------------------------------------------------------------


def test_restored_trees_are_shared_through_the_read_cache(tmp_path):
    """get() shares one reconstruction through the read cache: its tensors
    are CPU views of the blob's writable buffer (no copy, no warning), its
    numpy leaves read-only; no trainer may mutate them
    (``test_torch_engine.py::test_restored_tree_unchanged_by_resumed_stage``)."""
    store = CheckpointStore(str(tmp_path))
    base = dict(big_tree(0), arr=np.arange(6.0))
    cid = store.put("pk", 10, base)
    store._read_cache.clear()
    restored = store.get(cid)
    assert store.get(cid) is restored          # the cached reconstruction
    assert restored["w"].device.type == "cpu"
    assert restored["arr"].flags.writeable is False
    with pytest.raises(ValueError):
        restored["arr"][:2] = 0.0
    assert_tree_equal(restored, base)


def test_chunk_size_change_degrades_delta_to_full(tmp_path):
    base = big_tree(0)
    store = CheckpointStore(str(tmp_path), chunk_bytes=1 << 16)
    cid0 = store.put("pk", 10, base)
    assert store._read_header(cid0)["chunk"] == 1 << 16

    reopened = CheckpointStore(str(tmp_path), chunk_bytes=1 << 14)
    child = big_tree(1, mutate_from=base)
    cid1 = reopened.put("pk", 20, child, parent_cid=cid0)
    assert reopened.delta_fallbacks == 1
    assert reopened.full_commits == 1 and reopened.delta_commits == 0
    reopened._read_cache.clear()
    assert_tree_equal(reopened.get(cid1), child)
    assert_tree_equal(reopened.get(cid0), base)


def test_thread_pool_serializer_writes_the_inline_blob(monkeypatch,
                                                       tmp_path):
    """``serializer_procs`` encodes and writes on threads over pieces of
    the leaves (a small piece size here, so a leaf spans several): the
    same blob, byte for byte, as the inline encoder, full and delta; reads
    through the pool give the same tree."""
    monkeypatch.setattr(ckpt_mod, "_PIECE", 1 << 17)
    base = big_tree(0)
    child = big_tree(1, mutate_from=base)
    inline = CheckpointStore(str(tmp_path / "a"))
    pooled = CheckpointStore(str(tmp_path / "b"), serializer_procs=3)
    try:
        for s in (inline, pooled):
            c0 = s.put("pk", 10, base)
            s.put_async("pk", 20, child, parent_cid=c0)
            s.flush()
        assert pooled.delta_commits == inline.delta_commits == 1
        for cid in (c0, inline.ckpt_id("pk", 20)):
            with open(inline._path(cid), "rb") as a, \
                    open(pooled._path(cid), "rb") as b:
                assert a.read() == b.read()
        pooled._read_cache.clear()
        assert_tree_equal(pooled.get(pooled.ckpt_id("pk", 20)), child)
    finally:
        pooled.close()
        inline.close()


# ---------------------------------------------------------------------------
# engine integration: the stats mirror over a tiered store
# ---------------------------------------------------------------------------


def test_engine_stats_mirror_store_counters(tmp_path):
    store = CheckpointStore(
        str(tmp_path / "disk"),
        remote=DirectoryObjectStore(str(tmp_path / "remote")),
        disk_capacity_bytes=500)
    space = GridSearchSpace(
        fns={"lr": [Constant(0.1),
                    MultiStep(0.1, [60], values=[0.1, 0.01]),
                    MultiStep(0.1, [60], values=[0.1, 0.02])],
             "bs": [Constant(64)]})
    svc = StudyService(SearchPlanDB(), SimulatedTrainer(), n_workers=1,
                       store=store)
    svc.submit(StudySpec("m", "d", ("lr", "bs")),
               GridTuner(space.trials(120)))
    stats = svc.close()
    assert stats.ckpt_bytes_written == store.bytes_written > 0
    assert stats.ckpt_delta_commits == store.delta_commits
    assert stats.ckpt_tier_demotions == store.tier_demotions
    assert (stats.ckpt_mem_hits + stats.ckpt_disk_hits
            + stats.ckpt_remote_hits) > 0
    assert stats.dedup_ratio == pytest.approx(store.dedup_ratio)


# ---------------------------------------------------------------------------
# leaves of this package: Python values, bf16, the tree section
# ---------------------------------------------------------------------------


def trainer_state():
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 70, generator=gen).to(torch.bfloat16),
              "b": torch.randn(5, generator=gen),
              "A_log": torch.zeros((), dtype=torch.float32)}
    return {"params": params, "opt": {"m": {k: v * 0 for k, v in
                                            params.items()}},
            "opt_name": "adamw", "data": (3, 1, 96, 32), "step": 12,
            "none": None, "flag": True, "x": 2.5,
            "view": params["b"][1::2]}      # strided: made contiguous


@pytest.mark.parametrize("tier", ["directory", "remote"])
def test_trainer_state_round_trips_with_python_leaves(tmp_path, tier):
    """Tensors (bf16, f32, 0-d, a strided view) come back with their
    dtypes, shapes and bits, on the CPU; ``step``, ``opt_name``, ``data``
    (four ints), a bool and a float as the same Python values and types;
    ``None`` as ``None``."""
    remote = (DirectoryObjectStore(str(tmp_path / "remote"))
              if tier == "remote" else None)
    store = CheckpointStore(str(tmp_path / "disk"), remote=remote,
                            disk_capacity_bytes=1 if remote else None)
    state = trainer_state()
    cid = store.put("pk", 12, state)
    store.put("pk", 13, trainer_state())       # demotes the first blob
    store._read_cache.clear()
    got = store.get(cid)
    assert got["params"]["w"].dtype == torch.bfloat16
    for a, b in ((got["params"][k], state["params"][k])
                 for k in state["params"]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert torch.equal(got["view"], state["view"])
    assert got["view"].is_contiguous()
    for k in ("opt_name", "data", "step", "flag", "x"):
        assert got[k] == state[k] and type(got[k]) is type(state[k])
    assert all(type(v) is int for v in got["data"])
    assert got["none"] is None and got["opt"]["m"]["w"].dtype == \
        torch.bfloat16
    if tier == "remote":
        assert store.tier_promotions >= 1


def test_tree_section_holds_no_torch_object(tmp_path):
    """The pickled structure names no class at all: builtin containers and
    leaf tags only."""
    store = CheckpointStore(str(tmp_path))
    cid = store.put("pk", 1, trainer_state())
    with open(store._path(cid), "rb") as f:
        data = f.read()
    hdr, off = store._parse_header(data)
    section = data[off:off + hdr["tree_len"]]
    ops = {op.name for op, _, _ in pickletools.genops(section)}
    assert not ops & {"GLOBAL", "STACK_GLOBAL", "REDUCE", "NEWOBJ", "INST"}
    assert b"torch" not in section


# ---------------------------------------------------------------------------
# side by side with the JAX package's store
# ---------------------------------------------------------------------------


def reference_trees():
    """A root and two descendants over sorted keys: f32 leaves that
    straddle 64 KiB, an i64 array, 0-d scalars, Python numbers."""
    rng = np.random.default_rng(7)
    root = {"a": rng.standard_normal(40_000).astype(np.float32),
            "b": np.arange(50, dtype=np.int64),
            "c": np.float32(3.5),
            "d": rng.standard_normal((3, 30_000)).astype(np.float32),
            "e": 17, "f": 0.25}
    child = dict(root, a=root["a"].copy(), e=18)
    child["a"][20_000:20_100] += 1.0          # one chunk of one leaf
    grandchild = dict(child, d=child["d"].copy())
    grandchild["d"][2, -5:] -= 2.0
    return [root, child, grandchild]


def as_port(t):
    return {k: torch.from_numpy(v.copy()) if isinstance(v, np.ndarray)
            else v for k, v in t.items()}


def blob(store, cid):
    """(header without ``tree_len``, payload bytes) of ``cid``'s blob."""
    with open(store._path(cid), "rb") as f:
        data = f.read()
    hdr, off = store._parse_header(data)
    return {k: v for k, v in hdr.items() if k != "tree_len"}, \
        data[off + hdr["tree_len"]:]


COUNTERS = ("delta_commits", "full_commits", "delta_rebases",
            "delta_fallbacks")


@pytest.mark.parametrize("procs", [0, 2], ids=["inline", "threads"])
def test_blobs_equal_the_reference_but_for_the_tree_section(tmp_path,
                                                            procs):
    """The same arrays, committed full, then as deltas down a chain past
    ``max_delta_depth`` (a rebase) and against a missing parent (a
    fallback): equal ``kind`` / ``depth`` / ``chunk`` / ``parent``, equal
    leaf metas (``d``, ``s``, ``n``, chunk digests and inline flags), equal
    payload bytes and equal delta / full / rebase / fallback counters."""
    ref = RefStore(str(tmp_path / "ref"), max_delta_depth=1,
                   chunk_bytes=1 << 15)
    port = CheckpointStore(str(tmp_path / "port"), max_delta_depth=1,
                           chunk_bytes=1 << 15, serializer_procs=procs)
    trees = reference_trees()
    for store, conv in ((ref, dict), (port, as_port)):
        parent = None
        for i, t in enumerate(trees):
            parent = store.put("pk", i, conv(t), parent_cid=parent)
        store.put("pk", 9, conv(trees[1]), parent_cid="ghost@0")
    port.close()
    kinds = []
    for i in (0, 1, 2, 9):
        cid = ref.ckpt_id("pk", i)
        (h_ref, p_ref), (h_port, p_port) = blob(ref, cid), blob(port, cid)
        assert h_port == h_ref and p_port == p_ref
        kinds.append(h_ref["kind"])
    assert kinds == ["full", "delta", "full", "full"]  # rebase, fallback
    assert [getattr(port, c) for c in COUNTERS] == \
        [getattr(ref, c) for c in COUNTERS] == [1, 3, 1, 1]
    for i, t in enumerate(trees):               # and the port reads back
        port._read_cache.clear()
        got = port.get(port.ckpt_id("pk", i))
        for k, v in as_port(t).items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(got[k], v)
            else:
                assert got[k] == v and type(got[k]) is type(v)


def test_bf16_round_trips_where_the_reference_reads_void(tmp_path):
    """bf16: the same payload and chunk digests as the reference's blob
    for the same bits; ``d`` is ``"bfloat16"`` here, ``'<V2'`` there; the
    port reads ``torch.bfloat16`` back bit for bit, the reference's read
    returns ``|V2`` void bytes (its documented fault, ROADMAP queue C)."""
    bits = np.random.default_rng(3).integers(
        0, 1 << 15, size=(2, 40_000), dtype=np.uint16)
    ref_tree = {"w": bits.view(ml_dtypes.bfloat16)}
    port_tree = {"w": torch.from_numpy(bits.view(np.int16).copy()).view(
        torch.bfloat16)}
    ref = RefStore(str(tmp_path / "ref"))
    port = CheckpointStore(str(tmp_path / "port"))
    cid = ref.put("pk", 1, ref_tree)
    port.put("pk", 1, port_tree)
    (h_ref, p_ref), (h_port, p_port) = blob(ref, cid), blob(port, cid)
    assert p_port == p_ref
    assert h_ref["leaves"][0]["d"] == "<V2"
    assert h_port["leaves"][0]["d"] == "bfloat16"
    strip = lambda h: json.dumps({**h, "leaves": [
        {k: v for k, v in m.items() if k != "d"} for m in h["leaves"]]})
    assert strip(h_port) == strip(h_ref)
    port._read_cache.clear()
    got = port.get(cid)["w"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), port_tree["w"].view(torch.int16))
    ref._read_cache.clear()
    assert ref.get(cid)["w"].dtype.str == "|V2"


def test_host_copies_wait_for_room(monkeypatch, tmp_path):
    """Back-pressure on pending host copies (a CUDA tree's pinned copy,
    faked here): a deposit whose copy would pass the host budget waits
    until the writer has committed an earlier one; one pending copy is
    always allowed, so nothing waits forever."""

    class Landed:
        def synchronize(self):
            pass

    monkeypatch.setattr(ckpt_mod, "_cuda_bytes", lambda tree: 100)
    monkeypatch.setattr(ckpt_mod, "_host_budget", lambda: 150)
    monkeypatch.setattr(ckpt_mod, "_copy_to_host", lambda tree, streams:
                        ckpt_mod._HostCopy(tree, Landed(), 100))
    store = CheckpointStore(str(tmp_path))
    release = threading.Event()
    real_serialize = store._serialize_disk

    def gated_serialize(cid, tree, parent_cid=None):
        assert release.wait(timeout=10)
        return real_serialize(cid, tree, parent_cid)

    monkeypatch.setattr(store, "_serialize_disk", gated_serialize)
    c1 = store.put_async("pk", 1, tree(1))       # room: nothing pending
    assert store._host_bytes == 100
    second = threading.Thread(target=store.put_async, args=("pk", 2, tree(2)))
    second.start()
    second.join(timeout=0.3)
    assert second.is_alive()                     # 100 + 100 > 150: waits
    assert store.pending_writes == 1
    assert_tree_equal(store.get(c1), tree(1))    # the pending host copy
    release.set()                                # the first commit lands
    second.join(timeout=10)
    assert not second.is_alive()
    store.flush()
    assert store._host_bytes == 0 and len(store) == 2
    store._read_cache.clear()
    assert_tree_equal(store.get(store.ckpt_id("pk", 2)), tree(2))
