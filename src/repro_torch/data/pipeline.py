"""Checkpointable data pipeline (Hippo §5.1).

The paper's two pipeline requirements, implemented over numpy arrays:

1. **Position-in-dataset checkpointing** — "the current permutation of the
   dataset [is] part of the checkpoint".  The pipeline state is
   ``(seed, epoch, cursor)``; the epoch's permutation is *re-derived* from
   ``(seed, epoch)`` (deterministic, seeded numpy generator), so the state is three ints —
   cheap to checkpoint yet bit-exact to resume: a trial resumed from a
   shared stage checkpoint sees exactly the sample stream it would have
   seen training straight through.

2. **Runtime batch-size change** — ``set_batch_size`` re-batches from the
   current cursor (the PyTorch analogue flushes prefetch queues and
   relaunches workers; here there is nothing to flush — the next batch is
   simply sliced at the new size).

Works over any dict-of-arrays dataset (token corpora, image/label pairs).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["DataPipeline", "synthetic_lm_dataset", "synthetic_cifar"]


class DataPipeline:
    def __init__(self, data: Dict[str, np.ndarray], batch_size: int,
                 seed: int = 0, drop_last: bool = True):
        sizes = {k: len(v) for k, v in data.items()}
        assert len(set(sizes.values())) == 1, f"ragged dataset: {sizes}"
        self.data = data
        self.n = next(iter(sizes.values()))
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.drop_last = drop_last
        self.epoch = 0
        self.cursor = 0
        self._perm_epoch: Optional[int] = None
        self._perm: Optional[np.ndarray] = None

    # ---------------------------------------------------------- permutation
    def _permutation(self, epoch: int) -> np.ndarray:
        if self._perm_epoch != epoch:
            rng = np.random.default_rng((self.seed, epoch))
            self._perm = rng.permutation(self.n)
            self._perm_epoch = epoch
        return self._perm

    # -------------------------------------------------------------- batches
    def next_batch(self) -> Dict[str, np.ndarray]:
        if self.cursor + self.batch_size > self.n:
            # wrap to a fresh epoch (drop the ragged tail)
            self.epoch += 1
            self.cursor = 0
        perm = self._permutation(self.epoch)
        idx = perm[self.cursor:self.cursor + self.batch_size]
        self.cursor += self.batch_size
        return {k: v[idx] for k, v in self.data.items()}

    def next_batches(self, count: int) -> Dict[str, np.ndarray]:
        """Prefetch ``count`` consecutive batches as one stacked slab.

        Returns ``{field: array[count, batch_size, ...]}`` and advances the
        pipeline state exactly as ``count`` calls of :meth:`next_batch`
        would — same permutation walk, same epoch wraps, bit-identical rows
        — but gathers each run of in-epoch batches with a single fancy
        index instead of one gather per step.  This is the data slab the
        fused trainer feeds to a whole-stage executable.
        """
        assert self.batch_size <= self.n, (
            f"batch_size {self.batch_size} exceeds dataset size {self.n}")
        chunks: Dict[str, list] = {k: [] for k in self.data}
        remaining = int(count)
        while remaining > 0:
            if self.cursor + self.batch_size > self.n:
                self.epoch += 1
                self.cursor = 0
            perm = self._permutation(self.epoch)
            fit = (self.n - self.cursor) // self.batch_size
            take = min(remaining, fit)
            idx = perm[self.cursor:self.cursor + take * self.batch_size]
            idx = idx.reshape(take, self.batch_size)
            for k, v in self.data.items():
                chunks[k].append(v[idx])
            self.cursor += take * self.batch_size
            remaining -= take
        return {k: (c[0] if len(c) == 1 else np.concatenate(c))
                for k, c in chunks.items()}

    def set_batch_size(self, batch_size: int) -> None:
        """§5.1: change batch size mid-study; position is preserved."""
        self.batch_size = int(batch_size)

    # ------------------------------------------------------------ ckpt state
    def state(self) -> Tuple[int, int, int, int]:
        return (self.seed, self.epoch, self.cursor, self.batch_size)

    def restore(self, state) -> None:
        self.seed, self.epoch, self.cursor, self.batch_size = (
            int(state[0]), int(state[1]), int(state[2]), int(state[3]))
        self._perm_epoch = None  # re-derive lazily


# ---------------------------------------------------------------------------
# synthetic datasets (offline container: no downloads)
# ---------------------------------------------------------------------------


def synthetic_lm_dataset(n: int, seq_len: int, vocab: int,
                         seed: int = 0) -> Dict[str, np.ndarray]:
    """Markov-ish token stream: learnable (next token correlates with
    current), so loss actually decreases under training."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, size=(n, 1), dtype=np.int32)
    drift = rng.integers(0, 7, size=(n, seq_len), dtype=np.int32)
    toks = (base + np.cumsum(drift, axis=1)) % vocab
    return {"tokens": toks.astype(np.int32)}


def synthetic_cifar(n: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """CIFAR-shaped synthetic classification set (10 classes, 32×32×3).
    Class-conditional Gaussian blobs — linearly separable enough that a
    small ResNet trains to high accuracy in a few hundred steps."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    protos = rng.normal(0, 1.0, size=(10, 8)).astype(np.float32)
    proj = rng.normal(0, 1.0, size=(8, 32 * 32 * 3)).astype(np.float32) / 8.0
    x = protos[labels] @ proj + rng.normal(0, 0.5, size=(n, 32 * 32 * 3))
    images = x.reshape(n, 32, 32, 3).astype(np.float32)
    return {"images": images, "labels": labels}
