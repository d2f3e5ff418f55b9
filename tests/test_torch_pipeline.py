"""Data pipeline of the PyTorch package == the JAX package's, byte for byte.

Both are numpy; the port keeps ``np.random.default_rng((seed, epoch))`` so a
trial resumed from a shared checkpoint sees the identical sample stream in
either package.
"""

import numpy as np
import pytest

from repro.data.pipeline import DataPipeline as JaxSidePipeline
from repro.data.pipeline import synthetic_cifar as ref_synthetic_cifar
from repro.data.pipeline import synthetic_lm_dataset as ref_synthetic_lm
from repro_torch.data.pipeline import (DataPipeline, synthetic_cifar,
                                       synthetic_lm_dataset)


def assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("n,seed", [(64, 0), (200, 7)])
def test_synthetic_cifar_identical(n, seed):
    assert_batches_equal(synthetic_cifar(n, seed=seed),
                         ref_synthetic_cifar(n, seed=seed))


def test_synthetic_lm_identical():
    assert_batches_equal(synthetic_lm_dataset(50, 16, 97, seed=3),
                         ref_synthetic_lm(50, 16, 97, seed=3))


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_slabs_equal_across_epoch_wraps_and_bs_changes(seed):
    data = synthetic_cifar(100, seed=1)
    a = DataPipeline(data, batch_size=32, seed=seed)
    b = JaxSidePipeline(ref_synthetic_cifar(100, seed=1), batch_size=32,
                        seed=seed)
    # 3 batches per epoch at bs 32: counts below wrap several times; the bs
    # changes land mid-epoch and re-batch from the cursor
    for count, bs in [(2, None), (5, None), (3, 16), (7, None), (1, 48),
                      (4, None), (8, 32)]:
        if bs is not None:
            a.set_batch_size(bs)
            b.set_batch_size(bs)
        assert_batches_equal(a.next_batches(count), b.next_batches(count))
        assert a.state() == b.state()
    assert a.epoch >= 3


@pytest.mark.parametrize("seed", [0, 5])
def test_single_batches_and_restore_equal(seed):
    data = synthetic_cifar(70, seed=2)
    a = DataPipeline(data, batch_size=16, seed=seed)
    b = JaxSidePipeline(data, batch_size=16, seed=seed)
    for _ in range(9):
        assert_batches_equal(a.next_batch(), b.next_batch())
    # a state captured by one package restores in the other
    c = DataPipeline(data, batch_size=1, seed=99)
    c.restore(b.state())
    assert c.state() == a.state()
    assert_batches_equal(c.next_batches(3), b.next_batches(3))


def test_slab_equals_consecutive_batches():
    data = synthetic_cifar(90, seed=4)
    a = DataPipeline(data, batch_size=20, seed=1)
    b = DataPipeline(data, batch_size=20, seed=1)
    slab = a.next_batches(11)
    for i in range(11):
        one = b.next_batch()
        for k in one:
            np.testing.assert_array_equal(slab[k][i], one[k])
    assert a.state() == b.state()
