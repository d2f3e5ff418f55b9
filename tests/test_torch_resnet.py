"""CIFAR ResNet of the PyTorch package held against the JAX package.

Parameters are initialised in JAX and carried across leaf for leaf via
numpy; logits, loss and every gradient leaf must agree within atol 1e-5 /
rtol 1e-4 (f32 convolution sums are taken in a different order).  The
stride-2 stage transitions are what this guards: XLA's ``"SAME"`` pads a
3x3 stride-2 convolution on an even input ``(0, 1)``, PyTorch's
``padding=1`` pads ``(1, 1)`` and gives different numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.resnet import ResNet as JaxResNet
from repro.models.resnet import _conv as jax_conv
from repro_torch.data.pipeline import synthetic_cifar
from repro_torch.models.resnet import ResNet, _conv, _same_pad
from repro_torch.train.torch_trainer import value_and_grad
from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy
from repro_torch.utils.tree import tree_leaves

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-4)


def to_numpy_tree(jax_tree):
    return jax.tree.map(np.asarray, jax_tree)


def both_sides(n, width, batch=8, seed=0):
    ref = JaxResNet(n=n, width=width)
    jparams = ref.init(jax.random.PRNGKey(seed))
    data = synthetic_cifar(batch, seed=seed + 1)
    jbatch = {k: jnp.asarray(v) for k, v in data.items()}
    tparams = tree_from_numpy(to_numpy_tree(jparams), "cpu")
    tbatch = {"images": torch.tensor(data["images"]),
              "labels": torch.tensor(data["labels"]).long()}
    return ref, jparams, jbatch, ResNet(n=n, width=width), tparams, tbatch


def sorted_leaves(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in sorted_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in sorted_leaves(v)]
    return [tree]


@pytest.mark.parametrize("n", [1, 2], ids=["n1", "n2_block_without_proj"])
def test_logits_loss_and_grads_match_jax(n):
    ref, jparams, jbatch, net, tparams, tbatch = both_sides(n, 8)
    if n == 2:
        assert "proj" not in tparams["stages"][0][1]   # stride-1, cin == c
        assert "proj" in tparams["stages"][1][0]       # stride-2 transition

    jlogits = ref.forward(jparams, jbatch)
    tlogits = net.forward(tparams, tbatch)
    assert tuple(tlogits.shape) == jlogits.shape == (8, 10)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), **TOL)

    (jloss, jaux), jgrads = jax.value_and_grad(ref.loss, has_aux=True)(
        jparams, jbatch)
    (tloss, taux), tgrads = value_and_grad(net.loss, tparams, tbatch)
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    assert float(taux["acc"]) == float(jaux["acc"])

    jl = [np.asarray(x) for x in jax.tree.leaves(jgrads)]
    tl = sorted_leaves(tree_to_numpy(tgrads))
    assert len(jl) == len(tl) == len(tree_leaves(tparams))
    for a, b in zip(tl, jl):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("size,k,stride,expect", [
    (32, 3, 1, (1, 1)), (32, 3, 2, (0, 1)), (16, 3, 2, (0, 1)),
    (32, 1, 2, (0, 0)), (15, 3, 2, (1, 1)), (7, 5, 3, (2, 2))])
def test_same_padding_amounts(size, k, stride, expect):
    assert _same_pad(size, k, stride) == expect


@pytest.mark.parametrize("hw,k,stride", [(32, 3, 1), (32, 3, 2), (16, 3, 2),
                                         (32, 1, 2), (15, 3, 2)])
def test_conv_matches_xla_same_padding(hw, k, stride):
    rng = np.random.default_rng(hw * 10 + k + stride)
    x = rng.normal(size=(2, hw, hw, 4)).astype(np.float32)
    w = rng.normal(size=(k, k, 4, 6)).astype(np.float32)
    want = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(w), stride))
    got = _conv(torch.tensor(x), torch.tensor(w), stride).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_symmetric_padding_would_be_wrong():
    """The trap itself: ``padding=1`` on the stride-2 3x3 convolution
    disagrees with XLA far beyond the tolerance."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(size=(2, 16, 16, 4)).astype(np.float32))
    w = torch.tensor(rng.normal(size=(3, 3, 4, 6)).astype(np.float32))
    right = _conv(x, w, 2)
    wrong = torch.nn.functional.conv2d(
        x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=2,
        padding=1).permute(0, 2, 3, 1)
    assert right.shape == wrong.shape
    assert float((right - wrong).abs().max()) > 0.1


@pytest.mark.parametrize("n,width", [(1, 8), (2, 8), (9, 16)])
def test_init_tree_matches_jax_structure(n, width):
    """Same keys, nesting, shapes and dtypes as the JAX package's init; the
    truncated-normal leaves have the same scale, not the same bits."""
    jshapes = jax.eval_shape(
        lambda: JaxResNet(n=n, width=width).init(jax.random.PRNGKey(0)))
    tparams = ResNet(n=n, width=width).init(0)
    jl = jax.tree.leaves(jshapes)
    tl = sorted_leaves(tparams)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    if n == 9:
        assert len(tl) == 114            # ResNet56: leaves = launches/step
        assert sum(x.numel() for x in tl) == 853_546
    stem = tparams["stem"]
    fan_in = 3 * 3 * 3
    assert float(stem.abs().max()) <= 2.0 * (2.0 / fan_in) ** 0.5 + 1e-6
    # std of a (-2, 2)-truncated unit normal is 0.880
    assert 0.6 < float(stem.std()) / (2.0 / fan_in) ** 0.5 < 1.1
    again = ResNet(n=n, width=width).init(0)
    assert all(torch.equal(a, b) for a, b in zip(tl, sorted_leaves(again)))
