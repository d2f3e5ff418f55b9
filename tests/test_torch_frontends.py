"""The vision and audio frontends of the PyTorch package's LM held against
the JAX package.

On the CPU, reduced configurations (f32), numpy-seeded inputs fed to both
packages and JAX-initialised weights carried across leaf for leaf:

* hubert-xlarge (audio, encoder-only: ``features @ frontend_proj``, 1-D
  positions, framewise labels) and qwen2-vl-7b (vision: ``patches @
  frontend_proj`` before the embedded text, ``positions`` (3, B, S) as
  M-RoPE ids on a patch grid — t = 0, h = row, w = column, the text
  continuing at max + 1 in all three sections, so the sections differ):
  the tree key for key, ``param_count`` exact, logits within 1e-4 ·
  max(1, |ref|), loss within 1e-5 and every gradient within 1e-4, on the
  plain and the kernel path, and the vision loss read off the text's
  logits after the patch prefix;
* hubert's ``embed``, which an audio model never reads: its gradient is
  exactly zero (``jax.grad``'s zeros; the port's ``value_and_grad``
  materialises them), and one AdamW step of the whole tree on the same
  gradients equals the reference's within 1e-6 (``embed`` only decays);
* a frontend input in another dtype than the model's raises
  ``ValueError`` naming the dtype expected.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.transformer import LM as JaxLM
from repro.train.optimizer import apply_update as jax_apply_update
from repro.train.optimizer import init_opt_state as jax_init_opt_state
from repro_torch.configs import get_config
from repro_torch.kernels import ops as kops
from repro_torch.models.transformer import LM
from repro_torch.train.optimizer import apply_update, init_opt_state
from repro_torch.train.torch_trainer import value_and_grad
from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy
from repro_torch.utils.tree import tree_leaves

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

ARCHS = ["hubert-xlarge", "qwen2-vl-7b"]
B, T = 2, 24          # batch; frames (audio) or text tokens (vision)


def flat(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat(v)]
    return [tree]


def configs(arch):
    return get_config(arch).reduced(), jax_get_config(arch).reduced()


def jax_params(jcfg, seed=0):
    """JAX-initialised weights, every bias and norm moved off its constant
    init."""
    params = JaxLM(jcfg).init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 100)
    return jax.tree.map(
        lambda x: x + jnp.asarray(0.02 * rng.normal(size=x.shape), x.dtype),
        params)


def grid_positions(P, n_text, batch):
    """M-RoPE ids of a square patch grid then text: patches (t, h, w) =
    (0, row, column), text at max + 1 + i in all three sections."""
    side = int(round(P ** 0.5))
    assert side * side == P
    rows, cols = np.divmod(np.arange(P), side)
    start = max(rows.max(), cols.max()) + 1
    text = start + np.arange(n_text)
    pos = np.stack([np.concatenate([np.zeros(P, int), text]),
                    np.concatenate([rows, text]),
                    np.concatenate([cols, text])])
    return np.broadcast_to(pos[:, None], (3, batch, P + n_text)).astype(
        np.int32)


def make_batch(cfg, seed=1):
    """The same batch as numpy arrays: audio features and labels, or
    patches, text tokens and grid positions."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"features": rng.normal(size=(B, T, cfg.frontend_dim)).astype(
                    np.float32),
                "labels": rng.integers(0, cfg.vocab_size,
                                       size=(B, T)).astype(np.int32)}
    P = cfg.frontend_tokens
    pos = grid_positions(P, T, B)
    assert not (pos[0] == pos[1]).all() and not (pos[1] == pos[2]).all()
    return {"patches": rng.normal(size=(B, P, cfg.frontend_dim)).astype(
                np.float32),
            "tokens": rng.integers(0, cfg.vocab_size,
                                   size=(B, T)).astype(np.int32),
            "positions": pos}


def to_torch(batch, dtype=torch.float32):
    return {k: (torch.tensor(v).long() if v.dtype.kind == "i"
                else torch.tensor(v).to(dtype)) for k, v in batch.items()}


def assert_close(got, ref, tol):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_and_param_count_match_jax(arch):
    """``frontend_proj`` (frontend_dim, d_model) beside the reference's
    other leaves, bf16 too; ``param_count`` exact, and the full
    configurations' counts."""
    cfg, jcfg = configs(arch)
    for dtype in ("float32", "bfloat16"):
        jc = dataclasses.replace(jcfg, dtype=dtype)
        c = dataclasses.replace(cfg, dtype=dtype)
        jshapes = jax.eval_shape(lambda: JaxLM(jc).init(
            jax.random.PRNGKey(0)))
        mine = LM(c).init(0)
        assert jax.tree.structure(jshapes) == jax.tree.structure(
            jax.tree.map(lambda _: 0, tree_to_numpy(mine)))
        for a, b in zip(flat(mine), jax.tree.leaves(jshapes)):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
        assert tuple(mine["frontend_proj"].shape) == (c.frontend_dim,
                                                      c.d_model)
        assert sum(x.numel() for x in tree_leaves(mine)) == c.param_count()
    full = get_config(arch)
    assert full.param_count() == jax_get_config(arch).param_count()
    if arch == "qwen2-vl-7b":
        assert dataclasses.replace(full, num_layers=2).param_count() == \
            1_560_701_440


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch, use_kernel):
    cfg, jcfg = configs(arch)
    jparams = jax_params(jcfg)
    batch = make_batch(cfg)
    ref = JaxLM(jcfg, use_kernel=use_kernel)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jlogits, _ = ref.forward(jparams, jbatch)
    (jloss, jaux), jgrads = jax.value_and_grad(ref.loss, has_aux=True)(
        jparams, jbatch)

    net = LM(cfg, use_kernel=use_kernel)
    tparams = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tbatch = to_torch(batch)
    kops.reset_kernel_stats()
    with (pytest.warns(kops.KernelFallbackWarning) if use_kernel
          else contextlib.nullcontext()):
        with torch.no_grad():
            logits, _ = net.forward(tparams, tbatch)
        (tloss, taux), tgrads = value_and_grad(net.loss, tparams, tbatch)
    # each attention call is one fallback on the kernel path (CPU tensors)
    assert kops.KERNEL_STATS.fallbacks == (2 * cfg.num_layers if use_kernel
                                           else 0)
    kops.reset_kernel_stats()
    S = T + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
    assert tuple(logits.shape) == (B, S, cfg.vocab_size)
    assert_close(logits.numpy(), np.asarray(jlogits), 1e-4)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=1e-5)
    np.testing.assert_allclose(float(taux["nll"]), float(jaux["nll"]),
                               atol=1e-5)
    jl = [np.asarray(x) for x in jax.tree.leaves(jgrads)]
    tl = flat(tree_to_numpy(tgrads))
    assert len(jl) == len(tl) == len(tree_leaves(tparams))
    for a, b in zip(tl, jl):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


def test_vision_loss_reads_the_text_after_the_patches():
    """The loss is the mean NLL of ``logits[:, P + i]`` against text token
    ``i + 1``, whatever the patch positions' logits hold."""
    cfg, _ = configs("qwen2-vl-7b")
    net = LM(cfg)
    params = net.init(0)
    tbatch = to_torch(make_batch(cfg, seed=4))
    with torch.no_grad():
        logits, _ = net.forward(params, tbatch)
        loss, _ = net.loss(params, tbatch)
    P = cfg.frontend_tokens
    logp = torch.log_softmax(logits[:, P:P + T - 1], dim=-1)
    want = -torch.gather(logp, -1, tbatch["tokens"][:, 1:, None]).mean()
    assert torch.allclose(loss, want, atol=1e-6)


def test_audio_embed_gradient_is_zero_and_adamw_matches_jax():
    cfg, jcfg = configs("hubert-xlarge")
    jparams = jax_params(jcfg)
    batch = make_batch(cfg, seed=2)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, _), jgrads = jax.value_and_grad(JaxLM(jcfg).loss, has_aux=True)(
        jparams, jbatch)
    tparams = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    (_, _), tgrads = value_and_grad(LM(cfg).loss, tparams, to_torch(batch))
    assert not bool(jnp.any(jgrads["embed"]))
    assert tgrads["embed"].shape == tparams["embed"].shape
    assert torch.count_nonzero(tgrads["embed"]) == 0
    # the update on the reference's gradients (the port's are held to them
    # within 1e-4 above; its embed gradient, zeros, is theirs exactly), so
    # that the step compares the two updates and not Adam's reading of
    # gradient elements that are float noise
    grads = tree_from_numpy(jax.tree.map(np.asarray, jgrads), "cpu")
    assert torch.equal(grads["embed"], tgrads["embed"])
    hp = {"lr": 1e-3, "wd": 0.1, "b1": 0.9, "b2": 0.95}
    jnew, _ = jax_apply_update("adamw", jparams, jgrads,
                               jax_init_opt_state("adamw", jparams), hp,
                               jnp.int32(0))
    tnew, _ = apply_update("adamw", tparams, grads,
                           init_opt_state("adamw", tparams), hp, 0)
    for a, b in zip(flat(tree_to_numpy(tnew)), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-6, rtol=0)
    # embed only decays: p (1 - lr wd)
    np.testing.assert_allclose(
        tnew["embed"].numpy(), (tparams["embed"] * (1 - 1e-3 * 0.1)).numpy(),
        rtol=1e-6, atol=0)


@pytest.mark.parametrize("arch,key", [("hubert-xlarge", "features"),
                                      ("qwen2-vl-7b", "patches")])
def test_frontend_input_of_another_dtype_raises(arch, key):
    """An f32 input into a bf16 model (the reference would promote it to
    f32) and a bf16 input into an f32 model are refused, naming the
    dtype the model takes."""
    cfg, _ = configs(arch)
    for model_dtype, input_dtype in (("bfloat16", torch.float32),
                                     ("float32", torch.bfloat16)):
        c = dataclasses.replace(cfg, dtype=model_dtype)
        net = LM(c)
        params = net.init(0)
        tbatch = to_torch(make_batch(c))
        tbatch[key] = tbatch[key].to(input_dtype)
        want = "bfloat16" if model_dtype == "bfloat16" else "float32"
        with pytest.raises(ValueError, match=f"takes torch.{want}"):
            net.forward(params, tbatch)
