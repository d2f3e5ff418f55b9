"""Decode of the PyTorch package held against the JAX package's.

On the CPU, f32, reduced configurations, numpy-seeded inputs fed to both
packages and JAX-initialised weights carried across leaf for leaf:

* ``init_kv_cache`` / ``attention_decode`` step by step — MHA, GQA, MQA,
  qk-norm, QKV bias, M-RoPE positions, and a window shorter than the
  sequence so the ring buffer wraps — outputs and caches within
  1e-4·max(1, |ref|);
* ``init_ssm_cache`` / ``ssm_decode`` the same;
* ``LM.decode_step`` over 32 tokens for qwen2-0.5b, mamba2-2.7b,
  qwen2-moe-a2.7b, grok-1-314b and recurrentgemma-2b (the MoE ones
  drop-free, as
  ``tests/test_models.py::test_decode_matches_forward`` runs them): logits
  and the whole cache tree against JAX's within 1e-4·max(1, |ref|), and
  the port's decode against its own forward within 5e-3 (the reference
  test's tolerance);
* the serve step against the reference's (next tokens equal, cache within
  1e-4), written in place on the cache it was given;
* ``input_specs`` decode structures equal to the reference's
  ``eval_shape`` structures for every architecture whose decode shapes
  apply (all but encoder-only hubert), on ``decode_32k`` and on
  ``long_500k`` (through ``config_for_shape``'s 8,192 window);
* ``examples/torch_serve_lm.py --device cpu``: its greedy tokens are the
  forward's arg-max over prompt + generation; without a card and without
  ``--device cpu`` it refuses.
"""

import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as R_SHAPES
from repro.configs import config_for_shape as r_config_for_shape
from repro.configs import get_config as jax_get_config
from repro.launch.specs import input_specs as r_input_specs
from repro.models import attention as jax_attn
from repro.models import ssm as jax_ssm
from repro.models.transformer import LM as JaxLM
from repro.train.step import build_serve_step as jax_build_serve_step
from repro_torch.configs import SHAPES, config_for_shape, get_config, \
    list_archs, shape_applicable
from repro_torch.launch.specs import input_specs
from repro_torch.models import attention, ssm
from repro_torch.models.transformer import LM
from repro_torch.train.step import build_serve_step
from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4            # across frameworks, relative to max(1, |ref|)
SELF_TOL = 5e-3       # decode against forward (tests/test_models.py)
DECODE_ARCHS = ["qwen2-0.5b", "mamba2-2.7b", "qwen2-moe-a2.7b",
                "grok-1-314b", "recurrentgemma-2b"]


def flat(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat(v)]
    return [tree]


def assert_close(got, ref, tol=TOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert float(err.max(initial=0.0)) <= tol, float(err.max())


def shifted(tree, seed):
    """A JAX tree with every leaf moved off its constant init, so each
    bias and norm carries signal."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: x + jnp.asarray(0.05 * rng.normal(size=x.shape), x.dtype),
        tree)


def configs(arch):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if cfg.n_experts:             # drop-free, as the reference's test
        jcfg = dataclasses.replace(jcfg, capacity_factor=16.0)
        cfg = dataclasses.replace(cfg, capacity_factor=16.0)
    return jcfg, cfg


# --------------------------------------------------------- attention decode
ATTN_CASES = {
    # name: (arch, heads, kv heads, window, max_len, steps)
    "mha": ("qwen2-moe-a2.7b", 4, 4, 0, 24, 20),
    "gqa": ("qwen2-0.5b", 4, 2, 0, 24, 20),
    "mqa_qk_norm": ("qwen3-8b", 4, 1, 0, 24, 20),
    "ring_wraps": ("qwen2-0.5b", 4, 2, 8, 24, 20),
    "mrope": ("qwen2-vl-7b", 4, 1, 6, 24, 14),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_decode_matches_jax(case):
    arch, H, Hkv, window, max_len, steps = ATTN_CASES[case]
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), num_heads=H,
                               num_kv_heads=Hkv)
    cfg = dataclasses.replace(get_config(arch).reduced(), num_heads=H,
                              num_kv_heads=Hkv)
    jp = shifted(jax_attn.init_attention(jcfg, jax.random.PRNGKey(0),
                                         jnp.float32), 1)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(2).normal(
        size=(steps, 2, 1, cfg.d_model)).astype(np.float32)

    jc = jax_attn.init_kv_cache(jcfg, 2, max_len, window, jnp.float32)
    tc = attention.init_kv_cache(cfg, 2, max_len, window, torch.float32)
    L = window or max_len
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        {k: v.shape for k, v in jc.items()} == \
        {"k": (2, L, Hkv, 32), "v": (2, L, Hkv, 32)}
    dec = jax.jit(lambda p, x, c, i: jax_attn.attention_decode(
        p, jcfg, x, c, i, window=window))
    buffers = (tc["k"], tc["v"])
    for i in range(steps):
        want, jc = dec(jp, jnp.asarray(x[i]), jc, jnp.int32(i))
        got, tc = attention.attention_decode(
            tp, cfg, torch.tensor(x[i]), tc, torch.tensor(i), window=window)
        assert_close(got.numpy(), want)
        for k in ("k", "v"):
            assert_close(tc[k].numpy(), jc[k])
    # written in place: the buffers init_kv_cache made
    assert (tc["k"], tc["v"]) == buffers
    if window:
        assert steps > L          # the ring wrapped


# ------------------------------------------------------------- SSM decode
def test_ssm_decode_matches_jax():
    jcfg, cfg = configs("mamba2-2.7b")
    jp = shifted(jax_ssm.init_ssm(jcfg, jax.random.PRNGKey(3), jnp.float32),
                 4)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(5).normal(
        size=(12, 2, 1, cfg.d_model)).astype(np.float32)
    jc = jax_ssm.init_ssm_cache(jcfg, 2, jnp.float32)
    tc = ssm.init_ssm_cache(cfg, 2, torch.float32)
    assert jax.tree.structure(jc) == jax.tree.structure(
        jax.tree.map(lambda _: 0, tree_to_numpy(tc)))
    for a, b in zip(flat(tc), jax.tree.leaves(jc)):
        assert tuple(a.shape) == b.shape and a.dtype == torch.float32
    state = tc["state"]
    dec = jax.jit(lambda p, x, c: jax_ssm.ssm_decode(p, jcfg, x, c))
    for i in range(12):
        want, jc = dec(jp, jnp.asarray(x[i]), jc)
        got, tc = ssm.ssm_decode(tp, cfg, torch.tensor(x[i]), tc)
        assert_close(got.numpy(), want)
        for a, b in zip(flat(tc), jax.tree.leaves(jc)):
            assert_close(a.numpy(), b)
    assert tc["state"] is state                  # written in place


def test_ssm_decode_keeps_the_cache_dtype():
    """A bf16 cache: the state is updated in f32 and stored back in bf16,
    as the reference stores it: within two bf16 ulps (2^-6 relative) of
    the reference's, whose f32 products may round the other way."""
    jcfg, cfg = configs("mamba2-2.7b")
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    jp = jax_ssm.init_ssm(jcfg, jax.random.PRNGKey(3), jnp.bfloat16)
    tp = tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(6).normal(size=(2, 1, cfg.d_model))
    jc = jax_ssm.init_ssm_cache(jcfg, 2, jnp.bfloat16)
    tc = ssm.init_ssm_cache(cfg, 2, torch.bfloat16)
    for _ in range(3):
        want, jc = jax_ssm.ssm_decode(jp, jcfg, jnp.asarray(x, jnp.bfloat16),
                                      jc)
        got, tc = ssm.ssm_decode(tp, cfg, torch.tensor(x).bfloat16(), tc)
    assert got.dtype == tc["state"].dtype == torch.bfloat16
    # the output: within 2^-6 of its largest value (two bf16 ulps there)
    ref = np.asarray(want, np.float32)
    assert np.abs(got.float().numpy() - ref).max() <= \
        2 ** -6 * np.abs(ref).max()
    np.testing.assert_allclose(tc["state"].float().numpy(),
                               np.asarray(jc["state"], np.float32),
                               atol=1e-2, rtol=2 ** -6)


# ------------------------------------------------------------- LM decode
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_lm_decode_step_matches_jax_and_its_own_forward(arch):
    jcfg, cfg = configs(arch)
    jm, m = JaxLM(jcfg), LM(cfg)
    jparams = shifted(jm.init(jax.random.PRNGKey(0)), 8)
    params = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    S = 32
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                             size=(2, S)).astype(np.int32)
    jcache = jm.init_cache(2, 40)
    cache = m.init_cache(2, 40)
    assert jax.tree.structure(jcache) == jax.tree.structure(
        jax.tree.map(lambda _: 0, tree_to_numpy(cache)))
    leaves = flat(cache)
    jdec = jax.jit(jm.decode_step)
    outs = []
    index = torch.zeros((), dtype=torch.int64)
    with torch.no_grad():
        for i in range(S):
            want, jcache = jdec(jparams, jcache, jnp.asarray(toks[:, i:i + 1]),
                                jnp.int32(i))
            got, cache = m.decode_step(
                params, cache, torch.from_numpy(toks[:, i:i + 1]).long(),
                index)
            index += 1
            assert got.dtype == torch.float32 and got.shape == want.shape
            assert_close(got.numpy(), want)
            outs.append(got[:, 0])
        full, _ = m.forward(params, {"tokens": torch.from_numpy(toks).long()})
    for a, b, c in zip(flat(cache), jax.tree.leaves(jcache), leaves):
        assert a is c                        # the buffers init_cache made
        assert_close(a.numpy(), b)
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=SELF_TOL, rtol=0)


def test_encoder_only_and_unported_families_have_no_decode():
    """hubert (encoder-only, audio), qwen2-vl (vision) and recurrentgemma
    (RG-LRU) all build now (slices 11 and 12); the two decoders have a
    decode input as the reference gives it, while an encoder-only config's
    decode shapes are not applicable (``shape_applicable``, the
    reference's rule) and it has no decode step."""
    for arch in ("hubert-xlarge", "qwen2-vl-7b", "recurrentgemma-2b"):
        cfg = get_config(arch)
        LM(cfg.reduced())
        applicable = shape_applicable(cfg, SHAPES["decode_32k"])
        assert applicable == (arch != "hubert-xlarge")
        if applicable:
            kind, got = input_specs(cfg, SHAPES["decode_32k"])
            assert kind == "decode" and set(got) == {"cache", "tokens",
                                                     "index"}
    enc = dataclasses.replace(get_config("qwen2-0.5b").reduced(),
                              causal=False, frontend="none")
    assert enc.is_encoder_only
    for m in (LM(enc), LM(get_config("hubert-xlarge").reduced())):
        with pytest.raises(ValueError, match="encoder-only"):
            m.decode_step(m.init(0), m.init_cache(1, 4),
                          torch.zeros((1, 1), dtype=torch.int64), 0)


# ------------------------------------------------------------- serve step
def test_serve_step_matches_the_reference():
    jcfg, cfg = configs("qwen2-0.5b")
    jm, m = JaxLM(jcfg), LM(cfg)
    jparams = shifted(jm.init(jax.random.PRNGKey(2)), 9)
    params = tree_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    jserve, serve = jax.jit(jax_build_serve_step(jm)), build_serve_step(m)
    jcache, cache = jm.init_cache(3, 16), m.init_cache(3, 16)
    buffers = flat(cache)
    jtok = jnp.asarray(np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(3, 1)), jnp.int32)
    tok = torch.tensor(np.asarray(jtok)).long()
    for i in range(10):
        jtok, jcache = jserve(jparams, jcache, jtok, jnp.int32(i))
        nxt, out = serve(params, cache, tok, torch.tensor(i))
        assert out is cache and nxt.dtype == torch.int32
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jtok))
        jtok, tok = jtok[:, None], nxt[:, None]
    assert all(a is b for a, b in zip(flat(cache), buffers))
    for a, b in zip(flat(cache), jax.tree.leaves(jcache)):
        assert_close(a.numpy(), b)


# ----------------------------------------------------------- input specs
# every architecture builds; an encoder-only one has no decode shapes
PORTED = list_archs()
DECODE_CASES = [(arch, shape_name) for shape_name in ("decode_32k", "long_500k")
                for arch in PORTED
                if shape_applicable(get_config(arch), SHAPES[shape_name])]


def meta_struct(tree):
    """(shape, dtype name) leaves of a JAX struct tree or a torch tree."""
    if isinstance(tree, dict):
        return {k: meta_struct(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [meta_struct(v) for v in tree]
    return (tuple(tree.shape), str(tree.dtype).split(".")[-1])


@pytest.mark.parametrize("arch,shape_name", DECODE_CASES)
def test_input_specs_decode_equal_the_reference(arch, shape_name):
    """Kind, keys, nesting, shapes and dtypes of the decode inputs; token
    ids and the index are int64 in the port, int32 in the reference."""
    shape = SHAPES[shape_name]
    cfg = config_for_shape(get_config(arch), shape)
    rcfg = r_config_for_shape(jax_get_config(arch), R_SHAPES[shape_name])
    assert cfg.sliding_window == rcfg.sliding_window
    kind, got = input_specs(cfg, shape)
    rkind, ref = r_input_specs(rcfg, R_SHAPES[shape_name])
    assert kind == rkind == "decode" and list(got) == list(ref)
    assert all(t.device.type == "meta" for t in flat(got))
    ints = {"int32": "int64"}
    want = meta_struct(ref)
    want["tokens"] = (want["tokens"][0], ints[want["tokens"][1]])
    want["index"] = (want["index"][0], ints[want["index"][1]])
    assert meta_struct(got) == want
    if shape_name == "long_500k" and not cfg.subquadratic:
        assert cfg.sliding_window == 8192
        assert got["cache"]["cycles"][0]["k"].shape[2] == 8192


# ---------------------------------------------------------------- example
def test_serve_example_runs_on_the_cpu_and_decodes_the_forward(
        monkeypatch, capsys):
    monkeypatch.syspath_prepend(os.path.join(ROOT, "examples"))
    example = importlib.import_module("torch_serve_lm")
    out = example.main(["--device", "cpu", "--batch", "2", "--prompt-len",
                        "12", "--new-tokens", "6"])
    text = capsys.readouterr().out
    assert "prefilled 12 positions" in text and "tok/s batched" in text
    assert "on cpu" in text
    cfg = get_config("qwen2-0.5b").reduced(d_model=256)
    m = LM(cfg)
    seq = torch.cat([out["prompts"], out["generated"].long()], dim=1)
    with torch.no_grad():
        logits, _ = m.forward(m.init(0), {"tokens": seq})
    # greedy token t+1 is the arg-max of the logits at t
    want = logits[:, 11:17].argmax(-1)
    np.testing.assert_array_equal(out["generated"].numpy(), want.numpy())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            example.main([])
