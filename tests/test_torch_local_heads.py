"""The kernels on each rank's local heads, on the CPU.

(a) :func:`repro_torch.kernels.ops.attention_plan` / ``ssd_plan`` over a
table of placements: a batch split on ``data``, plan cases 1 (q and kv
heads split on whole GQA groups), 2 (q heads inside one kv group, the kv
head sliced locally, ``dk`` / ``dv`` ``Partial``) and 3 (heads gathered),
and the SSD plan (``dB`` / ``dC`` ``Partial``).

(b) ``kops.flash_attention`` / ``kops.ssd_intra`` on DTensors over four
``gloo`` ranks, on a ``(data 2, model 2)`` and a ``(1, 4)`` mesh, one
call per case: the output and every input's gradient (``dk`` / ``dv`` of
replicated kv, ``dB`` / ``dC``) gathered whole within 1e-6 of the
whole-tensor binding on the same seeded inputs, in f32, at the scale of
the reference (its largest magnitude, at least 1).

(c) ``python -m repro_torch.launch.train --use-kernel`` over four ``gloo``
ranks on a ``(2, 2)`` mesh, reduced qwen2-0.5b and reduced mamba2-2.7b,
from the JAX package's seed-0 weights, against the reference's
``build_train_step(LM(cfg, use_kernel=True))`` on a ``(2, 2)``
``jax.sharding.Mesh`` of four forced host devices (its Pallas kernels in
interpret mode) and against the port's one-process launcher: losses within
1e-5 relative, gathered parameters within 1e-4
(``tests/test_torch_launch_ranks.py``'s tolerances).  (d) On the CPU no
kernel launches: every call is a counted ``device:cpu`` fallback.
"""

import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.distributed.tensor import Partial, Replicate, Shard

from repro_torch.kernels import ops as kops
from repro_torch.launch import train as launcher
from repro_torch.models import LM
from test_torch_launch_ranks import _JAX_SCRIPT, _free_port, flat

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
S0, S2, S3, R = Shard(0), Shard(2), Shard(3), Replicate()


# --------------------------------------------------------- (a) the plans
# name: (q, k / v placements, hq, hkv, mesh shape) → (cases, inputs of q
# and k, gradient of k, output, kv_heads, gathered)
ATTENTION_PLANS = {
    "case1": (((S0, S2), (S0, S2)), 4, 2, (2, 2)),
    "case1_kv_whole": (((S0, S2), (S0, R)), 8, 4, (2, 2)),
    "case2": (((S0, S2), (S0, R)), 4, 1, (2, 2)),
    "case2_gqa": (((S0, S2), (S0, R)), 8, 2, (1, 4)),
    "case3_straddle": (((S0, S2), (S0, R)), 6, 3, (2, 2)),
    "case3_q_whole": (((S0, R), (S0, R)), 14, 2, (2, 4)),
    "batch_only": (((S0, R), (S0, R)), 4, 2, (4, 1)),
    "one_card": (((S0, S2), (S0, S2)), 14, 2, (1, 1)),
}
ATTENTION_WANT = {
    "case1": (("batch", "heads"), (S0, S2), (S0, S2), (S0, S2), (S0, S2),
              None, False),
    "case1_kv_whole": (("batch", "heads"), (S0, S2), (S0, S2), (S0, S2),
                       (S0, S2), None, False),
    "case2": (("batch", "kv_group"), (S0, S2), (S0, R), (S0, Partial()),
              (S0, S2), (1, (0, 0)), False),
    "case2_gqa": (("batch", "kv_group"), (S0, S2), (S0, R),
                  (S0, Partial()), (S0, S2), (1, (0, 0, 1, 1)), False),
    "case3_straddle": (("batch", "gathered"), (S0, R), (S0, R), (S0, R),
                       (S0, R), None, True),
    "case3_q_whole": (("batch", "gathered"), (S0, R), (S0, R), (S0, R),
                      (S0, R), None, True),
    "batch_only": (("batch", "gathered"), (S0, R), (S0, R), (S0, R),
                   (S0, R), None, False),
    "one_card": (("batch", "heads"), (S0, S2), (S0, S2), (S0, S2),
                 (S0, S2), None, False),
}


@pytest.mark.parametrize("name", sorted(ATTENTION_PLANS))
def test_attention_plan(name):
    """Each mesh dimension's case, the placements q and k are taken in,
    k's declared gradient (``Partial`` in case 2 only), the output's, the
    kv head each coordinate reads, and whether heads were gathered on a
    dimension of more than one rank."""
    (pq, pkv), hq, hkv, shape = ATTENTION_PLANS[name]
    cases, q_in, k_in, k_grad, out, kv, gathered = ATTENTION_WANT[name]
    plan = kops.attention_plan((pq, pkv, pkv), hq, hkv, shape)
    assert plan.cases == cases
    assert plan.inputs[0] == q_in and plan.inputs[1:] == (k_in, k_in)
    assert plan.grads[0] == q_in and plan.grads[1:] == (k_grad, k_grad)
    assert plan.output == out
    assert plan.kv_heads == kv
    assert plan.gathered is gathered


# name: (xr, dtr, ltT, Br / Cr placements, heads, mesh shape)
SSD_PLANS = {
    "ssd_heads": ((S0, S3), (S0, R), (S0, R), (S0, R), 8, (2, 2)),
    "ssd_heads_dt_split": ((S0, S3), (S0, S3), (S0, S2), (S0, R), 8,
                           (2, 2)),
    "ssd_x_whole": ((S0, R), (S0, R), (S0, R), (S0, R), 8, (2, 2)),
    "ssd_uneven": ((S0, S3), (S0, R), (S0, R), (S0, R), 6, (1, 4)),
}


@pytest.mark.parametrize("name", sorted(SSD_PLANS))
def test_ssd_plan(name):
    """xr split on heads takes dt and the decays on its heads while B and
    C stay whole with ``Partial`` gradients; anything else is gathered."""
    px, pdt, plt, pbc, heads, shape = SSD_PLANS[name]
    plan = kops.ssd_plan((px, pdt, plt, pbc, pbc), heads, shape)
    if name.startswith("ssd_heads"):
        assert plan.cases == ("batch", "heads")
        assert plan.inputs == ((S0, S3), (S0, S3), (S0, S2), (S0, R),
                               (S0, R))
        assert plan.grads == ((S0, S3), (S0, S3), (S0, S2),
                              (S0, Partial()), (S0, Partial()))
        assert plan.output == (S0, S3) and not plan.gathered
    else:
        assert plan.cases == ("batch", "gathered")
        assert plan.inputs == ((S0, R),) * 5 == plan.grads
        assert plan.output == (S0, R) and plan.gathered


# ---------------------------------------------- (b) the bindings on ranks
# name: (mesh shape, hq, hkv, q placements, k / v placements, causal,
# window); B 2, S 16, hd 8
BIND_ATTENTION = {
    "case1": ((2, 2), 4, 2, (S0, S2), (S0, S2), True, 0),
    "case1_kv_whole": ((2, 2), 8, 4, (S0, S2), (S0, R), True, 0),
    "case2": ((2, 2), 4, 1, (S0, S2), (S0, R), True, 0),
    "case2_gqa": ((1, 4), 8, 2, (S0, S2), (S0, R), True, 5),
    "case3_straddle": ((2, 2), 6, 3, (S0, S2), (S0, R), False, 0),
    "case3_q_whole": ((2, 2), 4, 2, (S0, R), (S0, R), True, 0),
}
# name: (mesh shape, xr, dtr, ltT, Br / Cr placements); B 2, nc 2, Q 8,
# H 4, P 8, N 4
BIND_SSD = {
    "ssd_heads": ((2, 2), (S0, S3), (S0, R), (S0, R), (S0, R)),
    "ssd_heads_dt_split": ((2, 2), (S0, S3), (S0, S3), (S0, S2), (S0, R)),
    "ssd_gqa_mesh": ((1, 4), (S0, S3), (S0, R), (S0, R), (S0, R)),
    "ssd_x_whole": ((2, 2), (S0, R), (S0, R), (S0, R), (S0, R)),
}
BIND_ATOL = 1e-6                 # by :func:`_err`, relative to the scale


def _attention_inputs(hq, hkv, seed):
    g = np.random.default_rng(seed)
    shapes = [(2, 16, hq, 8), (2, 16, hkv, 8), (2, 16, hkv, 8),
              (2, 16, hq, 8)]
    return [torch.from_numpy(g.standard_normal(s).astype(np.float32))
            for s in shapes]


def _ssd_inputs(seed):
    g = np.random.default_rng(seed)
    B, nc, Q, H, P, N = 2, 2, 8, 4, 8, 4
    f = lambda *s: g.standard_normal(s).astype(np.float32)
    arrays = [f(B, nc, Q, H, P), np.abs(f(B, nc, Q, H)) * 0.5,
              -np.abs(f(B, nc, H, Q)) * 0.3, f(B, nc, Q, N), f(B, nc, Q, N),
              f(B, nc, Q, H, P)]
    return [torch.from_numpy(a) for a in arrays]


def _err(a, ref):
    """Max abs difference over the reference's scale (at least 1): the
    partial sums of ``dB`` / ``dC`` and case 2's ``dk`` / ``dv`` add in
    another order than the whole call's, so they round at that scale."""
    return float((a - ref).abs().max() / max(1.0, float(ref.abs().max())))


def _bind_case(mesh, fn, whole, placements, seed):
    """One binding call on DTensors against the whole-tensor call: max
    abs errors of the output and of each input's gradient, the output's
    and each gradient's placements, and the counter deltas."""
    from torch.distributed.tensor import distribute_tensor
    *inputs, do = whole
    leaves = [x.clone().requires_grad_() for x in inputs]
    ref = fn(*leaves)
    ref.backward(do)
    dts = [distribute_tensor(x, mesh, list(p)).requires_grad_()
           for x, p in zip(inputs, placements)]
    stats0 = (kops.KERNEL_STATS.calls, kops.KERNEL_STATS.fallbacks,
              kops.KERNEL_STATS.heads_gathered)
    out = fn(*dts)
    out.backward(distribute_tensor(do, mesh, list(out.placements)))
    return {
        "out": _err(out.full_tensor(), ref),
        "grads": [_err(d.grad.full_tensor(), x.grad)
                  for d, x in zip(dts, leaves)],
        "out_placements": tuple(out.placements),
        "grad_placements": [tuple(d.grad.placements) for d in dts],
        "counts": tuple(b - a for a, b in zip(stats0, (
            kops.KERNEL_STATS.calls, kops.KERNEL_STATS.fallbacks,
            kops.KERNEL_STATS.heads_gathered))),
        "launches": launcher._launches()}


def _bind_rank(rank, port, out_dir):
    """One rank: every binding case, the results pickled to
    ``out_dir``."""
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    dist.init_process_group("gloo", rank=rank, world_size=WORLD)
    try:
        meshes = {shape: init_device_mesh("cpu", shape,
                                          mesh_dim_names=("data", "model"))
                  for shape in ((2, 2), (1, 4))}
        got = {}
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", kops.KernelFallbackWarning)
            for i, (name, (shape, hq, hkv, pq, pkv, causal, window)) in \
                    enumerate(sorted(BIND_ATTENTION.items())):
                fn = lambda q, k, v: kops.flash_attention(
                    q, k, v, causal=causal, window=window)
                got[name] = _bind_case(meshes[shape], fn,
                                       _attention_inputs(hq, hkv, i),
                                       (pq, pkv, pkv), i)
            for i, (name, (shape, *ps)) in enumerate(sorted(
                    BIND_SSD.items())):
                got[name] = _bind_case(meshes[shape], kops.ssd_intra,
                                       _ssd_inputs(i), ps + [ps[-1]], i)
        with open(os.path.join(out_dir, f"bind{rank}.pkl"), "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def bindings(tmp_path_factory):
    """Every rank's results of every binding case."""
    d = tmp_path_factory.mktemp("bindings")
    mp.spawn(_bind_rank, args=(_free_port(), str(d)), nprocs=WORLD,
             join=True)
    ranks = []
    for rank in range(WORLD):
        with open(d / f"bind{rank}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks


def _leaf_grads(plan, placements):
    """Each input's gradient placements: as the plan declares them where
    the input was taken as it lay, else the input's own (the backward of
    its redistribution)."""
    return [g if p == i else p for p, i, g in zip(placements, plan.inputs,
                                                  plan.grads)]


@pytest.mark.parametrize("name", sorted(BIND_ATTENTION))
def test_flash_attention_on_dtensors(bindings, name):
    """B2–B4's binding on DTensors: the output and ``dq``, ``dk``, ``dv``
    within 1e-6 of the whole-tensor binding on every rank, placed as the
    plan says (``dk`` / ``dv`` a ``Partial`` sum in case 2), one counted
    CPU fallback a call, gathered heads counted in case 3 only."""
    shape, hq, hkv, pq, pkv, causal, window = BIND_ATTENTION[name]
    plan = kops.attention_plan((pq, pkv, pkv), hq, hkv, shape)
    for got in (r[name] for r in bindings):
        assert got["out"] <= BIND_ATOL, got
        assert max(got["grads"]) <= BIND_ATOL, got
        assert got["out_placements"] == plan.output
        assert got["grad_placements"] == _leaf_grads(plan, (pq, pkv, pkv))
        assert got["counts"] == (0, 1, int(plan.gathered))
        assert set(got["launches"].values()) == {0}


@pytest.mark.parametrize("name", sorted(BIND_SSD))
def test_ssd_intra_on_dtensors(bindings, name):
    """B5–B6's binding on DTensors: ``y`` and ``dx``, ``ddt``, ``dlt``,
    ``dB``, ``dC`` within 1e-6 of the whole-tensor binding on every rank
    (``dB`` / ``dC`` partial sums over the head shards), one counted CPU
    fallback a call."""
    shape, px, pdt, plt, pbc = BIND_SSD[name]
    plan = kops.ssd_plan((px, pdt, plt, pbc, pbc), 4, shape)
    for got in (r[name] for r in bindings):
        assert got["out"] <= BIND_ATOL, got
        assert max(got["grads"]) <= BIND_ATOL, got
        assert got["out_placements"] == plan.output
        assert got["grad_placements"] == _leaf_grads(plan, (px, pdt, plt,
                                                            pbc, pbc))
        assert got["counts"] == (0, 1, int(plan.gathered))
        assert set(got["launches"].values()) == {0}


# ------------------------------------- (c) the launcher with --use-kernel
STEPS, LR, MODEL_AXIS = 3, 3e-4, 2
# arch: (batch, seq); mamba2's sequence is four of its reduced chunks
LAUNCH = {"qwen2-0.5b": (4, 32), "mamba2-2.7b": (4, 64)}


def _argv(arch):
    batch, seq = LAUNCH[arch]
    return ["--arch", arch, "--reduced", "--steps", str(STEPS), "--batch",
            str(batch), "--seq", str(seq), "--lr", str(LR), "--device",
            "cpu", "--use-kernel"]


def _launch_rank(rank, port, arch, weights, out_dir):
    """One rank: the launcher's ``main`` with ``--use-kernel`` from
    ``weights`` on a (2, 2) mesh; its report and gathered final
    parameters pickled to ``out_dir``."""
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    from repro_torch.launch import dryrun
    from repro_torch.utils.convert import tree_from_numpy, tree_to_numpy
    from repro_torch.utils.tree import tree_map

    launcher.model_axis = lambda n: MODEL_AXIS
    dryrun.ShardedLM.init = \
        lambda self, seed, device=None: tree_from_numpy(weights, device)
    loop, kept = launcher._loop, {}

    def keep(*args, **kw):
        out, params = loop(*args, **kw)
        kept["params"] = tree_map(lambda x: x.full_tensor(), params)
        return out, params

    launcher._loop = keep
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", kops.KernelFallbackWarning)
        out = launcher.main(_argv(arch))
    out["params"] = flat(tree_to_numpy(kept["params"]))
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module", params=sorted(LAUNCH))
def launched(request, tmp_path_factory):
    """For one arch: the reference's ``use_kernel=True`` step on a (2, 2)
    mesh of four host devices, four ranks of the port's launcher with
    ``--use-kernel``, and its one-process launcher, from the JAX
    package's seed-0 weights."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import LM as JaxLM
    from repro_torch.utils.convert import tree_from_numpy

    arch = request.param
    batch, seq = LAUNCH[arch]
    tmp = tmp_path_factory.mktemp(arch)
    jcfg = jax_get_config(arch).reduced(d_model=256)
    weights = jax.tree.map(np.asarray,
                           JaxLM(jcfg).init(jax.random.PRNGKey(0)))
    wfile, jout = tmp / "weights.pkl", tmp / "jax.pkl"
    with open(wfile, "wb") as f:
        pickle.dump(weights, f)
    script = tmp / "jax_mesh_step.py"
    script.write_text(_JAX_SCRIPT.format(
        src=os.path.join(REPO, "src"), arch=arch, data=WORLD // MODEL_AXIS,
        model=MODEL_AXIS, weights=str(wfile), batch=batch, seq=seq,
        steps=STEPS, lr=LR, out=str(jout), use_kernel=True))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               + os.environ.get("XLA_FLAGS", ""))
    proc = subprocess.Popen([sys.executable, str(script)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        mp.spawn(_launch_rank, args=(_free_port(), arch, weights, str(tmp)),
                 nprocs=WORLD, join=True)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, stderr[-4000:]
    assert "JAX-MESH-OK" in stdout
    with open(jout, "rb") as f:
        ref = pickle.load(f)
    ranks = []
    for rank in range(WORLD):
        with open(tmp / f"rank{rank}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    init = LM.init
    LM.init = lambda self, seed, device=None: tree_from_numpy(
        weights, device or "cpu")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", kops.KernelFallbackWarning)
            one = launcher.main(_argv(arch))
    finally:
        LM.init = init
        kops.reset_kernel_stats()           # the fallbacks warned once
    return {"arch": arch, "ref": ref, "ranks": ranks, "one": one}


def test_use_kernel_ranks_losses(launched):
    """Every rank's three losses within 1e-5 relative of the reference's
    ``use_kernel=True`` step on its (2, 2) mesh and of the port's
    one-process launcher with ``--use-kernel``."""
    ref, one = launched["ref"]["losses"], launched["one"]["losses"]
    np.testing.assert_allclose(one, ref, rtol=1e-5, atol=0)
    for got in launched["ranks"]:
        assert got["mesh"] == {"data": WORLD // MODEL_AXIS,
                               "model": MODEL_AXIS}
        np.testing.assert_allclose(got["losses"], ref, rtol=1e-5, atol=0)
        np.testing.assert_allclose(got["losses"], one, rtol=1e-5, atol=0)


def test_use_kernel_ranks_parameters(launched):
    """Every rank's gathered final parameters within 1e-4 of the
    reference's, leaf for leaf."""
    ref = launched["ref"]["params"]
    for got in launched["ranks"]:
        assert len(got["params"]) == len(ref)
        for a, b in zip(got["params"], ref):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_use_kernel_ranks_cpu_counters(launched):
    """On the CPU no kernel launches; each attention (or SSD) layer's call
    a step is a counted ``device:cpu`` fallback, on each local head
    shard (reduced qwen2's 4 / 1 heads split 2 + 2 inside its one kv
    group, case 2; mamba2's 8 SSD heads 4 + 4), none with heads gathered.
    The one-process launcher also counts B1's fallback a step."""
    from repro_torch.configs import get_config
    layers = get_config(launched["arch"]).reduced(d_model=256).num_layers
    for got in launched["ranks"] + [launched["one"]]:
        assert set(got["launches"]) == {f"B{i}" for i in range(1, 7)}
        assert set(got["launches"].values()) == {0}
        assert set(got["launches_tc"].values()) == {0}
        assert got["kernel_calls"] == 0 and got["heads_gathered"] == 0
    for got in launched["ranks"]:
        assert got["kernel_fallbacks"] == layers * STEPS
    assert launched["one"]["kernel_fallbacks"] == (layers + 1) * STEPS
