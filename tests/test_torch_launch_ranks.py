"""The launcher over several ranks, on the CPU: four ``gloo`` ranks
(``torch.multiprocessing.spawn``, the environment ``torchrun`` would set)
train reduced qwen2-0.5b on a ``(data 2, model 2)`` mesh of DTensors,
from the JAX package's seed-0 weights (carried over by
``repro_torch/utils/convert.py``).

Beside them, a subprocess with four forced host devices runs the JAX
package's train step on a ``(data 2, model 2)`` mesh, its parameters,
AdamW state and batches placed by the reference's ``param_specs`` /
``batch_specs``, as its launcher shards the step with GSPMD, on the same
weights and batches.  Every rank's three losses are within 1e-5
relative of it and of the port's one-process launcher, and the gathered
final parameters within 1e-4 of it: the tolerance of
``tests/test_torch_launch.py``'s three AdamW steps, since Adam normalises
a gradient entry that is float noise in both packages, so such an entry
moves by up to lr a step either way (the port's one-process launcher
lands 3e-5 from the reference's mesh run, its ranks as far).  Every
parameter's local shard has the shape its ``param_specs`` entry gives;
``--use-kernel`` over ranks goes on to the process group, and B2 / B5
handed DTensors return DTensors placed by their plans (the launcher with
``--use-kernel`` over ranks: ``tests/test_torch_local_heads.py``).
"""

import os
import pickle
import socket
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import get_config
from repro_torch.dist.sharding import param_specs, spec_leaves
from repro_torch.kernels import ops as kops
from repro_torch.launch import train as launcher
from repro_torch.models import LM
from repro_torch.utils.tree import tree_leaves

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH, WORLD, MODEL_AXIS = "qwen2-0.5b", 4, 2
STEPS, BATCH, SEQ, LR = 3, 4, 32, 3e-4
ARGV = ["--arch", ARCH, "--reduced", "--steps", str(STEPS), "--batch",
        str(BATCH), "--seq", str(SEQ), "--lr", str(LR), "--device", "cpu"]

# The JAX package's step on a (2, 2) mesh of forced host devices.  The
# mesh is ``jax.sharding.Mesh``'s, whose axes GSPMD shards automatically:
# ``jax.make_mesh`` on this JAX gives explicit axis types, under which the
# reference launcher's embedding gather stops with ``DuplicateSpecError``
# (see ``repro_torch/dist/sharding.py``).
_JAX_SCRIPT = """
import pickle, sys
sys.path.insert(0, {src!r})
import jax
import jax.numpy as jnp
import numpy as np
assert jax.device_count() == 4, jax.device_count()
from jax.sharding import Mesh
from repro.configs import get_config
from repro.data import DataPipeline, synthetic_lm_dataset
from repro.dist.sharding import (ShardingRules, batch_specs, mesh_sizes_of,
                                 param_specs)
from repro.launch.specs import batch_struct
from repro.models import LM
from repro.train.optimizer import init_opt_state
from repro.train.step import build_train_step, shardings_for

cfg = get_config({arch!r}).reduced(d_model=256)
mesh = Mesh(np.array(jax.devices()).reshape({data}, {model}),
            ("data", "model"))
rules = ShardingRules(fsdp="data", tp="model", dp=("data",))
sizes = mesh_sizes_of(mesh)
ns = lambda t: shardings_for(mesh, t)
with open({weights!r}, "rb") as f:
    params = jax.tree.map(jnp.asarray, pickle.load(f))
opt = init_opt_state("adamw", params)
params = jax.device_put(params, ns(param_specs(
    jax.eval_shape(lambda: params), rules, sizes)))
opt = jax.device_put(opt, ns(param_specs(jax.eval_shape(lambda: opt),
                                         rules, sizes)))
bshard = ns(batch_specs(cfg, batch_struct(cfg, {batch}, {seq}), rules,
                        sizes))
data = DataPipeline(synthetic_lm_dataset(4096, {seq}, cfg.vocab_size),
                    {batch})
step = jax.jit(build_train_step(LM(cfg, use_kernel={use_kernel})))
losses = []
for i in range({steps}):
    b = jax.device_put({{k: jnp.asarray(v)
                        for k, v in data.next_batch().items()}}, bshard)
    params, opt, loss = step(params, opt, b, jnp.float32({lr}),
                             jnp.int32(i))
    losses.append(float(loss))
assert any(not x.sharding.is_fully_replicated
           for x in jax.tree.leaves(params)), "nothing was sharded"
with open({out!r}, "wb") as f:
    pickle.dump({{"losses": losses,
                 "params": [np.asarray(x) for x in jax.tree.leaves(params)]}},
                f)
print("JAX-MESH-OK")
"""


def flat(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flat(v)]
    return [tree]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _on_dtensors(mesh):
    """On a rank, beside the launch: B2 / B5 handed DTensors return
    DTensors placed as their plans say (q split on the batch and heads,
    the SSD's x on the batch and its heads)."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                          distribute_tensor)
    gen = torch.Generator().manual_seed(7)
    place = lambda shape, p: distribute_tensor(
        torch.randn(shape, generator=gen), mesh, p)
    q = place((2, 8, 2, 4), [Shard(0), Shard(2)])
    x = place((2, 1, 8, 2, 4), [Shard(0), Shard(3)])
    dt, lt = place((2, 1, 8, 2), [Shard(0), Shard(3)]), \
        place((2, 1, 2, 8), [Shard(0), Shard(2)])
    bc = place((2, 1, 8, 4), [Shard(0), Replicate()])
    shape = tuple(mesh.mesh.shape)
    got = []
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", kops.KernelFallbackWarning)
        for out, plan in (
                (kops.flash_attention(q, q, q), kops.attention_plan(
                    (q.placements,) * 3, 2, 2, shape)),
                (kops.ssd_intra(x, dt, lt, bc, bc), kops.ssd_plan(
                    tuple(t.placements for t in (x, dt, lt, bc, bc)), 2,
                    shape))):
            got.append(isinstance(out, DTensor) and tuple(out.placements)
                       == plan.output == (Shard(0), Shard(plan.output[1].dim)))
    return got


def _rank(rank, port, weights, out_dir):
    """One rank: the launcher's ``main`` from ``weights`` on a (2, 2)
    mesh (the model axis fixed at 2: four ranks would take 4 by the
    launcher's rule), its report, its gathered final parameters and
    :func:`_on_dtensors` pickled to ``out_dir``."""
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    import torch.distributed as dist
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
        kept["mesh"] = next(iter(tree_leaves(params))).device_mesh
        return out, params

    launcher._loop = keep
    dist.init_process_group("gloo", rank=rank, world_size=WORLD)
    try:
        out = launcher.main(ARGV)
        got = dict(losses=out["losses"], local_shapes=out["local_shapes"],
                   mesh=out["mesh"], launches=out["launches"],
                   params=flat(tree_to_numpy(kept["params"])),
                   on_dtensors=_on_dtensors(kept["mesh"]))
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(got, f)
    finally:
        dist.destroy_process_group()


def test_four_gloo_ranks_train_as_one_process(tmp_path, monkeypatch):
    """Four ranks, ``(data 2, model 2)``, from the JAX package's seed-0
    weights: each rank's three losses within 1e-5 relative of the JAX
    package's step on a (2, 2) mesh of four host devices (the reference's
    own shardings) and of the port's one-process launcher, the gathered
    final parameters within 1e-4 of the reference's; every parameter's local
    shape the one ``param_specs`` gives on that mesh, no kernel launch;
    B2 and B5 on DTensors return DTensors placed by their plans."""
    import jax
    from repro.configs import get_config as jax_get_config
    from repro.models import LM as JaxLM
    from repro_torch.utils.convert import tree_from_numpy

    jcfg = jax_get_config(ARCH).reduced(d_model=256)
    weights = jax.tree.map(np.asarray,
                           JaxLM(jcfg).init(jax.random.PRNGKey(0)))
    wfile, jout = tmp_path / "weights.pkl", tmp_path / "jax.pkl"
    with open(wfile, "wb") as f:
        pickle.dump(weights, f)
    script = tmp_path / "jax_mesh_step.py"
    script.write_text(_JAX_SCRIPT.format(
        src=os.path.join(REPO, "src"), arch=ARCH, data=WORLD // MODEL_AXIS,
        model=MODEL_AXIS, weights=str(wfile), batch=BATCH, seq=SEQ,
        steps=STEPS, lr=LR, out=str(jout), use_kernel=False))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               + os.environ.get("XLA_FLAGS", ""))
    # the reference's run and the ranks side by side
    proc = subprocess.Popen([sys.executable, str(script)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        mp.spawn(_rank, args=(_free_port(), weights, str(tmp_path)),
                 nprocs=WORLD, join=True)
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        proc.kill()
    assert proc.returncode == 0, stderr[-4000:]
    assert "JAX-MESH-OK" in stdout
    with open(jout, "rb") as f:
        ref = pickle.load(f)

    monkeypatch.setattr(LM, "init", lambda self, seed, device=None:
                        tree_from_numpy(weights, device or "cpu"))
    one = launcher.main(ARGV)["losses"]
    np.testing.assert_allclose(one, ref["losses"], rtol=1e-5, atol=0)

    cfg = get_config(ARCH).reduced(d_model=256)
    sizes = {"data": WORLD // MODEL_AXIS, "model": MODEL_AXIS}
    params = LM(cfg).init(0, device="meta")
    specs = spec_leaves(param_specs(params, launcher.RULES, sizes))
    want = [tuple(n // (sizes[e] if e else 1) for n, e in zip(x.shape, s))
            for x, s in zip(tree_leaves(params), specs)]
    assert any(w != tuple(x.shape) for w, x in zip(want, tree_leaves(
        params)))                                # something is split
    for rank in range(WORLD):
        with open(tmp_path / f"rank{rank}.pkl", "rb") as f:
            got = pickle.load(f)
        assert got["mesh"] == sizes
        np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5,
                                   atol=0)
        np.testing.assert_allclose(got["losses"], one, rtol=1e-5, atol=0)
        assert len(got["params"]) == len(ref["params"])
        for a, b in zip(got["params"], ref["params"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
        assert got["local_shapes"] == want, rank
        assert got["launches"] == {f"B{i}": 0 for i in range(1, 7)}
        assert got["on_dtensors"] == [True, True]


def test_kernels_over_ranks_refuse_before_anything_starts(monkeypatch):
    """``--use-kernel`` over several ranks is not refused: the rank goes on
    to join the process group (stopped there).  The name is the one the
    test had while the launcher refused such a run, kept so that its
    history stays one test."""
    import torch.distributed as dist

    class Joined(Exception):
        pass

    def join(*args, **kw):
        raise Joined(kw)

    monkeypatch.setenv("WORLD_SIZE", str(WORLD))
    monkeypatch.setattr(dist, "init_process_group", join)
    with pytest.raises(Joined, match="'world_size': 4"):
        launcher.main(ARGV + ["--use-kernel"])
    assert not dist.is_initialized()


def test_several_cards_without_torchrun_say_how_to_launch(monkeypatch):
    """One process that sees several cards is refused with the
    ``torchrun`` line; one card, or the CPU, is the one-device mesh."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        launcher.local_mesh(torch.device("cuda"))
    mesh, devices = launcher.local_mesh(torch.device("cpu"))
    assert mesh.sizes == {"data": 1, "model": 1}
    assert devices == [torch.device("cpu")]
    assert [launcher.model_axis(n) for n in (1, 2, 4, 6, 8, 32)] == \
        [1, 2, 4, 2, 8, 16]
