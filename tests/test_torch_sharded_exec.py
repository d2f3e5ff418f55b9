"""Sharded stage execution on a worker mesh wider than one device, on the
CPU (the counterpart of ``tests/test_meshplane.py``'s 4-device subprocess
case, where the JAX package forces four host devices).

A ``TorchTrainer`` bound to a 4-device ``WorkerMesh`` keeps the carry at
rest split over the mesh (every shard a tensor of its own on the CPU),
gathers it whole before each chunk and splits it again after: the
study's checkpoints, metrics and counts are bit-equal to a thread
fleet's, and its metrics agree with the JAX trainer's thread fleet on the
same weights and data.  Solo stages, fused chains (with an optimizer
switch at a boundary) and both group tiers take this path.
"""

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings, strategies as st

import repro.core as R
import repro.core.tuners as RT
import repro_torch.core as T
import repro_torch.core.tuners as TT
from repro_torch.core.trainer import StageContext
from repro_torch.data import DataPipeline
from repro_torch.dist.meshes import WorkerMesh
from repro_torch.dist.sharding import (P, Shards, ShardingRules,
                                       generic_param_specs, join_leaf,
                                       join_tree, spec_leaves, split_leaf,
                                       split_tree)
from repro_torch.train.torch_trainer import TorchTrainer
from repro_torch.utils.tree import tree_leaves

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)

MESH4 = WorkerMesh.build([0, 1, 2, 3])       # a flat 4-device data axis
CPU = torch.device("cpu")


class TinyTask:
    """Linear softmax classifier (the reference tests' tiny task: w (16,
    4), b (4,)); with ``params0`` (numpy) it starts from those weights."""

    def __init__(self, params0=None):
        self.params0 = params0

    def init(self, gen):
        if self.params0 is not None:
            return {k: torch.from_numpy(np.array(v))
                    for k, v in self.params0.items()}
        return {"w": 0.1 * torch.randn((16, 4), generator=gen),
                "b": torch.zeros((4,))}

    def loss(self, params, batch):
        logits = batch["x"] @ params["w"] + params["b"]
        logp = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, 1, batch["y"][:, None]).mean()
        acc = (torch.argmax(logits, -1) == batch["y"]).float().mean()
        return nll, {"acc": acc}


class TinyMLP:
    """Two layers, 16 → 8 → 3: ``w2`` (8, 3) splits on its rows and
    ``b2`` (3,) on nothing, so it rests whole."""

    def init(self, gen):
        return {"w1": 0.3 * torch.randn((16, 8), generator=gen),
                "b1": torch.zeros((8,)),
                "w2": 0.3 * torch.randn((8, 3), generator=gen),
                "b2": torch.zeros((3,))}

    def loss(self, params, batch):
        h = torch.tanh(batch["x"] @ params["w1"] + params["b1"])
        logits = h @ params["w2"] + params["b2"]
        logp = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, 1, batch["y"][:, None] % 3).mean()
        acc = (torch.argmax(logits, -1) == batch["y"] % 3).float().mean()
        return nll, {"acc": acc}


def tiny_dataset(n=128, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(0, 1, (n, 16)).astype(np.float32),
            "y": rng.integers(0, 4, n).astype(np.int32)}


def backend(task=None, **kw):
    data = tiny_dataset()
    return TorchTrainer(task or TinyTask(), lambda: DataPipeline(
        data, batch_size=8, seed=3), tiny_dataset(seed=1),
        default_optimizer="momentum", device="cpu", **kw)


def bits(x):
    return x.contiguous().view(torch.uint8)


def assert_bit_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert not isinstance(y, Shards)
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(bits(x), bits(y))
        else:
            assert x == y


def assert_whole_on_cpu(state):
    for x in tree_leaves((state["params"], state["opt"])):
        assert isinstance(x, torch.Tensor) and x.device == CPU


# ---------------------------------------------------------------------------
# split / join
# ---------------------------------------------------------------------------

MESHES = [(("data", 4),), (("data", 2), ("model", 2)), (("data", 3),),
          (("data", 2),)]


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 12]), min_size=1,
                max_size=4),
       st.integers(0, 2), st.sampled_from(range(len(MESHES))),
       st.sampled_from([torch.float32, torch.bfloat16, torch.int64]),
       st.integers(0, 2 ** 31 - 1))
def test_split_then_join_is_bit_identical(shape, n_lead, mesh_i, dtype,
                                          seed):
    """Random trees split by ``generic_param_specs`` over a mesh and joined
    back are the same bits; every shard is a tensor of its own, of the
    chunk's shape, and the first ``n_lead`` dims never split."""
    axes = MESHES[mesh_i]
    n_dev = math.prod(n for _, n in axes)
    n_lead = min(n_lead, len(shape))
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn(shape, generator=gen) * 100).to(dtype)
    tree = {"a": x, "b": [x[..., :1].contiguous(), None]}
    specs = generic_param_specs(tree, ShardingRules.for_mesh(False),
                                sizes=dict(axes), n_lead=n_lead)
    rest = split_tree(tree, specs, axes, [CPU] * n_dev)
    for leaf, spec in zip(tree_leaves(rest), spec_leaves(specs)):
        assert all(e is None for e in spec[:n_lead])
        if all(e is None for e in spec):
            assert isinstance(leaf, torch.Tensor)
            continue
        assert isinstance(leaf, Shards) and len(leaf.pieces) == n_dev
        want = [n // (dict(axes)[e] if e else 1)
                for n, e in zip(leaf.shape, spec)]
        assert all(list(p.shape) == want for p in leaf.pieces)
    back = join_tree(rest, CPU)
    assert back["b"][1] is None
    assert_bit_equal(back, tree)


def test_split_over_a_two_axis_entry_in_mesh_order():
    """A dimension named by two axes splits row-major over both (the first
    outermost); devices that differ only on an axis the spec leaves out
    hold copies of one chunk."""
    axes = (("pod", 2), ("data", 2), ("model", 2))
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    s = split_leaf(x, P(("pod", "data"), None), axes, [CPU] * 8)
    assert [int(p[0, 0]) for p in s.pieces] == [0, 0, 6, 6, 12, 12, 18, 18]
    assert len({p.data_ptr() for p in s.pieces}) == 8
    assert torch.equal(join_leaf(s, CPU), x)
    with pytest.raises(ValueError, match="devices for a mesh"):
        split_leaf(x, P("data", None), axes, [CPU] * 4)


# ---------------------------------------------------------------------------
# the trainer on a 4-device mesh
# ---------------------------------------------------------------------------

def desc(lr, optimizer="momentum"):
    return {"hps": {"lr": {"kind": "const", "value": lr}},
            "static": {"optimizer": optimizer}}


def ctx(d, s0, s1):
    return StageContext("n", d, 0, s0, s1, "n")


def record_rests(tb):
    """Spy on the trainer's at-rest splits: a list of (n_lead, carry)."""
    seen = []
    real = tb._at_rest

    def spy(carry, n_lead):
        out = real(carry, n_lead)
        seen.append((n_lead, out))
        return out

    tb._at_rest = spy
    return seen


def test_carry_rests_in_four_pieces_between_chunks():
    """Between chunks each leaf that 4 divides is in 4 pieces along the
    dimension ``generic_param_specs`` names (the largest that divides), a
    member-stacked carry's member axis never splits though 4 divides it,
    and ``b2`` (3,) rests whole on the first device."""
    tb = backend(TinyMLP(), chunk_steps=2)
    tb.set_mesh(MESH4)
    seen = record_rests(tb)
    s0 = tb.init_state()
    tb.run_stage(s0, ctx(desc(0.05), 0, 6))
    tb.vectorize_groups = True
    tb.run_stages_batched([s0] * 4, [ctx(desc(v), 0, 4)
                                     for v in (0.1, 0.05, 0.02, 0.01)])
    assert {n for n, _ in seen} == {0, 1} and len(seen) >= 6
    for n_lead, (params, opt) in seen:
        for name, leaf in params.items():
            m = opt["m"][name]
            if name == "b2":                      # 3 divides no 4
                assert isinstance(leaf, torch.Tensor) and leaf.device == CPU
                assert isinstance(m, torch.Tensor)
                continue
            assert isinstance(leaf, Shards) and isinstance(m, Shards)
            d = {"w1": 0, "b1": 0, "w2": 0}[name] + n_lead
            assert leaf.spec[d] == "data" and leaf.spec[:n_lead] == (None,) \
                * n_lead
            assert len(leaf.pieces) == 4
            assert len({p.data_ptr() for p in leaf.pieces}) == 4
            for p in leaf.pieces:
                assert p.shape[d] * 4 == leaf.shape[d]
                if n_lead:
                    assert p.shape[0] == 4            # all four members


@pytest.mark.parametrize("vectorize", [False, True],
                         ids=["looped", "vectorised"])
def test_stages_on_the_mesh_are_bit_equal_to_a_thread_worker(vectorize):
    """A solo stage, a fused chain that switches from momentum to AdamW at
    a boundary, and a sibling group of chains (looped and vectorised
    tiers, switching likewise): every boundary state bit-equal to the
    same call on a thread worker, and whole on the CPU."""
    chain = [ctx(desc(0.05), 0, 5), ctx(desc(0.02, "adamw"), 5, 11)]
    group = [[ctx(desc(v), 0, 3), ctx(desc(v / 2, "adamw"), 3, 8)]
             for v in (0.1, 0.05, 0.02)]
    outs = {}
    for mesh in (None, MESH4):
        tb = backend(TinyMLP(), chunk_steps=4, vectorize_groups=vectorize)
        tb.set_mesh(mesh)
        s0 = tb.init_state()
        outs[mesh] = [tb.run_stage(s0, chain[0]), *tb.run_chain(s0, chain),
                      *[b for m in tb.run_chains_batched([s0] * 3, group)
                        for b in m]]
        if mesh is not None:
            for state in outs[mesh]:
                assert_whole_on_cpu(state)
    assert len(outs[None]) == 9
    for a, b in zip(outs[None], outs[MESH4]):
        assert a["opt_name"] == b["opt_name"]
        assert_bit_equal(a, b)
    assert outs[None][2]["opt_name"] == "adamw"


def _study(task, meshes, batch_siblings, vectorize):
    db = T.SearchPlanDB()
    study = T.Study.create(db, "m", "d", ("lr",))
    trials = [T.Trial(T.HpConfig({"lr": T.MultiStep(
        0.1, [8], values=[0.1, v])}), 16) for v in (0.05, 0.02, 0.01)]
    tb = backend(task, vectorize_groups=vectorize)
    # one worker: the fork checkpoint lands first, so the sibling tails
    # form a ready group next round instead of chaining off in-round state
    eng = study.engine(tb, n_workers=1, batch_siblings=batch_siblings,
                       worker_meshes=meshes)
    stats = eng.run([TT.GridTuner(trials)])
    plan = db.get(study.key)
    leaves = {t.trial_id: plan.trial_paths[t.trial_id][-1] for t in trials}
    ckpts = {tid: eng.store.get(plan.nodes[nid].ckpts[16])
             for tid, nid in leaves.items()}
    metrics = {tid: plan.nodes[nid].metrics[16]
               for tid, nid in leaves.items()}
    return stats, ckpts, metrics, tb


def _ref_study(vectorize):
    """The reference's thread fleet (its 4-device fleet is bitwise to it,
    ``tests/test_meshplane.py``)."""
    from test_dataplane import tiny_backend as ref_tiny_backend
    db = R.SearchPlanDB()
    study = R.Study.create(db, "m", "d", ("lr",))
    trials = [R.Trial(R.HpConfig({"lr": R.MultiStep(
        0.1, [8], values=[0.1, v])}), 16) for v in (0.05, 0.02, 0.01)]
    rb = ref_tiny_backend(vectorize_groups=vectorize)
    eng = study.engine(rb, n_workers=1, batch_siblings=True)
    stats = eng.run([RT.GridTuner(trials)])
    plan = db.get(study.key)
    p0 = {k: np.asarray(v) for k, v in rb.init_state()["params"].items()}
    return stats, {t.trial_id: plan.nodes[plan.trial_paths[t.trial_id][-1]]
                   .metrics[16] for t in trials}, p0


@pytest.mark.parametrize("batch_siblings,vectorize",
                         [(False, False), (True, False), (True, True)],
                         ids=["chains", "groups-looped", "groups-vectorised"])
def test_sharded_study_is_bit_equal_to_the_thread_fleet(batch_siblings,
                                                        vectorize):
    """The reference's sharded study (three ``MultiStep`` trials forking at
    step 8, 16 steps, one worker) on a ``WorkerMesh.build([0, 1, 2, 3])``
    fleet: leaf checkpoints, metrics and ``steps_run`` bit-equal to the
    thread fleet's, stages really placed on the mesh, the siblings batched
    where asked; the leaf metrics within the side-by-side tolerance (1e-4)
    of the JAX trainer's thread fleet from the same weights and data."""
    ref_stats, ref_metrics, p0 = _ref_study(vectorize)
    st_t, ck_t, me_t, _ = _study(TinyTask(p0), None, batch_siblings,
                                 vectorize)
    st_m, ck_m, me_m, tb = _study(TinyTask(p0), [MESH4], batch_siblings,
                                  vectorize)
    assert st_m.mesh_placements > 0 and st_t.mesh_placements == 0
    assert st_m.steps_run == st_t.steps_run == ref_stats.steps_run
    if batch_siblings:
        assert st_m.batched_groups >= 1
        assert st_m.batched_groups == st_t.batched_groups
    assert tb._wmesh == MESH4 and len(tb._mesh_devices) == 4
    assert me_m == me_t
    for tid in ck_t:
        assert_whole_on_cpu(ck_m[tid])
        assert_bit_equal(ck_m[tid], ck_t[tid])
        for k in ("loss", "val_acc"):
            np.testing.assert_allclose(me_m[tid][k], ref_metrics[tid][k],
                                       atol=1e-4, rtol=0)


def test_mlp_study_on_the_mesh_is_bit_equal():
    """The same study over ``TinyMLP`` (a leaf resting whole beside split
    ones), vectorised groups: bit-equal to the thread fleet."""
    st_t, ck_t, me_t, _ = _study(TinyMLP(), None, True, True)
    st_m, ck_m, me_m, _ = _study(TinyMLP(), [MESH4], True, True)
    assert st_m.batched_groups >= 1 and st_m.mesh_placements > 0
    assert me_m == me_t
    for tid in ck_t:
        assert_bit_equal(ck_m[tid], ck_t[tid])


def test_set_mesh_binds_and_unbinds():
    """A wide mesh binds its devices (the CPU per position on a CPU
    trainer); a one-device mesh or ``None`` is the default path again."""
    tb = backend()
    tb.set_mesh(MESH4)
    assert tb._mesh_devices == [CPU] * 4 and tb._home == CPU
    for m in (WorkerMesh.build([0]), None):
        tb.set_mesh(m)
        assert tb._wmesh is None and tb._mesh_devices is None
        assert tb._at_rest(("x",), 0) == ("x",)
