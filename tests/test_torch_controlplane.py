"""Control plane of the PyTorch package == the JAX package's, exactly.

The same randomised operation sequences (fixed seeds) drive a search plan
in each package; node ids, ``path_key``s (the checkpoint addresses), stage
trees and the chains every scheduling policy extracts must be equal — these
are pure-Python structures, so the bar is equality, not a tolerance.
"""

import pickle
import random

import pytest

import repro.core.hpseq as r_hpseq
import repro.core.scheduler as r_sched
import repro.core.searchplan as r_plan
import repro.core.stagetree as r_tree
import repro.core.trial as r_trial
import repro.core.values as r_values
import repro.core.merge as r_merge
import repro.utils as r_utils
import repro_torch.core.hpseq as t_hpseq
import repro_torch.core.scheduler as t_sched
import repro_torch.core.searchplan as t_plan
import repro_torch.core.stagetree as t_tree
import repro_torch.core.trial as t_trial
import repro_torch.core.values as t_values
import repro_torch.core.merge as t_merge
import repro_torch.utils as t_utils
from repro.core.engine.events import EventLoop as RefEventLoop
from repro_torch.core.engine.events import EventLoop


class Side:
    """One package's control-plane modules behind common names."""

    def __init__(self, hpseq, trial, plan, tree, sched):
        self.hpseq, self.trial, self.plan = hpseq, trial, plan
        self.tree, self.sched = tree, sched


REF = Side(r_hpseq, r_trial, r_plan, r_tree, r_sched)
PORT = Side(t_hpseq, t_trial, t_plan, t_tree, t_sched)


def random_trial(side, rng):
    steps = rng.choice([40, 80, 120, 160])
    base = rng.choice([0.1, 0.2])
    n_drops = rng.randint(0, 2)
    bounds = sorted(rng.sample([20, 40, 60, 80, 100, 120], n_drops))
    bounds = [b for b in bounds if b < steps]
    values = [base] + [round(base * 0.5 ** (i + 1), 4)
                       for i in range(len(bounds))]
    H = side.hpseq
    lr = H.MultiStep(base, bounds, values=values) if bounds \
        else H.Constant(base)
    fns = {"lr": lr}
    if rng.random() < 0.3:
        fns["bs"] = H.MultiStep(64, [60], values=[64, 128])
    return side.trial.Trial(H.HpConfig(fns), steps)


def tree_signature(tree):
    return (list(tree.roots),
            [(s.stage_id, s.node_id, s.start, s.stop, s.resume, s.parent,
              list(s.children), s.report) for s in tree.stages.values()])


def plan_signature(plan):
    return [(nid, plan.path_key(nid), n.parent, n.start, n.refcount,
             sorted(n.requests), sorted(n.running), dict(n.ckpts),
             sorted(n.trials))
            for nid, n in plan.nodes.items()]


def walk(side, seed, n_ops=100):
    """The randomised walk of ``tests/test_stagetree_incremental.py``;
    yields a snapshot of every observable after each operation."""
    rng = random.Random(seed)
    plan = side.plan.SearchPlan(f"prop-{seed}")
    stb = side.tree.StageTreeBuilder(plan)
    live, running, out = [], [], []
    for _ in range(n_ops):
        op = rng.random()
        if op < 0.40 or not plan.nodes:
            t = random_trial(side, rng)
            plan.submit(t, upto=rng.choice([None, 20, 60, 100]),
                        study=rng.choice(["s0", "s1"]))
            live.append(t)
        elif op < 0.65:
            pend = plan.pending_requests()
            if pend:
                req = rng.choice(pend)
                plan.mark_running([req])
                running.append(req)
        elif op < 0.90:
            if running:
                req = running.pop(rng.randrange(len(running)))
                plan.record_result(
                    req.node_id, req.step, f"ck-{req.node_id}-{req.step}",
                    {"val_acc": rng.random()} if rng.random() < 0.8 else None)
            elif plan.pending_requests():
                req = rng.choice(plan.pending_requests())
                plan.record_result(req.node_id, req.step,
                                   f"ck-{req.node_id}-{req.step}",
                                   {"val_acc": rng.random()})
        elif live:
            t = live.pop(rng.randrange(len(live)))
            path = list(plan.trial_paths.get(t.trial_id, []))
            dead = plan.release_trial(t.trial_id)
            for nid in path:
                node = plan.nodes[nid]
                for s in sorted(node.requests):
                    if s not in node.running and s not in node.metrics:
                        plan.drop_request(nid, s)
            for nid in dead:
                plan.evict_ckpts(nid)
        incremental = stb.build()
        scratch = side.tree.build_stage_tree(plan)
        assert side.tree.stage_trees_equal(incremental, scratch)
        assert plan.pending_requests() == plan.pending_requests_scan()
        out.append((plan_signature(plan), tree_signature(incremental),
                    [tuple(r) for r in plan.pending_requests()]))
    return plan, stb, out


@pytest.mark.parametrize("seed", range(8))
def test_randomised_plans_and_stage_trees_equal_across_packages(seed):
    _, _, ref = walk(REF, seed)
    _, _, port = walk(PORT, seed)
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"diverged after operation {i}"


@pytest.mark.parametrize("policy", sorted(r_sched.POLICIES))
@pytest.mark.parametrize("seed", [1, 4])
def test_every_policy_extracts_the_same_chains(policy, seed):
    assert sorted(t_sched.POLICIES) == sorted(r_sched.POLICIES)
    chains = []
    for side in (REF, PORT):
        plan, stb, _ = walk(side, seed, n_ops=60)
        # profiles steer the critical path: give nodes distinct ones
        for i, nid in enumerate(plan.nodes):
            plan.record_profile(nid, 0.5 + 0.1 * (i % 7))
        tree = stb.build()
        sched = side.sched.make_policy(policy)
        got = sched.assign(plan, tree, 4)
        chains.append([[(s.stage_id, s.node_id, s.start, s.stop)
                        for s in path] for path in got])
        taken = {s.stage_id for path in got for s in path}
        more = sched.assign(plan, tree, 3, taken=taken)
        chains[-1].append([[s.stage_id for s in path] for path in more])
    assert chains[0] == chains[1]
    assert chains[0][:-1], "the walk left nothing to schedule"


@pytest.mark.parametrize("seed", [0, 3])
def test_plan_json_round_trip_across_packages(seed):
    """A plan journalled by one package loads in the other with the same
    addresses (the journal is the cross-session contract)."""
    walked, _, _ = walk(REF, seed, n_ops=60)
    # running marks are transient and not journalled: compare two reloads
    ref_plan = r_plan.SearchPlan.from_json(walked.to_json())
    port_plan = t_plan.SearchPlan.from_json(walked.to_json())
    assert plan_signature(port_plan) == plan_signature(ref_plan)
    assert port_plan.to_json() == ref_plan.to_json()
    assert tree_signature(t_tree.build_stage_tree(port_plan)) == \
        tree_signature(r_tree.build_stage_tree(ref_plan))


def test_hashing_ids_values_and_merge_rates_equal():
    obj = {"b": [1, 2.5, "x"], "a": {"z": None, "y": (1, 2)}}
    assert t_utils.stable_hash(obj) == r_utils.stable_hash(obj)
    assert t_utils.short_hash(obj) == r_utils.short_hash(obj)
    a, b = t_utils.IdGen("stage", 3), r_utils.IdGen("stage", 3)
    assert [a() for _ in range(4)] == [b() for _ in range(4)]

    rng_a, rng_b = random.Random(5), random.Random(5)
    ta = [random_trial(PORT, rng_a) for _ in range(12)]
    tb = [random_trial(REF, rng_b) for _ in range(12)]
    assert [t.trial_id for t in ta] == [t.trial_id for t in tb]
    assert [t.to_json() for t in ta] == [t.to_json() for t in tb]
    assert t_merge.merge_rate(ta) == r_merge.merge_rate(tb)
    assert t_merge.unique_steps(ta) == r_merge.unique_steps(tb)
    assert t_merge.total_steps(ta) == r_merge.total_steps(tb)
    for x, y in zip(ta, tb):
        for seg_a, seg_b in zip(x.segments(), y.segments()):
            assert (seg_a.start, seg_a.stop, seg_a.desc) == \
                (seg_b.start, seg_b.stop, seg_b.desc)
            assert t_values.desc_values(seg_a.desc, seg_a.start, seg_a.start,
                                        seg_a.stop) == \
                r_values.desc_values(seg_b.desc, seg_b.start, seg_b.start,
                                     seg_b.stop)


@pytest.mark.parametrize("fn", [
    lambda H: H.Constant(0.1), lambda H: H.StepLR(0.1, 0.1, [90, 135]),
    lambda H: H.Warmup(5, 0.1, H.Exponential(0.1, 0.95)),
    lambda H: H.Cosine(0.1, 100), lambda H: H.Linear(0.1, 0.0, 50),
    lambda H: H.MultiStep(0.05, [40, 60], values=[0.05, 0.02, 0.002]),
    lambda H: H.Cyclic(0.01, 0.1, 20),
    lambda H: H.CosineWarmRestarts(0.1, 30)],
    ids=["constant", "steplr", "warmup_exp", "cosine", "linear", "multistep",
         "cyclic", "cosine_restarts"])
def test_hp_functions_equal(fn):
    a, b = fn(t_hpseq), fn(r_hpseq)
    assert a.to_json() == b.to_json()
    assert [a.value(s) for s in range(0, 160, 7)] == \
        [b.value(s) for s in range(0, 160, 7)]
    assert a.boundaries(160) == b.boundaries(160)
    for lo, hi in [(0, 40), (40, 100), (95, 160)]:
        assert a.piece_descriptor(lo, hi) == b.piece_descriptor(lo, hi)


def test_event_loop_orders_like_the_reference_and_pickles_clean():
    """Plain-int counters: same (time, insertion) order as the reference's
    ``itertools.count``, and pickling warns of nothing."""
    a, b = EventLoop(), RefEventLoop()
    for t, kind in [(3.0, "x"), (1.0, "y"), (3.0, "z"), (1.0, "w"), (0.5, "v")]:
        a.push(t, kind, None)
        b.push(t, kind, None)
    clone = pickle.loads(pickle.dumps(a))
    ids = pickle.loads(pickle.dumps(t_utils.IdGen("n", 7)))
    assert ids() == "n-7"
    order = lambda loop: [(e.time, e.seq, e.kind)
                          for e in iter(lambda: loop.pop() if loop else None,
                                        None)]
    want = order(b)
    assert order(a) == want and order(clone) == want
