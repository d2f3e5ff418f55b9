"""The traffic mixes on the port's simulator: what a round delivers and
what the stage tree saves."""

import pytest

from hippo_bench import studies


def _round(name):
    from repro_torch.core.trainer import SimulatedTrainer
    mix = studies.load_mix(name)
    stats, tuners, trials, store = studies.run_round(SimulatedTrainer(), mix,
                                                     "model")
    return mix, stats, tuners, trials, store


@pytest.mark.parametrize("name, trial_steps, run, evals", [
    ("high_merge", 128, 32, 6), ("low_merge", 64, 64, 14)])
def test_round_counts(name, trial_steps, run, evals):
    mix, stats, tuners, trials, store = _round(name)
    assert sum(t.trial_steps for t in tuners) == trial_steps
    assert stats.steps_run == run
    assert stats.evals_run == evals
    assert all(t.is_done() for t in tuners)
    assert len(store) == 0                    # the round emptied its store


def test_trial_steps_are_sha_requests():
    """Per study: every trial to the first rung, the survivors on from
    their rung to the next."""
    mix = studies.load_mix("high_merge")
    tuner = studies.make_tuner(studies.make_trials(mix["studies"][0], 16),
                               mix["tuner"])
    rungs, n, want, prev = (4, 8, 16), 8, 0, 0
    for r in rungs:
        want += n * (r - prev)
        n, prev = n // 2, r
    assert want == 64
    _, _, tuners, _, _ = _round("high_merge")
    assert [t.trial_steps for t in tuners] == [want, want]
    assert tuner.trial_steps == 0


def test_high_merge_grids_overlap():
    """The second study shifts one decay set: 6 of its 8 schedules are
    the first study's, and they merge into the same trials."""
    mix = studies.load_mix("high_merge")
    a, b = (studies.make_trials(s, 16) for s in mix["studies"])
    assert len({t.trial_id for t in a} & {t.trial_id for t in b}) == 6


def test_low_merge_shares_nothing():
    mix = studies.load_mix("low_merge")
    a, b = (studies.make_trials(s, 16) for s in mix["studies"])
    assert not {t.trial_id for t in a} & {t.trial_id for t in b}
    # every trial its own first learning rate and weight decay: no two
    # share a step, no two can form a sibling group
    firsts = [(t["lr"], t["wd"]) for s in mix["studies"] for t in s]
    assert len(set(firsts)) == len(firsts)
    assert len({t["wd"] for s in mix["studies"] for t in s}) == len(firsts)
    _, stats, tuners, _, _ = _round("low_merge")
    assert sum(t.trial_steps for t in tuners) / stats.steps_run == 1.0


def test_schedule_is_the_ports_hp_sequence():
    mix = studies.load_mix("high_merge")
    for spec, trial in zip(mix["studies"][1],
                           studies.make_trials(mix["studies"][1], 16)):
        ours = [lr for lr, _ in studies.schedule(spec, 16)]
        theirs = [trial.hp_at(s)["lr"] for s in range(16)]
        assert ours == pytest.approx(theirs, rel=1e-12)
        assert trial.hp_at(3)["wd"] == spec["wd"]
