"""A tuner that stops a trial another live study holds.

A trial's default id is a hash of its schedule and length, so two tuners
over the same schedules submit the same trial, and the plan merges them
as one.  A tuner stopping that trial (SHA's losers) stops it for its own
study only in this package: ``ExecutionEngine._kill`` detaches the study
and kills the trial when no other live study holds it, the check
``cancel_study`` makes.  The JAX package kills the trial for both, and the
study that promoted it waits forever — this file pins that departure.
"""

import pytest
import torch

import repro.core as R
import repro.core.tuners as RT
import repro_torch.core as T
import repro_torch.core.tuners as TT

# the suite runs several worker processes side by side: one intra-op
# thread each, or the workers fight over the cores
torch.set_num_threads(1)


def space(C, tuners, batch=64):
    """``examples/torch_hpo_resnet.py::space()``'s six schedules, built
    from package ``C``."""
    return tuners.GridSearchSpace(fns={
        "lr": [C.Constant(0.05),
               C.MultiStep(0.05, [40], values=[0.05, 0.005]),
               C.MultiStep(0.05, [40], values=[0.05, 0.02]),
               C.MultiStep(0.05, [60], values=[0.05, 0.005]),
               C.MultiStep(0.05, [60, 80], values=[0.05, 0.02, 0.002]),
               C.MultiStep(0.05, [80], values=[0.05, 0.01])],
        "bs": [C.Constant(batch)]})


def studies(C, tuners, sizes, n_workers=2):
    """SHA studies over the first ``n`` of the six schedules, one per
    entry of ``sizes``, in one ``StudyService`` over ``SimulatedTrainer``;
    returns each study's best trial id and the session's stats."""
    trials = space(C, tuners).trials(100)
    svc = C.StudyService(C.SearchPlanDB(), C.SimulatedTrainer(horizon=100),
                         n_workers=n_workers)
    spec = C.StudySpec("m", "d", ("lr", "bs"))
    shas = [tuners.SHATuner(trials[:n], min_steps=25, max_steps=100, eta=2)
            for n in sizes]
    for sha in shas:
        svc.submit(spec, sha)
    stats = svc.close()
    return [sha.best.trial_id for sha in shas], stats


@pytest.mark.parametrize("n_workers", [1, 2])
def test_shared_trial_stopped_by_one_study_lives_on_for_the_other(n_workers):
    """Six schedules and their first three, as two studies of one service:
    the service closes, each study's best trial is the one it finds
    alone, and the two train fewer steps together than apart.  The JAX
    package raises on the same scenario."""
    (best6,), alone6 = studies(T, TT, [6], n_workers)
    (best3,), alone3 = studies(T, TT, [3], n_workers)
    got, stats = studies(T, TT, [6, 3], n_workers)
    assert got == [best6, best3]
    assert stats.steps_run < alone6.steps_run + alone3.steps_run
    assert stats.by_study["study-1"].steps_run == alone3.steps_run
    with pytest.raises(RuntimeError,
                       match="service quiescent but studies not done"):
        studies(R, RT, [6, 3], n_workers)


def test_kill_with_no_other_holder_equals_the_reference():
    """A trial only its own study holds dies as in the JAX package: the
    same stats field for field (checkpoint GC included) over one study,
    and over two studies that share no trial."""
    for sizes in ([6], [3]):
        _, got = studies(T, TT, sizes)
        _, ref = studies(R, RT, sizes)
        assert got.steps_run == ref.steps_run
        assert got.ckpt_evictions == ref.ckpt_evictions
        assert got.gpu_seconds == ref.gpu_seconds
        assert got.by_study.keys() == ref.by_study.keys()
