"""Trial-equivalent steps the window delivered per step the engine ran:
what the stage tree saved (control plane: core/searchplan.py,
core/stagetree.py, core/scheduler.py, core/engine/)."""


def read(run):
    ran = sum(r.stats.steps_run for r in run.rounds)
    return sum(r.trial_steps for r in run.rounds) / ran if ran else None
