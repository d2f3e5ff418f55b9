"""Host time of the synchronous slice of a checkpoint put, per put, over
the window (checkpoint plane: train/checkpoint.py)."""


def read(run):
    saves = sum(r.stats.ckpt_saves for r in run.rounds)
    if not saves:
        return None
    return 1e3 * sum(r.stats.ckpt_save_seconds for r in run.rounds) / saves
