"""The plain reference against the port at small sizes on the CPU, and
a whole run of each cell, at small sizes, judged correct."""

import pytest
import torch

from hippo_bench import cells, run, studies
from hippo_bench.reference import lm as ref
from hippo_bench.tests.small import SMALL_LIMITS, small_config

CELLS = ["qwen2-0.5b-f32.high_merge", "mamba2-2.7b-f32.high_merge",
         "qwen2-0.5b.low_merge"]


@pytest.mark.parametrize("name", ["qwen2-0.5b", "mamba2-2.7b"])
def test_two_steps_of_two_schedules(name):
    """The port's loss, AdamW update and evaluation, two steps of two
    schedules from the same weights and rows, within float32 rounding."""
    from repro_torch.train.optimizer import apply_update, init_opt_state
    from repro_torch.train.torch_trainer import value_and_grad
    cell = cells.Cell(name + ".high_merge", 20240611, device="cpu",
                      cfg=small_config(name))
    task = cell.backend.task
    specs = [cell.mix["studies"][0][0], cell.mix["studies"][0][5]]
    model = ref.ReferenceLM(cell.cfg)
    p0 = {p: v.float() for p, v in ref.flat(cell.params).items()}
    truth, _ = ref.replay(model, p0, cell.batch, cell.eval_tokens,
                          {i: studies.schedule(s, 2) for i, s in
                           enumerate(specs)}, {0: [1, 2], 1: [1, 2]})
    evals = {"tokens": cell.eval_tokens.long()}
    for i, spec in enumerate(specs):
        params, opt = cell.params, init_opt_state("adamw", cell.params)
        for step, (lr, wd) in enumerate(studies.schedule(spec, 2)):
            batch = {"tokens": cell.batch(step).long()}
            _, grads = value_and_grad(task.loss, params, batch)
            params, opt = apply_update("adamw", params, grads, opt,
                                       {"lr": lr, "wd": wd}, step)
            with torch.no_grad():
                got = float(task.loss(params, evals)[0])
            assert got == pytest.approx(truth[(i, step + 1)], abs=2e-5)


@pytest.mark.parametrize("name", CELLS)
def test_small_run_is_correct(name):
    """A whole run on the CPU — warm-up, window, check — with the
    reference within 1e-4 nats of every sampled answer and 1e-3 of every
    first-rung leaf's norms."""
    out = run.run(name, 2 ** 40 + 7, 0.0, False, device="cpu",
                  cfg=small_config(name.rpartition(".")[0]),
                  limits=SMALL_LIMITS,
                  log=lambda msg: None)
    assert out["correct"], out["checks"]
    assert out["attempted"] == 2 and out["failed"] == 0
    assert list(out["checks"]) == list(SMALL_LIMITS)
    assert out["metrics"]["trial_steps_per_s"]["value"] > 0
