"""Whether the timed rounds' answers are right.

The outputs judged are the port's own: the evaluation loss every trial
reported at every rung, and each study's best trial, from the window's
last round at the timed sizes.  A sample drawn from the seed — one study
of that round, every trial of it that reached the last rung, and one more
of its trials — is replayed by the plain reference from the same weights
and tokens, along the schedules the mix gives (so a step that used
another learning rate, a wrong loss, gradient or update, a wrong
evaluation, or a resumed stage that did not start from what its rung
saved all move an answer).  The numbers compared:

* ``eval_loss_gap``: the largest |port − reference| of the sampled
  evaluation losses (nats);
* ``best_gap``: how far, by the reference's losses, the port's best trial
  lies behind the best of the study's finalists (0 when they agree);
* ``update_gap`` and ``grad_rms_gap``: at the first rung, for each sampled
  schedule prefix, the state the port's trainer handed back against the
  reference's, by the worst leaf — the gap between the two norms of the
  parameters' change, and of the root of AdamW's second moment (the
  gradients as the optimizer took them in), over the reference's norm of
  that leaf or of the median leaf, whichever is larger.  Leaves whose
  gradient is nought to rounding in the reference (under a thousandth of
  the median leaf's, as a key's bias is under softmax) are left out.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, List, Tuple

import torch

from hippo_bench import cells, studies, weights
from hippo_bench.reference import lm as ref


def sample(rounds, mix, seed: int):
    """``(study index, {trial index: reported steps})`` of the answers
    the reference replays, from the last round."""
    last = rounds[-1]
    s = weights.derive(seed, "sample-study") % len(last.tuners)
    tuner, trials = last.tuners[s], last.trials[s]
    steps: Dict[int, List[int]] = {}
    for i, t in enumerate(trials):
        done = sorted(st for (tid, st) in tuner.history if tid == t.trial_id)
        if done:
            steps[i] = done
    top = mix["tuner"]["max_steps"]
    finalists = [i for i, st in steps.items() if top in st]
    others = sorted(set(steps) - set(finalists))
    chosen = set(finalists)
    if others:
        chosen.add(others[weights.derive(seed, "sample-trial") % len(others)])
    best = best_answer(tuner, trials)
    if best is not None:
        chosen.add(best[0])
    return s, {i: steps[i] for i in sorted(chosen)}


def best_answer(tuner, trials):
    """``(trial index, step)`` at which the tuner's best score was told."""
    if tuner.best is None:
        return None
    for i, t in enumerate(trials):
        if t.trial_id != tuner.best.trial_id:
            continue
        for (tid, st), m in sorted(tuner.history.items()):
            if tid == t.trial_id and m["val_acc"] == tuner.best_score:
                return i, st
    return None


def reference_run(model, cell, s: int, picks: Dict[int, List[int]],
                  store=lambda tree: tree):
    """The reference's evaluation loss of every sampled answer, and its
    first-rung states' norms by schedule prefix."""
    specs = cell.mix["studies"][s]
    schedules = {i: studies.schedule(specs[i], max(st))
                 for i, st in picks.items()}
    losses, states = ref.replay(
        model, cell.params_ref, lambda step: cell.batch(step),
        cell.eval_tokens, schedules, picks,
        look_at=cell.mix["tuner"]["min_steps"], store=store)
    return losses, {cells.key_of(k): v for k, v in states.items()}


def leaf_gaps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Each leaf's |got − want| over max(want, median want)."""
    return (got - want).abs() / torch.maximum(want, want.median())


def compare(answers: Dict[Tuple[int, int], float],
            truth: Dict[Tuple[int, int], float], best, top: int,
            states: Dict[tuple, Dict[str, torch.Tensor]],
            ref_states: Dict[tuple, Dict[str, torch.Tensor]]
            ) -> Dict[str, float]:
    """The numbers compared, from the judged side's ``answers`` and first-
    rung ``states`` and the reference's ``truth`` and ``ref_states``
    (answers ``{(trial index, step): loss}``)."""
    gap = max(abs(answers[k] - truth[k]) for k in truth)
    final = [k for k in truth if k[1] == top]
    if best is None or best not in truth:
        best_gap = float("inf")
    else:
        best_gap = max(0.0, truth[best] - min(truth[k] for k in final))
    out = {"eval_loss_gap": gap, "best_gap": best_gap,
           "update_gap": float("inf"), "grad_rms_gap": float("inf")}
    if ref_states and all(k in states for k in ref_states):
        for name in ("update", "grad_rms"):
            worst = 0.0
            for k, want in ref_states.items():
                rms = want["grad_rms"]
                keep = rms >= 1e-3 * rms.median()
                gaps = leaf_gaps(states[k][name].to(rms.device), want[name])
                worst = max(worst, float(gaps[keep].max()))
            out[name + "_gap"] = worst
    return out


def port_answers(rounds, s: int, picks) -> Dict[Tuple[int, int], float]:
    tuner, trials = rounds[-1].tuners[s], rounds[-1].trials[s]
    return {(i, st): tuner.history[(trials[i].trial_id, st)]["loss"]
            for i, steps in picks.items() for st in steps}


def judge(numbers: Dict[str, float], limits: Dict[str, Any]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """``(correct, {name: {"value", "limit"}})``: correct when every
    number is at or under its limit (a missing limit fails).  A number
    its cell's limits file marks ``"compared": false`` (no reading of the
    control or of a fault separates from the port's) is shown, not
    judged."""
    shown, ok = {}, True
    for name, value in numbers.items():
        entry = limits.get(name, {})
        if entry.get("compared") is False:
            shown[name] = {"value": value, "limit": "not compared"}
            continue
        limit = entry.get("limit")
        shown[name] = {"value": value, "limit": limit}
        ok = ok and limit is not None and value <= limit
    return ok, shown


def run_check(cell, rounds, control: bool = False) -> Dict[str, Any]:
    """Sample, replay with the reference, compare.  ``cell.params_ref``
    holds the float32 copy of the drawn weights, flat by path.  Returns
    the numbers and what they were read from; with ``control``, also the
    control's numbers (the configuration's ``control`` module of
    :mod:`hippo_bench.reference` in the port's place: ``fp8`` below
    bfloat16, ``tf32`` below float32)."""
    ref.precise()
    s, picks = sample(rounds, cell.mix, cell.seed)
    top = cell.mix["tuner"]["max_steps"]
    truth, ref_states = reference_run(ref.ReferenceLM(cell.cfg), cell, s,
                                      picks)
    tuner, trials = rounds[-1].tuners[s], rounds[-1].trials[s]
    out = {"study": s, "answers": len(truth), "states": len(ref_states),
           "numbers": compare(port_answers(rounds, s, picks), truth,
                              best_answer(tuner, trials), top,
                              rounds[-1].rung_states, ref_states)}
    if control:
        low = importlib.import_module(
            f"hippo_bench.reference.{cell.cfg['control']}")
        got, states = reference_run(ref.ReferenceLM(cell.cfg, low.matmul),
                                    cell, s, picks, store=low.store)
        best = min((k for k in got if k[1] == top), key=got.get)
        out["control"] = compare(got, truth, best, top, states, ref_states)
    return out
