"""The simulator examples of the PyTorch package against the JAX
package's: ``examples/torch_quickstart.py`` and
``examples/torch_multi_study.py`` print the same GPU-hours, end-to-end
hours, steps trained, merge rates and per-study lines as
``examples/quickstart.py`` and ``examples/multi_study.py`` — at the JAX
examples' own sizes and at reduced ones (the JAX examples' sizes are
constants there, so the reduced runs set them on the imported modules;
nothing of the JAX package is edited).  Text, not numbers: the lines must
be equal character for character."""

import contextlib
import importlib
import io
import os

import pytest

from repro.core import StudyService as RefStudyService

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def examples(monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(ROOT, "examples"))
    monkeypatch.syspath_prepend(ROOT)
    return importlib.import_module


def printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("steps,workers", [(200, 8), (60, 3)],
                         ids=["published", "reduced"])
def test_quickstart_prints_the_jax_examples_numbers(examples, monkeypatch,
                                                    steps, workers):
    ref, port = examples("quickstart"), examples("torch_quickstart")
    if (steps, workers) != (200, 8):
        space_cls = ref.GridSearchSpace

        class Space(space_cls):
            def trials(self, _n):
                return super().trials(steps)

        monkeypatch.setattr(ref, "GridSearchSpace", Space)
        monkeypatch.setattr(ref, "StudyService", lambda *a, **kw: (
            RefStudyService(*a, **{**kw, "n_workers": workers})))
    want = printed(ref.main)
    got = printed(port.main, ["--steps", str(steps), "--workers",
                              str(workers)])
    assert got == want
    assert len(got) == 3 and "steps trained" in got[-1]


@pytest.mark.parametrize("studies,steps,workers,gap", [
    (4, 160, 40, 3600.0), (2, 90, 12, 1800.0)],
    ids=["published", "reduced"])
def test_multi_study_prints_the_jax_examples_numbers(examples, monkeypatch,
                                                     studies, steps, workers,
                                                     gap):
    ref, port = examples("multi_study"), examples("torch_multi_study")
    monkeypatch.setattr(ref, "S", studies)
    monkeypatch.setattr(ref, "STEPS", steps)
    monkeypatch.setattr(ref, "ARRIVAL_GAP", gap)
    monkeypatch.setattr(ref, "StudyService", lambda *a, **kw: (
        RefStudyService(*a, **{**kw, "n_workers": workers})))
    want = printed(ref.main)
    got = printed(port.main, ["--studies", str(studies), "--steps",
                              str(steps), "--workers", str(workers),
                              "--arrival-gap", str(gap)])
    assert got == want
    assert any("GPU-h" in line for line in got)
    assert sum(line.startswith("  study-") for line in got) == studies


def test_the_ports_space_is_the_benchmarks_space(examples):
    """The port's copy of ``resnet20_space_high_merge`` gives the JAX
    package's trials, schedule for schedule."""
    spaces, port = examples("benchmarks.spaces"), examples(
        "torch_multi_study")
    for seed in range(3):
        want = spaces.resnet20_space_high_merge(seed=seed).trials(160)
        got = port.resnet20_space_high_merge(seed=seed).trials(160)
        assert [t.trial_id for t in got] == [t.trial_id for t in want]


def test_lm_study_example_runs_recurrentgemma_reduced_on_the_cpu(examples):
    """``examples/torch_hpo_lm.py --arch recurrentgemma-2b --device cpu
    --layers 5``: the reduced model at one (RG-LRU, RG-LRU, local) cycle
    plus the two trailing RG-LRU layers, stage-based against
    trial-based — fewer steps, the same best trial, every reported metric
    bit-equal."""
    example = examples("torch_hpo_lm")
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        results = example.main(["--arch", "recurrentgemma-2b", "--device",
                                "cpu", "--layers", "5"])
    lines = buf.getvalue().splitlines()
    (s_stats, s_best, s_hist) = results["stage"]
    (t_stats, t_best, t_hist) = results["trial"]
    assert s_stats.steps_run == 16 and t_stats.steps_run == 32
    assert s_best == t_best and s_hist == t_hist
    assert s_stats.kernel_fallbacks == 0
    assert lines[-1].endswith("every reported metric bit-equal: True")
