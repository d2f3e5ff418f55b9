"""What the benchmark promises about itself: nothing of JAX or the JAX
package loads with its run path, the reference loads nothing of the port,
and ``BENCHMARK.json`` resolves to files and keeps to its names."""

import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _loaded_after(code):
    """Top-level names of the modules a fresh interpreter holds after
    ``code``."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]))
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


RUN_PATH = """
import os
from hippo_bench import calibrate, cells, check, run, trace
run.use_checkout()
import repro_torch.core.study, repro_torch.train.torch_trainer
for name in os.listdir("hippo_bench/metrics"):
    if name.endswith(".py") and name != "__init__.py":
        run.reader(name[:-3])
"""


def test_run_path_loads_no_jax():
    names = _loaded_after(RUN_PATH)
    assert not names & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in names


def test_reference_loads_nothing_of_the_port():
    names = _loaded_after(
        "import hippo_bench.reference.lm, hippo_bench.reference.attention, "
        "hippo_bench.reference.ssd, hippo_bench.reference.fp8")
    assert not names & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def _bench():
    with open(BENCH) as f:
        return json.load(f)


def test_names_and_units():
    b = _bench()
    metrics = b["end_to_end"] + b["per_layer"]
    for item in b["configs"] + b["workloads"] + metrics:
        assert NAME.match(item["name"]), item["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert len(w["why"]) <= 200 and w["chips"] == 1
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    assert "setup_s" in names


def test_every_cell_and_metric_resolves_to_its_files():
    b = _bench()
    here = os.path.join(ROOT, "hippo_bench")
    for c in b["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"]
        assert os.path.exists(os.path.join(here, "reference",
                                           cfg["block"] + ".py"))
    for w in b["workloads"]:
        for sub in (f"traffic/{w['traffic']}.json",
                    f"configs/{w['config']}.json",
                    f"limits/{w['name']}.json"):
            assert os.path.exists(os.path.join(here, sub)), sub
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(here, "metrics",
                                           m["name"] + ".py"))


def test_per_layer_cells_report_what_they_move():
    b = _bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in moved.get("workloads", cells)
    layers = {}
    for m in b["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


@pytest.mark.card
def test_a_cell_on_the_card(card):
    """One short run of the first cell at its real size (only on a card):
    the result line as the driver reads it."""
    out = subprocess.run(
        [sys.executable, "-m", "hippo_bench.run", "--workload",
         "qwen2-0.5b-f32.high_merge", "--seed", "5", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu"
    assert line["correct"], line["checks"]
