"""The PyTorch package stands alone: importing every one of its modules —
and ``chip_smoke`` as a module, without running it — in a fresh interpreter
leaves neither ``jax`` nor any module of the JAX package ``repro`` loaded,
and needs neither ``triton`` nor a GPU."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = r"""
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "repro" or m.startswith("repro."))
print("BAD", bad)
print("TRITON", "triton" in sys.modules)
"""

WALK = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + sorted(
    m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."))
for n in names:
    importlib.import_module(n)
print("MODULES", len(names))
for extra in sys.argv[1:]:
    importlib.import_module(extra)
""" + CHECK

ALONE = r"""
import importlib, sys
importlib.import_module(sys.argv[1])
""" + CHECK


def run_walk(*extra, script=WALK):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT, os.path.join(ROOT, "examples")])
    out = subprocess.run([sys.executable, "-W", "error", "-c", script,
                          *extra],
                         capture_output=True, text=True, env=env, cwd=ROOT,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lines = dict(l.split(" ", 1) for l in out.stdout.strip().splitlines())
    return lines


def test_every_module_imports_without_jax_or_the_jax_package():
    lines = run_walk()
    assert int(lines["MODULES"]) >= 30
    assert lines["BAD"] == "[]"
    assert lines["TRITON"] == "False"


@pytest.mark.parametrize("module", ["chip_smoke", "torch_hpo_resnet",
                                    "torch_hpo_lm", "torch_serve_lm",
                                    "torch_quickstart", "torch_multi_study"])
def test_entry_scripts_import_without_jax_or_the_jax_package(module):
    lines = run_walk(module)
    assert lines["BAD"] == "[]"


@pytest.mark.parametrize("module", ["repro_torch.kernels.ssd_scan",
                                    "repro_torch.models.ssm"])
def test_ssd_modules_import_alone_without_jax_or_the_jax_package(module):
    """The SSD slice's modules, each imported on its own in a fresh
    interpreter, before anything else of the package."""
    lines = run_walk(module, script=ALONE)
    assert lines["BAD"] == "[]"
    assert lines["TRITON"] == "False"


@pytest.mark.parametrize("module", ["repro_torch.core.faults",
                                    "repro_torch.core.engine.session",
                                    "repro_torch.frontdoor.snapshot_v5",
                                    "repro_torch.frontdoor.admission",
                                    "repro_torch.frontdoor.leases",
                                    "repro_torch.frontdoor.gateway",
                                    "repro_torch.launch.serve_studies",
                                    "repro_torch.dist.meshes",
                                    "repro_torch.dist.sharding",
                                    "repro_torch.train.step",
                                    "repro_torch.launch.specs",
                                    "repro_torch.launch.train",
                                    "repro_torch.launch.mesh",
                                    "repro_torch.launch.dryrun",
                                    "repro_torch.launch.hillclimb",
                                    "repro_torch.analysis.roofline",
                                    "repro_torch.analysis.report"])
def test_fault_and_session_modules_import_alone_without_jax(module):
    """The fault plane's, the session snapshots', the front door's, the
    mesh plane's, the launchers' (the dry run and the hill-climb too) and
    the analysis modules, each imported on its own in a fresh interpreter,
    before anything else of the package."""
    lines = run_walk(module, script=ALONE)
    assert lines["BAD"] == "[]"
    assert lines["TRITON"] == "False"


def test_no_source_line_imports_jax_or_the_jax_package():
    """Belt and braces for lazily imported code paths the walk cannot see."""
    import re
    pat = re.compile(r"^\s*(from|import)\s+(jax|jaxlib|repro)(\.|\s|$)")
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "examples", "torch_hpo_resnet.py"),
             os.path.join(ROOT, "examples", "torch_hpo_lm.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) > 30
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                assert not pat.match(line), f"{path}:{i}: {line.strip()}"
