"""``correct`` comes out false when the timed path is broken underneath
(each fault a cell can have on one card), and under the control — the
reference in the port's place one precision below the configuration's
(TF32 products for float32, float8 for bfloat16)."""

import pytest

from hippo_bench import calibrate, check, faults, run
from hippo_bench.tests.small import SMALL_LIMITS, small_config


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", ["qwen2-0.5b-f32.high_merge",
                                  "mamba2-2.7b-f32.high_merge"])
def test_fault_is_caught(name, fault):
    out = run.run(name, 31337, 0.0, False, device="cpu",
                  cfg=small_config(name.rpartition(".")[0]),
                  limits=SMALL_LIMITS, fault=fault, log=lambda msg: None)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", ["qwen2-0.5b-f32.high_merge",
                                  "mamba2-2.7b-f32.high_merge"])
def test_control_fails(name):
    r = calibrate.reading(name, 4242, control=True, device="cpu",
                          cfg=small_config(name.rpartition(".")[0]))
    assert check.judge(r["numbers"], SMALL_LIMITS)[0], r["numbers"]
    assert not check.judge(r["control"], SMALL_LIMITS)[0], r["control"]
