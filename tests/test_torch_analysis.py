"""The port's roofline, report and hill-climb against the JAX package's:
the same table rows from the same records, the roofline terms equal once
scaled by the two hardware tables, the seven variants' rules and config
overrides, and one ``seqpar`` variant run through the DTensor sequence
constraint."""

import dataclasses
import math

import jax
import pytest
import torch
import torch.distributed as dist

assert jax.devices()

from repro.analysis import report as r_report  # noqa: E402
from repro.analysis import roofline as r_roofline  # noqa: E402
from repro.dist.sharding import ShardingRules as RRules  # noqa: E402
from repro.launch import hillclimb as r_hillclimb  # noqa: E402
from repro_torch.analysis import report, roofline  # noqa: E402
from repro_torch.dist.sharding import ShardingRules  # noqa: E402
from repro_torch.launch import dryrun, hillclimb  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def no_process_group_left():
    assert not dist.is_initialized()
    yield
    leaked = dist.is_initialized()
    if leaked:
        dist.destroy_process_group()
    assert not leaked, "a test left a process group behind"


@pytest.fixture(scope="module")
def records():
    """One production record, a reduced one, a skip and an error, single
    and multi-pod keys."""
    prod = dryrun.run_case("qwen2-0.5b", "decode_32k", verbose=False)
    red = dryrun.run_case("mamba2-2.7b", "train_4k", reduced=True,
                          device="cpu", verbose=False)
    skip = dryrun.run_case("hubert-xlarge", "long_500k", verbose=False)
    err = {"arch": "yi-34b", "shape": "train_4k", "multi_pod": True,
           "status": "error", "error": "RuntimeError('no strategy')"}
    return [prod, red, skip, err]


def body(table):
    return table.splitlines()[2:]


def test_dryrun_table_rows_equal_the_reference(records):
    got, ref = report.dryrun_table(records), r_report.dryrun_table(records)
    assert body(got) == body(ref) and len(body(got)) == 4
    assert "flops/dev" in got.splitlines()[0]
    assert "HLO" not in got.splitlines()[0]


def test_roofline_terms_equal_the_reference_scaled_by_the_hardware(records):
    scale = {"compute_s": "peak_flops", "memory_s": "hbm_bw",
             "collective_s": "link_bw"}
    for rec in records[:2]:
        for chips in (256, 512):
            got = roofline.roofline_terms(rec, chips)
            ref = r_roofline.roofline_terms(rec, chips)
            for term, hw in scale.items():
                want = ref[term] * r_roofline.HW[hw] / roofline.HW[hw]
                assert math.isclose(got[term], want, rel_tol=1e-12)
            for key in ("hlo_flops_per_device", "hlo_bytes_per_device",
                        "collective_bytes_per_device", "hlo_flops_global"):
                assert got[key] == ref[key]
            assert got["bound_step_s"] == max(got[t] for t in scale)
            assert got["dominant"] + "_s" in scale
        for tokens, kind in ((4096, "train"), (128, "decode")):
            assert roofline.model_flops(rec, tokens, kind) == \
                r_roofline.model_flops(rec, tokens, kind)
    assert roofline.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                           "link_bw": 450e9}
    # the roofline table reads the same records; its rows keep the order,
    # and its last column names the ops run replicated
    rows = body(report.roofline_table(records))
    assert len(rows) == len(body(r_report.roofline_table(records)))
    assert rows[0].startswith("| qwen2-0.5b | decode_32k |")
    assert rows[0].endswith("| argmax 1 |"), rows[0]


def test_load_keeps_the_latest_record_per_case(tmp_path, records):
    import json
    path = tmp_path / "r.jsonl"
    later = dict(records[0], lower_s=99.0)
    with open(path, "w") as f:
        for r in records + [later]:
            f.write(json.dumps(r) + "\n")
    got, ref = report.load(str(path)), r_report.load(str(path))
    assert got == ref and len(got) == 4
    assert [r["lower_s"] for r in got if r["shape"] == "decode_32k"
            and not r["reduced"]] == [99.0]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("variant", sorted(r_hillclimb.VARIANTS))
def test_hillclimb_variants_equal_the_reference(variant, multi_pod):
    assert sorted(hillclimb.VARIANTS) == sorted(r_hillclimb.VARIANTS)
    r_over, c_over = r_hillclimb.VARIANTS[variant]
    t_over, tc_over = hillclimb.VARIANTS[variant]
    assert tc_over == c_over
    ref = dataclasses.replace(RRules.for_mesh(multi_pod), **r_over)
    got = dataclasses.replace(ShardingRules.for_mesh(multi_pod), **t_over)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_seqpar_variant_runs_through_the_sequence_constraint(tmp_path,
                                                             capsys):
    """qwen2-0.5b × prefill_32k under ``seqpar``: the residual stream is
    sharded on the sequence over ``model`` after every block, which moves
    collectives the baseline does not have."""
    out = tmp_path / "h.jsonl"
    hillclimb.main(["--arch", "qwen2-0.5b", "--shape", "prefill_32k",
                    "--variant", "baseline", "seqpar", "--out", str(out)])
    lines = capsys.readouterr().out
    assert "[seqpar]: compute" in lines and "dominant=" in lines
    import json
    with open(out) as f:
        base, seq = [json.loads(line) for line in f]
    assert base["status"] == seq["status"] == "ok"
    assert seq["variant"] == seq["tag"] == "seqpar"
    assert seq["rules"]["seq"] == "model" and base["rules"]["seq"] is None
    assert set(seq["roofline"]) >= {"compute_s", "memory_s",
                                    "collective_s", "dominant"}
    assert seq["collectives"]["counts"] != base["collectives"]["counts"]
    # K and V gathered over the sequence: every op ran on its own shards
    assert "replicated" not in seq and "replicated" not in base
