"""The yardstick's arithmetic against hand counts at the shapes of
PERF.md's kernel table."""


import pytest
import torch

from hippo_bench import cells, flops
from hippo_bench.reference.lm import flat


def test_b2_to_b4_at_qwen2_shape():
    work = flops.attention_work(4, 1024, 14, 2, 64)
    pairs = 1024 * 1025 // 2
    assert work["B2"][0] == 4 * 4 * 14 * 64 * pairs
    assert work["B2"][0] == pytest.approx(7.52e9, rel=1e-3)
    assert work["B3"][0] == 1.5 * work["B2"][0]       # 11.29 GFLOP
    assert work["B4"][0] == 2.0 * work["B2"][0]       # 15.05 GFLOP
    # bf16 q, k, v and out read / written once, the f32 lse once
    assert work["B2"][1] == 2 * 2 * 4 * 1024 * 16 * 64 + 4 * 4 * 14 * 1024


def test_b5_b6_at_mamba2_shape():
    work = flops.ssd_work(1, 16, 128, 80, 64, 128)
    assert work["B5"][1] == pytest.approx(44.3e6, rel=1e-2)
    assert work["B6"][1] == pytest.approx(67.6e6, rel=1e-2)
    assert work["B5"][0] == pytest.approx(1.43e9, rel=1e-2)
    assert work["B6"][0] == pytest.approx(2.93e9, rel=1e-2)
    assert flops.bound_s(*work["B5"]) == work["B5"][1] / flops.HBM_BYTES_PER_S


def _port_leaves(name):
    from repro_torch.models.transformer import LM
    cfg = cells.load_config(name)
    with torch.device("meta"):
        tree = LM(cells.port_config(cfg)).init(torch.Generator())
    return cfg, flat(tree)


def test_b1_bytes_of_qwen2_tree():
    cfg, leaves = _port_leaves("qwen2-0.5b")
    n = sum(v.numel() for v in leaves.values())
    assert n == 494_032_768
    per = flops.update_bytes([(v.numel(), v.element_size())
                              for v in leaves.values()])
    assert per == 14 * n
    assert per == pytest.approx(6.92e9, rel=1e-3)


@pytest.mark.parametrize("name", ["qwen2-0.5b", "mamba2-2.7b"])
def test_matrix_params_are_the_trees_matrices(name):
    """Every leaf of two or more per-layer dimensions is a matrix a token
    multiplies (the embedding once, as the tied head)."""
    cfg, leaves = _port_leaves(name)
    mats = sum(v.numel() for p, v in leaves.items()
               if v.dim() - (p[0] == "cycles") >= 2
               and not str(p[-1]).startswith(("conv_", "b")))
    assert flops.matrix_params(cfg) == mats


def test_train_flops_qwen2_step():
    cfg = cells.load_config("qwen2-0.5b")
    tokens = cfg["batch"] * cfg["seq_len"]
    attn = 3 * tokens * 24 * 4 * 896 * cfg["seq_len"] / 2
    want = 6 * tokens * flops.matrix_params(cfg) + attn
    assert flops.train_flops(cfg, cfg["batch"], cfg["seq_len"]) == \
        pytest.approx(want)
    assert flops.eval_flops(cfg, 2, 4096) * 3 == pytest.approx(want)
