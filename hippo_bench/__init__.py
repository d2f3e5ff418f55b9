"""The benchmark of the PyTorch / CUDA port (``repro_torch``): rounds of
multi-study SHA searches through ``StudyService`` on one card, held
against a plain float32 reference.

    python3 -m hippo_bench.run --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

A cell resolves by name to ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``limits/<cell>.json``; each per-layer
metric to ``metrics/<name>.py``.  The cells, metrics and bounds are in
``BENCHMARK.json`` at the root of the repository; ``PERF.md`` says why.
Tests (CPU): ``python -m pytest hippo_bench/tests``.
"""
