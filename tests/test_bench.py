"""Unit tests for bench.py's ledger/baseline logic (no accelerator).

The bench is the driver-facing perf record; its regression baseline has
twice produced artifacts (cross-backend r3, cross-batch r4), so the
keying rules are pinned here.
"""

import importlib.util
import json
import os
import sys


def _load_bench(tmp_path, ledger_lines):
    ledger = tmp_path / "benchmarks" / "ledger.jsonl"
    os.makedirs(ledger.parent, exist_ok=True)
    with open(ledger, "w") as f:
        for rec in ledger_lines:
            f.write(json.dumps(rec) + "\n")
    spec = importlib.util.spec_from_file_location(
        "bench_under_test",
        os.path.join(os.path.dirname(os.path.dirname(__file__)), "bench.py"),
    )
    mod = importlib.util.module_from_spec(spec)
    # import executes the jax import only; no device work
    sys.modules["bench_under_test"] = mod
    spec.loader.exec_module(mod)
    mod.LEDGER = str(ledger)
    return mod


LEDGER = [
    {"config": "flat", "value": 100.0, "num_envs": 4096, "backend": "gpu"},
    {"config": "flat", "value": 600.0, "num_envs": 16384, "backend": "gpu"},
    {"config": "flat", "value": 5.0, "num_envs": 4096, "backend": "cpu"},
    {"config": "dr", "value": 50.0, "num_envs": 4096, "backend": "gpu"},
]


def test_prior_best_keys_on_config_backend_and_batch(tmp_path):
    bench = _load_bench(tmp_path, LEDGER)
    # batch-matched: a @4096 run must never be scored against @16384
    assert bench.prior_best("flat", "gpu", 4096) == 100.0
    assert bench.prior_best("flat", "gpu", 16384) == 600.0
    # backend-matched
    assert bench.prior_best("flat", "cpu", 4096) == 5.0
    # unseen combos -> 0.0 (vs_baseline falls back to 1.0)
    assert bench.prior_best("flat", "gpu", 8192) == 0.0
    assert bench.prior_best("obstacles", "gpu", 4096) == 0.0
    assert bench.prior_best("dr", "gpu", 4096) == 50.0


def test_run_matrix_covers_baseline_operating_points(tmp_path):
    bench = _load_bench(tmp_path, LEDGER)
    matrix = set(bench.RUN_MATRIX)
    # BASELINE.md headline batch + the BASELINE-native 4096 point
    assert ("flat", 16384) in matrix
    assert ("flat", 4096) in matrix
    # BASELINE config 3 (domain randomization) at both operating points
    assert ("dr", 4096) in matrix and ("dr", 16384) in matrix
    # every collision-class terrain
    for cfg in ("obstacles", "hfield", "capsule"):
        assert (cfg, 4096) in matrix
