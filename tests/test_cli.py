"""CLI regression tests: scripts/train.py and scripts/export_policy.py
driven as subprocesses — the user-facing surfaces that unit tests miss
(both broke during development in ways the library tests couldn't see:
sys.path bootstrap, obstacle-config plumbing)."""

import json
import os
import subprocess
import sys

import pytest

from puppax import compile_cache

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# share the suite's persistent XLA compilation cache with the subprocess:
# a cold train-step compile alone is ~6 min on CPU, which made the
# end-to-end test flaky against its timeout under any machine load
_ENV = dict(
    os.environ,
    JAX_PLATFORMS="cpu",
    JAX_COMPILATION_CACHE_DIR=compile_cache.cache_dir(),
    JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="1.0",
)


def _run(args, timeout=2100):
    return subprocess.run(
        [sys.executable] + args,
        cwd=_REPO,
        env=_ENV,
        capture_output=True,
        text=True,
        timeout=timeout,
    )


def test_train_cli_rejects_unknown_key():
    r = _run(["scripts/train.py", "--set", "train.not_a_key=1"], timeout=120)
    assert r.returncode != 0
    assert "unknown config key" in (r.stdout + r.stderr)


@pytest.mark.slow
def test_train_and_export_cli_end_to_end(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    metrics = str(tmp_path / "m.jsonl")
    r = _run(
        [
            "scripts/train.py",
            "--platform", "cpu",
            "--set", "train.num_timesteps=64",
            "--set", "train.num_envs=8",
            "--set", "train.episode_length=8",
            "--set", "train.unroll_length=4",
            "--set", "train.batch_size=4",
            "--set", "train.num_minibatches=2",
            "--set", "train.num_updates_per_batch=1",
            "--set", "train.num_evals=1",
            "--set", "train.num_eval_envs=4",
            "--set", "env.n_obstacles=2",
            "--set", f"train.checkpoint_path={ckpt}",
            "--set", f"train.metrics_jsonl={metrics}",
            "--set", 'train.policy_hidden_layer_sizes=[16,16]',
            "--set", 'train.value_hidden_layer_sizes=[16,16]',
        ]
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "config hash:" in r.stdout
    assert os.path.isdir(os.path.join(ckpt, "64"))
    assert os.path.isdir(os.path.join(ckpt, "state", "64"))
    assert os.path.exists(metrics)

    out_json = str(tmp_path / "policy.json")
    r2 = _run(
        ["scripts/export_policy.py", "--checkpoint", ckpt, "--out", out_json],
        timeout=300,
    )
    assert r2.returncode == 0, r2.stdout[-2000:] + r2.stderr[-2000:]
    exported = json.load(open(out_json))
    assert exported["in_shape"] == [None, 72]
    assert exported["layers"][-1]["shape"] == [None, 12]
