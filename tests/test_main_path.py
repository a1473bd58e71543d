"""The training entry point needs only JAX, numpy and optax, and its
compile cache lives where ``compile_cache`` says.

The machine with the GPU is guaranteed numpy, scipy, optax, chex, einops
and pytest beside JAX — not flax, orbax, ml_collections or mujoco. The
first test runs ``scripts/train.py`` in a fresh interpreter with those
four blocked from import, builds the env (from the committed model
snapshot), and traces one PPO training epoch.
"""

import os
import subprocess
import sys

import pytest

from puppax import compile_cache

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_DRIVER = r'''
import importlib.abc
import sys

BLOCKED = ("flax", "orbax", "ml_collections", "mujoco")


class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")


sys.meta_path.insert(0, Block())
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
real_jit = jax.jit


class Traced(Exception):
    pass


def jit(fn, *args, **kwargs):
    compiled = real_jit(fn, *args, **kwargs)
    if getattr(fn, "__name__", "") != "training_epoch":
        return compiled

    def trace_only(*call_args):
        jaxpr = compiled.trace(*call_args).jaxpr
        print("TRAINING EPOCH EQNS", len(jaxpr.eqns), flush=True)
        raise Traced

    return trace_only


jax.jit = jit
sys.path.insert(0, "scripts")
import train  # noqa: E402

try:
    train.main([
        "--platform", "cpu",
        "--set", "train.num_envs=4", "--set", "train.batch_size=2",
        "--set", "train.num_minibatches=2", "--set", "train.unroll_length=2",
        "--set", "train.num_evals=1", "--set", "train.episode_length=4",
        "--set", "train.num_timesteps=8",
        "--set", "train.policy_hidden_layer_sizes=[8]",
        "--set", "train.value_hidden_layer_sizes=[8]",
    ])
except Traced:
    pass
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("LOADED", loaded)
'''


def test_train_entry_needs_no_flax_orbax_mlcollections_mujoco():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)  # one CPU device, not the suite's virtual 8
    r = subprocess.run(
        [sys.executable, "-c", _DRIVER], cwd=_REPO, env=env,
        capture_output=True, text=True, timeout=600,
    )
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "TRAINING EPOCH EQNS" in r.stdout, r.stdout[-2000:]
    assert "LOADED []" in r.stdout


@pytest.mark.parametrize("env_value", [None, "", "/some/fixed/cache"])
def test_compile_cache_dir_rule(monkeypatch, env_value):
    if env_value is None:
        monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(compile_cache.ENV_VAR, env_value)
    want = env_value or os.path.join(_REPO, ".jax_cache")
    assert compile_cache.cache_dir() == want
    # the default is a fixed path inside the checkout, ignored by git
    with open(os.path.join(_REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_compile_cache_enable_sets_no_other_dir(monkeypatch):
    """With the variable set, JAX's own reading of it stands: enable()
    sets nothing. Without it, enable() points JAX at the fixed default."""
    import jax

    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    monkeypatch.setenv(compile_cache.ENV_VAR, "/env/chosen/cache")
    assert compile_cache.enable() == "/env/chosen/cache"
    assert calls == []
    monkeypatch.delenv(compile_cache.ENV_VAR)
    assert compile_cache.enable() == compile_cache.DEFAULT_DIR
    assert calls == [("jax_compilation_cache_dir", compile_cache.DEFAULT_DIR)]
