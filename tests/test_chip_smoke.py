"""chip_smoke.py's checks, and its phases on CPU devices standing in for
cards (the card itself is only reached by running the script on a GPU)."""

import importlib.util
import os

import jax
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small(smoke, monkeypatch):
    """A few envs and steps, no nvidia-smi."""
    monkeypatch.setattr(smoke, "N_ENVS", 8)
    monkeypatch.setattr(smoke, "N_STEPS", 3)
    monkeypatch.setattr(smoke, "card_line", lambda: "cpu stand-in")
    return smoke


def _fields(n_env=6, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "qpos": rng.normal(size=(n_env, 19)),
        "qvel": rng.normal(size=(n_env, 18)) * 5,
        "obs": rng.normal(size=(n_env, 72)),
        "reward": rng.normal(size=(n_env,)) * 0.05,
    }


@pytest.mark.parametrize("field", ["qpos", "qvel", "obs", "reward"])
def test_check_close_holds_each_field_to_its_tolerance(smoke, field):
    ref = _fields()
    inside = {k: v.copy() for k, v in ref.items()}
    inside[field][2] += 0.5 * smoke.ATOL[field]
    smoke.check_close("inside", inside, ref)

    outside = {k: v.copy() for k, v in ref.items()}
    flat = outside[field].reshape(len(outside[field]), -1)
    flat[3, 0] += 2 * (smoke.ATOL[field] + smoke.RTOL * abs(flat[3, 0]))
    with pytest.raises(smoke.PhaseError, match="1 of 6 envs outside"):
        smoke.check_close("outside", outside, ref)


def test_check_close_rejects_shape_and_nonfinite(smoke):
    ref = _fields()
    bad = dict(ref, obs=ref["obs"][:, :10])
    with pytest.raises(smoke.PhaseError, match="shape"):
        smoke.check_close("shape", bad, ref)
    nan = dict(ref, qvel=ref["qvel"].copy())
    nan["qvel"][0, 0] = np.nan
    with pytest.raises(smoke.PhaseError, match="non-finite"):
        smoke.check_close("nan", nan, ref)


def test_tf32_rounding_control_is_caught(smoke):
    ref = _fields()
    rounded = {k: np.asarray(smoke.round_to_tf32(v.astype(np.float32)))
               for k, v in ref.items()}
    # 10 mantissa bits: relative error up to 2^-11, far above RTOL
    rel = np.abs(rounded["qpos"] - ref["qpos"]) / np.abs(ref["qpos"])
    assert 10 * smoke.RTOL < rel.max() <= 2.0 ** -11 * 1.01
    assert "6 of 6" in smoke.check_rejects("tf32", rounded, ref)
    with pytest.raises(smoke.PhaseError, match="too loose"):
        smoke.check_rejects("same", ref, ref)


@pytest.mark.parametrize(
    "n_gpu, n_ref, ok",
    [(0, 0, True), (10, 0, True), (11, 0, False), (130, 60, True), (131, 60, False)],
)
def test_check_like_reference_limit(smoke, n_gpu, n_ref, ok):
    if ok:
        smoke.check_like_reference(n_gpu, n_ref, 1000)
    else:
        with pytest.raises(smoke.PhaseError, match="limit"):
            smoke.check_like_reference(n_gpu, n_ref, 1000)


def test_main_without_a_gpu_fails(smoke, capsys):
    assert jax.default_backend() == "cpu"
    assert smoke.main([]) == 1
    out, err = capsys.readouterr()
    assert "no GPU" in err and '"ok"' not in out


def test_step_phase_runs_on_cpu(small, monkeypatch, capsys):
    """The whole step phase with the host CPU in the card's place: the two
    sides then agree exactly and the TF32 control is still rejected."""
    small.phase_step()
    out = capsys.readouterr().out
    assert "step path on gpu: engine" in out
    assert "worst env at 0.000 of its tolerance" in out
    assert "rejected: 8 of 8 envs outside tolerance" in out
    assert "0 of 16 env-steps outside tolerance on the gpu" in out


def test_four_card_steps_on_cpu_devices(small, capsys):
    """The sharded-vs-one-device comparison on 4 virtual CPU devices."""
    assert len(jax.devices()) >= 4
    small.phase_four_steps()
    out = capsys.readouterr().out
    assert "sharded vs one card, step 1" in out
    assert "after 3 steps" in out
