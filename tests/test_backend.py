"""The step-path choice (puppax/backend.py)."""

import jax
import pytest

from puppax import backend


@pytest.mark.parametrize(
    "platform, expect",
    [
        ("cpu", "engine"),
        ("gpu", "engine"),
        ("rocm", ValueError),
        ("metal", ValueError),
        ("neuron", ValueError),
    ],
)
def test_step_path(platform, expect):
    if expect is ValueError:
        with pytest.raises(ValueError, match=platform):
            backend.step_path(platform)
    else:
        assert backend.step_path(platform) == expect


def test_step_path_defaults_to_the_running_backend():
    assert jax.default_backend() in backend.PLATFORMS
    assert backend.step_path() == backend.step_path(jax.default_backend())
