"""Test configuration: CPU backend with a virtual 8-device mesh.

Multi-chip sharding is validated on a virtual CPU mesh
(xla_force_host_platform_device_count), mirroring how the driver dry-runs
the multi-chip path; numerical physics oracle tests run f64 on CPU against
the mujoco C engine.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

# headless: mujoco's GLFW backend can block indefinitely probing for a
# display; EGL fails fast (render tests then skip cleanly)
if not os.environ.get("MUJOCO_GL") and not os.environ.get("DISPLAY"):
    os.environ["MUJOCO_GL"] = "egl"

import jax  # noqa: E402

# the tests run on the CPU backend, whatever the machine has
jax.config.update("jax_platforms", "cpu")

# persistent compilation cache: the suite's cost is dominated by XLA
# compiles of the physics step; caching makes re-runs ~5x faster
from puppax import compile_cache  # noqa: E402

compile_cache.enable()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

import pytest  # noqa: E402


@pytest.fixture(scope="module")
def x64():
    """f64 mode for oracle modules. Module-scoped ON PURPOSE: a
    session-scoped version leaks jax_enable_x64 into every later module,
    where python-float weak types then promote f32 scan carries to f64
    (scan carry TypeError in the train smoke)."""
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)
