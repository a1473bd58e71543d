from setuptools import find_packages, setup

setup(
    name="puppax",
    version="0.1.0",
    description=(
        "JAX quadruped locomotion RL framework: pure-JAX MuJoCo-"
        "semantics physics, batched Pupper v3 joystick env, mesh-sharded PPO"
    ),
    packages=find_packages(include=["puppax", "puppax.*"]),
    package_data={"puppax.model": ["pupper_v3.xml", "snapshots/*.npz"]},
    python_requires=">=3.10",
    install_requires=[
        "jax",
        "optax",
        "numpy",
    ],
    extras_require={
        # MJCF compilation of models without a committed snapshot,
        # rendering, and the MuJoCo C oracle tests
        "mujoco": ["mujoco"],
        "dev": ["pytest", "mujoco"],
    },
)
