"""Frozen experiment config tree: env / DR / train, JSON-overridable.

The reference had no config system beyond reward scales — everything else
was a 40-kwarg env constructor and notebook literals (SURVEY §5
'config/flag system'). This module is the framework's single config
surface: frozen dataclasses whose defaults mirror the reference defaults
exactly (/root/reference/pupperv3_mjx/environment.py:41-119 for env,
domain_randomization.py:8-23 for DR, the brax PPO invocation shape for
train), with dict/JSON round-trip, dotted-path overrides, and a stable
config hash logged for reproducibility.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class StartPositionConfig:
    x_min: float = -2.0
    x_max: float = 2.0
    y_min: float = -2.0
    y_max: float = 2.0
    z_min: float = 0.15
    z_max: float = 0.20


@dataclass(frozen=True)
class EnvConfig:
    """PupperV3Env construction defaults (environment.py:41-119)."""

    path: Optional[str] = None  # None = bundled Pupper v3 model
    action_scale: float = 0.75
    observation_history: int = 2
    dof_damping: float = 0.25
    position_control_kp: float = 5.0
    resample_velocity_step: int = 500
    linear_velocity_x_range: Tuple[float, float] = (-0.75, 0.75)
    linear_velocity_y_range: Tuple[float, float] = (-0.5, 0.5)
    angular_velocity_range: Tuple[float, float] = (-2.0, 2.0)
    zero_command_probability: float = 0.01
    stand_still_command_threshold: float = 0.1
    maximum_pitch_command: float = 0.0
    maximum_roll_command: float = 0.0
    angular_velocity_noise: float = 0.3
    gravity_noise: float = 0.1
    motor_angle_noise: float = 0.1
    last_action_noise: float = 0.01
    kick_vel: float = 0.2
    kick_probability: float = 0.02
    terminal_body_z: float = 0.1
    early_termination_step_threshold: int = 500
    terminal_body_angle: float = 0.52
    foot_radius: float = 0.02
    environment_timestep: float = 0.02
    physics_timestep: float = 0.004
    use_imu: bool = True
    # publish info["privileged_obs"] (ground-truth critic-only signals)
    privileged_obs: bool = False
    # append a free-running (cos, sin) gait clock to the policy obs
    gait_phase_observation: bool = False
    gait_frequency: float = 2.5  # Hz
    # carry info["difficulty"] scaling kick/noise amplitudes (the learner
    # ramps it when train.curriculum_steps > 0)
    disturbance_curriculum: bool = False
    start_position: StartPositionConfig = field(default_factory=StartPositionConfig)
    # obstacle terrain (obstacles.py): 0 disables
    n_obstacles: int = 0
    obstacle_seed: int = 0
    obstacle_x_range: Tuple[float, float] = (-5.0, 5.0)
    obstacle_y_range: Tuple[float, float] = (-5.0, 5.0)
    obstacle_height: float = 0.02
    obstacle_length: float = 3.0
    # heightfield rough terrain (terrain.py): False disables
    heightfield: bool = False
    heightfield_seed: int = 0
    heightfield_nrow: int = 32
    heightfield_ncol: int = 32
    # mujoco hfield size: (radius_x, radius_y, elevation_z, base_z)
    heightfield_size: Tuple[float, float, float, float] = (4.0, 4.0, 0.04, 0.01)


@dataclass(frozen=True)
class DomainRandomizationConfig:
    """domain_randomize ranges (domain_randomization.py:8-23)."""

    enabled: bool = True
    friction_range: Tuple[float, float] = (0.6, 1.4)
    kp_multiplier_range: Tuple[float, float] = (0.75, 1.25)
    kd_multiplier_range: Tuple[float, float] = (0.5, 2.0)
    body_com_x_shift_range: Tuple[float, float] = (-0.03, 0.03)
    body_com_y_shift_range: Tuple[float, float] = (-0.01, 0.01)
    body_com_z_shift_range: Tuple[float, float] = (-0.02, 0.02)
    body_inertia_scale_range: Tuple[float, float] = (0.7, 1.3)
    body_mass_scale_range: Tuple[float, float] = (0.7, 1.3)


@dataclass(frozen=True)
class TrainConfig:
    """PPO hyperparameters (the brax ppo.train invocation surface)."""

    num_timesteps: int = 500_000_000
    episode_length: int = 1000
    num_envs: int = 4096
    num_eval_envs: int = 128
    learning_rate: float = 3e-4
    lr_schedule: str = "constant"  # constant | cosine | linear
    lr_final_fraction: float = 0.0
    entropy_cost: float = 1e-2
    entropy_schedule: str = "constant"  # constant | linear
    entropy_cost_final: float = 0.0
    discounting: float = 0.97
    unroll_length: int = 20
    batch_size: int = 256
    num_minibatches: int = 32
    num_updates_per_batch: int = 4
    reward_scaling: float = 1.0
    clipping_epsilon: float = 0.3
    gae_lambda: float = 0.95
    normalize_observations: bool = True
    # asymmetric actor-critic: value net sees obs + env privileged_obs
    # (requires env.privileged_obs=true; policy/export ABI unchanged)
    privileged_critic: bool = False
    # ramp disturbances (kick/noise) 0 -> 1 over this many env steps
    # (requires env.disturbance_curriculum=true; 0 = off)
    curriculum_steps: int = 0
    seed: int = 0
    num_evals: int = 10
    activation: str = "elu"  # must be in utils.activation_fn_map (export ABI)
    policy_hidden_layer_sizes: Tuple[int, ...] = (128, 128, 128, 128)
    value_hidden_layer_sizes: Tuple[int, ...] = (256, 256, 256, 256, 256)
    # matmul precision of the VALUE network's dots (highest|high|default;
    # on a GPU 'high'/'default' allow TF32). The policy stays pinned to
    # HIGHEST (deployment-ABI parity); the value net has no such
    # constraint and dominates the learner's FLOPs, so 'high'/'default' trade value-estimate precision
    # for SGD throughput (measure eval quality before adopting).
    value_precision: str = "highest"
    # Gather each SGD minibatch lazily inside the update scan instead of
    # materializing the full shuffled batch tensor (bit-identical
    # training trajectory; a learner-throughput lever — see
    # docs/TRAINING.md "Profiling the learner").
    lazy_shuffle: bool = False
    checkpoint_path: Optional[str] = None
    metrics_jsonl: Optional[str] = None
    # live training-curve errorbar plot (reference utils.py:97-112); headless
    # equivalent: re-rendered PNG at this path on every eval epoch
    progress_plot: Optional[str] = None


@dataclass(frozen=True)
class ExperimentConfig:
    env: EnvConfig = field(default_factory=EnvConfig)
    domain_randomization: DomainRandomizationConfig = field(
        default_factory=DomainRandomizationConfig
    )
    train: TrainConfig = field(default_factory=TrainConfig)


def to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def config_hash(cfg) -> str:
    """Stable short hash of the full config (logged for reproducibility)."""
    blob = json.dumps(to_dict(cfg), sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def _build(cls, data: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        value = data[f.name]
        if dataclasses.is_dataclass(f.type) or (
            isinstance(f.type, str)
            and f.type in _NESTED  # postponed annotations: resolve by name
        ):
            sub_cls = f.type if dataclasses.is_dataclass(f.type) else _NESTED[f.type]
            kwargs[f.name] = _build(sub_cls, value)
        elif isinstance(value, list):
            kwargs[f.name] = tuple(value)
        else:
            kwargs[f.name] = value
    return cls(**kwargs)


_NESTED = {
    "EnvConfig": EnvConfig,
    "DomainRandomizationConfig": DomainRandomizationConfig,
    "TrainConfig": TrainConfig,
    "StartPositionConfig": StartPositionConfig,
}


def from_dict(data: dict) -> ExperimentConfig:
    return _build(ExperimentConfig, data)


def apply_overrides(cfg: ExperimentConfig, overrides: dict) -> ExperimentConfig:
    """Apply dotted-path overrides, e.g. {'train.num_envs': 8192}."""
    data = to_dict(cfg)
    for path, value in overrides.items():
        node = data
        parts = path.split(".")
        for p in parts[:-1]:
            node = node[p]
        if parts[-1] not in node:
            raise KeyError(f"unknown config key: {path}")
        node[parts[-1]] = value
    return from_dict(data)
