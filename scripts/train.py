#!/usr/bin/env python
"""Train a Pupper v3 joystick policy from an ExperimentConfig.

Replaces the reference's notebook-driven training (SURVEY §3.4): builds
the env (optionally with obstacle terrain), wires the DR fn, metrics
sink, checkpointing, and the mesh-sharded PPO learner from one config.

Usage:
  python scripts/train.py [--config cfg.json] [--set train.num_envs=8192] ...
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import xml.etree.ElementTree as ET

# allow running straight from a source checkout without pip install
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_override(kv: str):
    key, _, raw = kv.partition("=")
    try:
        value = json.loads(raw)
    except json.JSONDecodeError:
        value = raw
    return key, value


def main(argv=None):
    """Run training; returns (params, final metrics dict)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", default=None, help="JSON config file")
    parser.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="dotted-path override, e.g. train.num_envs=8192",
    )
    parser.add_argument("--wandb", action="store_true", help="log to wandb too")
    parser.add_argument(
        "--resume", action="store_true",
        help="resume from the latest train-state checkpoint in "
             "train.checkpoint_path (params + optimizer + normalizer)",
    )
    parser.add_argument(
        "--platform", default=None,
        help="force the jax platform (e.g. 'cpu' for a run without a GPU)",
    )
    args = parser.parse_args(argv)

    if args.platform:
        import jax as _jax

        _jax.config.update("jax_platforms", args.platform)

    from puppax import compile_cache
    from puppax.configs import experiment as exp

    compile_cache.enable()
    from puppax.parallel import maybe_initialize_distributed

    maybe_initialize_distributed()

    cfg = exp.ExperimentConfig()
    if args.config:
        with open(args.config) as f:
            cfg = exp.from_dict(json.load(f))
    if args.set:
        cfg = exp.apply_overrides(cfg, dict(parse_override(s) for s in args.set))
    print(f"config hash: {exp.config_hash(cfg)}")

    from puppax.configs import get_config
    from puppax.env import PupperV3Env, domain_randomization
    from puppax.model import assets, obstacles
    from puppax.tools.metrics import MetricsLogger, make_progress_fn
    from puppax.train import checkpoint, make_ppo_networks, ppo
    from puppax.utils import activation_fn_map

    e = cfg.env
    xml_string = None
    if e.n_obstacles > 0 or e.heightfield:
        tree = assets.pupper_xml_tree() if e.path is None else ET.parse(e.path)
        if e.n_obstacles > 0:
            tree = obstacles.add_boxes_to_model(
                tree,
                n_boxes=e.n_obstacles,
                x_range=e.obstacle_x_range,
                y_range=e.obstacle_y_range,
                height=e.obstacle_height,
                length=e.obstacle_length,
                seed=e.obstacle_seed,
            )
        if e.heightfield:
            from puppax.model import terrain

            tree = terrain.add_heightfield_to_model(
                tree,
                nrow=e.heightfield_nrow,
                ncol=e.heightfield_ncol,
                size=e.heightfield_size,
                seed=e.heightfield_seed,
            )
        xml_string = ET.tostring(tree.getroot(), encoding="unicode")

    env = PupperV3Env(
        path=e.path if xml_string is None else None,
        xml_string=xml_string,
        reward_config=get_config(),
        action_scale=e.action_scale,
        observation_history=e.observation_history,
        dof_damping=e.dof_damping,
        position_control_kp=e.position_control_kp,
        resample_velocity_step=e.resample_velocity_step,
        linear_velocity_x_range=e.linear_velocity_x_range,
        linear_velocity_y_range=e.linear_velocity_y_range,
        angular_velocity_range=e.angular_velocity_range,
        zero_command_probability=e.zero_command_probability,
        stand_still_command_threshold=e.stand_still_command_threshold,
        maximum_pitch_command=e.maximum_pitch_command,
        maximum_roll_command=e.maximum_roll_command,
        angular_velocity_noise=e.angular_velocity_noise,
        gravity_noise=e.gravity_noise,
        motor_angle_noise=e.motor_angle_noise,
        last_action_noise=e.last_action_noise,
        kick_vel=e.kick_vel,
        kick_probability=e.kick_probability,
        terminal_body_z=e.terminal_body_z,
        early_termination_step_threshold=e.early_termination_step_threshold,
        terminal_body_angle=e.terminal_body_angle,
        foot_radius=e.foot_radius,
        environment_timestep=e.environment_timestep,
        physics_timestep=e.physics_timestep,
        use_imu=e.use_imu,
        privileged_obs=e.privileged_obs,
        gait_phase_observation=e.gait_phase_observation,
        gait_frequency=e.gait_frequency,
        disturbance_curriculum=e.disturbance_curriculum,
        start_position_config=domain_randomization.StartPositionRandomization(
            x_min=e.start_position.x_min, x_max=e.start_position.x_max,
            y_min=e.start_position.y_min, y_max=e.start_position.y_max,
            z_min=e.start_position.z_min, z_max=e.start_position.z_max,
        ),
    )

    dr = cfg.domain_randomization
    randomization_fn = None
    if dr.enabled:
        randomization_fn = functools.partial(
            domain_randomization.domain_randomize,
            friction_range=dr.friction_range,
            kp_multiplier_range=dr.kp_multiplier_range,
            kd_multiplier_range=dr.kd_multiplier_range,
            body_com_x_shift_range=dr.body_com_x_shift_range,
            body_com_y_shift_range=dr.body_com_y_shift_range,
            body_com_z_shift_range=dr.body_com_z_shift_range,
            body_inertia_scale_range=dr.body_inertia_scale_range,
            body_mass_scale_range=dr.body_mass_scale_range,
        )

    import jax

    t = cfg.train
    # multi-host: only process 0 writes metrics/checkpoints (shared storage)
    is_lead = jax.process_index() == 0
    logger = MetricsLogger(
        jsonl_path=t.metrics_jsonl if is_lead else None,
        use_wandb=args.wandb and is_lead,
    )
    logger.log({"config_hash": exp.config_hash(cfg)}, step=0)
    progress = make_progress_fn(logger, plot_path=t.progress_plot)

    def policy_params_fn(step, make_policy, params):
        if t.checkpoint_path and is_lead:
            path = checkpoint.save_checkpoint(step, params, t.checkpoint_path)
            # artifact-store upload per checkpoint (reference
            # utils.py:208-211 wandb.log_model parity; JSONL sink records
            # a pointer line)
            logger.log_artifact(path, name=f"checkpoint_{step}")

    network_factory = functools.partial(
        make_ppo_networks,
        policy_hidden_layer_sizes=t.policy_hidden_layer_sizes,
        value_hidden_layer_sizes=t.value_hidden_layer_sizes,
        activation=activation_fn_map(t.activation),
        value_precision=t.value_precision,
    )

    make_policy, params, metrics = ppo.train(
        env,
        num_timesteps=t.num_timesteps,
        episode_length=t.episode_length,
        num_envs=t.num_envs,
        num_eval_envs=t.num_eval_envs,
        learning_rate=t.learning_rate,
        lr_schedule=t.lr_schedule,
        lr_final_fraction=t.lr_final_fraction,
        entropy_cost=t.entropy_cost,
        entropy_schedule=t.entropy_schedule,
        entropy_cost_final=t.entropy_cost_final,
        discounting=t.discounting,
        unroll_length=t.unroll_length,
        batch_size=t.batch_size,
        num_minibatches=t.num_minibatches,
        num_updates_per_batch=t.num_updates_per_batch,
        reward_scaling=t.reward_scaling,
        clipping_epsilon=t.clipping_epsilon,
        gae_lambda=t.gae_lambda,
        normalize_observations=t.normalize_observations,
        lazy_shuffle=t.lazy_shuffle,
        seed=t.seed,
        num_evals=t.num_evals,
        network_factory=network_factory,
        privileged_critic=t.privileged_critic,
        curriculum_steps=t.curriculum_steps,
        randomization_fn=randomization_fn,
        progress_fn=progress,
        policy_params_fn=policy_params_fn,
        checkpoint_dir=t.checkpoint_path,
        resume=args.resume,
        metrics_logger=logger,
    )
    print(json.dumps({k: v for k, v in metrics.items()}, default=float, indent=2))
    if t.checkpoint_path and is_lead:
        path = checkpoint.save_checkpoint(t.num_timesteps, params, t.checkpoint_path)
        logger.log_artifact(path, name=f"checkpoint_{t.num_timesteps}")
        print(f"final checkpoint: {path}")
    return params, metrics


if __name__ == "__main__":
    main()
