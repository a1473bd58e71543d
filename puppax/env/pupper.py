"""PupperV3 joystick-locomotion environment (L4, the heart of the framework).

Behavioral parity with /root/reference/pupperv3_mjx/environment.py — the
50 Hz joystick-tracking quadruped env: command sampling, action/IMU latency
buffers, random kicks, observation noise, the 18-term reward, termination,
command resampling, and the full State.info state machine (environment.py:
321-334). The RNG split order inside reset/step/_get_obs is kept identical
call-for-call (SURVEY §7 hard-parts #2) so seed-0 trajectories reproduce.

The physics model is a function argument on the hot path (``step(state,
action, model=...)``) so domain randomization can vmap batched model leaves
over the env axis without retracing (the reference achieved this with
brax's DomainRandomizationVmapWrapper).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from puppax import utils
from puppax.env import domain_randomization, rewards
from puppax.env.base import Env, State
from puppax.model.mjcf import CompiledModel, RobotModel, load_model
from puppax.ops import math
from puppax.physics import pipeline
from puppax.physics.pipeline import PhysicsState


def body_names_to_body_ids(mj_model, body_names: List[str]) -> np.ndarray:
    """Resolve body names to ids (reference environment.py:17-20)."""
    return np.array([mj_model.body(name).id for name in body_names])


def body_name_to_geom_ids(mj_model, body_name: str) -> np.ndarray:
    """All geom ids attached to a body (reference environment.py:23-25)."""
    body = mj_model.body(body_name)
    return body.geomadr + np.arange(np.squeeze(body.geomnum))


def body_names_to_geom_ids(mj_model, body_names: List[str]) -> np.ndarray:
    arrays = [body_name_to_geom_ids(mj_model, name) for name in body_names]
    return np.concatenate(arrays) if arrays else np.zeros(0, dtype=int)


class PupperV3Env(Env):
    """Pupper v3 quadruped joystick policy training environment."""

    def __init__(
        self,
        path: Optional[str],
        reward_config: Dict,
        action_scale: float,
        observation_history: int,
        joint_lower_limits: List = [
            -1.220, -0.420, -2.790, -2.510, -3.140, -0.710,
            -1.220, -0.420, -2.790, -2.510, -3.140, -0.710,
        ],
        joint_upper_limits: List = [
            2.510, 3.140, 0.710, 1.220, 0.420, 2.790,
            2.510, 3.140, 0.710, 1.220, 0.420, 2.790,
        ],
        dof_damping: float = 0.25,
        position_control_kp: float = 5.0,
        start_position_config: domain_randomization.StartPositionRandomization = (
            domain_randomization.StartPositionRandomization(
                x_min=-2.0, x_max=2.0, y_min=-2.0, y_max=2.0, z_min=0.15, z_max=0.20
            )
        ),
        foot_site_names: List[str] = [
            "leg_front_r_3_foot_site",
            "leg_front_l_3_foot_site",
            "leg_back_r_3_foot_site",
            "leg_back_l_3_foot_site",
        ],
        torso_name: str = "base_link",
        upper_leg_body_names: List[str] = [
            "leg_front_r_2", "leg_front_l_2", "leg_back_r_2", "leg_back_l_2",
        ],
        lower_leg_body_names: List[str] = [
            "leg_front_r_3", "leg_front_l_3", "leg_back_r_3", "leg_back_l_3",
        ],
        resample_velocity_step: int = 500,
        linear_velocity_x_range: Tuple[float, float] = (-0.75, 0.75),
        linear_velocity_y_range: Tuple[float, float] = (-0.5, 0.5),
        angular_velocity_range: Tuple[float, float] = (-2.0, 2.0),
        zero_command_probability: float = 0.01,
        stand_still_command_threshold: float = 0.1,
        maximum_pitch_command: float = 0.0,  # degrees
        maximum_roll_command: float = 0.0,  # degrees
        default_pose: jax.Array = None,
        desired_abduction_angles: jax.Array = None,
        angular_velocity_noise: float = 0.3,
        gravity_noise: float = 0.1,
        motor_angle_noise: float = 0.1,
        last_action_noise: float = 0.01,
        kick_vel: float = 0.2,
        kick_probability: float = 0.02,
        terminal_body_z: float = 0.1,
        early_termination_step_threshold: int = 500,
        terminal_body_angle: float = 0.52,
        foot_radius: float = 0.02,
        environment_timestep: float = 0.02,
        physics_timestep: float = 0.004,
        latency_distribution: jax.Array = None,
        imu_latency_distribution: jax.Array = None,
        desired_world_z_in_body_frame: jax.Array = None,
        use_imu: bool = True,
        privileged_obs: bool = False,
        gait_phase_observation: bool = False,
        gait_frequency: float = 2.5,  # Hz
        disturbance_curriculum: bool = False,
        xml_string: Optional[str] = None,
        dtype=jnp.float32,
    ):
        # defaults as host numpy: closed over as constants by every jitted
        # step and reset
        if default_pose is None:
            default_pose = np.array(
                [0.26, 0.0, -0.52, -0.26, 0.0, 0.52, 0.26, 0.0, -0.52, -0.26, 0.0, 0.52]
            )
        if desired_abduction_angles is None:
            desired_abduction_angles = np.array([0.0, 0.0, 0.0, 0.0])
        if latency_distribution is None:
            latency_distribution = np.array([0.2, 0.8])
        if imu_latency_distribution is None:
            imu_latency_distribution = np.array([0.5, 0.5])
        if desired_world_z_in_body_frame is None:
            desired_world_z_in_body_frame = np.array([0.0, 0.0, 1.0])

        compiled: CompiledModel = load_model(path, dtype=dtype, xml_string=xml_string)
        self.mj_model = compiled.mj_model
        model = compiled.robot.tree_replace({"opt.timestep": physics_timestep})
        # actuator override for a smoother policy: PD with kp/kd
        # (reference environment.py:170-174); model leaves stay host numpy
        gainprm = np.array(model.actuator_gainprm)
        gainprm[:, 0] = position_control_kp
        biasprm = np.array(model.actuator_biasprm)
        biasprm[:, 1] = -position_control_kp
        biasprm[:, 2] = -dof_damping
        model = model.replace(
            actuator_gainprm=gainprm, actuator_biasprm=biasprm
        )
        self._dt = environment_timestep  # 50 Hz control
        self._n_substeps = int(environment_timestep / physics_timestep)

        # init pose: home keyframe with joints at default_pose
        # (reference environment.py:176-177,192)
        init_q = np.array(model.key_qpos)
        init_q[7:] = np.asarray(default_pose, dtype)
        model = model.replace(key_qpos=init_q)
        self.model = model

        self._reward_config = reward_config
        self._torso_geom_ids = body_name_to_geom_ids(self.mj_model, torso_name)
        self._torso_idx = self.mj_model.body(torso_name).id
        # ctor constants stay host numpy: they are closed over by every
        # jitted step/reset as constants
        self._action_scale = np.asarray(action_scale, dtype)
        self._angular_velocity_noise = angular_velocity_noise
        self._gravity_noise = gravity_noise
        self._motor_angle_noise = motor_angle_noise
        self._last_action_noise = last_action_noise
        self._kick_vel = kick_vel
        self._init_q = init_q
        self._default_pose = np.asarray(default_pose, dtype)
        self._desired_abduction_angles = np.asarray(desired_abduction_angles, dtype)
        self.lowers = np.asarray(joint_lower_limits, dtype)
        self.uppers = np.asarray(joint_upper_limits, dtype)

        self._feet_site_id = np.array(
            [self.mj_model.site(f).id for f in foot_site_names]
        )
        self._lower_leg_body_id = body_names_to_body_ids(
            self.mj_model, lower_leg_body_names
        )
        self._upper_leg_geom_ids = body_names_to_geom_ids(
            self.mj_model, upper_leg_body_names
        )

        self._foot_radius = foot_radius
        self._nv = model.nv
        self._start_position_config = start_position_config
        self._linear_velocity_x_range = linear_velocity_x_range
        self._linear_velocity_y_range = linear_velocity_y_range
        self._angular_velocity_range = angular_velocity_range
        self._zero_command_probability = zero_command_probability
        self._stand_still_command_threshold = stand_still_command_threshold
        self._maximum_pitch_command = maximum_pitch_command
        self._maximum_roll_command = maximum_roll_command
        self._kick_probability = kick_probability
        self._resample_velocity_step = resample_velocity_step
        self.observation_dim = 36  # 33 without orientation, 36 with
        self._observation_history = observation_history
        self._early_termination_step_threshold = early_termination_step_threshold
        self._terminal_body_z = terminal_body_z
        self._terminal_body_angle = terminal_body_angle
        self._desired_world_z_in_body_frame = np.asarray(
            desired_world_z_in_body_frame, dtype
        )
        self._latency_distribution = np.asarray(latency_distribution, dtype)
        self._imu_latency_distribution = np.asarray(imu_latency_distribution, dtype)
        self._use_imu = use_imu
        self._privileged_obs = privileged_obs
        self._gait_phase_obs = gait_phase_observation
        self._gait_frequency = gait_frequency
        self._disturbance_curriculum = disturbance_curriculum
        self._dtype = dtype

    # ---- properties -----------------------------------------------------
    @property
    def dt(self) -> float:
        return self._dt

    @property
    def sys(self) -> RobotModel:
        """Reference-compatible alias for the model pytree (brax 'sys')."""
        return self.model

    @property
    def observation_size(self) -> int:
        """Policy input width: the stacked noisy-obs history, plus the
        2-dim gait clock (cos, sin) when enabled. The clock rides OUTSIDE
        the history stack (it is deterministic — stacking adds nothing)
        and outside the step core, so the reference obs contract is
        untouched when it is off."""
        n = self.observation_dim * self._observation_history
        return n + 2 if self._gait_phase_obs else n

    @property
    def action_size(self) -> int:
        return self.model.nu

    # ---- sampling helpers (RNG split order = reference) ------------------
    @property
    def privileged_obs_size(self) -> int:
        """34: true local lin/ang velocity + gravity (9), joint velocities
        (12), contact flags (4), feet air time (4), kick (2), DR leaves
        friction/kp/torso-mass (3)."""
        return 34

    def _privileged_observation(
        self,
        m: RobotModel,
        pipeline_state: PhysicsState,
        info: Dict[str, Any],
        kick: jax.Array,
    ) -> jax.Array:
        """Ground-truth critic-only observation (asymmetric actor-critic):
        un-noised, un-lagged state the on-robot policy cannot see, plus
        the per-env domain-randomization leaves. Computed OUTSIDE the
        step core — enabled envs pay a few extra XLA ops, disabled envs
        are bit-identical to the reference contract."""
        inv_rot = math.quat_inv(pipeline_state.x_rot[self._torso_idx - 1])
        lin = math.rotate(pipeline_state.xd_vel[self._torso_idx - 1], inv_rot)
        ang = math.rotate(pipeline_state.xd_ang[self._torso_idx - 1], inv_rot)
        grav = math.rotate(jnp.array([0.0, 0.0, -1.0], self._dtype), inv_rot)
        return jnp.concatenate(
            [
                lin,
                ang,
                grav,
                pipeline_state.qd[6:],
                info["last_contact"].astype(self._dtype),
                info["feet_air_time"],
                kick,
                jnp.stack(
                    [
                        m.geom_friction[0, 0],
                        m.actuator_gainprm[0, 0],
                        m.body_mass[self._torso_idx],
                    ]
                ).astype(self._dtype),
            ]
        )

    def sample_command(self, rng: jax.Array) -> jax.Array:
        """Sample a (vx, vy, wz) command; with probability
        zero_command_probability return a near-zero command
        (reference environment.py:246-272, same split order)."""
        lin_vel_x = self._linear_velocity_x_range
        lin_vel_y = self._linear_velocity_y_range
        ang_vel_yaw = self._angular_velocity_range

        rng, key1, key2, key3, key4, key5 = jax.random.split(rng, 6)
        vx = jax.random.uniform(key1, (1,), minval=lin_vel_x[0], maxval=lin_vel_x[1])
        vy = jax.random.uniform(key2, (1,), minval=lin_vel_y[0], maxval=lin_vel_y[1])
        wz = jax.random.uniform(key3, (1,), minval=ang_vel_yaw[0], maxval=ang_vel_yaw[1])
        new_cmd = jnp.array([vx[0], vy[0], wz[0]])

        zero_cmd_prob = jax.random.uniform(key4, (1,))
        noisy_near_zero = jax.random.uniform(
            key5,
            (3,),
            minval=-self._stand_still_command_threshold,
            maxval=self._stand_still_command_threshold,
        )
        return jnp.where(
            zero_cmd_prob < self._zero_command_probability, noisy_near_zero, new_cmd
        )

    def sample_body_orientation(self, rng: jax.Array) -> jax.Array:
        """Rotate the desired world-z by random pitch/roll within limits
        (reference environment.py:274-298)."""
        rng, key_pitch, key_roll = jax.random.split(rng, 3)
        pitch = (
            jax.random.uniform(key_pitch, (1,), minval=-1, maxval=1.0)
            * self._maximum_pitch_command
        )
        roll = (
            jax.random.uniform(key_roll, (1,), minval=-1, maxval=1.0)
            * self._maximum_roll_command
        )
        euler_rotation = math.euler_to_quat(jnp.array([roll[0], pitch[0], 0.0]))
        return math.rotate(self._desired_world_z_in_body_frame, euler_rotation)

    def initial_action_buffer(self) -> jax.Array:
        return jnp.zeros((12, self._latency_distribution.shape[0]), self._dtype)

    def initial_imu_buffer(self) -> jax.Array:
        """(6, depth) buffer: [wx, wy, wz, gx, gy, gz] columns, gravity -1 z."""
        buf = jnp.zeros((6, self._imu_latency_distribution.shape[0]), self._dtype)
        return buf.at[5, :].set(-1.0)

    # ---- core API ---------------------------------------------------------
    def reset(self, rng: jax.Array, model: Optional[RobotModel] = None) -> State:
        m = self.model if model is None else model
        rng, sample_command_key, sample_orientation_key, randomize_pos_key = (
            jax.random.split(rng, 4)
        )

        init_q = domain_randomization.randomize_qpos(
            self._init_q, self._start_position_config, rng=randomize_pos_key
        )
        pipeline_state = pipeline.pipeline_init(
            m, init_q, jnp.zeros(self._nv, self._dtype)
        )

        state_info = {
            "rng": rng,
            "last_act": jnp.zeros(12, self._dtype),
            "action_buffer": self.initial_action_buffer(),
            "imu_buffer": self.initial_imu_buffer(),
            "last_vel": jnp.zeros(12, self._dtype),
            "command": self.sample_command(sample_command_key),
            "last_contact": jnp.zeros(4, dtype=bool),
            "feet_air_time": jnp.zeros(4, self._dtype),
            "rewards": {
                k: jnp.zeros((), self._dtype)
                for k in self._reward_config.rewards.scales.keys()
            },
            "kick": jnp.array([0.0, 0.0], self._dtype),
            "step": jnp.zeros((), jnp.int32),
            "desired_world_z_in_body_frame": self.sample_body_orientation(
                sample_orientation_key
            ),
        }

        obs_history = jnp.zeros(
            self._observation_history * self.observation_dim, self._dtype
        )
        if self._privileged_obs:
            state_info["privileged_obs"] = self._privileged_observation(
                m, pipeline_state, state_info, state_info["kick"]
            )
        if self._disturbance_curriculum:
            # disturbance scale in [0, 1]: multiplies kick + obs noise
            # amplitudes. 1.0 by default (full disturbance, eval-faithful);
            # the learner ramps it with training progress
            # (ppo.train curriculum_steps).
            state_info["difficulty"] = jnp.ones((), self._dtype)
        obs = self._get_obs(pipeline_state, state_info, obs_history)
        if self._gait_phase_obs:
            state_info["gait_phase"] = jnp.zeros((), self._dtype)
            obs = jnp.concatenate(
                [obs, jnp.array([1.0, 0.0], self._dtype)]  # cos 0, sin 0
            )
        reward, done = jnp.zeros(2, self._dtype)
        metrics = {"total_dist": jnp.zeros((), self._dtype)}
        for k in state_info["rewards"]:
            metrics[k] = state_info["rewards"][k]
        return State(pipeline_state, obs, reward, done, metrics, state_info)

    def _draw_step_noise(self, rng: jax.Array) -> Dict[str, jax.Array]:
        """Every random draw one env step makes, hoisted ahead of the
        deterministic math. The split/draw order is bit-identical to the
        inline draws the reference interleaves through its step
        (environment.py:351-361, 457-469) and _get_obs (:498-516): all
        keys derive only from ``info["rng"]``, so drawing them up front
        leaves every stream unchanged while giving the step a pure
        noise-in/state-out core.

        Returns rng (the carried key), kick (2,), act_lat/imu_lat one-hot
        lag weights, the four obs noise vectors, and the resample
        command/orientation candidates (reference reuses cmd_rng for
        both, a pinned quirk)."""
        rng, cmd_rng, kick_noise_2, kick_bernoulli, latency_key = (
            jax.random.split(rng, 5)
        )
        kick = (
            jax.random.uniform(kick_noise_2, shape=(2,), minval=-1.0, maxval=1.0)
            * self._kick_vel
        )
        kick *= jax.random.bernoulli(
            kick_bernoulli, p=self._kick_probability, shape=(1,)
        )
        act_lat = utils.latency_onehot(latency_key, self._latency_distribution)

        # _get_obs draw block (reference environment.py:498-516 order)
        rng, ang_key, gravity_key, motor_angle_key, last_action_key, imu_key = (
            jax.random.split(rng, 6)
        )
        ang_vel_noise = (
            jax.random.uniform(ang_key, (3,), minval=-1, maxval=1)
            * self._angular_velocity_noise
        )
        gravity_noise = (
            jax.random.uniform(gravity_key, (3,), minval=-1, maxval=1)
            * self._gravity_noise
        )
        motor_ang_noise = (
            jax.random.uniform(motor_angle_key, (12,), minval=-1, maxval=1)
            * self._motor_angle_noise
        )
        last_action_noise = (
            jax.random.uniform(last_action_key, (12,), minval=-1, maxval=1)
            * self._last_action_noise
        )
        imu_lat = utils.latency_onehot(imu_key, self._imu_latency_distribution)

        return {
            "rng": rng,
            "kick": kick,
            "act_lat": act_lat,
            "ang_vel_noise": ang_vel_noise,
            "gravity_noise": gravity_noise,
            "motor_ang_noise": motor_ang_noise,
            "last_action_noise": last_action_noise,
            "imu_lat": imu_lat,
            "resample_cmd": self.sample_command(cmd_rng),
            "resample_ori": self.sample_body_orientation(cmd_rng),
        }

    # noise-bundle keys the deterministic step core consumes (everything
    # except the carried rng)
    _CORE_NOISE_KEYS = (
        "kick", "act_lat", "imu_lat", "ang_vel_noise", "gravity_noise",
        "motor_ang_noise", "last_action_noise", "resample_cmd", "resample_ori",
    )

    def _step_core(
        self,
        m: RobotModel,
        qpos: jax.Array,
        qvel: jax.Array,
        action: jax.Array,
        env_in: Dict[str, jax.Array],
        noise: Dict[str, jax.Array],
    ):
        """Deterministic single-env step core: noise in, state out.

        Everything between the RNG draws (_draw_step_noise) and the State
        assembly — kick, action latency, physics, observation, contact
        filters, termination, rewards, and the carried-field updates — as
        a pure function of explicit inputs (reference
        environment.py:348-483); batched steps vmap it.
        """
        # random kick: both occurrence and velocity are random
        # (reference environment.py:351-356)
        qvel = qvel.at[:2].set(noise["kick"] + qvel[:2])

        # action latency (reference environment.py:358-361)
        lagged_action, action_buffer = utils.apply_lagged_value(
            env_in["action_buffer"], action, noise["act_lat"]
        )

        # physics (reference environment.py:364-366)
        motor_targets = self._default_pose + lagged_action * self._action_scale
        motor_targets = jnp.clip(motor_targets, self.lowers, self.uppers)
        pipeline_state = pipeline.pipeline_step(
            m, pipeline._zeros_state(m, qpos, qvel), motor_targets,
            n_substeps=self._n_substeps,
        )

        obs_info = {
            "command": env_in["command"],
            "desired_world_z_in_body_frame": env_in["desired_z"],
            "imu_buffer": env_in["imu_buffer"],
            "last_act": env_in["last_act"],
        }
        obs = self._get_obs(
            pipeline_state, obs_info, env_in["obs_history"], noise=noise
        )
        imu_buffer = obs_info["imu_buffer"]
        joint_angles = pipeline_state.q[7:]
        joint_vel = pipeline_state.qd[6:]

        # foot contact from site z-height (reference environment.py:374-381)
        foot_pos = pipeline_state.site_xpos[self._feet_site_id]
        foot_contact_z = foot_pos[:, 2] - self._foot_radius
        contact = foot_contact_z < 1e-3
        contact_filt_mm = contact | env_in["last_contact"]
        contact_filt_cm = (foot_contact_z < 3e-2) | env_in["last_contact"]
        first_contact = (env_in["feet_air_time"] > 0) * contact_filt_mm
        feet_air_time = env_in["feet_air_time"] + self.dt

        # termination (reference environment.py:383-388)
        up = jnp.array([0.0, 0.0, 1.0], self._dtype)
        done = jnp.dot(
            math.rotate(up, pipeline_state.x_rot[self._torso_idx - 1]), up
        ) < jnp.cos(jnp.asarray(self._terminal_body_angle, self._dtype))
        done |= jnp.any(joint_angles < self.lowers)
        done |= jnp.any(joint_angles > self.uppers)
        done |= pipeline_state.x_pos[self._torso_idx - 1, 2] < self._terminal_body_z

        # rewards (reference environment.py:390-444)
        sigma = self._reward_config.rewards.tracking_sigma
        rewards_dict = {
            "tracking_lin_vel": rewards.reward_tracking_lin_vel(
                env_in["command"], pipeline_state, tracking_sigma=sigma
            ),
            "tracking_ang_vel": rewards.reward_tracking_ang_vel(
                env_in["command"], pipeline_state, tracking_sigma=sigma
            ),
            "tracking_orientation": rewards.reward_tracking_orientation(
                env_in["desired_z"],
                pipeline_state,
                tracking_sigma=sigma,
            ),
            "lin_vel_z": rewards.reward_lin_vel_z(pipeline_state),
            "ang_vel_xy": rewards.reward_ang_vel_xy(pipeline_state),
            "orientation": rewards.reward_orientation(pipeline_state),
            "torques": rewards.reward_torques(pipeline_state.qfrc_actuator),
            "joint_acceleration": rewards.reward_joint_acceleration(
                joint_vel, env_in["last_vel"], dt=self._dt
            ),
            "mechanical_work": rewards.reward_mechanical_work(
                pipeline_state.qfrc_actuator[6:], pipeline_state.qvel[6:]
            ),
            "action_rate": rewards.reward_action_rate(action, env_in["last_act"]),
            "stand_still": rewards.reward_stand_still(
                env_in["command"], joint_angles, self._default_pose, 0.1
            ),
            "stand_still_joint_velocity": rewards.reward_stand_still(
                env_in["command"],
                joint_vel,
                jnp.zeros(12, self._dtype),
                self._stand_still_command_threshold,
            ),
            "abduction_angle": rewards.reward_abduction_angle(
                joint_angles,
                desired_abduction_angles=self._desired_abduction_angles,
            ),
            "feet_air_time": rewards.reward_feet_air_time(
                feet_air_time, first_contact, env_in["command"]
            ),
            "foot_slip": rewards.reward_foot_slip(
                pipeline_state,
                contact_filt_cm,
                feet_site_id=self._feet_site_id,
                lower_leg_body_id=self._lower_leg_body_id,
            ),
            "termination": rewards.reward_termination(
                done,
                env_in["step"],
                step_threshold=self._early_termination_step_threshold,
            ),
            "knee_collision": rewards.reward_geom_collision(
                pipeline_state, self._upper_leg_geom_ids
            ),
            "body_collision": rewards.reward_geom_collision(
                pipeline_state, self._torso_geom_ids
            ),
        }
        rewards_dict = {
            k: v * self._reward_config.rewards.scales[k]
            for k, v in rewards_dict.items()
        }
        reward = jnp.clip(sum(rewards_dict.values()) * self.dt, 0.0, 10000.0)

        # carried-field updates (reference environment.py:448-455)
        feet_air_time = feet_air_time * ~contact_filt_mm
        step_count = env_in["step"] + 1

        # command + orientation resample (NOTE: the same cmd_rng feeds both,
        # preserving the reference's reuse quirk, environment.py:457-469)
        command = jnp.where(
            step_count > self._resample_velocity_step,
            noise["resample_cmd"],
            env_in["command"],
        )
        desired_z = jnp.where(
            step_count > self._resample_velocity_step,
            noise["resample_ori"],
            env_in["desired_z"],
        )

        # reset the step counter when done or past the resample horizon
        step_count = jnp.where(
            done | (step_count > self._resample_velocity_step), 0, step_count
        )

        total_dist = math.normalize(
            pipeline_state.x_pos[self._torso_idx - 1]
        )[1]

        env_out = {
            "obs": obs,
            "reward": reward,
            "done": done.astype(self._dtype),
            "action_buffer": action_buffer,
            "imu_buffer": imu_buffer,
            "command": command,
            "desired_z": desired_z,
            "feet_air_time": feet_air_time,
            "last_contact": contact,
            "step": step_count,
            "rewards": rewards_dict,
            "total_dist": total_dist,
        }
        return pipeline_state, env_out

    def step(
        self, state: State, action: jax.Array, model: Optional[RobotModel] = None
    ) -> State:
        m = self.model if model is None else model
        info = dict(state.info)

        noise = self._draw_step_noise(info["rng"])
        info["rng"] = noise["rng"]
        if self._disturbance_curriculum:
            # scale disturbance amplitudes OUTSIDE the step core: the RNG
            # streams and the latency/resample draws are untouched;
            # difficulty=1.0 is bit-identical to the un-curriculum env
            # (x * 1.0 is exact in fp)
            d = info["difficulty"]
            noise = dict(noise)
            for k in (
                "kick", "ang_vel_noise", "gravity_noise",
                "motor_ang_noise", "last_action_noise",
            ):
                noise[k] = noise[k] * d
        core_noise = {k: noise[k] for k in self._CORE_NOISE_KEYS}
        env_in = {
            "action_buffer": info["action_buffer"],
            "imu_buffer": info["imu_buffer"],
            "command": info["command"],
            "desired_z": info["desired_world_z_in_body_frame"],
            "last_act": info["last_act"],
            "last_vel": info["last_vel"],
            "feet_air_time": info["feet_air_time"],
            "last_contact": info["last_contact"],
            "step": info["step"],
            # the step core consumes the pure history stack; the gait
            # clock (when enabled) rides after it and is re-derived below
            "obs_history": state.obs[
                : self.observation_dim * self._observation_history
            ],
        }
        pipeline_state, env_out = self._step_core(
            m, state.pipeline_state.qpos, state.pipeline_state.qvel,
            action, env_in, core_noise,
        )

        # state management (reference environment.py:448-469)
        info["kick"] = noise["kick"]
        info["last_act"] = action
        info["last_vel"] = pipeline_state.qd[6:]
        info["action_buffer"] = env_out["action_buffer"]
        info["imu_buffer"] = env_out["imu_buffer"]
        info["feet_air_time"] = env_out["feet_air_time"]
        info["last_contact"] = env_out["last_contact"]
        info["rewards"] = env_out["rewards"]
        info["step"] = env_out["step"]
        info["command"] = env_out["command"]
        info["desired_world_z_in_body_frame"] = env_out["desired_z"]
        if self._privileged_obs:
            info["privileged_obs"] = self._privileged_observation(
                m, pipeline_state, info, noise["kick"]
            )

        obs = env_out["obs"]
        if self._gait_phase_obs:
            # deterministic clock, entirely outside the fused step core.
            # The bare env's clock free-runs; AutoResetWrapper restarts it
            # on the EFFECTIVE done (env termination OR episode time
            # limit, which the env can't see) so each auto-reset episode
            # observes the fresh-reset sequence — matching the deployed
            # runtime's reset_clock().
            phase = jnp.mod(
                info["gait_phase"]
                + self._dtype(2.0 * np.pi * self._gait_frequency * self._dt),
                self._dtype(2.0 * np.pi),
            )
            info["gait_phase"] = phase
            obs = jnp.concatenate([obs, jnp.cos(phase)[None], jnp.sin(phase)[None]])

        metrics = dict(state.metrics)
        metrics["total_dist"] = env_out["total_dist"]
        metrics.update(env_out["rewards"])

        return state.replace(
            pipeline_state=pipeline_state,
            obs=obs,
            reward=env_out["reward"],
            done=env_out["done"],
            metrics=metrics,
            info=info,
        )

    def _get_obs(
        self,
        pipeline_state: PhysicsState,
        state_info: Dict[str, Any],
        obs_history: jax.Array,
        noise: Optional[Dict[str, jax.Array]] = None,
    ) -> jax.Array:
        """36-dim observation, noised/lagged, stacked newest-first
        (reference environment.py:485-543, same RNG split order).

        ``noise`` carries the pre-drawn noise bundle on the step path
        (_draw_step_noise); the reset path draws inline from
        ``state_info["rng"]`` with the identical split order."""
        if self._use_imu:
            inv_torso_rot = math.quat_inv(pipeline_state.x_rot[0])
            local_body_angular_velocity = math.rotate(
                pipeline_state.xd_ang[0], inv_torso_rot
            )
        else:
            inv_torso_rot = jnp.array([1, 0, 0, 0], self._dtype)
            local_body_angular_velocity = jnp.zeros(3, self._dtype)

        # noise model after arXiv 2202.05481 (reference environment.py:498-516)
        if noise is None:
            (
                state_info["rng"],
                ang_key,
                gravity_key,
                motor_angle_key,
                last_action_key,
                imu_sample_key,
            ) = jax.random.split(state_info["rng"], 6)

            ang_vel_noise = (
                jax.random.uniform(ang_key, (3,), minval=-1, maxval=1)
                * self._angular_velocity_noise
            )
            gravity_noise = (
                jax.random.uniform(gravity_key, (3,), minval=-1, maxval=1)
                * self._gravity_noise
            )
            motor_ang_noise = (
                jax.random.uniform(motor_angle_key, (12,), minval=-1, maxval=1)
                * self._motor_angle_noise
            )
            last_action_noise = (
                jax.random.uniform(last_action_key, (12,), minval=-1, maxval=1)
                * self._last_action_noise
            )
            imu_lat = utils.latency_onehot(
                imu_sample_key, self._imu_latency_distribution
            )
        else:
            ang_vel_noise = noise["ang_vel_noise"]
            gravity_noise = noise["gravity_noise"]
            motor_ang_noise = noise["motor_ang_noise"]
            last_action_noise = noise["last_action_noise"]
            imu_lat = noise["imu_lat"]

        noised_gravity = (
            math.rotate(jnp.array([0.0, 0.0, -1.0], self._dtype), inv_torso_rot)
            + gravity_noise
        )
        noised_gravity = noised_gravity / jnp.linalg.norm(noised_gravity)
        noised_ang_vel = local_body_angular_velocity + ang_vel_noise
        noised_imu_data = jnp.concatenate([noised_ang_vel, noised_gravity])

        lagged_imu_data, state_info["imu_buffer"] = utils.apply_lagged_value(
            state_info["imu_buffer"], noised_imu_data, imu_lat
        )

        obs = jnp.concatenate(
            [
                lagged_imu_data,  # noised angular velocity and gravity (6)
                state_info["command"],  # command (3)
                state_info["desired_world_z_in_body_frame"],  # desired ori (3)
                pipeline_state.q[7:] - self._default_pose + motor_ang_noise,  # (12)
                state_info["last_act"] + last_action_noise,  # (12)
            ]
        )
        assert self.observation_dim == obs.shape[0]
        obs = jnp.clip(obs, -100.0, 100.0)
        # stack through time, newest at the front
        return jnp.roll(obs_history, obs.size).at[: obs.size].set(obs)

    def render(self, trajectory, camera: Optional[str] = None, **kwargs):
        """Host-side rendering of a pipeline-state trajectory (eval only)."""
        from puppax.tools import video

        return video.render_trajectory(
            self.mj_model, trajectory, camera=camera or "tracking_cam", **kwargs
        )
