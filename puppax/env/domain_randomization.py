"""Domain randomization: per-env model randomization + start-pose sampling.

Behavioral parity with /root/reference/pupperv3_mjx/domain_randomization.py:
``domain_randomize`` draws, per env (vmapped over rng keys):
  - one friction scalar broadcast to every geom's slide friction (:29-30)
  - one kp multiplier rewriting actuator gainprm[:,0] / biasprm[:,1] and one
    kd multiplier rewriting biasprm[:,2] (:32-50)
  - a torso COM shift on body_ipos[1] (:52-67)
  - per-body-per-axis inertia scales (:71-78) and per-body mass scales (:80-87)
and returns ``(batched model, in_axes-pytree)`` — the same randomization_fn
protocol the reference's brax PPO consumed (:93-112), here consumed by
puppax.env.wrappers.BatchedEnv / the PPO learner. The RNG call sequence is
kept identical for seed-parity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp

from puppax.model.mjcf import RobotModel


def domain_randomize(
    model: RobotModel,
    rng: jax.Array,
    friction_range: Tuple = (0.6, 1.4),
    kp_multiplier_range: Tuple = (0.75, 1.25),
    kd_multiplier_range: Tuple = (0.5, 2.0),
    body_com_x_shift_range: Tuple = (-0.03, 0.03),
    body_com_y_shift_range: Tuple = (-0.01, 0.01),
    body_com_z_shift_range: Tuple = (-0.02, 0.02),
    body_inertia_scale_range: Tuple = (0.7, 1.3),
    body_mass_scale_range: Tuple = (0.7, 1.3),
):
    """Randomize friction / actuator gains / COM / inertia / mass per env.

    Args:
      model: the (unbatched) RobotModel.
      rng: (num_envs, 2) batch of PRNG keys — one per environment.

    Returns:
      (batched model, in_axes pytree): the six randomized leaves carry a
      leading env axis; in_axes marks them 0 and everything else None.
    """

    @jax.vmap
    def rand(rng):
        # model leaves are host numpy (mjcf.put_model.arr) — lift the ones
        # edited with .at[] to jnp inside the trace (free: becomes a
        # jaxpr constant, no device round-trip)
        geom_friction0 = jnp.asarray(model.geom_friction)
        gainprm0 = jnp.asarray(model.actuator_gainprm)
        biasprm0 = jnp.asarray(model.actuator_biasprm)
        body_ipos0 = jnp.asarray(model.body_ipos)
        rng, key = jax.random.split(rng, 2)
        friction_val = jax.random.uniform(
            key, (1,), minval=friction_range[0], maxval=friction_range[1]
        )
        # ONE scalar broadcast to every geom's slide friction
        geom_friction = geom_friction0.at[:, 0].set(friction_val)

        rng, key_kp, key_kd = jax.random.split(rng, 3)
        kp = (
            jax.random.uniform(
                key_kp, (1,), minval=kp_multiplier_range[0], maxval=kp_multiplier_range[1]
            )
            * model.actuator_gainprm[:, 0]
        )
        kd = jax.random.uniform(
            key_kd, (1,), minval=kd_multiplier_range[0], maxval=kd_multiplier_range[1]
        ) * (-model.actuator_biasprm[:, 2])
        gain = gainprm0.at[:, 0].set(kp)
        bias = biasprm0.at[:, 1].set(-kp).at[:, 2].set(-kd)

        rng, key_com = jax.random.split(rng)
        com_shift = jax.random.uniform(
            key_com,
            (3,),
            minval=jnp.array(
                [
                    body_com_x_shift_range[0],
                    body_com_y_shift_range[0],
                    body_com_z_shift_range[0],
                ]
            ),
            maxval=jnp.array(
                [
                    body_com_x_shift_range[1],
                    body_com_y_shift_range[1],
                    body_com_z_shift_range[1],
                ]
            ),
        )
        body_ipos = body_ipos0.at[1].set(body_ipos0[1] + com_shift)

        rng, key_inertia = jax.random.split(rng)
        inertia_scale = jax.random.uniform(
            key_inertia,
            model.body_inertia.shape,
            minval=body_inertia_scale_range[0],
            maxval=body_inertia_scale_range[1],
        )
        body_inertia = model.body_inertia * inertia_scale

        rng, key_mass = jax.random.split(rng)
        mass_scale = jax.random.uniform(
            key_mass,
            model.body_mass.shape,
            minval=body_mass_scale_range[0],
            maxval=body_mass_scale_range[1],
        )
        body_mass = model.body_mass * mass_scale

        return geom_friction, gain, bias, body_ipos, body_inertia, body_mass

    friction, gain, bias, body_ipos, body_inertia, body_mass = rand(rng)

    in_axes = jax.tree_util.tree_map(lambda x: None, model)
    in_axes = in_axes.replace(
        geom_friction=0,
        actuator_gainprm=0,
        actuator_biasprm=0,
        body_ipos=0,
        body_inertia=0,
        body_mass=0,
    )
    batched = model.replace(
        geom_friction=friction,
        actuator_gainprm=gain,
        actuator_biasprm=bias,
        body_ipos=body_ipos,
        body_inertia=body_inertia,
        body_mass=body_mass,
    )
    return batched, in_axes


@dataclass
class StartPositionRandomization:
    """Uniform start-position box (reference domain_randomization.py:115-123)."""

    x_min: float
    x_max: float
    y_min: float
    y_max: float
    z_min: float
    z_max: float


def small_quaternion(rng, max_angle_deg=30, max_yaw_deg=180):
    """Random quaternion with bounded pitch/roll and yaw (reference
    domain_randomization.py:125-177; defined for API parity)."""
    rng, key_pitch, key_roll, key_yaw = jax.random.split(rng, 4)
    pitch = (jax.random.uniform(key_pitch, ()) * 2 - 1) * max_angle_deg * jnp.pi / 180.0
    roll = (jax.random.uniform(key_roll, ()) * 2 - 1) * max_angle_deg * jnp.pi / 180.0
    yaw = (jax.random.uniform(key_yaw, ()) * 2 - 1) * max_yaw_deg * jnp.pi / 180.0
    cr, sr = jnp.cos(roll / 2), jnp.sin(roll / 2)
    cp, sp = jnp.cos(pitch / 2), jnp.sin(pitch / 2)
    cy, sy = jnp.cos(yaw / 2), jnp.sin(yaw / 2)
    q = jnp.array(
        [
            cr * cp * cy + sr * sp * sy,
            sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy,
            cr * cp * sy - sr * sp * cy,
        ]
    )
    return q / jnp.linalg.norm(q)


def random_z_rotation_quaternion(rng) -> jax.Array:
    """Uniform-yaw quaternion (reference domain_randomization.py:180-185)."""
    yaw = jax.random.uniform(rng, (1,), minval=-jnp.pi, maxval=jnp.pi)
    return jnp.concatenate([jnp.cos(yaw / 2), jnp.zeros(2), jnp.sin(yaw / 2)])


def randomize_qpos(
    qpos: jax.Array, start_position_config: StartPositionRandomization, rng
) -> jax.Array:
    """Randomize free-joint xyz within the box + uniform yaw (reference
    domain_randomization.py:188-210; same split order for seed-parity)."""
    rng, key_pos, key_yaw = jax.random.split(rng, 3)
    qpos = jnp.asarray(qpos)  # host-numpy init_q -> traced constant
    qpos = qpos.at[:3].set(
        jax.random.uniform(
            key_pos,
            shape=(3,),
            minval=jnp.array(
                (
                    start_position_config.x_min,
                    start_position_config.y_min,
                    start_position_config.z_min,
                )
            ),
            maxval=jnp.array(
                (
                    start_position_config.x_max,
                    start_position_config.y_max,
                    start_position_config.z_max,
                )
            ),
        )
    )
    return qpos.at[3:7].set(random_z_rotation_quaternion(key_yaw))
