"""Physics pipeline: init / step over the RobotModel pytree.

Replacement for the brax mjx pipeline the reference env calls
(``self.pipeline_init`` /root/reference/pupperv3_mjx/environment.py:319 and
``self.pipeline_step`` /root/reference/pupperv3_mjx/environment.py:366).

``pipeline_step`` runs ``n_substeps`` forward+integrate passes (the
reference runs 5: env dt 0.02 / physics dt 0.004, environment.py:166,179).
Matching MJX/MuJoCo step semantics, the returned state carries
post-integration qpos/qvel while every position/velocity-derived cache
(x, xd, site_xpos, contacts, qfrc_actuator) is from the final forward pass
— i.e. lags integration by one substep, exactly like mjx.step's Data.

The whole step is one jit region of small dense batched linear algebra;
``jax.vmap`` over the leading env axis turns it into (B, ...) kernels;
sharding the env axis over a mesh spreads it across devices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from puppax import struct

from puppax.model.mjcf import RobotModel
from puppax.ops import linalg
from puppax.physics import collision, constraint, integrate, smooth, solver


@struct.dataclass
class PhysicsState:
    """Per-env physics state pytree (the env layer's 'pipeline state').

    Field surface mirrors what the reference env/rewards consume from the
    brax mjx pipeline state (SURVEY §1 L2): q/qd aliases, x (per-link world
    transforms, world body dropped => torso at index torso_idx-1), xd
    (per-link world-frame velocities), site_xpos, xpos (with world row),
    qfrc_actuator, and the contact set (geom1/geom2/dist).
    """

    qpos: jnp.ndarray  # (nq,)
    qvel: jnp.ndarray  # (nv,)
    qacc: jnp.ndarray  # (nv,)
    x_pos: jnp.ndarray  # (nbody-1, 3) link positions (world dropped)
    x_rot: jnp.ndarray  # (nbody-1, 4) link quaternions
    xd_vel: jnp.ndarray  # (nbody-1, 3) link linear velocity (world frame)
    xd_ang: jnp.ndarray  # (nbody-1, 3) link angular velocity (world frame)
    xpos: jnp.ndarray  # (nbody, 3) body positions incl. world row
    site_xpos: jnp.ndarray  # (nsite, 3)
    qfrc_actuator: jnp.ndarray  # (nv,)
    contact: collision.Contacts

    # --- reference-compatible aliases (brax State field names) ---
    @property
    def q(self) -> jnp.ndarray:
        return self.qpos

    @property
    def qd(self) -> jnp.ndarray:
        return self.qvel


def forward(m: RobotModel, qpos: jnp.ndarray, qvel: jnp.ndarray, ctrl):
    """One full forward-dynamics pass; returns (qacc, caches).

    The whole pass runs under matmul precision 'highest': reduced-precision
    products (bf16 or TF32 operands) corrupt the mass matrix / constraint
    Jacobians enough to NaN the Newton solve within a few env steps (MJX
    documents the same requirement).
    """
    with jax.default_matmul_precision("highest"):
        kin = smooth.kinematics(m, qpos)
        com = smooth.com_pos(m, kin)
        vel = smooth.com_vel(m, com, qvel)
        qM = smooth.crb(m, com)
        qfrc_bias = smooth.rne(m, com, vel, qvel)
        qfrc_passive = smooth.passive(m, qvel)
        qfrc_actuator = smooth.actuation(m, qpos, qvel, ctrl)
        qfrc_smooth = qfrc_passive + qfrc_actuator - qfrc_bias

        # unrolled small-SPD solve for these tiny systems (ops/linalg)
        qacc_smooth = linalg.spd_solve(qM, qfrc_smooth)

        contacts = collision.collide(m, kin)
        efc = constraint.make_efc(m, com, qpos, qvel, contacts)
        res = solver.solve(m, qM, qacc_smooth, efc)
        return res.qacc, (kin, com, vel, contacts, qfrc_actuator)


def _make_state(m, qpos, qvel, qacc, caches) -> PhysicsState:
    kin, com, vel, contacts, qfrc_actuator = caches
    # world-frame per-link velocities from com-referenced spatial velocities:
    # v_origin = cvel_lin + cvel_ang x (xpos - subtree_com[root])
    from puppax.ops.select import take_rows

    offset = kin.xpos - take_rows(com.subtree_com, m.body_rootid)
    ang = vel.cvel[:, :3]
    lin = vel.cvel[:, 3:] + jnp.cross(ang, offset)
    # reporting surface: the full uncapped per-pair contact set (MuJoCo C
    # semantics, matching the independent oracle replay); the solver used
    # the capped `contacts` internally (MJX dynamics semantics)
    del contacts
    report = collision.collide_pairs(m, kin)
    return PhysicsState(
        qpos=qpos,
        qvel=qvel,
        qacc=qacc,
        x_pos=kin.xpos[1:],
        x_rot=kin.xquat[1:],
        xd_vel=lin[1:],
        xd_ang=ang[1:],
        xpos=kin.xpos,
        site_xpos=kin.site_xpos,
        qfrc_actuator=qfrc_actuator,
        contact=report,
    )


def pipeline_init(m: RobotModel, qpos: jnp.ndarray, qvel: jnp.ndarray) -> PhysicsState:
    """Initialize state with a forward pass (mjx.forward semantics)."""
    ctrl = jnp.zeros(m.nu, qpos.dtype)
    qacc, caches = forward(m, qpos, qvel, ctrl)
    return _make_state(m, qpos, qvel, qacc, caches)


def pipeline_step(
    m: RobotModel, state: PhysicsState, ctrl: jnp.ndarray, n_substeps: int = 5
) -> PhysicsState:
    """Advance n_substeps physics steps under constant ctrl (one env step).

    The substep loop is a ``lax.scan`` so the (large) forward-dynamics body
    is traced/compiled once regardless of substep count; XLA still fuses
    within each body and the env-batch axis carries the parallelism.
    """

    def substep(carry, _):
        qpos, qvel = carry
        qacc, caches = forward(m, qpos, qvel, ctrl)
        qpos_new, qvel_new = integrate.euler(m, qpos, qvel, qacc)
        return (qpos_new, qvel_new), (qacc, caches)

    (qpos, qvel), (qaccs, caches) = jax.lax.scan(
        substep, (state.qpos, state.qvel), (), length=n_substeps
    )
    # keep the caches of the LAST substep (mjx.step semantics: kinematic
    # caches lag integration by one substep)
    last = jax.tree_util.tree_map(lambda x: x[-1], (qaccs, caches))
    qacc, caches = last
    return _make_state(m, qpos, qvel, qacc, caches)


def _zeros_state(m: RobotModel, qpos, qvel) -> PhysicsState:
    """Minimal PhysicsState carrier for ``pipeline_step``, which reads only
    qpos/qvel."""
    z = jnp.zeros
    dt = qpos.dtype
    return PhysicsState(
        qpos=qpos, qvel=qvel, qacc=z(m.nv, dt),
        x_pos=z((m.nbody - 1, 3), dt), x_rot=z((m.nbody - 1, 4), dt),
        xd_vel=z((m.nbody - 1, 3), dt), xd_ang=z((m.nbody - 1, 3), dt),
        xpos=z((m.nbody, 3), dt), site_xpos=z((m.nsite, 3), dt),
        qfrc_actuator=z(m.nv, dt), contact=None,
    )
