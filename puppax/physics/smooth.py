"""Smooth (unconstrained) dynamics: FK, COM frames, CRB, RNE, actuation.

MuJoCo-semantics forward dynamics stages as pure functions of the
RobotModel pytree. The body tree is processed **level by level** (a cached
static schedule): all bodies at the same depth — e.g. the four legs' hip /
upper / lower links — are advanced with one batched quaternion/spatial op
per level instead of per-body unrolled ops. This cuts the op count ~4x,
which is what determines both XLA compile time and the per-fusion dispatch
cost that dominates tiny-model physics; the env batch axis is added by
``jax.vmap`` on top and carries the parallelism.

Stage-for-stage these reproduce (independently, from the published MuJoCo
computation model) mj_kinematics, mj_comPos, mj_comVel, mj_crb, mj_rne and
mj_fwdActuation, which the reference consumed through mjx.forward/mjx.step
(/root/reference/pupperv3_mjx/environment.py:319,366). Validated against
the mujoco C oracle in tests/test_physics_oracle.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from puppax.model.mjcf import JNT_FREE, JNT_HINGE, RobotModel
from puppax.ops import math
from puppax.ops.select import add_rows, set_rows, take_rows


class Kinematics(NamedTuple):
    xpos: jnp.ndarray  # (nbody, 3) body frame origins, world frame
    xquat: jnp.ndarray  # (nbody, 4)
    xipos: jnp.ndarray  # (nbody, 3) body COM positions
    ximat: jnp.ndarray  # (nbody, 3, 3) inertial frame orientations
    xanchor: jnp.ndarray  # (njnt, 3) joint anchors, world frame
    xaxis: jnp.ndarray  # (njnt, 3) joint axes, world frame
    site_xpos: jnp.ndarray  # (nsite, 3)
    geom_xpos: jnp.ndarray  # (ngeom, 3)
    geom_xmat: jnp.ndarray  # (ngeom, 3, 3)


class ComQuantities(NamedTuple):
    subtree_com: jnp.ndarray  # (nbody, 3)
    cinert: jnp.ndarray  # (nbody, 6, 6) spatial inertia about root-subtree com
    cdof: jnp.ndarray  # (nv, 6) dof motion axes about root-subtree com


class Velocity(NamedTuple):
    cvel: jnp.ndarray  # (nbody, 6) spatial velocities [ang; lin]
    cdof_dot: jnp.ndarray  # (nv, 6)


class _Level(NamedTuple):
    kind: str  # 'free' | 'hinge' | 'fixed'
    bodies: tuple
    parents: tuple
    jnts: tuple  # joint ids (empty for 'fixed')


@functools.lru_cache(maxsize=None)
def _schedule(nbody, njnt, body_parentid, body_jntid, jnt_type):
    """Static level schedule: bodies grouped by tree depth and joint kind."""
    depth = [0] * nbody
    for i in range(1, nbody):
        depth[i] = depth[body_parentid[i]] + 1
    levels = []
    for d in range(1, max(depth) + 1 if nbody > 1 else 1):
        bodies = [i for i in range(1, nbody) if depth[i] == d]
        groups = {"free": [], "hinge": [], "fixed": []}
        for i in bodies:
            j = body_jntid[i]
            if j == -1:
                groups["fixed"].append(i)
            elif jnt_type[j] == JNT_FREE:
                groups["free"].append(i)
            elif jnt_type[j] == JNT_HINGE:
                groups["hinge"].append(i)
            else:  # pragma: no cover - guarded at model build
                raise NotImplementedError(jnt_type[j])
        for kind in ("free", "hinge", "fixed"):
            if groups[kind]:
                bs = groups[kind]
                levels.append(
                    _Level(
                        kind=kind,
                        bodies=tuple(bs),
                        parents=tuple(body_parentid[i] for i in bs),
                        jnts=tuple(body_jntid[i] for i in bs),
                    )
                )
    return tuple(levels)


def _levels(m: RobotModel):
    return _schedule(m.nbody, m.njnt, m.body_parentid, m.body_jntid, m.jnt_type)


# batched quaternion helpers (leading axis = bodies-in-level)
_rot = jax.vmap(math.rotate)
_qmul = jax.vmap(math.quat_mul)
_qmat = jax.vmap(math.quat_to_mat)


def kinematics(m: RobotModel, qpos: jnp.ndarray) -> Kinematics:
    """Forward kinematics, level-scheduled over the fixed body tree."""
    dtype = qpos.dtype
    xpos = jnp.zeros((m.nbody, 3), dtype)
    xquat = jnp.zeros((m.nbody, 4), dtype).at[0, 0].set(1.0)
    xanchor = jnp.zeros((m.njnt, 3), dtype)
    xaxis = jnp.zeros((m.njnt, 3), dtype)

    for lv in _levels(m):
        if lv.kind == "free":
            for body, j in zip(lv.bodies, lv.jnts):
                qadr = m.jnt_qposadr[j]
                pos = qpos[qadr : qadr + 3]
                quat = qpos[qadr + 3 : qadr + 7]
                quat = quat / jnp.linalg.norm(quat)
                xpos = set_rows(xpos, (body,), pos[None])
                xquat = set_rows(xquat, (body,), quat[None])
                xanchor = set_rows(xanchor, (j,), pos[None])
                # free axis unrotated
                xaxis = set_rows(xaxis, (j,), m.jnt_axis[j][None])
            continue
        pq = take_rows(xquat, lv.parents)
        frame_pos = take_rows(xpos, lv.parents) + _rot(
            take_rows(m.body_pos, lv.bodies), pq
        )
        frame_quat = _qmul(pq, take_rows(m.body_quat, lv.bodies))
        if lv.kind == "fixed":
            xpos = set_rows(xpos, lv.bodies, frame_pos)
            xquat = set_rows(xquat, lv.bodies, frame_quat)
            continue
        # hinge group
        qadr = tuple(m.jnt_qposadr[j] for j in lv.jnts)
        angle = take_rows(qpos, qadr) - take_rows(m.qpos0, qadr)
        axis = take_rows(m.jnt_axis, lv.jnts)
        jpos = take_rows(m.jnt_pos, lv.jnts)
        half = 0.5 * angle
        qloc = jnp.concatenate(
            [jnp.cos(half)[:, None], axis * jnp.sin(half)[:, None]], axis=1
        )
        quat = _qmul(frame_quat, qloc)
        anchor = frame_pos + _rot(jpos, frame_quat)
        pos = anchor - _rot(jpos, quat)
        xpos = set_rows(xpos, lv.bodies, pos)
        xquat = set_rows(xquat, lv.bodies, quat)
        xanchor = set_rows(xanchor, lv.jnts, anchor)
        xaxis = set_rows(xaxis, lv.jnts, _rot(axis, quat))

    # inertial / site / geom frames: one batched op each
    xipos = xpos + _rot(m.body_ipos, xquat)
    ximat = _qmat(_qmul(xquat, m.body_iquat))
    if m.nsite:
        site_xpos = take_rows(xpos, m.site_bodyid) + _rot(
            m.site_pos, take_rows(xquat, m.site_bodyid)
        )
    else:
        site_xpos = jnp.zeros((0, 3), dtype)
    gq = take_rows(xquat, m.geom_bodyid)
    geom_xpos = take_rows(xpos, m.geom_bodyid) + _rot(m.geom_pos, gq)
    geom_xmat = _qmat(_qmul(gq, m.geom_quat))
    return Kinematics(
        xpos=xpos,
        xquat=xquat,
        xipos=xipos,
        ximat=ximat,
        xanchor=xanchor,
        xaxis=xaxis,
        site_xpos=site_xpos,
        geom_xpos=geom_xpos,
        geom_xmat=geom_xmat,
    )


def com_pos(m: RobotModel, kin: Kinematics) -> ComQuantities:
    """Subtree COMs, com-frame spatial inertias and dof axes (mj_comPos)."""
    dtype = kin.xpos.dtype
    # subtree mass/moment via reverse level-wise scatter-add
    subtree_mass = m.body_mass
    subtree_mom = m.body_mass[:, None] * kin.xipos
    for lv in reversed(_levels(m)):
        subtree_mass = add_rows(
            subtree_mass, lv.parents, take_rows(subtree_mass, lv.bodies)
        )
        subtree_mom = add_rows(
            subtree_mom, lv.parents, take_rows(subtree_mom, lv.bodies)
        )
    subtree_com = subtree_mom / jnp.maximum(subtree_mass, 1e-12)[:, None]

    # spatial inertia of each body about its kinematic-tree-root com
    offset = kin.xipos - take_rows(subtree_com, m.body_rootid)
    cinert = math.transform_inertia_batch(
        m.body_mass, m.body_inertia, offset, kin.ximat
    )

    # dof axes about the root com
    cdof = jnp.zeros((m.nv, 6), dtype)
    hinge_j = [j for j in range(m.njnt) if m.jnt_type[j] == JNT_HINGE]
    if hinge_j:
        dadr = tuple(m.jnt_dofadr[j] for j in hinge_j)
        roots = tuple(m.body_rootid[m.jnt_bodyid[j]] for j in hinge_j)
        com_r = take_rows(subtree_com, roots)
        ax = take_rows(kin.xaxis, hinge_j)
        off = com_r - take_rows(kin.xanchor, hinge_j)
        cdof = set_rows(
            cdof, dadr, jnp.concatenate([ax, jnp.cross(ax, off)], axis=1)
        )
    for j in range(m.njnt):
        if m.jnt_type[j] != JNT_FREE:
            continue
        b = m.jnt_bodyid[j]
        d = m.jnt_dofadr[j]
        com_r = subtree_com[m.body_rootid[b]]
        eye3 = jnp.eye(3, dtype=dtype)
        cdof = cdof.at[d : d + 3].set(
            jnp.concatenate([jnp.zeros((3, 3), dtype), eye3], axis=1)
        )
        R = math.quat_to_mat(kin.xquat[b])  # columns = body axes in world
        axes = R.T  # rows
        off = com_r - kin.xanchor[j]
        cdof = cdof.at[d + 3 : d + 6].set(
            jnp.concatenate(
                [axes, jnp.cross(axes, off[None, :])], axis=1
            )
        )
    return ComQuantities(subtree_com=subtree_com, cinert=cinert, cdof=cdof)


def com_vel(m: RobotModel, com: ComQuantities, qvel: jnp.ndarray) -> Velocity:
    """Body spatial velocities and dof-axis derivatives (mj_comVel),
    level-scheduled."""
    dtype = qvel.dtype
    cvel = jnp.zeros((m.nbody, 6), dtype)
    cdof_dot = jnp.zeros((m.nv, 6), dtype)
    for lv in _levels(m):
        v_parent = take_rows(cvel, lv.parents)
        if lv.kind == "fixed":
            cvel = set_rows(cvel, lv.bodies, v_parent)
            continue
        if lv.kind == "hinge":
            dadr = tuple(m.jnt_dofadr[j] for j in lv.jnts)
            cd = take_rows(com.cdof, dadr)  # (k, 6)
            cdd = jax.vmap(math.motion_cross)(v_parent, cd)
            cdof_dot = set_rows(cdof_dot, dadr, cdd)
            cvel = set_rows(
                cvel, lv.bodies, v_parent + cd * take_rows(qvel, dadr)[:, None]
            )
            continue
        # free joints (one body at a time; usually exactly one)
        for body, j in zip(lv.bodies, lv.jnts):
            d = m.jnt_dofadr[j]
            v = cvel[m.body_parentid[body]]
            v_trans = v + com.cdof[d : d + 3].T @ qvel[d : d + 3]
            cdd = jax.vmap(math.motion_cross, in_axes=(None, 0))(
                v_trans, com.cdof[d + 3 : d + 6]
            )
            cdof_dot = cdof_dot.at[d + 3 : d + 6].set(cdd)
            v_full = v_trans + com.cdof[d + 3 : d + 6].T @ qvel[d + 3 : d + 6]
            cvel = set_rows(cvel, (body,), v_full[None])
    return Velocity(cvel=cvel, cdof_dot=cdof_dot)


@functools.lru_cache(maxsize=None)
def _crb_masks(nbody, nv, body_parentid, body_jntid, jnt_type, jnt_dofadr,
               jnt_bodyid, njnt):
    """Static CRB fill masks: per-dof body index and lower-triangular
    ancestor-pair mask anc[j, k] = 1 iff dof k is an ancestor-or-self dof
    of dof j's body and k <= j."""
    body_dofs = [[] for _ in range(nbody)]
    dof_body = np.zeros(nv, dtype=np.int32)
    for j in range(njnt):
        b = jnt_bodyid[j]
        d = jnt_dofadr[j]
        n = 6 if jnt_type[j] == JNT_FREE else 1
        for dd in range(d, d + n):
            body_dofs[b].append(dd)
            dof_body[dd] = b
    chains = [[] for _ in range(nbody)]
    for i in range(1, nbody):
        chains[i] = chains[body_parentid[i]] + body_dofs[i]
    anc = np.zeros((nv, nv), dtype=np.float32)
    for jd in range(nv):
        for kd in chains[dof_body[jd]]:
            if kd <= jd:
                anc[jd, kd] = 1.0
    return dof_body, anc


def crb(m: RobotModel, com: ComQuantities) -> jnp.ndarray:
    """Dense joint-space inertia matrix via composite rigid body (mj_crb).

    F[j] = crb_inertia[body(j)] @ cdof[j]; lower triangle = anc * (F cdof^T),
    symmetrized — one (nv,6)x(6,nv) matmul plus static masks.
    """
    crb_inert = com.cinert
    for lv in reversed(_levels(m)):
        live = [
            (b, p) for b, p in zip(lv.bodies, lv.parents) if p > 0
        ]  # contributions into the world body are dropped (static)
        if not live:
            continue
        bs = tuple(b for b, _ in live)
        ps = tuple(p for _, p in live)
        crb_inert = add_rows(crb_inert, ps, take_rows(crb_inert, bs))

    dof_body, anc = _crb_masks(
        m.nbody, m.nv, m.body_parentid, m.body_jntid, m.jnt_type,
        m.jnt_dofadr, m.jnt_bodyid, m.njnt,
    )
    # fused multiply-reduce forms (see ops.linalg.mv): exact f32 with no
    # matmul precision to pin
    F = jnp.sum(take_rows(crb_inert, dof_body) * com.cdof[:, None, :], axis=-1)
    W = jnp.sum(F[:, None, :] * com.cdof[None, :, :], axis=-1)
    W = W * jnp.asarray(anc, com.cdof.dtype)
    return W + W.T - jnp.diag(jnp.diag(W)) + jnp.diag(m.dof_armature)


def rne(
    m: RobotModel,
    com: ComQuantities,
    vel: Velocity,
    qvel: jnp.ndarray,
) -> jnp.ndarray:
    """Bias forces C(q, qvel) including gravity (mj_rne, flg_acc=0),
    level-scheduled forward/backward passes."""
    dtype = qvel.dtype
    cacc = jnp.zeros((m.nbody, 6), dtype)
    cacc = cacc.at[0, 3:].set(-m.gravity.astype(dtype))
    for lv in _levels(m):
        a = take_rows(cacc, lv.parents)
        if lv.kind == "hinge":
            dadr = tuple(m.jnt_dofadr[j] for j in lv.jnts)
            a = a + take_rows(vel.cdof_dot, dadr) * take_rows(qvel, dadr)[:, None]
        elif lv.kind == "free":
            for idx, (body, j) in enumerate(zip(lv.bodies, lv.jnts)):
                d = m.jnt_dofadr[j]
                extra = vel.cdof_dot[d : d + 6].T @ qvel[d : d + 6]
                a = add_rows(a, (idx,), extra[None])
        cacc = set_rows(cacc, lv.bodies, a)

    # per-body forces: I a + v x* (I v), batched over all bodies
    Iv = jnp.sum(com.cinert * vel.cvel[:, None, :], axis=-1)
    Ia = jnp.sum(com.cinert * cacc[:, None, :], axis=-1)
    cfrc = Ia + jax.vmap(math.motion_cross_force)(vel.cvel, Iv)
    total = cfrc
    for lv in reversed(_levels(m)):
        live = [(b, p) for b, p in zip(lv.bodies, lv.parents) if p > 0]
        if not live:
            continue
        bs = tuple(b for b, _ in live)
        ps = tuple(p for _, p in live)
        total = add_rows(total, ps, take_rows(total, bs))

    qfrc_bias = jnp.zeros(m.nv, dtype)
    hinge_j = [j for j in range(m.njnt) if m.jnt_type[j] == JNT_HINGE]
    if hinge_j:
        dadr = tuple(m.jnt_dofadr[j] for j in hinge_j)
        bb = tuple(m.jnt_bodyid[j] for j in hinge_j)
        qfrc_bias = set_rows(
            qfrc_bias,
            dadr,
            jnp.sum(take_rows(com.cdof, dadr) * take_rows(total, bb), axis=1),
        )
    for j in range(m.njnt):
        if m.jnt_type[j] != JNT_FREE:
            continue
        d = m.jnt_dofadr[j]
        b = m.jnt_bodyid[j]
        qfrc_bias = qfrc_bias.at[d : d + 6].set(com.cdof[d : d + 6] @ total[b])
    return qfrc_bias


def passive(m: RobotModel, qvel: jnp.ndarray) -> jnp.ndarray:
    """Passive joint damping force (frictionloss is a solver constraint)."""
    return -m.dof_damping * qvel


def actuation(
    m: RobotModel, qpos: jnp.ndarray, qvel: jnp.ndarray, ctrl: jnp.ndarray
) -> jnp.ndarray:
    """Affine actuator force: gain*ctrl + bias·[1, q, qd], clipped.

    Reproduces the affine PD servo the reference configures:
    gainprm=[kp,0,0], biasprm=[0,-kp,-kd] => tau = kp (ctrl - q) - kd qd,
    clipped to forcerange (/root/reference/pupperv3_mjx/environment.py:170-174,
    test_pupper_model.xml:42-43).
    """
    qadr = tuple(m.jnt_qposadr[j] for j in m.actuator_jntid)
    dadr = tuple(m.jnt_dofadr[j] for j in m.actuator_jntid)
    length = take_rows(qpos, qadr)
    velocity = take_rows(qvel, dadr)
    bias = (
        m.actuator_biasprm[:, 0]
        + m.actuator_biasprm[:, 1] * length
        + m.actuator_biasprm[:, 2] * velocity
    )
    force = m.actuator_gainprm[:, 0] * ctrl + bias
    force = jnp.clip(force, m.actuator_forcerange[:, 0], m.actuator_forcerange[:, 1])
    return add_rows(jnp.zeros(m.nv, qpos.dtype), dadr, force)
