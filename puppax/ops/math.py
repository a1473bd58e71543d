"""Quaternion and spatial (6D) rigid-body math, MuJoCo conventions.

All functions are pure, jit/vmap-friendly, and written for single
(unbatched) operands — batching is applied by ``jax.vmap`` at the
pipeline level so the env-batch axis carries the parallelism.

Conventions:
  * quaternions are (w, x, y, z), unit norm
  * spatial motion/force vectors are shape (6,) = [angular(3); linear(3)]
  * spatial inertia is a dense (6, 6) symmetric matrix in the same ordering

Reference behavior being reproduced (not copied): the quaternion helpers
used by the reference env via ``brax.math`` (rotate, quat_inv,
euler_to_quat, normalize — see /root/reference/pupperv3_mjx/rewards.py and
environment.py call sites) and the spatial algebra used implicitly via
MuJoCo's smooth dynamics (mj_comPos / mj_comVel / mj_rne / mj_crb).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# quaternions (w, x, y, z)
# ---------------------------------------------------------------------------


def quat_mul(u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product u ⊗ v."""
    return jnp.stack(
        [
            u[0] * v[0] - u[1] * v[1] - u[2] * v[2] - u[3] * v[3],
            u[0] * v[1] + u[1] * v[0] + u[2] * v[3] - u[3] * v[2],
            u[0] * v[2] - u[1] * v[3] + u[2] * v[0] + u[3] * v[1],
            u[0] * v[3] + u[1] * v[2] - u[2] * v[1] + u[3] * v[0],
        ]
    )


def quat_inv(q: jnp.ndarray) -> jnp.ndarray:
    """Conjugate of a unit quaternion."""
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def rotate(vec: jnp.ndarray, quat: jnp.ndarray) -> jnp.ndarray:
    """Rotate a 3-vector by a unit quaternion (q v q*).

    Matches ``brax.math.rotate`` semantics used throughout the reference
    env/reward code (/root/reference/pupperv3_mjx/environment.py:296-297,
    492-493, 513; rewards.py:24,60,68).
    """
    s, u = quat[0], quat[1:]
    r = 2.0 * (jnp.dot(u, vec) * u) + (s * s - jnp.dot(u, u)) * vec
    r = r + 2.0 * s * jnp.cross(u, vec)
    return r


def rotate_inv(vec: jnp.ndarray, quat: jnp.ndarray) -> jnp.ndarray:
    """Rotate a 3-vector by the inverse of a unit quaternion."""
    return rotate(vec, quat_inv(quat))


def quat_to_mat(q: jnp.ndarray) -> jnp.ndarray:
    """Unit quaternion -> 3x3 rotation matrix (column i = rotate(e_i))."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return jnp.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def euler_to_quat(v: jnp.ndarray) -> jnp.ndarray:
    """Euler angles (DEGREES), intrinsic x-y'-z'' convention, -> quaternion.

    Matches ``brax.math.euler_to_quat`` as used by
    /root/reference/pupperv3_mjx/environment.py:296 (roll, pitch, yaw):
    brax converts from degrees (half-angle = v*pi/360) — the env's
    maximum_pitch/roll_command are specified in degrees (environment.py:
    101-102). Caught by the independent oracle replay (r2): a radians
    version rotates the desired-z command wildly off axis.
    """
    half = v * (jnp.pi / 360.0)
    c1, c2, c3 = jnp.cos(half)
    s1, s2, s3 = jnp.sin(half)
    w = c1 * c2 * c3 - s1 * s2 * s3
    x = s1 * c2 * c3 + c1 * s2 * s3
    y = c1 * s2 * c3 - s1 * c2 * s3
    z = c1 * c2 * s3 + s1 * s2 * c3
    return jnp.array([w, x, y, z])


def normalize(v: jnp.ndarray, eps: float = 1e-6):
    """Return (unit vector, norm) with safe division.

    Matches ``brax.math.normalize`` (used for command-magnitude gating in
    /root/reference/pupperv3_mjx/rewards.py:81,106 and the total_dist
    metric, environment.py:478).
    """
    norm = jnp.linalg.norm(v)
    n = v / (norm + eps)
    return n, norm


def quat_integrate(q: jnp.ndarray, omega_local: jnp.ndarray, dt) -> jnp.ndarray:
    """Integrate a unit quaternion by a body-frame angular velocity.

    MuJoCo ``mju_quatIntegrate`` semantics: free-joint angular velocity is
    expressed in the child body frame; q_new = q ⊗ exp(dt * ω / 2),
    renormalized.
    """
    angle = jnp.linalg.norm(omega_local) * dt
    # safe axis for zero rotation
    norm = jnp.linalg.norm(omega_local)
    axis = omega_local / jnp.where(norm < 1e-12, 1.0, norm)
    half = 0.5 * angle
    dq = jnp.concatenate([jnp.cos(half)[None], axis * jnp.sin(half)])
    out = quat_mul(q, dq)
    return out / jnp.linalg.norm(out)


# ---------------------------------------------------------------------------
# spatial algebra: 6-vectors [ang; lin]
# ---------------------------------------------------------------------------


def motion_cross(v: jnp.ndarray, m: jnp.ndarray) -> jnp.ndarray:
    """Spatial cross product of two motion vectors: v x m.

    [w1; p1] x [w2; p2] = [w1×w2 ; w1×p2 + p1×w2]
    """
    ang = jnp.cross(v[:3], m[:3])
    lin = jnp.cross(v[:3], m[3:]) + jnp.cross(v[3:], m[:3])
    return jnp.concatenate([ang, lin])


def motion_cross_force(v: jnp.ndarray, f: jnp.ndarray) -> jnp.ndarray:
    """Spatial cross product of a motion vector with a force vector: v x* f.

    [w; p] x* [t; f] = [w×t + p×f ; w×f]
    """
    ang = jnp.cross(v[:3], f[:3]) + jnp.cross(v[3:], f[3:])
    lin = jnp.cross(v[:3], f[3:])
    return jnp.concatenate([ang, lin])


def inert_mul(I: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Spatial inertia (6,6) times motion vector (6,) -> force vector (6,)."""
    return I @ v


def transform_inertia(
    mass: jnp.ndarray, diag_inertia: jnp.ndarray, ipos: jnp.ndarray, imat: jnp.ndarray
) -> jnp.ndarray:
    """Build a (6,6) spatial inertia about a frame origin.

    Args:
      mass: scalar body mass.
      diag_inertia: (3,) principal moments.
      ipos: (3,) vector from the frame origin to the body COM, world-aligned.
      imat: (3,3) rotation from principal axes to the frame axes.

    Returns the spatial inertia [[I + m cxc^T, m cx],[m cx^T, m 1]] with
    ordering [ang; lin] (MuJoCo cinert semantics, expanded to dense 6x6).
    """
    return transform_inertia_batch(
        mass[None], diag_inertia[None], ipos[None], imat[None]
    )[0]


# Levi-Civita tensor: skew(c)[i, k] = eps[i, j, k] c[j]
_EPS3 = np.zeros((3, 3, 3), np.float32)
_EPS3[0, 1, 2] = _EPS3[1, 2, 0] = _EPS3[2, 0, 1] = 1.0
_EPS3[0, 2, 1] = _EPS3[1, 0, 2] = _EPS3[2, 1, 0] = -1.0


def transform_inertia_batch(
    mass: jnp.ndarray, diag_inertia: jnp.ndarray, ipos: jnp.ndarray, imat: jnp.ndarray
) -> jnp.ndarray:
    """Batched (n, 6, 6) spatial inertias — a handful of dense einsums
    instead of per-body scalar assembly (jnp.array-of-scalars + jnp.block
    explode into many small ops under a 4k env vmap)."""
    dtype = ipos.dtype
    # I3[n,i,k] = sum_j imat[n,i,j] d[n,j] imat[n,k,j] (fused, no matmul)
    I3 = jnp.sum(
        imat[..., :, None, :]
        * diag_inertia[..., None, None, :]
        * imat[..., None, :, :],
        axis=-1,
    )
    c = ipos
    m_ = mass[..., None, None]
    cc = c[..., :, None] * c[..., None, :]
    dot = jnp.sum(c * c, axis=-1)[..., None, None]
    eye3 = jnp.eye(3, dtype=dtype)
    # cx cx^T = (c.c) I - c c^T
    top_left = I3 + m_ * (dot * eye3 - cc)
    cx = jnp.sum(
        jnp.asarray(_EPS3, dtype)[None, :, :, :] * c[..., None, :, None],
        axis=-2,
    )
    top_right = m_ * cx
    bottom_left = jnp.swapaxes(top_right, -1, -2)
    bottom_right = m_ * eye3
    top = jnp.concatenate([top_left, top_right], axis=-1)
    bottom = jnp.concatenate([bottom_left, bottom_right], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def transform_motion(v: jnp.ndarray, offset: jnp.ndarray) -> jnp.ndarray:
    """Shift a spatial motion vector to a new reference point.

    new_point = old_point + offset;  [w; p'] where p' = p - offset × w.
    """
    ang = v[:3]
    lin = v[3:] - jnp.cross(offset, ang)
    return jnp.concatenate([ang, lin])


def ad_dual(offset: jnp.ndarray, f: jnp.ndarray) -> jnp.ndarray:
    """Shift a spatial force vector to a new reference point.

    Torque about new point = t + offset × f_lin.
    """
    ang = f[:3] + jnp.cross(offset, f[3:])
    return jnp.concatenate([ang, f[3:]])
