"""Primal Newton constraint solver (MuJoCo semantics).

Minimizes over qacc:
    0.5 (x - x_smooth)' M (x - x_smooth) + sum_i s_i(J_i x - aref_i)
where s_i is the per-row convex cost:
  * one-sided rows (limits, pyramid facets): 0.5 D jar^2 when jar < 0, else 0
  * friction-loss rows: Huber — 0.5 D jar^2 for |jar| <= floss R,
    linear floss |jar| - 0.5 floss^2 R outside (force saturates at ±floss)

Each Newton iteration builds the exact Hessian H = M + J_A' D J_A over the
active set, takes a Cholesky step, and runs an exact line search on the
piecewise-quadratic 1-D restriction (Newton on phi', ls_iterations steps).
Configured like the reference model: iterations=1, ls_iterations=5
(/root/reference/test/test_pupper_model.xml:57). The solve is a handful of
batched (nv x nv) factorizations and (nefc x nv) matmuls — dense, fixed
shape, fused by XLA across the env batch.

Validated against mujoco C (warmstart disabled, same init x0 = qacc_smooth)
in tests/test_physics_step.py.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from puppax.model.mjcf import RobotModel
from puppax.ops import linalg
from puppax.physics.constraint import EfcData


# Tiny-matrix products as broadcast-multiply-reduce: XLA fuses these into
# single exact-f32 elementwise kernels instead of HIGHEST-precision
# batched matmuls over tiny matrices.
def _mv(A: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """A @ x for small (n, m) A."""
    return jnp.sum(A * x[None, :], axis=-1)


def _mtv(A: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """A.T @ y for small (n, m) A."""
    return jnp.sum(A * y[:, None], axis=0)


def _weighted_gram(J: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """J.T @ diag(w) @ J for small (nefc, nv) J."""
    return jnp.sum(w[:, None, None] * J[:, :, None] * J[:, None, :], axis=0)


class SolverResult(NamedTuple):
    qacc: jnp.ndarray  # (nv,)
    efc_force: jnp.ndarray  # (nefc,)
    qfrc_constraint: jnp.ndarray  # (nv,)


def _row_cost(efc: EfcData, jar: jnp.ndarray) -> jnp.ndarray:
    """Total per-row convex cost at jar (the s_i in the module docstring)."""
    quad = 0.5 * efc.D * jar * jar
    lin = efc.floss * jnp.abs(jar) - 0.5 * efc.floss * efc.floss * efc.R
    cost_fric = jnp.where(jnp.abs(jar) <= efc.floss * efc.R, quad, lin)
    cost_onesided = jnp.where(jar < 0, quad, 0.0)
    return jnp.sum(jnp.where(efc.is_friction, cost_fric, cost_onesided))


def _row_force(efc: EfcData, jar: jnp.ndarray):
    """Per-row constraint force and quadratic-zone mask at given jar."""
    quad_fric = jnp.abs(jar) <= efc.floss * efc.R
    quad = jnp.where(efc.is_friction, quad_fric, jar < 0)
    lin_force = jnp.where(efc.is_friction, -jnp.sign(jar) * efc.floss, 0.0)
    force = jnp.where(quad, -efc.D * jar, lin_force)
    return force, quad


def solve(
    m: RobotModel,
    qM: jnp.ndarray,
    qacc_smooth: jnp.ndarray,
    efc: EfcData,
) -> SolverResult:
    dtype = qacc_smooth.dtype
    x = qacc_smooth

    # MuJoCo solver termination scale: costs/gradients are normalized by
    # meaninertia * max(1, nv) before comparison with opt.tolerance
    # (mj_solNewton semantics). With iterations=1 (the reference model)
    # this reduces to the single unconditional step validated against the
    # C oracle; for iterations>1 converged lanes freeze via the mask.
    scale = 1.0 / max(m.meaninertia * max(1, m.nv), 1e-30)
    tol = m.tolerance
    active = jnp.asarray(True)
    n_iter = max(m.solver_iterations, 1)

    for it in range(n_iter):
        jar = _mv(efc.J, x) - efc.aref
        force, quad = _row_force(efc, jar)
        ma = _mv(qM, x - qacc_smooth)
        grad = ma - _mtv(efc.J, force)
        # pre-step gradient exit (mj: gradient < tolerance)
        grad_norm = scale * jnp.sqrt(jnp.sum(grad * grad))
        active = active & (grad_norm >= tol)
        # exact Hessian over the active set
        dw = efc.D * quad.astype(dtype)
        H = qM + _weighted_gram(efc.J, dw)
        dx = -linalg.spd_solve(H, grad)

        # Exact line search. phi(alpha) is convex piecewise quadratic, so
        # phi'(alpha) is increasing piecewise linear:
        #   phi'(a) = g0 + a h0 + sum_onesided min(D (jar + a jv), 0) jv
        #                       + sum_friction clip(D (jar + a jv), ±floss) jv
        # The exact minimizer is the root of phi'. We locate the linear
        # segment containing the sign change by evaluating phi' at every
        # activity breakpoint (O(nefc^2) fused elementwise work,
        # bit-deterministic), then solve
        # the linear segment in closed form. States where MuJoCo C's capped
        # iterative search converges match this to machine precision.
        jv = _mv(efc.J, dx)
        mdx = _mv(qM, dx)
        g0 = jnp.dot(dx, ma)  # gauss gradient term at alpha=0
        h0 = jnp.maximum(jnp.dot(dx, mdx), 1e-12)  # gauss curvature > 0

        def dphi_fn(alpha):
            # alpha: (...,) broadcast over rows
            jar_a = jar + alpha[..., None] * jv
            dja = efc.D * jar_a
            s = jnp.where(
                efc.is_friction,
                jnp.clip(dja, -efc.floss, efc.floss),
                jnp.minimum(dja, 0.0),
            )
            return g0 + alpha * h0 + jnp.sum(s * jv, axis=-1)

        BIG = jnp.asarray(1e12, dtype)
        safe_jv = jnp.where(jnp.abs(jv) > 1e-12, jv, 1.0)
        valid = (jnp.abs(jv) > 1e-12) & (efc.D > 0)
        bp0 = jnp.where(valid, -jar / safe_jv, BIG)
        fl_over_d = efc.floss / jnp.maximum(efc.D, 1e-30)
        bp_lo = jnp.where(
            valid & efc.is_friction, (-fl_over_d - jar) / safe_jv, BIG
        )
        bp_hi = jnp.where(
            valid & efc.is_friction, (fl_over_d - jar) / safe_jv, BIG
        )
        bps = jnp.concatenate([bp0, bp_lo, bp_hi, jnp.zeros((1,), dtype)])
        vals = dphi_fn(bps)
        # segment bracket: largest bp with phi'<=0, smallest bp with phi'>0
        neg = vals <= 0
        a_lo = jnp.max(jnp.where(neg, bps, -BIG))
        a_hi = jnp.min(jnp.where(~neg, bps, BIG))
        # phi' is linear on (a_lo, a_hi): root via evaluation at two points
        has_hi = a_hi < BIG
        mid = jnp.where(has_hi, 0.5 * (a_lo + a_hi), a_lo + 1.0)
        f_lo = dphi_fn(a_lo[None])[0]
        f_mid = dphi_fn(mid[None])[0]
        slope = (f_mid - f_lo) / jnp.maximum(mid - a_lo, 1e-30)
        slope = jnp.maximum(slope, 1e-12)
        alpha = a_lo - f_lo / slope
        # descent safeguard (phi'(0) < 0 guarantees a positive step)
        alpha = jnp.maximum(alpha, 0.0)

        x_new = x + alpha * dx
        x_old = x
        x = jnp.where(active, x_new, x)
        if it < n_iter - 1:
            # post-step improvement exit (mj: improvement < tolerance);
            # skipped on the last iteration — nothing left to gate
            cost_old = 0.5 * jnp.dot(x_old - qacc_smooth, ma) + _row_cost(
                efc, jar
            )
            jar_new = _mv(efc.J, x) - efc.aref
            ma_new = _mv(qM, x - qacc_smooth)
            cost_new = 0.5 * jnp.dot(x - qacc_smooth, ma_new) + _row_cost(
                efc, jar_new
            )
            active = active & (scale * (cost_old - cost_new) >= tol)

    jar = _mv(efc.J, x) - efc.aref
    force, _ = _row_force(efc, jar)
    qfrc_constraint = _mtv(efc.J, force)
    return SolverResult(qacc=x, efc_force=force, qfrc_constraint=qfrc_constraint)
