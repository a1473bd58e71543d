"""Analytic narrowphase collision for the pupper model class.

Supported pair types (everything the reference model + obstacle terrain
produces, plus heightfield terrain and capsule-legged quadruped variants):
plane-sphere, sphere-sphere, sphere-box, hfield-sphere, plane-capsule,
sphere-capsule, capsule-capsule. All candidate pairs are
evaluated every step with fixed shapes; the reference's MJX contact caps
(``max_geom_pairs`` per pair type, then ``max_contact_points`` overall,
/root/reference/test/test_pupper_model.xml:227-230 via
utils.set_mjx_custom_options) are applied as top-k selections by
penetration depth.

Everything here is deliberately **gather/scatter-free**. Pair selections
from the kinematics tables use constant one-hot einsums (the pair lists
are static model topology), and top-k is a short sequential argmin with
one-hot extraction instead of ``jax.lax.top_k`` + dynamic gathers under
the env vmap (ops/select.py).

Contact conventions match MuJoCo: ``dist`` < 0 means penetration, the
frame's first row is the normal pointing from geom1 into geom2, ``pos`` is
the midpoint of the overlap, and per-contact friction/solref/solimp are
combined from both geoms (solmix-weighted average for solref/solimp,
elementwise max for friction — verified against mjData in
tests/test_physics_constraint.py).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from puppax.model.mjcf import RobotModel
from puppax.physics.smooth import Kinematics


class Contacts(NamedTuple):
    """Fixed-size contact set (ncon = max_contact_points)."""

    dist: jnp.ndarray  # (ncon,) penetration (<0) or large positive for pads
    pos: jnp.ndarray  # (ncon, 3)
    frame: jnp.ndarray  # (ncon, 3, 3) rows = [normal, tangent1, tangent2]
    friction: jnp.ndarray  # (ncon, 2) tangential friction coefficients
    solref: jnp.ndarray  # (ncon, 2)
    solimp: jnp.ndarray  # (ncon, 5)
    invweight: jnp.ndarray  # (ncon,) body_invweight0 lin sum of the two bodies
    geom1: jnp.ndarray  # (ncon,) int
    geom2: jnp.ndarray  # (ncon,) int
    body1: jnp.ndarray  # (ncon,) int
    body2: jnp.ndarray  # (ncon,) int


_PAD_DIST = 1e10


def _take(x: jnp.ndarray, idx: Sequence[int]) -> jnp.ndarray:
    """Select rows of a traced (n, ...) array by STATIC indices via a
    constant one-hot einsum — lowers to one dense contraction instead of a
    gather under the env vmap (ops/select.py)."""
    idx = np.asarray(idx, np.int64)
    sel = np.zeros((len(idx), x.shape[0]), np.float32)
    sel[np.arange(len(idx)), idx] = 1.0
    return jnp.einsum(
        "kn,n...->k...",
        jnp.asarray(sel, x.dtype),
        x,
        precision=jax.lax.Precision.HIGHEST,
    )


def _make_frames(n: jnp.ndarray) -> jnp.ndarray:
    """Contact frames from unit normals (k, 3) — exact mju_makeFrame:
    helper axis e = y if |n_y| < 0.5 else z; t2 = normalize(n x e);
    t1 = t2 x n. (Fitted and verified against mjData contact frames over
    random capsule poses, r2 — an axis-projection Gram-Schmidt variant
    coincides only for normals with a zero y-component.)"""
    use_y = jnp.abs(n[:, 1]) < 0.5
    e = jnp.where(
        use_y[:, None],
        jnp.array([0.0, 1.0, 0.0], n.dtype),
        jnp.array([0.0, 0.0, 1.0], n.dtype),
    )
    t2 = jnp.cross(n, e)
    t2 = t2 / jnp.maximum(jnp.linalg.norm(t2, axis=-1, keepdims=True), 1e-12)
    t1 = jnp.cross(t2, n)
    return jnp.stack([n, t1, t2], axis=1)  # (k, 3, 3)


def _combine(m: RobotModel, g1: np.ndarray, g2: np.ndarray):
    """Per-contact parameter combination (priorities equal, solmix default):
    friction = elementwise max, solref/solimp = mean. Static pair ids."""
    fr = jnp.maximum(_take(m.geom_friction, g1), _take(m.geom_friction, g2))
    # MuJoCo contact friction = [slide, slide, torsion, roll, roll]; both
    # tangential directions use the slide coefficient
    tangential = jnp.stack([fr[:, 0], fr[:, 0]], axis=-1)
    solref = 0.5 * (_take(m.geom_solref, g1) + _take(m.geom_solref, g2))
    solimp = 0.5 * (_take(m.geom_solimp, g1) + _take(m.geom_solimp, g2))
    bodyid = np.asarray(m.geom_bodyid)
    b1, b2 = bodyid[g1], bodyid[g2]
    iw_lin = m.body_invweight0[:, 0]
    invweight = _take(iw_lin, b1) + _take(iw_lin, b2)
    return tangential.astype(solref.dtype), solref, solimp, invweight, b1, b2


def _plane_sphere(m: RobotModel, kin: Kinematics, g1, g2):
    """Batched plane(g1)-sphere(g2) for static index arrays g1, g2."""
    n = _take(kin.geom_xmat, g1)[:, :, 2]  # plane normals = local z axes
    plane_pos = _take(kin.geom_xpos, g1)
    center = _take(kin.geom_xpos, g2)
    r = _take(m.geom_size, g2)[:, 0]
    dist = jnp.sum(n * (center - plane_pos), axis=-1) - r
    pos = center - n * (r + 0.5 * dist)[:, None]
    return dist, pos, _make_frames(n)


def _sphere_sphere(m: RobotModel, kin: Kinematics, g1, g2):
    c1 = _take(kin.geom_xpos, g1)
    c2 = _take(kin.geom_xpos, g2)
    r1 = _take(m.geom_size, g1)[:, 0]
    r2 = _take(m.geom_size, g2)[:, 0]
    delta = c2 - c1
    length = jnp.linalg.norm(delta, axis=-1)
    n = delta / jnp.maximum(length, 1e-12)[:, None]
    dist = length - (r1 + r2)
    pos = c1 + n * (r1 + 0.5 * dist)[:, None]
    return dist, pos, _make_frames(n)


def _sphere_box(m: RobotModel, kin: Kinematics, g1, g2):
    """Batched sphere(g1) vs box(g2); normal points from sphere into box."""
    center = _take(kin.geom_xpos, g1)
    r = _take(m.geom_size, g1)[:, 0]
    box_pos = _take(kin.geom_xpos, g2)
    box_mat = _take(kin.geom_xmat, g2)  # (k, 3, 3)
    half = _take(m.geom_size, g2)  # (k, 3)
    # sphere centers in box frames
    p = jnp.einsum("kij,ki->kj", box_mat, center - box_pos)
    clamped = jnp.clip(p, -half, half)
    inside = jnp.all(jnp.abs(p) < half, axis=-1)

    # outside: closest point on surface
    delta_out = p - clamped
    dist_out = jnp.linalg.norm(delta_out, axis=-1)
    n_out = -delta_out / jnp.maximum(dist_out, 1e-12)[:, None]
    # inside: push out along the nearest face (one-hot, no scatter)
    gaps = half - jnp.abs(p)
    kmin = jnp.argmin(gaps, axis=-1)
    oh = jax.nn.one_hot(kmin, 3, dtype=p.dtype)
    sign = jnp.sign(jnp.sum(p * oh, axis=-1))
    sign = jnp.where(sign == 0, 1.0, sign)
    n_in = -sign[:, None] * oh
    dist_in = -jnp.sum(gaps * oh, axis=-1)
    surf_in = p * (1.0 - oh) + oh * sign[:, None] * half

    dist_local = jnp.where(inside, dist_in, dist_out) - r
    n_local = jnp.where(inside[:, None], n_in, n_out)
    surf_local = jnp.where(inside[:, None], surf_in, clamped)

    n = jnp.einsum("kij,kj->ki", box_mat, n_local)
    surface = box_pos + jnp.einsum("kij,kj->ki", box_mat, surf_local)
    sphere_surface = center + n * r[:, None]
    pos = 0.5 * (sphere_surface + surface)
    return dist_local, pos, _make_frames(n)


def _capsule_ends(m: RobotModel, kin: Kinematics, g):
    """Endpoint centers + radius of capsules for static geom ids g."""
    center = _take(kin.geom_xpos, g)
    axis = _take(kin.geom_xmat, g)[:, :, 2]  # local z in world frame
    size = _take(m.geom_size, g)
    r = size[:, 0]
    half = size[:, 1]
    return center - axis * half[:, None], center + axis * half[:, None], r


def _plane_capsule(m: RobotModel, kin: Kinematics, g1, g2):
    """Batched plane(g1)-capsule(g2): MuJoCo emits one contact per capsule
    END (two plane-sphere contacts at the endpoint spheres) — rows are
    interleaved [pair0_end0, pair0_end1, pair1_end0, ...].

    Frame convention (mjc_PlaneCapsule, verified against mjData): the
    first tangent is the capsule AXIS projected onto the plane (the
    friction pyramid aligns with the capsule), not the mju_makeFrame
    axis-projection; vertical capsules fall back to mju_makeFrame."""
    n = _take(kin.geom_xmat, g1)[:, :, 2]
    plane_pos = _take(kin.geom_xpos, g1)
    axis = _take(kin.geom_xmat, g2)[:, :, 2]
    e0, e1, r = _capsule_ends(m, kin, g2)
    ends = jnp.stack([e0, e1], axis=1)  # (k, 2, 3)
    dist = jnp.sum(n[:, None, :] * (ends - plane_pos[:, None, :]), axis=-1) - r[:, None]
    pos = ends - n[:, None, :] * (r[:, None] + 0.5 * dist)[:, :, None]
    k = dist.shape[0]
    proj = axis - n * jnp.sum(n * axis, axis=-1, keepdims=True)
    pnorm = jnp.linalg.norm(proj, axis=-1, keepdims=True)
    fallback = _make_frames(n)
    t1 = jnp.where(pnorm > 1e-8, proj / jnp.maximum(pnorm, 1e-12), fallback[:, 1])
    t2 = jnp.cross(n, t1)
    frames = jnp.stack([n, t1, t2], axis=1)
    return (
        dist.reshape(2 * k),
        pos.reshape(2 * k, 3),
        jnp.repeat(frames, 2, axis=0),
    )


def _sphere_capsule(m: RobotModel, kin: Kinematics, g1, g2):
    """Batched sphere(g1)-capsule(g2): sphere vs the nearest point on the
    capsule axis segment (mjc_SphereCapsule semantics)."""
    c1 = _take(kin.geom_xpos, g1)
    r1 = _take(m.geom_size, g1)[:, 0]
    center = _take(kin.geom_xpos, g2)
    axis = _take(kin.geom_xmat, g2)[:, :, 2]
    size = _take(m.geom_size, g2)
    r2, half = size[:, 0], size[:, 1]
    t = jnp.clip(jnp.sum((c1 - center) * axis, axis=-1), -half, half)
    nearest = center + axis * t[:, None]
    delta = nearest - c1
    length = jnp.linalg.norm(delta, axis=-1)
    n = delta / jnp.maximum(length, 1e-12)[:, None]
    dist = length - (r1 + r2)
    pos = c1 + n * (r1 + 0.5 * dist)[:, None]
    return dist, pos, _make_frames(n)


def _capsule_capsule(m: RobotModel, kin: Kinematics, g1, g2):
    """Batched capsule-capsule: closest points between the two axis
    segments (Ericson 5.1.9, clamped), then the virtual sphere-sphere
    contact (mjc_CapsuleCapsule semantics)."""
    a0, a1, r1 = _capsule_ends(m, kin, g1)
    b0, b1, r2 = _capsule_ends(m, kin, g2)
    d1 = a1 - a0
    d2 = b1 - b0
    r_ = a0 - b0
    a = jnp.sum(d1 * d1, axis=-1)
    e = jnp.sum(d2 * d2, axis=-1)
    f = jnp.sum(d2 * r_, axis=-1)
    c = jnp.sum(d1 * r_, axis=-1)
    b = jnp.sum(d1 * d2, axis=-1)
    denom = a * e - b * b
    # segment parameters s (on capsule 1) and t (on capsule 2) in [0, 1]
    s = jnp.where(
        denom > 1e-12, jnp.clip((b * f - c * e) / jnp.maximum(denom, 1e-12), 0.0, 1.0), 0.0
    )
    t = (b * s + f) / jnp.maximum(e, 1e-12)
    # re-clamp t, then recompute s against the clamped t
    t_cl = jnp.clip(t, 0.0, 1.0)
    s = jnp.where(
        t != t_cl,
        jnp.clip((b * t_cl - c) / jnp.maximum(a, 1e-12), 0.0, 1.0),
        s,
    )
    p1 = a0 + d1 * s[:, None]
    p2 = b0 + d2 * t_cl[:, None]
    delta = p2 - p1
    length = jnp.linalg.norm(delta, axis=-1)
    n = delta / jnp.maximum(length, 1e-12)[:, None]
    dist = length - (r1 + r2)
    pos = p1 + n * (r1 + 0.5 * dist)[:, None]
    return dist, pos, _make_frames(n)


def _hfield_sphere(m: RobotModel, kin: Kinematics, g1, g2):
    """Batched heightfield(g1) vs sphere(g2).

    Gather-free bilinear-patch narrowphase: the elevation lookup and surface
    slope at the sphere's footprint are quadratic forms ``w_rᵀ H w_c`` with
    the interpolation weights folded into row/column one-hot vectors — two
    small dense contractions instead of dynamic gathers (see module
    docstring). The
    contact is the tangent plane of the bilinear patch at the footprint.
    On cells whose 4 corners are coplanar this equals MuJoCo's
    triangulated-prism narrowphase exactly; on saddle cells it is the
    smooth bilinear interpolant instead of the two triangles.
    """
    H = m.hfield_data  # (nrow, ncol) normalized [0,1]
    dtype = kin.geom_xpos.dtype
    rx, ry, ez = m.hfield_size[0], m.hfield_size[1], m.hfield_size[2]
    hf_pos = _take(kin.geom_xpos, g1)
    hf_mat = _take(kin.geom_xmat, g1)  # (k, 3, 3)
    center = _take(kin.geom_xpos, g2)
    r = _take(m.geom_size, g2)[:, 0]
    # sphere centers in the heightfield frame
    p = jnp.einsum("kij,ki->kj", hf_mat, center - hf_pos)
    nrow, ncol = m.hfield_nrow, m.hfield_ncol
    # fractional grid coordinates of the footprint
    u = (p[:, 0] + rx) / (2.0 * rx) * (ncol - 1)
    v = (p[:, 1] + ry) / (2.0 * ry) * (nrow - 1)
    outside = (jnp.abs(p[:, 0]) > rx) | (jnp.abs(p[:, 1]) > ry)
    iu = jnp.clip(jnp.floor(u), 0.0, float(ncol - 2))
    iv = jnp.clip(jnp.floor(v), 0.0, float(nrow - 2))
    fu = jnp.clip(u - iu, 0.0, 1.0)
    fv = jnp.clip(v - iv, 0.0, 1.0)
    cols = jnp.arange(ncol, dtype=dtype)
    rows = jnp.arange(nrow, dtype=dtype)
    e_c0 = (cols == iu[:, None]).astype(dtype)
    e_c1 = (cols == iu[:, None] + 1.0).astype(dtype)
    e_r0 = (rows == iv[:, None]).astype(dtype)
    e_r1 = (rows == iv[:, None] + 1.0).astype(dtype)
    w_c = (1.0 - fu)[:, None] * e_c0 + fu[:, None] * e_c1  # (k, ncol)
    w_r = (1.0 - fv)[:, None] * e_r0 + fv[:, None] * e_r1  # (k, nrow)
    d_c = e_c1 - e_c0  # d w_c / d fu
    d_r = e_r1 - e_r0
    hi = jax.lax.Precision.HIGHEST
    h = ez * jnp.einsum("kr,rc,kc->k", w_r, H, w_c, precision=hi)
    dhdx = ez * jnp.einsum("kr,rc,kc->k", w_r, H, d_c, precision=hi) * (
        (ncol - 1) / (2.0 * rx)
    )
    dhdy = ez * jnp.einsum("kr,rc,kc->k", d_r, H, w_c, precision=hi) * (
        (nrow - 1) / (2.0 * ry)
    )
    n_local = jnp.stack([-dhdx, -dhdy, jnp.ones_like(dhdx)], axis=-1)
    n_local = n_local / jnp.linalg.norm(n_local, axis=-1, keepdims=True)
    dist = (p[:, 2] - h) * n_local[:, 2] - r
    dist = jnp.where(outside, jnp.asarray(_PAD_DIST, dtype), dist)
    n = jnp.einsum("kij,kj->ki", hf_mat, n_local)
    safe = jnp.where(outside, jnp.zeros_like(dist), dist)
    pos = center - n * (r + 0.5 * safe)[:, None]
    return dist, pos, _make_frames(n)


def _top_k_select(items, k):
    """Keep the k most-penetrating rows (ascending dist, first-index ties),
    matching lax.top_k(-dist) order — implemented as k sequential argmins
    with one-hot extraction (gather-free)."""
    dist = items[0]
    n = dist.shape[0]
    if n <= k:
        return items
    iota = jnp.arange(n)
    masked = dist
    rows = []
    for _ in range(k):
        i = jnp.argmin(masked)
        oh = iota == i
        rows.append(oh)
        # mask with +inf (not _PAD_DIST) so already-selected rows can never
        # be re-picked even when the remaining rows are all pads
        masked = jnp.where(oh, jnp.asarray(jnp.inf, dist.dtype), masked)
    sel = jnp.stack(rows)  # (k, n) bool
    out = []
    for x in items:
        sel_x = sel.reshape(sel.shape + (1,) * (x.ndim - 1))
        out.append(jnp.sum(jnp.where(sel_x, x[None], jnp.zeros((), x.dtype)), axis=1))
    return tuple(out)


def _pair_groups(m: RobotModel, kin: Kinematics):
    """Evaluate every candidate pair; yields per-type contact tuples.
    ``rows`` is the contacts-per-pair expansion (plane-capsule emits one
    contact per capsule end)."""
    for pairs, fn, rows in (
        (m.pairs_plane_sphere, _plane_sphere, 1),
        (m.pairs_sphere_sphere, _sphere_sphere, 1),
        (m.pairs_sphere_box, _sphere_box, 1),
        (m.pairs_hfield_sphere, _hfield_sphere, 1),
        (m.pairs_plane_capsule, _plane_capsule, 2),
        (m.pairs_sphere_capsule, _sphere_capsule, 1),
        (m.pairs_capsule_capsule, _capsule_capsule, 1),
    ):
        if not pairs:
            continue
        g1 = np.asarray([p[0] for p in pairs], np.int64)
        g2 = np.asarray([p[1] for p in pairs], np.int64)
        dist, pos, frame = fn(m, kin, g1, g2)
        if rows > 1:
            g1 = np.repeat(g1, rows)
            g2 = np.repeat(g2, rows)
        fri, sref, simp, iw, b1, b2 = _combine(m, g1, g2)
        yield (
            dist,
            pos,
            frame,
            fri,
            sref,
            simp,
            iw,
            jnp.asarray(g1, jnp.int32),
            jnp.asarray(g2, jnp.int32),
            jnp.asarray(b1, jnp.int32),
            jnp.asarray(b2, jnp.int32),
        )


def collide_pairs(m: RobotModel, kin: Kinematics) -> Contacts:
    """Uncapped per-pair contact set in static pair order — the REPORTING
    surface (PhysicsState.contact) the env's collision rewards read.

    MuJoCo C reports every candidate pair's contact (no MJX-style caps);
    since r2 the reporting set matches that (the independent oracle replay,
    tests/oracle_env, counts contacts from the C engine). The SOLVER still
    consumes the capped set from :func:`collide` — reference MJX dynamics
    semantics — and the two only differ when > max_geom_pairs pairs of one
    type penetrate simultaneously. Static pair order means the env's
    geom-id reward masks need no gathers.
    """
    groups = list(_pair_groups(m, kin))
    if not groups:
        return _empty_contacts(m, kin.geom_xpos.dtype, 0)
    merged = tuple(
        jnp.concatenate([g[i] for g in groups]) for i in range(len(groups[0]))
    )
    return Contacts(*merged)


def _empty_contacts(m: RobotModel, dtype, ncon: int) -> Contacts:
    return Contacts(
        dist=jnp.full((ncon,), _PAD_DIST, dtype),
        pos=jnp.zeros((ncon, 3), dtype),
        frame=jnp.tile(jnp.eye(3, dtype=dtype), (ncon, 1, 1)),
        friction=jnp.ones((ncon, 2), dtype),
        solref=jnp.tile(jnp.asarray([0.02, 1.0], dtype), (ncon, 1)),
        solimp=jnp.tile(
            jnp.asarray([0.9, 0.95, 0.001, 0.5, 2.0], dtype), (ncon, 1)
        ),
        invweight=jnp.zeros((ncon,), dtype),
        geom1=jnp.zeros((ncon,), jnp.int32),
        geom2=jnp.zeros((ncon,), jnp.int32),
        body1=jnp.zeros((ncon,), jnp.int32),
        body2=jnp.zeros((ncon,), jnp.int32),
    )


def collide(m: RobotModel, kin: Kinematics) -> Contacts:
    """Evaluate all candidate pairs, apply per-type and global top-k caps."""
    dtype = kin.geom_xpos.dtype
    # per-type pair cap (reference MJX max_geom_pairs semantics)
    groups = [
        _top_k_select(g, m.max_geom_pairs) for g in _pair_groups(m, kin)
    ]

    ncon = m.max_contact_points
    if not groups:
        return _empty_contacts(m, dtype, ncon)

    merged = tuple(
        jnp.concatenate([g[i] for g in groups]) for i in range(len(groups[0]))
    )
    n_all = merged[0].shape[0]
    if n_all > ncon:
        merged = _top_k_select(merged, ncon)
    elif n_all < ncon:
        pad = ncon - n_all
        padded = []
        for i, x in enumerate(merged):
            if i == 0:  # dist
                fill = jnp.full((pad,), _PAD_DIST, x.dtype)
            elif x.dtype in (jnp.int32, jnp.int64):
                fill = jnp.zeros((pad,) + x.shape[1:], x.dtype)
            elif i == 2:  # frame
                fill = jnp.tile(jnp.eye(3, dtype=x.dtype), (pad, 1, 1))
            else:
                fill = jnp.ones((pad,) + x.shape[1:], x.dtype)
            padded.append(jnp.concatenate([x, fill]))
        merged = tuple(padded)

    return Contacts(
        dist=merged[0],
        pos=merged[1],
        frame=merged[2],
        friction=merged[3],
        solref=merged[4],
        solimp=merged[5],
        invweight=merged[6],
        geom1=merged[7],
        geom2=merged[8],
        body1=merged[9],
        body2=merged[10],
    )
