"""MJCF -> RobotModel pytree compilation.

The reference loads models through ``brax.io.mjcf.load`` which wraps
``mujoco.MjModel`` + ``mjx.put_model``
(/root/reference/pupperv3_mjx/environment.py:165). Here the plain ``mujoco``
C compiler runs host-side exactly once (or, where mujoco is not installed,
the committed snapshot of its output is loaded — puppax/model/snapshot.py),
and every numeric table the engine needs is extracted into an immutable
JAX pytree. Static topology
(parent indices, joint types, collision pair lists) is kept as hashable
Python tuples on non-pytree fields so that jit re-traces only on topology
changes, never on parameter changes — and so domain randomization can put a
leading env axis on parameter leaves (friction/gains/inertia/mass/COM)
without touching the static structure, mirroring the reference's
randomization protocol (/root/reference/pupperv3_mjx/domain_randomization.py:93-112).
"""

from __future__ import annotations

import itertools
from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from puppax import struct
from puppax.model import snapshot

# mujoco geom type enum values we support (mjtGeom)
GEOM_PLANE = 0
GEOM_HFIELD = 1
GEOM_SPHERE = 2
GEOM_CAPSULE = 3
GEOM_BOX = 6

# joint types (mjtJoint)
JNT_FREE = 0
JNT_HINGE = 3


def _t(x) -> tuple:
    """numpy array -> nested hashable tuple (static pytree aux data)."""
    a = np.asarray(x)
    if a.ndim == 1:
        return tuple(a.tolist())
    return tuple(map(tuple, a.tolist()))


@struct.dataclass
class RobotModel:
    """Immutable numeric robot model (the engine's 'System' pytree).

    Array leaves may carry a leading env-batch axis when domain-randomized
    (geom_friction, actuator_gainprm, actuator_biasprm, body_ipos,
    body_inertia, body_mass — the six leaves randomized by the reference,
    /root/reference/pupperv3_mjx/domain_randomization.py:93-112).
    """

    # ---- static topology (hashable, not traced) ----
    nq: int = struct.field(pytree_node=False)
    nv: int = struct.field(pytree_node=False)
    nu: int = struct.field(pytree_node=False)
    nbody: int = struct.field(pytree_node=False)
    njnt: int = struct.field(pytree_node=False)
    ngeom: int = struct.field(pytree_node=False)
    nsite: int = struct.field(pytree_node=False)
    body_parentid: tuple = struct.field(pytree_node=False)
    body_rootid: tuple = struct.field(pytree_node=False)
    # one joint per body max in this model class; -1 = fixed to parent
    body_jntid: tuple = struct.field(pytree_node=False)
    jnt_type: tuple = struct.field(pytree_node=False)
    jnt_qposadr: tuple = struct.field(pytree_node=False)
    jnt_dofadr: tuple = struct.field(pytree_node=False)
    jnt_bodyid: tuple = struct.field(pytree_node=False)
    jnt_limited: tuple = struct.field(pytree_node=False)
    dof_bodyid: tuple = struct.field(pytree_node=False)
    geom_bodyid: tuple = struct.field(pytree_node=False)
    geom_type: tuple = struct.field(pytree_node=False)
    site_bodyid: tuple = struct.field(pytree_node=False)
    actuator_jntid: tuple = struct.field(pytree_node=False)
    dof_frictional: tuple = struct.field(pytree_node=False)  # dofs with frictionloss>0
    # collision candidate pair tables: tuples of (geom1, geom2)
    pairs_plane_sphere: tuple = struct.field(pytree_node=False)
    pairs_sphere_sphere: tuple = struct.field(pytree_node=False)
    pairs_sphere_box: tuple = struct.field(pytree_node=False)
    # contact caps (reference custom numerics max_contact_points /
    # max_geom_pairs, /root/reference/test/test_pupper_model.xml:227-230)
    max_contact_points: int = struct.field(pytree_node=False)
    max_geom_pairs: int = struct.field(pytree_node=False)
    # solver options (/root/reference/test/test_pupper_model.xml:57-59)
    timestep: float = struct.field(pytree_node=False)
    impratio: float = struct.field(pytree_node=False)
    solver_iterations: int = struct.field(pytree_node=False)
    ls_iterations: int = struct.field(pytree_node=False)
    tolerance: float = struct.field(pytree_node=False)
    ls_tolerance: float = struct.field(pytree_node=False)
    # mean body inertia (mjModel.stat.meaninertia): the MuJoCo solver's
    # cost/gradient normalization scale for tolerance-based early exit
    meaninertia: float = struct.field(pytree_node=False)

    # ---- numeric parameters (traced jnp leaves) ----
    gravity: jnp.ndarray
    qpos0: jnp.ndarray  # reference configuration (FK zero), (nq,)
    key_qpos: jnp.ndarray  # 'home' keyframe qpos, (nq,)
    body_pos: jnp.ndarray  # (nbody, 3)
    body_quat: jnp.ndarray  # (nbody, 4)
    body_ipos: jnp.ndarray  # (nbody, 3)   [DR leaf]
    body_iquat: jnp.ndarray  # (nbody, 4)
    body_mass: jnp.ndarray  # (nbody,)     [DR leaf]
    body_inertia: jnp.ndarray  # (nbody, 3) [DR leaf]
    jnt_pos: jnp.ndarray  # (njnt, 3)
    jnt_axis: jnp.ndarray  # (njnt, 3)
    jnt_range: jnp.ndarray  # (njnt, 2)
    jnt_solref: jnp.ndarray  # (njnt, 2)
    jnt_solimp: jnp.ndarray  # (njnt, 5)
    jnt_margin: jnp.ndarray  # (njnt,)
    dof_armature: jnp.ndarray  # (nv,)
    dof_damping: jnp.ndarray  # (nv,)
    dof_frictionloss: jnp.ndarray  # (nv,)
    dof_solref: jnp.ndarray  # (nv, 2)
    dof_solimp: jnp.ndarray  # (nv, 5)
    dof_invweight0: jnp.ndarray  # (nv,) diag(M^-1) at qpos0 (mujoco-precomputed)
    body_invweight0: jnp.ndarray  # (nbody, 2) [lin, rot] inverse weights at qpos0
    geom_pos: jnp.ndarray  # (ngeom, 3)
    geom_quat: jnp.ndarray  # (ngeom, 4)
    geom_size: jnp.ndarray  # (ngeom, 3)
    geom_friction: jnp.ndarray  # (ngeom, 3) [DR leaf]
    geom_solref: jnp.ndarray  # (ngeom, 2)
    geom_solimp: jnp.ndarray  # (ngeom, 5)
    site_pos: jnp.ndarray  # (nsite, 3)
    actuator_gainprm: jnp.ndarray  # (nu, 3)  [DR leaf]
    actuator_biasprm: jnp.ndarray  # (nu, 3)  [DR leaf]
    actuator_forcerange: jnp.ndarray  # (nu, 2)

    # ---- heightfield terrain (optional; at most one hfield) ----
    # static grid topology; 0x0 = no heightfield in the model
    hfield_nrow: int = struct.field(pytree_node=False, default=0)
    hfield_ncol: int = struct.field(pytree_node=False, default=0)
    pairs_hfield_sphere: tuple = struct.field(pytree_node=False, default=())
    # normalized elevation grid (nrow, ncol) in [0,1]; row r sits at
    # y = -ry + 2*ry*r/(nrow-1), col c at x = -rx + 2*rx*c/(ncol-1)
    # (mujoco memory convention, verified empirically against mj_step)
    hfield_data: Optional[jnp.ndarray] = None
    hfield_size: Optional[jnp.ndarray] = None  # (4,) rx, ry, elevation_z, base_z

    # ---- capsule collision pairs (r2; empty for sphere-only models) ----
    pairs_plane_capsule: tuple = struct.field(pytree_node=False, default=())
    pairs_sphere_capsule: tuple = struct.field(pytree_node=False, default=())
    pairs_capsule_capsule: tuple = struct.field(pytree_node=False, default=())

    def tree_replace(self, updates: dict) -> "RobotModel":
        """Dotted-path functional update, mirroring brax's System.tree_replace
        API used by the reference (/root/reference/pupperv3_mjx/environment.py:167).
        Only flat field names are needed here ('opt.timestep' is accepted as
        an alias for the static timestep field)."""
        out = self
        for key, val in updates.items():
            field = key.split(".")[-1] if key.startswith("opt.") else key
            out = out.replace(**{field: val})
        return out


class CompiledModel:
    """Host-side compilation result: the RobotModel pytree plus the host
    model — a ``mujoco.MjModel``, or its ``snapshot.ModelSnapshot`` where
    mujoco is not installed — for float64 tables, name lookups and
    rendering (never traced)."""

    def __init__(self, robot: RobotModel, mj_model):
        self.robot = robot
        self.mj_model = mj_model


def _collision_pairs(m):
    """Static candidate collision pairs, MuJoCo pair-filter semantics:
    contype/conaffinity bitmask match, different bodies, parent-child
    excluded unless the parent is the world body."""
    plane_sphere, sphere_sphere, sphere_box, hfield_sphere = [], [], [], []
    plane_capsule, sphere_capsule, capsule_capsule = [], [], []
    supported = {GEOM_PLANE, GEOM_SPHERE, GEOM_CAPSULE, GEOM_BOX, GEOM_HFIELD}
    for g1, g2 in itertools.combinations(range(m.ngeom), 2):
        if not (
            (m.geom_contype[g1] & m.geom_conaffinity[g2])
            or (m.geom_contype[g2] & m.geom_conaffinity[g1])
        ):
            continue
        b1, b2 = int(m.geom_bodyid[g1]), int(m.geom_bodyid[g2])
        if b1 == b2:
            continue
        # parent-child filter (world parent exempt)
        p1, p2 = int(m.body_parentid[b1]), int(m.body_parentid[b2])
        w1 = int(m.body_weldid[b1]) if hasattr(m, "body_weldid") else b1
        w2 = int(m.body_weldid[b2]) if hasattr(m, "body_weldid") else b2
        if (p2 == b1 or p1 == b2) and b1 != 0 and b2 != 0:
            continue
        if w1 == w2:
            continue
        t1, t2 = int(m.geom_type[g1]), int(m.geom_type[g2])
        if t1 not in supported or t2 not in supported:
            raise NotImplementedError(f"geom pair type ({t1},{t2}) unsupported")
        # order pairs canonically: plane first, box before sphere
        pair = sorted(((t1, g1), (t2, g2)))
        (ta, ga), (tb, gb) = pair
        if ta == GEOM_PLANE and tb == GEOM_SPHERE:
            plane_sphere.append((ga, gb))
        elif ta == GEOM_SPHERE and tb == GEOM_SPHERE:
            sphere_sphere.append((ga, gb))
        elif ta == GEOM_SPHERE and tb == GEOM_BOX:
            sphere_box.append((ga, gb))
        elif ta == GEOM_HFIELD and tb == GEOM_SPHERE:
            hfield_sphere.append((ga, gb))
        elif ta == GEOM_PLANE and tb == GEOM_CAPSULE:
            plane_capsule.append((ga, gb))
        elif ta == GEOM_SPHERE and tb == GEOM_CAPSULE:
            sphere_capsule.append((ga, gb))
        elif ta == GEOM_CAPSULE and tb == GEOM_CAPSULE:
            capsule_capsule.append((ga, gb))
        elif ta == GEOM_PLANE and tb == GEOM_BOX:
            # plane-box between world geoms is filtered by same-body above;
            # any other combination is out of scope for this model class
            raise NotImplementedError("plane-box collisions unsupported")
        elif GEOM_HFIELD in (ta, tb):
            # hfield vs plane/box are world-static pairs, never dynamic here
            raise NotImplementedError(f"hfield pair ({ta},{tb}) unsupported")
        else:
            raise NotImplementedError(f"pair ({ta},{tb}) unsupported")
    return (
        tuple(plane_sphere),
        tuple(sphere_sphere),
        tuple(sphere_box),
        tuple(hfield_sphere),
        tuple(plane_capsule),
        tuple(sphere_capsule),
        tuple(capsule_capsule),
    )


def _custom_numeric(m, name: str, default: int) -> int:
    for i in range(m.nnumeric):
        if m.numeric(i).name == name:
            return int(m.numeric_data[m.numeric_adr[i]])
    return default


def put_model(m, dtype=jnp.float32) -> RobotModel:
    """Extract a RobotModel pytree from a compiled mujoco model (or its
    snapshot)."""
    if m.njnt and not all(
        int(t) in (JNT_FREE, JNT_HINGE) for t in m.jnt_type
    ):
        raise NotImplementedError("only free + hinge joints supported")
    # one joint per body max
    if np.any(m.body_jntnum > 1):
        raise NotImplementedError("at most one joint per body supported")
    body_jntid = np.where(m.body_jntnum[:] > 0, m.body_jntadr[:], -1)

    ps, ss, bs, hs, pc, sc, cc = _collision_pairs(m)
    if int(m.nhfield) > 1:
        raise NotImplementedError("at most one heightfield supported")

    def arr(x):
        # host numpy: model leaves are closed over as jit constants
        return np.asarray(np.asarray(x), dtype=dtype)

    return RobotModel(
        nq=int(m.nq),
        nv=int(m.nv),
        nu=int(m.nu),
        nbody=int(m.nbody),
        njnt=int(m.njnt),
        ngeom=int(m.ngeom),
        nsite=int(m.nsite),
        body_parentid=_t(m.body_parentid),
        body_rootid=_t(m.body_rootid),
        body_jntid=_t(body_jntid),
        jnt_type=_t(m.jnt_type),
        jnt_qposadr=_t(m.jnt_qposadr),
        jnt_dofadr=_t(m.jnt_dofadr),
        jnt_bodyid=_t(m.jnt_bodyid),
        jnt_limited=_t(m.jnt_limited.astype(int)),
        dof_bodyid=_t(m.dof_bodyid),
        geom_bodyid=_t(m.geom_bodyid),
        geom_type=_t(m.geom_type),
        site_bodyid=_t(m.site_bodyid),
        actuator_jntid=_t(m.actuator_trnid[:, 0]),
        dof_frictional=tuple(int(d) for d in np.nonzero(m.dof_frictionloss > 0)[0]),
        pairs_plane_sphere=ps,
        pairs_sphere_sphere=ss,
        pairs_sphere_box=bs,
        pairs_hfield_sphere=hs,
        pairs_plane_capsule=pc,
        pairs_sphere_capsule=sc,
        pairs_capsule_capsule=cc,
        hfield_nrow=int(m.hfield_nrow[0]) if m.nhfield else 0,
        hfield_ncol=int(m.hfield_ncol[0]) if m.nhfield else 0,
        hfield_data=(
            arr(m.hfield_data.reshape(int(m.hfield_nrow[0]), int(m.hfield_ncol[0])))
            if m.nhfield
            else None
        ),
        hfield_size=arr(m.hfield_size[0]) if m.nhfield else None,
        max_contact_points=_custom_numeric(m, "max_contact_points", 8),
        max_geom_pairs=_custom_numeric(m, "max_geom_pairs", 8),
        timestep=float(m.opt.timestep),
        impratio=float(m.opt.impratio),
        solver_iterations=int(m.opt.iterations),
        ls_iterations=int(m.opt.ls_iterations),
        tolerance=float(m.opt.tolerance),
        ls_tolerance=float(m.opt.ls_tolerance),
        meaninertia=float(m.stat.meaninertia),
        gravity=arr(m.opt.gravity),
        qpos0=arr(m.qpos0),
        key_qpos=arr(m.key_qpos[0] if m.nkey else m.qpos0),
        body_pos=arr(m.body_pos),
        body_quat=arr(m.body_quat),
        body_ipos=arr(m.body_ipos),
        body_iquat=arr(m.body_iquat),
        body_mass=arr(m.body_mass),
        body_inertia=arr(m.body_inertia),
        jnt_pos=arr(m.jnt_pos),
        jnt_axis=arr(m.jnt_axis),
        jnt_range=arr(m.jnt_range),
        jnt_solref=arr(m.jnt_solref),
        jnt_solimp=arr(m.jnt_solimp),
        jnt_margin=arr(m.jnt_margin),
        dof_armature=arr(m.dof_armature),
        dof_damping=arr(m.dof_damping),
        dof_frictionloss=arr(m.dof_frictionloss),
        dof_solref=arr(m.dof_solref),
        dof_solimp=arr(m.dof_solimp),
        dof_invweight0=arr(m.dof_invweight0),
        body_invweight0=arr(m.body_invweight0),
        geom_pos=arr(m.geom_pos),
        geom_quat=arr(m.geom_quat),
        geom_size=arr(m.geom_size),
        geom_friction=arr(m.geom_friction),
        geom_solref=arr(m.geom_solref),
        geom_solimp=arr(m.geom_solimp),
        site_pos=arr(m.site_pos),
        actuator_gainprm=arr(m.actuator_gainprm[:, :3]),
        actuator_biasprm=arr(m.actuator_biasprm[:, :3]),
        actuator_forcerange=arr(m.actuator_forcerange),
    )


def load_model(
    path: str, dtype=jnp.float32, xml_string: Optional[str] = None
) -> CompiledModel:
    """Compile an MJCF file (or XML string) into a CompiledModel.

    Equivalent role to ``brax.io.mjcf.load``
    (/root/reference/pupperv3_mjx/environment.py:165): one host-side MuJoCo
    compile, after which no jitted code touches the C library. Without
    mujoco installed, the committed snapshot of the same XML is loaded
    (FileNotFoundError, naming the regenerate command, on a miss).
    """
    if xml_string is None and path is None:
        # default to the bundled physics-equivalent Pupper v3 model
        from puppax.model import assets

        xml_string = assets.pupper_xml()
    try:
        import mujoco
    except ImportError:
        if xml_string is None:
            with open(path) as f:
                xml_string = f.read()
        mj_model = snapshot.load(xml_string)
    else:
        if xml_string is not None:
            mj_model = mujoco.MjModel.from_xml_string(xml_string)
        else:
            mj_model = mujoco.MjModel.from_xml_path(str(path))
    return CompiledModel(put_model(mj_model, dtype=dtype), mj_model)
