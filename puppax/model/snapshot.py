"""Committed compiled-model snapshots: MJCF without the MuJoCo library.

``mjcf.load_model`` compiles MJCF with ``mujoco`` when it is importable.
Where it is not, it loads the snapshot of the same XML: the compiled
``mujoco.MjModel`` tables that ``mjcf.put_model`` and the env's name
lookups read, stored at full (float64) precision in
``snapshots/<xml_key>.npz`` together with the XML text itself.
``ModelSnapshot`` exposes them under the ``MjModel`` attribute names, so
both sources flow through the same code.

Regenerate after changing a bundled model (needs ``mujoco``)::

    python scripts/make_model_snapshots.py
"""

from __future__ import annotations

import hashlib
import os
from types import SimpleNamespace
from typing import Dict

import numpy as np

SNAPSHOT_DIR = os.path.join(os.path.dirname(__file__), "snapshots")
REGENERATE = "python scripts/make_model_snapshots.py"

SIZE_FIELDS = (
    "nq", "nv", "nu", "nbody", "njnt", "ngeom", "nsite", "nhfield", "nkey",
    "nnumeric",
)
ARRAY_FIELDS = (
    "body_parentid", "body_rootid", "body_weldid", "body_jntnum",
    "body_jntadr", "body_geomadr", "body_geomnum", "body_pos", "body_quat",
    "body_ipos", "body_iquat", "body_mass", "body_inertia", "body_invweight0",
    "jnt_type", "jnt_qposadr", "jnt_dofadr", "jnt_bodyid", "jnt_limited",
    "jnt_pos", "jnt_axis", "jnt_range", "jnt_solref", "jnt_solimp",
    "jnt_margin", "dof_bodyid", "dof_armature", "dof_damping",
    "dof_frictionloss", "dof_solref", "dof_solimp", "dof_invweight0",
    "geom_bodyid", "geom_type", "geom_contype", "geom_conaffinity",
    "geom_pos", "geom_quat", "geom_size", "geom_friction", "geom_solref",
    "geom_solimp", "site_bodyid", "site_pos", "actuator_trnid",
    "actuator_gainprm", "actuator_biasprm", "actuator_forcerange",
    "hfield_nrow", "hfield_ncol", "hfield_data", "hfield_size",
    "numeric_adr", "numeric_data", "qpos0", "key_qpos",
)
OPT_FIELDS = (
    "timestep", "impratio", "iterations", "ls_iterations", "tolerance",
    "ls_tolerance", "gravity",
)
STAT_FIELDS = ("meaninertia",)
NAME_KINDS = ("body", "site", "numeric")


def xml_key(xml: str) -> str:
    """Snapshot key of an MJCF XML string."""
    return hashlib.sha256(xml.encode()).hexdigest()[:16]


def path_for(xml: str) -> str:
    return os.path.join(SNAPSHOT_DIR, xml_key(xml) + ".npz")


def tables_from_mujoco(m, xml: str) -> Dict[str, np.ndarray]:
    """The snapshot content of a compiled ``mujoco.MjModel``."""
    out = {"xml": np.array(xml)}
    for name in SIZE_FIELDS:
        out[name] = np.array(int(getattr(m, name)))
    for name in ARRAY_FIELDS:
        out[name] = np.array(getattr(m, name))
    for name in OPT_FIELDS:
        out["opt." + name] = np.array(getattr(m.opt, name))
    for name in STAT_FIELDS:
        out["stat." + name] = np.array(getattr(m.stat, name))
    counts = {"body": m.nbody, "site": m.nsite, "numeric": m.nnumeric}
    for kind in NAME_KINDS:
        names = [getattr(m, kind)(i).name for i in range(counts[kind])]
        out["names." + kind] = np.array(names, dtype=str)
    return out


def save(m, xml: str) -> str:
    """Write the snapshot of ``m`` (compiled from ``xml``); returns its path."""
    os.makedirs(SNAPSHOT_DIR, exist_ok=True)
    path = path_for(xml)
    np.savez_compressed(path, **tables_from_mujoco(m, xml))
    return path


class ModelSnapshot:
    """Read-only ``mujoco.MjModel`` stand-in over a snapshot's tables."""

    def __init__(self, tables: Dict[str, np.ndarray]):
        self.tables = tables
        for name in SIZE_FIELDS:
            setattr(self, name, int(tables[name]))
        for name in ARRAY_FIELDS:
            setattr(self, name, tables[name])
        self.opt = SimpleNamespace(
            **{n: tables["opt." + n][()] for n in OPT_FIELDS}
        )
        self.opt.gravity = tables["opt.gravity"]
        self.stat = SimpleNamespace(
            **{n: tables["stat." + n][()] for n in STAT_FIELDS}
        )
        self._ids = {
            kind: {str(n): i for i, n in enumerate(tables["names." + kind])}
            for kind in NAME_KINDS
        }

    def _id(self, kind: str, name: str) -> int:
        try:
            return self._ids[kind][name]
        except KeyError:
            raise KeyError(f"no {kind} named {name!r} in the model") from None

    def body(self, name: str):
        i = self._id("body", name)
        return SimpleNamespace(
            id=i, name=name,
            geomadr=self.body_geomadr[i : i + 1],
            geomnum=self.body_geomnum[i : i + 1],
        )

    def site(self, name: str):
        return SimpleNamespace(id=self._id("site", name), name=name)

    def numeric(self, i: int):
        return SimpleNamespace(id=i, name=str(self.tables["names.numeric"][i]))


def load(xml: str) -> ModelSnapshot:
    """The snapshot of ``xml``; raises FileNotFoundError on a miss."""
    path = path_for(xml)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no compiled-model snapshot for this MJCF (key {xml_key(xml)}) "
            f"and mujoco is not installed to compile it. Generate it where "
            f"mujoco is installed with: {REGENERATE}"
        )
    with np.load(path) as data:
        return ModelSnapshot({k: data[k] for k in data.files})
