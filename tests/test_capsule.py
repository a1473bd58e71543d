"""Capsule collision primitives vs the MuJoCo C oracle (VERDICT r1 item 6).

Capsules are the standard quadruped collision primitive; the engine now
supports plane-capsule (two end contacts), sphere-capsule, and
capsule-capsule narrowphase. A capsule-variant Pupper model (foot spheres
replaced by capsules) must reproduce the C engine's trajectories.
"""

import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest

from puppax.model.assets import pupper_xml
from puppax.model.mjcf import load_model
from puppax.physics import collision, pipeline, smooth


def _capsule_pupper_xml() -> str:
    """Bundled Pupper model with the 4 foot spheres replaced by capsules
    (r=0.015, half-length 0.02) — the common quadruped leg primitive."""
    tree = ET.ElementTree(ET.fromstring(pupper_xml()))
    n = 0
    for geom in tree.getroot().iter("geom"):
        if geom.get("type") == "sphere" and geom.get("size") == "0.01995":
            geom.set("type", "capsule")
            geom.set("size", "0.015 0.02")
            n += 1
    assert n == 4, n
    return ET.tostring(tree.getroot(), encoding="unicode")


def _free_capsules_xml() -> str:
    """Two free capsules + a free sphere over a plane: exercises all three
    capsule pair types with fully generic poses."""
    return """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom name="floor" type="plane" size="0 0 1" contype="1" conaffinity="1"
          friction="0.8 0.02 0.01"/>
    <body name="c1" pos="0 0 0.3">
      <freejoint/>
      <geom name="c1g" type="capsule" size="0.04 0.09" mass="0.4"
            contype="1" conaffinity="1" friction="0.8 0.02 0.01"/>
    </body>
    <body name="c2" pos="0.05 0.02 0.6" quat="0.92 0.2 0.33 0">
      <freejoint/>
      <geom name="c2g" type="capsule" size="0.03 0.07" mass="0.3"
            contype="1" conaffinity="1" friction="0.8 0.02 0.01"/>
    </body>
    <body name="s1" pos="-0.04 0.05 0.9">
      <freejoint/>
      <geom name="s1g" type="sphere" size="0.05" mass="0.2"
            contype="1" conaffinity="1" friction="0.8 0.02 0.01"/>
    </body>
  </worldbody>
</mujoco>
"""


@pytest.fixture(scope="module")
def caps_oracle(x64):
    xml = _free_capsules_xml()
    mj = mujoco.MjModel.from_xml_string(xml)
    mj.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_WARMSTART
    cm = load_model(None, dtype=jnp.float64, xml_string=xml)
    # raise caps so nothing is dropped vs the C engine
    m = cm.robot.replace(max_contact_points=32, max_geom_pairs=32)
    return mj, m


def test_capsule_pair_enumeration(caps_oracle):
    _, m = caps_oracle
    assert len(m.pairs_plane_capsule) == 2
    assert len(m.pairs_sphere_capsule) == 2
    assert len(m.pairs_capsule_capsule) == 1
    assert len(m.pairs_plane_sphere) == 1


def test_capsule_narrowphase_matches_mujoco(caps_oracle):
    """Random tumbling poses: every penetrating C contact has a matching
    puppax contact with the same dist/pos/normal."""
    mj, m = caps_oracle
    d = mujoco.MjData(mj)
    rng = np.random.default_rng(2)
    matched = 0
    for _ in range(60):
        qpos = np.array(mj.qpos0)
        for b in range(3):
            qpos[7 * b : 7 * b + 3] = rng.uniform(-0.15, 0.15, 3)
            qpos[7 * b + 2] = rng.uniform(0.02, 0.25)
            quat = rng.normal(0, 1, 4)
            qpos[7 * b + 3 : 7 * b + 7] = quat / np.linalg.norm(quat)
        d.qpos[:] = qpos
        mujoco.mj_forward(mj, d)
        kin = smooth.kinematics(m, jnp.asarray(qpos))
        con = collision.collide(m, kin)
        dists = np.asarray(con.dist)
        pos = np.asarray(con.pos)
        frames = np.asarray(con.frame)
        for k in range(d.ncon):
            c = d.contact[k]
            if c.dist > -1e-6:
                continue  # only firm penetrations are robustly unique
            err = np.abs(dists - c.dist)
            j = int(np.argmin(err))
            assert err[j] < 1e-9, (c.dist, dists[j])
            np.testing.assert_allclose(pos[j], c.pos, atol=1e-9)
            np.testing.assert_allclose(frames[j].ravel(), c.frame, atol=1e-8)
            matched += 1
    assert matched >= 30, matched


def test_capsule_drop_trajectory_matches_oracle(caps_oracle):
    """250 substeps of free fall + contact settling: qpos stays within
    1e-4 of the C engine (the plane-capsule two-end contact model and the
    segment-segment narrowphase feed the same Newton solve)."""
    mj, m = caps_oracle
    d = mujoco.MjData(mj)
    state = pipeline.pipeline_init(
        m, jnp.asarray(np.array(mj.qpos0)), jnp.zeros(m.nv, jnp.float64)
    )
    ctrl = jnp.zeros(m.nu, jnp.float64)
    step1 = jax.jit(lambda s: pipeline.pipeline_step(m, s, ctrl, n_substeps=1))
    max_err = 0.0
    for _ in range(250):
        mujoco.mj_step(mj, d)
        state = step1(state)
        max_err = max(
            max_err, float(np.max(np.abs(np.asarray(state.qpos) - d.qpos)))
        )
    assert max_err < 1e-4, max_err


def test_capsule_pupper_loads_and_steps(x64):
    """The capsule-legged Pupper variant compiles and its standing drop
    on the XLA engine (f64) matches the C engine."""
    xml = _capsule_pupper_xml()
    mj = mujoco.MjModel.from_xml_string(xml)
    mj.opt.disableflags |= mujoco.mjtDisableBit.mjDSBL_WARMSTART
    mj.opt.timestep = 0.004
    cm = load_model(None, dtype=jnp.float64, xml_string=xml)
    m = cm.robot.tree_replace({"opt.timestep": 0.004})
    m = m.replace(max_contact_points=64, max_geom_pairs=64)
    assert len(m.pairs_plane_capsule) == 4  # the new feet

    qpos = np.array(mj.key_qpos[0])
    qpos[2] = 0.25
    d = mujoco.MjData(mj)
    d.qpos[:] = qpos
    d.ctrl[:] = qpos[7:]
    state = pipeline.pipeline_init(m, jnp.asarray(qpos), jnp.zeros(18, jnp.float64))
    ctrl = jnp.asarray(qpos[7:], jnp.float64)
    step1 = jax.jit(lambda s: pipeline.pipeline_step(m, s, ctrl, n_substeps=1))
    max_err = 0.0
    for _ in range(250):
        mujoco.mj_step(mj, d)
        state = step1(state)
        max_err = max(
            max_err, float(np.max(np.abs(np.asarray(state.qpos) - d.qpos)))
        )
    assert max_err < 1e-4, max_err
