"""Committed compiled-model snapshots (puppax/model/snapshot.py).

Each snapshot must equal a fresh MuJoCo compile of the XML stored in it,
and ``load_model`` must give the same RobotModel and env tables from the
snapshot as from mujoco.
"""

import glob
import os

import numpy as np
import pytest

from puppax.model import assets, mjcf, snapshot

mujoco = pytest.importorskip("mujoco")

SNAPSHOTS = sorted(glob.glob(os.path.join(snapshot.SNAPSHOT_DIR, "*.npz")))


def test_bundled_model_has_a_snapshot():
    assert os.path.exists(snapshot.path_for(assets.pupper_xml()))


@pytest.mark.parametrize("path", SNAPSHOTS, ids=os.path.basename)
def test_snapshot_equals_fresh_compile(path):
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files}
    xml = str(stored["xml"])
    assert os.path.basename(path) == snapshot.xml_key(xml) + ".npz"
    fresh = snapshot.tables_from_mujoco(mujoco.MjModel.from_xml_string(xml), xml)
    assert sorted(stored) == sorted(fresh)
    for name, want in fresh.items():
        got = stored[name]
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def _leaves(robot):
    import jax

    return jax.tree_util.tree_flatten_with_path(robot)


def test_load_model_from_snapshot_matches_mujoco(monkeypatch):
    """The same RobotModel, float64 tables and name lookups from the
    snapshot as from the mujoco compile."""
    import builtins

    via_mujoco = mjcf.load_model(None)

    real_import = builtins.__import__

    def no_mujoco(name, *args, **kwargs):
        if name == "mujoco" or name.startswith("mujoco."):
            raise ImportError("mujoco blocked for this test")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_mujoco)
    via_snapshot = mjcf.load_model(None)
    monkeypatch.setattr(builtins, "__import__", real_import)

    assert isinstance(via_snapshot.mj_model, snapshot.ModelSnapshot)
    (la, ta), (lb, tb) = _leaves(via_mujoco.robot), _leaves(via_snapshot.robot)
    assert ta == tb
    for (path, a), (_, b) in zip(la, lb):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))

    m, s = via_mujoco.mj_model, via_snapshot.mj_model
    for name in snapshot.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(m, name), getattr(s, name), err_msg=name)
    for name in ("base_link", "leg_front_r_2", "leg_back_l_3"):
        assert m.body(name).id == s.body(name).id
        np.testing.assert_array_equal(m.body(name).geomadr, s.body(name).geomadr)
        np.testing.assert_array_equal(m.body(name).geomnum, s.body(name).geomnum)
    assert m.site("leg_front_r_3_foot_site").id == s.site("leg_front_r_3_foot_site").id
    with pytest.raises(KeyError):
        s.body("no_such_body")


def test_snapshot_miss_names_the_regenerate_command():
    with pytest.raises(FileNotFoundError, match="make_model_snapshots.py"):
        snapshot.load("<mujoco model='not-committed'/>")
