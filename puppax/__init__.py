"""puppax — a JAX quadruped locomotion RL framework.

A from-scratch JAX/XLA re-design of the capability set of the reference
``pupperv3_mjx`` package (rishihahs/pupperv3-mjx): a pure-JAX fixed-topology
rigid-body physics engine with MuJoCo semantics, a batched Pupper v3 joystick
locomotion environment, domain randomization, a mesh-sharded PPO learner, and
the policy-export deployment ABI.

Layer map (mirrors reference SURVEY §1, all five layers owned here):
  L1 model/    — MJCF compile (host-side mujoco, once) -> numeric pytree
  L2 physics/  — pure-JAX rigid body engine (FK, CRB, RNE, contacts, Newton)
  L3 env/      — batched env runtime (State pytree, auto-reset, episode)
  L4 env/pupper.py — the PupperV3 joystick environment
  L5 train/ export/ tools/ — PPO learner, checkpoints, export, logging
"""

__version__ = "0.1.0"

# MuJoCo binds its GL backend at the FIRST `import mujoco` (mujoco reads
# MUJOCO_GL in gl_context.py at import time; swapping afterwards leaves
# PyOpenGL on the wrong platform). On a headless host the glfw default
# probes X11 and rendering dies with "gladLoadGL error", so pick EGL up
# front when (a) nothing was requested, (b) there is no display, and
# (c) libEGL actually exists (a bad value would break ALL mujoco use,
# physics included). Rendering itself stays eval-only (tools/video.py).
import ctypes.util as _ctypes_util
import os as _os

if (
    not _os.environ.get("MUJOCO_GL")
    and not _os.environ.get("DISPLAY")
    and _ctypes_util.find_library("EGL")
):
    _os.environ["MUJOCO_GL"] = "egl"
