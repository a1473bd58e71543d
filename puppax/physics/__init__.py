"""puppax.physics — L2: pure-JAX fixed-topology rigid-body engine.

A from-scratch replacement for the brax/MJX physics pipeline the
reference runs on (/root/reference/pupperv3_mjx/environment.py:319,366):
MuJoCo-semantics forward dynamics — forward kinematics, CRB mass matrix,
RNE bias forces, analytic sphere/plane/box collisions, pyramidal-cone
constraint assembly with solimp/solref impedance, a Newton solver, affine
PD actuation and semi-implicit Euler integration — written as pure
functions of a ``RobotModel`` pytree, fully jit/vmap/shard_map-able so the
env-batch axis carries all the parallelism.
"""

try:
    from puppax.physics.pipeline import (  # noqa: F401
        PhysicsState,
        pipeline_init,
        pipeline_step,
    )
except ImportError:  # pipeline lands after the smooth/constraint stages
    pass
