"""Device mesh, shardings, and multi-host bootstrap (the distrib layer).

The reference had no distributed backend in-repo: brax PPO ``pmap``-ed over
local devices with implicit ``psum`` (SURVEY §2.4). This design replaces
pmap with a global ``jax.sharding.Mesh`` over all devices and
``jit``-with-``NamedSharding`` semantics: the env batch is sharded over the
``'env'`` axis (data parallelism; every GPU of a host reaches every other
over NVLink, so the 1-D mesh needs no topology), parameters are
replicated, and XLA inserts the gradient all-reduce — no hand-written
collectives on the hot path.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

ENV_AXIS = "env"


def maybe_initialize_distributed(**kwargs) -> bool:
    """Bootstrap multi-host JAX (jax.distributed) if running under a
    multi-process launcher; a no-op in single-process runs.

    Must run before ANY backend-initializing JAX call (``jax.devices()``,
    ``jax.process_count()``, the first op...) — so the launcher decision is
    made purely from the environment: explicit ``kwargs``, a
    ``COORDINATOR_ADDRESS`` env var (with optional ``NUM_PROCESSES`` /
    ``PROCESS_ID``), or a cluster env jax auto-detects (GKE/Slurm). Returns
    True when the distributed runtime is (or already was) live. Failures
    RAISE — a silently-single-host process in a pod job corrupts training.
    """
    import os

    if jax.distributed.is_initialized():
        return True
    coordinator = kwargs.get("coordinator_address") or os.environ.get(
        "COORDINATOR_ADDRESS"
    )
    if coordinator is None:
        return False  # single-process run: leave the local backend alone
    kwargs.setdefault("coordinator_address", coordinator)
    if "NUM_PROCESSES" in os.environ:
        kwargs.setdefault("num_processes", int(os.environ["NUM_PROCESSES"]))
    if "PROCESS_ID" in os.environ:
        kwargs.setdefault("process_id", int(os.environ["PROCESS_ID"]))
    jax.distributed.initialize(**kwargs)
    return True


def make_env_mesh(devices: Optional[list] = None) -> Mesh:
    """1-D mesh over all (or the given) devices with the 'env' data axis.

    The env/data batch dimension is the only sharded axis in this framework
    (SURVEY §2.3: the policy MLP is tiny — no TP/PP); scaling is pure data
    parallelism over ICI/DCN.
    """
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (ENV_AXIS,))


def env_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a pytree with a leading env-batch axis."""
    return NamedSharding(mesh, PartitionSpec(ENV_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for replicated leaves (params, optimizer state, scalars)."""
    return NamedSharding(mesh, PartitionSpec())


def shard_env_batch(tree, mesh: Mesh):
    """Place a host pytree with leading batch axis onto the mesh, sharded
    over the env axis."""
    sharding = env_sharding(mesh)
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding) if hasattr(x, "ndim") and x.ndim else x,
        tree,
    )
