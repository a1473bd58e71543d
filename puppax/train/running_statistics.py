"""Running observation normalization statistics (Welford, device-parallel).

Equivalent of the brax/acme running-statistics normalizer whose
``mean``/``std`` fields form half of the PPO param tuple the reference
checkpoints and exports (/root/reference/pupperv3_mjx/export.py:29,
utils.py:242). The state layout keeps those field names so
``export.convert_params`` semantics carry over bit-for-bit.

Updates are exact streaming mean/variance over the batch; under a sharded
mesh the batch statistics are computed by XLA reductions over the sharded
axis (jnp.sum over a NamedSharding-annotated array lowers to a
reduce+all-reduce across devices) — no explicit pmean needed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from puppax import struct


@struct.dataclass
class RunningStatisticsState:
    """Streaming mean/std state. Field names are part of the export ABI."""

    count: jnp.ndarray  # () scalar, float for stable large-count math
    mean: jnp.ndarray  # (obs_dim,)
    summed_variance: jnp.ndarray  # (obs_dim,) sum of squared deviations
    std: jnp.ndarray  # (obs_dim,)


def init_state(obs_dim: int, dtype=jnp.float32) -> RunningStatisticsState:
    return RunningStatisticsState(
        count=jnp.zeros((), jnp.float32),
        mean=jnp.zeros(obs_dim, dtype),
        summed_variance=jnp.zeros(obs_dim, dtype),
        std=jnp.ones(obs_dim, dtype),
    )


def update(
    state: RunningStatisticsState,
    batch: jnp.ndarray,
    std_min_value: float = 1e-6,
    axis_name: str = None,
) -> RunningStatisticsState:
    """Fold a batch (..., obs_dim) into the running statistics (Chan's
    parallel Welford update — exact, order-independent, all on device).

    Inside a ``shard_map``/``pmap`` region pass ``axis_name`` to reduce the
    batch moments across the device axis (one fused psum over ICI) so every
    shard holds identical global statistics.
    """
    obs_dim = state.mean.shape[-1]
    flat = batch.reshape(-1, obs_dim)
    batch_count = jnp.asarray(flat.shape[0], jnp.float32)

    batch_mean = jnp.mean(flat, axis=0)
    if axis_name is not None:
        batch_mean = jax.lax.pmean(batch_mean, axis_name)
    batch_m2 = jnp.sum(jnp.square(flat - batch_mean), axis=0)
    if axis_name is not None:
        batch_m2 = jax.lax.psum(batch_m2, axis_name)
        batch_count = batch_count * jax.lax.psum(1.0, axis_name)

    new_count = state.count + batch_count
    delta = batch_mean - state.mean
    new_mean = state.mean + delta * (batch_count / new_count)
    new_m2 = (
        state.summed_variance
        + batch_m2
        + jnp.square(delta) * state.count * batch_count / new_count
    )
    new_std = jnp.sqrt(jnp.maximum(new_m2 / new_count, 0.0))
    new_std = jnp.maximum(new_std, std_min_value)
    return RunningStatisticsState(
        count=new_count,
        mean=new_mean.astype(state.mean.dtype),
        summed_variance=new_m2.astype(state.summed_variance.dtype),
        std=new_std.astype(state.std.dtype),
    )


def normalize(batch: jnp.ndarray, state: RunningStatisticsState) -> jnp.ndarray:
    return (batch - state.mean) / state.std


def denormalize(batch: jnp.ndarray, state: RunningStatisticsState) -> jnp.ndarray:
    return batch * state.std + state.mean
