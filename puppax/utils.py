"""Small shared utilities: circular buffers, latency sampling, activations.

Behavioral parity with /root/reference/pupperv3_mjx/utils.py:19-69 (latency
buffers), :296-313 (activation map), :115-142 (fuzzy search). The latency
model — push the newest value into a column-circular buffer, then sample a
column by a lag distribution — is part of the env's RNG stream, so the
``jax.random.choice(axis=1, p=...)`` call is kept bit-identical.
"""

from __future__ import annotations

import difflib
from typing import Tuple

import jax
import jax.numpy as jnp


def circular_buffer_push_back(buffer: jax.Array, new_value: jax.Array) -> jax.Array:
    """Shift a (dim, depth) buffer one step and write new_value at [:, -1]."""
    return jnp.roll(buffer, shift=-1, axis=1).at[:, -1].set(new_value)


def circular_buffer_push_front(buffer: jax.Array, new_value: jax.Array) -> jax.Array:
    """Shift a (dim, depth) buffer one step and write new_value at [:, 0]."""
    return jnp.roll(buffer, shift=1, axis=1).at[:, 0].set(new_value)


def sample_lagged_value(
    rng: jax.Array,
    buffer_newest_first: jax.Array,
    new_value: jax.Array,
    distribution: jax.Array,
) -> Tuple[jax.Array, jax.Array]:
    """Push new_value, then sample a lagged column by ``distribution``.

    distribution[0] is the probability of zero latency. Returns the sampled
    (dim,) value and the updated buffer — models actuation/IMU transport
    delay (reference utils.py:49-69).
    """
    onehot = latency_onehot(rng, distribution)
    return apply_lagged_value(buffer_newest_first, new_value, onehot)


def latency_onehot(rng: jax.Array, distribution: jax.Array) -> jax.Array:
    """Draw the lag column as a one-hot vector.

    Bit-identical to the index ``jax.random.choice(rng, buf, axis=1, p=...)``
    would pick: choice draws its index the same way for scalar and array
    ``a`` (cumsum + searchsorted on the same key), so drawing the index
    alone preserves the env's parity-pinned RNG stream.
    """
    depth = distribution.shape[0]
    ind = jax.random.choice(rng, depth, p=distribution)
    return (jnp.arange(depth) == ind).astype(distribution.dtype)


def apply_lagged_value(
    buffer_newest_first: jax.Array, new_value: jax.Array, onehot: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Push new_value, then select the lag column by the one-hot weights —
    an elementwise multiply + depth-axis sum instead of ``jnp.take``
    (no batched dynamic gather) and instead of an einsum (a
    HIGHEST-precision einsum vmaps into a tiny batched GEMM). 0/1 weights
    select exactly: each column is scaled by 0.0 or
    1.0 and summing zeros is exact in f32."""
    buffer_newest_first = circular_buffer_push_front(buffer_newest_first, new_value)
    sampled = jnp.sum(
        buffer_newest_first * onehot.astype(buffer_newest_first.dtype)[None, :],
        axis=1,
    )
    return sampled, buffer_newest_first


def activation_fn_map(activation_name: str):
    """Name -> JAX activation fn (reference utils.py:296-313; KeyError on
    unknown names is part of the contract, see reference test_utils.py)."""
    return {
        "relu": jax.nn.relu,
        "sigmoid": jax.nn.sigmoid,
        "elu": jax.nn.elu,
        "tanh": jnp.tanh,
        "softmax": jax.nn.softmax,
    }[activation_name.lower()]


def fuzzy_search(obj, search_str: str, cutoff: float = 0.6):
    """Fuzzy-match attribute names of ``obj`` against ``search_str``;
    returns [(name, ratio)] sorted by ratio desc (reference utils.py:115-142)."""
    results = [
        (prop, difflib.SequenceMatcher(None, search_str, prop).ratio())
        for prop in dir(obj)
    ]
    results = [r for r in results if r[1] >= cutoff]
    results.sort(key=lambda x: x[1], reverse=True)
    return results
