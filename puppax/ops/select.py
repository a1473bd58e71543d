"""Gather/scatter-free row selection for STATIC index sets.

Batched gathers/scatters under a large env ``vmap`` move far more memory
than the few rows they select. All physics-topology indices (body tree levels, dof addresses, pair
tables) are static model data, so every ``x[idx]`` / ``x.at[idx].set`` /
``x.at[idx].add`` on the hot path can be a constant one-hot contraction
instead: tiny dense (k, n) matmuls that XLA fuses freely.

Index arguments must be Python/numpy ints (NOT traced); results are exact
for float data, and duplicate indices in ``add_rows`` accumulate like
scatter-add.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

# One-hot contractions MUST run at full f32: a reduced-precision matmul
# (bf16, or TF32 on a GPU) rounds BOTH operands, so even a
# multiply-by-exactly-1.0 selection would silently quantize the selected
# values (qpos errors that NaN the physics within a few env steps).
_P = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=None)
def _onehot(idx: tuple, n: int) -> np.ndarray:
    sel = np.zeros((len(idx), n), np.float32)
    # np.intp: an empty tuple otherwise becomes a float64 array (IndexError)
    sel[np.arange(len(idx)), np.asarray(idx, np.intp)] = 1.0
    return sel


@functools.lru_cache(maxsize=None)
def _mask(idx: tuple, n: int) -> np.ndarray:
    mask = np.zeros((n,), np.float32)
    mask[np.asarray(idx, np.intp)] = 1.0
    return mask


def _as_tuple(idx) -> tuple:
    return tuple(int(i) for i in np.asarray(idx).reshape(-1))


# Selection backend: 'einsum' contracts as a matmul at HIGHEST precision;
# 'vpu' uses an elementwise broadcast-where-sum (exact by construction).
# Both are exact; which is faster depends on shapes — switchable for
# benchmarking via PUPPAX_SELECT_IMPL.
import os as _os

_IMPL = _os.environ.get("PUPPAX_SELECT_IMPL", "einsum")


def take_rows(x: jnp.ndarray, idx: Sequence[int]) -> jnp.ndarray:
    """x[idx] for static idx: (n, ...) -> (k, ...), gather-free."""
    t = _as_tuple(idx)
    if _IMPL == "vpu":
        sel = _onehot(t, x.shape[0]).astype(bool)  # np (k, n)
        selb = jnp.asarray(sel.reshape(sel.shape + (1,) * (x.ndim - 1)))
        picked = jnp.where(selb, x[None], jnp.zeros((), x.dtype))
        return jnp.sum(picked, axis=1)
    sel = jnp.asarray(_onehot(t, x.shape[0]), x.dtype)
    return jnp.einsum("kn,n...->k...", sel, x, precision=_P)


def _scatter(t: tuple, n: int, values: jnp.ndarray) -> jnp.ndarray:
    """One-hot scatter of (k, ...) values into (n, ...) (zeros elsewhere)."""
    if _IMPL == "vpu":
        sel = _onehot(t, n).astype(bool)  # (k, n)
        selb = jnp.asarray(
            sel.reshape(sel.shape + (1,) * (values.ndim - 1))
        )
        expanded = jnp.where(selb, values[:, None], jnp.zeros((), values.dtype))
        return jnp.sum(expanded, axis=0)
    sel = jnp.asarray(_onehot(t, n), values.dtype)
    return jnp.einsum("kn,k...->n...", sel, values, precision=_P)


def set_rows(x: jnp.ndarray, idx: Sequence[int], values: jnp.ndarray) -> jnp.ndarray:
    """x.at[idx].set(values) for static, duplicate-free idx."""
    t = _as_tuple(idx)
    n = x.shape[0]
    keep = 1.0 - jnp.asarray(_mask(t, n), x.dtype).reshape(
        (n,) + (1,) * (x.ndim - 1)
    )
    return x * keep + _scatter(t, n, values)


def add_rows(x: jnp.ndarray, idx: Sequence[int], values: jnp.ndarray) -> jnp.ndarray:
    """x.at[idx].add(values) for static idx (duplicates accumulate)."""
    t = _as_tuple(idx)
    return x + _scatter(t, x.shape[0], values)
