"""Small-matrix dense linear algebra tuned for the physics engine.

XLA's generic Cholesky lowers tiny (nv x nv) factorizations into enormous
blocked loop nests (~50k HLO instructions for 18x18 under vmap) that
dominate both compile and run time. For the engine's
fixed, tiny, well-conditioned SPD systems (mass matrix + armature;
Newton Hessian) a fully unrolled left-looking Cholesky compiles to a few
hundred fused elementwise ops and vmaps cleanly over the env batch.

HBM note: the factor is built as a list of (…, n) column vectors and
stacked once at the end — no (…, n, n) intermediate is materialized per
elimination step (the right-looking rank-1-update form re-writes the full
trailing matrix n times, which at a 4k env batch costs hundreds of MB of
HBM traffic per solve).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def mv(A: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """A @ x for a small (n, m) matrix as a fused multiply-reduce.

    The broadcast form fuses into one exact-f32 elementwise kernel, with
    no matmul precision to pin.
    """
    return jnp.sum(A * x[None, :], axis=-1)


def mtv(A: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """A.T @ y for a small (n, m) matrix (fused multiply-reduce)."""
    return jnp.sum(A * y[:, None], axis=0)


def mm_small(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """A @ B for small matrices as a fused multiply-reduce."""
    return jnp.sum(A[..., :, :, None] * B[..., None, :, :], axis=-2)


def cholesky_columns(A: jnp.ndarray) -> list:
    """Columns of the lower Cholesky factor of a small SPD matrix.

    ``A`` must be symmetric (rows are read in place of columns). Returns
    a list of n arrays of shape ``A.shape[:-1]`` == (..., n).
    """
    n = A.shape[-1]
    cols = []
    for k in range(n):
        acc = A[..., k, :]  # row k == column k by symmetry
        for j in range(k):
            acc = acc - cols[j][..., k, None] * cols[j]
        pivot = jnp.sqrt(jnp.maximum(acc[..., k], 1e-30))
        col = acc / pivot[..., None]
        col = jnp.where(np.arange(n) >= k, col, jnp.zeros((), A.dtype))
        cols.append(col)
    return cols


def cholesky(A: jnp.ndarray) -> jnp.ndarray:
    """Lower Cholesky factor of a small SPD matrix (n x n, unrolled)."""
    return jnp.stack(cholesky_columns(A), axis=-1)


def _solve_lower_cols(cols: list, b: jnp.ndarray) -> list:
    """Forward substitution L y = b on the column representation."""
    n = len(cols)
    ys = []
    for k in range(n):
        acc = b[..., k]
        for j in range(k):
            acc = acc - cols[j][..., k] * ys[j]
        ys.append(acc / cols[k][..., k])
    return ys


def _solve_upper_t_cols(cols: list, ys: list) -> jnp.ndarray:
    """Back substitution L^T x = y on the column representation."""
    n = len(cols)
    xs = [None] * n
    for k in range(n - 1, -1, -1):
        acc = ys[k]
        for j in range(n - 1, k, -1):
            acc = acc - cols[k][..., j] * xs[j]
        xs[k] = acc / cols[k][..., k]
    return jnp.stack(xs, axis=-1)


def solve_lower(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve L y = b with L lower triangular (unrolled forward subst.)."""
    n = L.shape[-1]
    cols = [L[..., :, k] for k in range(n)]
    return jnp.stack(_solve_lower_cols(cols, b), axis=-1)


def solve_upper_t(L: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Solve L^T x = y with L lower triangular (unrolled back subst.)."""
    n = L.shape[-1]
    cols = [L[..., :, k] for k in range(n)]
    return _solve_upper_t_cols(cols, [y[..., k] for k in range(n)])


def cho_solve(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b given L = cholesky(A)."""
    return solve_upper_t(L, solve_lower(L, b))


def spd_solve(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve a small SPD system A x = b via unrolled Cholesky (the factor
    never materializes as an (n, n) matrix — column vectors end to end)."""
    cols = cholesky_columns(A)
    ys = _solve_lower_cols(cols, b)
    return _solve_upper_t_cols(cols, ys)
