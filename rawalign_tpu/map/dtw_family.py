"""Device equivalents of the full reference DTW family (dtw.hpp:21-29).

The production mapping path only ever calls the slanted-banded global
kernel (map/dtw_pallas.py / map/dtw.py — dtw.cpp:273-520's analog) and
the global traceback (native C, golden/dtw.py). This module completes
the family on device for SURVEY §2 row 12 parity:

  reference (dtw.cpp)                      device equivalent here
  ------------------------------------     ----------------------------
  DTW_global / DTW_global_slow             dtw_batch(semiglobal=False)
  DTW_semiglobal / DTW_semiglobal_slow     dtw_batch(semiglobal=True)
  DTW_global_diagonalbanded                dtw_batch(radius=r)
  DTW_global_slantedbanded[_antidiag...]   map/dtw.py, map/dtw_pallas.py
  DTW_global_tb / DTW_semiglobal_tb        native/rawalign_host.cpp +
                                           golden/dtw.py (host, like the
                                           reference's own CPU tb)

Formulation: anti-diagonal wavefront (`lax.scan` over n+m-1 diagonals,
two rotating carry buffers) — the same traversal the reference's
vectorized kernel uses (dtw.cpp:273-520), so every cell consumes the
exact float32 operand triple of the row-major reference code and the
scores match bit-for-bit; cells outside the diagonal band (optional
``radius``) read INF. The a-operand per diagonal is a uniform dynamic
slice of the reversed padded array (no gathers in the scan body).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

INF = np.float32(1e10)


@functools.partial(
    jax.jit, static_argnames=("semiglobal", "radius", "exclude_last")
)
def dtw_batch(
    a: jax.Array,  # (B, N) f32, padded
    b: jax.Array,  # (B, M) f32, padded
    n_a: jax.Array,  # (B,) int32 true lengths
    n_b: jax.Array,  # (B,) int32
    *,
    semiglobal: bool = False,
    radius: int | None = None,
    exclude_last: bool = False,
) -> jax.Array:
    """Batched full-matrix DTW costs (B,), global or semiglobal, with an
    optional diagonal band of half-width ``radius``."""
    B, N = a.shape
    M = b.shape[1]
    L = N + M

    def one(av, bv, n, m):
        # reversed-padded a: slice [L-1-d : L-1-d+M] yields a[d-j]; the
        # trailing pad keeps dynamic_slice from clamping the start on
        # early diagonals (d < M-1), which would silently shift values
        a_rev = jnp.concatenate(
            [jnp.zeros(M, jnp.float32), av[::-1], jnp.zeros(M, jnp.float32)]
        )
        j = jnp.arange(M, dtype=jnp.int32)

        def step(carry, d):
            prev, prev2 = carry  # diagonals d-1 and d-2, indexed by j
            i = d - j
            valid = (i >= 0) & (i < n) & (j < m)
            if radius is not None:
                valid &= jnp.abs(i - j) <= radius
            asel = jax.lax.dynamic_slice(a_rev, (L - 1 - d,), (M,))
            cost = jnp.abs(asel - bv)
            top = jnp.where(j < m, prev, INF)  # (i-1, j)
            left = jnp.concatenate([jnp.full(1, INF), prev[:-1]])  # (i, j-1)
            topleft = jnp.concatenate([jnp.full(1, INF), prev2[:-1]])
            best = jnp.minimum(jnp.minimum(top, left), topleft)
            first = (i == 0) & (j == 0)
            if semiglobal:
                free = i == 0
            else:
                free = first
            base = jnp.where(free, jnp.float32(0), best)
            cur = jnp.where(valid, base + cost, INF)
            return (cur, prev), cur

        init = (jnp.full(M, INF, jnp.float32), jnp.full(M, INF, jnp.float32))
        _, diags = jax.lax.scan(
            step, init, jnp.arange(L - 1, dtype=jnp.int32)
        )
        # cell (n-1, j) lives on diagonal d = n-1+j at position j
        last_row = diags[n - 1 + j, j]
        last_row = jnp.where(j < m, last_row, INF)
        if semiglobal:
            bj = jnp.argmin(last_row)  # first minimum (dtw.cpp:579-585)
            res = last_row[bj]
            if exclude_last:
                res = res - jnp.abs(av[n - 1] - bv[bj])
        else:
            res = last_row[m - 1]
            if exclude_last:
                res = res - jnp.abs(av[n - 1] - bv[m - 1])
        return res

    return jax.vmap(one)(a, b, n_a.astype(jnp.int32), n_b.astype(jnp.int32))
