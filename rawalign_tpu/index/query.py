"""Batched seed lookup on device: searchsorted + bounded gather.

Replaces the reference's per-seed khash probe loop (ri_idx_get +
rmap.cpp:371-391) with two vectorized binary searches over the sorted key
table and a (B, NE, MAX_OCC) gather.

Occurrence policy: seeds with more than MAX_OCC hits are dropped ENTIRELY
(and counted). The reference has no cap, but ultra-frequent seeds carry
almost no positional information and its own (disabled) occurrence filter
(rmap.cpp:28-51) took the same stance; truncating their hit lists instead
was measured to bias anchors toward low target positions and hurt
accuracy.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class BucketedKeys(NamedTuple):
    """Key table reorganized for a cheap device lookup: UNIQUE sorted
    hashes + per-hash (first-position, count) into the value table, and
    a 2^b-entry bucket offset table over the hash top bits — the
    device analog of the reference's bucketed khash
    (rawindex.cpp:194-246). Lookup cost is counted in dependent
    gathers: bucket + K in-bucket binary-search steps + 3 answer
    gathers, vs 2 * log2(S) for the two plain searchsorteds (~3x
    fewer at real table sizes)."""

    ku: jax.Array  # (U,) uint32 unique sorted hashes
    kidx: jax.Array  # (U,) int32 first position in the full key table
    kcnt: jax.Array  # (U,) int32 occurrence count
    boff: jax.Array  # (2^b + 1,) int32 bucket start offsets into ku
    n_steps: int  # binary-search iterations (covers the largest bucket)
    b_bits: int


def build_bucketed_keys(keys: np.ndarray, b_bits: int = 14) -> BucketedKeys:
    keys = np.asarray(keys, dtype=np.uint32)
    ku, kidx, kcnt = np.unique(keys, return_index=True, return_counts=True)
    starts = (
        np.arange(1 << b_bits, dtype=np.uint64) << np.uint64(32 - b_bits)
    ).astype(np.uint32)
    boff = np.empty((1 << b_bits) + 1, dtype=np.int64)
    boff[:-1] = np.searchsorted(ku, starts, side="left")
    boff[-1] = ku.size
    max_span = int(np.diff(boff).max()) if ku.size else 0
    n_steps = int(np.ceil(np.log2(max_span + 1))) if max_span > 0 else 0
    return BucketedKeys(
        ku=jnp.asarray(ku),
        kidx=jnp.asarray(kidx.astype(np.int32)),
        kcnt=jnp.asarray(kcnt.astype(np.int32)),
        boff=jnp.asarray(boff.astype(np.int32)),
        n_steps=n_steps,
        b_bits=b_bits,
    )


def lookup_bounds(
    bk: BucketedKeys, h: jax.Array
) -> tuple[jax.Array, jax.Array]:
    """(lo, count) for every query hash — identical to
    ``searchsorted(keys, h, 'left')`` / ``'right' - 'left'`` over the
    full key table (missing hashes get count 0; their lo is 0, which
    callers must not read — the engine's host expansion selects on
    count > 0). Jit-traceable; ``h`` any shape uint32."""
    ku, kidx, kcnt, boff = bk.ku, bk.kidx, bk.kcnt, bk.boff
    if ku.shape[0] == 0:
        z = jnp.zeros(h.shape, jnp.int32)
        return z, z
    bidx = (h >> np.uint32(32 - bk.b_bits)).astype(jnp.int32)
    lo = boff[bidx]
    hi = boff[bidx + 1]
    span = hi - lo
    umax = ku.shape[0] - 1
    for _ in range(bk.n_steps):  # in-bucket lower_bound, fixed depth
        half = span >> 1
        mid = lo + half
        kv = ku[jnp.minimum(mid, umax)]
        go = (span > 0) & (kv < h)
        lo = jnp.where(go, mid + 1, lo)
        span = jnp.where(go, span - half - 1, half)
    safe = jnp.minimum(lo, umax)
    eq = (lo < hi) & (ku[safe] == h)
    cnt = jnp.where(eq, kcnt[safe], 0).astype(jnp.int32)
    glo = jnp.where(eq, kidx[safe], 0).astype(jnp.int32)
    return glo, cnt


class HitBatch(NamedTuple):
    t_id: jax.Array  # (B, NE, MAX_OCC) int32 target sequence id
    t_pos: jax.Array  # (B, NE, MAX_OCC) int32 target signal position
    strand: jax.Array  # (B, NE, MAX_OCC) int32 0/1
    q_pos: jax.Array  # (B, NE, MAX_OCC) int32 query event index
    valid: jax.Array  # (B, NE, MAX_OCC) bool
    n_dropped: jax.Array  # (B,) int32 hits lost to the MAX_OCC cap


@functools.partial(jax.jit, static_argnames=("max_occ",))
def query_seeds(
    keys: jax.Array,  # (S,) uint32 sorted index hashes
    val_id: jax.Array,  # (S,) uint32
    val_ps: jax.Array,  # (S,) uint32 pos<<1|strand
    hashes: jax.Array,  # (B, NE) uint32 query seed hashes
    qpos: jax.Array,  # (B, NE) int32 query event positions
    seed_valid: jax.Array,  # (B, NE) bool
    *,
    max_occ: int = 16,
) -> HitBatch:
    B, NE = hashes.shape
    flat = hashes.reshape(-1)
    lo = jnp.searchsorted(keys, flat, side="left").reshape(B, NE)
    hi = jnp.searchsorted(keys, flat, side="right").reshape(B, NE)
    count = (hi - lo).astype(jnp.int32)
    over_cap = count > max_occ
    o = jnp.arange(max_occ, dtype=jnp.int32)
    gidx = lo[..., None].astype(jnp.int32) + o
    hit_valid = (
        seed_valid[..., None]
        & ~over_cap[..., None]
        & (o[None, None, :] < count[..., None])
    )
    gidx = jnp.clip(gidx, 0, max(keys.shape[0] - 1, 0))
    ids = val_id[gidx].astype(jnp.int32)
    ps = val_ps[gidx]
    # target position: low-31 bits of pos field (rmap.cpp:326,387)
    t_pos = ((ps >> jnp.uint32(1)) & jnp.uint32(0x7FFFFFFF)).astype(jnp.int32)
    strand = (ps & jnp.uint32(1)).astype(jnp.int32)
    dropped = jnp.sum(
        jnp.where(seed_valid & over_cap, count, 0), axis=1
    )
    return HitBatch(
        t_id=ids,
        t_pos=t_pos,
        strand=strand,
        q_pos=jnp.broadcast_to(qpos[..., None], (B, NE, max_occ)),
        valid=hit_valid,
        n_dropped=dropped.astype(jnp.int32),
    )
