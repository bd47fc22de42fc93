"""Batched event sketching on device (JAX).

Data-parallel form of the reference's sketch modes (src/rsketch.c): the
adjacent-similar suppression + rolling pack are a single short
``lax.scan`` over the event axis (sequential carry: last kept value,
packed accumulator, ring of recent kept positions), everything else —
bit-level quantization, the hash, the minimizer window filter — is
vectorized. (A one-launch GPU kernel of the scan was 18x faster alone on
an H100 but no faster end to end, where stage 1 overlaps host work; see
PERF.md.)

Width note: the packed code spans quant_bit*e bits (up to 50 for e=10),
but the reference hashes it with hash64 masked to 32 bits
(rsketch.c:6-15,255): the first hash step is ``(~key + (key<<21)) & (2^32-1)``,
which reads only bits 0..31 (for ~key) and 0..10 (for key<<21) of the
packed code — the hash depends ONLY on its low 32 bits. The device pack
therefore tracks a uint32 accumulator and matches the reference hashes
bit-for-bit without 64-bit integers.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

LAST_SIG_DIFF = np.float32(0.3)
RI_MASK_SIGNAL = np.float32(3.402823466e32)


class SeedBatch(NamedTuple):
    hashes: jax.Array  # (B, NE) uint32 seed hash values
    qpos: jax.Array  # (B, NE) int32 event index of the seed
    valid: jax.Array  # (B, NE) bool


def _u32(x: int) -> jnp.ndarray:
    return jnp.uint32(x & 0xFFFFFFFF)


def hash64_u32(key: jax.Array) -> jax.Array:
    """hash64 masked to 32 bits (rsketch.c:6-15) in uint32 arithmetic."""
    key = key.astype(jnp.uint32)
    key = (~key) + (key << _u32(21))
    key = key ^ (key >> _u32(24))
    key = key + (key << _u32(3)) + (key << _u32(8))
    key = key ^ (key >> _u32(14))
    key = key + (key << _u32(2)) + (key << _u32(4))
    key = key ^ (key >> _u32(28))
    key = key + (key << _u32(31))
    return key


def quantize_u32(values: jax.Array, q: int, lq: int) -> jax.Array:
    """Bit-level quantization (rsketch.c:178): top-2 bits of the float's
    raw encoding next to lq bits taken from below the top q bits."""
    bits = jax.lax.bitcast_convert_type(
        values.astype(jnp.float32), jnp.uint32
    )
    mask_lq = _u32((1 << lq) - 1)
    return ((bits >> _u32(30)) << _u32(lq)) | ((bits >> _u32(32 - q)) & mask_lq)


def _sketch_scan(events, n_events, e, q, lq):
    """Shared scan: returns (hashes, emit mask, newest pos, oldest pos,
    kept-rank) per event slot. A seed at slot i hashes the last e kept
    events; newest pos = i (plain-mode y, rsketch.c:253), oldest pos =
    the kept event e-1 keeps earlier (min-mode y, rsketch.c:184-190)."""
    B, NE = events.shape
    quant_bit = lq + 2
    nbits = quant_bit * e
    mask_events = _u32((1 << nbits) - 1 if nbits < 32 else 0xFFFFFFFF)
    tq = quantize_u32(events, q, lq)
    idx = jnp.arange(NE, dtype=jnp.int32)
    in_range = idx[None, :] < n_events[:, None]

    def step(carry, xs):
        last_val, acc, kept_cnt, ring = carry
        val, tqv, valid, i = xs
        # C semantics (rsketch.c:243): index 0 bypasses the similarity
        # check; the comparison value l_sigpos starts at index 0 whether
        # or not event 0 was kept, and updates only on keeps.
        similar = jnp.abs(val - last_val) < LAST_SIG_DIFF
        masked = val == RI_MASK_SIGNAL
        keep = valid & ~masked & ((i == 0) | ~similar)
        new_last = jnp.where(keep, val, last_val)
        new_acc = jnp.where(
            keep, ((acc << _u32(quant_bit)) | tqv) & mask_events, acc
        )
        new_cnt = kept_cnt + keep.astype(jnp.int32)
        # ring of the last e kept positions (ring[..., -1] = newest)
        new_ring = jnp.where(
            keep[:, None],
            jnp.concatenate([ring[:, 1:], jnp.full((B, 1), i)], axis=1),
            ring,
        )
        emit = keep & (new_cnt >= e)
        return (new_last, new_acc, new_cnt, new_ring), (
            new_acc,
            emit,
            new_ring[:, 0],
            new_cnt,
        )

    init = (
        events[:, 0].astype(jnp.float32),
        jnp.zeros(B, jnp.uint32),
        jnp.zeros(B, jnp.int32),
        jnp.zeros((B, e), jnp.int32),
    )
    _, (accs, emits, oldest, cnts) = jax.lax.scan(
        step,
        init,
        (events.T, tq.T, in_range.T, idx),
        unroll=2,
    )
    hashes = hash64_u32(accs.T)
    return (
        jnp.where(emits.T, hashes, 0),
        emits.T,
        jnp.broadcast_to(idx[None, :], (B, NE)),
        oldest.T,
        cnts.T,
    )


@functools.partial(jax.jit, static_argnames=("e", "q", "lq"))
def sketch_events_batch(
    events: jax.Array,
    n_events: jax.Array,
    *,
    e: int,
    q: int,
    lq: int,
) -> SeedBatch:
    """Plain-mode sketching (ri_sketch_reg, rsketch.c:223-274): one seed
    per kept event once e events are packed; position = newest event."""
    hashes, emit, newest, _oldest, _cnt = _sketch_scan(
        events, n_events, e, q, lq
    )
    return SeedBatch(hashes=hashes, qpos=newest, valid=emit)


@functools.partial(jax.jit, static_argnames=("w", "e", "q", "lq"))
def sketch_events_min_batch(
    events: jax.Array,
    n_events: jax.Array,
    *,
    w: int,
    e: int,
    q: int,
    lq: int,
) -> SeedBatch:
    """Minimizer-window sketching (ri_sketch_min, rsketch.c:146-221),
    set semantics.

    The reference emits, for every window of w consecutive seeds, the
    minimum-hash seed plus same-hash duplicates, in a particular order
    with first-window special casing. Downstream anchors are re-sorted,
    so only the emitted SET matters: seed s is kept iff its hash equals
    the window minimum of at least one w-window of consecutive seeds
    covering s (identical to the reference's set modulo boundary-window
    quirks). Positions report the OLDEST event of the e-window, matching
    min-mode's buffer semantics (rsketch.c:184-190).
    """
    B, NE = events.shape
    hashes, emit, _newest, oldest, cnt = _sketch_scan(
        events, n_events, e, q, lq
    )
    BIG = jnp.uint32(0xFFFFFFFF)
    h = jnp.where(emit, hashes, BIG)
    # compact seeds by emission rank so "w consecutive seeds" is a
    # contiguous window
    rank = jnp.where(emit, cnt - e, 0)  # 0-based seed rank
    bidx = jnp.arange(B)[:, None]
    comp = jnp.full((B, NE), BIG).at[
        bidx, jnp.where(emit, rank, NE - 1)
    ].min(h, mode="drop")
    wmin = comp
    for d in range(1, w):
        shifted = jnp.concatenate(
            [jnp.full((B, d), BIG), comp[:, :-d]], axis=1
        )
        wmin = jnp.minimum(wmin, shifted)
    # wmin[r'] = min over compact ranks (r'-w+1 .. r'); seed at rank r is
    # a minimizer iff comp[r] == wmin[r'] for some r' in [r, r+w-1]
    is_min = jnp.zeros((B, NE), bool)
    for d in range(w):
        wm_at = jnp.concatenate(
            [wmin[:, d:], jnp.full((B, d), BIG)], axis=1
        )
        is_min = is_min | (comp == wm_at)
    picked = emit & jnp.take_along_axis(
        is_min & (comp != BIG), rank, axis=1
    )
    return SeedBatch(hashes=hashes, qpos=oldest, valid=picked)