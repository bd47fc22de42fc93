"""Single source of truth for the stage1 device->host packed layout.

Stage 1 (events + sketch + index-lookup bounds) returns ONE packed f32
array per round, so everything rides one fetch. Both the single-device
engine (map/engine.py) and the distributed engine
(parallel/dist_engine.py) MUST produce and consume this exact layout;
round 2 shipped with the two drifting apart (the distributed stage1
kept an older three-block layout), which silently zeroed every anchor
qpos and broke the multi-chip PAF. This module is the only place the
layout is defined.

Layout, per row (int blocks bitcast into the f32 payload)::

    [ ev_values (NE, optional) | lo (NS) | qc (NS) | scalars (4) ]

where ``qc`` packs (qpos, count) into one int32 as ``(qpos << 16) |
count``: qpos < 2**15 (bounded by max_events_per_chunk) and count <=
0xFFFF (bounded by max_occ), validated by :func:`validate_bounds` at
engine construction so misconfiguration fails loudly instead of
corrupting anchors via the sign-extending unpack shift.

The four scalar columns are, in order: n_events, n_events_dropped,
n_occ_dropped (seed hits dropped by the occurrence cap), and
n_compact_dropped (valid seeds beyond the compaction width).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

#: qpos rides the high 16 bits through a signed int32; the unpack is an
#: arithmetic shift, so qpos must stay below 2**15 to keep the sign bit
#: clear.
QPOS_LIMIT = 1 << 15
#: count occupies the low 16 bits.
COUNT_LIMIT = 1 << 16
#: trailing int32 scalar columns (see module docstring for the order).
N_SCALARS = 4


def validate_bounds(max_events_per_chunk: int, max_occ: int) -> None:
    """Fail loudly on configurations the packed codec cannot represent.

    Called from MappingEngine.__init__: both bounds are user-settable
    (config max_events_per_chunk, CLI --max_occ) and exceeding either
    would silently corrupt anchors on unpack.
    """
    if not 0 < max_events_per_chunk < QPOS_LIMIT:
        raise ValueError(
            f"max_events_per_chunk={max_events_per_chunk} out of range for "
            f"the stage1 (qpos, count) packing: need 0 < value < {QPOS_LIMIT}"
        )
    if not 0 < max_occ < COUNT_LIMIT:
        raise ValueError(
            f"max_occ={max_occ} out of range for the stage1 (qpos, count) "
            f"packing: need 0 < value < {COUNT_LIMIT}"
        )


def pack_qc(qpos, count):
    """Pack (qpos, count) int32 arrays into one int32 word.

    Works on both jnp and np arrays (pure arithmetic). Inputs must obey
    :func:`validate_bounds`.
    """
    return (qpos << 16) | count


def unpack_qc(qc):
    """Inverse of :func:`pack_qc` -> (qpos, count)."""
    return qc >> 16, qc & 0xFFFF


def hits_first_perm(count):
    """Stable permutation putting nonzero-count seed columns first.

    Zero-count slots emit no anchors, so applying this to the compacted
    seed blocks cannot change the expanded anchor order — but it makes
    nonzero counts a contiguous column PREFIX, the invariant behind the
    engine's adaptive stage1 prefix download. BOTH engines must apply
    it (single source here) or the cross-engine bit-identity test
    fails.
    """
    import jax
    import jax.numpy as jnp

    flag = (count == 0).astype(jnp.int32)
    idx = jnp.broadcast_to(
        jnp.arange(count.shape[1], dtype=jnp.int32)[None, :], count.shape
    )
    _f, perm = jax.lax.sort((flag, idx), dimension=1, num_keys=1)
    return perm


def pack_stage1(ev_values, lo, qc, scalars, *, include_events: bool):
    """Assemble the device-side packed stage1 output (jnp arrays).

    ``ev_values`` (B, NE) f32; ``lo``/``qc`` (B, NS) int32; ``scalars``
    (B, N_SCALARS) int32. Imports jax lazily so the codec stays
    importable host-side without jax.
    """
    import jax
    import jax.numpy as jnp

    bc = lambda x: jax.lax.bitcast_convert_type(
        x.astype(jnp.int32), jnp.float32
    )
    parts = [ev_values] if include_events else []
    parts += [bc(lo), bc(qc), bc(scalars)]
    return jnp.concatenate(parts, axis=1)


def pack_stage1_fused(ev_values, lo, qc, scalars, scores, preds, *,
                      include_events: bool):
    """Fused stage1+chain layout: the plain stage1 blocks followed by
    the chain-DP outputs ``scores`` (B, A) f32 and ``preds`` (B, A)
    int32 (bitcast). The host replays hit expansion from (lo, qc) and
    consumes scores/preds only when its replayed anchor count fits A.
    """
    import jax
    import jax.numpy as jnp

    bc = lambda x: jax.lax.bitcast_convert_type(
        x.astype(jnp.int32), jnp.float32
    )
    parts = [ev_values] if include_events else []
    parts += [bc(lo), bc(qc), bc(scalars), scores.astype(jnp.float32),
              bc(preds)]
    return jnp.concatenate(parts, axis=1)


class Stage1FusedHost(NamedTuple):
    stage1: "Stage1Host"
    scores: np.ndarray  # (B, A) f32
    preds: np.ndarray  # (B, A) int32


def unpack_stage1_fused(packed: np.ndarray, *, ne: int, ns: int, a: int,
                        events_on_host: bool) -> Stage1FusedHost:
    base = (ne if events_on_host else 0) + 2 * ns + N_SCALARS
    if packed.shape[1] != base + 2 * a:
        raise ValueError(
            f"fused stage1 packed width {packed.shape[1]} != expected "
            f"{base + 2 * a} (ne={ne}, ns={ns}, a={a}, "
            f"events_on_host={events_on_host}) — producer/consumer "
            "layout drift"
        )
    s1 = unpack_stage1(
        packed[:, :base], ne=ne, ns=ns, events_on_host=events_on_host
    )
    scores = packed[:, base : base + a]
    preds = packed.view(np.int32)[:, base + a :]
    return Stage1FusedHost(stage1=s1, scores=scores, preds=preds)


class Stage1Host(NamedTuple):
    """Host view of one round's unpacked stage1 output."""

    ev_values: np.ndarray | None  # (B, NE) f32, None when device-resident
    lo: np.ndarray  # (B, NS) int32 — global index-table offsets
    qpos: np.ndarray  # (B, NS) int32
    count: np.ndarray  # (B, NS) int32 — 0 for invalid/over-cap seeds
    n_events: np.ndarray  # (B,) int32
    n_ev_dropped: np.ndarray  # (B,) int32
    n_occ_dropped: np.ndarray  # (B,) int32
    n_compact_dropped: np.ndarray  # (B,) int32


def unpack_stage1(packed: np.ndarray, *, ne: int, ns: int,
                  events_on_host: bool) -> Stage1Host:
    """Decode the fetched packed f32 array back into host arrays."""
    expect = (ne if events_on_host else 0) + 2 * ns + N_SCALARS
    if packed.shape[1] != expect:
        raise ValueError(
            f"stage1 packed width {packed.shape[1]} != expected {expect} "
            f"(ne={ne}, ns={ns}, events_on_host={events_on_host}) — "
            "producer/consumer layout drift"
        )
    pi = packed.view(np.int32)
    base = ne if events_on_host else 0
    ev_values = packed[:, :ne] if events_on_host else None
    lo = pi[:, base : base + ns]
    qc = pi[:, base + ns : base + 2 * ns]
    qpos, count = unpack_qc(qc)
    return Stage1Host(
        ev_values=ev_values,
        lo=lo,
        qpos=qpos,
        count=count,
        n_events=pi[:, -4],
        n_ev_dropped=pi[:, -3],
        n_occ_dropped=pi[:, -2],
        n_compact_dropped=pi[:, -1],
    )
