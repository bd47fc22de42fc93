"""Batched chaining DP on device (JAX).

Data-parallel reformulation of the reference chaining DP (rmap.cpp:427-507). The
reference iterates anchors per (target, strand) list, scanning up to 5000
predecessors with two early-exit heuristics (a target-gap break and a
skip counter). Here all anchor lists of a read are flattened into one
array sorted by (segment = target*2+strand, target_pos, query_pos) and a
``lax.scan`` walks the anchor axis once, examining a bounded predecessor
window vectorized across the batch.

Semantics within the window are EXACT, including the skip counter: the
candidate scores, the prefix-max "running best" that defines which
candidates count as improvements, the skip-count prefix sum and both
break conditions are associative prefix computations over the window
axis (no inner sequential loop).

Deviation from the reference (documented, deliberate): the reference's
5000-anchor predecessor window exists because a CPU walks it serially
with early exits; here the window is a vector axis, so we bound it at
``window`` (default 64) — wider than the skip-counter (25) typically
allows the reference to look anyway. Cross-segment slots in the window
are inert, exactly like the reference's per-list iteration.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# np scalar, not jnp: a module-level jnp constant initializes the XLA
# backend at import, which breaks jax.distributed.initialize() ordering
NEG = np.float32(-3e38)


class ChainScores(NamedTuple):
    scores: jax.Array  # (B, A) float32 chaining scores
    preds: jax.Array  # (B, A) int32 predecessor index (== i for none)


@functools.partial(
    jax.jit,
    static_argnames=("window", "e", "max_gap", "max_target_gap", "max_skips"),
)
def chain_dp_batch(
    seg: jax.Array,  # (B, A) int32 segment id (target*2+strand), sorted
    target: jax.Array,  # (B, A) int32 target positions
    query: jax.Array,  # (B, A) int32 query positions
    n_anchors: jax.Array,  # (B,) int32
    *,
    window: int = 64,
    e: int = 6,
    max_gap: int = 2000,
    max_target_gap: int = 5000,
    max_skips: int = 25,
) -> ChainScores:
    B, A = seg.shape
    W = window
    init_score = jnp.float32(e)

    # front-pad with sentinel rows so the window slice is always in bounds
    def pad(x, fill):
        return jnp.concatenate(
            [jnp.full((B, W), fill, x.dtype), x], axis=1
        )

    seg_p = pad(seg, jnp.int32(-1))
    tgt_p = pad(target, jnp.int32(0))
    qry_p = pad(query, jnp.int32(0))

    def step(carry, i):
        f_p = carry  # (B, W + A) scores, front W slots = NEG
        # window rows j = i-W .. i-1 live at padded positions i .. i+W-1;
        # reverse so axis position d-1 corresponds to predecessor distance d
        wseg = jax.lax.dynamic_slice(seg_p, (0, i), (B, W))[:, ::-1]
        wtgt = jax.lax.dynamic_slice(tgt_p, (0, i), (B, W))[:, ::-1]
        wqry = jax.lax.dynamic_slice(qry_p, (0, i), (B, W))[:, ::-1]
        wf = jax.lax.dynamic_slice(f_p, (0, i), (B, W))[:, ::-1]

        ct = jax.lax.dynamic_slice(tgt_p, (0, i + W), (B, 1))
        cq = jax.lax.dynamic_slice(qry_p, (0, i + W), (B, 1))
        cs = jax.lax.dynamic_slice(seg_p, (0, i + W), (B, 1))

        seg_ok = wseg == cs
        cont = seg_ok & ((wqry == cq) | (wtgt == ct))  # rmap.cpp:456-457
        brk_gap = seg_ok & ~cont & (wtgt + max_target_gap < ct)  # :458
        qdiff = cq - wqry
        tdiff = ct - wtgt
        cont2 = seg_ok & ~cont & ~brk_gap & (qdiff < 0)  # :465
        # a gap break stops the reference's loop: every slot at or past the
        # first same-segment break is dead
        brk_cum = jnp.cumsum(brk_gap.astype(jnp.int32), axis=1) > 0
        processed = seg_ok & ~cont & ~cont2 & ~brk_cum

        matching = jnp.minimum(jnp.minimum(tdiff, qdiff), e).astype(jnp.float32)
        gap_len = jnp.abs(tdiff - qdiff)
        gap_scale = jnp.where(
            tdiff > 0,
            qdiff.astype(jnp.float32) / tdiff.astype(jnp.float32),
            jnp.float32(1.0),
        )
        gates = (gap_len < max_gap) & (gap_scale < 5.0) & (gap_scale > 0.75)
        cand = jnp.where(gates, wf + matching, jnp.float32(0.0))  # :472-474
        cand_eff = jnp.where(processed, cand, NEG)

        # running best before each slot: max(init, cummax_exclusive(cand))
        cmax = jax.lax.associative_scan(jnp.maximum, cand_eff, axis=1)
        cmax_excl = jnp.concatenate(
            [jnp.full((B, 1), NEG), cmax[:, :-1]], axis=1
        )
        running = jnp.maximum(init_score, cmax_excl)
        improved = processed & (cand_eff > running)  # :476

        # skip counter: +1 per processed non-improving slot, -1 per
        # improvement; the loop breaks AFTER a non-improving slot pushes
        # the count past max_skips (rmap.cpp:479-483)
        delta = jnp.where(
            processed, jnp.where(improved, -1, 1), 0
        ).astype(jnp.int32)
        skips = jnp.cumsum(delta, axis=1)
        skip_brk = processed & ~improved & (skips > max_skips)
        skip_cut = (
            jnp.cumsum(skip_brk.astype(jnp.int32), axis=1)
            - skip_brk.astype(jnp.int32)
        ) > 0  # exclusive: the breaking slot itself was processed
        alive = processed & ~skip_cut
        cand_alive = jnp.where(alive, cand_eff, NEG)

        best = jnp.max(cand_alive, axis=1)
        best_d = jnp.argmax(cand_alive, axis=1) + 1  # first max == C's pred
        score_i = jnp.maximum(init_score, best)
        has_pred = best > init_score
        pred_i = jnp.where(has_pred, i - best_d, i)

        f_p = jax.lax.dynamic_update_slice(
            f_p, score_i[:, None], (0, i + W)
        )
        return f_p, (score_i, pred_i.astype(jnp.int32))

    f_init = jnp.concatenate(
        [jnp.full((B, W), NEG), jnp.zeros((B, A), jnp.float32)], axis=1
    )
    _, (scores_t, preds_t) = jax.lax.scan(
        step, f_init, jnp.arange(A, dtype=jnp.int32), unroll=2
    )
    scores = scores_t.T
    preds = preds_t.T
    in_range = jnp.arange(A)[None, :] < n_anchors[:, None]
    return ChainScores(
        scores=jnp.where(in_range, scores, 0.0),
        preds=jnp.where(in_range, preds, jnp.arange(A)[None, :]),
    )
