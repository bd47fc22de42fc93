"""Batched event detection on device (JAX).

Data-parallel reformulation of the reference event detector
(src/revent.c):

* prefix sums / t-statistics: vectorized window reductions over the whole
  batch (revent.c:22-75 computes them sequentially per read);
* the dual-detector peak state machine (revent.c:77-138) is inherently
  sequential in the sample axis -> ``lax.scan`` over samples, vectorized
  over the read batch; each step can emit up to one peak per detector;
* peak compaction and event means are gathers over the prefix sums;
* per-chunk z-normalization (revent.c:179-184).

Shapes are static: (B, L) signal chunks in, (B, NE) padded events out with
per-read counts. Per-read chunk lengths are dynamic via masks.

Numerical note: prefix sums are accumulated in the reference's exact
sequential float32 order (see _sequential_prefix_sums) so that t-stats and
event values bit-match the golden model; only the final t = |d|/sqrt(v/w)
uses float32 sqrt/div where the C code routes through double, a <=2-ulp
difference that can flip a peak only when a t-stat sits within rounding
of a threshold.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

FLT_MAX = np.float32(np.finfo(np.float32).max)
FLT_MIN = np.float32(np.finfo(np.float32).tiny)


class EventBatch(NamedTuple):
    values: jax.Array  # (B, NE) float32 normalized event means, zero-padded
    n_events: jax.Array  # (B,) int32
    n_dropped: jax.Array  # (B,) int32 events lost to the NE cap


def _sequential_prefix_sums(sig: jax.Array, length: jax.Array):
    """Float32 prefix sums with STRICTLY SEQUENTIAL accumulation order,
    bit-matching the reference's C loop (revent.c:22-32).

    XLA's parallel cumsum associates differently; the reference's
    downstream t-statistics difference nearby prefix values (catastrophic
    cancellation), so peak positions are sensitive to the exact
    accumulation order. A ``lax.scan`` over samples reproduces it exactly
    and is fused with the peak scan's pipeline.

    Returns (ps, pss) of shape (B, L+1).
    """
    B, L = sig.shape
    idx = jnp.arange(L)
    s = jnp.where(idx[None, :] < length[:, None], sig, 0.0)

    def step(carry, xs):
        x, x2 = xs
        ps, pss = carry
        ps = ps + x
        # Note: x2 is pre-squared OUTSIDE the scan; computing x*x here lets
        # XLA fuse it into an FMA (single rounding), which breaks bit parity
        # with the C code's separate multiply-then-add (revent.c:30).
        pss = pss + x2
        return (ps, pss), (ps, pss)

    init = (jnp.zeros(B, jnp.float32), jnp.zeros(B, jnp.float32))
    s2 = s * s
    _, (ps_t, pss_t) = jax.lax.scan(step, init, (s.T, s2.T), unroll=2)
    z = jnp.zeros((B, 1), jnp.float32)
    ps = jnp.concatenate([z, ps_t.T], axis=1)
    pss = jnp.concatenate([z, pss_t.T], axis=1)
    return ps, pss


def _window_tstat(
    ps: jax.Array, pss: jax.Array, length: jax.Array, w: int
) -> jax.Array:
    """t-statistic from prefix sums (revent.c:34-75): index i compares
    sig[i-w:i] against sig[i:i+w] (valid for w <= i <= len-w, zero
    outside). Elementwise float32 ops in the reference's order."""
    B = ps.shape[0]
    L = ps.shape[1] - 1
    idx = jnp.arange(L)
    iw = jnp.maximum(idx - w, 0)
    ipw = jnp.minimum(idx + w, L)
    bidx = jnp.arange(B)[:, None]
    sum1 = ps[bidx, idx[None, :]] - ps[bidx, iw[None, :]]
    sumsq1 = pss[bidx, idx[None, :]] - pss[bidx, iw[None, :]]
    sum2 = ps[bidx, ipw[None, :]] - ps[bidx, idx[None, :]]
    sumsq2 = pss[bidx, ipw[None, :]] - pss[bidx, idx[None, :]]
    w32 = jnp.float32(w)
    mean1 = sum1 / w32
    mean2 = sum2 / w32
    var = sumsq1 / w32 - mean1 * mean1 + sumsq2 / w32 - mean2 * mean2
    var = jnp.maximum(var, FLT_MIN)
    # The reference divides the clamped variance by w in float (revent.c:69)
    # which lands in the denormal range when var == FLT_MIN; XLA flushes
    # denormals to zero, which would make t infinite and poison the peak
    # state machine with NaNs. Clamping the quotient at FLT_MIN keeps t
    # finite-and-huge exactly like the C code (the magnitude of these
    # zero-variance t values is numerical garbage in both).
    t = jnp.abs(mean2 - mean1) / jnp.sqrt(jnp.maximum(var / w32, FLT_MIN))
    # valid range: w <= i <= length - w (revent.c:50), zero elsewhere
    ok = (idx[None, :] >= w) & (idx[None, :] <= length[:, None] - w)
    ok &= length[:, None] >= 2 * w
    return jnp.where(ok, t, 0.0)


def _peak_scan(
    t1: jax.Array,
    t2: jax.Array,
    length: jax.Array,
    threshold1: float,
    threshold2: float,
    w1: int,
    w2: int,
    peak_height: float,
):
    """Dual-detector peak state machine (revent.c:77-138) as a scan over
    samples. Returns (B, L, 2) int32 emitted peak positions (-1 = none);
    detector 0 = short (dominates), 1 = long."""
    B, L = t1.shape
    ph = jnp.float32(peak_height)
    thr = (jnp.float32(threshold1), jnp.float32(threshold2))
    win = (w1, w2)

    def make_state():
        return dict(
            masked_to=jnp.zeros(B, jnp.int32),
            peak_pos=jnp.full(B, -1, jnp.int32),
            peak_value=jnp.full(B, FLT_MAX, jnp.float32),
            valid_peak=jnp.zeros(B, jnp.bool_),
        )

    def step(carry, inp):
        i, cv1, cv2 = inp
        s0, s1 = carry
        cvs = (cv1, cv2)
        emitted = []
        new_states = [None, None]
        # detector 0 first; its firing masks detector 1 (revent.c:112-120)
        states = [s0, s1]
        for k in (0, 1):
            st = states[k]
            cv = cvs[k]
            active = (st["masked_to"] < i) & (i < length)
            no_peak = st["peak_pos"] == -1

            # CASE 1: no recorded maximum yet
            deeper = cv < st["peak_value"]
            qualifies = (cv - st["peak_value"]) > ph
            c1_value = jnp.where(
                deeper | qualifies, cv, st["peak_value"]
            )
            c1_pos = jnp.where(qualifies, i, st["peak_pos"])

            # CASE 2: inside a peak
            upd = cv > st["peak_value"]
            c2_value = jnp.where(upd, cv, st["peak_value"])
            c2_pos = jnp.where(upd, i, st["peak_pos"])
            becomes_valid = ((c2_value - cv) > ph) & (c2_value > thr[k])
            c2_valid = st["valid_peak"] | becomes_valid
            fire = c2_valid & ((i - c2_pos) > (win[k] // 2))

            value = jnp.where(no_peak, c1_value, jnp.where(fire, cv, c2_value))
            pos = jnp.where(no_peak, c1_pos, jnp.where(fire, -1, c2_pos))
            valid = jnp.where(no_peak, st["valid_peak"], c2_valid & ~fire)
            emit = jnp.where(active & ~no_peak & fire, c2_pos, -1)

            # apply only where active
            new_st = dict(
                masked_to=st["masked_to"],
                peak_pos=jnp.where(active, pos, st["peak_pos"]),
                peak_value=jnp.where(active, value, st["peak_value"]),
                valid_peak=jnp.where(active, valid, st["valid_peak"]),
            )
            emitted.append(jnp.where(active, emit, -1))
            new_states[k] = new_st

            if k == 0:
                # short detector dominating the long one (revent.c:112-120):
                # in CASE 2, if the short peak value exceeds its threshold,
                # mask + reset the long detector.
                dominate = active & ~no_peak & (c2_value > thr[0])
                s1_ = states[1]
                states = [
                    new_st,
                    dict(
                        masked_to=jnp.where(
                            dominate, c2_pos + win[0], s1_["masked_to"]
                        ),
                        peak_pos=jnp.where(dominate, -1, s1_["peak_pos"]),
                        peak_value=jnp.where(
                            dominate, FLT_MAX, s1_["peak_value"]
                        ),
                        valid_peak=jnp.where(
                            dominate, False, s1_["valid_peak"]
                        ),
                    ),
                ]
            else:
                states = [states[0], new_st]

        return (states[0], states[1]), jnp.stack(emitted, axis=-1)

    xs = (
        jnp.arange(L, dtype=jnp.int32),
        t1.T,
        t2.T,
    )
    (_, _), peaks = jax.lax.scan(step, (make_state(), make_state()), xs)
    # peaks: (L, B, 2) -> (B, L, 2)
    return jnp.transpose(peaks, (1, 0, 2))


def _compact_peaks(peaks_lb2: jax.Array, max_peaks: int):
    """Flatten (B, L, 2) emitted positions into (B, MAXP) in emission order
    (sample-major, detector-minor), -1 padded.

    Compaction via a (invalid, index) permutation sort + gather instead
    of a scatter: the (invalid, index) pairs are unique, so the result is
    deterministic and order-preserving."""
    B, L, _ = peaks_lb2.shape
    flat = peaks_lb2.reshape(B, L * 2)
    valid = flat >= 0
    n = jnp.sum(valid, axis=1).astype(jnp.int32)
    idx0 = jnp.broadcast_to(
        jnp.arange(L * 2, dtype=jnp.int32)[None, :], (B, L * 2)
    )
    _f, perm = jax.lax.sort(
        ((~valid).astype(jnp.int32), idx0), dimension=1, num_keys=1
    )
    comp = jnp.take_along_axis(flat, perm[:, :max_peaks], axis=1)
    in_range = jnp.arange(max_peaks)[None, :] < n[:, None]
    return jnp.where(in_range, comp, -1), n


@functools.partial(
    jax.jit,
    static_argnames=(
        "w1",
        "w2",
        "threshold1",
        "threshold2",
        "peak_height",
        "max_events",
    ),
)
def detect_events_batch(
    sig: jax.Array,
    length: jax.Array,
    *,
    w1: int = 3,
    w2: int = 6,
    threshold1: float = 4.30265,
    threshold2: float = 2.57058,
    peak_height: float = 1.0,
    max_events: int = 2048,
) -> EventBatch:
    """Batched detect_events (revent.c:190-210).

    sig: (B, L) float32, zero-padded; length: (B,) int32 valid samples.
    """
    sig = sig.astype(jnp.float32)
    B, L = sig.shape
    ps, pss = _sequential_prefix_sums(sig, length)
    t1 = _window_tstat(ps, pss, length, w1)
    t2 = _window_tstat(ps, pss, length, w2)
    peaks_emitted = _peak_scan(
        t1, t2, length, threshold1, threshold2, w1, w2, peak_height
    )
    peaks, n_peaks = _compact_peaks(peaks_emitted, max_events)

    # gen_events (revent.c:140-188): events [0..n_ev-2] are prefix-sum means
    # between consecutive peaks; the final event runs to s_len. n_ev counts
    # peaks[1:] in (0, s_len).
    pk_valid = peaks >= 0
    interior = (
        pk_valid
        & (peaks > 0)
        & (peaks < length[:, None])
        & (jnp.arange(max_events)[None, :] >= 1)
    )
    n_ev = jnp.where(
        n_peaks > 0, 1 + jnp.sum(interior, axis=1), 0
    ).astype(jnp.int32)
    n_ev_capped = jnp.minimum(n_ev, max_events)

    pk = jnp.where(pk_valid, peaks, 0)
    bidx = jnp.arange(B)[:, None]
    ps_at_pk = ps[bidx, pk]
    prev_pk = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), pk[:, :-1]], axis=1)
    ps_prev = ps[bidx, prev_pk]
    ev_idx = jnp.arange(max_events)[None, :]
    # event pi (< n_ev-1): (ps[pk[pi]] - ps[pk[pi-1]]) / (pk[pi] - pk[pi-1])
    denom = (pk - prev_pk).astype(jnp.float32)
    mid_events = (ps_at_pk - ps_prev) / jnp.where(denom == 0, 1.0, denom)
    # final event: from pk[n_ev-2] (or 0 if n_ev==1) to s_len
    last_i = jnp.maximum(n_ev_capped - 2, -1)
    last_pk = jnp.where(
        last_i >= 0, pk[jnp.arange(B), jnp.maximum(last_i, 0)], 0
    )
    ps_last = ps[jnp.arange(B), last_pk]
    ps_end = ps[jnp.arange(B), length]
    final_event = (ps_end - ps_last) / jnp.maximum(
        (length - last_pk).astype(jnp.float32), 1.0
    )
    is_final = ev_idx == (n_ev_capped - 1)[:, None]
    in_range = ev_idx < n_ev_capped[:, None]
    events = jnp.where(
        is_final, final_event[:, None], jnp.where(in_range, mid_events, 0.0)
    )
    events = jnp.where(in_range, events, 0.0)

    # z-normalize per read (revent.c:179-184). The reference computes
    # var = E[x^2] - mean^2 in DOUBLE; in float32 that formula loses
    # ~11 bits to cancellation (x ~ 95 pA, x^2 ~ 9e3), drifting every
    # normalized event by up to ~3e-5 vs the compiled C. The device path
    # stays in f32, so use the cancellation-free two-pass form E[(x-mean)^2],
    # which lands within a few f32 ulp of the C double result.
    cnt = jnp.maximum(n_ev_capped, 1).astype(jnp.float32)
    mean = jnp.sum(events, axis=1) / cnt
    centered = jnp.where(in_range, events - mean[:, None], 0.0)
    var = jnp.sum(centered * centered, axis=1) / cnt
    std = jnp.sqrt(jnp.maximum(var, 0.0))
    std = jnp.where(std == 0, 1.0, std)
    norm = (events - mean[:, None]) / std[:, None]
    norm = jnp.where(in_range, norm, 0.0)

    n_dropped = (n_ev - n_ev_capped) + jnp.maximum(
        n_peaks - max_events, 0
    )
    return EventBatch(values=norm, n_events=n_ev_capped, n_dropped=n_dropped)
