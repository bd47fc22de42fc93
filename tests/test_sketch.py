"""Sketching tests: golden self-consistency and device-vs-golden parity."""

import numpy as np
import pytest

from rawalign_tpu.golden import sketch as gsketch
from rawalign_tpu.seeds import sketch as dsketch


def test_hash64_reference_values():
    # hash64 is invertible on the 32-bit domain -> no collisions on a range
    keys = np.arange(10_000, dtype=np.uint64)
    hashed = gsketch.hash64_np(keys, np.uint64(0xFFFFFFFF))
    assert np.unique(hashed).size == keys.size
    # python scalar path agrees with vectorized path
    for k in [0, 1, 12345, 0xFFFFFFFF, 0xABCDEF123]:
        assert gsketch.hash64(k) == int(
            gsketch.hash64_np(np.array([k], dtype=np.uint64), np.uint64(0xFFFFFFFF))[0]
        )


def test_quantize_bits():
    # q=9, lq=3: top-2 bits of the float bits, then 3 bits from below the
    # top 9 (rsketch.c:177-178)
    v = np.array([1.5, -0.25, 0.0, 2.0], dtype=np.float32)
    got = gsketch.quantize(v, 9, 3)
    bits = v.view(np.uint32)
    want = ((bits >> 30) << 3) | ((bits >> 23) & 7)
    np.testing.assert_array_equal(got, want)


def test_sketch_reg_manual():
    rng = np.random.default_rng(0)
    vals = rng.normal(0, 1, 50).astype(np.float32)
    seeds = gsketch.sketch_reg(vals, sid=3, strand=1, e=6, q=9, lq=3, k=6)
    assert seeds.shape[1] == 2
    # y encodes id, pos, strand
    ys = seeds[:, 1]
    assert np.all((ys >> np.uint64(32)) == 3)
    assert np.all((ys & np.uint64(1)) == 1)
    # x low 6 bits are the span k+e-1
    assert np.all((seeds[:, 0] & np.uint64(63)) == 6 + 6 - 1)


def test_device_sketch_matches_golden():
    rng = np.random.default_rng(1)
    B, NE = 4, 256
    e, q, lq = 6, 9, 3
    events = np.zeros((B, NE), dtype=np.float32)
    n_events = np.zeros(B, dtype=np.int32)
    for b in range(B):
        n = int(rng.integers(20, NE))
        # mix of distinct and near-identical consecutive values to exercise
        # the suppression filter
        v = rng.normal(0, 1, n).astype(np.float32)
        mask = rng.random(n) < 0.3
        v[mask] = (np.round(v[mask] * 2) / 2).astype(np.float32)
        events[b, :n] = v
        n_events[b] = n
    res = dsketch.sketch_events_batch(events, n_events, e=e, q=q, lq=lq)
    for b in range(B):
        want = gsketch.sketch_reg(
            events[b, : n_events[b]], sid=0, strand=0, e=e, q=q, lq=lq, k=6
        )
        want_hashes = (want[:, 0] >> np.uint64(6)).astype(np.uint32)
        want_pos = ((want[:, 1] & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(
            np.int32
        )
        got_valid = np.asarray(res.valid[b])
        got_hashes = np.asarray(res.hashes[b])[got_valid]
        got_pos = np.asarray(res.qpos[b])[got_valid]
        np.testing.assert_array_equal(got_hashes, want_hashes)
        np.testing.assert_array_equal(got_pos, want_pos)


def test_device_sketch_min_set_matches_golden():
    """Minimizer mode: the emitted seed SET must match golden (order and
    boundary-window duplicates may differ; anchors are re-sorted later)."""
    rng = np.random.default_rng(5)
    w, e, q, lq = 5, 7, 9, 3
    n = 400
    v = rng.normal(0, 1, n).astype(np.float32)
    res = dsketch.sketch_events_min_batch(
        v[None, :], np.array([n], dtype=np.int32), w=w, e=e, q=q, lq=lq
    )
    valid = np.asarray(res.valid[0])
    got = set(
        zip(
            np.asarray(res.hashes[0])[valid].tolist(),
            np.asarray(res.qpos[0])[valid].tolist(),
        )
    )
    want_seeds = gsketch.sketch_min(v, sid=0, strand=0, w=w, e=e, q=q, lq=lq, k=6)
    want = set(
        zip(
            (want_seeds[:, 0] >> np.uint64(6)).astype(np.uint32).tolist(),
            (
                (want_seeds[:, 1] & np.uint64(0xFFFFFFFF)) >> np.uint64(1)
            ).astype(np.int64).tolist(),
        )
    )
    # identical sets modulo first/last-window boundary quirks
    sym = got.symmetric_difference(want)
    # observed differences sit at the first/last windows only
    assert len(sym) <= max(8, len(want) // 10), (len(sym), len(want))
    assert len(got & want) >= 0.9 * len(want)


def test_device_sketch_e7_width():
    """e=7 packs 35 bits; hashes must still match golden (which packs in
    uint64) because hash64&0xffffffff reads only the low 32 bits."""
    rng = np.random.default_rng(2)
    e, q, lq = 7, 9, 3
    n = 200
    v = rng.normal(0, 1, n).astype(np.float32)
    res = dsketch.sketch_events_batch(
        v[None, :], np.array([n], dtype=np.int32), e=e, q=q, lq=lq
    )
    want = gsketch.sketch_reg(v, sid=0, strand=0, e=e, q=q, lq=lq, k=6)
    want_hashes = (want[:, 0] >> np.uint64(6)).astype(np.uint32)
    got = np.asarray(res.hashes[0])[np.asarray(res.valid[0])]
    np.testing.assert_array_equal(got, want_hashes)

