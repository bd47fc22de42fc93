"""ctypes bindings for the native host library (native/rawalign_host.cpp).

Builds the library on first use if a compiler is available; every entry
point has a pure-Python fallback (the golden model), so the framework
works without a toolchain — just slower on host-side index builds.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
_SO = os.path.join(_NATIVE_DIR, "librawalign_host.so")


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL | None:
    src = os.path.join(_NATIVE_DIR, "rawalign_host.cpp")
    if not os.path.exists(src):
        return None
    # one builder at a time (test workers and engines load concurrently);
    # make rebuilds only a missing or stale library
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR], check=True, capture_output=True
            )
        except (subprocess.CalledProcessError, FileNotFoundError):
            if not os.path.exists(_SO):
                return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    u32 = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.ra_sketch_reg.restype = ctypes.c_int64
    lib.ra_sketch_reg.argtypes = [
        f32, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u32, i64p,
    ]
    lib.ra_sketch_min.restype = ctypes.c_int64
    lib.ra_sketch_min.argtypes = [
        f32, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, u32, i64p,
    ]
    lib.ra_gen_peaks.restype = ctypes.c_int64
    lib.ra_gen_peaks.argtypes = [
        f32, f32, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, u32,
    ]
    i32arr = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8arr = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.ra_dtw_banded.restype = ctypes.c_float
    lib.ra_dtw_banded.argtypes = [
        f32, ctypes.c_int64, f32, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
    ]
    lib.ra_dtw_banded_batch.restype = None
    lib.ra_dtw_banded_batch.argtypes = [
        f32, i64p, i64p, f32, i64p, i64p, i32arr, u8arr, ctypes.c_int64, f32,
    ]
    lib.ra_dtw_global_tb.restype = ctypes.c_int64
    lib.ra_dtw_global_tb.argtypes = [
        f32, ctypes.c_int64, f32, ctypes.c_int64,
        i32arr, f32, ctypes.POINTER(ctypes.c_float),
    ]
    if hasattr(lib, "ra_znorm_sums"):
        lib.ra_znorm_sums.restype = None
        lib.ra_znorm_sums.argtypes = [
            f32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ]
    if hasattr(lib, "ra_pack_seeds"):
        u64arr = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
        lib.ra_pack_seeds.restype = None
        lib.ra_pack_seeds.argtypes = [u32, u32, ctypes.c_int64, u64arr]
    if hasattr(lib, "ra_pore_gather"):
        lib.ra_pore_gather.restype = None
        lib.ra_pore_gather.argtypes = [i32arr, ctypes.c_int64, f32, f32]
        lib.ra_znorm_apply.restype = None
        lib.ra_znorm_apply.argtypes = [
            f32, ctypes.c_int64, ctypes.c_double, ctypes.c_double,
        ]
    if hasattr(lib, "ra_chain_dp"):
        lib.ra_chain_dp.restype = None
        lib.ra_chain_dp.argtypes = [
            i32arr, i32arr, i32arr, i32arr,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, f32, i32arr,
        ]
    if hasattr(lib, "ra_gen_events"):
        lib.ra_gen_events.restype = ctypes.c_int64
        lib.ra_gen_events.argtypes = [u32, ctypes.c_int64, f32,
                                      ctypes.c_int64, f32]
    if hasattr(lib, "ra_detect_events"):
        lib.ra_detect_events.restype = ctypes.c_int64
        lib.ra_detect_events.argtypes = [
            f32, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_float, f32,
        ]
    if hasattr(lib, "ra_expand_round"):
        lib.ra_expand_round.restype = None
        lib.ra_expand_round.argtypes = [
            i32arr, i32arr, i32arr, u8arr, i64p, i64p, i64p, i64p, i32arr,
            u32, u32, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            i32arr, i32arr, i32arr, i32arr, i64p,
        ]
    if hasattr(lib, "ra_chains_from_dp"):
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.ra_chains_from_dp.restype = ctypes.c_int64
        lib.ra_chains_from_dp.argtypes = [
            i32arr, i32arr, i32arr, f32, i32arr, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32arr, i64p, i32arr, f64,
        ]
    if hasattr(lib, "ra_round_chains"):
        f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
        lib.ra_round_chains.restype = ctypes.c_int64
        lib.ra_round_chains.argtypes = [
            # seg, tgt, qry, scores, preds, n_anch, gate, B, A
            i32arr, i32arr, i32arr, f32, i32arr, i32arr, u8arr,
            ctypes.c_int64, ctypes.c_int64,
            # min_chaining_score; num_best, min_num, disable, sort_for_dtw,
            # use_dtw, border_global, fill_full; band_frac
            ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double,
            # segbase, ev_base
            i64p, i64p,
            # ch_read, ch_score, ch_seg, ch_start_t, ch_end_t, ch_nanch,
            # ch_aoff, ch_at, ch_aq, ch_doff, descs, out_counts
            i32arr, f64, i32arr, i32arr, i32arr, i32arr, i64p, u32, u32,
            i64p, i64p, i64p,
        ]
        lib.ra_round_finalize.restype = None
        lib.ra_round_finalize.argtypes = [
            i32arr, f64, i32arr, i32arr, i32arr, i32arr, i64p, u32, u32,
            i64p, ctypes.c_int64, ctypes.c_int64, f32, ctypes.c_int64,
            ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_int,
            u8arr, i32arr, i32arr, i32arr, i32arr, i32arr, u32, u32,
            i32arr, f64, f64, f32, f32, f32,
            i64p, i64p, i64p, i64p, i64p,
        ]
    return lib


def available() -> bool:
    return load() is not None


def znorm_sums_available() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "ra_znorm_sums")


def znorm_sums(values: np.ndarray) -> tuple[float, float]:
    """(sum, sum_of_squares) as the reference's sequential double
    left-fold (rsig.cpp:28-35) — order-exact, unlike np.sum's pairwise
    accumulation."""
    lib = load()
    values = np.ascontiguousarray(values, dtype=np.float32)
    s = ctypes.c_double()
    s2 = ctypes.c_double()
    lib.ra_znorm_sums(values, values.size, ctypes.byref(s), ctypes.byref(s2))
    return s.value, s2.value


def pack_seeds_available() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "ra_pack_seeds")


def pack_seeds(h: np.ndarray, ps: np.ndarray) -> np.ndarray:
    """(h << 32 | ps) as uint64 in one C pass."""
    lib = load()
    h = np.ascontiguousarray(h, dtype=np.uint32)
    ps = np.ascontiguousarray(ps, dtype=np.uint32)
    out = np.empty(h.size, dtype=np.uint64)
    lib.ra_pack_seeds(h, ps, h.size, out)
    return out


def pore_gather_available() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "ra_pore_gather")


def pore_gather(kmers: np.ndarray, pore_vals: np.ndarray) -> np.ndarray:
    """out[i] = pore_vals[kmers[i]] in one C pass."""
    lib = load()
    kmers = np.ascontiguousarray(kmers, dtype=np.int32)
    pore_vals = np.ascontiguousarray(pore_vals, dtype=np.float32)
    out = np.empty(kmers.size, dtype=np.float32)
    lib.ra_pore_gather(kmers, kmers.size, pore_vals, out)
    return out


def znorm_apply(vals: np.ndarray, mean: float, std: float) -> None:
    """In-place (v - mean)/std with the reference's double arithmetic
    and a single rounding to float32 (rsig.cpp:37-38)."""
    lib = load()
    lib.ra_znorm_apply(vals, vals.size, float(mean), float(std))


def sketch_reg(values: np.ndarray, e: int, q: int, lq: int):
    """(hashes uint32, positions int64) of plain-mode seeds."""
    lib = load()
    values = np.ascontiguousarray(values, dtype=np.float32)
    n = values.size
    out_h = np.empty(max(n, 1), dtype=np.uint32)
    out_p = np.empty(max(n, 1), dtype=np.int64)
    cnt = lib.ra_sketch_reg(values, n, e, q, lq, out_h, out_p)
    return out_h[:cnt].copy(), out_p[:cnt].copy()


def sketch_min(values: np.ndarray, w: int, e: int, q: int, lq: int):
    lib = load()
    values = np.ascontiguousarray(values, dtype=np.float32)
    n = values.size
    out_h = np.empty(max(n, 1), dtype=np.uint32)
    out_p = np.empty(max(n, 1), dtype=np.int64)
    cnt = lib.ra_sketch_min(values, n, w, e, q, lq, out_h, out_p)
    return out_h[:cnt].copy(), out_p[:cnt].copy()


def dtw_banded(a: np.ndarray, b: np.ndarray, radius: int, exclude_last: bool) -> float:
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.float32)
    b = np.ascontiguousarray(b, dtype=np.float32)
    return float(
        lib.ra_dtw_banded(a, a.size, b, b.size, int(radius), int(exclude_last))
    )


def dtw_banded_batch(pairs) -> np.ndarray:
    """pairs: list of (a, b, radius, exclude_last). Returns (T,) costs."""
    lib = load()
    T = len(pairs)
    a_pool = np.concatenate(
        [np.asarray(p[0], np.float32) for p in pairs]
    ) if T else np.zeros(0, np.float32)
    b_pool = np.concatenate(
        [np.asarray(p[1], np.float32) for p in pairs]
    ) if T else np.zeros(0, np.float32)
    a_len = np.array([p[0].size for p in pairs], dtype=np.int64)
    b_len = np.array([p[1].size for p in pairs], dtype=np.int64)
    a_off = np.zeros(T, dtype=np.int64)
    b_off = np.zeros(T, dtype=np.int64)
    np.cumsum(a_len[:-1], out=a_off[1:])
    np.cumsum(b_len[:-1], out=b_off[1:])
    radius = np.array([p[2] for p in pairs], dtype=np.int32)
    excl = np.array([p[3] for p in pairs], dtype=np.uint8)
    out = np.zeros(T, dtype=np.float32)
    if T:
        lib.ra_dtw_banded_batch(
            np.ascontiguousarray(a_pool),
            a_off, a_len,
            np.ascontiguousarray(b_pool),
            b_off, b_len,
            radius, excl, T, out,
        )
    return out


def dtw_global_tb(a: np.ndarray, b: np.ndarray):
    """Full-matrix global DTW traceback: (ij (L, 2) int32, diff (L,)
    f32, cost). Path-identical to golden dtw_global_tb; C loop instead
    of a per-cell Python loop (the --dtw-output-cigar hot path,
    rmap.cpp:715-717)."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.float32)
    b = np.ascontiguousarray(b, dtype=np.float32)
    cap = a.size + b.size
    out_ij = np.empty((max(cap, 1), 2), dtype=np.int32)
    out_diff = np.empty(max(cap, 1), dtype=np.float32)
    cost = ctypes.c_float()
    ln = lib.ra_dtw_global_tb(
        a, a.size, b, b.size, out_ij, out_diff, ctypes.byref(cost)
    )
    return out_ij[:ln], out_diff[:ln], float(cost.value)


def gen_events(peaks: np.ndarray, ps: np.ndarray, s_len: int) -> np.ndarray:
    """Events from peaks + prefix sums (revent.c:140-188), bit-identical
    to golden gen_events."""
    lib = load()
    peaks = np.ascontiguousarray(peaks, dtype=np.uint32)
    ps = np.ascontiguousarray(ps, dtype=np.float32)
    out = np.empty(peaks.size + 1, dtype=np.float32)
    n = lib.ra_gen_events(peaks, peaks.size, ps, s_len, out)
    return out[:n].copy()


def events_available() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "ra_detect_events")


def detect_events(
    sig: np.ndarray, *, w1: int, w2: int, threshold1: float,
    threshold2: float, peak_height: float,
) -> np.ndarray:
    """Whole event detector for one chunk in C (revent.c:190-210),
    bit-identical to golden prefix_sums+tstat+gen_peaks+gen_events."""
    lib = load()
    sig = np.ascontiguousarray(sig, dtype=np.float32)
    out = np.empty(sig.size + 2, dtype=np.float32)
    n = lib.ra_detect_events(
        sig, sig.size, w1, w2, threshold1, threshold2, peak_height, out
    )
    return out[:n].copy()


def chain_dp_available() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "ra_chain_dp")


def chain_dp(
    seg: np.ndarray,  # (B, A) int32, sorted (segment, target, query)
    tgt: np.ndarray,
    qry: np.ndarray,
    n_anchors: np.ndarray,  # (B,) int32
    *,
    window: int,
    e: int,
    max_gap: int,
    max_target_gap: int,
    max_skips: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Host chaining DP (C), bit-identical to the device kernel
    (map/chain.py) and the golden model within the bounded window.
    Returns (scores (B, A) f32, preds (B, A) i32)."""
    lib = load()
    seg = np.ascontiguousarray(seg, dtype=np.int32)
    tgt = np.ascontiguousarray(tgt, dtype=np.int32)
    qry = np.ascontiguousarray(qry, dtype=np.int32)
    n_anchors = np.ascontiguousarray(n_anchors, dtype=np.int32)
    B, A = seg.shape
    scores = np.empty((B, A), dtype=np.float32)
    preds = np.empty((B, A), dtype=np.int32)
    lib.ra_chain_dp(
        seg, tgt, qry, n_anchors, B, A, window, e,
        max_gap, max_target_gap, max_skips, scores, preds,
    )
    return scores, preds


def expand_round_available() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "ra_expand_round")


def expand_round(
    h_lo, h_qpos, h_count, live, offsets, carried_lists,
    val_id, val_ps, A, seg_b, tgt_b, qry_b, n_anch,
):
    """C anchor expansion (map/anchors.py's ordering contract,
    bit-identical outputs). Returns (max_used, max_true, dropped)."""
    lib = load()
    B, NS = h_count.shape
    car_cnt = np.zeros(B, np.int32)
    segs: list[np.ndarray] = []
    ts: list[np.ndarray] = []
    qs: list[np.ndarray] = []
    for i in sorted(carried_lists):
        if not live[i]:
            continue
        cs, ct, cq = carried_lists[i]
        car_cnt[i] = cs.size
        segs.append(np.asarray(cs, np.int64))
        ts.append(np.asarray(ct, np.int64))
        qs.append(np.asarray(cq, np.int64))
    z = np.zeros(0, np.int64)
    car_seg = np.ascontiguousarray(np.concatenate(segs)) if segs else z
    car_tpos = np.ascontiguousarray(np.concatenate(ts)) if ts else z
    car_qpos = np.ascontiguousarray(np.concatenate(qs)) if qs else z
    stats = np.zeros(3, np.int64)
    lib.ra_expand_round(
        np.ascontiguousarray(h_lo, np.int32),
        np.ascontiguousarray(h_qpos, np.int32),
        np.ascontiguousarray(h_count, np.int32),
        np.ascontiguousarray(live, np.uint8),
        np.ascontiguousarray(offsets, np.int64),
        car_seg, car_tpos, car_qpos, car_cnt,
        np.ascontiguousarray(val_id, np.uint32),
        np.ascontiguousarray(val_ps, np.uint32),
        B, NS, A, seg_b, tgt_b, qry_b, n_anch, stats,
    )
    return int(stats[0]), int(stats[1]), int(stats[2])


def chains_from_dp_available() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "ra_chains_from_dp")


def chains_from_dp_raw(
    seg: np.ndarray,
    tgt: np.ndarray,
    qry: np.ndarray,
    scores: np.ndarray,
    preds: np.ndarray,
    n: int,
    *,
    min_chaining_score: float,
    num_best_chains: int,
    min_num_anchors: int,
    disable_filter: bool,
):
    """C end-candidate selection + traceback (rmap.cpp:486-505,130-173).
    Returns (anchor_idx (total,) i32 in end->start order, chain_off
    (n_chains+1,) i64, end_idx (n_chains,) i32, score (n_chains,) f64) —
    identical chain set/order to postprocess.chains_from_dp."""
    lib = load()
    seg = np.ascontiguousarray(seg[:n], dtype=np.int32)
    tgt = np.ascontiguousarray(tgt[:n], dtype=np.int32)
    qry = np.ascontiguousarray(qry[:n], dtype=np.int32)
    scores = np.ascontiguousarray(scores[:n], dtype=np.float32)
    preds = np.ascontiguousarray(preds[:n], dtype=np.int32)
    cap = max(n, 1)
    anchor_idx = np.empty(cap, dtype=np.int32)
    chain_off = np.empty(cap + 1, dtype=np.int64)
    end_idx = np.empty(cap, dtype=np.int32)
    score = np.empty(cap, dtype=np.float64)
    nc = lib.ra_chains_from_dp(
        seg, tgt, qry, scores, preds, n,
        float(min_chaining_score), int(num_best_chains),
        int(min_num_anchors), int(disable_filter),
        anchor_idx, chain_off, end_idx, score,
    )
    total = int(chain_off[nc]) if nc else 0
    return anchor_idx[:total], chain_off[: nc + 1], end_idx[:nc], score[:nc]


def round_tail_available() -> bool:
    lib = load()
    return lib is not None and hasattr(lib, "ra_round_chains")


def round_chains(
    seg, tgt, qry, scores, preds, n_anch, gate, A, *,
    min_chaining_score, num_best_chains, min_num_anchors, disable_filter,
    sort_for_dtw, use_dtw, border_global, fill_full, band_frac,
    segbase, ev_base,
):
    """Batched traceback + chain records + DTW tile descriptors for one
    engine round (ra_round_chains; see the C doc comment). Returns
    (read, score, seg, start_t, end_t, nanch, aoff, at, aq, doff, descs)
    trimmed to the actual counts."""
    lib = load()
    B = gate.size
    total = int(n_anch.sum())
    cap_ch = max(total // max(min_num_anchors, 1) + B, 8)
    cap_a = max(total, 8)
    cap_d = max(total + B, 8) if use_dtw else 8
    ch_read = np.empty(cap_ch, np.int32)
    ch_score = np.empty(cap_ch, np.float64)
    ch_seg = np.empty(cap_ch, np.int32)
    ch_start_t = np.empty(cap_ch, np.int32)
    ch_end_t = np.empty(cap_ch, np.int32)
    ch_nanch = np.empty(cap_ch, np.int32)
    ch_aoff = np.empty(cap_ch + 1, np.int64)
    ch_at = np.empty(cap_a, np.uint32)
    ch_aq = np.empty(cap_a, np.uint32)
    ch_doff = np.empty(cap_ch + 1, np.int64)
    descs = np.empty((cap_d, 6), np.int64)
    counts = np.zeros(3, np.int64)
    nc = lib.ra_round_chains(
        seg, tgt, qry, scores, preds, n_anch, gate,
        B, int(A), float(min_chaining_score), int(num_best_chains),
        int(min_num_anchors), int(disable_filter), int(sort_for_dtw),
        int(use_dtw), int(border_global), int(fill_full), float(band_frac),
        segbase, ev_base,
        ch_read, ch_score, ch_seg, ch_start_t, ch_end_t, ch_nanch,
        ch_aoff, ch_at, ch_aq, ch_doff, descs.reshape(-1), counts,
    )
    nc, na, nd = int(counts[0]), int(counts[1]), int(counts[2])
    return (
        ch_read[:nc], ch_score[:nc], ch_seg[:nc], ch_start_t[:nc],
        ch_end_t[:nc], ch_nanch[:nc], ch_aoff[: nc + 1], ch_at[:na],
        ch_aq[:na], ch_doff[: nc + 1], descs[:nd],
    )


def round_finalize(
    rec, B, costs, *,
    use_dtw, border_global, match_bonus, dtw_min_score,
    min_bestmap_ratio, min_meanmap_ratio, min_chain_anchor,
):
    """Batched B&B replay + primary chains + MAPQ + decision + emit
    fields + carried anchors (ra_round_finalize). ``rec`` is
    round_chains' return tuple. Returns a dict of per-read arrays plus
    (car_off, car_seg, car_t, car_q)."""
    lib = load()
    (ch_read, ch_score, ch_seg, ch_start_t, ch_end_t, ch_nanch,
     ch_aoff, ch_at, ch_aq, ch_doff, descs) = rec
    n_chains = ch_read.size
    costs = np.ascontiguousarray(costs, np.float32)
    dec = np.zeros(B, np.uint8)
    nc = np.zeros(B, np.int32)
    seg = np.zeros(B, np.int32)
    st_t = np.zeros(B, np.int32)
    en_t = np.zeros(B, np.int32)
    na0 = np.zeros(B, np.int32)
    qs = np.zeros(B, np.uint32)
    qe = np.zeros(B, np.uint32)
    mapq = np.zeros(B, np.int32)
    s1 = np.zeros(B, np.float64)
    s2 = np.zeros(B, np.float64)
    sm = np.zeros(B, np.float32)
    at = np.zeros(B, np.float32)
    aq = np.zeros(B, np.float32)
    cap_car = max(int(ch_aoff[-1]) if n_chains else 0, 1)
    car_off = np.zeros(B + 1, np.int64)
    car_seg = np.empty(cap_car, np.int64)
    car_t = np.empty(cap_car, np.int64)
    car_q = np.empty(cap_car, np.int64)
    tot = np.zeros(1, np.int64)
    lib.ra_round_finalize(
        ch_read, ch_score, ch_seg, ch_start_t, ch_end_t, ch_nanch,
        ch_aoff, ch_at, ch_aq, ch_doff, n_chains, B, costs, costs.size,
        int(use_dtw), int(border_global), float(match_bonus),
        float(dtw_min_score), float(min_bestmap_ratio),
        float(min_meanmap_ratio), int(min_chain_anchor),
        dec, nc, seg, st_t, en_t, na0, qs, qe, mapq, s1, s2, sm, at, aq,
        car_off, car_seg, car_t, car_q, tot,
    )
    t = int(tot[0])
    return {
        "decision": dec, "nc": nc, "seg": seg, "start_t": st_t,
        "end_t": en_t, "nanch0": na0, "q_start": qs, "q_end": qe,
        "mapq": mapq, "s1": s1, "s2": s2, "sm": sm, "at": at, "aq": aq,
        "car_off": car_off, "car_seg": car_seg[:t], "car_t": car_t[:t],
        "car_q": car_q[:t],
    }


def gen_peaks(
    t1: np.ndarray, t2: np.ndarray, s_len: int,
    threshold1: float, threshold2: float, w1: int, w2: int, peak_height: float,
) -> np.ndarray:
    lib = load()
    t1 = np.ascontiguousarray(t1[:s_len], dtype=np.float32)
    t2 = np.ascontiguousarray(t2[:s_len], dtype=np.float32)
    out = np.empty(max(s_len, 1), dtype=np.uint32)
    cnt = lib.ra_gen_peaks(
        t1, t2, s_len, threshold1, threshold2, w1, w2, peak_height, out
    )
    return out[:cnt].copy()
