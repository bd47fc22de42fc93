"""Host side of the batched banded DTW: size classes, descriptors, dispatch.

The sparse border constraint turns chains into many small (a, b) DTW
problems ("tiles", rmap.cpp:248-293), with a the longer sequence
(dtw.cpp:283-292). Tiles whose sides fit the device caps are grouped
into power-of-two size classes and sent to the device as int32
descriptors into a value pool that is already resident there
(``map.dtw``); larger tiles run on the native host C implementation of
the same band geometry (the golden model without the native library)
while the device works.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses

import numpy as np

from rawalign_tpu.map import dtw as ddtw


def _pow2_at_least(x: int, lo: int) -> int:
    """Smallest power of two >= max(x, lo).

    Compile-shape parameters are quantized to powers of two: the
    multi-class dispatch's jit signature contains every class's
    (dpw, Tp), so pow2 buckets keep the set of compiled programs small
    and stable after the first few rounds."""
    p = lo
    while p < x:
        p *= 2
    return p


@dataclasses.dataclass
class PendingDtw:
    n: int
    small_idx: list
    small_pending: list  # (s0, len, device_array) — sharded dispatch
    large_idx: list
    large_costs: object  # np.ndarray or Future of one
    packed: object = None  # single device array (one-device dispatch)
    packed_chunks: tuple = ()  # (s0, len, offset) into packed


def _desc_array(a_base, a_len, b_base, b_len, R, excl, *, block: int) -> np.ndarray:
    """The (6, Tp) int32 descriptor array of one class batch (rows as
    ``map.dtw.DESC_ROWS``). The tile axis is padded to a power of two of
    at least ``block`` with 1x1 dummy tiles on pool element 0."""
    T = a_base.size
    d = np.zeros((ddtw.DESC_ROWS, _pow2_at_least(T, block)), dtype=np.int32)
    for row, v in enumerate((a_base, a_len, b_base, b_len, R, excl)):
        d[row, :T] = v
    d[1, T:] = 1  # n
    d[3, T:] = 1  # m
    d[4, T:] = 1  # R
    return d


def class_batch(pairs, *, block: int = ddtw.TILE_BLOCK):
    """One class batch from explicit (a, b, radius, excl) tiles whose a
    is the longer side, for kernel checks and timing: returns the value
    pool, the (6, Tp) descriptors and the band width dpw."""
    a_len = np.array([p[0].size for p in pairs], np.int64)
    b_len = np.array([p[1].size for p in pairs], np.int64)
    R = ddtw.widened_radius(a_len, b_len, [p[2] for p in pairs])
    pool = np.concatenate(
        [np.asarray(p[0], np.float32) for p in pairs]
        + [np.asarray(p[1], np.float32) for p in pairs]
    )
    desc = _desc_array(
        np.concatenate([[0], np.cumsum(a_len)[:-1]]), a_len,
        a_len.sum() + np.concatenate([[0], np.cumsum(b_len)[:-1]]), b_len,
        R, np.array([p[3] for p in pairs]), block=block,
    )
    return pool, desc, _pow2_at_least(int(R.max()) + 3, 16)


def _host_dtw(sub):
    from rawalign_tpu import native

    if native.available():
        return native.dtw_banded_batch(sub)
    from rawalign_tpu.golden import dtw as gdtw

    return np.array(
        [gdtw.dtw_global_slantedbanded_antidiagonalwise(a, b, r, x) for a, b, r, x in sub],
        dtype=np.float32,
    )


def dtw_submit_indexed(
    a_base: np.ndarray,
    a_len: np.ndarray,
    b_base: np.ndarray,
    b_len: np.ndarray,
    radius: np.ndarray,
    excl: np.ndarray,
    ref_cat_dev,
    ev_cat: np.ndarray,
    ref_cat_host: np.ndarray,
    *,
    device_max_n: int = 128,
    device_max_b: int = 128,
    mesh=None,
    ev_dev=None,
    ev_fetch=None,
) -> PendingDtw:
    """Descriptor-based batched DTW dispatch. The a side must already be
    the longer sequence; bases index the combined [ref_cat | ev_cat] pool
    (event bases pre-offset by len(ref_cat)). Only descriptors (24 B per
    tile) and the round's event pool are uploaded; the reference pool is
    resident on the device.

    With ``mesh`` set, every class batch's tile axis is padded to a
    multiple of (mesh.size * TILE_BLOCK) and sharded over all mesh
    devices (``map.dtw.dtw_indexed_sharded``); ref_cat_dev must then be
    replicated over the mesh. With ``ev_dev`` (a device-resident event
    pool) the event values are not uploaded; ``ev_fetch(idx, len)`` then
    reads the rare oversized tile's event window back for the host path."""
    N = a_base.size
    R_all = ddtw.widened_radius(a_len, b_len, radius)
    small = (
        (a_len <= device_max_n)
        & (b_len <= device_max_b)
        & (R_all + 3 <= ddtw.MAX_DPW)
    )
    small_idx = np.nonzero(small)[0]
    large_idx = np.nonzero(~small)[0]
    packed = None
    packed_chunks: list = []
    small_pending: list = []
    if small_idx.size:
        block = ddtw.TILE_BLOCK * (mesh.size if mesh is not None else 1)
        # pow2 size classes (32, 64, ..., pow2>=device_max_n) group tiles
        # of similar wavefront length
        cls = np.full(small_idx.size, 32, np.int64)
        p = 64
        top = _pow2_at_least(device_max_n, 32)
        while p <= top:
            cls[a_len[small_idx] > p // 2] = p
            p *= 2
        order = np.argsort(cls, kind="stable")
        small_idx = small_idx[order]
        cls = cls[order]
        bounds = np.nonzero(np.diff(cls))[0] + 1
        starts = np.concatenate([[0], bounds])
        ends = np.concatenate([bounds, [small_idx.size]])
        descs = []
        metas = []
        out_off = 0
        for s0, s1 in zip(starts, ends):
            sel = small_idx[s0:s1]
            R = R_all[sel]
            dpw = _pow2_at_least(int(R.max(initial=1)) + 3, 16)
            d = _desc_array(
                a_base[sel], a_len[sel], b_base[sel], b_len[sel], R, excl[sel],
                block=block,
            )
            descs.append(d)
            metas.append((dpw, d.shape[1]))
            packed_chunks.append((int(s0), int(s1 - s0), out_off))
            out_off += d.shape[1]
        Lp = _pow2_at_least(ev_cat.size, 256)
        if mesh is not None:
            ev_pool = np.zeros(Lp, dtype=np.float32)
            ev_pool[: ev_cat.size] = ev_cat
            outs = ddtw.dtw_indexed_sharded(
                ref_cat_dev, ev_pool, tuple(descs), metas=tuple(metas), mesh=mesh
            )
            small_pending = [
                (s0c, lnc, outs[k]) for k, (s0c, lnc, _off) in enumerate(packed_chunks)
            ]
            packed_chunks = []
        else:
            lev = 0 if ev_dev is not None else Lp
            blob = np.zeros(lev + sum(d.size for d in descs), dtype=np.float32)
            if ev_dev is None:
                blob[: ev_cat.size] = ev_cat
            off = lev
            for d in descs:
                blob[off : off + d.size] = d.reshape(-1).view(np.float32)
                off += d.size
            packed = ddtw.dtw_indexed(
                ref_cat_dev, blob, ev_dev, metas=tuple(metas), lev=lev
            )
            # start the device->host copy now so it overlaps the
            # caller's host work instead of starting in dtw_collect
            packed.copy_to_host_async()
    large_costs = np.zeros(0, np.float32)
    if large_idx.size:
        Lref = ref_cat_host.size

        def window(base, ln):
            if base < Lref:
                return ref_cat_host[base : base + ln]
            if ev_fetch is not None:  # resident-event mode (rare path)
                return ev_fetch(base - Lref, ln)
            return ev_cat[base - Lref : base - Lref + ln]

        sub = [
            (
                window(int(a_base[i]), int(a_len[i])),
                window(int(b_base[i]), int(b_len[i])),
                int(radius[i]),
                bool(excl[i]),
            )
            for i in large_idx
        ]
        # the host batch runs on a worker thread so it overlaps the
        # device classes (joined in dtw_collect)
        pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        large_costs = pool.submit(_host_dtw, sub)
        pool.shutdown(wait=False)
    return PendingDtw(
        n=N,
        small_idx=list(small_idx),
        small_pending=small_pending,
        large_idx=list(large_idx),
        large_costs=large_costs,
        packed=packed,
        packed_chunks=tuple(packed_chunks),
    )


def dtw_collect(pending: PendingDtw) -> np.ndarray:
    """Block on the device classes and assemble costs in input order."""
    out = np.zeros(pending.n, dtype=np.float32)
    if pending.small_idx:
        costs = np.zeros(len(pending.small_idx), dtype=np.float32)
        from rawalign_tpu import runtime

        if pending.packed is not None:
            arr = runtime.fetch(pending.packed, label="DTW fetch")
            for s0, ln, off in pending.packed_chunks:
                costs[s0 : s0 + ln] = arr[off : off + ln]
        for s0, ln, dev in pending.small_pending:
            costs[s0 : s0 + ln] = runtime.fetch(dev, label="DTW fetch")[:ln]
        out[pending.small_idx] = costs
    if pending.large_idx:
        lc = pending.large_costs
        if hasattr(lc, "result"):  # concurrent.futures.Future
            lc = lc.result()
        out[pending.large_idx] = lc
    return out


def dtw_banded_pairs(
    pairs: list[tuple[np.ndarray, np.ndarray, int, bool]], **kw
) -> np.ndarray:
    """Banded DTW of explicit (read_region, ref_region, band_radius,
    exclude_last) pairs through the engine's dispatch: the pairs are
    packed into one pool (each swapped so a is the longer, dtw.cpp:283-292;
    the caller computes the radius from the read region before swapping,
    rmap.cpp:276). ``kw`` goes to ``dtw_submit_indexed``."""
    import jax

    if not pairs:
        return np.zeros(0, dtype=np.float32)
    T = len(pairs)
    ra = [np.asarray(p[0], np.float32) for p in pairs]
    rb = [np.asarray(p[1], np.float32) for p in pairs]
    la = np.fromiter((x.size for x in ra), np.int64, T)
    lb = np.fromiter((x.size for x in rb), np.int64, T)
    base_a = np.concatenate([[0], np.cumsum(la)[:-1]])
    base_b = la.sum() + np.concatenate([[0], np.cumsum(lb)[:-1]])
    pool = np.concatenate(ra + rb + [np.zeros(1, np.float32)])
    swap = lb > la
    radius = np.fromiter((p[2] for p in pairs), np.int32, T)
    excl = np.fromiter((p[3] for p in pairs), np.int32, T)
    pend = dtw_submit_indexed(
        np.where(swap, base_b, base_a).astype(np.int32),
        np.where(swap, lb, la).astype(np.int32),
        np.where(swap, base_a, base_b).astype(np.int32),
        np.where(swap, la, lb).astype(np.int32),
        radius,
        excl,
        jax.device_put(pool),
        np.zeros(0, np.float32),
        pool,
        **kw,
    )
    return dtw_collect(pend)
