"""Batched banded DTW on device: the plain JAX version and the dispatch.

Computes the reference's production alignment kernel
``DTW_global_slantedbanded_antidiagonalwise`` (dtw.cpp:273-520) for a
BATCH of tiles — the sparse border constraint (rmap.cpp:238-300)
decomposes every chain into many small independent DTW tiles, which form
the batch axis.

A tile is described by one column of a (6, T) int32 array (rows
``DESC_ROWS``): ``a_base, n, b_base, m, R, excl``. Its sequences are
``a = src[a_base : a_base + n]`` (the longer one; callers swap as the
reference does, dtw.cpp:283-292) and ``b = src[b_base : b_base + m]`` in
one flat float32 value pool; ``R`` is the slope-widened band radius
(dtw.cpp:294-300) and ``excl`` the exclude-last flag.

The wavefront is a ``lax.fori_loop`` over anti-diagonal pairs. Its state
is the two rotating band buffers, (dpw, T) float32 with band slots along
axis 0, plus per-tile integers: the band center advances by integer slope
stepping (dtw.cpp:350-359) kept as a Bresenham accumulator, and each step
reads the a and b values of its cells straight from the pool. Nothing of
size (T, n, ·) is ever built. Out-of-band slots hold INF (=1e10), which
the oracle-validated golden model proved reproduces the C buffer
semantics. The arithmetic is float32 abs, sub, min and add only, so the
result equals the golden model's float32 bit for bit.

On the GPU each class batch runs the CUDA kernel (native/dtw_banded.cu),
a transcription of the same step with the band slots across warp lanes;
``dtw_plain`` is its reference and the CPU path.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from rawalign_tpu import platform

INF = np.float32(1e10)  # np, not jnp: keep imports backend-init-free
DESC_ROWS = 6  # a_base, n, b_base, m, R, excl
#: a class batch holds a power of two of at least this many tiles per
#: device: the CUDA kernel's tiles per thread block
TILE_BLOCK = 8
#: widest band buffer the CUDA kernel is instantiated for; tiles with
#: R + 3 above it run on the host
MAX_DPW = 1024


def widened_radius(n, m, radius):
    """R = radius + ceil((n - m) * radius / n) (dtw.cpp:294-300), int64."""
    n64 = np.maximum(np.asarray(n, np.int64), 1)
    r64 = np.asarray(radius, np.int64)
    return r64 + ((n64 - np.asarray(m, np.int64)) * r64 + n64 - 1) // n64


@functools.partial(jax.jit, static_argnames=("dpw",))
def dtw_plain(src: jax.Array, desc: jax.Array, *, dpw: int) -> jax.Array:
    """(T,) float32 banded DTW costs of the tiles in ``desc`` (6, T) over
    the value pool ``src``. ``dpw`` (static) must be >= R + 3 of every
    tile."""
    a_base, n, b_base, m, R, excl = (desc[i][None, :] for i in range(DESC_ROWS))
    T = desc.shape[1]
    S = src.shape[0]
    plm = R % 2 == 0  # the primary anti-diagonal is the longer one
    lp = jnp.where(plm, R + 1, R)
    ls = jnp.where(plm, R, R + 1)
    hlp = lp // 2
    hls = ls // 2
    slot0 = jnp.where(plm, hlp, hlp + 1)
    ok = (n > 0) & (m > 0)
    o = jax.lax.broadcasted_iota(jnp.int32, (dpw, T), 0)
    inf_row = jnp.full((1, T), INF)

    def value(base, length, idx):
        v = src[jnp.clip(base + idx, 0, S - 1)]
        return jnp.where((idx >= 0) & (idx < length), v, 0.0)

    d00 = jnp.where(ok, jnp.abs(value(a_base, n, 0) - value(b_base, m, 0)), 0.0)
    corr = jnp.where(
        (excl != 0) & ok,
        jnp.abs(value(a_base, n, n - 1) - value(b_base, m, m - 1)),
        0.0,
    )

    def shift_left(x):  # out[o] = x[o+1], INF at o = dpw-1
        return jnp.concatenate([x[1:], inf_row], axis=0)

    def shift_right(x):  # out[o] = x[o-1], INF at o = 0
        return jnp.concatenate([inf_row, x[:-1]], axis=0)

    def step(it, st):
        dp0, dp1, acc, cr, pinc, res = st
        active = it < n
        acc2 = acc + m
        incraw = acc2 >= n
        acc = jnp.where(incraw, acc2 - n, acc2)
        incb = incraw & active
        cr = cr + incb.astype(jnp.int32)

        # closed-form in-band slot ranges (dtw.cpp:320-345)
        s_i = it + hls - 1
        s_j = cr - hls
        o0s = jnp.maximum(jnp.maximum(0, s_i - n + 1), -s_j)
        o1s = jnp.minimum(jnp.minimum(ls, s_i + 1), m - s_j)
        p_i = it + hlp
        p_j = cr - hlp
        o0p = jnp.maximum(jnp.maximum(0, p_i - n + 1), -p_j)
        o1p = jnp.minimum(jnp.minimum(lp, p_i + 1), m - p_j)
        # primary slot o holds cell (x - o, y + o) = (p_i - o, p_j + o)
        x = p_i - o
        y = p_j + o
        bv = value(b_base, m, jnp.where(plm, y, y - 1))

        # ---- secondary anti-diagonal (dtw.cpp:361-414)
        top = jnp.where(~plm & (o == 0), INF, dp1)
        topleft = jnp.where(~plm & (o == 0) & ~pinc, INF, dp0)
        left = jnp.where(~plm & (o == ls - 1), INF, shift_left(dp1))
        cost = jnp.abs(value(a_base, n, jnp.where(plm, x - 1, x)) - bv)
        sec = jnp.minimum(jnp.minimum(top, left), topleft) + cost
        sec = jnp.where((o >= o0s) & (o < o1s), sec, INF)

        e0 = jnp.where(incb, dp1, dp0)
        e1 = jnp.where(incb, sec, dp1)

        # ---- primary anti-diagonal (dtw.cpp:416-491); with R odd slot o
        # holds primary cell o - 1 (the reference's "+1 simplification")
        e1r = shift_right(e1)
        e0r = shift_right(e0)
        top = jnp.where(
            plm,
            jnp.where(o == 0, INF, e1r),
            jnp.where(incb, e1r, jnp.where(o == 1, INF, e1r)),
        )
        topleft = jnp.where(
            incb,
            e0,
            jnp.where(
                plm,
                jnp.where(o == 0, INF, e0r),
                jnp.where((o == 1) & ~pinc, INF, e0r),
            ),
        )
        left = jnp.where(plm & incb & (o == lp - 1), INF, e1)
        cost = jnp.abs(value(a_base, n, jnp.where(plm, x, x + 1)) - bv)
        op = jnp.where(plm, o, o - 1)
        pri = jnp.minimum(jnp.minimum(top, left), topleft) + cost
        pri = jnp.where((op >= o0p) & (op < o1p), pri, INF)

        dp0 = jnp.where(active, e1, dp0)
        dp1 = jnp.where(active, pri, dp1)
        at_slot0 = jnp.min(jnp.where(o == slot0, dp1, INF), axis=0, keepdims=True)
        res = jnp.where(it == n - 1, at_slot0, res)
        pinc = jnp.where(active, incraw, pinc)
        return dp0, dp1, acc, cr, pinc, res

    zeros = jnp.zeros((1, T), jnp.int32)
    init = (
        jnp.full((dpw, T), INF),
        jnp.where((o == slot0) & ok, d00, INF),
        zeros,
        zeros,
        jnp.zeros((1, T), jnp.bool_),
        jnp.where(ok, d00, INF),
    )
    res = jax.lax.fori_loop(1, jnp.max(n), step, init)[-1]
    return (res - corr)[0]


def dtw_class(src: jax.Array, desc: jax.Array, *, dpw: int) -> jax.Array:
    """One class batch on this platform: the CUDA kernel on the GPU, the
    plain version on the CPU (the choice is made while tracing)."""
    if platform.use_kernels():
        from rawalign_tpu.map import dtw_cuda

        return dtw_cuda.dtw_banded(src, desc, dpw=dpw)
    return dtw_plain(src, desc, dpw=dpw)


@functools.partial(jax.jit, static_argnames=("metas", "lev"))
def dtw_indexed(
    ref_cat: jax.Array,  # (Lref,) f32 resident reference value pool
    blob: jax.Array,  # (lev + 6*sum(Tp),) f32: [event pool | bitcast descs]
    ev: jax.Array | None = None,  # resident event pool (then lev == 0)
    *,
    metas: tuple,  # ((dpw, Tp), ...) per class batch
    lev: int,
) -> jax.Array:
    """All class batches of one mapping round in ONE dispatch: one
    host->device transfer (the round's event pool and the int32
    descriptors bitcast into one f32 blob) and one result array (all
    class batches' costs concatenated). Tile bases index
    [ref_cat | event pool].

    With ``ev`` (a device-resident event pool, e.g. the engine's event
    history buffer) blob carries only the descriptors (lev must be 0) and
    event bases index [ref_cat | ev.ravel()]."""
    if ev is not None:
        assert lev == 0
        src = jnp.concatenate([ref_cat, ev.reshape(-1)])
    else:
        src = jnp.concatenate([ref_cat, blob[:lev]])
    ints = jax.lax.bitcast_convert_type(blob[lev:], jnp.int32)
    outs = []
    off = 0
    for dpw, tp in metas:
        d = jax.lax.dynamic_slice_in_dim(ints, off, DESC_ROWS * tp)
        off += DESC_ROWS * tp
        outs.append(dtw_class(src, d.reshape(DESC_ROWS, tp), dpw=dpw))
    return jnp.concatenate(outs)


_SHARDED_DISPATCH_CACHE: dict = {}


def dtw_indexed_sharded(
    ref_cat: jax.Array,  # replicated resident reference value pool
    ev_pool: jax.Array,  # (lev,) f32 round event pool (replicated)
    descs: tuple,  # per class batch: (6, Tp) int32, Tp % mesh.size == 0
    *,
    metas: tuple,  # ((dpw, Tp), ...) — Tp GLOBAL per class
    mesh,
) -> tuple:
    """Mesh-sharded ``dtw_indexed``: the TILE axis of every class batch
    is sharded over all mesh devices (the flattened (data, shard) axes);
    the signal pool is replicated, so each device runs the wavefront on
    its tile slice with no inter-device communication — DTW tiles are
    embarrassingly parallel, the multi-device analog of the reference's
    mapping threads each running DTW_global_slantedbanded_antidiagonalwise
    (kt_for, rmap.cpp:916 + dtw.cpp:273-520).

    Returns a tuple of (Tp,) global cost arrays, one per class batch."""
    from jax.sharding import PartitionSpec as P

    axes = tuple(mesh.axis_names)
    key = (mesh, metas)
    f = _SHARDED_DISPATCH_CACHE.get(key)
    if f is None:

        def local(ref_cat, ev_pool, *dd):
            src = jnp.concatenate([ref_cat, ev_pool])
            return tuple(
                dtw_class(src, d, dpw=dpw) for d, (dpw, _tp) in zip(dd, metas)
            )

        f = jax.jit(
            jax.shard_map(
                local,
                mesh=mesh,
                in_specs=(P(None), P(None))
                + tuple(P(None, axes) for _ in metas),
                out_specs=tuple(P(axes) for _ in metas),
                check_vma=False,
            )
        )
        _SHARDED_DISPATCH_CACHE[key] = f
    return f(ref_cat, ev_pool, *descs)
