"""Device banded DTW (map/dtw.py, map/tiles.py) vs the golden model."""

import numpy as np
import pytest

from rawalign_tpu.golden import dtw as gdtw
from rawalign_tpu.map import dtw as ddtw
from rawalign_tpu.map import tiles


def _rand(rng, n):
    return rng.normal(0.0, 1.0, size=n).astype(np.float32)


def _assert_close(got, want, ctx=None):
    # identical operand triples -> must agree to float32 exactness;
    # allow 1e-3 (the reference's own check_dtw tolerance) for safety;
    # both-huge (band missed the corner) counts as equal
    got = np.asarray(got)
    want = np.asarray(want, dtype=np.float32)
    both_huge = (got > 1e9) & (want > 1e9)
    bad = np.nonzero(~both_huge & (np.abs(got - want) > 1e-3))[0]
    assert bad.size == 0, (
        bad[:5], got[bad[:5]], want[bad[:5]], [ctx[i] for i in bad[:5]] if ctx else None
    )


SHAPES = [
    (1, 1),
    (4, 4),
    (10, 7),
    (7, 10),
    (30, 30),
    (30, 17),
    (17, 30),
    (64, 40),
    (40, 64),
    (200, 30),
    (30, 200),
    (128, 128),
    (200, 190),
]


@pytest.mark.parametrize("seed", range(4))
def test_device_banded_matches_golden(seed):
    rng = np.random.default_rng(seed)
    pairs = []
    want = []
    for al, bl in SHAPES:
        for r in (1, 2, 5, 12):
            for excl in (False, True):
                if excl and al == 1 and bl == 1:
                    continue
                a, b = _rand(rng, al), _rand(rng, bl)
                pairs.append((a, b, r, excl))
                want.append(
                    gdtw.dtw_global_slantedbanded_antidiagonalwise(a, b, r, excl)
                )
    got = tiles.dtw_banded_pairs(pairs, device_max_n=256, device_max_b=256)
    _assert_close(got, want, [(p[0].size, p[1].size, p[2], p[3]) for p in pairs])


def test_device_banded_production_band_fracs():
    """Radii as the mapper computes them: max(1, read_len * 0.10)."""
    rng = np.random.default_rng(99)
    pairs, want = [], []
    for al in (20, 45, 80, 150, 400):
        for stretch in (0.7, 1.0, 1.4):
            bl = max(1, int(al * stretch))
            a, b = _rand(rng, al), _rand(rng, bl)
            r = max(1, int(al * 0.10))
            pairs.append((a, b, r, True))
            want.append(
                gdtw.dtw_global_slantedbanded_antidiagonalwise(a, b, r, True)
            )
    got = tiles.dtw_banded_pairs(pairs, device_max_n=1024, device_max_b=1024)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-3)


def test_indexed_dispatch_matches_golden():
    """dtw_submit_indexed (descriptor form over a resident pool) must
    match the golden banded DTW on random tiles drawn from two value
    pools, mixing ref-side-longer and read-side-longer tiles."""
    rng = np.random.default_rng(123)
    ref_cat = _rand(rng, 5000)
    ev_cat = _rand(rng, 800)
    import jax

    ref_dev = jax.device_put(ref_cat)
    Lref = ref_cat.size
    rows, want = [], []
    for _ in range(60):
        tl = int(rng.integers(2, 250))
        ql = int(rng.integers(2, 250))
        t0 = int(rng.integers(0, Lref - tl))
        q0 = int(rng.integers(0, ev_cat.size - ql))
        r = max(1, int(ql * 0.10))
        excl = bool(rng.integers(0, 2))
        ref_r = ref_cat[t0 : t0 + tl]
        read_r = ev_cat[q0 : q0 + ql]
        if tl > ql:
            rows.append((t0, tl, Lref + q0, ql, r, int(excl)))
            want.append(
                gdtw.dtw_global_slantedbanded_antidiagonalwise(
                    ref_r, read_r, r, excl
                )
            )
        else:
            rows.append((Lref + q0, ql, t0, tl, r, int(excl)))
            want.append(
                gdtw.dtw_global_slantedbanded_antidiagonalwise(
                    read_r, ref_r, r, excl
                )
            )
    da = np.asarray(rows, dtype=np.int64)
    pending = tiles.dtw_submit_indexed(
        da[:, 0].astype(np.int32),
        da[:, 1].astype(np.int32),
        da[:, 2].astype(np.int32),
        da[:, 3].astype(np.int32),
        da[:, 4].astype(np.int32),
        da[:, 5].astype(np.int32),
        ref_dev,
        ev_cat,
        ref_cat,
    )
    _assert_close(tiles.dtw_collect(pending), want)


def _class_pairs(rng, max_n, parity, count):
    """Tiles of one size class (a_len in (max_n/2, max_n]) whose widened
    radius has the given parity, radius ~10% of the shorter side."""
    pairs = []
    lo = 1 if max_n == 32 else max_n // 2 + 1
    while len(pairs) < count:
        n = int(rng.integers(lo, max_n + 1))
        m = max(1, int(n * rng.uniform(0.6, 1.0)))
        r = max(1, int(0.1 * m))
        while int(ddtw.widened_radius(n, m, r)) % 2 != parity:
            r += 1
        pairs.append((_rand(rng, n), _rand(rng, m), r, bool(rng.integers(0, 2))))
    return pairs


@pytest.mark.parametrize("parity", [0, 1], ids=["R_even", "R_odd"])
@pytest.mark.parametrize("max_n", [32 << i for i in range(7)])
def test_plain_dtw_size_class(max_n, parity):
    """The plain fori_loop DTW, through the engine's indexed dispatch,
    equals golden float32 on every size class up to 2048 and both R
    parities (the two band geometries of dtw.cpp:361-491)."""
    rng = np.random.default_rng(max_n * 2 + parity)
    pairs = _class_pairs(rng, max_n, parity, 6 if max_n < 1024 else 3)
    want = [gdtw.dtw_global_slantedbanded_antidiagonalwise(*p) for p in pairs]
    got = tiles.dtw_banded_pairs(pairs, device_max_n=2048, device_max_b=2048)
    assert (got == np.asarray(want, np.float32)).all(), (got, want)


def test_desc_array_padding():
    """Class batches pad the tile axis to a power of two of at least the
    block with 1x1 dummy tiles on pool element 0."""
    d = tiles._desc_array(
        np.array([5, 9, 0]), np.array([4, 3, 2]), np.array([1, 2, 3]),
        np.array([3, 3, 2]), np.array([2, 3, 1]), np.array([1, 0, 1]),
        block=8,
    )
    assert d.shape == (ddtw.DESC_ROWS, 8) and d.dtype == np.int32
    assert d[:, :3].tolist() == [
        [5, 9, 0], [4, 3, 2], [1, 2, 3], [3, 3, 2], [2, 3, 1], [1, 0, 1]
    ]
    assert (d[:, 3:] == np.array([[0], [1], [0], [1], [1], [0]])).all()
    assert tiles._desc_array(*([np.zeros(9, int)] * 6), block=8).shape[1] == 16
    assert tiles._desc_array(*([np.zeros(3, int)] * 6), block=32).shape[1] == 32


def test_routing_to_host_and_classes():
    """Tiles beyond the device caps, or whose band would exceed the
    widest kernel instance, run on the host; the rest are grouped into
    pow2 size classes whose dpw covers every member's R + 3."""
    rng = np.random.default_rng(5)
    pool = _rand(rng, 10000)
    import jax

    a_len = np.array([10, 40, 300, 100, 100], np.int32)
    b_len = np.array([8, 40, 200, 100, 100], np.int32)
    radius = np.array([1, 4, 30, 2 * ddtw.MAX_DPW, 10], np.int32)
    zero = np.zeros(5, np.int32)
    base = np.arange(5, dtype=np.int32) * 1000
    pend = tiles.dtw_submit_indexed(
        base, a_len, base + 500, b_len, radius, zero,
        jax.device_put(pool), np.zeros(0, np.float32), pool,
        device_max_n=256, device_max_b=256,
    )
    assert sorted(pend.large_idx) == [2, 3]
    assert sorted(pend.small_idx) == [0, 1, 4]
    got = tiles.dtw_collect(pend)
    want = [
        gdtw.dtw_global_slantedbanded_antidiagonalwise(
            pool[base[i] : base[i] + a_len[i]],
            pool[base[i] + 500 : base[i] + 500 + b_len[i]],
            int(radius[i]), False,
        )
        for i in range(5)
    ]
    _assert_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("max_n", [32 << i for i in range(7)])
def test_cuda_kernel_matches_plain(gpu, max_n):
    """The CUDA kernel equals the plain version on every size class,
    both parities in one batch (run on the card: pytest -m gpu)."""
    import jax.numpy as jnp

    from rawalign_tpu.map import dtw_cuda

    rng = np.random.default_rng(max_n)
    pairs = _class_pairs(rng, max_n, 0, 16) + _class_pairs(rng, max_n, 1, 16)
    pool, d, dpw = tiles.class_batch(pairs)
    src, dd = jnp.asarray(pool), jnp.asarray(d)
    got = np.asarray(dtw_cuda.dtw_banded(src, dd, dpw=dpw))
    want = np.asarray(ddtw.dtw_plain(src, dd, dpw=dpw))
    assert (got == want).all()


def test_cuda_wrapper_validates_before_building():
    """The kernel wrapper rejects band widths it has no instance for and
    descriptor arrays that are not (6, k*TILE_BLOCK), before it touches
    the toolchain."""
    import jax.numpy as jnp

    from rawalign_tpu.map import dtw_cuda

    assert dtw_cuda.DPW_SUPPORTED == (16, 32, 64, 128, 256, 512, 1024)
    src = jnp.zeros(64, jnp.float32)
    with pytest.raises(ValueError, match="dpw=48"):
        dtw_cuda.dtw_banded(src, jnp.zeros((6, 8), jnp.int32), dpw=48)
    with pytest.raises(ValueError, match="desc shape"):
        dtw_cuda.dtw_banded(src, jnp.zeros((6, 12), jnp.int32), dpw=16)
    with pytest.raises(ValueError, match="desc shape"):
        dtw_cuda.dtw_banded(src, jnp.zeros((9, 8), jnp.int32), dpw=16)


def test_dtw_class_picks_kernel_by_platform(monkeypatch):
    """dtw_class traces the CUDA kernel where platform.use_kernels() is
    true and the plain version elsewhere."""
    import jax.numpy as jnp

    from rawalign_tpu import platform
    from rawalign_tpu.map import dtw_cuda

    calls = []

    def fake(src, desc, *, dpw):
        calls.append(dpw)
        return jnp.full(desc.shape[1], 7.0, jnp.float32)

    monkeypatch.setattr(dtw_cuda, "dtw_banded", fake)
    src = jnp.arange(16, dtype=jnp.float32)
    d = jnp.asarray(tiles._desc_array(*([np.zeros(1, int)] * 6), block=8))
    plain = np.asarray(ddtw.dtw_class(src, d, dpw=16))
    # an empty tile costs INF; the 1x1 dummies on pool element 0 cost 0
    assert calls == [] and plain[0] > 1e9 and (plain[1:] == 0).all()
    monkeypatch.setattr(platform, "use_kernels", lambda backend=None: True)
    assert (np.asarray(ddtw.dtw_class(src, d, dpw=32)) == 7.0).all()
    assert calls == [32]
