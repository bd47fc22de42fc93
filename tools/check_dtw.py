#!/usr/bin/env python
"""DTW self-test + micro-benchmark harness.

This framework's analog of the reference's ``check_dtw`` binary
(src/check_dtw.cpp):

* default mode — randomized equivalence tests across the reference's
  shape groups (check_dtw.cpp:183-237): every DTW variant in
  rawalign_tpu.golden.dtw is compared against an INDEPENDENT baseline
  implementation (a plain full-matrix double-precision DTW written here,
  playing the role of the third-party baseline_dtw.hpp), with the banded
  variants given a band radius derived from the unconstrained optimal
  path so banded == unbanded exactly (check_dtw.cpp:128-136);
  tolerance 1e-3 as in check_dtw.cpp:138.

* ``--performance-benchmark ITERS ALEN BLEN BAND_FRAC`` — per-call
  latency of each variant (check_dtw.cpp:240-272): the golden NumPy
  kernels, the native C library (if built), and the device Pallas kernel
  (amortized per tile over a batch, the way production drives it).

    python tools/check_dtw.py [NUM_TESTS]
    python tools/check_dtw.py --performance-benchmark 100 200 190 0.1
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rawalign_tpu.golden import dtw as gdtw


# ---------------------------------------------------------------------------
# Independent baseline: textbook full-matrix DTW in float64 (the role of
# baseline_dtw.hpp / Jekel's implementation in the reference harness).
def baseline_dtw(a, b):
    n, m = len(a), len(b)
    D = np.full((n + 1, m + 1), np.inf)
    D[0, 0] = 0.0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            c = abs(float(a[i - 1]) - float(b[j - 1]))
            D[i, j] = c + min(D[i - 1, j], D[i, j - 1], D[i - 1, j - 1])
    return D


def optimal_path(D):
    i, j = D.shape[0] - 1, D.shape[1] - 1
    path = [(i - 1, j - 1)]
    while i > 1 or j > 1:
        moves = []
        if i > 1 and j > 1:
            moves.append((D[i - 1, j - 1], i - 1, j - 1))
        if i > 1:
            moves.append((D[i - 1, j], i - 1, j))
        if j > 1:
            moves.append((D[i, j - 1], i, j - 1))
        _, i, j = min(moves)
        path.append((i - 1, j - 1))
    return path[::-1]


def necessary_band_radius(path, n, m):
    """Smallest slanted-band radius covering the optimal path
    (check_dtw.cpp:128-136): the band center at row i is i*m/n."""
    r = 1
    for i, j in path:
        center = (i * m) // max(n, 1)
        r = max(r, abs(j - center) + 2)
    return r


def necessary_diag_radius(path):
    """Smallest main-diagonal band radius covering the optimal path (the
    diagonal-banded variant's band center at row i is column i)."""
    r = 1
    for i, j in path:
        r = max(r, abs(j - i) + 2)
    return r


SHAPE_GROUPS = [
    (4, 4),
    (10, 10),
    (30, 30),
    (200, 200),
    (10, 7),
    (30, 17),
    (200, 30),
    (7, 10),
    (17, 30),
    (30, 200),
]


def run_tests(num_tests: int) -> int:
    rng = np.random.default_rng(42)
    failures = 0
    per_group = max(1, num_tests // len(SHAPE_GROUPS))
    for al, bl in SHAPE_GROUPS:
        for t in range(per_group):
            a = rng.uniform(-2.5, 2.5, al).astype(np.float32)
            b = rng.uniform(-2.5, 2.5, bl).astype(np.float32)
            D = baseline_dtw(a, b)
            want = D[-1, -1]
            path = optimal_path(D)
            r = necessary_band_radius(path, al, bl)
            got = {
                "global": gdtw.dtw_global(a, b),
                "global_slow": gdtw.dtw_global_slow(a, b),
                "global_tb": gdtw.dtw_global_tb(a, b).cost,
                "diagonalbanded": gdtw.dtw_global_diagonalbanded(
                    a, b, necessary_diag_radius(path)
                ),
                "slantedbanded": gdtw.dtw_global_slantedbanded(a, b, r),
                "slantedbanded_antidiagonalwise": (
                    gdtw.dtw_global_slantedbanded_antidiagonalwise(a, b, r)
                ),
            }
            for name, v in got.items():
                if abs(v - want) > 1e-3:
                    print(
                        f"FAIL {name} a={al} b={bl} test={t}: "
                        f"got {v} want {want} (r={r})"
                    )
                    failures += 1
            # semiglobal: free start/end on the reference axis — verify
            # against a min over baseline start/end columns
            sg = gdtw.dtw_semiglobal(a, b)
            Dsg = np.full((al + 1, bl + 1), np.inf)
            Dsg[0, :] = 0.0
            for i in range(1, al + 1):
                for j in range(1, bl + 1):
                    c = abs(float(a[i - 1]) - float(b[j - 1]))
                    Dsg[i, j] = c + min(
                        Dsg[i - 1, j], Dsg[i, j - 1], Dsg[i - 1, j - 1]
                    )
            want_sg = Dsg[-1, 1:].min()
            if abs(sg - want_sg) > 1e-3:
                print(f"FAIL semiglobal a={al} b={bl}: {sg} vs {want_sg}")
                failures += 1
    total = per_group * len(SHAPE_GROUPS)
    print(f"{total} randomized tests per variant, {failures} failures")
    return 1 if failures else 0


def run_perf(iters: int, alen: int, blen: int, frac: float) -> int:
    rng = np.random.default_rng(0)
    a = rng.uniform(-2.5, 2.5, alen).astype(np.float32)
    b = rng.uniform(-2.5, 2.5, blen).astype(np.float32)
    r = max(1, int(alen * frac))

    def mtime(fn, n=iters):
        fn()  # warm
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) / n * 1e6

    rows = [
        ("golden numpy global (rolling)", mtime(lambda: gdtw.dtw_global(a, b))),
        (
            "golden numpy slantedbanded_antidiagonalwise",
            mtime(
                lambda: gdtw.dtw_global_slantedbanded_antidiagonalwise(a, b, r)
            ),
        ),
    ]
    try:
        from rawalign_tpu import native

        if native.available():
            rows.append(
                (
                    "native C slantedbanded_antidiagonalwise",
                    mtime(lambda: native.dtw_banded(a, b, r, False)),
                )
            )
    except Exception:
        pass
    try:
        import jax

        from rawalign_tpu.map import tiles

        batch_pairs = [(a, b, r, False)] * 2048
        kw = dict(device_max_n=4096, device_max_b=4096)
        tiles.dtw_banded_pairs(batch_pairs, **kw)  # warm / compile

        def dev_call():
            tiles.dtw_banded_pairs(batch_pairs, **kw)

        us = mtime(dev_call, n=max(3, iters // 10))
        rows.append(
            (
                f"device batch (2048 tiles, {jax.devices()[0].device_kind}), "
                "per tile",
                us / 2048,
            )
        )
    except Exception as e:  # pragma: no cover
        print(f"# device benchmark skipped: {e}", file=sys.stderr)

    print(f"# a_len={alen} b_len={blen} band_radius={r} iters={iters}")
    for name, us in rows:
        print(f"{name}: {us:.2f} us/call")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("num_tests", nargs="?", type=int, default=200)
    ap.add_argument(
        "--performance-benchmark",
        nargs=4,
        metavar=("ITERS", "ALEN", "BLEN", "BAND_FRAC"),
    )
    args = ap.parse_args()
    if args.performance_benchmark:
        it, al, bl, fr = args.performance_benchmark
        return run_perf(int(it), int(al), int(bl), float(fr))
    return run_tests(args.num_tests)


if __name__ == "__main__":
    raise SystemExit(main())
