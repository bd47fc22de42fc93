"""Kernel-level timing of the GPU DTW kernel against its plain JAX version.

Usage (on a GPU): python scripts/microbench_dtw.py [--tiles N] [--iters N]

For every DTW size class (32..2048, both R parities mixed, band radius
~10% of the shorter side as the mapper sets it) it times the CUDA kernel
(map/dtw_cuda.py) and the plain fori_loop version (map/dtw.py) on the
same (6, T) descriptors. Each time is the median of ``--iters`` calls ending in
block_until_ready, after one compiling call. Results must be equal; the
card's name and power limit head the output.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _time(fn, iters: int):
    import jax

    jax.block_until_ready(fn())  # compile
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, default=256, help="tiles per class")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        raise SystemExit("microbench_dtw: needs a GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    from rawalign_tpu import runtime
    from rawalign_tpu.map import dtw as ddtw
    from rawalign_tpu.map import dtw_cuda, tiles

    runtime.enable_compilation_cache()
    rng = np.random.default_rng(0)
    for max_n in (32 << i for i in range(7)):
        lo = 1 if max_n == 32 else max_n // 2 + 1
        n = rng.integers(lo, max_n + 1, args.tiles)
        m = np.maximum(1, (n * rng.uniform(0.6, 1.0, args.tiles)).astype(np.int64))
        r = np.maximum(1, (0.1 * m).astype(np.int64))
        R = ddtw.widened_radius(n, m, r)
        pairs = [
            (rng.normal(0, 1, a).astype(np.float32),
             rng.normal(0, 1, b).astype(np.float32), rr, True)
            for a, b, rr in zip(n, m, r)
        ]
        pool, d, dpw = tiles.class_batch(pairs)
        src, dd = jnp.asarray(pool), jnp.asarray(d)
        k = jax.jit(lambda s, x: dtw_cuda.dtw_banded(s, x, dpw=dpw))
        p = jax.jit(lambda s, x: ddtw.dtw_plain(s, x, dpw=dpw))
        equal = bool((np.asarray(k(src, dd)) == np.asarray(p(src, dd))).all())
        tk = _time(lambda: k(src, dd), args.iters)
        tp = _time(lambda: p(src, dd), args.iters)
        cells = int((n * np.minimum(2 * R + 1, m)).sum())
        print(f"dtw class {max_n:4d} dpw {dpw:3d} T {d.shape[1]}: kernel "
              f"{tk * 1e3:.3f} ms ({cells / tk / 1e9:.2f} Gcell/s), plain "
              f"{tp * 1e3:.3f} ms, plain/kernel {tp / tk:.1f}x, equal {equal}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
