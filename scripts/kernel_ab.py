"""End-to-end A/B of the GPU DTW kernel against its plain JAX version.

Usage (on a GPU): python scripts/kernel_ab.py [--reads N]

Maps chip_smoke.py's data (5 Mb genome, 512 reads, sensitive preset with
DTW chain evaluation) with ``MappingEngine`` at the CLI's defaults, in
one process, under two DTW implementations:

  kernels       the CUDA kernel (the default on the GPU)
  dtw_plain     the plain fori_loop version (map/dtw.py)

in the order kernels, dtw_plain, dtw_plain, kernels. JAX's caches are cleared at every switch and each timed pass
follows an untimed pass of the same implementation, so no timed pass
compiles. Every pass's PAF (without mt:f) must equal the first.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import statistics
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ORDER = ("kernels", "dtw_plain", "dtw_plain", "kernels")


@contextlib.contextmanager
def implementation(name: str):
    import jax

    from rawalign_tpu.map import dtw as ddtw
    from rawalign_tpu.map import dtw_cuda

    with contextlib.ExitStack() as stack:
        if name == "dtw_plain":
            stack.enter_context(mock.patch.object(
                dtw_cuda, "dtw_banded",
                lambda src, desc, *, dpw: ddtw.dtw_plain(src, desc, dpw=dpw),
            ))
        jax.clear_caches()
        yield


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=512)
    args = ap.parse_args()
    import chip_smoke

    devs = chip_smoke.require_gpu(1)
    card = chip_smoke.card_line()
    print(f"card: {card}; JAX {devs[0].device_kind}", flush=True)
    from rawalign_tpu import cli
    from rawalign_tpu.index.index import RawIndex
    from rawalign_tpu.io import fast5, paf
    from rawalign_tpu.map.engine import MappingEngine

    os.makedirs(chip_smoke.WORK, exist_ok=True)
    chip_smoke.build_native()
    paths = chip_smoke.make_data()
    if cli.main(["-x", "sensitive", "-p", paths["model"], "-d", paths["idx"], paths["ref"]]):
        raise SystemExit("indexing failed")
    _io, mo = chip_smoke.mapping_options()
    idx = RawIndex.load(paths["idx"])
    reads = list(fast5.read_sigbin(paths["reads"]))[: args.reads]

    def one_pass():
        eng = MappingEngine(idx, mo, batch_size=32, pipeline_depth=4)
        t0 = time.perf_counter()
        lines = [paf.strip_mt(paf.paf_line(r)) for r in eng.map_reads(iter(reads))]
        dt = time.perf_counter() - t0
        eng.close()
        return sorted(lines), dt

    ref = None
    rates: dict[str, list[float]] = {}
    for name in ORDER:
        with implementation(name):
            one_pass()
            lines, dt = one_pass()
        ref = lines if ref is None else ref
        same = lines == ref
        rates.setdefault(name, []).append(len(reads) / dt)
        print(f"{name:13s} {len(reads)} reads in {dt:.3f} s: "
              f"{len(reads) / dt:.2f} reads/s; PAF equal to first pass: {same}",
              flush=True)
        if not same:
            raise SystemExit("PAF differs between implementations")
    for name, r in rates.items():
        print(f"{name:13s} reads/s on {card}: {r} (mean {statistics.mean(r):.2f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
