"""Benchmark: end-to-end mapping throughput on one NVIDIA GPU.

Prints ONE JSON line:
  {"metric": "reads_per_sec", "value": N, "unit": "reads/sec",
   "device": {...}, "details": {...}}

The workload is 256 synthetic reads on a 200 kb genome with the
sensitive preset and DTW chain evaluation (override the scale with
RAWALIGN_BENCH_GENOME_KB / RAWALIGN_BENCH_N_READS). ``value`` is the
median of three mapping passes after a warm-up pass that compiles every
shape. ``details`` adds the device DTW throughput through the engine's
DTW dispatch on a small-tile and a large-tile mix. Fails when JAX finds
no GPU: a number from any other device is not this benchmark's.
"""

import json
import statistics
import subprocess
import time

import numpy as np


def build_dataset(n_reads=None, genome_kb=None):
    import os

    from rawalign_tpu import config
    from rawalign_tpu.index import index as dindex
    from rawalign_tpu.testing import synth

    if n_reads is None:
        n_reads = int(os.environ.get("RAWALIGN_BENCH_N_READS", "256"))
    if genome_kb is None:
        genome_kb = int(os.environ.get("RAWALIGN_BENCH_GENOME_KB", "200"))
    ds = synth.make_dataset(
        seed=7,
        genome_lengths=[genome_kb * 1000],
        n_reads=n_reads,
        read_len_bp=(400, 1200),
        noise_pa=1.5,
    )
    io = config.IndexOptions()
    mo = config.MappingOptions()
    config.set_opt("sensitive", io, mo)
    mo.set_flag(config.MappingFlag.DTW_EVALUATE_CHAINS)
    idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)
    return ds, idx, io, mo, genome_kb


def bench_mapping(ds, idx, mo):
    from rawalign_tpu.map.engine import MappingEngine

    reads = [(r.name, r.signal) for r in ds.reads]
    engine = MappingEngine(idx, mo, batch_size=32, pipeline_depth=8)
    # warm-up pass over the full read set: compiles every shape the
    # measured passes hit
    _ = list(engine.map_reads(reads))
    times = []
    for _pass in range(3):
        t0 = time.perf_counter()
        results = list(engine.map_reads(reads))
        times.append(time.perf_counter() - t0)
    engine.close()
    dt = statistics.median(times)
    n_mapped = sum(1 for r in results if r.mapped)
    by_name = {r.name: r for r in ds.reads}
    n_correct = 0
    for res in results:
        if not res.mapped:
            continue
        read = by_name[res.read_name]
        if (
            read.ref_id >= 0
            and res.ref_name == ds.seqs[read.ref_id].name
            and res.rev == read.strand
        ):
            lo = res.fragment_start_position
            hi = lo + res.fragment_length
            if not (hi < read.ref_start or lo > read.ref_end):
                n_correct += 1
    n = len(reads)
    return n / dt, n_mapped / n, n_correct / n, times


def _tile_mix(rng, n_tiles, lo, hi):
    pairs = []
    for _ in range(n_tiles):
        al = int(rng.integers(lo, hi))
        bl = max(1, int(al * rng.uniform(0.7, 1.4)))
        a = rng.normal(0, 1, al).astype(np.float32)
        b = rng.normal(0, 1, bl).astype(np.float32)
        pairs.append((a, b, max(1, int(al * 0.10)), True))
    return pairs


def bench_dtw_device(pairs, iters=20):
    """Device DTW cells/s through the engine's dispatch
    (tiles.dtw_banded_pairs: size classes, descriptors, one device
    program per call), median of ``iters`` calls after a compiling one."""
    from rawalign_tpu.map import tiles

    kw = dict(device_max_n=2048, device_max_b=2048)
    cells = 0
    for a, b, r, _ in pairs:
        n, m = max(a.size, b.size), min(a.size, b.size)
        cells += n * min(2 * r + 1, m)
    tiles.dtw_banded_pairs(pairs, **kw)  # compile
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        tiles.dtw_banded_pairs(pairs, **kw)
        ts.append(time.perf_counter() - t0)
    return cells / statistics.median(ts)


def main():
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py: needs a GPU, JAX found {devs[0].platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    ds, idx, io, mo, genome_kb = build_dataset()
    rng = np.random.default_rng(0)
    dev_cups = bench_dtw_device(_tile_mix(rng, 4096, 8, 96))
    dev_cups_large = bench_dtw_device(_tile_mix(rng, 512, 512, 2048), iters=5)
    reads_per_sec, mapped_frac, correct_frac, times = bench_mapping(ds, idx, mo)
    print(
        json.dumps(
            {
                "metric": "reads_per_sec",
                "value": round(reads_per_sec, 2),
                "unit": "reads/sec",
                "device": {
                    "platform": devs[0].platform,
                    "kind": devs[0].device_kind,
                    "count": len(devs),
                    "card": card,
                },
                "details": {
                    "genome_kb": genome_kb,
                    "n_reads": len(ds.reads),
                    "mapped_frac": round(mapped_frac, 3),
                    "correct_frac": round(correct_frac, 3),
                    "mapping_pass_s": [round(t, 3) for t in times],
                    "dtw_device_cells_per_sec": int(dev_cups),
                    "dtw_device_cells_per_sec_large_tiles": int(dev_cups_large),
                },
            }
        )
    )


if __name__ == "__main__":
    main()
