#!/usr/bin/env python
"""Interleaved A/B benchmark over engine configurations (round 5).

Builds the 200kb bench dataset once, constructs one engine per named
config, warms each with a full pass (compiles cached), then runs
interleaved measured passes (A, B, C, A, B, C, ...) so every variant
sees the same host conditions. Reports per-variant best and
median wall, reads/s, and the phase breakdown of the best pass.

Usage:
  python scripts/perf_ab.py --trials 5 --configs base,dev,fused
  python scripts/perf_ab.py --configs base,depth12,depth16
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CONFIGS = {
    "base": dict(batch_size=32, pipeline_depth=8),
    "dev": dict(batch_size=32, pipeline_depth=8, chain_impl="device"),
    "host": dict(batch_size=32, pipeline_depth=8, stage1_impl="host"),
    "host64": dict(batch_size=64, pipeline_depth=4, stage1_impl="host"),
    "host16": dict(batch_size=16, pipeline_depth=16, stage1_impl="host"),
    "fused": dict(batch_size=32, pipeline_depth=8, fused=True),
    "depth4": dict(batch_size=32, pipeline_depth=4),
    "depth12": dict(batch_size=32, pipeline_depth=12),
    "depth16": dict(batch_size=32, pipeline_depth=16),
    "b16d16": dict(batch_size=16, pipeline_depth=16),
    "b64d4": dict(batch_size=64, pipeline_depth=4),
    "b64d8": dict(batch_size=64, pipeline_depth=8),
    "b128d2": dict(batch_size=128, pipeline_depth=2),
    "b256d1": dict(batch_size=256, pipeline_depth=1),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--configs", default="base,dev,fused")
    ap.add_argument("--genome-kb", type=int, default=200)
    ap.add_argument("--n-reads", type=int, default=256)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    from rawalign_tpu import config, runtime
    from rawalign_tpu.index import index as dindex
    from rawalign_tpu.map.engine import MappingEngine
    from rawalign_tpu.testing import synth

    runtime.enable_compilation_cache()
    ds = synth.make_dataset(
        seed=7, genome_lengths=[args.genome_kb * 1000],
        n_reads=args.n_reads, read_len_bp=(400, 1200), noise_pa=1.5,
    )
    io, mo = config.IndexOptions(), config.MappingOptions()
    config.set_opt("sensitive", io, mo)
    mo.set_flag(config.MappingFlag.DTW_EVALUATE_CHAINS)
    idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)
    reads = [(r.name, r.signal) for r in ds.reads]

    names = args.configs.split(",")
    engines = {}
    for nm in names:
        engines[nm] = MappingEngine(idx, mo, **CONFIGS[nm])
    # warm: full pass per engine (also validates mapping)
    for nm, eng in engines.items():
        t0 = time.perf_counter()
        res = list(eng.map_reads(iter(reads)))
        n_mapped = sum(1 for r in res if r.mapped)
        print(f"warm {nm}: {time.perf_counter()-t0:.1f}s "
              f"mapped {n_mapped}/{len(reads)}", flush=True)

    stats = {nm: {"walls": [], "best_phase": None} for nm in names}
    for t in range(args.trials):
        for nm, eng in engines.items():
            for k in eng.phase_times:
                eng.phase_times[k] = 0.0 if k != "rounds" else 0
            t0 = time.perf_counter()
            res = list(eng.map_reads(iter(reads)))
            d = time.perf_counter() - t0
            st = stats[nm]
            if not st["walls"] or d < min(st["walls"]):
                st["best_phase"] = {
                    k: round(v, 3) for k, v in eng.phase_times.items()
                }
            st["walls"].append(d)
            print(f"t{t} {nm}: {d*1000:.0f} ms "
                  f"({len(reads)/d:.0f} r/s)", flush=True)

    out = {}
    for nm in names:
        w = sorted(stats[nm]["walls"])
        out[nm] = {
            "config": CONFIGS[nm],
            "best_ms": round(w[0] * 1000, 1),
            "median_ms": round(w[len(w) // 2] * 1000, 1),
            "best_reads_per_sec": round(len(reads) / w[0], 1),
            "phase_times_best": stats[nm]["best_phase"],
        }
        print(nm, json.dumps(out[nm]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
