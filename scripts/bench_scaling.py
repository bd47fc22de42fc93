"""Multi-device scaling benchmark for the distributed mapping ENGINE.

Runs the full end-to-end DistributedMappingEngine (events -> sketch ->
all-to-all-routed sharded index lookup -> chaining DP -> DTW tile
evaluation -> decisions/PAF; rawalign_tpu.parallel.dist_engine) over
meshes of 1..N devices and reports weak-scaling efficiency — the
BASELINE.md target is >= 80% efficiency from 1 to N hosts.

On a real pod, run one process per host after
``rawalign_tpu.parallel.distributed.init()``; here it also runs on the
virtual CPU mesh for CI:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python scripts/bench_scaling.py --reads-per-device 8

Prints one JSON line per mesh layout plus a final summary line.
``--step-only`` benchmarks just the jitted per-chunk step
(parallel.mesh.build_mapping_step), isolating device scaling from the
host orchestration.
"""

import argparse
import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def _bench_engine(args, jax, ds, idx, io, mo, layouts):
    """Weak-scaling protocol (VERDICT r3 item 6): fixed per-device work,
    every engine warmed (compile cache hot) BEFORE any measurement, then
    >= `--trials` measured passes per layout taken INTERLEAVED (layout
    order re-visited each trial) so host-load drift hits all layouts
    equally; per-layout result is the best trial (this host has 6-60%
    hypervisor CPU steal — the best window is the least-contaminated
    measurement)."""
    from rawalign_tpu.map import engine as dengine
    from rawalign_tpu.parallel import mesh as pmesh
    from rawalign_tpu.parallel.dist_engine import DistributedMappingEngine

    engines = {}
    workloads = {}
    for nd in layouts:
        n_shard = args.n_shard if nd % args.n_shard == 0 else 1
        n_data = nd // n_shard
        n_reads = args.reads_per_device * nd  # fixed work per device
        reads = [
            (f"r{i}", ds.reads[i % len(ds.reads)].signal)
            for i in range(n_reads)
        ]
        # ALL layouts (including nd=1) run the SAME distributed program
        # so the curve measures its scaling, not the gap between the
        # dist engine and the separately-optimized single-chip engine
        # (which is reported as its own reference row below)
        mesh = pmesh.make_mesh(n_data, n_shard)
        eng = DistributedMappingEngine(
            idx, mo, mesh, batch_size=args.reads_per_device * nd
        )
        engines[nd] = (eng, [n_data, n_shard])
        workloads[nd] = reads
    sc_engine = dengine.MappingEngine(
        idx, mo, batch_size=args.reads_per_device
    )
    sc_reads = workloads[layouts[0]]
    # warm every layout first: no compile inside any timed window
    for nd in layouts:
        for _ in engines[nd][0].map_reads(iter(workloads[nd])):
            pass
    for _ in sc_engine.map_reads(iter(sc_reads)):
        pass
    trials = {nd: [] for nd in layouts}
    sc_trials = []
    for _t in range(args.trials):
        for nd in layouts:
            t0 = time.perf_counter()
            n_out = sum(
                1 for _ in engines[nd][0].map_reads(iter(workloads[nd]))
            )
            dt = time.perf_counter() - t0
            trials[nd].append(n_out / dt)
        t0 = time.perf_counter()
        n_out = sum(1 for _ in sc_engine.map_reads(iter(sc_reads)))
        sc_trials.append(n_out / (time.perf_counter() - t0))
    print(
        json.dumps(
            {
                "metric": "singlechip_engine_reads_per_sec",
                "reads": len(sc_reads),
                "reads_per_sec_trials": [round(x, 1) for x in sc_trials],
                "reads_per_sec": round(max(sc_trials), 1),
                "note": "the optimized single-chip engine on the same "
                "per-device workload (reference row, not part of the "
                "scaling curve)",
            }
        )
    )
    results = {}
    for nd in layouts:
        best = max(trials[nd])
        results[nd] = (best, nd)
        print(
            json.dumps(
                {
                    "metric": "engine_reads_per_sec",
                    "devices": nd,
                    "mesh": engines[nd][1],
                    "reads": len(workloads[nd]),
                    "reads_per_sec_trials": [round(x, 1) for x in trials[nd]],
                    "reads_per_sec": round(best, 1),
                }
            )
        )
    return results, trials


def _bench_step(args, jax, ds, idx, io, mo, layouts):
    from rawalign_tpu.parallel import mesh as pmesh

    L = mo.chunk_size
    results = {}
    for nd in layouts:
        n_shard = args.n_shard if nd % args.n_shard == 0 else 1
        n_data = nd // n_shard
        mesh = pmesh.make_mesh(n_data, n_shard)
        keys_sh, id_sh, ps_sh, bounds = pmesh.shard_index_by_hash_range(
            idx.keys, idx.val_id, idx.val_ps, n_shard
        )
        B = args.reads_per_device * n_data
        chunks = np.zeros((B, L), dtype=np.float32)
        lengths = np.zeros(B, dtype=np.int32)
        for i in range(B):
            sig = ds.reads[i % len(ds.reads)].signal[:L]
            chunks[i, : sig.size] = sig
            lengths[i] = sig.size
        step = pmesh.build_mapping_step(
            mesh, io_opt=io, mo_opt=mo, max_occ=16, max_anchors=512
        )
        out = step(chunks, lengths, keys_sh, id_sh, ps_sh, bounds)
        jax.block_until_ready(out)  # compile
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = step(chunks, lengths, keys_sh, id_sh, ps_sh, bounds)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / args.iters
        rps = B / dt
        results[nd] = (rps, n_data)
        print(
            json.dumps(
                {
                    "metric": "chunk_steps_per_sec",
                    "devices": nd,
                    "mesh": [n_data, n_shard],
                    "global_batch": B,
                    "reads_per_sec": round(rps, 1),
                    "step_ms": round(dt * 1e3, 2),
                }
            )
        )
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads-per-device", type=int, default=8)
    ap.add_argument("--genome-kb", type=int, default=50)
    ap.add_argument("--n-shard", type=int, default=1,
                    help="index shards per layout (1 = replicated index)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--trials", type=int, default=3,
                    help="interleaved measured passes per layout")
    ap.add_argument("--out", default=None, help="write JSON record here")
    ap.add_argument("--step-only", action="store_true",
                    help="benchmark only the jitted per-chunk device step")
    args = ap.parse_args()

    import os

    import jax

    # apply JAX_PLATFORMS through the config as well, so the virtual
    # CPU mesh invocation works whatever plugin is installed
    if os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

    from rawalign_tpu import config
    from rawalign_tpu.index import index as dindex
    from rawalign_tpu.testing import synth

    n_dev = len(jax.devices())
    ds = synth.make_dataset(
        seed=11,
        genome_lengths=[args.genome_kb * 1000],
        n_reads=max(args.reads_per_device * n_dev, 64),
        read_len_bp=(400, 900),
        noise_pa=1.5,
    )
    io = config.IndexOptions()
    mo = config.MappingOptions()
    config.set_opt("sensitive", io, mo)
    from rawalign_tpu.config import MappingFlag

    mo.set_flag(MappingFlag.DTW_EVALUATE_CHAINS)
    mo.max_events_per_chunk = 512
    idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)

    if args.n_shard < 1 or args.n_shard & (args.n_shard - 1):
        ap.error(f"--n-shard must be a power of two (got {args.n_shard})")
    layouts = []
    d = 1
    while d <= n_dev:
        if d % args.n_shard == 0 or args.n_shard == 1:
            layouts.append(d)
        d *= 2
    if not layouts:
        ap.error(
            f"--n-shard {args.n_shard} exceeds available devices ({n_dev})"
        )

    all_trials = None
    if args.step_only:
        results = _bench_step(args, jax, ds, idx, io, mo, layouts)
    else:
        results, all_trials = _bench_engine(args, jax, ds, idx, io, mo,
                                            layouts)

    # weak scaling: the global batch grows with the scaled axis, so
    # normalize throughput per scaled unit
    rps0, n0 = results[layouts[0]]
    curve = {
        nd: round((results[nd][0] / nd) / (rps0 / n0), 3) for nd in layouts
    }
    eff = curve[layouts[-1]]
    summary = {
        "metric": "scaling_efficiency",
        "value": eff,
        "unit": f"1->{layouts[-1]} devices (weak scaling, "
        + ("step" if args.step_only else "engine end-to-end")
        + ")",
        "vs_baseline": round(eff / 0.8, 3),
        "efficiency_curve": curve,
    }
    if jax.default_backend() == "cpu":
        # On the virtual CPU mesh all N "devices" timeshare this host's
        # C physical cores: even a PERFECT program cannot hold per-
        # device throughput flat past N=C — the expected raw efficiency
        # is min(N, C)/N. The measurable quantity here is the sharded
        # program's overhead beyond that timesharing model; >= 0.8
        # corrected means the distributed program itself scales, and
        # the real >= 80% target can only be measured on real chips.
        import os as _os

        C = _os.cpu_count() or 1
        corrected = {
            nd: round(curve[nd] * nd / min(nd, C), 3) for nd in layouts
        }
        summary["physical_cores"] = C
        summary["timeshare_expected_efficiency"] = {
            nd: round(min(nd, C) / nd, 3) for nd in layouts
        }
        summary["corrected_efficiency_curve"] = corrected
        summary["corrected_value"] = corrected[layouts[-1]]
        summary["note"] = (
            "virtual CPU mesh: N virtual devices timeshare "
            f"{C} physical cores, so raw weak-scaling efficiency is "
            "bounded by min(N,C)/N regardless of program quality; "
            "corrected_* divides that bound out. corrected > 1 means "
            "the small-N points are host-orchestration-bound, not "
            "compute-bound (extra virtual devices ride otherwise-idle "
            "cores). Real ICI scaling requires real chips."
        )
    print(json.dumps(summary))
    if args.out:
        rec = {"summary": summary}
        if all_trials is not None:
            rec["trials"] = {
                str(nd): [round(x, 1) for x in all_trials[nd]]
                for nd in all_trials
            }
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
