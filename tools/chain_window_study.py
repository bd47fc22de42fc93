#!/usr/bin/env python
"""Chaining-window parity study: device engine vs the golden engine on
anchor-dense (tandem-repeat) genomes.

The reference's chaining DP considers up to 5000 predecessors per anchor
(rmap.cpp:440-484, `chaining_band_length`); the device kernel uses a
bounded window (engine `chain_window`). On clean genomes anchors per
(target, strand) segment are sparse and a small window is exact; on
repetitive targets anchor lists get dense and a too-small window can
split or mis-score chains. This tool quantifies that: for each scenario
it maps reads with the golden engine (full reference semantics, no
occurrence cap) and with the device engine over a (window, max_occ)
grid, reporting PAF-line equality and locus agreement.

Usage: python tools/chain_window_study.py [--reads 24] [--out study.json]
Runs on CPU (jax_platforms=cpu) — fully host-side, no accelerator needed.
"""

import argparse
import json
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from rawalign_tpu import config
from rawalign_tpu.golden import engine as gengine
from rawalign_tpu.index import index as dindex
from rawalign_tpu.io import paf
from rawalign_tpu.map.engine import MappingEngine
from rawalign_tpu.testing import synth


def _strip_time(line: str) -> str:
    return re.sub(r"mt:f:[0-9.]+", "mt:f:X", line)


def scenarios(n_reads):
    rng = np.random.default_rng(99)
    yield "clean_100kb", synth.make_dataset(
        seed=21, genome_lengths=[100_000], n_reads=n_reads,
        read_len_bp=(300, 900), noise_pa=1.5,
    )
    yield "tandem_2kbx25", synth.make_dataset(
        seed=22, n_reads=n_reads, read_len_bp=(300, 900), noise_pa=1.5,
        seqs=synth.tandem_genome(
            rng, unit_len=2000, copies=25, flank=10_000, divergence=0.02
        ),
    )
    yield "tandem_300bx100", synth.make_dataset(
        seed=23, n_reads=n_reads, read_len_bp=(300, 900), noise_pa=1.5,
        seqs=synth.tandem_genome(
            rng, unit_len=300, copies=100, flank=10_000, divergence=0.05
        ),
    )
    yield "noisy_100kb", synth.make_dataset(
        seed=24, genome_lengths=[100_000], n_reads=n_reads,
        read_len_bp=(300, 900), noise_pa=3.0,
    )
    # ---- 5 Mb adversarial scenarios (VERDICT r2 weak #5): beyond
    # tandem arrays — paralogs scattered across the target axis, where
    # the bounded predecessor window and the anchor budget both bite
    yield "segdup_5mb", synth.make_dataset(
        seed=25, n_reads=n_reads, read_len_bp=(300, 900), noise_pa=1.5,
        seqs=synth.segdup_genome(
            rng, total_len=5_000_000, dup_len=20_000, n_dups=30,
            divergence=0.02,
        ),
    )
    yield "shuffled_5mb", synth.make_dataset(
        seed=26, n_reads=n_reads, read_len_bp=(300, 900), noise_pa=1.5,
        seqs=synth.shuffled_repeat_genome(
            rng, n_units=8, unit_len=1000, n_blocks=3000,
            divergence=0.03, spacer_len=400,
        ),
    )


def locus_match(res, read, seqs):
    if not res.mapped or read.ref_id < 0:
        return res.mapped == (read.ref_id >= 0)
    if res.ref_name != seqs[read.ref_id].name or res.rev != read.strand:
        return False
    lo = res.fragment_start_position
    hi = lo + res.fragment_length
    return not (hi < read.ref_start or lo > read.ref_end)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=24)
    ap.add_argument("--out", default=None)
    ap.add_argument("--windows", type=int, nargs="+",
                    default=[64, 256, 1024])
    ap.add_argument("--max-occs", type=int, nargs="+", default=[64, 256])
    args = ap.parse_args()

    out = {}
    for name, ds in scenarios(args.reads):
        io = config.IndexOptions()
        mo = config.MappingOptions()
        config.set_opt("sensitive", io, mo)
        mo.set_flag(config.MappingFlag.DTW_EVALUATE_CHAINS)
        idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)
        golden = {}
        for r in ds.reads:
            res = gengine.map_read(idx, r.signal, r.name, mo)
            golden[r.name] = (_strip_time(paf.paf_line(res)), res)
        by_name = {r.name: r for r in ds.reads}
        rows = {}
        for window in args.windows:
            for occ in args.max_occs:
                eng = MappingEngine(
                    idx, mo, batch_size=8, chain_window=window,
                    max_occ=occ, max_anchors=4096,
                )
                n_exact = n_locus_eq_golden = n_correct = n_mapped = 0
                for res in eng.map_reads(
                    (r.name, r.signal) for r in ds.reads
                ):
                    want_line, want_res = golden[res.read_name]
                    line = _strip_time(paf.paf_line(res))
                    n_exact += line == want_line
                    read = by_name[res.read_name]
                    n_mapped += res.mapped
                    n_correct += locus_match(res, read, ds.seqs)
                    n_locus_eq_golden += (
                        res.mapped == want_res.mapped
                        and (
                            not res.mapped
                            or (
                                res.ref_name == want_res.ref_name
                                and res.rev == want_res.rev
                                and abs(
                                    res.fragment_start_position
                                    - want_res.fragment_start_position
                                )
                                <= 100
                            )
                        )
                    )
                N = len(ds.reads)
                rows[f"w{window}_occ{occ}"] = {
                    "paf_exact": f"{n_exact}/{N}",
                    "same_locus_as_golden": f"{n_locus_eq_golden}/{N}",
                    "mapped": n_mapped,
                    "truth_correct": f"{n_correct}/{N}",
                    "anchors_dropped": eng.counters["anchors_dropped"],
                    "occ_hits_dropped": eng.counters["seed_hits_dropped"],
                }
                print(f"{name} w={window} occ={occ}: "
                      f"{rows[f'w{window}_occ{occ}']}", file=sys.stderr)
        golden_correct = sum(
            locus_match(res, by_name[nm], ds.seqs)
            for nm, (_l, res) in golden.items()
        )
        out[name] = {
            "golden_truth_correct": f"{golden_correct}/{len(ds.reads)}",
            "configs": rows,
        }
    print(json.dumps(out, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
