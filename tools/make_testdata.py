#!/usr/bin/env python
"""Generate a synthetic evaluation dataset: reference FASTA, pore-model
TSV, reads as sigbin (plus multi-read FAST5 when h5py is installed), and
a ground-truth TSV.

Stands in for the reference's test/data downloads (d1-d5), which are not
redistributable; the simulated signal model matches the pipeline's
assumptions (per-base dwell around sample_rate/bp_per_sec, Gaussian pA
noise). Usage:

    python tools/make_testdata.py OUTDIR --genome-kb 100 --reads 200 \
        --random-frac 0.2
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rawalign_tpu.io import fast5
from rawalign_tpu.testing import synth


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--genome-kb", type=float, nargs="+", default=[100.0])
    ap.add_argument("--reads", type=int, default=200)
    ap.add_argument("--read-bp-min", type=int, default=400)
    ap.add_argument("--read-bp-max", type=int, default=2000)
    ap.add_argument("--noise-pa", type=float, default=1.5)
    ap.add_argument("--random-frac", type=float, default=0.0,
                    help="fraction of unmappable pure-noise reads")
    ap.add_argument("--k", type=int, default=6)
    args = ap.parse_args()

    os.makedirs(args.outdir, exist_ok=True)
    ds = synth.make_dataset(
        seed=args.seed,
        genome_lengths=[int(kb * 1000) for kb in args.genome_kb],
        n_reads=args.reads,
        read_len_bp=(args.read_bp_min, args.read_bp_max),
        k=args.k,
        noise_pa=args.noise_pa,
        frac_random=args.random_frac,
    )
    synth.write_dataset(args.outdir, ds)
    if fast5.HAVE_H5PY:
        fast5.write_fast5(
            os.path.join(args.outdir, "reads.fast5"),
            [(r.name, r.signal) for r in ds.reads],
        )
    with open(os.path.join(args.outdir, "truth.tsv"), "w") as f:
        f.write("read\tref\tstrand\tstart\tend\n")
        for r in ds.reads:
            ref = ds.seqs[r.ref_id].name if r.ref_id >= 0 else "*"
            strand = "-" if r.strand else "+"
            f.write(f"{r.name}\t{ref}\t{strand}\t{r.ref_start}\t{r.ref_end}\n")
    print(f"wrote dataset to {args.outdir}: {len(ds.seqs)} seqs, "
          f"{len(ds.reads)} reads")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
