"""Command-line interface.

Single-binary usage mirroring the reference (main.cpp:255-316):

    rawalign-tpu [options] <target.fa|target.idx.npz> [query.fast5/dir ...]

Indexing options, presets and mapping flags replicate the reference's
option surface (main.cpp:26-62,131-150); device-engine knobs (batch size,
occurrence cap, chaining window) are additions.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from rawalign_tpu import __version__, config
from rawalign_tpu.config import BorderConstraint, FillMethod, MappingFlag
from rawalign_tpu.index import index as dindex
from rawalign_tpu.io import fast5, fasta, paf
from rawalign_tpu.pore_model import load_pore_model
from rawalign_tpu.until import SequenceUntil


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rawalign-tpu",
        description="GPU raw nanopore signal mapper "
        "(Seed-Filter-Align with banded DTW)",
    )
    p.add_argument("target", nargs="?", help="reference FASTA or prebuilt index (.npz)")
    p.add_argument("query", nargs="*", help="FAST5/sigbin files or directories")
    p.add_argument("-d", dest="dump", help="dump index to FILE")
    p.add_argument("-p", dest="pore", help="k-mer pore model FILE")
    p.add_argument("-k", type=int, help="pore model k-mer size")
    p.add_argument("-e", type=int, help="events per hash value")
    p.add_argument("-q", type=int, help="significant signal bits")
    p.add_argument("-l", dest="lq", type=int, help="low bits of q to quantize")
    p.add_argument("-w", type=int, help="minimizer window (0=off)")
    p.add_argument("-n", type=int, help="BLEND neighbors (unsupported, parity)")
    p.add_argument("-t", dest="threads", type=int, default=3, help="host worker threads")
    p.add_argument("-K", dest="minibatch", default=None, help="mapping mini-batch size")
    p.add_argument("-x", dest="preset", help="preset: sensitive|fast|faster|viral|sequence-until")
    p.add_argument("-o", dest="output", default="-", help="output PAF file")
    p.add_argument("--version", action="version", version=__version__)
    # chaining
    p.add_argument("--min-events", type=int)
    p.add_argument("--max-gap", type=int)
    p.add_argument("--max-target-gap", type=int)
    p.add_argument("--max-chains", type=int, help="chaining band length")
    p.add_argument("--min-anchors", type=int)
    p.add_argument("--best-chains", type=int)
    p.add_argument("--min-score", type=float)
    # mapping
    p.add_argument("--max-chunks", type=int)
    p.add_argument("--stop-min-anchor", type=int)
    p.add_argument("--map-min-anchor", type=int)
    p.add_argument("--stop-best-ratio", type=float)
    p.add_argument("--map-best-ratio", type=float)
    p.add_argument("--stop-mean-ratio", type=float)
    p.add_argument("--map-mean-ratio", type=float)
    p.add_argument("--bp-per-sec", type=int)
    p.add_argument("--sample-rate", type=int)
    p.add_argument("--chunk-size", type=int)
    # DTW
    p.add_argument("--dtw-evaluate-chains", action="store_true")
    p.add_argument("--dtw-output-cigar", action="store_true")
    p.add_argument("--dtw-border-constraint", choices=["global", "sparse", "local"])
    p.add_argument("--dtw-log-scores", action="store_true")
    p.add_argument("--no-chainingscore-filtering", action="store_true")
    p.add_argument("--dtw-match-bonus", type=float)
    p.add_argument("--dtw-fill-method", help="'banded', 'full' or 'banded=FRAC'")
    p.add_argument("--dtw-min-score", type=float)
    p.add_argument("--output-chains", action="store_true")
    p.add_argument("--log-anchors", action="store_true")
    p.add_argument("--log-num-anchors", action="store_true")
    # sequence until
    p.add_argument("--sequence-until", action="store_true")
    p.add_argument("--threshold", type=float)
    p.add_argument("--n-samples", type=int)
    p.add_argument("--test-frequency", type=int)
    p.add_argument("--min-reads", type=int)
    # device engine knobs
    p.add_argument("--batch-size", type=int, default=32, help="reads per device batch")
    p.add_argument("--max-occ", type=int, default=4096,
                   help="per-seed hit-count safety cap (the reference "
                   "gathers every hit, rmap.cpp:371-391; the default "
                   "never binds at evaluated genome scales)")
    p.add_argument("--chain-window", type=int, default=64, help="chaining DP predecessor window")
    p.add_argument("--max-anchors", type=int, default=2048,
                   help="per-read anchor budget for DEVICE chain paths; "
                   "the native (default) chain path sizes its arrays "
                   "dynamically and only decimates beyond the 128k "
                   "ceiling — lossless at evaluated scales")
    p.add_argument("--seeds-out", type=int, default=768,
                   help="compacted seed slots per chunk (device stage output)")
    p.add_argument("--pipeline-depth", type=int, default=4,
                   help="read groups advancing round-robin (overlaps host and device work)")
    p.add_argument("--engine", choices=["device", "golden"], default="device",
                   help="'golden' runs the NumPy reference-replica engine")
    p.add_argument("--chain-impl", choices=["auto", "native", "device"],
                   default="auto",
                   help="chaining DP placement: host C (native) or the "
                   "device kernel; auto prefers native when the host "
                   "library is built")
    p.add_argument("--stage1-impl",
                   choices=["auto", "device", "host", "hybrid"],
                   default="auto",
                   help="events+sketch+lookup placement: 'hybrid' "
                   "(host-C event detector — bit-identical to the "
                   "reference's C-double semantics — + device sketch/"
                   "lookup; the default when the native lib is built), "
                   "'device' (everything in one jitted dispatch, "
                   "f32 event detector), 'host' (C events + C sketch + "
                   "binary-search lookup; one device round trip per "
                   "round). 'auto' = hybrid if available else device")
    # observability / fault tolerance (SURVEY §5: the reference has none;
    # these are framework additions)
    p.add_argument("--resume", action="store_true",
                   help="skip reads already present in the -o PAF and append")
    p.add_argument("--profile", metavar="DIR",
                   help="capture a jax.profiler device trace into DIR")
    p.add_argument("--debug-nans", action="store_true",
                   help="enable jax debug_nans (slow; for debugging)")
    p.add_argument("--selfcheck", type=float, default=0.0, metavar="FRAC",
                   help="sanitizer analog: re-map a deterministic FRAC "
                   "sample of reads with the golden host oracle and "
                   "report any mapping-column divergence (0=off). "
                   "Capture stops after --selfcheck-max-reads eligible "
                   "reads (stream order)")
    p.add_argument("--selfcheck-max-reads", type=int, default=64,
                   metavar="N",
                   help="cap on reads captured for --selfcheck (bounds "
                   "the golden re-map cost; raise for full audits)")
    p.add_argument("--mt-mode", choices=["share", "wall"], default="share",
                   help="mt:f tag semantics for the batched engine: "
                   "'share' = amortized per-read share of each round's "
                   "wall (batching-fair aggregate metric), 'wall' = "
                   "strict reference semantics — each read's wall clock "
                   "across its live rounds (rmap.cpp:684-694; directly "
                   "comparable to the binary's mt:f, double-counts "
                   "shared batch cost)")
    p.add_argument("--selfcheck-strict", action="store_true",
                   help="exit nonzero if --selfcheck finds divergent "
                   "reads (for CI/automation)")
    return p


def parse_num(s: str) -> int:
    s = s.strip()
    mult = 1
    if s and s[-1] in "kKmMgG":
        mult = {"k": 10**3, "m": 10**6, "g": 10**9}[s[-1].lower()]
        s = s[:-1]
    return int(float(s) * mult + 0.499)


def apply_options(args) -> tuple[config.IndexOptions, config.MappingOptions]:
    io = config.IndexOptions()
    mo = config.MappingOptions()
    if args.preset:
        config.set_opt(args.preset, io, mo)
    for name, attr in [
        ("k", "k"), ("e", "e"), ("q", "q"), ("lq", "lq"), ("w", "w"), ("n", "n")
    ]:
        v = getattr(args, name)
        if v is not None:
            setattr(io, attr, v)
    simple = {
        "min_events": "min_events",
        "max_gap": "max_gap_length",
        "max_target_gap": "max_target_gap_length",
        "max_chains": "chaining_band_length",
        "min_anchors": "min_num_anchors",
        "best_chains": "num_best_chains",
        "min_score": "min_chaining_score",
        "max_chunks": "max_num_chunk",
        "stop_min_anchor": "min_chain_anchor",
        "map_min_anchor": "min_chain_anchor_out",
        "stop_best_ratio": "min_bestmap_ratio",
        "map_best_ratio": "min_bestmap_ratio_out",
        "stop_mean_ratio": "min_meanmap_ratio",
        "map_mean_ratio": "min_meanmap_ratio_out",
        "bp_per_sec": "bp_per_sec",
        "sample_rate": "sample_rate",
        "chunk_size": "chunk_size",
        "dtw_match_bonus": "dtw_match_bonus",
        "dtw_min_score": "dtw_min_score",
        "threshold": "t_threshold",
        "n_samples": "tn_samples",
        "test_frequency": "ttest_freq",
        "min_reads": "tmin_reads",
    }
    for arg_name, opt_name in simple.items():
        v = getattr(args, arg_name)
        if v is not None:
            setattr(mo, opt_name, v)
    if args.minibatch is not None:
        mo.mini_batch_size = parse_num(args.minibatch)
    flags = [
        ("sequence_until", MappingFlag.SEQUENCE_UNTIL),
        ("dtw_evaluate_chains", MappingFlag.DTW_EVALUATE_CHAINS),
        ("dtw_output_cigar", MappingFlag.DTW_OUTPUT_CIGAR),
        ("dtw_log_scores", MappingFlag.DTW_LOG_SCORES),
        ("no_chainingscore_filtering", MappingFlag.DISABLE_CHAININGSCORE_FILTERING),
        ("output_chains", MappingFlag.OUTPUT_CHAINS),
        ("log_anchors", MappingFlag.LOG_ANCHORS),
        ("log_num_anchors", MappingFlag.LOG_NUM_ANCHORS),
    ]
    for arg_name, flag in flags:
        if getattr(args, arg_name):
            mo.flag |= flag
    if args.dtw_border_constraint:
        mo.dtw_border_constraint = {
            "global": BorderConstraint.GLOBAL,
            "sparse": BorderConstraint.SPARSE,
            "local": BorderConstraint.LOCAL,
        }[args.dtw_border_constraint]
    if args.dtw_fill_method:
        fm = args.dtw_fill_method
        if fm == "banded":
            mo.dtw_fill_method = FillMethod.BANDED
        elif fm == "full":
            mo.dtw_fill_method = FillMethod.FULL
        elif fm.startswith("banded="):
            mo.dtw_fill_method = FillMethod.BANDED
            mo.dtw_band_radius_frac = float(fm[7:])
        else:
            raise SystemExit(f"[ERROR] unknown DTW fill method '{fm}'")
    return io, mo


def main(argv=None) -> int:
    t0 = time.time()
    args = build_parser().parse_args(argv)
    if args.target is None:
        build_parser().print_help()
        return 1
    io, mo = apply_options(args)

    # load or build index; reference-format indexes are detected by their
    # "RI" magic (rawindex.cpp:441-463), ours by .npz
    def _is_ref_index(path: str) -> bool:
        try:
            with open(path, "rb") as f:
                return f.read(2) == b"RI"
        except OSError:
            return False

    if args.target.endswith(".npz"):
        idx = dindex.RawIndex.load(args.target)
        print(
            f"[M::main::{time.time()-t0:.3f}] loaded the index for "
            f"{idx.n_seq} target sequence(s)",
            file=sys.stderr,
        )
    elif _is_ref_index(args.target):
        from rawalign_tpu.index.ref_format import load_reference_index

        idx = load_reference_index(args.target)
        print(
            f"[M::main::{time.time()-t0:.3f}] loaded the reference-format "
            f"index for {idx.n_seq} target sequence(s)",
            file=sys.stderr,
        )
    else:
        if not args.pore:
            print(
                "[ERROR] specify a pore model file with -p when indexing "
                "from a sequence file",
                file=sys.stderr,
            )
            return 1
        model = load_pore_model(args.pore)
        io.k = model.k
        seqs = list(fasta.read_fasta(args.target))
        idx = dindex.build_index(seqs, model.pore_vals, io)
        print(
            f"[M::main::{time.time()-t0:.3f}] built the index for "
            f"{idx.n_seq} target sequence(s), {idx.keys.size} seeds",
            file=sys.stderr,
        )
        if args.dump:
            if args.dump.endswith(".ind"):
                from rawalign_tpu.index.ref_format import dump_reference_index

                dump_reference_index(idx, args.dump)
            else:
                idx.save(args.dump)
            print(f"[M::main] index dumped to {args.dump}", file=sys.stderr)

    if not args.query:
        if not args.dump and not args.target.endswith(".npz"):
            print(
                "[ERROR] missing input: specify query signal files or -d "
                "to store the index",
                file=sys.stderr,
            )
            return 1
        return 0

    files: list[str] = []
    for qpath in args.query:
        files.extend(fast5.find_signal_files(qpath))
    if not files:
        print("[ERROR] no signal files found", file=sys.stderr)
        return 1

    # resume: skip reads already emitted to the output PAF (the index file
    # is the unit of precomputed state in the reference, SURVEY §5; here
    # mapping additionally resumes at read granularity)
    already_done: set[str] = set()
    if args.resume and args.output != "-":
        try:
            with open(args.output) as f:
                for line in f:
                    if line.strip():
                        already_done.add(line.split("\t", 1)[0])
            print(
                f"[M::main] resume: {len(already_done)} reads already mapped",
                file=sys.stderr,
            )
        except OSError:
            pass

    if args.output == "-":
        out = sys.stdout
    else:
        out = open(args.output, "a" if args.resume else "w")
    su = (
        SequenceUntil(idx.n_seq, mo)
        if mo.flag & MappingFlag.SEQUENCE_UNTIL
        else None
    )
    if args.debug_nans:
        import jax

        jax.config.update("jax_debug_nans", True)
    if args.profile:
        import jax

        jax.profiler.start_trace(args.profile)

    checker = None
    if args.selfcheck > 0.0:
        from rawalign_tpu.selfcheck import SelfCheck

        checker = SelfCheck(
            idx, mo, fraction=args.selfcheck,
            max_reads=args.selfcheck_max_reads,
        )

    def reads():
        from rawalign_tpu.io.prefetch import prefetch_signals

        for name, sig in prefetch_signals(files, n_threads=args.threads):
            if name not in already_done:
                if checker is not None:
                    checker.capture(name, sig)
                yield name, sig

    n_out = 0
    if args.engine == "golden":
        from rawalign_tpu.golden import engine as gengine

        results = gengine.map_reads(idx, reads(), mo)
    else:
        from rawalign_tpu.map.engine import MappingEngine

        engine = MappingEngine(
            idx,
            mo,
            batch_size=args.batch_size,
            max_occ=args.max_occ,
            chain_window=args.chain_window,
            max_anchors=args.max_anchors,
            seeds_out=args.seeds_out,
            pipeline_depth=args.pipeline_depth,
            chain_impl=args.chain_impl,
            stage1_impl=args.stage1_impl,
            mt_mode=args.mt_mode,
        )
        results = engine.map_reads(reads())
    su_stopped = False
    for res in results:
        line = paf.paf_line(res)
        if su_stopped and res.mapped:
            # post-stop reads are emitted as forced-unmapped lines that
            # keep read_length/mapq/tags — the reference's step-3 output
            # for batch indices >= su_stop (rmap.cpp:960-964; with the
            # sequence-until preset's 750M mini-batch the whole run is
            # one batch, so every post-stop read takes this form)
            cols = line.split("\t")
            cols[2:11] = ["*"] * 9
            line = "\t".join(cols)
        print(line, file=out)
        n_out += 1
        if checker is not None:
            checker.record(res)
        if su is not None and not su_stopped and res.mapped:
            ref_id = idx.seq_names.index(res.ref_name)
            if su.add_mapped_read(ref_id, res.fragment_length):
                su_stopped = True
                print(
                    "[M::map] Sequence Until is activated, stopping "
                    f"sequencing after processing {su.n_reads} mapped reads",
                    file=sys.stderr,
                )
    if args.profile:
        import jax

        jax.profiler.stop_trace()
    selfcheck_failed = False
    if checker is not None:
        rep = checker.report()
        selfcheck_failed = rep["n_divergent"] > 0
    if out is not sys.stdout:
        out.close()
    # final resource report (main.cpp:389-394)
    import resource

    ru = resource.getrusage(resource.RUSAGE_SELF)
    cpu = ru.ru_utime + ru.ru_stime
    # ru_maxrss is KiB on Linux but bytes on macOS
    rss_div = 1024.0**3 if sys.platform == "darwin" else 1024.0**2
    peak_gb = ru.ru_maxrss / rss_div
    print(
        f"[M::main] Version: {__version__}\n"
        f"[M::main] Real time: {time.time()-t0:.3f} sec; "
        f"CPU: {cpu:.3f} sec; Peak RSS: {peak_gb:.3f} GB; reads: {n_out}",
        file=sys.stderr,
    )
    from rawalign_tpu import runtime as _rt

    ts = _rt.transfer_stats
    if ts["retries"] or ts["stall_warnings"] or ts["failures"]:
        print(
            f"[M::main] Device transfers: {ts['retries']} retries, "
            f"{ts['stall_warnings']} stall warnings, "
            f"{ts['failures']} hard failures",
            file=sys.stderr,
        )
    if selfcheck_failed and args.selfcheck_strict:
        # automation must be able to detect the silent-corruption class
        # --selfcheck exists to catch without scraping stderr
        return 7
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
