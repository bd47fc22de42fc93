#!/usr/bin/env python
"""Accuracy/throughput metrics from a PAF against ground truth.

This framework's analog of the reference's evaluation pipeline
(test/scripts/compare_pafs.py + `uncalled pafstats --annotate`): computes
tp/fp/fn/tn, precision, recall, F1, and the mapping-time statistics from
the PAF ``mt:f`` tag and the chunk counts from ``ci:i`` (the same
instruments the reference keys its figures off,
compare_pafs.py:37-63).

Ground truth is either a truth.tsv from tools/make_testdata.py or a PAF
produced by a trusted mapper on basecalled reads.

    python tools/compare_pafs.py out.paf truth.tsv [--tolerance 100]
"""

import argparse
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def load_truth_tsv(path):
    truth = {}
    with open(path) as f:
        header = f.readline()
        for line in f:
            fields = line.rstrip("\n").split("\t")
            if len(fields) < 5:
                continue
            name, ref, strand, start, end = fields[:5]
            truth[name] = (ref, strand, int(start), int(end))
    return truth


def parse_paf_line(line):
    f = line.rstrip("\n").split("\t")
    rec = {
        "name": f[0],
        "mapped": f[2] != "*",
        "tags": {},
    }
    if rec["mapped"]:
        rec.update(
            strand=f[4],
            ref=f[5],
            t_start=int(f[7]),
            t_end=int(f[8]),
        )
    for tag in f[12:]:
        parts = tag.split(":", 2)
        if len(parts) == 3:
            rec["tags"][parts[0]] = parts[2]
    return rec


def evaluate(paf_path, truth, tolerance=100):
    tp = fp = fn = tn = 0
    times = []
    chunks_mapped = []
    chunks_unmapped = []
    with open(paf_path) as f:
        for line in f:
            if not line.strip():
                continue
            rec = parse_paf_line(line)
            t = truth.get(rec["name"])
            if "mt" in rec["tags"]:
                times.append(float(rec["tags"]["mt"]))
            ci = int(rec["tags"].get("ci", 0))
            if rec["mapped"]:
                chunks_mapped.append(ci)
            else:
                chunks_unmapped.append(ci)
            if t is None:
                continue
            ref, strand, start, end = t
            is_mappable = ref != "*"
            if rec["mapped"]:
                if (
                    is_mappable
                    and rec["ref"] == ref
                    and rec["strand"] == strand
                    and not (
                        rec["t_end"] < start - tolerance
                        or rec["t_start"] > end + tolerance
                    )
                ):
                    tp += 1
                else:
                    fp += 1
            else:
                if is_mappable:
                    fn += 1
                else:
                    tn += 1
    precision = tp / (tp + fp) if tp + fp else 0.0
    recall = tp / (tp + fn) if tp + fn else 0.0
    f1 = (
        2 * precision * recall / (precision + recall)
        if precision + recall
        else 0.0
    )
    return {
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "tn": tn,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "mean_time_ms": statistics.fmean(times) if times else 0.0,
        "median_time_ms": statistics.median(times) if times else 0.0,
        "mean_chunks_mapped": (
            statistics.fmean(chunks_mapped) if chunks_mapped else 0.0
        ),
        "mean_chunks_unmapped": (
            statistics.fmean(chunks_unmapped) if chunks_unmapped else 0.0
        ),
        # the batched engine's mt:f is the read's AMORTIZED share of the
        # rounds it was live in (engine.py charge_round), not the
        # reference's exclusive per-read wall time (rmap.cpp:684-694):
        # comparable in aggregate (sum over reads ~= mapping wall), but
        # per-read distributions are narrower than the reference's
        "mt_semantics": "amortized round share (see tests/test_mt_semantics.py)",
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("paf")
    ap.add_argument("truth")
    ap.add_argument("--tolerance", type=int, default=100,
                    help="bp slack for position overlap")
    args = ap.parse_args()
    truth = load_truth_tsv(args.truth)
    m = evaluate(args.paf, truth, args.tolerance)
    for k, v in m.items():
        if isinstance(v, float):
            print(f"{k}\t{v:.4f}")
        else:
            print(f"{k}\t{v}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
