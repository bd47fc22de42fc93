#!/usr/bin/env python
"""Figure and table generation from evaluation results.

This framework's analog of the reference's ``paperplotscripts/``
(paperplotscripts/README.md:16-27): each subcommand mirrors one of the
reference's scripts, consuming the JSON rows emitted by
``tools/evaluate.py --json`` (the analog of the reference's locally
generated ``.comparison``/``.throughput``/``.time`` files).

    # accuracy/throughput tradeoff scatter (plot_accuracy_throughput_tradeoff.py)
    python tools/paperplots.py tradeoff results/*.json -o tradeoff.pdf

    # band-radius / match-bonus parameter sweeps (plot_band_radius_parameter_sweep.py,
    # plot_matchbonus_parameter_sweep.py)
    python tools/paperplots.py sweep sweep_results.json -o sweep.pdf

    # seeding/chaining/alignment time breakdown (plot_seeding_chaining_alignment.py)
    python tools/paperplots.py breakdown phases.json -o breakdown.pdf

    # spider/radar chart of metric tradeoffs (plot_spider_tradeoffs.py)
    python tools/paperplots.py spider results/*.json -o spider.pdf

    # LaTeX tables (table_numeric_results.py / table_full_results.py)
    python tools/paperplots.py table results/*.json -o results.tex

Result-row schema (tools/compare_pafs.py evaluate + evaluate.py extras):
precision, recall, f1, mean_time_ms, median_time_ms, mean_chunks_mapped,
mean_chunks_unmapped, wall_s, and optionally config / sweep_value /
dataset labels. Breakdown input: {"label": ..., "phases": {name: sec}}
rows (rawalign_tpu.map.engine.MappingEngine.phase_times).
"""

import argparse
import json
import os
import sys


def _load_rows(paths):
    rows = []
    for p in paths:
        with open(p) as f:
            data = json.load(f)
        items = data if isinstance(data, list) else [data]
        for r in items:
            r.setdefault("label", r.get("config", os.path.basename(p)))
            rows.append(r)
    return rows


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def cmd_tradeoff(args):
    rows = _load_rows(args.results)
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(5, 4))
    for r in rows:
        # throughput instrument: mean mapping time per read (mt:f tag),
        # as in plot_accuracy_throughput_tradeoff.py
        x = r.get("mean_time_ms", r.get("wall_s", 0) * 1000)
        ax.scatter(x, r["f1"], label=r["label"])
        ax.annotate(
            r["label"], (x, r["f1"]), fontsize=7, xytext=(3, 3),
            textcoords="offset points",
        )
    ax.set_xlabel("mean mapping time per read (ms)")
    ax.set_ylabel("F1")
    ax.set_xscale("log")
    ax.set_title("accuracy / throughput tradeoff")
    fig.tight_layout()
    fig.savefig(args.output)
    print(args.output)


def cmd_sweep(args):
    rows = sorted(_load_rows(args.results), key=lambda r: r["sweep_value"])
    plt = _mpl()
    xs = [r["sweep_value"] for r in rows]
    fig, ax1 = plt.subplots(figsize=(5, 4))
    ax1.plot(xs, [r["f1"] for r in rows], "o-", label="F1")
    ax1.plot(xs, [r["precision"] for r in rows], "s--", label="precision")
    ax1.plot(xs, [r["recall"] for r in rows], "^--", label="recall")
    ax1.set_xlabel(args.xlabel)
    ax1.set_ylabel("accuracy")
    ax1.legend(loc="lower left", fontsize=8)
    ax2 = ax1.twinx()
    ax2.plot(
        xs,
        [r.get("mean_time_ms", 0) for r in rows],
        "x-",
        color="tab:red",
        label="mean time/read",
    )
    ax2.set_ylabel("mean mapping time per read (ms)", color="tab:red")
    fig.tight_layout()
    fig.savefig(args.output)
    print(args.output)


def cmd_breakdown(args):
    rows = _load_rows(args.results)
    plt = _mpl()
    # map engine phases onto the reference's seeding/chaining/alignment
    # split (plot_seeding_chaining_alignment.py)
    GROUPS = {
        "seeding": ("build_inputs", "stage_chain", "host_anchors"),
        "chaining": ("chain_dp", "traceback"),
        "alignment": ("dtw_prep", "dtw"),
        "other": ("finalize",),
    }
    labels = [r["label"] for r in rows]
    fig, ax = plt.subplots(figsize=(6, 4))
    bottoms = [0.0] * len(rows)
    for gname, keys in GROUPS.items():
        vals = [sum(r["phases"].get(k, 0.0) for k in keys) for r in rows]
        ax.bar(labels, vals, bottom=bottoms, label=gname)
        bottoms = [b + v for b, v in zip(bottoms, vals)]
    ax.set_ylabel("wall time (s)")
    ax.legend()
    ax.set_title("seeding / chaining / alignment breakdown")
    fig.tight_layout()
    fig.savefig(args.output)
    print(args.output)


def cmd_spider(args):
    rows = _load_rows(args.results)
    plt = _mpl()
    import numpy as np

    metrics = ["precision", "recall", "f1"]
    has_time = all(r.get("mean_time_ms") for r in rows)
    if has_time:
        metrics.append("speed")
        tmax = max(r["mean_time_ms"] for r in rows)
    angles = np.linspace(0, 2 * np.pi, len(metrics), endpoint=False).tolist()
    angles += angles[:1]
    fig, ax = plt.subplots(figsize=(5, 5), subplot_kw=dict(polar=True))
    for r in rows:
        vals = [r[m] for m in metrics if m != "speed"]
        if has_time:
            vals.append(1.0 - r["mean_time_ms"] / (tmax * 1.05))
        vals += vals[:1]
        ax.plot(angles, vals, label=r["label"])
        ax.fill(angles, vals, alpha=0.08)
    ax.set_xticks(angles[:-1])
    ax.set_xticklabels(metrics)
    ax.set_ylim(0, 1)
    ax.legend(fontsize=7, loc="lower right")
    fig.tight_layout()
    fig.savefig(args.output)
    print(args.output)


def cmd_table(args):
    rows = _load_rows(args.results)
    cols = [
        ("label", "Config", "{}"),
        ("precision", "Precision", "{:.4f}"),
        ("recall", "Recall", "{:.4f}"),
        ("f1", "F$_1$", "{:.4f}"),
        ("mean_time_ms", "Mean time/read (ms)", "{:.2f}"),
        ("median_time_ms", "Median time/read (ms)", "{:.2f}"),
        ("mean_chunks_mapped", "Chunks (mapped)", "{:.2f}"),
        ("wall_s", "Wall (s)", "{:.1f}"),
    ]
    cols = [c for c in cols if any(c[0] in r for r in rows)]
    lines = [
        "\\begin{tabular}{l" + "r" * (len(cols) - 1) + "}",
        "\\toprule",
        " & ".join(h for _, h, _ in cols) + " \\\\",
        "\\midrule",
    ]
    for r in rows:
        lines.append(
            " & ".join(
                fmt.format(r[k]) if k in r else "--" for k, _, fmt in cols
            )
            + " \\\\"
        )
    lines += ["\\bottomrule", "\\end{tabular}"]
    out = "\n".join(lines) + "\n"
    if args.output == "-":
        sys.stdout.write(out)
    else:
        with open(args.output, "w") as f:
            f.write(out)
        print(args.output)


def main() -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, fn, extra in [
        ("tradeoff", cmd_tradeoff, {}),
        ("sweep", cmd_sweep, {"xlabel": True}),
        ("breakdown", cmd_breakdown, {}),
        ("spider", cmd_spider, {}),
        ("table", cmd_table, {}),
    ]:
        p = sub.add_parser(name)
        p.add_argument("results", nargs="+")
        p.add_argument("-o", "--output", default="-" if name == "table" else f"{name}.pdf")
        if extra.get("xlabel"):
            p.add_argument("--xlabel", default="sweep value")
        p.set_defaults(fn=fn)
    args = ap.parse_args()
    args.fn(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
