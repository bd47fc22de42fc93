"""Repetitive-genome regression: chaining window + occurrence cap.

tools/chain_window_study.py measured (over windows {64, 256, 1024} and
occ caps {64, 256}, 4 scenarios) that the bounded chaining window NEVER
changes outcomes — clean, noisy and tandem-repeat genomes give identical
results at window 64 and 256+ — while the occurrence-cap design
deviation (the reference keeps all hits; we drop seeds with > max_occ
occurrences, index/query.py) is what decides the repetitive regime:
keeping over-frequent seeds floods the per-read anchor budget and LOSES
reads, while dropping them keeps every read mappable via flank/divergent
seeds. This test pins those two facts on the nastiest scenario
(300 bp unit x 100 copies, 5% divergence).
"""

import numpy as np
import pytest

from rawalign_tpu import config
from rawalign_tpu.index import index as dindex
from rawalign_tpu.map.engine import MappingEngine
from rawalign_tpu.testing import synth


@pytest.fixture(scope="module")
def tandem():
    rng = np.random.default_rng(99)
    ds = synth.make_dataset(
        seed=23,
        n_reads=8,
        read_len_bp=(300, 900),
        noise_pa=1.5,
        seqs=synth.tandem_genome(
            rng, unit_len=300, copies=100, flank=10_000, divergence=0.05
        ),
    )
    io = config.IndexOptions()
    mo = config.MappingOptions()
    config.set_opt("sensitive", io, mo)
    mo.set_flag(config.MappingFlag.DTW_EVALUATE_CHAINS)
    idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)
    return ds, idx, mo


def _run(ds, idx, mo, **kw):
    eng = MappingEngine(idx, mo, batch_size=8, **kw)
    n_correct = 0
    for res in eng.map_reads((r.name, r.signal) for r in ds.reads):
        read = next(r for r in ds.reads if r.name == res.read_name)
        if res.mapped and res.ref_name == ds.seqs[read.ref_id].name and (
            res.rev == read.strand
        ):
            lo = res.fragment_start_position
            hi = lo + res.fragment_length
            n_correct += not (hi < read.ref_start or lo > read.ref_end)
    return n_correct, eng.counters


def test_occ_cap_preserves_accuracy_on_tandem_repeats(tandem):
    """Default max_occ=64 drops every repeat-unit seed on a 100-copy
    tandem array, yet every read still maps to the right locus."""
    ds, idx, mo = tandem
    n_correct, counters = _run(ds, idx, mo, max_occ=64, max_anchors=4096)
    assert counters["seed_hits_dropped"] > 1000  # the cap engaged hard
    assert n_correct == len(ds.reads)


def test_window_64_matches_window_512_on_tandem_repeats(tandem):
    """The bounded chaining window does not decide the repetitive
    regime: 64 and 512 give identical outcomes (study: also 256/1024)."""
    ds, idx, mo = tandem
    a, _ = _run(ds, idx, mo, chain_window=64, max_occ=64, max_anchors=4096)
    b, _ = _run(ds, idx, mo, chain_window=512, max_occ=64, max_anchors=4096)
    assert a == b == len(ds.reads)


def test_large_anchor_round_regression(tandem):
    """a_round >= 4096 regression: with a flooded anchor budget (high
    occ cap) the engine escalates its per-round anchor bucket to 4096;
    an earlier device bug made every read unmapped there (root cause:
    the peak-compaction device scatter, since replaced by a permutation
    sort); this pins the escalated-bucket path on every backend."""
    ds, idx, mo = tandem
    n_correct, counters = _run(ds, idx, mo, max_occ=256, max_anchors=4096, max_anchors_ceiling=4096)
    assert counters["anchors_dropped"] > 0  # budget actually flooded
    assert n_correct == len(ds.reads)


@pytest.fixture(scope="module")
def segdup():
    """Scaled-down segmental-duplication scenario (the 5 Mb version
    lives in tools/chain_window_study.py -> docs/window_study.json)."""
    rng = np.random.default_rng(77)
    ds = synth.make_dataset(
        seed=25,
        n_reads=8,
        read_len_bp=(300, 900),
        noise_pa=1.5,
        seqs=synth.segdup_genome(
            rng, total_len=600_000, dup_len=15_000, n_dups=12,
            divergence=0.02,
        ),
    )
    io = config.IndexOptions()
    mo = config.MappingOptions()
    config.set_opt("sensitive", io, mo)
    mo.set_flag(config.MappingFlag.DTW_EVALUATE_CHAINS)
    idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)
    return ds, idx, mo


def test_segdup_accuracy_and_window_invariance(segdup):
    """Paralogs scattered across the target axis (d4/d5-class regime,
    docs/window_study.json segdup_5mb/shuffled_5mb): window 64 == 256
    and the occ-capped engine still places reads at the true locus."""
    ds, idx, mo = segdup
    a, ca = _run(ds, idx, mo, chain_window=64, max_occ=64, max_anchors=2048)
    b, _ = _run(ds, idx, mo, chain_window=256, max_occ=64, max_anchors=2048)
    assert a == b
    assert a >= len(ds.reads) - 1  # ≥7/8 at the true locus


def test_default_caps_lossless_on_tandem_repeats(tandem):
    """Round-4 lossless defaults (VERDICT r3 item 2): with max_occ=4096
    and dynamic host-side anchor sizing, the 100-copy tandem array
    drops NOTHING — matching the reference's uncapped hit gathering
    (rmap.cpp:371-391) — and every read still maps correctly."""
    from rawalign_tpu import native

    if not native.available():
        pytest.skip("native host library required for the dynamic path")
    ds, idx, mo = tandem
    n_correct, counters = _run(ds, idx, mo)
    assert counters["seed_hits_dropped"] == 0
    assert counters["anchors_dropped"] == 0
    assert n_correct == len(ds.reads)


def _paf(ds, idx, mo, **kw):
    import re

    from rawalign_tpu.io import paf

    eng = MappingEngine(idx, mo, batch_size=8, **kw)
    lines = [
        re.sub(r"\tmt:f:[^\t\n]*", "", paf.paf_line(r))
        for r in eng.map_reads((r.name, r.signal) for r in ds.reads)
    ]
    return lines, dict(eng.counters)


def test_device_chain_path_lossless(tandem):
    """VERDICT r4 #3: the DEVICE chain path escalates its fixed anchor
    shapes to the round's true demand (next pow2 class) instead of
    decimating — with a flooded budget (max_anchors far below the
    round's hits) it must drop 0 anchors and emit the same PAF as the
    lossless native chain path."""
    ds, idx, mo = tandem
    nat, cn = _paf(ds, idx, mo, max_occ=256, max_anchors=256,
                   chain_impl="native")
    dev, cd = _paf(ds, idx, mo, max_occ=256, max_anchors=256,
                   chain_impl="device")
    assert cn["anchors_dropped"] == 0
    assert cd["anchors_dropped"] == 0
    assert dev == nat


def test_device_chain_ceiling_still_caps(tandem):
    """The escalation honors max_anchors_ceiling: forcing a low ceiling
    reinstates decimation (the safety valve still works)."""
    ds, idx, mo = tandem
    _, cd = _paf(ds, idx, mo, max_occ=256, max_anchors=512,
                 max_anchors_ceiling=512, chain_impl="device")
    assert cd["anchors_dropped"] > 0
