#!/usr/bin/env python
"""Smoke test of the mapper's main path on NVIDIA GPUs.

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # four cards: the distributed engine

One card, all in this one process (a second JAX process on the card
would fail for want of memory):

1. build the native host library and the CUDA DTW kernel from source;
2. generate, from a fixed seed, a 5 Mb genome (E. coli scale, the
   RawHash/RawAlign d2 deployment) and 512 reads of 400-2000 bp, 20% of
   them pure noise, written as sigbin;
3. index with ``cli.main(-x sensitive -p model -d idx ref.fa)``;
4. map with ``cli.main(-x sensitive --dtw-evaluate-chains --selfcheck
   ... --selfcheck-strict)`` and report reads/s;
5. compare the PAF with the golden engine on a fixed sample of 64 reads,
   mapping columns only (no mt:f);
6. compile the DTW kernel at its real widths and compare it with its
   plain reference and the golden model, for every size class 32..2048
   and both R parities; check the device sketch at max_events_per_chunk
   against the golden sketch; measure the device (f32) event detector of
   --stage1-impl device against the golden C-double one;
7. print the device as the last line of standard output.

``--four-cards`` runs only the single-card ``MappingEngine`` and
``DistributedMappingEngine`` on (4,1), (2,2) and (1,4) meshes over the
same data, and checks that their PAF (without mt:f) is equal.

Exits non-zero, with no result line, when JAX finds no GPU or any phase
fails.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
SEED = 2024
GENOME_BP = 5_000_000
N_READS = 512
GOLDEN_SAMPLE = 64
PAF_COLUMNS = 12  # the mapping columns; tags (mt:f, ...) excluded
DTW_CLASSES = tuple(32 << i for i in range(7))  # 32 .. 2048
DTW_TILES_PER_CLASS = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    return out.splitlines()[0]


def require_gpu(n: int):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu" or len(devs) < n:
        raise SystemExit(
            f"chip_smoke: needs {n} GPU(s); JAX found {len(devs)} "
            f"{devs[0].platform} device(s)"
        )
    return devs


def build_native() -> None:
    subprocess.run(["make", "-B", "-s", "-C", os.path.join(ROOT, "native")], check=True)
    from rawalign_tpu.map import dtw_cuda

    dtw_cuda.register()


def make_data() -> dict:
    from rawalign_tpu.testing import synth

    t0 = time.perf_counter()
    ds = synth.make_dataset(
        seed=SEED,
        genome_lengths=[GENOME_BP],
        n_reads=N_READS,
        read_len_bp=(400, 2000),
        frac_random=0.2,
    )
    paths = synth.write_dataset(WORK, ds)
    paths["idx"] = os.path.join(WORK, "ref.idx.npz")
    paths["paf"] = os.path.join(WORK, "out.paf")
    log(f"data: {GENOME_BP} bp genome, {len(ds.reads)} reads "
        f"({sum(r.ref_id < 0 for r in ds.reads)} noise), "
        f"{time.perf_counter() - t0:.1f} s")
    return paths


def mapping_options():
    from rawalign_tpu import config
    from rawalign_tpu.config import MappingFlag

    io, mo = config.IndexOptions(), config.MappingOptions()
    config.set_opt("sensitive", io, mo)
    mo.set_flag(MappingFlag.DTW_EVALUATE_CHAINS)
    return io, mo


def index_and_map(paths: dict, card: str) -> None:
    from rawalign_tpu import cli

    t0 = time.perf_counter()
    rc = cli.main(["-x", "sensitive", "-p", paths["model"], "-d", paths["idx"],
                   paths["ref"]])
    if rc != 0:
        raise RuntimeError(f"indexing failed: exit code {rc}")
    log(f"index: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rc = cli.main(["-x", "sensitive", "--dtw-evaluate-chains",
                   "--selfcheck", "0.1", "--selfcheck-max-reads", "16",
                   "--selfcheck-strict", "-o", paths["paf"],
                   paths["idx"], paths["reads"]])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"mapping failed (selfcheck-strict): exit code {rc}")
    with open(paths["paf"]) as f:
        n = sum(1 for line in f if line.strip())
    if n != N_READS:
        raise RuntimeError(f"PAF has {n} lines for {N_READS} reads")
    log(f"mapping pass on {card}: {n} reads in {wall:.2f} s wall "
        f"(cold: index load and compilation included), {n / wall:.1f} reads/s; "
        "selfcheck-strict passed")


def engine_report(paths: dict) -> None:
    """The resolved stage placement, and the compiled stage-1 step's
    memory analysis."""
    import jax.numpy as jnp
    import numpy as np

    from rawalign_tpu.index.index import RawIndex
    from rawalign_tpu.map.engine import MappingEngine

    _io, mo = mapping_options()
    eng = MappingEngine(RawIndex.load(paths["idx"]), mo, batch_size=32)
    stage1 = eng._stage1_mode
    chain = "native" if eng._chain_native else "device"
    log(f"engine: stage1={stage1} chain={chain}")
    if (stage1, chain) != ("hybrid", "native"):
        raise RuntimeError("the default path must be stage1=hybrid, chain=native")
    B, ne = eng.batch_size, mo.max_events_per_chunk
    ma = eng._stage1_hy_jit.lower(
        eng._bt,
        jnp.zeros((B, ne + 2), jnp.float32),
        jnp.zeros((B, eng._hmax), jnp.float32),
        np.zeros(B, np.int32),
    ).compile().memory_analysis()
    log(f"stage-1 step (B={B}, NE={ne}) memory_analysis: {ma}")
    eng.close()


def compare_golden(paths: dict) -> None:
    from rawalign_tpu.golden import engine as gengine
    from rawalign_tpu.index.index import RawIndex
    from rawalign_tpu.io import fast5, paf

    _io, mo = mapping_options()
    idx = RawIndex.load(paths["idx"])
    got = {}
    with open(paths["paf"]) as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            got[cols[0]] = cols[:PAF_COLUMNS]
    reads = list(fast5.read_sigbin(paths["reads"]))
    step = max(1, len(reads) // GOLDEN_SAMPLE)
    sample = reads[::step][:GOLDEN_SAMPLE]
    t0 = time.perf_counter()
    equal, diff = 0, []
    for name, sig in sample:
        want = paf.paf_line(gengine.map_read(idx, sig, name, mo)).split("\t")
        if got.get(name) == want[:PAF_COLUMNS]:
            equal += 1
        else:
            diff.append((name, got.get(name), want[:PAF_COLUMNS]))
    log(f"golden comparison: {equal} lines equal, {len(diff)} different "
        f"({len(sample)} sampled reads, {time.perf_counter() - t0:.1f} s)")
    for name, a, b in diff[:5]:
        log(f"  {name}: engine {a} golden {b}")
    if diff:
        raise RuntimeError("PAF differs from the golden engine")


def _dtw_tiles(rng, max_n: int, parity: int):
    """Random tiles of one size class whose widened radius R has the
    given parity, as (pool, desc, dpw, pairs)."""
    import numpy as np

    from rawalign_tpu.map import dtw as ddtw
    from rawalign_tpu.map import tiles

    lo = 1 if max_n == 32 else max_n // 2 + 1
    pairs = []
    while len(pairs) < DTW_TILES_PER_CLASS:
        n = int(rng.integers(lo, max_n + 1))
        m = max(1, int(n * rng.uniform(0.6, 1.0)))
        r = max(1, int(0.1 * m))
        while int(ddtw.widened_radius(n, m, r)) % 2 != parity:
            r += 1
        a = rng.normal(0, 1, n).astype(np.float32)
        b = rng.normal(0, 1, m).astype(np.float32)
        pairs.append((a, b, r, bool(rng.integers(0, 2))))
    return (*tiles.class_batch(pairs), pairs)


def _max_diff(got, want):
    import numpy as np

    both_huge = (got > 1e9) & (want > 1e9)
    return float(np.where(both_huge, 0.0, np.abs(got - want)).max())


def kernel_phase() -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from rawalign_tpu.golden import dtw as gdtw
    from rawalign_tpu.golden import sketch as gsketch
    from rawalign_tpu.map import dtw as ddtw
    from rawalign_tpu.map import dtw_cuda
    from rawalign_tpu.seeds import sketch

    rng = np.random.default_rng(SEED)
    worst = 0.0
    for max_n in DTW_CLASSES:
        for parity in (0, 1):
            pool, desc, dpw, pairs = _dtw_tiles(rng, max_n, parity)
            src, d = jnp.asarray(pool), jnp.asarray(desc)
            T = len(pairs)
            got = np.asarray(dtw_cuda.dtw_banded(src, d, dpw=dpw))[:T]
            plain = np.asarray(ddtw.dtw_plain(src, d, dpw=dpw))[:T]
            golden = np.asarray(
                [gdtw.dtw_global_slantedbanded_antidiagonalwise(*p) for p in pairs[:4]],
                np.float32,
            )
            dp, dg = _max_diff(got, plain), _max_diff(got[:4], golden)
            worst = max(worst, dp, dg)
            log(f"dtw class {max_n:4d} R {'even' if parity == 0 else 'odd '} "
                f"dpw {dpw:3d}: max |kernel - plain| {dp} over {T} tiles, "
                f"max |kernel - golden| {dg} over 4")
    if worst > 1e-3:
        raise RuntimeError(f"DTW kernel differs from its reference by {worst}")
    # one mapping round's dispatch (every class in one program)
    metas, descs = [], []
    for max_n in DTW_CLASSES:
        pool, desc, dpw, _ = _dtw_tiles(rng, max_n, max_n // 32 % 2)
        metas.append((dpw, desc.shape[1]))
        descs.append(desc)
    blob = np.concatenate([np.zeros(256, np.float32)]
                          + [d.reshape(-1).view(np.float32) for d in descs])
    ma = ddtw.dtw_indexed.lower(
        jnp.asarray(pool), jnp.asarray(blob), metas=tuple(metas), lev=256
    ).compile().memory_analysis()
    log(f"DTW step ({len(metas)} classes) memory_analysis: {ma}")

    io, mo = mapping_options()
    B, NE = 32, mo.max_events_per_chunk
    ev = rng.normal(0, 1, (B, NE)).astype(np.float32)
    ev[:, 1::2] = ev[:, 0::2] + 0.1  # adjacent-similar events are skipped
    n = rng.integers(0, NE + 1, B).astype(np.int32)
    n[0], n[1] = 0, NE
    got = jax.device_get(sketch.sketch_events_batch(
        jnp.asarray(ev), jnp.asarray(n), e=io.e, q=io.q, lq=io.lq
    ))
    n_equal = 0
    for b in range(B):
        want = gsketch.sketch_reg(ev[b, : n[b]], sid=0, strand=0, e=io.e,
                                  q=io.q, lq=io.lq, k=6)
        v = got.valid[b]
        n_equal += bool(
            np.array_equal(got.hashes[b][v], (want[:, 0] >> np.uint64(6)).astype(np.uint32))
            and np.array_equal(got.qpos[b][v],
                               ((want[:, 1] & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int32))
        )
    log(f"device sketch (B={B}, NE={NE}, e={io.e}): {n_equal}/{B} reads' seeds "
        "equal to the golden sketch")
    if n_equal != B:
        raise RuntimeError("device sketch differs from the golden sketch")


def events_phase(paths: dict) -> None:
    """The f32 device event detector (``--stage1-impl device``) against
    the golden C-double semantics on the first chunk of 64 reads: the
    documented deviation is <= 2 ulp in the t-statistic, which may move
    an event boundary where a t-statistic sits on a threshold."""
    import numpy as np

    from rawalign_tpu.golden import events as gevents
    from rawalign_tpu.io import fast5
    from rawalign_tpu.signal import events as devents

    _io, mo = mapping_options()
    L = mo.chunk_size
    sigs = [s[:L] for _, s in fast5.read_sigbin(paths["reads"])][:64]
    batch = np.zeros((len(sigs), L), np.float32)
    lengths = np.zeros(len(sigs), np.int32)
    for i, s in enumerate(sigs):
        batch[i, : s.size] = s
        lengths[i] = s.size
    res = devents.detect_events_batch(
        batch, lengths, w1=mo.window_length1, w2=mo.window_length2,
        threshold1=mo.threshold1, threshold2=mo.threshold2,
        peak_height=mo.peak_height, max_events=mo.max_events_per_chunk,
    )
    n_ev = np.asarray(res.n_events)
    values = np.asarray(res.values)
    same, worst_diff, worst_count, n_close, n_all = 0, 0.0, 0, 0, 0
    for i, s in enumerate(sigs):
        want = gevents.detect_events(s, mo).astype(np.float32)
        got = values[i, : n_ev[i]]
        worst_count = max(worst_count, abs(got.size - want.size))
        if got.size == want.size:
            same += 1
            if want.size:
                diff = np.abs(got - want)
                worst_diff = max(worst_diff, float(diff.max()))
                n_close += int((diff < 1e-4).sum())
                n_all += want.size
    log(f"device event detector vs golden on {len(sigs)} chunks: {same} with "
        f"equal event counts (largest count difference {worst_count}); "
        f"on those, {n_close}/{n_all} event values within 1e-4 of golden, "
        f"largest |device - golden| {worst_diff:.3g} (z-normalized values)")
    if worst_count > 2:
        raise RuntimeError("device event detector beyond its documented deviation")


def four_cards(paths: dict) -> None:
    from rawalign_tpu.index.index import RawIndex
    from rawalign_tpu.io import fast5, paf
    from rawalign_tpu.map.engine import MappingEngine
    from rawalign_tpu.parallel import mesh as pmesh
    from rawalign_tpu.parallel.dist_engine import (
        DistributedMappingEngine,
        mesh_layouts,
    )

    _io, mo = mapping_options()
    idx = RawIndex.load(paths["idx"])
    reads = list(fast5.read_sigbin(paths["reads"]))

    def run(eng) -> list[str]:
        t0 = time.perf_counter()
        lines = sorted(paf.strip_mt(paf.paf_line(r)) for r in eng.map_reads(iter(reads)))
        eng.close()
        return lines, time.perf_counter() - t0

    ref, wall = run(MappingEngine(idx, mo, batch_size=32))
    log(f"single card: {len(ref)} PAF lines, {wall:.1f} s (cold)")
    for layout in mesh_layouts(4):
        eng = DistributedMappingEngine(idx, mo, pmesh.make_mesh(*layout), batch_size=32)
        lines, wall = run(eng)
        n_diff = sum(a != b for a, b in zip(ref, lines)) + abs(len(ref) - len(lines))
        log(f"mesh {layout}: {len(lines)} PAF lines, {n_diff} different "
            f"from the single card, {wall:.1f} s (cold)")
        if n_diff:
            for a, b in [(a, b) for a, b in zip(ref, lines) if a != b][:3]:
                log(f"  single {a}\n  mesh   {b}")
            raise RuntimeError(f"PAF on mesh {layout} differs from one card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed engine on four GPUs")
    args = ap.parse_args(argv)
    n_cards = 4 if args.four_cards else 1
    devs = require_gpu(n_cards)
    card = card_line()
    log(f"card: {card}")
    os.makedirs(WORK, exist_ok=True)
    try:
        build_native()
        paths = make_data()
        if args.four_cards:
            from rawalign_tpu import cli

            rc = cli.main(["-x", "sensitive", "-p", paths["model"], "-d",
                           paths["idx"], paths["ref"]])
            if rc != 0:
                raise RuntimeError(f"indexing failed: exit code {rc}")
            four_cards(paths)
        else:
            index_and_map(paths, card)
            engine_report(paths)
            compare_golden(paths)
            kernel_phase()
            events_phase(paths)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
