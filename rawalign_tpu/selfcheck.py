"""Self-check ("sanitizer") subsystem: sampled cross-validation of the
batched device engine against the golden host oracle.

The reference's safety net for its C/pthreads runtime is
valgrind/sanitizer tooling plus deterministic tests (SURVEY §5). A device
pipeline's failure modes are different: the dangerous bugs are SILENT —
a miscompiled or stale-cached kernel, a packing/layout drift between
engines (exactly the round-2 regression class), numeric divergence
after a refactor. This module is the device analog of running under
a sanitizer: deterministically sample a fraction of production reads,
re-map each through the pure-NumPy golden engine (golden/engine.py,
cited line-by-line to rmap.cpp:667-822), and diff every mapping column,
producing a divergence report.

Wired to the CLI as ``--selfcheck FRACTION`` (0 disables; 1 re-checks
every eligible read). Sampling is by a hash of the read name, so which
names are ELIGIBLE is stable across runs, resume, batch geometry and
pipeline depth; capture stops after ``max_reads`` eligible reads
(CLI ``--selfcheck-max-reads``, default 64) to bound the golden re-map
cost, so on long runs the checked set is the first ``max_reads``
eligible reads in stream order (after a resume, the first in the
REMAINING stream). Raise the cap (or set it to the read count) for
full-coverage audits.
"""

from __future__ import annotations

import sys
import zlib
from dataclasses import dataclass, field

import numpy as np

from rawalign_tpu.io import paf

# Mapping columns compared (PAF cols 2-12 + mapq; mt:f/ci:i tags are
# excluded by design — the batched engine's amortized-share mt:f
# semantics differ from the golden per-read wall time, see
# tests/test_mt_semantics.py).
FIELDS = (
    # "mapped" is compared by the early return in diff_results
    "read_length",
    "read_start_position",
    "read_end_position",
    "ref_name",
    "ref_len",
    "fragment_start_position",
    "fragment_length",
    "rev",
    "mapq",
)


def diff_results(
    got: paf.MappingResult, want: paf.MappingResult
) -> list[tuple[str, object, object]]:
    """Field-level diff of two mapping results (mapping columns only)."""
    out = []
    if got.mapped != want.mapped:
        return [("mapped", got.mapped, want.mapped)]
    if not got.mapped:
        return []
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if a != b:
            out.append((f, a, b))
    return out


@dataclass
class SelfCheck:
    """Collects a deterministic sample of (signal, engine result) pairs
    during mapping and re-validates them against the golden oracle."""

    index: object
    opt: object
    fraction: float
    max_reads: int = 64
    signals: dict[str, np.ndarray] = field(default_factory=dict)
    results: dict[str, paf.MappingResult] = field(default_factory=dict)

    def want(self, name: str) -> bool:
        if self.fraction <= 0.0 or len(self.signals) >= self.max_reads:
            return False
        h = zlib.crc32(name.encode()) % 10_000
        return h < self.fraction * 10_000

    def capture(self, name: str, sig: np.ndarray) -> None:
        if self.want(name):
            self.signals[name] = np.asarray(sig, dtype=np.float32)

    def record(self, res: paf.MappingResult) -> None:
        if res.read_name in self.signals:
            self.results[res.read_name] = res

    def run(self) -> dict:
        """Re-map the captured sample with the golden engine and diff.

        Returns {"n_checked", "n_divergent", "divergences": [...]}; each
        divergence is {"read", "field", "got", "want"}.
        """
        from rawalign_tpu.golden import engine as gengine

        divergences = []
        n = 0
        for name, res in sorted(self.results.items()):
            n += 1
            want = gengine.map_read(
                self.index, self.signals[name], name, self.opt
            )
            for f, a, b in diff_results(res, want):
                divergences.append(
                    {"read": name, "field": f, "got": a, "want": b}
                )
        return {
            "n_checked": n,
            "n_divergent": len({d["read"] for d in divergences}),
            "divergences": divergences,
        }

    def report(self, stream=None) -> dict:
        # resolve sys.stderr at call time (a default arg would freeze
        # whatever object sys.stderr was at import, e.g. a test capture)
        stream = stream if stream is not None else sys.stderr
        rep = self.run()
        if rep["n_divergent"]:
            print(
                f"[M::selfcheck] FAIL: {rep['n_divergent']}/"
                f"{rep['n_checked']} sampled reads diverge from the "
                "golden oracle:",
                file=stream,
            )
            for d in rep["divergences"][:20]:
                print(
                    f"[M::selfcheck]   {d['read']}: {d['field']} "
                    f"got={d['got']} want={d['want']}",
                    file=stream,
                )
        else:
            print(
                f"[M::selfcheck] ok: {rep['n_checked']} sampled reads "
                "match the golden oracle on all mapping columns",
                file=stream,
            )
        return rep
