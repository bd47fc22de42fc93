"""Device (JAX) event detection vs the golden model."""

import numpy as np
import pytest

from rawalign_tpu import config
from rawalign_tpu.golden import events as gevents
from rawalign_tpu.signal import events as devents
from rawalign_tpu.testing import synth


def _chunks(seed=0, n=6, L=4000):
    """Realistic synthetic signal chunks of varying length."""
    rng = np.random.default_rng(seed)
    from rawalign_tpu.pore_model import synthetic_pore_model

    pm = synthetic_pore_model(k=6, seed=seed)
    out = []
    for i in range(n):
        seq = "".join(rng.choice(list("ACGT"), size=rng.integers(80, 500)))
        sig = synth.simulate_read_signal(rng, seq, pm, noise_pa=1.5)
        out.append(sig[:L])
    return out


def test_device_events_match_golden():
    opt = config.MappingOptions()
    sigs = _chunks(seed=3)
    B = len(sigs)
    L = max(s.size for s in sigs)
    batch = np.zeros((B, L), dtype=np.float32)
    lengths = np.zeros(B, dtype=np.int32)
    for i, s in enumerate(sigs):
        batch[i, : s.size] = s
        lengths[i] = s.size
    res = devents.detect_events_batch(batch, lengths, max_events=2048)
    n_total = 0
    n_match = 0
    n_equal_count = 0
    for i, s in enumerate(sigs):
        want = gevents.detect_events(s, opt)
        got = np.asarray(res.values[i][: int(res.n_events[i])])
        # Prefix sums and the peak machine bit-match the golden model; the
        # only residuals are (a) the final t = |d|/sqrt(v/w) computed in
        # float32 on device vs via double in C — a <=2-ulp difference that
        # can flip a marginal peak (rare; allow |delta count| <= 2), and
        # (b) z-norm accumulators (C doubles vs device float32, ~1e-6 rel).
        assert abs(got.size - want.size) <= 2, (i, got.size, want.size)
        if got.size == want.size:
            n_equal_count += 1
            n_total += want.size
            n_match += int(np.sum(np.abs(got - want) < 1e-4))
    assert n_equal_count >= len(sigs) // 2
    assert n_total > 400
    assert n_match >= 0.995 * n_total, f"{n_match}/{n_total} events match"


def test_device_events_empty_and_constant():
    batch = np.zeros((3, 1000), dtype=np.float32)
    batch[1] = 95.0  # constant -> no peaks
    rng = np.random.default_rng(0)
    batch[2] = rng.normal(95, 10, size=1000)
    lengths = np.array([0, 1000, 1000], dtype=np.int32)
    res = devents.detect_events_batch(batch, lengths, max_events=512)
    assert int(res.n_events[0]) == 0
    assert int(res.n_events[1]) <= 1
    assert int(res.n_events[2]) > 10
    v = np.asarray(res.values[2][: int(res.n_events[2])])
    assert abs(float(np.mean(v))) < 1e-3

