"""Failure detection / elastic recovery for device transfers.

The reference has no failure handling (fprintf+exit, main.cpp:324-327);
runtime.fetch/put detect stalled transfers and retry transient runtime
errors. These tests exercise classification, retry, watchdog, and the
engine integration.
"""

import sys
import time

import numpy as np
import pytest

from rawalign_tpu import runtime


class _FlakyDevArray:
    """Mimics a jax.Array whose host materialization fails transiently.

    jax.device_get(np.ndarray) returns it unchanged, so to exercise the
    retry wrapper we hand fetch() an object whose __array__ raises; jax
    falls back to np.asarray for unknown types.
    """

    def __init__(self, value, fail_times, message):
        self.value = np.asarray(value)
        self.remaining = fail_times
        self.message = message
        self.calls = 0

    def __array__(self, dtype=None, copy=None):
        self.calls += 1
        if self.remaining > 0:
            self.remaining -= 1
            raise RuntimeError(self.message)
        return self.value


def _reset_stats():
    for k in runtime.transfer_stats:
        runtime.transfer_stats[k] = 0


def test_transient_classification():
    assert runtime._is_transient(RuntimeError("DEADLINE_EXCEEDED: rpc"))
    assert runtime._is_transient(OSError("Connection reset by peer"))
    assert runtime._is_transient(RuntimeError("transport closed"))
    assert runtime._is_transient(TimeoutError("operation timed out"))
    assert not runtime._is_transient(ValueError("bad shape (3, 4)"))
    assert not runtime._is_transient(RuntimeError("RESOURCE_EXHAUSTED: OOM"))
    # generic words alone must NOT classify as transient (they appear in
    # permanent errors too: "will not retry", "connection pool config",
    # "operation aborted by user")
    assert not runtime._is_transient(ValueError("will not retry this op"))
    assert not runtime._is_transient(RuntimeError("connection pool misconfigured"))
    assert not runtime._is_transient(RuntimeError("operation aborted by user"))


def test_permanent_error_not_counted_as_link_failure(monkeypatch):
    """Ordinary shape/compile bugs surface as exceptions but must not
    inflate the device-link 'hard failures' stat the CLI reports."""
    _reset_stats()
    monkeypatch.setattr(time, "sleep", lambda s: None)
    arr = _FlakyDevArray([1.0], 99, "invalid shape for gather")
    with pytest.raises(RuntimeError, match="invalid shape"):
        runtime.fetch(arr, label="test fetch", warn_after=0)
    assert runtime.transfer_stats["failures"] == 0


def test_fetch_retries_transient(monkeypatch):
    _reset_stats()
    monkeypatch.setattr(time, "sleep", lambda s: None)
    arr = _FlakyDevArray([1.0, 2.0], 2, "UNAVAILABLE: socket closed")
    out = runtime.fetch(arr, label="test fetch", warn_after=0)
    np.testing.assert_array_equal(out, [1.0, 2.0])
    assert arr.calls == 3
    assert runtime.transfer_stats["retries"] == 2
    assert runtime.transfer_stats["failures"] == 0


def test_fetch_gives_up_after_retries(monkeypatch):
    _reset_stats()
    monkeypatch.setattr(time, "sleep", lambda s: None)
    arr = _FlakyDevArray([1.0], 99, "DEADLINE_EXCEEDED")
    with pytest.raises(RuntimeError, match="DEADLINE"):
        runtime.fetch(arr, label="test fetch", retries=2, warn_after=0)
    assert arr.calls == 3  # 1 try + 2 retries
    assert runtime.transfer_stats["failures"] == 1


def test_fetch_no_retry_on_permanent_error(monkeypatch):
    _reset_stats()
    monkeypatch.setattr(time, "sleep", lambda s: None)
    arr = _FlakyDevArray([1.0], 99, "invalid shape for gather")
    with pytest.raises(RuntimeError, match="invalid shape"):
        runtime.fetch(arr, label="test fetch", warn_after=0)
    assert arr.calls == 1
    assert runtime.transfer_stats["retries"] == 0


def test_watchdog_logs_stall(capsys):
    _reset_stats()

    class _Slow:
        def __array__(self, dtype=None, copy=None):
            # wide margin (25x the warn threshold) so the watchdog
            # thread gets scheduled even under heavy CI load
            time.sleep(0.5)
            return np.zeros(1)

    runtime.fetch(_Slow(), label="slow fetch", warn_after=0.02)
    err = capsys.readouterr().err
    assert "slow fetch has been blocked" in err
    assert runtime.transfer_stats["stall_warnings"] >= 1


def test_watchdog_silent_when_fast(capsys):
    _reset_stats()
    runtime.fetch(np.zeros(4), label="fast fetch", warn_after=5.0)
    assert "blocked" not in capsys.readouterr().err
    assert runtime.transfer_stats["stall_warnings"] == 0


def test_put_retries(monkeypatch):
    _reset_stats()
    monkeypatch.setattr(time, "sleep", lambda s: None)
    import jax

    calls = {"n": 0}
    real_put = jax.device_put

    def flaky_put(x, sharding=None):
        calls["n"] += 1
        if calls["n"] < 2:
            raise RuntimeError("UNAVAILABLE: connection reset")
        return real_put(x) if sharding is None else real_put(x, sharding)

    monkeypatch.setattr(jax, "device_put", flaky_put)
    out = runtime.put(np.arange(4.0), label="test put", warn_after=0)
    np.testing.assert_array_equal(np.asarray(out), np.arange(4.0))
    assert calls["n"] == 2
    assert runtime.transfer_stats["retries"] == 1


def test_engine_survives_transient_fetch_failure(monkeypatch):
    """End-to-end: a transient device_get failure mid-mapping does not
    lose the batch — the engine retries and produces identical PAF."""
    _reset_stats()
    monkeypatch.setattr(time, "sleep", lambda s: None)
    from rawalign_tpu import config
    from rawalign_tpu.index import index as dindex
    from rawalign_tpu.io import paf
    from rawalign_tpu.map import engine as dengine
    from rawalign_tpu.testing import synth

    ds = synth.make_dataset(
        seed=11, genome_lengths=[4000], n_reads=4, read_len_bp=(150, 300)
    )
    io = config.IndexOptions()
    mo = config.MappingOptions()
    config.set_opt("viral", io, mo)
    mo.set_flag(config.MappingFlag.DTW_EVALUATE_CHAINS)
    mo.max_events_per_chunk = 256
    idx = dindex.build_index(ds.seqs, ds.model.pore_vals, io)
    reads = [(r.name, r.signal) for r in ds.reads]

    eng = dengine.MappingEngine(idx, mo, batch_size=4)
    want = sorted(paf.paf_line(r) for r in eng.map_reads(iter(reads)))

    import jax

    real_get = jax.device_get
    fail = {"left": 2}

    def flaky_get(x):
        if fail["left"] > 0:
            fail["left"] -= 1
            raise RuntimeError("DEADLINE_EXCEEDED: transfer stall")
        return real_get(x)

    monkeypatch.setattr(jax, "device_get", flaky_get)
    eng2 = dengine.MappingEngine(idx, mo, batch_size=4)
    got = sorted(paf.paf_line(r) for r in eng2.map_reads(iter(reads)))
    monkeypatch.setattr(jax, "device_get", real_get)

    strip_mt = lambda lines: [
        "\t".join(c for c in l.split("\t") if not c.startswith("mt:f"))
        for l in lines
    ]
    assert strip_mt(got) == strip_mt(want)
    assert fail["left"] == 0
    assert runtime.transfer_stats["retries"] == 2
