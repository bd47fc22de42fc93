"""Runtime helpers: compilation cache, transfer utilities, and
failure detection / recovery for host<->device transfers.

* the persistent compilation cache is enabled process-wide (compiled
  executables survive across runs of the same checkout);
* hosts fetch device results with ONE device_get per pipeline stage
  rather than per-array np.asarray calls;
* transfers go through :func:`fetch` / :func:`put`, which detect
  stalls (a watchdog logs to stderr when a transfer exceeds a
  threshold) and retry transient runtime errors with backoff.

The reference has no failure-handling story at all (errors are
``fprintf(stderr)+exit``, e.g. main.cpp:324-327). Detection (watchdog +
transfer stats), recovery (bounded retry on *transient* errors only),
and job-level resume (the CLI's read-granular ``--resume``) together
form this framework's recovery layer. Whether the retry and watchdog buy
anything on a locally attached GPU is not measured yet.
"""

from __future__ import annotations

import os
import sys
import threading
import time

#: the compile cache's directory when JAX_COMPILATION_CACHE_DIR is not
#: set: fixed, inside the checkout (listed in .gitignore)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "build",
    "jax_cache",
)

# --------------------------------------------------------------------------
# Failure detection / elastic transfer layer
# --------------------------------------------------------------------------

#: absl status-code tokens (matched case-sensitively — XLA runtime
#: errors carry them verbatim) that mark a transient failure.
_TRANSIENT_CODES = (
    "DEADLINE_EXCEEDED",
    "UNAVAILABLE",
    "ABORTED",
    "CANCELLED",
)

#: narrower lowercase fallbacks for raw socket/OS-level transport
#: errors that carry no status code. Deliberately specific phrases —
#: generic words ("retry", "connection", "aborted") would misclassify
#: permanent errors whose message merely mentions them. Anything not
#: matched (shape errors, OOM, compile errors) re-raises immediately:
#: retrying those would loop forever.
_TRANSIENT_MARKERS = (
    "timed out",
    "timeout",
    "connection reset",
    "connection refused",
    "connection closed",
    "broken pipe",
    "socket closed",
    "transport closed",
    "temporarily unavailable",
)

#: counters for observability (reported by the CLI's final stats and
#: available to tests); guarded by the GIL only — they are advisory.
transfer_stats = {
    "retries": 0,
    "stall_warnings": 0,
    "failures": 0,
}


def _is_transient(err: BaseException) -> bool:
    msg = f"{type(err).__name__}: {err}"
    if any(c in msg for c in _TRANSIENT_CODES):
        return True
    low = msg.lower()
    return any(m in low for m in _TRANSIENT_MARKERS)


class _Watchdog:
    """Logs to stderr if an operation takes longer than ``warn_after``
    seconds (and again every interval after). A blocked transfer inside
    the device runtime cannot be interrupted from Python, so detection
    is the most a host can do while it waits — but the log line turns a
    silent multi-minute hang into a diagnosable event."""

    def __init__(self, label: str, warn_after: float):
        self.label = label
        self.warn_after = warn_after
        self._done = threading.Event()
        self._t0 = time.perf_counter()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._done.wait(self.warn_after):
            dt = time.perf_counter() - self._t0
            transfer_stats["stall_warnings"] += 1
            print(
                f"[W::runtime] {self.label} has been blocked for "
                f"{dt:.0f} s (device stall?) — still waiting",
                file=sys.stderr,
                flush=True,
            )

    def cancel(self):
        self._done.set()


def _with_retry(op, label: str, retries: int | None, warn_after: float | None):
    if retries is None:
        retries = int(os.environ.get("RAWALIGN_TRANSFER_RETRIES", "3"))
    if warn_after is None:
        warn_after = float(
            os.environ.get("RAWALIGN_TRANSFER_WARN_S", "60")
        )
    delay = 1.0
    attempt = 0
    while True:
        wd = _Watchdog(label, warn_after) if warn_after > 0 else None
        try:
            return op()
        except Exception as e:  # noqa: BLE001 — classified below
            if not _is_transient(e):
                # not a transient failure (shape/compile/OOM bug):
                # re-raise without polluting the failure counter
                raise
            if attempt >= retries:
                transfer_stats["failures"] += 1
                raise
            attempt += 1
            transfer_stats["retries"] += 1
            print(
                f"[W::runtime] {label} failed with transient error "
                f"({type(e).__name__}: {str(e)[:200]}); retry "
                f"{attempt}/{retries} in {delay:.0f} s",
                file=sys.stderr,
                flush=True,
            )
            time.sleep(delay)
            delay = min(delay * 2, 30.0)
        finally:
            if wd is not None:
                wd.cancel()


def fetch(x, *, label: str = "device_get", retries: int | None = None,
          warn_after: float | None = None):
    """``jax.device_get`` with stall detection and transient-error
    retry. Safe to retry: a device->host copy has no side effects."""
    import jax

    return _with_retry(
        lambda: jax.device_get(x), label, retries, warn_after
    )


def put(x, sharding=None, *, label: str = "device_put",
        retries: int | None = None, warn_after: float | None = None):
    """``jax.device_put`` with stall detection and transient-error
    retry (idempotent: re-uploading the same host buffer is safe)."""
    import jax

    if sharding is None:
        op = lambda: jax.device_put(x)
    else:
        op = lambda: jax.device_put(x, sharding)
    return _with_retry(op, label, retries, warn_after)


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache for every compile and
    return its directory: JAX_COMPILATION_CACHE_DIR where that is set
    (JAX reads it itself; nothing else is set here), otherwise
    DEFAULT_CACHE_DIR."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
