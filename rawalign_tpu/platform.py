"""The one place that picks an implementation for the platform JAX runs on.

On the GPU (an NVIDIA H100) the device stages that have a hand-written
kernel use it: banded DTW (native/dtw_banded.cu through the XLA FFI).
On the CPU, which serves the tests, the same stages run as plain JAX,
which is also the reference the kernels are compared with. No other
platform is supported.
"""

from __future__ import annotations

import jax

SUPPORTED = ("gpu", "cpu")


def use_kernels(backend: str | None = None) -> bool:
    """True where the hand-written GPU kernels run, False where the plain
    JAX versions do. ``backend`` defaults to ``jax.default_backend()``;
    any platform other than ``gpu`` or ``cpu`` raises."""
    b = jax.default_backend() if backend is None else backend
    if b == "gpu":
        return True
    if b == "cpu":
        return False
    raise RuntimeError(
        f"unsupported JAX platform {b!r}: rawalign_tpu runs on "
        f"{' or '.join(SUPPORTED)}"
    )
