"""The GPU banded-DTW kernel (native/dtw_banded.cu) as a JAX operation.

The library is built from the repository's source with ``nvcc`` for
``sm_90a`` on first use (``make -C native cuda``; the output is listed in
.gitignore) and registered as an XLA FFI target. The kernel has no
interpret mode: its reference is ``map.dtw.dtw_plain``, which it matches
bit for bit.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np

from rawalign_tpu.map.dtw import DESC_ROWS, MAX_DPW, TILE_BLOCK

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "native"
)
_SO = os.path.join(_NATIVE_DIR, "librawalign_dtw_cuda.so")
_TARGET = "rawalign_dtw_banded"

#: band widths the kernel is instantiated for (native/dtw_banded.cu)
DPW_SUPPORTED = tuple(16 << i for i in range(MAX_DPW.bit_length() - 4))


@functools.lru_cache(maxsize=1)
def register() -> None:
    """Build (if stale) and load the library, then register the target."""
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-s", "-C", _NATIVE_DIR, "cuda"], check=True)
    lib = ctypes.CDLL(_SO)
    jax.ffi.register_ffi_target(
        _TARGET, jax.ffi.pycapsule(lib.RawalignDtwBanded), platform="CUDA"
    )


def dtw_banded(src: jax.Array, desc: jax.Array, *, dpw: int) -> jax.Array:
    """(T,) float32 banded DTW costs; same contract as
    ``map.dtw.dtw_plain``. T must be a multiple of TILE_BLOCK."""
    if dpw not in DPW_SUPPORTED:
        raise ValueError(f"dtw kernel has no instance for dpw={dpw}")
    T = desc.shape[1]
    if desc.shape[0] != DESC_ROWS or T % TILE_BLOCK:
        raise ValueError(f"desc shape {desc.shape} is not (6, k*{TILE_BLOCK})")
    register()
    return jax.ffi.ffi_call(
        _TARGET, jax.ShapeDtypeStruct((T,), jnp.float32)
    )(src, desc.astype(jnp.int32), dpw=np.int32(dpw))
