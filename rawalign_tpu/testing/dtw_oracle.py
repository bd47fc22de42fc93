"""Build and wrap the reference DTW implementation as a test oracle.

Compiles /root/reference/src/dtw.cpp (read-only reference checkout; not
part of this repo) into a shared library at test time and exposes its
functions via ctypes. Used only by the test suite to validate the golden
model and the device kernels against the actual reference semantics. If the
reference checkout or a C++ compiler is unavailable, oracle tests skip.
"""

from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import tempfile

import numpy as np

REFERENCE_DTW = "/root/reference/src/dtw.cpp"

_WRAPPER = r"""
#include "%(dtw_cpp)s"

extern "C" {

float c_dtw_global(const float* a, uint32_t al, const float* b, uint32_t bl,
                   int excl) {
  return DTW_global(a, al, b, bl, excl != 0);
}
float c_dtw_global_slow(const float* a, uint32_t al, const float* b,
                        uint32_t bl, int excl) {
  return DTW_global_slow(a, al, b, bl, excl != 0);
}
float c_dtw_global_diagonalbanded(const float* a, uint32_t al, const float* b,
                                  uint32_t bl, int r, int excl) {
  return DTW_global_diagonalbanded(a, al, b, bl, r, excl != 0);
}
float c_dtw_global_slantedbanded(const float* a, uint32_t al, const float* b,
                                 uint32_t bl, int r, int excl) {
  return DTW_global_slantedbanded(a, al, b, bl, r, excl != 0);
}
float c_dtw_global_slantedbanded_antidiagonalwise(const float* a, uint32_t al,
                                                  const float* b, uint32_t bl,
                                                  int r, int excl) {
  return DTW_global_slantedbanded_antidiagonalwise(a, al, b, bl, r, excl != 0);
}
float c_dtw_semiglobal(const float* a, uint32_t al, const float* b,
                       uint32_t bl, int excl) {
  return DTW_semiglobal(a, al, b, bl, excl != 0);
}
float c_dtw_semiglobal_slow(const float* a, uint32_t al, const float* b,
                            uint32_t bl, int excl) {
  return DTW_semiglobal_slow(a, al, b, bl, excl != 0);
}
int c_dtw_global_tb(const float* a, uint32_t al, const float* b, uint32_t bl,
                    int excl, float* cost, uint32_t* is, uint32_t* js,
                    float* diffs, int cap) {
  dtw_result res = DTW_global_tb(a, al, b, bl, excl != 0);
  *cost = res.cost;
  int n = (int)res.alignment.size();
  if (n > cap) return -n;
  for (int i = 0; i < n; i++) {
    is[i] = res.alignment[i].position.i;
    js[i] = res.alignment[i].position.j;
    diffs[i] = res.alignment[i].difference;
  }
  return n;
}
int c_dtw_semiglobal_tb(const float* a, uint32_t al, const float* b,
                        uint32_t bl, int excl, float* cost, uint32_t* is,
                        uint32_t* js, float* diffs, int cap) {
  dtw_result res = DTW_semiglobal_tb(a, al, b, bl, excl != 0);
  *cost = res.cost;
  int n = (int)res.alignment.size();
  if (n > cap) return -n;
  for (int i = 0; i < n; i++) {
    is[i] = res.alignment[i].position.i;
    js[i] = res.alignment[i].position.j;
    diffs[i] = res.alignment[i].difference;
  }
  return n;
}

}  // extern "C"
"""


@functools.lru_cache(maxsize=1)
def load_oracle():
    """Compile (once per environment) and load the oracle library.

    Returns the ctypes CDLL or None if unavailable.
    """
    if not os.path.exists(REFERENCE_DTW):
        return None
    cache_dir = os.path.join(tempfile.gettempdir(), "rawalign_tpu_oracle")
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, "dtw_oracle.so")
    if not os.path.exists(so_path):
        wrapper = os.path.join(cache_dir, "dtw_wrapper.cpp")
        with open(wrapper, "w") as f:
            f.write(_WRAPPER % {"dtw_cpp": REFERENCE_DTW})
        cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", wrapper, "-o", so_path]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except (subprocess.CalledProcessError, FileNotFoundError):
            return None
    lib = ctypes.CDLL(so_path)
    fl = ctypes.c_float
    u32 = ctypes.c_uint32
    i32 = ctypes.c_int
    pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    pu = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    for name in (
        "c_dtw_global",
        "c_dtw_global_slow",
        "c_dtw_semiglobal",
        "c_dtw_semiglobal_slow",
    ):
        fn = getattr(lib, name)
        fn.restype = fl
        fn.argtypes = [pf, u32, pf, u32, i32]
    for name in (
        "c_dtw_global_diagonalbanded",
        "c_dtw_global_slantedbanded",
        "c_dtw_global_slantedbanded_antidiagonalwise",
    ):
        fn = getattr(lib, name)
        fn.restype = fl
        fn.argtypes = [pf, u32, pf, u32, i32, i32]
    for name in ("c_dtw_global_tb", "c_dtw_semiglobal_tb"):
        fn = getattr(lib, name)
        fn.restype = i32
        fn.argtypes = [
            pf,
            u32,
            pf,
            u32,
            i32,
            ctypes.POINTER(ctypes.c_float),
            pu,
            pu,
            pf,
            i32,
        ]
    return lib


def _as32(x):
    return np.ascontiguousarray(x, dtype=np.float32)


def dtw_global(a, b, excl=False):
    lib = load_oracle()
    a, b = _as32(a), _as32(b)
    return float(lib.c_dtw_global(a, a.size, b, b.size, int(excl)))


def dtw_global_slow(a, b, excl=False):
    lib = load_oracle()
    a, b = _as32(a), _as32(b)
    return float(lib.c_dtw_global_slow(a, a.size, b, b.size, int(excl)))


def dtw_global_diagonalbanded(a, b, r, excl=False):
    lib = load_oracle()
    a, b = _as32(a), _as32(b)
    return float(
        lib.c_dtw_global_diagonalbanded(a, a.size, b, b.size, int(r), int(excl))
    )


def dtw_global_slantedbanded(a, b, r, excl=False):
    lib = load_oracle()
    a, b = _as32(a), _as32(b)
    return float(
        lib.c_dtw_global_slantedbanded(a, a.size, b, b.size, int(r), int(excl))
    )


def dtw_global_slantedbanded_antidiagonalwise(a, b, r, excl=False):
    lib = load_oracle()
    a, b = _as32(a), _as32(b)
    return float(
        lib.c_dtw_global_slantedbanded_antidiagonalwise(
            a, a.size, b, b.size, int(r), int(excl)
        )
    )


def dtw_semiglobal(a, b, excl=False):
    lib = load_oracle()
    a, b = _as32(a), _as32(b)
    return float(lib.c_dtw_semiglobal(a, a.size, b, b.size, int(excl)))


def dtw_semiglobal_slow(a, b, excl=False):
    lib = load_oracle()
    a, b = _as32(a), _as32(b)
    return float(lib.c_dtw_semiglobal_slow(a, a.size, b, b.size, int(excl)))


def _tb(fn, a, b, excl):
    a, b = _as32(a), _as32(b)
    cap = int(a.size + b.size + 2)
    cost = ctypes.c_float()
    is_ = np.zeros(cap, dtype=np.uint32)
    js = np.zeros(cap, dtype=np.uint32)
    diffs = np.zeros(cap, dtype=np.float32)
    n = fn(a, a.size, b, b.size, int(excl), ctypes.byref(cost), is_, js, diffs, cap)
    assert n >= 0, "oracle traceback buffer too small"
    return float(cost.value), is_[:n].copy(), js[:n].copy(), diffs[:n].copy()


def dtw_global_tb(a, b, excl=False):
    lib = load_oracle()
    return _tb(lib.c_dtw_global_tb, a, b, excl)


def dtw_semiglobal_tb(a, b, excl=False):
    lib = load_oracle()
    return _tb(lib.c_dtw_semiglobal_tb, a, b, excl)
