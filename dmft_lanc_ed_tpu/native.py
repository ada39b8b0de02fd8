"""ctypes bindings for the native host-side builder (native/edcore.cpp).

libedcore.so is not tracked: the first use builds it from edcore.cpp with
native/build.sh (again whenever the source is newer), then loads it. Every
entry point has a numpy fallback in :mod:`.sectors`, so the package works
without a compiler. Enable/disable via the DMFT_ED_NATIVE env var (default:
use if loadable).
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional, Tuple

import numpy as np

log = logging.getLogger("dmft_lanc_ed_tpu")

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _root() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")


def load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("DMFT_ED_NATIVE", "1") == "0":
        return None
    so = os.path.join(_root(), "libedcore.so")
    src = os.path.join(_root(), "edcore.cpp")
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
        try:
            subprocess.run(["sh", os.path.join(_root(), "build.sh")],
                           check=True, capture_output=True, timeout=120)
        except (subprocess.SubprocessError, OSError) as e:
            log.debug("native build failed (%s); using numpy fallback", e)
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    lib.ed_enumerate_states.restype = ctypes.c_int64
    lib.ed_enumerate_states.argtypes = [ctypes.c_int32, ctypes.c_int32, i64p]
    lib.ed_hop_entries.restype = ctypes.c_int64
    lib.ed_hop_entries.argtypes = [i64p, ctypes.c_int64, i32p, i32p, f64p,
                                   ctypes.c_int32, i64p, i64p, f64p]
    lib.ed_encode_runs.restype = ctypes.c_int64
    lib.ed_encode_runs.argtypes = [i64p, i64p, f64p, ctypes.c_int64,
                                   i64p, i64p, i64p, f64p]
    lib.ed_occupations.restype = None
    lib.ed_occupations.argtypes = [i64p, ctypes.c_int64, ctypes.c_int32, i8p]
    _LIB = lib
    return _LIB


def enumerate_states(ns: int, npart: int) -> Optional[np.ndarray]:
    lib = load()
    if lib is None:
        return None
    from math import comb
    out = np.empty(comb(ns, npart), dtype=np.int64)
    n = lib.ed_enumerate_states(ns, npart, out)
    return out[:n]


def hop_entries_batch(states: np.ndarray, pos_c: np.ndarray,
                      pos_d: np.ndarray, amps: np.ndarray
                      ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    lib = load()
    if lib is None:
        return None
    states = np.ascontiguousarray(states, dtype=np.int64)
    n = len(states)
    nt = len(pos_c)
    cap = n * max(nt, 1)
    rows = np.empty(cap, np.int64)
    cols = np.empty(cap, np.int64)
    vals = np.empty(cap, np.float64)
    nnz = lib.ed_hop_entries(states, n,
                             np.ascontiguousarray(pos_c, np.int32),
                             np.ascontiguousarray(pos_d, np.int32),
                             np.ascontiguousarray(amps, np.float64),
                             nt, rows, cols, vals)
    return rows[:nnz], cols[:nnz], vals[:nnz]


def encode_runs(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray
                ) -> Optional[Tuple[np.ndarray, ...]]:
    lib = load()
    if lib is None:
        return None
    nnz = len(rows)
    d0 = np.empty(nnz, np.int64)
    s0 = np.empty(nnz, np.int64)
    ln = np.empty(nnz, np.int64)
    vv = np.empty(nnz, np.float64)
    nr = lib.ed_encode_runs(np.ascontiguousarray(rows, np.int64),
                            np.ascontiguousarray(cols, np.int64),
                            np.ascontiguousarray(vals, np.float64),
                            nnz, d0, s0, ln, vv)
    return d0[:nr], s0[:nr], ln[:nr], vv[:nr]
