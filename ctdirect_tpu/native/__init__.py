"""Native (C++) runtime pieces, loaded via ctypes.

The reference stack's performance-critical linear algebra lives in native code
(Ipopt C++, MUMPS Fortran — SURVEY.md §2.2). Here the device compute path is
JAX, and the native library is a HOST oracle: a structure-exploiting
block-tridiagonal + arrowhead KKT solver (csrc/blocktri.cpp, per-block pivoted
LU in f64, OpenMP-batched) that the tests and chip_smoke.py check the JAX
solvers against. No solver path falls back to it. Built on first use with
g++ into libblocktri.so next to this file (not committed)."""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
_REPO = _HERE.parent.parent
_SRC = _REPO / "csrc" / "blocktri.cpp"
_SO = _HERE / "libblocktri.so"

_lib = None


def build(force: bool = False) -> Path:
    """Compile the native library (g++ -O3 -fopenmp) if needed."""
    if _SO.exists() and not force and _SO.stat().st_mtime >= _SRC.stat().st_mtime:
        return _SO
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-fPIC",
        "-shared",
        "-fopenmp",
        str(_SRC),
        "-o",
        str(_SO),
    ]
    subprocess.run(cmd, check=True, capture_output=True)
    return _SO


def _load():
    global _lib
    if _lib is None:
        build()
        _lib = ctypes.CDLL(str(_SO))
        dp = ctypes.POINTER(ctypes.c_double)
        _lib.blocktri_solve.restype = ctypes.c_int
        _lib.blocktri_solve.argtypes = [ctypes.c_int] * 3 + [dp] * 8
        _lib.blocktri_solve_batch.restype = ctypes.c_int
        _lib.blocktri_solve_batch.argtypes = [ctypes.c_int] * 4 + [dp] * 8
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def _ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def blocktri_solve(A, B, E, F, r, rb):
    """Solve one block-tridiagonal + border system on the host.

    Shapes: A (N,bs,bs), B (N-1,bs,bs), E (N,bs,wb), F (wb,wb), r (N,bs),
    rb (wb,). Returns (X (N,bs), xb (wb,))."""
    lib = _load()
    A = np.ascontiguousarray(A, dtype=np.float64)
    B = np.ascontiguousarray(B, dtype=np.float64)
    E = np.ascontiguousarray(E, dtype=np.float64)
    F = np.ascontiguousarray(F, dtype=np.float64)
    r = np.ascontiguousarray(r, dtype=np.float64)
    rb = np.ascontiguousarray(rb, dtype=np.float64)
    N, bs = r.shape
    wb = rb.shape[0]
    X = np.empty((N, bs), dtype=np.float64)
    xb = np.empty((wb,), dtype=np.float64)
    st = lib.blocktri_solve(
        N, bs, wb, _ptr(A), _ptr(B), _ptr(E), _ptr(F), _ptr(r), _ptr(rb), _ptr(X), _ptr(xb)
    )
    if st != 0:
        raise RuntimeError(f"blocktri_solve failed with status {st}")
    return X, xb


def blocktri_solve_batch(A, B, E, F, r, rb):
    """Batched host solve (OpenMP across instances). Leading batch axis on
    every argument."""
    lib = _load()
    arrs = [np.ascontiguousarray(x, dtype=np.float64) for x in (A, B, E, F, r, rb)]
    A, B, E, F, r, rb = arrs
    batch, N, bs = r.shape
    wb = rb.shape[1]
    X = np.empty((batch, N, bs), dtype=np.float64)
    xb = np.empty((batch, wb), dtype=np.float64)
    st = lib.blocktri_solve_batch(
        batch, N, bs, wb, _ptr(A), _ptr(B), _ptr(E), _ptr(F), _ptr(r), _ptr(rb), _ptr(X), _ptr(xb)
    )
    if st != 0:
        raise RuntimeError(f"blocktri_solve_batch failed with status {st}")
    return X, xb
