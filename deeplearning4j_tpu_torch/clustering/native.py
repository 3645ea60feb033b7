"""ctypes binding for the C++ Barnes-Hut kernel (``_sptree.cpp``, the port's
own copy of the JAX package's source; counterpart of its
``clustering/native.py``).

Compiled at first use through ``util/native.py`` into ``build/native/``
(keyed by source hash) and bound with the reference's ctypes signatures.
This is host code, not a device kernel: ``load()`` returns None when no
compiler is available, and callers then use the pure-Python
:mod:`.sptree` implementation.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from ..util.native import compile_and_load

_SRC = Path(__file__).parent / "_sptree.cpp"
_lib: Optional[ctypes.CDLL] = None
_tried = False


def load() -> Optional[ctypes.CDLL]:
    """The compiled kernel, or None (then use sptree.SpTree)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    lib = compile_and_load(_SRC)
    if lib is None:
        return None
    lib.bh_tsne_gradient.restype = ctypes.c_int
    lib.bh_tsne_gradient.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_int,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_double), ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double)]
    lib.bh_non_edge_forces.restype = ctypes.c_double
    lib.bh_non_edge_forces.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_long, ctypes.c_int,
        ctypes.c_long, ctypes.c_double, ctypes.POINTER(ctypes.c_double)]
    _lib = lib
    return _lib


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _lptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_long))


def bh_gradient(y: np.ndarray, row_ptr: np.ndarray, cols: np.ndarray,
                vals: np.ndarray, theta: float):
    """BH t-SNE gradient via the native kernel. Returns (dC [n,d], kl).
    Raises if the kernel is unavailable — callers check load() first."""
    lib = load()
    if lib is None:
        raise RuntimeError("native SpTree kernel unavailable")
    y = np.ascontiguousarray(y, dtype=np.float64)
    row_ptr = np.ascontiguousarray(row_ptr, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    vals = np.ascontiguousarray(vals, dtype=np.float64)
    n, d = y.shape
    dc = np.zeros_like(y)
    kl = ctypes.c_double(0.0)
    rc = lib.bh_tsne_gradient(_dptr(y), n, d, _lptr(row_ptr), _lptr(cols),
                              _dptr(vals), float(theta), _dptr(dc),
                              ctypes.byref(kl))
    if rc != 0:
        raise RuntimeError(f"bh_tsne_gradient failed rc={rc}")
    return dc, float(kl.value)


def non_edge_forces(y: np.ndarray, i: int, theta: float):
    """Single-point repulsion via native SpTree (test hook). Returns
    (neg_force [d], sum_q)."""
    lib = load()
    if lib is None:
        raise RuntimeError("native SpTree kernel unavailable")
    y = np.ascontiguousarray(y, dtype=np.float64)
    n, d = y.shape
    neg = np.zeros(d)
    sq = lib.bh_non_edge_forces(_dptr(y), n, d, int(i), float(theta),
                                _dptr(neg))
    return neg, float(sq)
