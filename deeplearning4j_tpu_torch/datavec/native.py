"""ctypes binding for the native CSV parser (``_fastcsv.cpp``, the port's
own copy of the JAX package's source; counterpart of its
``datavec/native.py``).

``parse_numeric_csv`` returns the parsed [rows, cols] float64 matrix, or
None whenever the native path can't take the file (no compiler, a
non-numeric field, ragged rows) — callers keep the Python csv path for
those. The C call releases the GIL, so prefetch threads parse in parallel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import numpy as np

from ..util.native import compile_and_load

_SRC = Path(__file__).parent / "_fastcsv.cpp"
_lib = None
_tried = False


def load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    lib = compile_and_load(_SRC)
    if lib is None:
        return None
    lib.csv_dims.restype = ctypes.c_long
    lib.csv_dims.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long)]
    lib.csv_parse_numeric.restype = ctypes.c_long
    lib.csv_parse_numeric.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_char, ctypes.c_long,
        ctypes.c_long, ctypes.c_long,
        ctypes.POINTER(ctypes.c_double), ctypes.c_long]
    _lib = lib
    return _lib


def parse_numeric_csv(data: bytes, delimiter: str = ",",
                      skip_lines: int = 0) -> Optional[np.ndarray]:
    """[rows, cols] float64 matrix, or None (caller uses the Python path)."""
    lib = load()
    if lib is None or len(delimiter) != 1:
        return None
    n = len(data)
    rows = ctypes.c_long(0)
    cols = ctypes.c_long(0)
    delim = ctypes.c_char(delimiter.encode())
    rc = lib.csv_dims(data, n, delim, skip_lines,
                      ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0 or rows.value == 0 or cols.value == 0:
        return None
    out = np.empty(rows.value * cols.value, dtype=np.float64)
    rc = lib.csv_parse_numeric(
        data, n, delim, skip_lines, rows.value, cols.value,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), out.size)
    if rc != rows.value:
        return None
    return out.reshape(rows.value, cols.value)
