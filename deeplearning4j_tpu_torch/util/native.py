"""Native host-code build and load: C++ sources compiled at first use with
the system toolchain and bound through ctypes (counterpart of the JAX
package's ``util/native.py``).

One loader serves every host kernel (``datavec/_fastcsv.cpp``, ...): the
shared library is cached under ``build/native/<stem>-<hash>.so`` at the
checkout's root (beside the CUDA kernels' ``build/kernels``), keyed by a
hash of the source and the flags; it is compiled to a process-private
name and renamed atomically, so a concurrent first user never dlopens a
half-written file. Without a compiler the loader warns and returns None,
and callers keep their pure-Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import warnings
from pathlib import Path
from typing import Optional, Sequence

BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"

_cache: dict = {}


def compile_and_load(src: Path, *, flags: Sequence[str] = ()
                     ) -> Optional[ctypes.CDLL]:
    """Compile ``src`` (cached by content hash) and dlopen it; None on any
    failure (missing source, no g++, compile error) with a warning."""
    src = Path(src)
    key = (str(src), tuple(flags))
    if key in _cache:
        return _cache[key]
    lib = _build(src, tuple(flags))
    _cache[key] = lib
    return lib


def library_path(src: Path, flags: Sequence[str] = ()) -> Path:
    """Where ``compile_and_load`` keeps the library built from ``src``."""
    src = Path(src)
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_ROOT / f"{src.stem}-{digest}.so"


def _build(src: Path, flags) -> Optional[ctypes.CDLL]:
    if not src.exists():
        return None
    so = library_path(src, flags)
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        # compile to a process-private name, then atomically rename: a
        # second process must never dlopen a half-written .so
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++14",
               *flags, "-o", str(tmp), str(src)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except Exception as e:
            if tmp.exists():
                tmp.unlink()
            warnings.warn(f"native build of {src.name} failed ({e}); "
                          "using the pure-Python fallback")
            return None
    try:
        return ctypes.CDLL(str(so))
    except OSError as e:
        warnings.warn(f"loading {so.name} failed ({e}); "
                      "using the pure-Python fallback")
        return None
