"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``ops/csrc/`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) at first use. Libraries land
in ``build/kernels/<name>-<hash>/`` at the repository root, keyed by a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
a second run reuses the build and an edited source or header rebuilds.
The first kernel call (or :func:`build_all`) compiles every missing
library at once, one ``nvcc`` process per source, and records each one's
build seconds.

Nothing here runs on import: the CPU-only test environment has no
``nvcc``, and no CUDA tensor ever reaches a kernel there.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source at first use and need the CUDA toolkit")


class Library:
    """One ``csrc/<name>.cu`` source and the shared library built from it.

    ``build_seconds`` is the wall time from the start of the (concurrent)
    build until this library was built, or loaded when it was built
    already; ``build_log``
    holds ``nvcc``'s output, ``-Xptxas -v`` register and spill counts
    included."""

    def __init__(self, name: str):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None

    def _digest(self) -> str:
        """The source, every header under ``csrc/`` (a source may include
        any of them) and the flags."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.name.encode())
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return h.hexdigest()[:16]

    def library_path(self) -> Path:
        return BUILD_ROOT / f"{self.name}-{self._digest()}" / f"lib{self.name}.so"

    def _start_build(self) -> subprocess.Popen:
        """Start nvcc on the source; it writes a temporary file that
        :meth:`_finish_build` renames into place (atomically)."""
        lib = self.library_path()
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def _finish_build(self, proc: subprocess.Popen) -> None:
        out, _ = proc.communicate()
        lib = self.library_path()
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        self.build_log = out
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
        os.replace(tmp, lib)
        lib.with_name("build.log").write_text(out)

    def _load(self) -> None:
        lib = self.library_path()
        log = lib.with_name("build.log")
        if not self.build_log and log.exists():
            self.build_log = log.read_text()
        self._lib = ctypes.CDLL(str(lib))

    def lib(self) -> ctypes.CDLL:
        """The loaded library. Its first use builds and loads every
        registered library at once (:func:`build_all`)."""
        if self._lib is None:
            build_all()
        return self._lib


class CudaKernel:
    """One C entry point of a library, and its launch count.

    ``launches`` is a plain integer that the op's wrapper increments each
    time it launches the kernel, and nowhere else — a run can read it to
    show that a path really went through the kernel."""

    def __init__(self, name: str, library: Library):
        self.name = name
        self.library = library
        self.launches = 0
        self._fn = None

    def fn(self, argtypes: List) -> ctypes._CFuncPtr:
        """The entry point with its ctypes signature (returns an int: the
        launch's cudaError_t)."""
        if self._fn is None:
            fn = getattr(self.library.lib(), self.name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
            self._fn = fn
        return self._fn


LIBRARIES: Dict[str, Library] = {}
KERNELS: Dict[str, CudaKernel] = {}


def kernel(name: str, source: Optional[str] = None) -> CudaKernel:
    """The registered :class:`CudaKernel` for entry point ``name`` of
    ``csrc/<source>.cu`` (``source`` defaults to ``name``)."""
    source = source or name
    if source not in LIBRARIES:
        LIBRARIES[source] = Library(source)
    if name not in KERNELS:
        KERNELS[name] = CudaKernel(name, LIBRARIES[source])
    return KERNELS[name]


def build_all() -> Dict[str, float]:
    """Build every registered library that is not built yet, all ``nvcc``
    processes at once, then load them all. Returns each library's
    ``build_seconds``."""
    with _lock:
        pending = [lib for lib in LIBRARIES.values() if lib._lib is None]
        t0 = time.perf_counter()
        errors: List[Exception] = []

        def finish(lib: Library, proc: subprocess.Popen) -> None:
            try:
                lib._finish_build(proc)
            except Exception as e:   # re-raised below, in the caller
                errors.append(e)
            lib.build_seconds = time.perf_counter() - t0

        waiters = [threading.Thread(target=finish,
                                    args=(lib, lib._start_build()))
                   for lib in pending if not lib.library_path().exists()]
        for w in waiters:
            w.start()
        for w in waiters:
            w.join()
        if errors:
            raise errors[0]
        for lib in pending:
            lib._load()
            if lib.build_seconds is None:   # found built: the load only
                lib.build_seconds = time.perf_counter() - t0
    return {name: lib.build_seconds for name, lib in LIBRARIES.items()}
