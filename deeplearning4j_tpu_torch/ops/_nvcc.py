"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``ops/csrc/`` becomes one shared library with a plain C
interface, compiled for Hopper (``sm_90a``) at first use. Libraries land
in ``build/kernels/<name>-<hash>/`` at the repository root, keyed by a
hash of the source and the flags, so a second run reuses the build and an
edited source rebuilds.

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
from typing import Dict, Optional

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


class CudaKernel:
    """One ``csrc/<name>.cu`` source, its shared library, and a launch count.

    ``launches`` is a plain integer that the op's wrapper increments each
    time it launches the kernel, and nowhere else — a run can read it to
    show that a path really went through the kernel."""

    def __init__(self, name: str):
        self.name = name
        self.source = CSRC / f"{name}.cu"
        self.launches = 0
        self.build_seconds: Optional[float] = None
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None

    def _digest(self) -> str:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return h.hexdigest()[:16]

    def library_path(self) -> Path:
        return BUILD_ROOT / f"{self.name}-{self._digest()}" / f"lib{self.name}.so"

    def _build(self) -> None:
        """Compile the source into the library path (atomically: nvcc
        writes a temporary file that is then renamed)."""
        lib = self.library_path()
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f".{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        self.build_log = proc.stdout
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source}:\n{proc.stdout}")
        os.replace(tmp, lib)
        lib.with_name("build.log").write_text(proc.stdout)

    def lib(self) -> ctypes.CDLL:
        """The loaded library, building it first if needed."""
        if self._lib is None:
            with _lock:
                if self._lib is None:
                    t0 = time.perf_counter()
                    lib = self.library_path()
                    if lib.exists():
                        log = lib.with_name("build.log")
                        self.build_log = log.read_text() if log.exists() else ""
                    else:
                        self._build()
                    self.build_seconds = time.perf_counter() - t0
                    self._lib = ctypes.CDLL(str(lib))
        return self._lib


KERNELS: Dict[str, CudaKernel] = {}


def kernel(name: str) -> CudaKernel:
    """The registered :class:`CudaKernel` for ``csrc/<name>.cu``."""
    if name not in KERNELS:
        KERNELS[name] = CudaKernel(name)
    return KERNELS[name]
