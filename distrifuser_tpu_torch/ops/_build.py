"""Build a CUDA source of ``csrc/`` at first use and load it with ctypes.

Each kernel module holds one ``KernelLibrary``: its ``build()`` compiles
``csrc/<source>`` with ``nvcc`` for sm_90a into a shared library with a
plain C interface, under ``build/kernels/`` beside the package (listed in
``.gitignore``), named by a hash of the source and the flags so that an
edited source is rebuilt.  The library is loaded with ``ctypes`` and handed
to the module's ``bind`` function, which sets each entry point's argument
and result types.  Nothing is compiled when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


class KernelLibrary:
    """One ``csrc/`` source, built once per process and loaded."""

    def __init__(self, source: str, bind):
        self.source = CSRC / source
        self._bind = bind
        self._lib = None
        self._log = ""
        self._lock = threading.Lock()

    def build(self) -> str:
        """Compile the source if this version has not been built yet, load
        it, and return the compiler's output (ptxas register and
        shared-memory report), or "" when an earlier build was reused."""
        with self._lock:
            if self._lib is not None:
                return self._log
            src = self.source.read_bytes()
            tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
            so = BUILD_DIR / f"lib{self.source.stem}_{tag}.so"
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                    capture_output=True, text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed building {self.source.name}:\n"
                                       f"{proc.stdout}{proc.stderr}")
                os.replace(tmp, so)
                self._log = proc.stdout + proc.stderr
            lib = ctypes.CDLL(str(so))
            self._bind(lib)
            self._lib = lib
            return self._log

    @property
    def lib(self):
        """The loaded library, built first if needed."""
        if self._lib is None:
            self.build()
        return self._lib
