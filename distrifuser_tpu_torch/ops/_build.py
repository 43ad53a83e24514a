"""Build a CUDA source of ``csrc/`` at first use and load it with ctypes.

Each kernel module holds one ``KernelLibrary``: its ``build()`` compiles
``csrc/<source>`` with ``nvcc`` for sm_90a into a shared library with a
plain C interface, under ``build/kernels/`` beside the package (listed in
``.gitignore``), named by a hash of the source, every header under
``csrc/`` (``*.cuh``, which the sources include) and the flags, so that
an edited source or header is rebuilt.  The library is loaded with
``ctypes`` and handed to the module's ``bind`` function, which sets each
entry point's argument and result types.  Nothing is compiled when a
module is imported.

Every kernel wrapper counts its launches in its own ``launches``
attribute and is listed in ``LAUNCH_COUNTERS`` (``counts_launches``), the
one list that whoever reads or replays the counts (parallel/graphs.py)
walks.  Counts change only through ``add_launches``: under one lock, since
servers on several threads (replicas sharing a card) launch at once, and
into a tally of its own on a thread that captures a CUDA graph
(``launch_tally``), so that a capture records its own launches and no
other thread's.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCH_COUNTERS: list = []
_COUNT_LOCK = threading.Lock()
_TALLY = threading.local()


def counts_launches(wrapper):
    """Give a kernel wrapper a ``launches`` count, 0, which it adds one to
    where it launches its kernel, and list it in ``LAUNCH_COUNTERS``."""
    wrapper.launches = 0
    LAUNCH_COUNTERS.append(wrapper)
    return wrapper


def add_launches(counter, n: int = 1, attr: str = "launches", head_dim=None) -> None:
    """Add ``n`` to ``counter``'s count ``attr`` (a kernel wrapper's, or the
    all-to-all's), and with ``head_dim`` to ``<attr>_by_head_dim[head_dim]``.
    Within ``launch_tally`` on this thread the count goes to the tally
    instead (the by-head-dim one still counts, as an eager call's)."""
    tally = getattr(_TALLY, "counts", None)
    with _COUNT_LOCK:
        if tally is not None:
            tally[(counter, attr)] = tally.get((counter, attr), 0) + n
        else:
            setattr(counter, attr, getattr(counter, attr) + n)
        if head_dim is not None:
            getattr(counter, attr + "_by_head_dim")[head_dim] += n


@contextlib.contextmanager
def launch_tally():
    """Within the block, this thread's launch counts go to the dict it
    yields, ``{(counter, attr): n}``, not to the counters; other threads
    keep counting theirs."""
    outer = getattr(_TALLY, "counts", None)
    _TALLY.counts = tally = {}
    try:
        yield tally
    finally:
        _TALLY.counts = outer


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


LIBRARIES: list = []  # every KernelLibrary, in the order the modules made them


def build_all() -> None:
    """Build (or load) every kernel library of the package now, one
    ``nvcc`` a source, all at once: what a caller does before the first
    collective when no rank may compile while its peers wait
    (serve/ranks.py)."""
    from . import flash_attention, quant_matmul, quantize  # noqa: F401 -- their libraries

    threads = [threading.Thread(target=lib.build, daemon=True) for lib in LIBRARIES]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for lib in LIBRARIES:
        lib.lib  # noqa: B018 -- raises here if a build failed


class KernelLibrary:
    """One ``csrc/`` source, built once per process and loaded."""

    def __init__(self, source: str, bind):
        LIBRARIES.append(self)
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
            digest = hashlib.sha256(self.source.read_bytes())
            for header in sorted(CSRC.glob("*.cuh")):
                digest.update(header.name.encode() + header.read_bytes())
            digest.update(" ".join(NVCC_FLAGS).encode())
            tag = digest.hexdigest()[:16]
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


def current_stream(index: int) -> int:
    """The raw handle of PyTorch's current stream on the CUDA device of
    that index (what a kernel launches on), without building a Stream
    object."""
    return torch._C._cuda_getCurrentRawStream(index)
