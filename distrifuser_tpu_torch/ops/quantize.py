"""Per-token activation quantization: the hand-written Hopper kernel and
its wrapper.

The plain version is parallel/compress.py ``quantize(x, mode, axis=-1)``
(the counterpart of the JAX package's ``quantize``, which XLA fuses into
the ops around it; there is no Pallas kernel for it).  The kernel is CUDA
C++ for sm_90a in ``csrc/quantize_rows.cu``: one pass over the activation
that writes the 8-bit payload and one float32 scale per row, bit for bit
what ``quantize`` computes on the card; its header comment gives the
design and what bounds it.  It is built with ``nvcc`` at first use into
``build/kernels/`` and bound through a plain C entry point loaded with
``ctypes`` (ops/_build.py).

``quantize_rows(x, mode)`` takes x [M, K] (bfloat16 or float32 on the
card, unit column stride) and returns ``(xq [M, K], sx [M])``: int8 (or
float8_e4m3fn for "fp8") row-major and float32.  Its callers: the A
operand of ops/quant_matmul.py, and the compressed stale-refresh payloads
of the patch path (parallel/context.py, float32 rows of KV or halo
channels).  On a CUDA tensor it launches the kernel or raises; on a CPU
tensor it runs ``quantize``.
"""

from __future__ import annotations

import ctypes

import torch

from ..parallel.compress import quantize
from ._build import KernelLibrary, counts_launches, current_stream

_IN_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PAYLOADS = {"int8": (0, torch.int8), "fp8": (1, torch.float8_e4m3fn)}


def _bind(lib) -> None:
    fn = lib.quantize_rows
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])


_KERNEL = KernelLibrary("quantize_rows.cu", _bind)


def build() -> str:
    """Compile and load ``csrc/quantize_rows.cu`` (ops/_build.py); returns
    the compiler's ptxas report, or "" when an earlier build was reused."""
    return _KERNEL.build()


@counts_launches
def quantize_rows(x, mode: str):
    """Per-row symmetric quantization of x [M, K] to ``mode`` ("int8" or
    "fp8"): the kernel on the card, ``compress.quantize`` on the CPU.
    Counts each kernel launch in ``quantize_rows.launches``."""
    if x.dim() != 2:
        raise ValueError(f"quantize_rows takes x [M, K], got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return quantize(x, mode, axis=-1)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows: x on {x.device}; the kernel takes a CUDA tensor")
    if mode not in _PAYLOADS:
        raise ValueError(f"not a quantizing mode: {mode!r}")
    if x.dtype not in _IN_CODES:
        raise ValueError(f"quantize_rows kernel takes bfloat16 or float32, got {x.dtype}")
    m, k = x.shape
    if m == 0 or k == 0 or x.stride(1) != 1:
        raise ValueError(f"quantize_rows: x needs rows and a unit column stride, shape "
                         f"{tuple(x.shape)}, strides {x.stride()}")
    code, dtype = _PAYLOADS[mode]
    xq = torch.empty((m, k), dtype=dtype, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    rc = _KERNEL.lib.quantize_rows(x.data_ptr(), x.stride(0), xq.data_ptr(), sx.data_ptr(),
                                   m, k, _IN_CODES[x.dtype], code,
                                   current_stream(x.get_device()))
    if rc != 0:
        raise RuntimeError(f"quantize_rows kernel launch failed: cudaError {rc}")
    quantize_rows.launches += 1
    return xq, sx
