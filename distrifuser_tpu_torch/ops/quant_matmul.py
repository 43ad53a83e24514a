"""Quantized matmul: the hand-written Hopper kernel, its wrapper and its
plain version.

Counterpart of distrifuser_tpu/ops/quant_matmul.py (``_qmm_kernel``
launched by ``quant_matmul``), the ``"pallas"`` route of
ops/gemm_routing.py.  The kernel is CUDA C++ for sm_90a in
``csrc/quant_matmul.cu`` (s8 and e4m3 tensor-core MMA); its header comment
gives the design and what bounds it.  It is built with ``nvcc`` at first
use into ``build/kernels/`` and bound through a plain C entry point loaded
with ``ctypes`` (ops/_build.py).

Contract, as in the JAX package (what ops/linear.py feeds it):

* ``xq`` [M, K]: the activation, quantized per token to the weight's
  payload type (int8 or float8_e4m3fn);
* ``wq`` [K, N]: the ``QuantizedTensor`` payload, same type;
* ``sw`` [N] float32: per-output-channel weight scales, channel_tile
  already expanded (``QuantizedTensor.channel_scale``);
* returns [M, N] float32 ``(xq @ wq) * sw``; the caller applies the
  per-token activation scale and casts.

Accumulation is int32 for int8 and float32 for fp8.  On a CUDA tensor the
wrapper launches the kernel or raises; on a CPU tensor it runs
``quant_matmul_reference``.  The kernel wants ``xq`` row-major and ``wq``
column-major (memory [N, K], torch's Linear layout, which is how
``quantize_weight`` holds a linear payload).  The TPU tile arguments
(``block_m``/``block_n``/``block_k``) have no counterpart: the CUDA
kernel's tiles are fixed, and ragged M, N and K are masked inside it, so no
caller pads.
"""

from __future__ import annotations

import ctypes

import torch

from ._build import KernelLibrary

_PAYLOAD_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}


def _bind(lib) -> None:
    fn = lib.quant_matmul_8bit
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


_KERNEL = KernelLibrary("quant_matmul.cu", _bind)


def build() -> str:
    """Compile and load ``csrc/quant_matmul.cu`` (ops/_build.py); returns
    the compiler's ptxas report, or "" when an earlier build was reused."""
    return _KERNEL.build()


def _check_shapes(xq, wq, sw):
    if xq.dim() != 2 or wq.dim() != 2:
        raise ValueError(f"quant_matmul takes 2D operands, got {tuple(xq.shape)} "
                         f"@ {tuple(wq.shape)}")
    m, k = xq.shape
    k2, n = wq.shape
    if k != k2 or tuple(sw.shape) != (n,):
        raise ValueError(f"shape mismatch: x [M={m}, K={k}], w [K={k2}, N={n}], "
                         f"sw {tuple(sw.shape)} (want [N])")
    return m, k, n


def quant_matmul_reference(xq, wq, sw):
    """Plain PyTorch ``(xq @ wq) * sw`` in float32.

    int8: the product is taken in float64, where every partial sum of
    8-bit products (each below 2**14, K below 2**14) is an exact integer,
    so rounding it to float32 is what the int32 -> float32 cast does; the
    result is bit-identical to an int32 accumulation.  (``xq @ wq`` on int8
    tensors would return int8 and wrap.)  fp8: every e4m3 product is exact
    in float32; only the order of the sums differs from the kernel's."""
    _check_shapes(xq, wq, sw)
    if xq.dtype == torch.int8:
        acc = (xq.double() @ wq.double()).float()
    else:
        acc = xq.float() @ wq.float()
    return acc * sw.float()


def quant_matmul(xq, wq, sw):
    """(xq @ wq) * sw with 8-bit MACs: the kernel on the card, the plain
    version on the CPU.  Counts each kernel launch in
    ``quant_matmul.launches``."""
    m, k, n = _check_shapes(xq, wq, sw)
    if xq.device.type == "cpu" and wq.device.type == "cpu" and sw.device.type == "cpu":
        return quant_matmul_reference(xq, wq, sw)
    for name, t in (("xq", xq), ("wq", wq), ("sw", sw)):
        if t.device.type != "cuda":
            raise ValueError(f"quant_matmul: {name} on {t.device}; the kernel "
                             "takes CUDA tensors on one device")
        if t.device != xq.device:
            raise ValueError(f"quant_matmul: {name} on {t.device}, xq on {xq.device}")
    if xq.dtype != wq.dtype or xq.dtype not in _PAYLOAD_CODES:
        raise ValueError(f"quant_matmul kernel takes int8 or float8_e4m3fn "
                         f"operands of one type, got {xq.dtype} @ {wq.dtype}")
    if sw.dtype != torch.float32:
        raise ValueError(f"quant_matmul: sw must be float32, got {sw.dtype}")
    if not xq.is_contiguous():
        raise ValueError(f"quant_matmul: xq must be row-major, strides {xq.stride()}")
    if wq.stride(0) != 1 or (n > 1 and wq.stride(1) != k):
        raise ValueError(f"quant_matmul: wq must be column-major ([N, K] memory, "
                         f"K contiguous), strides {wq.stride()}")
    if not sw.is_contiguous():
        raise ValueError("quant_matmul: sw must be contiguous")
    if m == 0 or n == 0 or k == 0:
        raise ValueError(f"quant_matmul: empty product [{m}, {k}] @ [{k}, {n}]")
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    rc = _KERNEL.lib.quant_matmul_8bit(
        xq.data_ptr(), wq.data_ptr(), sw.data_ptr(), out.data_ptr(), m, n, k,
        _PAYLOAD_CODES[xq.dtype],
        torch.cuda.current_stream(xq.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: cudaError {rc}")
    quant_matmul.launches += 1
    return out


quant_matmul.launches = 0
