"""Quantized matmul: the hand-written Hopper kernel, its wrapper and its
plain version.

Counterpart of distrifuser_tpu/ops/quant_matmul.py (``_qmm_kernel``
launched by ``quant_matmul``), the ``"pallas"`` route of
ops/gemm_routing.py.  The kernel is CUDA C++ for sm_90a in
``csrc/quant_matmul.cu`` (TMA tile ring, s8 and e4m3 ``wgmma``); its
header comment gives the design and what bounds it.  It is built with
``nvcc`` at first use into ``build/kernels/`` and bound through a plain C
entry point loaded with ``ctypes`` (ops/_build.py).

Contract, as in the JAX package:

* ``xq`` [M, K]: the activation, quantized per token to the weight's
  payload type (int8 or float8_e4m3fn);
* ``wq`` [K, N]: the ``QuantizedTensor`` payload, same type;
* ``sw`` [N] float32: per-output-channel weight scales, channel_tile
  already expanded (``QuantizedTensor.channel_scale``);
* returns [M, N] float32 ``(xq @ wq) * sw``.

The fused form that ops/linear.py uses also takes ``sx`` [M] float32, the
per-token activation scale, an ``out_dtype`` (float32 or bfloat16 on the
card) and an optional ``bias`` [N] of that dtype, and returns
``((xq @ wq) * sw * sx[:, None]).to(out_dtype) (+ bias)``: the caller's
scale, cast and bias applied in the kernel's epilogue, in the caller's
order.

Accumulation is int32 for int8 and float32 for fp8.  On a CUDA tensor the
wrapper launches the kernel or raises; on a CPU tensor it runs
``quant_matmul_reference``.  The kernel wants ``xq`` with unit column
stride and ``wq`` column-major (memory [N, K], torch's Linear layout,
which is how ``quantize_weight`` holds a linear payload).  The TPU tile
arguments (``block_m``/``block_n``/``block_k``) have no counterpart: the
kernel has one tile per payload type and a persistent grid, and the
tensor-memory accelerator zero-fills ragged M, N and K.  It needs 16-byte aligned bases and row
strides; an operand without them (K % 16 != 0, a shifted view) is handed
over as a zero-padded or re-allocated copy, the JAX wrapper's zero padding.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ._build import KernelLibrary, add_launches, counts_launches, current_stream

_PAYLOAD_CODES = {torch.int8: 0, torch.float8_e4m3fn: 1}
_OUT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib) -> None:
    fn = lib.quant_matmul_8bit
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    info = lib.quant_matmul_variant
    info.restype = ctypes.c_int
    info.argtypes = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 5


_KERNEL = KernelLibrary("quant_matmul.cu", _bind)


def build() -> str:
    """Compile and load ``csrc/quant_matmul.cu`` (ops/_build.py); returns
    the compiler's ptxas report, or "" when an earlier build was reused."""
    return _KERNEL.build()


def variant(mode: str) -> dict:
    """The kernel instance a product in ``mode`` runs on the card (one per
    payload type): registers per thread (as compiled), dynamic shared
    memory bytes and threads per block, output columns per block, ring
    stages."""
    keys = ("registers", "smem_bytes", "threads", "block_n", "stages")
    vals = [ctypes.c_int(0) for _ in keys]
    rc = _KERNEL.lib.quant_matmul_variant(int(mode == "fp8"),
                                          *(ctypes.byref(v) for v in vals))
    if rc != 0:
        raise RuntimeError(f"quant_matmul_variant failed: cudaError {rc}")
    return {k: v.value for k, v in zip(keys, vals)}


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


def quant_matmul_reference(xq, wq, sw, *, sx=None, out_dtype=torch.float32, bias=None):
    """Plain PyTorch ``(xq @ wq) * sw`` in float32, then ``* sx[:, None]``,
    the cast to ``out_dtype`` and ``+ bias`` where given.

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
    y = acc * sw.float()
    if sx is not None:
        y = y * sx[:, None]
    y = y.to(out_dtype)
    return y if bias is None else y + bias


def _padded(t, k):
    """A copy of ``t`` [rows, k] with unit column stride, zero-padded to
    the next multiple of 16 columns (both operands get the same padding, so
    the padded K reads zeros in both)."""
    kp = max(16, -(-k // 16) * 16)
    return F.pad(t.contiguous().view(torch.uint8), (0, kp - k)).view(t.dtype)


@counts_launches
def quant_matmul(xq, wq, sw, *, sx=None, out_dtype=torch.float32, bias=None):
    """(xq @ wq) * sw with 8-bit MACs, or with ``sx`` the fused form (module
    docstring): the kernel on the card, the plain version on the CPU.
    Counts each kernel launch in ``quant_matmul.launches``."""
    if not (xq.is_cuda or wq.is_cuda or sw.is_cuda):
        return quant_matmul_reference(xq, wq, sw, sx=sx, out_dtype=out_dtype, bias=bias)
    m, k, n = _check_shapes(xq, wq, sw)
    dev = xq.get_device()  # -1 on the CPU
    for name, t in (("xq", xq), ("wq", wq), ("sw", sw), ("sx", sx), ("bias", bias)):
        if t is not None and (t.get_device() != dev or dev < 0):
            raise ValueError(f"quant_matmul: {name} on {t.device}; the kernel takes "
                             f"CUDA tensors on one device (xq on {xq.device})")
    payload, out_code = _PAYLOAD_CODES.get(xq.dtype), _OUT_CODES.get(out_dtype)
    if payload is None or wq.dtype != xq.dtype:
        raise ValueError(f"quant_matmul kernel takes int8 or float8_e4m3fn "
                         f"operands of one type, got {xq.dtype} @ {wq.dtype}")
    if out_code is None:
        raise ValueError(f"quant_matmul kernel writes float32 or bfloat16, not {out_dtype}")
    if sw.dtype != torch.float32 or not sw.is_contiguous():
        raise ValueError(f"quant_matmul: sw must be contiguous float32, got {sw.dtype}")
    if sx is not None and (sx.dtype != torch.float32 or sx.shape != (m,)
                           or not sx.is_contiguous()):
        raise ValueError(f"quant_matmul: sx must be contiguous float32 [M={m}], got "
                         f"{sx.dtype} {tuple(sx.shape)}")
    if bias is not None and (bias.dtype != out_dtype or bias.shape != (n,)
                             or not bias.is_contiguous()):
        raise ValueError(f"quant_matmul: bias must be contiguous {out_dtype} [N={n}], "
                         f"got {bias.dtype} {tuple(bias.shape)}")
    if wq.stride(0) != 1:
        raise ValueError(f"quant_matmul: wq must be column-major ([N, K] memory, "
                         f"K contiguous), strides {wq.stride()}")
    if m == 0 or n == 0 or k == 0:
        raise ValueError(f"quant_matmul: empty product [{m}, {k}] @ [{k}, {n}]")
    # TMA wants 16-byte aligned bases and row strides: xq [M, K] row-major
    # and the payload's [N, K] memory as they are, else padded copies
    kp = k
    a_ptr, lda, b_ptr, ldb = xq.data_ptr(), xq.stride(0), wq.data_ptr(), wq.stride(1)
    if k % 16 or (a_ptr | lda) % 16 or xq.stride(1) != 1:
        a = _padded(xq, k)
        a_ptr, lda, kp = a.data_ptr(), a.stride(0), a.shape[1]
    if k % 16 or (b_ptr | ldb) % 16:
        b = _padded(wq.t(), k)
        b_ptr, ldb = b.data_ptr(), b.stride(0)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    rc = _KERNEL.lib.quant_matmul_8bit(
        a_ptr, lda, b_ptr, ldb, sw.data_ptr(), 0 if sx is None else sx.data_ptr(),
        0 if bias is None else bias.data_ptr(), out.data_ptr(), m, n, kp, payload,
        out_code, current_stream(dev),
    )
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: cudaError {rc}")
    add_launches(quant_matmul)
    return out
