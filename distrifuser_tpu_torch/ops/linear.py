"""Dense and MLP primitives, and the quantized-weight matmul.

Counterpart of distrifuser_tpu/ops/linear.py (``_quantized_matmul``,
``linear``, ``geglu``, ``feed_forward``).  Params are
``{"kernel": [in, out], "bias": [out]?}``, the JAX layout, so
``x @ kernel`` is the same product; a dense GEMM goes to cuBLAS through
``torch.matmul`` (it was an XLA op in the reference).

A ``QuantizedTensor`` kernel (DistriConfig.weight_quant) goes down the
route ops/gemm_routing.py picks: ``"dequant"`` densifies it; ``"dot"`` and
``"pallas"`` quantize the activation per token (one scale per row over the
last axis; on the card the kernel of ops/quantize.py), multiply 8-bit by
8-bit with int32 (int8) or float32 (fp8) accumulation, and apply the
scales after it: ``"dot"`` through a library GEMM, then ``acc * sx * sw``;
``"pallas"`` through the kernel of ops/quant_matmul.py in its fused form,
which applies ``sw``, then ``sx``, the cast and the bias in its epilogue.
The result is cast to the promoted type of the activation and the compute
dtype, as in JAX, and the bias is added to the cast result.  On the card
the "pallas" route is two launches (quantize, fused GEMM); on the CPU both
run their plain versions, the same operations in the same order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.compress import QuantizedTensor
from .gemm_routing import resolve
from .quant_matmul import quant_matmul
from .quantize import quantize_rows


def pad_rows_for_library(xq):
    """``xq`` zero-padded to the rows the library 8-bit GEMMs accept: more
    than 16 for ``torch._int_mm``, a multiple of 16 for
    ``torch._scaled_mm`` (padded as bytes; 0x00 is +0.0 in e4m3)."""
    m = xq.shape[0]
    pad = max(0, 17 - m) if xq.dtype == torch.int8 else -m % 16
    if not pad:
        return xq
    return F.pad(xq.view(torch.uint8), (0, 0, 0, pad)).view(xq.dtype)


def library_8bit_matmul(xq, wq):
    """float32 ``xq @ wq`` of 8-bit operands by a library GEMM: on the card
    ``torch._int_mm`` (int32 sums) or ``torch._scaled_mm`` (fp8, unit
    scales, float32 sums) on rows padded by ``pad_rows_for_library``; on
    the CPU the plain product, exact for int8 (float64 holds every partial
    sum)."""
    m = xq.shape[0]
    if xq.device.type == "cpu":
        if xq.dtype == torch.int8:
            return (xq.double() @ wq.double()).float()
        return xq.float() @ wq.float()
    xp = pad_rows_for_library(xq)
    if xq.dtype == torch.int8:
        return torch._int_mm(xp, wq)[:m].float()
    one = torch.ones((), dtype=torch.float32, device=xq.device)
    return torch._scaled_mm(xp, wq, scale_a=one, scale_b=one,
                            out_dtype=torch.float32)[:m]


def _quantized_matmul(x, qt: QuantizedTensor, bias=None):
    """x [..., K] @ QuantizedTensor [K, N] (+ bias) through the routed path."""
    out_dtype = torch.promote_types(x.dtype, qt.dtype)
    route = "dequant"
    if qt.ndim == 2:
        k, n = qt.shape
        m = x.numel() // k
        route = resolve(qt.mode, m, k, n, qt.compute, platform=x.device.type).impl
    if route == "dequant":
        y = torch.matmul(x.to(out_dtype), qt.dense().to(out_dtype))
        return y if bias is None else y + bias
    xq, sx = quantize_rows(x.reshape(m, k), qt.mode)
    sw = qt.channel_scale()
    if route == "pallas":
        y = quant_matmul(xq, qt.payload, sw, sx=sx, out_dtype=out_dtype, bias=bias)
    else:  # dot
        y = (library_8bit_matmul(xq, qt.payload) * sx[:, None] * sw).to(out_dtype)
        if bias is not None:
            y = y + bias
    return y.reshape(*x.shape[:-1], n)


def linear(p, x):
    kern = p["kernel"]
    if isinstance(kern, QuantizedTensor):
        return _quantized_matmul(x, kern, p.get("bias"))
    y = torch.matmul(x, kern)
    if "bias" in p:
        y = y + p["bias"]
    return y


def geglu(p, x):
    """diffusers GEGLU: hidden, gate = proj(x).chunk(2); hidden * gelu(gate),
    exact (erf) GeLU."""
    a, g = linear(p["proj"], x).chunk(2, dim=-1)
    return a * F.gelu(g, approximate="none")


def feed_forward(p, x):
    """diffusers FeedForward with GEGLU: net.0 = GEGLU, net.2 = Linear."""
    return linear(p["net_2"], geglu(p["net_0"], x))
