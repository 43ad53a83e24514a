"""Dense and MLP primitives.

Counterpart of distrifuser_tpu/ops/linear.py (``linear``, ``geglu``,
``feed_forward``).  Params are ``{"kernel": [in, out], "bias": [out]?}``,
the JAX layout, so ``x @ kernel`` is the same product; the GEMM goes to
cuBLAS through ``torch.matmul`` (it was an XLA op in the reference).
Quantized kernels (``_quantized_matmul``) are ROADMAP queue 1 item 12.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def linear(p, x):
    y = torch.matmul(x, p["kernel"])
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
