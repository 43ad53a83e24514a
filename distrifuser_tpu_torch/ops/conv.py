"""NHWC convolution: dense, and the two patch-parallel variants.

Counterpart of distrifuser_tpu/ops/conv.py (``conv2d``, ``sliced_conv2d``,
``patch_conv2d``; its ``_conv_valid_h`` is ``conv2d`` with height padding
0, the halo rows being in the input).  Activations stay NHWC at the public
surface, as in the JAX package; the kernel is held OIHW in
``channels_last`` memory format (models/weights.py), so the NHWC tensor's
NCHW view is already channels_last and cuDNN runs without a layout copy.
A weight-quantized kernel is densified at the call (``asdense``), as the
JAX package densifies it for its XLA conv: convolutions stay cuDNN under
every ``weight_quant`` mode.

* ``sliced_conv2d``, the first layer (``conv_in``): every rank holds the
  whole input and computes its own output rows from the zero-padded input.
* ``patch_conv2d``, the halo conv on a row patch: a k x k kernel needs
  (k-1)/2 rows of each spatial neighbour.  Synchronous steps exchange fresh
  halos; stale steps convolve with the previous step's halos and start the
  exchange of fresh ones for the next step.  1 x k kernels need no halo.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel.compress import asdense
from ..parallel.context import PatchContext


def conv2d(p, x, *, stride: int = 1, padding=None):
    """Dense NHWC conv; ``padding`` defaults to (k-1)//2 ("same" for odd k).

    On a card the images of a batch are convolved one at a time: at some
    shapes (SDXL's 640 -> 640 at 64x64 and 1280 -> 1280 at 32x32, B = 4, on
    an H100) cuDNN's convolution gives an image bits that depend on its
    position in the batch, though never on the other images.  One image a
    launch makes every row's result that of the image alone, so a batched
    call (the serve plane's coalesced requests) gives each image what a call
    of its own gives it."""
    kh, kw = p["kernel"].shape[2:]
    if padding is None:
        padding = ((kh - 1) // 2, (kw - 1) // 2)
    elif isinstance(padding, int):
        padding = (padding, padding)
    kernel, bias = asdense(p["kernel"]), p.get("bias")
    xs = x.permute(0, 3, 1, 2)
    if x.is_cuda and x.shape[0] > 1:
        y = torch.cat([F.conv2d(xi, kernel, bias, stride=stride, padding=padding)
                       for xi in xs.split(1)])
    else:
        y = F.conv2d(xs, kernel, bias, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def sliced_conv2d(p, x_full, ctx: PatchContext, *, stride: int = 1):
    """First-layer conv: the whole input [B, H, W, C], this rank's output
    rows only.  Output rows ``[idx*h_out, (idx+1)*h_out)`` need input rows
    ``[idx*h_out*stride - pad, (idx+1)*h_out*stride + pad)``; padding the
    whole input with zero rows first gives every rank a slice of one size
    and the image-border zeros."""
    kh, kw = p["kernel"].shape[2:]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    h = x_full.shape[1]
    if h % (stride * ctx.n):
        raise ValueError(f"input height {h} not divisible by stride*n = {stride * ctx.n}")
    out_h_local = h // stride // ctx.n
    xp = F.pad(x_full, (0, 0, 0, 0, ph, ph))
    start = ctx.split_idx * out_h_local * stride  # in padded rows
    rows = xp[:, start:start + out_h_local * stride + 2 * ph]
    return conv2d(p, rows, stride=stride, padding=(0, pw))


def patch_conv2d(p, x, ctx: PatchContext, name: str, *, stride: int = 1):
    """Halo conv on a row patch [B, h_local, W, C]."""
    kh, kw = p["kernel"].shape[2:]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    if ctx.n == 1 or ph == 0:
        return conv2d(p, x, stride=stride, padding=(ph, pw))
    if ctx.is_sync:
        top, bottom = ctx.emit_sync_halos(name, x, ph)
    else:
        halos = ctx.stale(name)  # [2, B, ph, W, C] of the previous step
        top, bottom = halos[0], halos[1]
        if ctx.refresh:
            ctx.emit_refresh_halos(name, x, ph)
    padded = torch.cat([top, x, bottom], dim=1)
    return conv2d(p, padded, stride=stride, padding=(0, pw))
