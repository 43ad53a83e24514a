"""Dense NHWC convolution.

Counterpart of distrifuser_tpu/ops/conv.py:conv2d.  Activations stay NHWC
at the public surface, as in the JAX package; the kernel is held OIHW in
``channels_last`` memory format (models/weights.py), so the NHWC tensor's
NCHW view is already channels_last and cuDNN runs without a layout copy.
A weight-quantized kernel is densified at the call (``asdense``), as the
JAX package densifies it for its XLA conv: convolutions stay cuDNN under
every ``weight_quant`` mode.  The patch-parallel variants
(``sliced_conv2d``, ``patch_conv2d``) are ROADMAP queue 1 item 7.
"""

from __future__ import annotations

import torch.nn.functional as F

from ..parallel.compress import asdense


def conv2d(p, x, *, stride: int = 1, padding=None):
    """Dense NHWC conv; ``padding`` defaults to (k-1)//2 ("same" for odd k)."""
    kh, kw = p["kernel"].shape[2:]
    if padding is None:
        padding = ((kh - 1) // 2, (kw - 1) // 2)
    elif isinstance(padding, int):
        padding = (padding, padding)
    y = F.conv2d(x.permute(0, 3, 1, 2), asdense(p["kernel"]), p.get("bias"),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)
