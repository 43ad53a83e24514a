"""Dense GroupNorm with float32 moments.

Counterpart of distrifuser_tpu/ops/normalization.py:group_norm (torch
nn.GroupNorm semantics: biased variance).  Moments accumulate in float32
whatever the activation dtype, as in the JAX package; the normalized value
is rounded to the activation dtype before the affine.  The six-mode
distributed GroupNorm (``patch_group_norm``) is ROADMAP queue 1 item 7.
"""

from __future__ import annotations

import torch


def _affine(p, y):
    if p is not None and "scale" in p:
        y = y * p["scale"]
        if "bias" in p:
            y = y + p["bias"]
    return y


def group_norm(p, x, *, groups: int, eps: float = 1e-5):
    """GroupNorm over an NHWC tensor."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h * w, groups, c // groups).float()
    mean = xg.mean(dim=(1, 3), keepdim=True)
    xc = xg - mean
    var = xc.square().mean(dim=(1, 3), keepdim=True)
    y = (xc * torch.rsqrt(var + eps)).reshape(b, h, w, c).to(x.dtype)
    return _affine(p, y)
