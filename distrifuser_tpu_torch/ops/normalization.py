"""GroupNorm: dense, and the six-mode distributed variant.

Counterpart of distrifuser_tpu/ops/normalization.py (``group_norm``,
``_local_moments``, ``_normalize``, ``patch_group_norm``).  Dense GroupNorm
has torch nn.GroupNorm semantics (biased variance).  Moments accumulate in
float32 whatever the activation dtype, as in the JAX package; the
normalized value is rounded to the activation dtype before the affine.

On a row patch the group statistics need the other ranks' moments.  The six
sync modes of the reference are reproduced with its quirks, on purpose,
because the paper's quality numbers depend on them:

* the distributed paths apply the Bessel factor ``ne/(ne-1)`` with the
  *local* element count, where dense GroupNorm uses the biased variance;
  so ``full_sync`` at n ranks is not equal to one device;
* ``corrected_async_gn`` adds the freshness correction ``local_fresh -
  local_stale`` without dividing it by n, and falls back to the local
  variance wherever the corrected variance goes negative.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import psum_mean
from ..parallel.context import PatchContext


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


def _local_moments(x, groups: int):
    """Per-group local E[x], E[x^2]: float32 [2, B, G]."""
    b, h, w, c = x.shape
    xg = x.reshape(b, h * w, groups, c // groups).float()
    return torch.stack([xg.mean(dim=(1, 3)), xg.square().mean(dim=(1, 3))])


def _normalize(p, x, full_mean, var, *, groups: int, eps: float, bessel_ne: int):
    """Shared tail: Bessel factor, rsqrt, affine."""
    b, h, w, c = x.shape
    var = var * (bessel_ne / (bessel_ne - 1))
    std_inv = torch.rsqrt(var + eps)  # [B, G]
    xg = x.reshape(b, h * w, groups, c // groups).float()
    y = (xg - full_mean[:, None, :, None]) * std_inv[:, None, :, None]
    return _affine(p, y.reshape(b, h, w, c).to(x.dtype))


def patch_group_norm(p, x, ctx: PatchContext, name: str, *, groups: int,
                     eps: float = 1e-5):
    """Distributed GroupNorm on a row patch [B, h_local, W, C]."""
    if ctx.n == 1:
        return group_norm(p, x, groups=groups, eps=eps)
    b, h, w, c = x.shape
    ne = (c // groups) * h * w  # local element count: the reference's Bessel basis

    if ctx.mode in ("stale_gn", "corrected_async_gn"):
        m = _local_moments(x, groups)  # [2, B, G]
        if ctx.is_sync:
            gathered = ctx.emit_sync_gather(name, m, "gn")  # [n, 2, B, G]
            full = gathered.mean(dim=0)
        else:
            gathered = ctx.stale(name)
            own_stale = gathered[ctx.split_idx]
            if ctx.mode == "corrected_async_gn":
                # stale global mean plus the un-normalized freshness correction
                full = gathered.mean(dim=0) + (m - own_stale)
            else:  # stale_gn: stale peers, fresh self
                full = (gathered.sum(dim=0) - own_stale + m) / ctx.n
            ctx.emit_refresh_gather(name, m, "gn")
        var = full[1] - full[0].square()
        if ctx.mode == "corrected_async_gn":
            local_var = m[1] - m[0].square()
            var = torch.where(var < 0, local_var, var)
        return _normalize(p, x, full[0], var, groups=groups, eps=eps, bessel_ne=ne)

    if ctx.is_sync or ctx.mode == "sync_gn":
        # blocking all-reduce of the moments every step; also the warmup of
        # separate_gn and no_sync
        full = psum_mean(_local_moments(x, groups), ctx.group)
        var = full[1] - full[0].square()
        return _normalize(p, x, full[0], var, groups=groups, eps=eps, bessel_ne=ne)

    # separate_gn / no_sync steady state: local GroupNorm, no Bessel factor
    return group_norm(p, x, groups=groups, eps=eps)
