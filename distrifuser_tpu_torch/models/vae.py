"""AutoencoderKL decoder (the SD/SDXL VAE) in PyTorch.

Counterpart of distrifuser_tpu/models/vae.py.  ``decode`` is the JAX
package's ``decode_sp`` at n == 1, where every sequence-parallel helper
(``_conv_sp``, ``_group_norm_sp``, ``_vae_attention_sp``) is its dense op:
the single-head mid-block attention goes through ``sdpa`` and so through
the flash kernel (d = 512).  The row-tiled decode, the n > 1 ring and the
encoder are ROADMAP queue 1 items 5 and 15.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.attention import sdpa
from ..ops.conv import conv2d
from ..ops.linear import linear
from ..ops.normalization import group_norm
from .unet import cast_params, upsample_nearest_2x

silu = F.silu


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.13025  # SDXL; SD 1.x uses 0.18215
    shift_factor: float = 0.0


def sdxl_vae_config() -> VAEConfig:
    return VAEConfig()


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                     norm_num_groups=8, scaling_factor=0.18215)


def _vae_resnet(p, x, groups):
    h = conv2d(p["conv1"], silu(group_norm(p["norm1"], x, groups=groups, eps=1e-6)))
    h = conv2d(p["conv2"], silu(group_norm(p["norm2"], h, groups=groups, eps=1e-6)))
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x)
    return x + h


def _vae_attention(p, x, groups):
    b, h, w, c = x.shape
    hs = group_norm(p["group_norm"], x, groups=groups, eps=1e-6).reshape(b, h * w, c)
    q = linear(p["to_q"], hs)
    k = linear(p["to_k"], hs)
    v = linear(p["to_v"], hs)
    out = sdpa(q, k, v, heads=1)
    return x + linear(p["to_out"], out).reshape(b, h, w, c)


def decode(params, cfg: VAEConfig, latents):
    """Latent [B, h, w, 4] (already divided by scaling_factor) -> image
    [B, 8h, 8w, 3] in [-1, 1]."""
    p = params["decoder"]
    groups = cfg.norm_num_groups
    x = conv2d(params["post_quant_conv"],
               latents.to(params["post_quant_conv"]["kernel"].dtype))
    x = conv2d(p["conv_in"], x)
    x = _vae_resnet(p["mid_block"]["resnets"][0], x, groups)
    x = _vae_attention(p["mid_block"]["attentions"][0], x, groups)
    x = _vae_resnet(p["mid_block"]["resnets"][1], x, groups)
    for up in p["up_blocks"]:
        for rp in up["resnets"]:
            x = _vae_resnet(rp, x, groups)
        if "upsamplers" in up:
            x = conv2d(up["upsamplers"][0]["conv"], upsample_nearest_2x(x))
    x = silu(group_norm(p["conv_norm_out"], x, groups=groups, eps=1e-6))
    return conv2d(p["conv_out"], x)


def init_vae_params(gen: torch.Generator, cfg: VAEConfig, dtype=torch.float32):
    """Random decoder tree (plus post_quant_conv) on ``gen``'s device,
    structured like the decoder half of the JAX init_vae_params tree."""
    dev = gen.device

    def conv(kh, kw, cin, cout):
        w = torch.randn((cout, cin, kh, kw), generator=gen, device=dev)
        return {"kernel": w / (cin * kh * kw) ** 0.5,
                "bias": torch.zeros(cout, device=dev)}

    def norm(c):
        return {"scale": torch.ones(c, device=dev), "bias": torch.zeros(c, device=dev)}

    def resnet(cin, cout):
        p = {"norm1": norm(cin), "conv1": conv(3, 3, cin, cout),
             "norm2": norm(cout), "conv2": conv(3, 3, cout, cout)}
        if cin != cout:
            p["conv_shortcut"] = conv(1, 1, cin, cout)
        return p

    def lin(c):
        return {"kernel": torch.randn((c, c), generator=gen, device=dev) / c**0.5,
                "bias": torch.zeros(c, device=dev)}

    rev = list(reversed(cfg.block_out_channels))
    top = rev[0]
    up_blocks = []
    c_prev = top
    for i, c in enumerate(rev):
        block = {"resnets": [resnet(c_prev if j == 0 else c, c)
                             for j in range(cfg.layers_per_block + 1)]}
        if i < len(rev) - 1:
            block["upsamplers"] = [{"conv": conv(3, 3, c, c)}]
        up_blocks.append(block)
        c_prev = c
    decoder = {
        "conv_in": conv(3, 3, cfg.latent_channels, top),
        "mid_block": {
            "resnets": [resnet(top, top), resnet(top, top)],
            "attentions": [{"group_norm": norm(top), "to_q": lin(top),
                            "to_k": lin(top), "to_v": lin(top), "to_out": lin(top)}],
        },
        "up_blocks": up_blocks,
        "conv_norm_out": norm(rev[-1]),
        "conv_out": conv(3, 3, rev[-1], cfg.out_channels),
    }
    params = {
        "decoder": decoder,
        "post_quant_conv": conv(1, 1, cfg.latent_channels, cfg.latent_channels),
    }
    return cast_params(params, dtype)
