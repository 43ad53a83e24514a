"""AutoencoderKL (the SD/SDXL VAE) in PyTorch: decoder and encoder.

Counterpart of distrifuser_tpu/models/vae.py.  ``decode`` and ``encode``
are the JAX package's ``decode_sp`` and ``encode_sp`` at n == 1, where
every sequence-parallel helper (``_conv_sp``, ``_group_norm_sp``,
``_vae_attention_sp``, ``_downsample_sp``) is its dense op: the
single-head mid-block attention of either half goes through ``sdpa`` and
so through the flash kernel (d = 512).  ``decode(..., tile=N)`` is the
row-tiled decode (``_decode_tiled``): latent row tiles of one shape,
linearly blended over their overlap, which bounds the mid attention to a
tile (one image decodes above 1024 px as the JAX package decodes it on one
device).  The n > 1 ring (``decode_sp``, ``encode_sp``) is ROADMAP queue 1
item 15.
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
from .unet import cast_params, load_config_source, upsample_nearest_2x

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


def sd_vae_config() -> VAEConfig:
    """The SD 1.x / 2.x VAE: SDXL's topology, latent scaling 0.18215."""
    return VAEConfig(scaling_factor=0.18215)


def vae_config_from_json(source) -> VAEConfig:
    """A VAEConfig from a diffusers `vae/config.json` (path or dict), with
    the snapshot's own scaling factor (0.18215 SD, 0.13025 SDXL) and
    channel layout."""
    cfg = load_config_source(source)
    return VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
        shift_factor=cfg.get("shift_factor") or 0.0,
    )


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


def decode(params, cfg: VAEConfig, latents, *, tile: int = 0):
    """Latent [B, h, w, 4] (already divided by scaling_factor) -> image
    [B, 8h, 8w, 3] in [-1, 1].  ``tile``: latent rows per tile (0: the
    whole latent at once)."""
    if tile and latents.shape[1] > tile:
        return _decode_tiled(params, cfg, latents, tile)
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


def _decode_tiled(params, cfg: VAEConfig, latents, tile: int, overlap: int = 8):
    """Row-tiled decode: tiles of ``tile`` latent rows, each overlapping
    the one before by ``min(overlap, tile // 2)`` rows, decoded whole and
    blended linearly over the shared pixel rows (the diffusers
    ``enable_tiling`` analog).  Every tile has one shape, the last one
    aligned to the bottom edge."""
    h = latents.shape[1]
    scale = 1 << (len(cfg.block_out_channels) - 1)  # latent row -> pixel rows
    overlap = min(overlap, tile // 2)
    stride = tile - overlap
    starts = list(range(0, h - tile, stride)) + [h - tile]
    pieces = [decode(params, cfg, latents[:, s:s + tile]) for s in starts]
    rows = []
    for i, s in enumerate(starts):
        piece = pieces[i]
        if i > 0:
            ov = (starts[i - 1] + tile - s) * scale  # pixel rows shared with the last tile
            blend = torch.linspace(0.0, 1.0, ov, device=piece.device)[None, :, None, None]
            piece = piece.clone()
            piece[:, :ov] = pieces[i - 1][:, -ov:] * (1 - blend) + piece[:, :ov] * blend
        keep = (starts[i + 1] - s) * scale if i + 1 < len(starts) else tile * scale
        rows.append(piece[:, :keep])
    return torch.cat(rows, dim=1)


def _downsample(p, x):
    """diffusers' VAE downsample: pad one zero row at the bottom and one
    zero column at the right, then a 3x3 stride-2 conv without padding
    (not a symmetric ``padding=1``)."""
    return conv2d(p["conv"], F.pad(x, (0, 0, 0, 1, 0, 1)), stride=2, padding=0)


def encode(params, cfg: VAEConfig, images, *, generator=None):
    """Image [B, H, W, 3] in [-1, 1] -> latent [B, H/8, W/8, 4] (multiply
    by scaling_factor for the diffusion space): the mean of the posterior,
    or with ``generator`` (a ``torch.Generator`` on the images' device) a
    sample mean + std * noise."""
    p = params["encoder"]
    groups = cfg.norm_num_groups
    x = conv2d(p["conv_in"], images.to(p["conv_in"]["kernel"].dtype))
    for down in p["down_blocks"]:
        for rp in down["resnets"]:
            x = _vae_resnet(rp, x, groups)
        if "downsamplers" in down:
            x = _downsample(down["downsamplers"][0], x)
    x = _vae_resnet(p["mid_block"]["resnets"][0], x, groups)
    x = _vae_attention(p["mid_block"]["attentions"][0], x, groups)
    x = _vae_resnet(p["mid_block"]["resnets"][1], x, groups)
    x = silu(group_norm(p["conv_norm_out"], x, groups=groups, eps=1e-6))
    x = conv2d(p["conv_out"], x)
    mean, logvar = conv2d(params["quant_conv"], x).chunk(2, dim=-1)
    if generator is None:
        return mean
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                        dtype=mean.dtype)
    return mean + std * noise


def init_vae_params(gen: torch.Generator, cfg: VAEConfig, dtype=torch.float32):
    """Random VAE tree on ``gen``'s device, structured like the JAX
    init_vae_params tree: decoder and post_quant_conv (drawn first),
    encoder and quant_conv."""
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

    def mid(c):
        return {"resnets": [resnet(c, c), resnet(c, c)],
                "attentions": [{"group_norm": norm(c), "to_q": lin(c), "to_k": lin(c),
                                "to_v": lin(c), "to_out": lin(c)}]}

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
        "mid_block": mid(top),
        "up_blocks": up_blocks,
        "conv_norm_out": norm(rev[-1]),
        "conv_out": conv(3, 3, rev[-1], cfg.out_channels),
    }
    params = {
        "decoder": decoder,
        "post_quant_conv": conv(1, 1, cfg.latent_channels, cfg.latent_channels),
    }
    # encoder: channels ascending, a downsample after every block but the last
    chs = cfg.block_out_channels
    down_blocks, c_prev = [], chs[0]
    for i, c in enumerate(chs):
        block = {"resnets": [resnet(c_prev if j == 0 else c, c)
                             for j in range(cfg.layers_per_block)]}
        if i < len(chs) - 1:
            block["downsamplers"] = [{"conv": conv(3, 3, c, c)}]
        down_blocks.append(block)
        c_prev = c
    params["encoder"] = {
        "conv_in": conv(3, 3, cfg.in_channels, chs[0]),
        "down_blocks": down_blocks,
        "mid_block": mid(chs[-1]),
        "conv_norm_out": norm(chs[-1]),
        "conv_out": conv(3, 3, chs[-1], 2 * cfg.latent_channels),
    }
    params["quant_conv"] = conv(1, 1, 2 * cfg.latent_channels, 2 * cfg.latent_channels)
    return cast_params(params, dtype)
