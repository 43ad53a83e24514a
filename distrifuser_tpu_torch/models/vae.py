"""AutoencoderKL (the SD/SDXL VAE) in PyTorch: decoder and encoder, whole
or sequence-parallel.

Counterpart of distrifuser_tpu/models/vae.py.  One topology serves both
modes, as in the JAX package: ``decode`` and ``encode`` are ``decode_sp``
and ``encode_sp`` at n == 1, where every sequence-parallel helper is its
dense op, so the single-head mid-block attention goes through ``sdpa`` and
the flash kernel (d = 512).  At n > 1 the latent (or image) is a row patch
of a process group of n ranks and nothing is stale:

* ``_conv_sp``: a 3x3 conv with fresh halos, exchanged synchronously with
  the neighbours (``collectives.halo_exchange``: zeros at the image
  border), then a conv that pads only the width; a 1x1 conv stays local;
* ``_group_norm_sp``: the float32 moments averaged over the group and the
  biased variance, clamped at 0 (torch nn.GroupNorm semantics: no Bessel
  factor, unlike the UNet's ``patch_group_norm``);
* ``_vae_attention``: the exact ring (ops/ring_attention.py
  ``ring_pass``) over the fused [B, L/n, 2 * 512] KV: one log-sum-exp flash
  launch at the whole local Lq a chunk, n a layer, no query chunking (the
  kernel holds no logits);
* ``_downsample``: diffusers' pad-then-stride-2 downsample, its one-row
  halo from the next rank (the last rank's is the zero pad).

``decode(..., tile=N)`` is the row-tiled decode (``_decode_tiled``):
latent row tiles of one shape, linearly blended over their overlap, which
bounds the mid attention to a tile.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.attention import sdpa
from ..ops.conv import conv2d
from ..ops.linear import linear
from ..ops.normalization import _affine, _local_moments, group_norm
from ..ops.ring_attention import ring_pass
from ..parallel.collectives import halo_exchange, psum_mean
from .unet import cast_params, load_config_source, upsample_nearest_2x

silu = F.silu


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    """The VAE's topology and latent scaling.  ``use_quant_conv`` and
    ``use_post_quant_conv`` (diffusers' config.json keys, true unless a
    config says otherwise) say whether the encoder's 1x1 moment conv and the
    decoder's 1x1 input conv exist; SD3's published VAE has neither.  They
    are instance attributes, not dataclass fields, so that a config still
    compares field for field with the JAX package's, which has none
    (``with_quant_convs`` sets them; ``dataclasses.replace`` drops them)."""

    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.13025  # SDXL; SD 1.x uses 0.18215
    shift_factor: float = 0.0
    use_quant_conv = True  # not fields: the class docstring
    use_post_quant_conv = True


def with_quant_convs(cfg: VAEConfig, use_quant_conv: bool = True,
                     use_post_quant_conv: bool = True) -> VAEConfig:
    """``cfg`` with or without the encoder's ``quant_conv`` and the
    decoder's ``post_quant_conv``."""
    out = dataclasses.replace(cfg)
    object.__setattr__(out, "use_quant_conv", bool(use_quant_conv))
    object.__setattr__(out, "use_post_quant_conv", bool(use_post_quant_conv))
    return out


def sdxl_vae_config() -> VAEConfig:
    return VAEConfig()


def sd_vae_config() -> VAEConfig:
    """The SD 1.x / 2.x VAE: SDXL's topology, latent scaling 0.18215."""
    return VAEConfig(scaling_factor=0.18215)


def sd3_vae_config() -> VAEConfig:
    """The SD3 VAE (stabilityai/stable-diffusion-3-medium's vae/config.json):
    SDXL's topology with a 16-channel latent, scaling 1.5305 and the latent
    shift 0.0609 that the SD3 pipeline adds back at decode."""
    return VAEConfig(latent_channels=16, scaling_factor=1.5305, shift_factor=0.0609)


def vae_config_from_json(source) -> VAEConfig:
    """A VAEConfig from a diffusers `vae/config.json` (path or dict), with
    the snapshot's own scaling factor (0.18215 SD, 0.13025 SDXL), channel
    layout and quant convs (``use_quant_conv`` / ``use_post_quant_conv``,
    default true)."""
    cfg = load_config_source(source)
    return with_quant_convs(VAEConfig(
        in_channels=cfg.get("in_channels", 3),
        out_channels=cfg.get("out_channels", 3),
        latent_channels=cfg.get("latent_channels", 4),
        block_out_channels=tuple(cfg.get("block_out_channels", (128, 256, 512, 512))),
        layers_per_block=cfg.get("layers_per_block", 2),
        norm_num_groups=cfg.get("norm_num_groups", 32),
        scaling_factor=cfg.get("scaling_factor", 0.18215),
        shift_factor=cfg.get("shift_factor") or 0.0,
    ), cfg.get("use_quant_conv", True), cfg.get("use_post_quant_conv", True))


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                     norm_num_groups=8, scaling_factor=0.18215)


def _conv_sp(p, x, n: int, group):
    """A conv on the row patch x [B, h/n, W, C] with fresh halos: exactly
    the whole-image conv's rows of this patch.  A 1x1 conv stays local."""
    kh, kw = p["kernel"].shape[2:]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    if ph == 0 or n == 1:
        return conv2d(p, x)
    top, bottom = halo_exchange(x, ph, group)
    return conv2d(p, torch.cat([top, x, bottom], dim=1), padding=(0, pw))


def _group_norm_sp(p, x, n: int, group, *, groups: int, eps: float):
    """Exact GroupNorm of a row patch: float32 moments averaged over the
    group (equal patches), biased variance clamped at 0 (E[x^2] - E[x]^2
    can go slightly negative by cancellation)."""
    if n == 1:
        return group_norm(p, x, groups=groups, eps=eps)
    b, h, w, c = x.shape
    m = psum_mean(_local_moments(x, groups), group)  # [2, B, G]
    mean, var = m[0], (m[1] - m[0].square()).clamp_min(0.0)
    xg = x.reshape(b, h * w, groups, c // groups).float()
    y = (xg - mean[:, None, :, None]) * torch.rsqrt(var[:, None, :, None] + eps)
    return _affine(p, y.reshape(b, h, w, c).to(x.dtype))


def _vae_resnet(p, x, n: int, group, groups: int):
    h = _conv_sp(p["conv1"], silu(_group_norm_sp(p["norm1"], x, n, group, groups=groups,
                                                 eps=1e-6)), n, group)
    h = _conv_sp(p["conv2"], silu(_group_norm_sp(p["norm2"], h, n, group, groups=groups,
                                                 eps=1e-6)), n, group)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x)  # 1x1: local
    return x + h


def _vae_attention(p, x, n: int, group, groups: int):
    """The mid-block attention over every token of the image: dense at
    n == 1, else the exact ring over the group's row patches."""
    b, h, w, c = x.shape
    hs = _group_norm_sp(p["group_norm"], x, n, group, groups=groups,
                        eps=1e-6).reshape(b, h * w, c)
    q = linear(p["to_q"], hs)
    if n == 1:
        out = sdpa(q, linear(p["to_k"], hs), linear(p["to_v"], hs), heads=1)
    else:
        kv = torch.cat([linear(p["to_k"], hs), linear(p["to_v"], hs)], dim=-1)
        out = ring_pass(q, kv, kv, n, group, heads=1).to(x.dtype)
    return x + linear(p["to_out"], out).reshape(b, h, w, c)


def decode_sp(params, cfg: VAEConfig, latents, n: int, group=None):
    """Sequence-parallel decode: this rank's latent rows [B, h/n, w, 4]
    (already divided by scaling_factor; rank i of ``group`` holds the i-th
    row patch) -> its pixel rows [B, 8h/n, 8w, 3] in [-1, 1].  Exact: the
    patches gathered in group order (``collectives.gather_rows``) are the
    whole decode.  Without ``post_quant_conv`` (the config's flag) the
    latent goes to ``conv_in`` as it is."""
    p = params["decoder"]
    groups = cfg.norm_num_groups
    if cfg.use_post_quant_conv:
        x = conv2d(params["post_quant_conv"],
                   latents.to(params["post_quant_conv"]["kernel"].dtype))
    else:
        x = latents.to(p["conv_in"]["kernel"].dtype)
    x = _conv_sp(p["conv_in"], x, n, group)
    x = _vae_resnet(p["mid_block"]["resnets"][0], x, n, group, groups)
    x = _vae_attention(p["mid_block"]["attentions"][0], x, n, group, groups)
    x = _vae_resnet(p["mid_block"]["resnets"][1], x, n, group, groups)
    for up in p["up_blocks"]:
        for rp in up["resnets"]:
            x = _vae_resnet(rp, x, n, group, groups)
        if "upsamplers" in up:  # local rows
            x = _conv_sp(up["upsamplers"][0]["conv"], upsample_nearest_2x(x), n, group)
    x = silu(_group_norm_sp(p["conv_norm_out"], x, n, group, groups=groups, eps=1e-6))
    return _conv_sp(p["conv_out"], x, n, group)


def decode(params, cfg: VAEConfig, latents, *, tile: int = 0):
    """Latent [B, h, w, 4] (already divided by scaling_factor) -> image
    [B, 8h, 8w, 3] in [-1, 1].  ``tile``: latent rows per tile (0: the
    whole latent at once)."""
    if tile and latents.shape[1] > tile:
        return _decode_tiled(params, cfg, latents, tile)
    return decode_sp(params, cfg, latents, 1)


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


def _downsample(p, x, n: int = 1, group=None):
    """diffusers' VAE downsample on a row patch: one zero column at the
    right and one row below (the next rank's top row; zeros on the last
    rank), then a 3x3 stride-2 conv without padding (not a symmetric
    ``padding=1``).  A patch's rows are even, so no output window reaches
    further than that one row."""
    if n == 1:
        x = F.pad(x, (0, 0, 0, 1, 0, 1))
    else:
        _, below = halo_exchange(x, 1, group)
        x = F.pad(torch.cat([x, below], dim=1), (0, 0, 0, 1))
    return conv2d(p["conv"], x, stride=2, padding=0)


def _rank_generator(generator: torch.Generator, rank: int) -> torch.Generator:
    """A generator of its own for ``rank``, seeded from one draw of
    ``generator`` (every rank draws the same) mixed with the rank: the
    counterpart of ``jax.random.fold_in(rng, axis_index)``."""
    base = torch.randint(0, 1 << 62, (1,), generator=generator,
                         device=generator.device).item()
    gen = torch.Generator(device=generator.device)
    return gen.manual_seed((base * 1000003 + rank) % (1 << 63))


def encode_sp(params, cfg: VAEConfig, images, n: int, group=None, *, generator=None):
    """Sequence-parallel encode: this rank's image rows [B, H/n, W, 3] in
    [-1, 1] -> its latent rows [B, H/(8n), W/8, 4] (multiply by
    scaling_factor for the diffusion space).  Without ``generator`` the
    mean of the posterior, exactly the whole encode's rows; with it (a
    ``torch.Generator`` on the images' device, in the same state on every
    rank) mean + std * noise, each rank drawing from a generator of its own
    (``_rank_generator``) at n > 1: statistically equivalent to the whole
    encode's sample, not the same draw.  Local rows must stay even at every
    downsample (H divisible by 8n).  Without ``quant_conv`` (the config's
    flag) the moments are ``conv_out``'s output."""
    p = params["encoder"]
    groups = cfg.norm_num_groups
    n_down = sum(1 for d in p["down_blocks"] if "downsamplers" in d)
    if images.shape[1] % (1 << n_down):
        raise ValueError(f"local rows {images.shape[1]} not divisible by 2^{n_down}: an "
                         f"{n}-way encode needs an image height divisible by {n << n_down}")
    if generator is not None and n > 1:
        generator = _rank_generator(generator, dist.get_rank(group))
    x = _conv_sp(p["conv_in"], images.to(p["conv_in"]["kernel"].dtype), n, group)
    for down in p["down_blocks"]:
        for rp in down["resnets"]:
            x = _vae_resnet(rp, x, n, group, groups)
        if "downsamplers" in down:
            x = _downsample(down["downsamplers"][0], x, n, group)
    x = _vae_resnet(p["mid_block"]["resnets"][0], x, n, group, groups)
    x = _vae_attention(p["mid_block"]["attentions"][0], x, n, group, groups)
    x = _vae_resnet(p["mid_block"]["resnets"][1], x, n, group, groups)
    x = silu(_group_norm_sp(p["conv_norm_out"], x, n, group, groups=groups, eps=1e-6))
    x = _conv_sp(p["conv_out"], x, n, group)
    if cfg.use_quant_conv:
        x = conv2d(params["quant_conv"], x)  # 1x1: local
    mean, logvar = x.chunk(2, dim=-1)
    if generator is None:
        return mean
    std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
    noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                        dtype=mean.dtype)
    return mean + std * noise


def encode(params, cfg: VAEConfig, images, *, generator=None):
    """Image [B, H, W, 3] in [-1, 1] -> latent [B, H/8, W/8, 4] (multiply
    by scaling_factor for the diffusion space): the mean of the posterior,
    or with ``generator`` (a ``torch.Generator`` on the images' device) a
    sample mean + std * noise."""
    return encode_sp(params, cfg, images, 1, generator=generator)


def init_vae_params(gen: torch.Generator, cfg: VAEConfig, dtype=torch.float32):
    """Random VAE tree on ``gen``'s device, structured like the JAX
    init_vae_params tree: decoder and post_quant_conv (drawn first),
    encoder and quant_conv; a conv the config's flags leave out is not
    drawn."""
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
    params = {"decoder": decoder}
    if cfg.use_post_quant_conv:
        params["post_quant_conv"] = conv(1, 1, cfg.latent_channels, cfg.latent_channels)
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
    if cfg.use_quant_conv:
        params["quant_conv"] = conv(1, 1, 2 * cfg.latent_channels, 2 * cfg.latent_channels)
    return cast_params(params, dtype)
