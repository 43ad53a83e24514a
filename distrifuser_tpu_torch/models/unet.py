"""Functional UNet2DConditionModel (SDXL / SD 1.x-2.x) in PyTorch.

Counterpart of distrifuser_tpu/models/unet.py.  The UNet is a function of a
parameter tree (nested dicts and lists of tensors, keyed like the JAX tree
and so like the diffusers state dict) routed through a dispatch object;
``DenseDispatch`` runs one device, ``PatchDispatch`` one rank of displaced
patch parallelism (row patches, halo convs, distributed GroupNorm,
stale-KV self-attention).  Activations are NHWC; attention runs on
[B, H*W, C] tokens.

Layouts inside the tree: linear kernels ``[in, out]`` as in JAX, conv
kernels ``[out, in, kh, kw]`` in channels_last memory format (the JAX tree
holds HWIO; models/weights.py transposes).  Any kernel may be a
``QuantizedTensor`` (DistriConfig.weight_quant): its ``dtype`` is the
compute dtype, and ops/linear.py and ops/conv.py consume it.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.attention import attention, cross_attention, patch_self_attention
from ..ops.conv import conv2d, patch_conv2d, sliced_conv2d
from ..ops.linear import feed_forward, linear
from ..ops.normalization import group_norm, patch_group_norm
from ..ops.ring_attention import ring_self_attention
from ..parallel.compress import QuantizedTensor
from ..parallel.context import PatchContext

silu = F.silu


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """Static architecture description (mirrors the diffusers UNet config)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280)
    down_block_types: Tuple[str, ...] = (
        "DownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "UpBlock2D",
    )
    layers_per_block: int = 2
    transformer_layers_per_block: Tuple[int, ...] = (1, 2, 10)
    num_attention_heads: Tuple[int, ...] = (5, 10, 20)
    cross_attention_dim: int = 2048
    norm_num_groups: int = 32
    use_linear_projection: bool = True
    addition_embed_type: Optional[str] = "text_time"  # SDXL; None for SD 1.x
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    flip_sin_to_cos: bool = True
    freq_shift: int = 0

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    def heads_for_block(self, i: int) -> int:
        return self.num_attention_heads[i]


def sdxl_config() -> UNetConfig:
    """SDXL-base UNet (stabilityai/stable-diffusion-xl-base-1.0)."""
    return UNetConfig()


_SD_DOWN_BLOCKS = ("CrossAttnDownBlock2D",) * 3 + ("DownBlock2D",)
_SD_UP_BLOCKS = ("UpBlock2D",) + ("CrossAttnUpBlock2D",) * 3


def sd15_config() -> UNetConfig:
    """SD 1.4/1.5 UNet (runwayml/stable-diffusion-v1-5 and compatible): 8
    heads at every level, so head dims 40, 80 and 160; conv projections
    in and out of each transformer."""
    return UNetConfig(
        block_out_channels=(320, 640, 1280, 1280),
        down_block_types=_SD_DOWN_BLOCKS,
        up_block_types=_SD_UP_BLOCKS,
        transformer_layers_per_block=(1, 1, 1, 1),
        num_attention_heads=(8, 8, 8, 8),
        cross_attention_dim=768,
        use_linear_projection=False,
        addition_embed_type=None,
        projection_class_embeddings_input_dim=0,
    )


def sd21_config() -> UNetConfig:
    """SD 2.0/2.1 UNet (stabilityai/stable-diffusion-2-1 and compatible):
    SD1.x block structure, OpenCLIP ViT-H conditioning (1024), uniform
    64-dim heads, linear transformer projections."""
    return UNetConfig(
        block_out_channels=(320, 640, 1280, 1280),
        down_block_types=_SD_DOWN_BLOCKS,
        up_block_types=_SD_UP_BLOCKS,
        transformer_layers_per_block=(1, 1, 1, 1),
        num_attention_heads=(5, 10, 20, 20),
        cross_attention_dim=1024,
        use_linear_projection=True,
        addition_embed_type=None,
        projection_class_embeddings_input_dim=0,
    )


_SUPPORTED_DOWN_BLOCKS = {"DownBlock2D", "CrossAttnDownBlock2D"}
_SUPPORTED_UP_BLOCKS = {"UpBlock2D", "CrossAttnUpBlock2D"}


def load_config_source(source) -> Dict[str, Any]:
    """A config source as a dict: a json file path (str/PathLike) or an
    already-parsed mapping.  Shared by the unet/clip/vae config loaders."""
    if isinstance(source, (str, bytes, os.PathLike)):
        with open(source) as f:
            return json.load(f)
    return dict(source)


def unet_config_from_json(source) -> UNetConfig:
    """A UNetConfig from a diffusers `unet/config.json` (path or dict), as
    diffusers' ``from_pretrained`` builds the architecture from that file:
    every SD-family snapshot (1.4/1.5, 2.0/2.1 base and v, SDXL-base) loads
    with its own architecture instead of a preset.

    Diffusers quirks reproduced here:
    * `attention_head_dim` in these configs historically means *number of
      heads* per block when `num_attention_heads` is absent (SD1.5's 8,
      SD2.1's [5,10,20,20], SDXL's [5,10,20]) — diffusers carries the same
      naming bug forward for backwards compatibility.
    * scalar fields broadcast over blocks (`transformer_layers_per_block: 1`).
    * flag fields appear as scalars or per-block lists; a list of falses
      (diffusers' re-saved form) means disabled, same as `false`.
    """
    cfg = load_config_source(source)

    def per_block(value, default):
        v = cfg.get(value, default)
        if isinstance(v, (list, tuple)):
            return tuple(v)
        return (v,) * len(blocks)

    blocks = tuple(cfg["block_out_channels"])
    down = tuple(cfg["down_block_types"])
    up = tuple(cfg["up_block_types"])
    unsupported = (set(down) - _SUPPORTED_DOWN_BLOCKS) | (
        set(up) - _SUPPORTED_UP_BLOCKS
    )

    def enabled(v):
        # scalar-or-per-block-list flag; [false, false, ...] means disabled
        return any(v) if isinstance(v, (list, tuple)) else bool(v)

    # key-present-with-null is valid diffusers and means "no mid block" —
    # unsupported here just like any nonstandard type
    mid = cfg["mid_block_type"] if "mid_block_type" in cfg else "UNetMidBlock2DCrossAttn"
    mid_bad = "null (no mid block)" if mid is None else mid
    for key, bad in (
        ("block types", unsupported),
        ("class_embed_type", cfg.get("class_embed_type")),
        ("encoder_hid_dim", cfg.get("encoder_hid_dim")),
        ("dual_cross_attention", enabled(cfg.get("dual_cross_attention"))),
        ("only_cross_attention", enabled(cfg.get("only_cross_attention"))),
        # LCM-distilled guidance embedding: weights would be silently dropped
        ("time_cond_proj_dim", cfg.get("time_cond_proj_dim")),
        ("class_embeddings_concat", cfg.get("class_embeddings_concat")),
        ("mid_block_type", None if mid == "UNetMidBlock2DCrossAttn" else mid_bad),
    ):
        if bad:
            raise NotImplementedError(
                f"unsupported UNet config: {key}={bad!r} (supported: the "
                "SD1.x/SD2.x/SDXL UNet2DConditionModel family)"
            )
    add_type = cfg.get("addition_embed_type")
    if add_type not in (None, "text_time"):
        raise NotImplementedError(
            f"unsupported addition_embed_type {add_type!r}"
        )
    # diffusers defaults attention_head_dim=8 (meaning 8 heads, see above)
    heads = cfg.get("num_attention_heads") or cfg.get("attention_head_dim", 8)
    if not isinstance(heads, (list, tuple)):
        heads = (heads,) * len(blocks)
    cross = cfg.get("cross_attention_dim", 1280)
    if isinstance(cross, (list, tuple)):
        uniq = set(cross)
        if len(uniq) != 1:
            raise NotImplementedError(
                f"per-block cross_attention_dim {cross!r} unsupported"
            )
        cross = cross[0]
    return UNetConfig(
        in_channels=cfg.get("in_channels", 4),
        out_channels=cfg.get("out_channels", 4),
        block_out_channels=blocks,
        down_block_types=down,
        up_block_types=up,
        layers_per_block=cfg.get("layers_per_block", 2),
        transformer_layers_per_block=per_block("transformer_layers_per_block", 1),
        num_attention_heads=tuple(heads),
        cross_attention_dim=cross,
        norm_num_groups=cfg.get("norm_num_groups", 32),
        use_linear_projection=cfg.get("use_linear_projection", False),
        addition_embed_type=add_type,
        addition_time_embed_dim=cfg.get("addition_time_embed_dim", 256) or 256,
        projection_class_embeddings_input_dim=cfg.get(
            "projection_class_embeddings_input_dim", 0
        )
        or 0,
        flip_sin_to_cos=cfg.get("flip_sin_to_cos", True),
        freq_shift=cfg.get("freq_shift", 0),
    )


def tiny_config(cross_attention_dim: int = 32, sdxl: bool = False) -> UNetConfig:
    """Small UNet with the full SDXL block structure, for tests."""
    return UNetConfig(
        block_out_channels=(32, 64),
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
        up_block_types=("CrossAttnUpBlock2D", "UpBlock2D"),
        layers_per_block=1,
        transformer_layers_per_block=(1, 1),
        num_attention_heads=(2, 4),
        cross_attention_dim=cross_attention_dim,
        norm_num_groups=8,
        use_linear_projection=True,
        addition_embed_type="text_time" if sdxl else None,
        addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=32 + 8 * 6 if sdxl else 0,
    )


def transformer_blocks_per_level(cfg: UNetConfig):
    """Transformer blocks at each resolution level (down, mid and up
    blocks together); level i runs at 1/2**i of the latent's height and
    width."""
    n = len(cfg.block_out_channels)
    blocks = [0] * n
    for i, btype in enumerate(cfg.down_block_types):
        if btype == "CrossAttnDownBlock2D":
            blocks[i] += cfg.layers_per_block * cfg.transformer_layers_per_block[i]
    blocks[n - 1] += cfg.transformer_layers_per_block[-1]  # mid block
    for i, btype in enumerate(cfg.up_block_types):
        if btype == "CrossAttnUpBlock2D":
            blocks[n - 1 - i] += ((cfg.layers_per_block + 1)
                                  * cfg.transformer_layers_per_block[n - 1 - i])
    return blocks


def attention_calls_per_forward(cfg: UNetConfig) -> int:
    """sdpa calls in one UNet evaluation: a self- and a cross-attention for
    every transformer block."""
    return 2 * sum(transformer_blocks_per_level(cfg))


def linear_calls(cfg: UNetConfig):
    """(linears one UNet evaluation runs, cross-attention ``to_kv`` linears
    ``precompute_text_kv`` runs once per generation).  Per transformer
    block: self-attention to_q, to_kv, to_out, cross-attention to_q,
    to_out, the GEGLU projection and the FF output; per transformer, a
    linear proj_in and proj_out; per resnet, time_emb_proj; and the time
    (and SDXL add-) embedding MLPs."""
    blocks = sum(transformer_blocks_per_level(cfg))
    cross = [b == "CrossAttnDownBlock2D" for b in cfg.down_block_types]
    cross += [b == "CrossAttnUpBlock2D" for b in cfg.up_block_types]
    n_down, n_up = len(cfg.down_block_types), len(cfg.up_block_types)
    transformers = (cfg.layers_per_block * sum(cross[:n_down]) + 1
                    + (cfg.layers_per_block + 1) * sum(cross[n_down:]))
    resnets = cfg.layers_per_block * n_down + 2 + (cfg.layers_per_block + 1) * n_up
    embeds = 2 + (2 if cfg.addition_embed_type == "text_time" else 0)
    proj = 2 * transformers if cfg.use_linear_projection else 0
    return 7 * blocks + proj + resnets + embeds, blocks


class DenseDispatch:
    """Single-device execution (diffusers-equivalent)."""

    def __init__(self, text_kv: Optional[Dict[str, Any]] = None):
        self.text_kv = text_kv or {}

    def conv_in(self, p, x, name):
        return conv2d(p, x)

    def conv(self, p, x, name, *, stride=1):
        return conv2d(p, x, stride=stride)

    def group_norm(self, p, x, name, *, groups, eps=1e-5):
        return group_norm(p, x, groups=groups, eps=eps)

    def self_attn(self, p, x, name, *, heads):
        return attention(p, x, heads=heads)

    def cross_attn(self, p, x, name, *, heads, enc):
        return cross_attention(
            p, x, heads=heads, encoder_hidden_states=enc,
            cached_kv=self.text_kv.get(name),
        )

    def feed_forward(self, p, x, name):
        return feed_forward(p, x)

    def resnet(self, p, x, temb, name, *, groups):
        return resnet_block(self, p, x, temb, name, groups=groups)


class PatchDispatch:
    """One rank of displaced patch parallelism: the activations are this
    rank's rows, ``ctx`` holds its process group and stale buffers."""

    def __init__(self, ctx: PatchContext):
        self.ctx = ctx

    def conv_in(self, p, x, name):
        # first layer: the whole input, this rank's output rows
        return sliced_conv2d(p, x, self.ctx)

    def conv(self, p, x, name, *, stride=1):
        return patch_conv2d(p, x, self.ctx, name, stride=stride)

    def group_norm(self, p, x, name, *, groups, eps=1e-5):
        return patch_group_norm(p, x, self.ctx, name, groups=groups, eps=eps)

    def self_attn(self, p, x, name, *, heads):
        if self.ctx.attn_impl == "ring":
            return ring_self_attention(p, x, self.ctx, name, heads=heads)
        return patch_self_attention(p, x, self.ctx, name, heads=heads)

    def cross_attn(self, p, x, name, *, heads, enc):
        cached = None if self.ctx.text_kv is None else self.ctx.text_kv.get(name)
        return cross_attention(p, x, heads=heads, encoder_hidden_states=enc,
                               cached_kv=cached)

    def feed_forward(self, p, x, name):
        return feed_forward(p, x)  # local over tokens

    def resnet(self, p, x, temb, name, *, groups):
        return resnet_block(self, p, x, temb, name, groups=groups)


def timestep_embedding(t, dim: int, *, flip_sin_to_cos: bool = True,
                       freq_shift: int = 0, max_period: int = 10000):
    """diffusers get_timestep_embedding, float32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32,
                                                   device=t.device)
    exponent = exponent / (half - freq_shift)
    emb = t.float()[:, None] * torch.exp(exponent)[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], dim=-1)
    return emb


def layer_norm(p, x, eps: float = 1e-5):
    """LayerNorm with float32 moments, normalized value in x.dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    xc = x32 - mean
    var = xc.square().mean(dim=-1, keepdim=True)
    y = (xc * torch.rsqrt(var + eps)).to(x.dtype)
    return y * p["scale"] + p["bias"]


def resnet_block(d, p, x, temb, name, *, groups: int):
    """diffusers ResnetBlock2D."""
    h = d.group_norm(p["norm1"], x, f"{name}.norm1", groups=groups)
    h = d.conv(p["conv1"], silu(h), f"{name}.conv1")
    t = linear(p["time_emb_proj"], silu(temb))
    h = h + t[:, None, None, :]
    h = d.group_norm(p["norm2"], h, f"{name}.norm2", groups=groups)
    h = d.conv(p["conv2"], silu(h), f"{name}.conv2")
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x)
    return x + h


def basic_transformer_block(d, p, x, enc, name, *, heads: int):
    """diffusers BasicTransformerBlock: self-attn, cross-attn, GEGLU FF."""
    x = x + d.self_attn(p["attn1"], layer_norm(p["norm1"], x), f"{name}.attn1",
                        heads=heads)
    x = x + d.cross_attn(p["attn2"], layer_norm(p["norm2"], x), f"{name}.attn2",
                         heads=heads, enc=enc)
    x = x + d.feed_forward(p["ff"], layer_norm(p["norm3"], x), f"{name}.ff")
    return x


def transformer_2d(d, p, x, enc, name, *, heads: int, use_linear_projection: bool,
                   norm_groups: int = 32):
    b, h, w, c = x.shape
    residual = x
    hs = d.group_norm(p["norm"], x, f"{name}.norm", groups=norm_groups, eps=1e-6)
    if use_linear_projection:
        hs = linear(p["proj_in"], hs.reshape(b, h * w, c))
    else:
        hs = conv2d(p["proj_in"], hs).reshape(b, h * w, c)
    for i, bp in enumerate(p["transformer_blocks"]):
        hs = basic_transformer_block(d, bp, hs, enc,
                                     f"{name}.transformer_blocks.{i}", heads=heads)
    if use_linear_projection:
        hs = linear(p["proj_out"], hs).reshape(b, h, w, c)
    else:
        hs = conv2d(p["proj_out"], hs.reshape(b, h, w, c))
    return hs + residual


def upsample_nearest_2x(x):
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def unet_forward(params, cfg: UNetConfig, sample, timesteps,
                 encoder_hidden_states, *, dispatch=None,
                 added_cond: Optional[Dict[str, Any]] = None,
                 cache_depth: int = 0, deep_cache=None):
    """Full UNet forward: ``sample`` [B, H, W, C] NHWC latent -> [B, H, W, C]
    (this rank's rows under ``PatchDispatch``).

    The step cache (parallel/stepcache.py): with ``cache_depth`` K > 0 the
    deepest K levels (down blocks L-K..L-1, the mid block, up blocks
    0..K-1) are the deep subtree and the result is ``(out, deep)``:

    * ``deep_cache`` None (a full step): everything runs, and ``deep`` is
      the feature entering up block K (after up block K-1's upsampler);
    * ``deep_cache`` given (a shallow step): only down blocks 0..L-K-1
      run, without block L-K-1's downsampler (it feeds the deep subtree
      only), then up blocks K..L-1 resume from ``deep_cache``; ``deep`` is
      None.  The shallow layers push exactly the skips the shallow up
      blocks pop.
    """
    d = dispatch or DenseDispatch()
    n_levels = len(cfg.block_out_channels)
    if cache_depth and not 1 <= cache_depth < n_levels:
        raise ValueError(f"cache_depth must be in [1, {n_levels - 1}] for a "
                         f"{n_levels}-level UNet, got {cache_depth}")
    cut = n_levels - cache_depth  # the first deep down block
    shallow = cache_depth > 0 and deep_cache is not None
    dtype = params["conv_in"]["kernel"].dtype
    b = sample.shape[0]
    timesteps = torch.as_tensor(timesteps, device=sample.device)
    if timesteps.dim() == 0:
        timesteps = timesteps.expand(b)

    temb = timestep_embedding(
        timesteps, cfg.block_out_channels[0],
        flip_sin_to_cos=cfg.flip_sin_to_cos, freq_shift=cfg.freq_shift,
    ).to(dtype)
    temb = linear(params["time_embedding"]["linear_2"],
                  silu(linear(params["time_embedding"]["linear_1"], temb)))
    if cfg.addition_embed_type == "text_time":
        assert added_cond is not None, "SDXL needs added_cond text_embeds/time_ids"
        time_ids = added_cond["time_ids"]
        tid_emb = timestep_embedding(
            time_ids.reshape(-1), cfg.addition_time_embed_dim,
            flip_sin_to_cos=cfg.flip_sin_to_cos, freq_shift=cfg.freq_shift,
        ).reshape(b, -1).to(dtype)
        add = torch.cat([added_cond["text_embeds"].to(dtype), tid_emb], dim=-1)
        temb = temb + linear(params["add_embedding"]["linear_2"],
                             silu(linear(params["add_embedding"]["linear_1"], add)))

    enc = encoder_hidden_states.to(dtype)
    groups = cfg.norm_num_groups
    n_blocks = len(cfg.block_out_channels)

    x = d.conv_in(params["conv_in"], sample.to(dtype), "conv_in")
    skips = [x]
    for i, btype in enumerate(cfg.down_block_types):
        if shallow and i >= cut:
            break
        bp = params["down_blocks"][i]
        for j in range(cfg.layers_per_block):
            x = d.resnet(bp["resnets"][j], x, temb, f"down_blocks.{i}.resnets.{j}",
                         groups=groups)
            if btype == "CrossAttnDownBlock2D":
                x = transformer_2d(
                    d, bp["attentions"][j], x, enc, f"down_blocks.{i}.attentions.{j}",
                    heads=cfg.heads_for_block(i),
                    use_linear_projection=cfg.use_linear_projection,
                    norm_groups=groups,
                )
            skips.append(x)
        if i < len(cfg.down_block_types) - 1 and not (shallow and i == cut - 1):
            x = d.conv(bp["downsamplers"][0]["conv"], x,
                       f"down_blocks.{i}.downsamplers.0.conv", stride=2)
            skips.append(x)

    if not shallow:
        mp = params["mid_block"]
        x = d.resnet(mp["resnets"][0], x, temb, "mid_block.resnets.0", groups=groups)
        x = transformer_2d(
            d, mp["attentions"][0], x, enc, "mid_block.attentions.0",
            heads=cfg.heads_for_block(n_blocks - 1),
            use_linear_projection=cfg.use_linear_projection, norm_groups=groups,
        )
        x = d.resnet(mp["resnets"][1], x, temb, "mid_block.resnets.1", groups=groups)

    deep_out = None
    for i, btype in enumerate(cfg.up_block_types):
        if shallow and i < cache_depth:
            continue
        if cache_depth and i == cache_depth:
            if shallow:
                x = deep_cache
            else:
                deep_out = x
        bp = params["up_blocks"][i]
        for j in range(cfg.layers_per_block + 1):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = d.resnet(bp["resnets"][j], x, temb, f"up_blocks.{i}.resnets.{j}",
                         groups=groups)
            if btype == "CrossAttnUpBlock2D":
                x = transformer_2d(
                    d, bp["attentions"][j], x, enc, f"up_blocks.{i}.attentions.{j}",
                    heads=cfg.heads_for_block(n_blocks - 1 - i),
                    use_linear_projection=cfg.use_linear_projection,
                    norm_groups=groups,
                )
        if i < len(cfg.up_block_types) - 1:
            x = upsample_nearest_2x(x)
            x = d.conv(bp["upsamplers"][0]["conv"], x,
                       f"up_blocks.{i}.upsamplers.0.conv")

    assert not skips
    x = d.group_norm(params["conv_norm_out"], x, "conv_norm_out", groups=groups)
    x = d.conv(params["conv_out"], silu(x), "conv_out")
    if cache_depth:
        return x, deep_out
    return x


def precompute_text_kv(params, encoder_hidden_states):
    """Text KV of every cross-attention layer, computed once per generation:
    {layer_name: [B, L_text, 2C]}, keyed like the forward's cross-attn names.
    The text embeddings are cast to the weights' dtype first, as the forward
    casts its own inputs."""
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                sub = f"{path}.{k}" if path else k
                if k == "attn2" and isinstance(v, dict):
                    w = v["to_kv"]["kernel"]
                    out[sub] = linear(v["to_kv"], encoder_hidden_states.to(w.dtype))
                elif isinstance(v, (dict, list)):
                    walk(v, sub)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, f"{path}.{i}")

    walk(params, "")
    return out


# ---------------------------------------------------------------------------
# random init, seeded through a torch.Generator (the tree matches the JAX
# init_unet_params structure; the random values differ from JAX's)
# ---------------------------------------------------------------------------


def _normal(gen, shape, scale):
    return torch.randn(shape, generator=gen, device=gen.device) * scale


def _init_linear(gen, cin, cout, bias=True):
    p = {"kernel": _normal(gen, (cin, cout), 1.0 / math.sqrt(cin))}
    if bias:
        p["bias"] = torch.zeros(cout, device=gen.device)
    return p


def _init_conv(gen, kh, kw, cin, cout, bias=True):
    p = {"kernel": _normal(gen, (cout, cin, kh, kw), 1.0 / math.sqrt(cin * kh * kw))}
    if bias:
        p["bias"] = torch.zeros(cout, device=gen.device)
    return p


def _init_norm(gen, c):
    return {"scale": torch.ones(c, device=gen.device),
            "bias": torch.zeros(c, device=gen.device)}


def _init_attn(gen, c, kv_dim=None):
    kv_dim = kv_dim or c
    return {
        "to_q": _init_linear(gen, c, c, bias=False),
        "to_kv": _init_linear(gen, kv_dim, 2 * c, bias=False),
        "to_out": _init_linear(gen, c, c),
    }


def _init_resnet(gen, cin, cout, temb_dim):
    p = {
        "norm1": _init_norm(gen, cin),
        "conv1": _init_conv(gen, 3, 3, cin, cout),
        "time_emb_proj": _init_linear(gen, temb_dim, cout),
        "norm2": _init_norm(gen, cout),
        "conv2": _init_conv(gen, 3, 3, cout, cout),
    }
    if cin != cout:
        p["conv_shortcut"] = _init_conv(gen, 1, 1, cin, cout)
    return p


def _init_transformer(gen, c, n_layers, cross_dim, use_linear):
    blocks = [
        {
            "norm1": _init_norm(gen, c),
            "attn1": _init_attn(gen, c),
            "norm2": _init_norm(gen, c),
            "attn2": _init_attn(gen, c, kv_dim=cross_dim),
            "norm3": _init_norm(gen, c),
            "ff": {
                "net_0": {"proj": _init_linear(gen, c, 8 * c)},
                "net_2": _init_linear(gen, 4 * c, c),
            },
        }
        for _ in range(n_layers)
    ]
    proj = ((lambda: _init_linear(gen, c, c)) if use_linear
            else (lambda: _init_conv(gen, 1, 1, c, c)))
    return {"norm": _init_norm(gen, c), "proj_in": proj(),
            "transformer_blocks": blocks, "proj_out": proj()}


def cast_params(tree, dtype, device=None):
    """Cast every floating tensor of a tree to ``dtype`` (and move it to
    ``device`` if given); conv kernels (4-D) go to channels_last memory
    format.  A ``QuantizedTensor``'s payload and scale are moved, never
    cast (an fp8 payload is a floating tensor too): ``dtype`` becomes its
    compute dtype."""
    if isinstance(tree, dict):
        return {k: cast_params(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [cast_params(v, dtype, device) for v in tree]
    if isinstance(tree, QuantizedTensor):
        return tree.to(device, dtype=dtype)
    t = tree.to(device) if device is not None else tree
    t = t.to(dtype) if t.is_floating_point() else t
    if t.dim() == 4:
        t = t.contiguous(memory_format=torch.channels_last)
    return t


def init_unet_params(gen: torch.Generator, cfg: UNetConfig, dtype=torch.float32):
    """Random parameter tree on ``gen``'s device, structured like the JAX
    init_unet_params tree."""
    ch0 = cfg.block_out_channels[0]
    temb_dim = cfg.time_embed_dim
    params: Dict[str, Any] = {
        "conv_in": _init_conv(gen, 3, 3, cfg.in_channels, ch0),
        "time_embedding": {
            "linear_1": _init_linear(gen, ch0, temb_dim),
            "linear_2": _init_linear(gen, temb_dim, temb_dim),
        },
    }
    if cfg.addition_embed_type == "text_time":
        params["add_embedding"] = {
            "linear_1": _init_linear(gen, cfg.projection_class_embeddings_input_dim,
                                     temb_dim),
            "linear_2": _init_linear(gen, temb_dim, temb_dim),
        }

    down_blocks = []
    out_ch = ch0
    for i, btype in enumerate(cfg.down_block_types):
        in_ch, out_ch = out_ch, cfg.block_out_channels[i]
        block: Dict[str, Any] = {"resnets": []}
        if btype == "CrossAttnDownBlock2D":
            block["attentions"] = []
        for j in range(cfg.layers_per_block):
            block["resnets"].append(
                _init_resnet(gen, in_ch if j == 0 else out_ch, out_ch, temb_dim))
            if btype == "CrossAttnDownBlock2D":
                block["attentions"].append(_init_transformer(
                    gen, out_ch, cfg.transformer_layers_per_block[i],
                    cfg.cross_attention_dim, cfg.use_linear_projection))
        if i < len(cfg.down_block_types) - 1:
            block["downsamplers"] = [{"conv": _init_conv(gen, 3, 3, out_ch, out_ch)}]
        down_blocks.append(block)
    params["down_blocks"] = down_blocks

    mid_ch = cfg.block_out_channels[-1]
    params["mid_block"] = {
        "resnets": [_init_resnet(gen, mid_ch, mid_ch, temb_dim),
                    _init_resnet(gen, mid_ch, mid_ch, temb_dim)],
        "attentions": [_init_transformer(
            gen, mid_ch, cfg.transformer_layers_per_block[-1],
            cfg.cross_attention_dim, cfg.use_linear_projection)],
    }

    up_blocks = []
    rev = list(reversed(cfg.block_out_channels))
    rev_tf = list(reversed(cfg.transformer_layers_per_block))
    prev_out = rev[0]
    for i, btype in enumerate(cfg.up_block_types):
        out_ch = rev[i]
        in_ch = rev[min(i + 1, len(rev) - 1)]
        block = {"resnets": []}
        if btype == "CrossAttnUpBlock2D":
            block["attentions"] = []
        for j in range(cfg.layers_per_block + 1):
            skip_ch = in_ch if j == cfg.layers_per_block else out_ch
            res_in = prev_out if j == 0 else out_ch
            block["resnets"].append(
                _init_resnet(gen, res_in + skip_ch, out_ch, temb_dim))
            if btype == "CrossAttnUpBlock2D":
                block["attentions"].append(_init_transformer(
                    gen, out_ch, rev_tf[i], cfg.cross_attention_dim,
                    cfg.use_linear_projection))
        if i < len(cfg.up_block_types) - 1:
            block["upsamplers"] = [{"conv": _init_conv(gen, 3, 3, out_ch, out_ch)}]
        prev_out = out_ch
        up_blocks.append(block)
    params["up_blocks"] = up_blocks

    params["conv_norm_out"] = _init_norm(gen, ch0)
    params["conv_out"] = _init_conv(gen, 3, 3, ch0, cfg.out_channels)
    return cast_params(params, dtype)
