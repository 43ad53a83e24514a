"""Diffusion transformer (PixArt-α's DiT) in PyTorch.

Counterpart of distrifuser_tpu/models/dit.py (``DiTConfig``,
``pixart_config``, ``dit_config_from_json``, ``tiny_dit_config``,
``patchify`` / ``unpatchify``, ``pos_embed_table``, ``timestep_embedding``,
``t_embed``, ``size_condition_embed``, ``fold_size_condition``,
``caption_project``, ``adaln_table``, ``precompute_caption_kv``,
``caption_mask_bias``, ``_masked_cross_sdpa``, ``dit_block``,
``final_layer``, ``embed_tokens``, ``dit_forward``, ``init_dit_params``).
PixArt-α's block (arXiv 2310.00426: adaLN-single conditioning,
self-attention, caption cross-attention, MLP): with ``(s1, sc1, g1, s2,
sc2, g2) = table + adaln(t)``,

    x = x + g1 * attn(ln(x) * (1 + sc1) + s1)
    x = x + cross_attn(x, caption)
    x = x + g2 * mlp(ln(x) * (1 + sc2) + s2)

Activations are token-major ``[B, N, hidden]`` and a contiguous token range
is a horizontal band of the image, so the sequence-parallel runner
(parallel/dit_sp.py) gives each rank its range.  The self-attention goes
through ops/attention.py ``sdpa``, the flash kernel on the card (d = 72 for
PixArt); the caption cross-attention with its key mask stays plain
products and a softmax, as the JAX package computes it with XLA.  K and V
are one fused projection (``attn_kv``, ``cross_kv``), as in the JAX tree.

The tree keeps the JAX tree's leaf names; ``blocks`` is a list of per-block
trees where the JAX tree stacks them on a leading axis
(models/weights.py ``params_from_jax`` unstacks them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.attention import sdpa, split_kv
from ..ops.linear import linear
from .unet import load_config_source

silu = F.silu


@dataclasses.dataclass(frozen=True)
class DiTConfig:
    """Static architecture description (PixArt-α-style DiT)."""

    sample_size: int = 128          # latent H = W (1024 px / 8)
    patch_size: int = 2
    in_channels: int = 4
    out_channels: int = 4           # epsilon only: the learned-sigma rows are dropped
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    mlp_ratio: int = 4
    caption_dim: int = 4096         # text-encoder width fed to the cross-attention
    frequency_embedding_size: int = 256
    # PixArt 1024-class checkpoints micro-condition on (resolution, aspect
    # ratio), folded into t_fc2's bias by fold_size_condition
    use_additional_conditions: bool = False
    # diffusers PatchEmbed coordinates: arange(side) / (side / base) /
    # interpolation_scale (base None = tokens_per_side)
    interpolation_scale: float = 1.0
    pos_embed_base_size: Optional[int] = None

    @property
    def tokens_per_side(self) -> int:
        return self.sample_size // self.patch_size

    @property
    def num_tokens(self) -> int:
        return self.tokens_per_side ** 2

    @property
    def token_dim(self) -> int:
        return self.patch_size * self.patch_size * self.in_channels

    @property
    def token_out_dim(self) -> int:
        return self.patch_size * self.patch_size * self.out_channels

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    def __post_init__(self):
        if self.sample_size % self.patch_size != 0:
            raise ValueError("sample_size must be divisible by patch_size")
        if self.hidden_size % self.num_heads != 0:
            raise ValueError("hidden_size must be divisible by num_heads")


def pixart_config(sample_size: int = 128) -> DiTConfig:
    """PixArt-α-XL/2: 28 blocks of 1152 (16 heads of 72), T5-v1.1-XXL
    caption width; 1024-class checkpoints (latent side 128) micro-condition
    on resolution and aspect and train with interpolation_scale 2."""
    return DiTConfig(
        sample_size=sample_size,
        use_additional_conditions=sample_size == 128,
        interpolation_scale=float(max(sample_size // 64, 1)),
        pos_embed_base_size=sample_size // 2,
    )


def dit_config_from_json(source) -> DiTConfig:
    """A DiTConfig from a diffusers ``PixArtTransformer2DModel`` config.json
    (path or dict); ``out_channels`` collapses to ``in_channels``, the
    learned-sigma half of the head being dropped at conversion."""
    d = load_config_source(source)
    heads = d.get("num_attention_heads", 16)
    sample = d.get("sample_size", 128)
    ps = d.get("patch_size", 2)
    return DiTConfig(
        sample_size=sample,
        patch_size=ps,
        in_channels=d.get("in_channels", 4),
        out_channels=d.get("in_channels", 4),
        hidden_size=heads * d.get("attention_head_dim", 72),
        depth=d.get("num_layers", 28),
        num_heads=heads,
        mlp_ratio=4,
        caption_dim=d.get("caption_channels", 4096),
        use_additional_conditions=d.get("use_additional_conditions", sample == 128),
        interpolation_scale=float(d.get("interpolation_scale") or max(sample // 64, 1)),
        pos_embed_base_size=sample // ps,
    )


def tiny_dit_config(depth: int = 8) -> DiTConfig:
    """Small config for tests: the real structure at toy widths."""
    return DiTConfig(sample_size=16, patch_size=2, hidden_size=64, depth=depth,
                     num_heads=4, mlp_ratio=2, caption_dim=32)


# ---------------------------------------------------------------------------
# pieces shared by the dense forward and the runner
# ---------------------------------------------------------------------------


def patchify(cfg: DiTConfig, x: torch.Tensor) -> torch.Tensor:
    """NHWC latent [B, H, W, C] -> tokens [B, N, ps*ps*C], row-major over the
    token grid."""
    b, hgt, wid, c = x.shape
    ps = cfg.patch_size
    x = x.reshape(b, hgt // ps, ps, wid // ps, ps, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (hgt // ps) * (wid // ps), ps * ps * c)


def unpatchify(cfg: DiTConfig, tokens: torch.Tensor, channels: int) -> torch.Tensor:
    """tokens [B, N, ps*ps*C] -> NHWC [B, H, W, C]."""
    b, n, _ = tokens.shape
    ps = cfg.patch_size
    side_w = cfg.tokens_per_side
    side_h = n // side_w
    x = tokens.reshape(b, side_h, side_w, ps, ps, channels).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, side_h * ps, side_w * ps, channels)


def pos_embed_table(cfg: DiTConfig, dtype=torch.float32, device=None) -> torch.Tensor:
    """2-D sin-cos position table [N, hidden], diffusers' layout: the first
    half of the channels encodes the column, the second the row, at
    coordinates ``arange(side) / (side / base) / interpolation_scale``."""
    side = cfg.tokens_per_side
    dim = cfg.hidden_size // 2

    def axis_embed(pos):
        omega = torch.arange(dim // 2, dtype=torch.float32, device=device)
        omega = 1.0 / (10000.0 ** (omega / (dim // 2)))
        out = pos[:, None] * omega[None, :]
        return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)

    base = cfg.pos_embed_base_size or side
    coords = (torch.arange(side, dtype=torch.float32, device=device)
              / (side / base) / cfg.interpolation_scale)
    emb = axis_embed(coords)  # [side, dim]
    grid_row = emb.repeat_interleave(side, dim=0)  # [N, dim]
    grid_col = emb.repeat(side, 1)
    return torch.cat([grid_col, grid_row], dim=-1).to(dtype)


def timestep_embedding(cfg: DiTConfig, t) -> torch.Tensor:
    """Sinusoidal features [..., freq_dim] of ``t`` (DiT convention: cos
    first)."""
    t = torch.as_tensor(t)
    half = cfg.frequency_embedding_size // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[..., None] * freqs
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def t_embed(params, cfg: DiTConfig, t) -> torch.Tensor:
    """Timestep -> conditioning vector [hidden]."""
    f = timestep_embedding(cfg, t).to(params["t_fc1"]["kernel"].dtype)
    return linear(params["t_fc2"], silu(linear(params["t_fc1"], f)))


def size_condition_embed(params, cfg: DiTConfig, height: float, width: float):
    """PixArt's micro-conditioning vector [hidden]: the (height, width) and
    the aspect ratio, each through its own 2-layer embedder."""
    dev = params["t_fc1"]["kernel"].device

    def embed(emb_p, vals):
        f = torch.stack([timestep_embedding(cfg, torch.tensor(float(v), device=dev))
                         for v in vals])
        f = f.to(emb_p["fc1"]["kernel"].dtype)
        return linear(emb_p["fc2"], silu(linear(emb_p["fc1"], f))).reshape(-1)

    res = embed(params["resolution_embedder"], (height, width))
    ar = embed(params["aspect_ratio_embedder"], (height / width,))
    return torch.cat([res, ar])


def fold_size_condition(params, cfg: DiTConfig, height: float, width: float):
    """``params`` with the micro-conditioning added to ``t_fc2``'s bias:
    it is timestep-independent and enters additively on t_embed's output,
    so the fold is exact.  A no-op without additional conditions."""
    if not cfg.use_additional_conditions or "resolution_embedder" not in params:
        return params
    cond = size_condition_embed(params, cfg, height, width)
    out = dict(params)
    out["t_fc2"] = dict(params["t_fc2"])
    out["t_fc2"]["bias"] = params["t_fc2"]["bias"] + cond.to(params["t_fc2"]["bias"].dtype)
    return out


def caption_project(params, enc: torch.Tensor) -> torch.Tensor:
    """Text-encoder states [B, Lt, caption_dim] -> [B, Lt, hidden]."""
    return linear(params["cap_fc2"],
                  F.gelu(linear(params["cap_fc1"], enc), approximate="tanh"))


def adaln_table(params, cfg: DiTConfig, temb: torch.Tensor) -> torch.Tensor:
    """The adaLN-single output for one timestep embedding: [6, hidden]."""
    return linear(params["adaln"], silu(temb)).reshape(6, cfg.hidden_size)


def _ln(x):
    """LayerNorm without affine, float32 moments."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)


def precompute_caption_kv(params, cfg: DiTConfig, enc: torch.Tensor):
    """Each block's cross-attention KV [B, Lt, 2*hidden], computed once per
    generation (the caption does not change over the loop); the caption is
    cast to the model dtype first."""
    y = caption_project(params, enc.to(params["cap_fc1"]["kernel"].dtype))
    return [linear(bp["cross_kv"], y) for bp in params["blocks"]]


def caption_mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """Caption mask [..., Lt] (1 = real token) -> additive bias
    [..., 1, 1, Lt]: -1e9 removes a key exactly."""
    keep = mask[..., None, None, :] != 0
    return torch.where(keep, 0.0, -1e9).float()


def _masked_cross_sdpa(q, k, v, bias, heads: int):
    """Cross-attention with an additive key bias: float32 logits and
    softmax, plain products (120 caption keys)."""
    b, lq, c = q.shape
    lk = k.shape[1]
    d = c // heads
    qh = q.reshape(b, lq, heads, d).float()
    kh = k.reshape(b, lk, heads, d).float()
    vh = v.reshape(b, lk, heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(d)
    w = torch.softmax(logits + bias, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w.to(v.dtype), vh)
    return out.reshape(b, lq, c)


def dit_block(bp: Dict[str, Any], cfg: DiTConfig, x: torch.Tensor, c6: torch.Tensor,
              cap_kv: torch.Tensor, self_kv: Optional[torch.Tensor] = None,
              patch_start: Optional[int] = None, kv_assemble=None, attn_core=None,
              cap_bias: Optional[torch.Tensor] = None):
    """One transformer block on ``x`` [B, Lq, hidden] (the tokens this call
    computes), ``c6`` [6, hidden] (or [B, 6, hidden]), ``cap_kv`` the
    block's caption KV [B, Lt, 2*hidden], ``cap_bias`` [B, 1, 1, Lt].

    The self-attention's KV, fused [.., 2*hidden] as the port keeps it, is
    assembled by mode:

    * dense (no ``self_kv``, no hooks): attend over ``x``;
    * cache (``self_kv`` [B, N, 2*hidden] + ``patch_start``, an int or a
      0-dim device index): the fresh rows are committed in place into rows
      ``patch_start..`` of ``self_kv`` (PipeFusion's per-block cache,
      parallel/pipefusion.py), then attended over with the rest; the JAX
      package attends over an updated copy and commits the same rows after
      the block, so the values attended are the same;
    * ``kv_assemble(kv) -> full kv``: any other assembly (the displaced
      runner's fresh gather or stale buffer with a fresh own slot);
    * ``attn_core(q, full_kv) -> [B, Lq, hidden]`` replaces the sdpa call
      (the runner's ring).

    Returns ``(x_out, kv)``, ``kv`` the fresh local KV [B, Lq, 2*hidden]."""
    mods = bp["scale_shift_table"][None] + (c6[None] if c6.dim() == 2 else c6)
    s1, sc1, g1, s2, sc2, g2 = (mods[:, i][:, None, :] for i in range(6))

    hn = _ln(x) * (1.0 + sc1) + s1
    q = linear(bp["attn_q"], hn)
    kv = linear(bp["attn_kv"], hn)
    if kv_assemble is not None:
        full_kv = kv_assemble(kv)
    elif self_kv is None:
        full_kv = kv
    else:  # the cache's own storage: the fresh rows land in it for good
        if isinstance(patch_start, torch.Tensor):
            rows = patch_start + torch.arange(kv.shape[1], device=kv.device)
            self_kv.index_copy_(1, rows, kv)
        else:
            self_kv[:, patch_start:patch_start + kv.shape[1]] = kv
        full_kv = self_kv
    if attn_core is None:
        k, v = split_kv(full_kv)
        att = sdpa(q, k, v, heads=cfg.num_heads)
    else:
        att = attn_core(q, full_kv)
    x = x + g1 * linear(bp["attn_out"], att)

    cq = linear(bp["cross_q"], x)
    ck, cv = split_kv(cap_kv)
    if cap_bias is None:
        catt = sdpa(cq, ck, cv, heads=cfg.num_heads)
    else:
        catt = _masked_cross_sdpa(cq, ck, cv, cap_bias, cfg.num_heads)
    x = x + linear(bp["cross_out"], catt)

    hn2 = _ln(x) * (1.0 + sc2) + s2
    x = x + g2 * linear(bp["mlp_fc2"],
                        F.gelu(linear(bp["mlp_fc1"], hn2), approximate="tanh"))
    return x, kv


def final_layer(params, cfg: DiTConfig, x: torch.Tensor, temb: torch.Tensor):
    """[B, L, hidden] -> [B, L, ps*ps*out_ch] through the 2-entry table plus
    the timestep embedding (PixArt's T2IFinalLayer)."""
    if temb.dim() == 1:
        mods = params["final_table"] + temb[None]  # [2, hidden]
        shift, scale = mods[0][None, None], mods[1][None, None]
    else:  # per-row timesteps: temb [B, hidden]
        mods = params["final_table"][None] + temb[:, None]
        shift, scale = mods[:, 0][:, None], mods[:, 1][:, None]
    return linear(params["final_out"], _ln(x) * (1.0 + scale) + shift)


def embed_tokens(params, cfg: DiTConfig, tokens: torch.Tensor, pos: torch.Tensor):
    """Patchified tokens [B, L, ps*ps*C] and their position rows [L, hidden]
    -> block activations."""
    return linear(params["proj_in"], tokens) + pos[None].to(tokens.dtype)


def dit_forward(params: Dict[str, Any], cfg: DiTConfig, x: torch.Tensor, t,
                enc: torch.Tensor, cap_kv=None, cap_mask: Optional[torch.Tensor] = None):
    """The whole DiT on one device: NHWC latent [B, H, W, C], a scalar
    timestep, caption states [B, Lt, caption_dim] (or their ``cap_kv``) and
    an optional caption mask [B, Lt] -> the epsilon prediction, NHWC
    float32."""
    dtype = params["proj_in"]["kernel"].dtype
    tokens = patchify(cfg, x).to(dtype)
    pos = pos_embed_table(cfg, tokens.dtype, tokens.device)
    h = embed_tokens(params, cfg, tokens, pos)
    temb = t_embed(params, cfg, torch.as_tensor(t, device=tokens.device))
    c6 = adaln_table(params, cfg, temb)
    if cap_kv is None:
        cap_kv = precompute_caption_kv(params, cfg, enc)
    cap_bias = None if cap_mask is None else caption_mask_bias(cap_mask)
    for bp, kv in zip(params["blocks"], cap_kv):
        h, _ = dit_block(bp, cfg, h, c6, kv, cap_bias=cap_bias)
    out = final_layer(params, cfg, h, temb)
    return unpatchify(cfg, out.float(), cfg.out_channels)


# ---------------------------------------------------------------------------
# random init through a torch.Generator (the JAX init_dit_params structure,
# blocks as a list; the random values differ from JAX's)
# ---------------------------------------------------------------------------


def init_dit_params(gen: torch.Generator, cfg: DiTConfig, dtype=torch.float32):
    """Random tree on ``gen``'s device, each leaf drawn in ``dtype``."""
    h = cfg.hidden_size
    dev = gen.device

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def lin(d_in, d_out):
        scale = 1.0 / math.sqrt(d_in)
        return {"kernel": (torch.rand((d_in, d_out), generator=gen, device=dev,
                                      dtype=dtype) * 2 - 1) * scale,
                "bias": torch.zeros(d_out, device=dev, dtype=dtype)}

    def block():
        return {
            "scale_shift_table": randn(6, h) / h**0.5,
            "attn_q": lin(h, h), "attn_kv": lin(h, 2 * h), "attn_out": lin(h, h),
            "cross_q": lin(h, h), "cross_kv": lin(h, 2 * h), "cross_out": lin(h, h),
            "mlp_fc1": lin(h, cfg.mlp_ratio * h), "mlp_fc2": lin(cfg.mlp_ratio * h, h),
        }

    params: Dict[str, Any] = {}
    if cfg.use_additional_conditions:
        if h % 3 != 0:
            raise ValueError("use_additional_conditions needs hidden_size % 3 == 0 "
                             "(resolution h+w and aspect embeddings concatenate to hidden)")
        for name in ("resolution_embedder", "aspect_ratio_embedder"):
            params[name] = {"fc1": lin(cfg.frequency_embedding_size, h // 3),
                            "fc2": lin(h // 3, h // 3)}
    params.update({
        "proj_in": lin(cfg.token_dim, h),
        "t_fc1": lin(cfg.frequency_embedding_size, h),
        "t_fc2": lin(h, h),
        "adaln": lin(h, 6 * h),
        "cap_fc1": lin(cfg.caption_dim, h),
        "cap_fc2": lin(h, h),
        "final_table": randn(2, h) / h**0.5,
        "final_out": lin(h, cfg.token_out_dim),
        "blocks": [block() for _ in range(cfg.depth)],
    })
    return params
