"""The MMDiT (Stable Diffusion 3's joint transformer) in PyTorch.

Counterpart of distrifuser_tpu/models/mmdit.py (``MMDiTConfig``,
``sd3_config``, ``mmdit_config_from_json``, ``tiny_mmdit_config``,
``init_mmdit_params``, ``pos_embed_cropped``, ``cond_vec``, ``_mods``,
``_rms_heads``, ``mmdit_block``, ``final_layer``, ``mmdit_forward``).  The
multimodal DiT of "Scaling Rectified Flow Transformers for High-Resolution
Image Synthesis" (Esser et al., 2024) runs two token streams, the text
context and the image patches, each with its own adaLN modulation,
projections and MLP, and one JOINT attention a block over the
concatenation of both streams' tokens (context rows first).

Activations are token-major ``[B, N, hidden]``: a contiguous token range is
a horizontal band of the image, which parallel/mmdit_sp.py gives each rank.
The joint attention goes through ops/attention.py ``sdpa``, the flash
kernel on the card (d = 64 at SD3's widths), over 154 + 4096 tokens at
1024x1024: neither length a multiple of the kernel's tiles, which it
masks.  q, k and v of a stream are one fused projection (``x_qkv``,
``c_qkv``), as in the JAX tree.

As in the JAX module:

* the last block keeps a whole context stream; SD3 drops its context
  attention output and MLP ("context_pre_only"), and the converter
  zero-fills those weights and gates, so the discarded stream passes
  through bit for bit (models/weights.py ``convert_mmdit_state_dict``);
* ``qk_norm`` (the SD3.5 family) RMS-normalizes each head's q and k, with
  float32 moments;
* SD3.5-medium's dual attention: blocks ``[0, dual_attention_blocks)``
  also run an image-only self-attention, whose leaves (``x_mod2``, the
  last 3 chunks of diffusers' 9-chunk AdaLayerNormZeroX, ``x2_qkv``,
  ``x2_out`` and its norms) live in ``blocks_dual``.

The tree keeps the JAX tree's leaf names; ``blocks`` and ``blocks_dual``
are lists of per-block trees where the JAX tree stacks them on a leading
axis (models/weights.py ``params_from_jax`` unstacks them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.attention import sdpa
from ..ops.linear import linear
from .dit import _ln, patchify, timestep_embedding, unpatchify
from .unet import load_config_source

silu = F.silu


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    """Static architecture description (SD3-class MMDiT)."""

    sample_size: int = 128          # latent H = W (1024 px / 8)
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    hidden_size: int = 1536         # SD3-medium: 24 heads of 64
    depth: int = 24
    num_heads: int = 24
    mlp_ratio: int = 4
    joint_attention_dim: int = 4096  # context width (T5-XXL / the CLIPs' concat)
    pooled_projection_dim: int = 2048  # CLIP-L + bigG pooled concat
    frequency_embedding_size: int = 256
    # the sin-cos table is built on this grid and center-cropped to the
    # token grid (SD3's PatchEmbed), so one checkpoint serves several sizes
    pos_embed_max_size: int = 192
    # the SD3.5 family: per-head RMSNorm of q and k in both streams
    qk_norm: bool = False
    # SD3.5-medium: blocks [0, dual_attention_blocks) run a second,
    # image-only self-attention (a contiguous prefix in every checkpoint)
    dual_attention_blocks: int = 0

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
        if self.tokens_per_side > self.pos_embed_max_size:
            raise ValueError(f"token grid {self.tokens_per_side} exceeds "
                             f"pos_embed_max_size {self.pos_embed_max_size}")
        if not 0 <= self.dual_attention_blocks <= self.depth:
            raise ValueError(f"dual_attention_blocks={self.dual_attention_blocks} must "
                             f"lie in [0, depth={self.depth}]")


def sd3_config(sample_size: int = 128) -> MMDiTConfig:
    """SD3-medium (2B): 24 joint blocks of 1536 (24 heads of 64), a
    16-channel latent."""
    return MMDiTConfig(sample_size=sample_size)


def mmdit_config_from_json(source) -> MMDiTConfig:
    """A config from a diffusers ``SD3Transformer2DModel`` config.json (path
    or dict); refuses the architecture options this module does not
    implement."""
    cfg = load_config_source(source)
    if cfg.get("qk_norm") not in (None, "", False, "rms_norm"):
        raise ValueError(
            f"qk_norm={cfg.get('qk_norm')!r}: only the SD3.5 family's 'rms_norm' is "
            "implemented; refusing to load silently-wrong weights")
    dual = tuple(cfg.get("dual_attention_layers") or ())
    if dual != tuple(range(len(dual))):
        raise ValueError(
            f"dual_attention_layers={dual}: only the published contiguous-prefix "
            "layout (0, 1, ..., k-1; SD3.5-medium uses 0-12) is implemented")
    heads = cfg.get("num_attention_heads", 24)
    return MMDiTConfig(
        dual_attention_blocks=len(dual),
        sample_size=cfg.get("sample_size", 128),
        patch_size=cfg.get("patch_size", 2),
        in_channels=cfg.get("in_channels", 16),
        out_channels=cfg.get("out_channels", cfg.get("in_channels", 16)),
        hidden_size=heads * cfg.get("attention_head_dim", 64),
        depth=cfg.get("num_layers", 24),
        num_heads=heads,
        joint_attention_dim=cfg.get("joint_attention_dim", 4096),
        pooled_projection_dim=cfg.get("pooled_projection_dim", 2048),
        pos_embed_max_size=cfg.get("pos_embed_max_size", 192),
        qk_norm=cfg.get("qk_norm") == "rms_norm",
    )


def tiny_mmdit_config(depth: int = 4) -> MMDiTConfig:
    """Test-scale geometry: a 16x16 latent grid, width 32."""
    return MMDiTConfig(sample_size=32, patch_size=2, in_channels=4, out_channels=4,
                       hidden_size=32, depth=depth, num_heads=4, mlp_ratio=2,
                       joint_attention_dim=32, pooled_projection_dim=24,
                       pos_embed_max_size=64)


# ---------------------------------------------------------------------------
# random init through a torch.Generator (the JAX init_mmdit_params
# structure, blocks as lists; the random values differ from JAX's)
# ---------------------------------------------------------------------------


def init_mmdit_params(gen: torch.Generator, cfg: MMDiTConfig, dtype=torch.float32):
    """Random tree on ``gen``'s device, each leaf drawn in ``dtype``."""
    h, d = cfg.hidden_size, cfg.head_dim
    dev = gen.device

    def lin(d_in, d_out):
        scale = 1.0 / math.sqrt(d_in)
        return {"kernel": (torch.rand((d_in, d_out), generator=gen, device=dev,
                                      dtype=dtype) * 2 - 1) * scale,
                "bias": torch.zeros(d_out, device=dev, dtype=dtype)}

    def ones():
        return torch.ones(d, device=dev, dtype=dtype)

    def block():
        # per-stream adaLN: shift, scale and gate for the attention and the MLP
        bp = {"x_mod": lin(h, 6 * h), "c_mod": lin(h, 6 * h),
              "x_qkv": lin(h, 3 * h), "c_qkv": lin(h, 3 * h),
              "x_out": lin(h, h), "c_out": lin(h, h),
              "x_fc1": lin(h, cfg.mlp_ratio * h), "x_fc2": lin(cfg.mlp_ratio * h, h),
              "c_fc1": lin(h, cfg.mlp_ratio * h), "c_fc2": lin(cfg.mlp_ratio * h, h)}
        if cfg.qk_norm:
            bp.update({name: ones() for name in ("x_qnorm", "x_knorm", "c_qnorm",
                                                 "c_knorm")})
        return bp

    def dual_block():
        bp = {"x_mod2": lin(h, 3 * h), "x2_qkv": lin(h, 3 * h), "x2_out": lin(h, h)}
        if cfg.qk_norm:
            bp.update({"x2_qnorm": ones(), "x2_knorm": ones()})
        return bp

    params: Dict[str, Any] = {
        "proj_in": lin(cfg.token_dim, h),
        "ctx_in": lin(cfg.joint_attention_dim, h),
        "t_fc1": lin(cfg.frequency_embedding_size, h),
        "t_fc2": lin(h, h),
        "pool_fc1": lin(cfg.pooled_projection_dim, h),
        "pool_fc2": lin(h, h),
        "final_mod": lin(h, 2 * h),
        "final_out": lin(h, cfg.token_out_dim),
        "blocks": [block() for _ in range(cfg.depth)],
    }
    if cfg.dual_attention_blocks:
        params["blocks_dual"] = [dual_block() for _ in range(cfg.dual_attention_blocks)]
    return params


# ---------------------------------------------------------------------------
# pieces shared by the dense forward and the runner
# ---------------------------------------------------------------------------


def pos_embed_cropped(cfg: MMDiTConfig, dtype=torch.float32, device=None) -> torch.Tensor:
    """[N, hidden] sin-cos table built on the ``pos_embed_max_size`` grid at
    coordinates ``arange(max) * side / max`` and center-cropped to the
    token grid (SD3's PatchEmbed); the first half of the channels encodes
    the column, the second the row."""
    side, big = cfg.tokens_per_side, cfg.pos_embed_max_size
    dim = cfg.hidden_size // 2
    omega = torch.arange(dim // 2, dtype=torch.float32, device=device)
    omega = 1.0 / (10000.0 ** (omega / (dim // 2)))
    coords = torch.arange(big, dtype=torch.float32, device=device) * (side / big)
    out = coords[:, None] * omega[None, :]
    emb = torch.cat([torch.sin(out), torch.cos(out)], dim=-1)  # [big, dim]
    top = (big - side) // 2
    window = emb[top:top + side]  # square latents: rows and columns alike
    grid_row = window.repeat_interleave(side, dim=0)  # [N, dim]
    grid_col = window.repeat(side, 1)
    return torch.cat([grid_col, grid_row], dim=-1).to(dtype)


def cond_vec(params, cfg: MMDiTConfig, t, pooled: torch.Tensor) -> torch.Tensor:
    """The conditioning vector [B, hidden] = MLP(timestep features) +
    MLP(pooled text); ``t`` a scalar or [B] (the flow sigma times 1000).
    A [B] ``t`` embeds row by row at a scalar's shapes (one-row GEMMs), so
    each row's vector has the bits a scalar ``t`` of its value gives."""
    t = torch.as_tensor(t, device=pooled.device).float().reshape(-1)

    def embed(tt):
        f = timestep_embedding(cfg, tt).to(params["t_fc1"]["kernel"].dtype)
        return linear(params["t_fc2"], silu(linear(params["t_fc1"], f)))

    temb = embed(t) if t.numel() == 1 else torch.cat([embed(tr[None]) for tr in t])
    p = pooled.to(params["pool_fc1"]["kernel"].dtype)
    pemb = linear(params["pool_fc2"], silu(linear(params["pool_fc1"], p)))
    if temb.shape[0] == 1 and pemb.shape[0] != 1:
        temb = temb.expand(pemb.shape)
    return temb + pemb


def _mods(mod_p, vec, n):
    """silu(vec) -> ``n`` modulation vectors, each [B, 1, hidden]."""
    return [c[:, None, :] for c in linear(mod_p, silu(vec)).chunk(n, dim=-1)]


def _rms_heads(x, w, heads: int):
    """Per-head RMSNorm over the head dim (SD3.5's qk_norm), float32
    moments: [B, L, C] with weight [C / heads] -> [B, L, C]."""
    b, l, c = x.shape
    xh = x.reshape(b, l, heads, c // heads).float()
    y = xh * torch.rsqrt(xh.square().mean(dim=-1, keepdim=True) + 1e-6)
    return (y * w.float()).to(x.dtype).reshape(b, l, c)


def _q_kv(qkv, bp, prefix: str, heads: int):
    """A fused [.., 3C] projection as (q, the fused KV [.., 2C]): views of
    it, or with the block's ``<prefix>_qnorm`` / ``_knorm`` weights (qk_norm)
    q and k normalized and the KV concatenated anew."""
    c = qkv.shape[-1] // 3
    q, kv = qkv[..., :c], qkv[..., c:]
    if prefix + "_qnorm" not in bp:
        return q, kv
    k = _rms_heads(kv[..., :c], bp[prefix + "_knorm"], heads)
    return (_rms_heads(q, bp[prefix + "_qnorm"], heads),
            torch.cat([k, kv[..., c:]], dim=-1))


def mmdit_block(bp: Dict[str, Any], cfg: MMDiTConfig, x: torch.Tensor, ctx: torch.Tensor,
                vec: torch.Tensor, kv_assemble=None, attn_core=None,
                dual_p: Optional[Dict[str, Any]] = None, kv2_assemble=None,
                attn2_core=None):
    """One joint-attention block on the image tokens ``x`` [B, Lx, hidden]
    (this rank's rows), the context ``ctx`` [B, Lc, hidden] and ``vec`` [B,
    hidden].

    The image stream's KV is fused ``[.., 2*hidden]`` (k then v) in the
    hooks, as the port keeps displaced KV:

    * ``kv_assemble(kv) -> full kv``: the displaced runner's assembly of
      the image KV (the fresh gather, or the stale buffer with this rank's
      slot fresh); the context KV is every rank's own, replicated;
    * ``attn_core(cq, xq, ckv, xkv) -> [B, Lc + Lx, hidden]`` replaces the
      attention call (the runner's ring, with the context KV as its static
      block).

    ``dual_p`` adds SD3.5-medium's image-only self-attention on the same
    LayerNorm of ``x`` modulated by ``x_mod2``, its gated output added after
    the joint attention's residual; ``kv2_assemble(kv2)`` and
    ``attn2_core(q2, kv2) -> [B, Lx, hidden]`` are its hooks.

    Returns ``(x_out, ctx_out, kv)`` with the fresh local image KV, plus
    the dual attention's ``kv2`` where ``dual_p`` is given."""
    assert kv_assemble is None or attn_core is None
    xs1, xsc1, xg1, xs2, xsc2, xg2 = _mods(bp["x_mod"], vec, 6)
    cs1, csc1, cg1, cs2, csc2, cg2 = _mods(bp["c_mod"], vec, 6)
    heads = cfg.num_heads

    xln = _ln(x)
    xn = xln * (1.0 + xsc1) + xs1
    cn = _ln(ctx) * (1.0 + csc1) + cs1
    xq, xkv = _q_kv(linear(bp["x_qkv"], xn), bp, "x", heads)
    cq, ckv = _q_kv(linear(bp["c_qkv"], cn), bp, "c", heads)
    if attn_core is not None:
        att = attn_core(cq, xq, ckv, xkv)
    else:
        full = xkv if kv_assemble is None else kv_assemble(xkv)
        (ck, cv), (fk, fv) = ckv.chunk(2, dim=-1), full.chunk(2, dim=-1)
        att = sdpa(torch.cat([cq, xq], dim=1), torch.cat([ck, fk], dim=1),
                   torch.cat([cv, fv], dim=1), heads=heads)
    lc = ctx.shape[1]
    catt, xatt = att[:, :lc], att[:, lc:]
    x = x + xg1 * linear(bp["x_out"], xatt)
    ctx = ctx + cg1 * linear(bp["c_out"], catt)

    kv2 = None
    if dual_p is not None:
        assert kv2_assemble is None or attn2_core is None
        d_s, d_sc, d_g = _mods(dual_p["x_mod2"], vec, 3)
        q2, kv2 = _q_kv(linear(dual_p["x2_qkv"], xln * (1.0 + d_sc) + d_s), dual_p,
                        "x2", heads)
        if attn2_core is not None:
            att2 = attn2_core(q2, kv2)
        else:
            full2 = kv2 if kv2_assemble is None else kv2_assemble(kv2)
            fk2, fv2 = full2.chunk(2, dim=-1)
            att2 = sdpa(q2, fk2, fv2, heads=heads)
        # diffusers' residual order: the joint attention, the gated dual
        # attention, then the MLP
        x = x + d_g * linear(dual_p["x2_out"], att2)

    xn2 = _ln(x) * (1.0 + xsc2) + xs2
    x = x + xg2 * linear(bp["x_fc2"], F.gelu(linear(bp["x_fc1"], xn2), approximate="tanh"))
    cn2 = _ln(ctx) * (1.0 + csc2) + cs2
    ctx = ctx + cg2 * linear(bp["c_fc2"],
                             F.gelu(linear(bp["c_fc1"], cn2), approximate="tanh"))
    if dual_p is not None:
        return x, ctx, xkv, kv2
    return x, ctx, xkv


def final_layer(params, cfg: MMDiTConfig, x: torch.Tensor, vec: torch.Tensor):
    """adaLN-modulated projection [B, L, hidden] -> [B, L, ps*ps*out_ch]."""
    shift, scale = _mods(params["final_mod"], vec, 2)
    return linear(params["final_out"], _ln(x) * (1.0 + scale) + shift)


def embed_tokens(params, tokens: torch.Tensor, pos: torch.Tensor):
    """Patchified tokens [B, L, ps*ps*C] and their position rows [L, hidden]
    -> the image stream entering block 0."""
    return linear(params["proj_in"], tokens) + pos[None].to(tokens.dtype)


def context_in(params, enc: torch.Tensor):
    """The text states [B, Lc, joint_attention_dim] -> the context stream
    entering block 0 (cast to the model dtype first)."""
    return linear(params["ctx_in"], enc.to(params["ctx_in"]["kernel"].dtype))


def mmdit_forward(params: Dict[str, Any], cfg: MMDiTConfig, x: torch.Tensor, t,
                  enc: torch.Tensor, pooled: torch.Tensor) -> torch.Tensor:
    """The whole MMDiT on one device: NHWC latent [B, H, W, C], the flow
    timestep (scalar or [B]), text states [B, Lc, joint_attention_dim] and
    pooled text [B, pooled_projection_dim] -> the velocity, NHWC float32."""
    dtype = params["proj_in"]["kernel"].dtype
    tokens = patchify(cfg, x).to(dtype)
    h = embed_tokens(params, tokens, pos_embed_cropped(cfg, dtype, tokens.device))
    ctx = context_in(params, enc)
    vec = cond_vec(params, cfg, t, pooled)
    duals = params.get("blocks_dual", [])
    for i, bp in enumerate(params["blocks"]):
        h, ctx = mmdit_block(bp, cfg, h, ctx, vec,
                             dual_p=duals[i] if i < len(duals) else None)[:2]
    out = final_layer(params, cfg, h, vec)
    return unpatchify(cfg, out.float(), cfg.out_channels)
