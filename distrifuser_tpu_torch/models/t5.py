"""T5 text encoder (encoder only), PixArt-α's T5-v1.1-XXL, in PyTorch.

Counterpart of distrifuser_tpu/models/t5.py (``T5Config``,
``t5_v1_1_xxl_config``, ``tiny_t5_config``, ``t5_config_from_json``,
``relative_position_buckets``, ``t5_encode``, ``init_t5_params``), with
transformers ``T5EncoderModel`` semantics:

* RMSNorm (float32 moments, no mean subtraction) before each sublayer and
  after the stack, residuals around both sublayers;
* self-attention without the 1/sqrt(d) scale, plus a learned
  relative-position bias (bucketed log-spaced offsets; the table is layer
  0's, shared by every layer) and the padding mask's -1e9 bias, float32
  logits and softmax.  It stays plain PyTorch products and a softmax, as it
  is XLA ops in the JAX package: the flash kernel's function has no bias;
* a gated (v1.1: ``wo(act(wi_0 x) * wi_1 x)``) or plain (``wo(act(wi x))``)
  feed-forward, tanh-GeLU or ReLU; no biases; the embedding is ``shared``.

The tree keeps the JAX tree's leaf names; its ``layers`` are a list of
per-layer trees where the JAX tree stacks them on a leading axis
(models/weights.py ``params_from_jax`` unstacks them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..ops.linear import linear
from .unet import load_config_source


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "gated-gelu"

    @property
    def inner_dim(self) -> int:
        return self.num_heads * self.d_kv

    @property
    def is_gated(self) -> bool:
        return self.feed_forward_proj.startswith("gated")

    @property
    def act(self):
        name = self.feed_forward_proj.split("-")[-1]
        if name == "gelu":
            # transformers maps T5's "gelu" to gelu_new, the tanh form
            return lambda x: F.gelu(x, approximate="tanh")
        if name == "relu":
            return F.relu
        raise ValueError(f"unsupported feed_forward_proj {name!r}")


def t5_v1_1_xxl_config() -> T5Config:
    """google/t5-v1_1-xxl's encoder: PixArt-α's text encoder."""
    return T5Config()


def tiny_t5_config(gated: bool = True) -> T5Config:
    return T5Config(
        vocab_size=128, d_model=32, d_kv=8, d_ff=48, num_layers=3, num_heads=4,
        feed_forward_proj="gated-gelu" if gated else "relu",
    )


def t5_config_from_json(source) -> T5Config:
    """A T5Config from a transformers ``config.json`` (path or dict)."""
    d = load_config_source(source)
    return T5Config(
        vocab_size=d.get("vocab_size", 32128),
        d_model=d.get("d_model", 4096),
        d_kv=d.get("d_kv", 64),
        d_ff=d.get("d_ff", 10240),
        num_layers=d.get("num_layers", 24),
        num_heads=d.get("num_heads", 64),
        relative_attention_num_buckets=d.get("relative_attention_num_buckets", 32),
        relative_attention_max_distance=d.get("relative_attention_max_distance", 128),
        layer_norm_epsilon=d.get("layer_norm_epsilon", 1e-6),
        feed_forward_proj=d.get("feed_forward_proj", "gated-gelu"),
    )


def _rms_norm(x, scale, eps):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * scale


def relative_position_buckets(cfg: T5Config, length: int, device=None) -> torch.Tensor:
    """[Lq, Lk] bucket ids of T5's bidirectional bucketing: exact small
    offsets, log-spaced large ones, the sign in the top half."""
    n_buckets = cfg.relative_attention_num_buckets // 2
    max_dist = cfg.relative_attention_max_distance
    ctx = torch.arange(length, device=device)
    rel = ctx[None, :] - ctx[:, None]  # memory - query
    buckets = torch.where(rel > 0, n_buckets, 0)
    rel = rel.abs()
    max_exact = n_buckets // 2
    is_small = rel < max_exact
    rel_large = max_exact + (
        torch.log(rel.float() / max_exact + 1e-9)
        / math.log(max_dist / max_exact)
        * (n_buckets - max_exact)
    ).to(torch.int32)
    rel_large = torch.clamp(rel_large, max=n_buckets - 1)
    return buckets + torch.where(is_small, rel, rel_large)


def _attention(lp, cfg: T5Config, x, pos_bias, mask_bias):
    b, l, _ = x.shape
    h, dk = cfg.num_heads, cfg.d_kv
    q = linear(lp["q"], x).reshape(b, l, h, dk)
    k = linear(lp["k"], x).reshape(b, l, h, dk)
    v = linear(lp["v"], x).reshape(b, l, h, dk)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    logits = logits + pos_bias[None] + mask_bias
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    att = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, l, cfg.inner_dim)
    return linear(lp["o"], att)


def _ff(lp, cfg: T5Config, x):
    if cfg.is_gated:
        return linear(lp["wo"], cfg.act(linear(lp["wi_0"], x)) * linear(lp["wi_1"], x))
    return linear(lp["wo"], cfg.act(linear(lp["wi"], x)))


def t5_encode(params: Dict[str, Any], cfg: T5Config, input_ids,
              attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token ids [B, L] -> final hidden states [B, L, d_model];
    ``attention_mask`` [B, L], 1 = attend."""
    emb = params["shared"]
    ids = torch.as_tensor(input_ids, device=emb.device)
    # out-of-vocab ids clamp to the last row, as JAX's gather clamps them
    x = emb[ids.clamp(0, emb.shape[0] - 1)]
    l = ids.shape[1]
    buckets = relative_position_buckets(cfg, l, emb.device)
    pos_bias = params["relative_attention_bias"].float()[buckets].permute(2, 0, 1)
    if attention_mask is None:
        mask_bias = torch.zeros((1, 1, 1, l), device=emb.device)
    else:
        keep = torch.as_tensor(attention_mask, device=emb.device)[:, None, None, :] != 0
        mask_bias = torch.where(keep, 0.0, -1e9).float()
    eps = cfg.layer_norm_epsilon
    for lp in params["layers"]:
        x = x + _attention(lp["attn"], cfg, _rms_norm(x, lp["attn_norm"], eps),
                           pos_bias, mask_bias)
        x = x + _ff(lp["ff"], cfg, _rms_norm(x, lp["ff_norm"], eps))
    return _rms_norm(x, params["final_norm"], eps)


def init_t5_params(gen: torch.Generator, cfg: T5Config, dtype=torch.float32):
    """Random tree on ``gen``'s device, structured like the JAX
    ``init_t5_params`` tree with its layers as a list (the random values
    differ from JAX's).  Each leaf is drawn in ``dtype``: T5-XXL's 4.8 B
    parameters never exist in float32 on the card."""
    dev = gen.device

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def lin(cin, cout):
        return {"kernel": randn(cin, cout) / math.sqrt(cin)}

    def layer():
        ff = ({"wi_0": lin(cfg.d_model, cfg.d_ff), "wi_1": lin(cfg.d_model, cfg.d_ff),
               "wo": lin(cfg.d_ff, cfg.d_model)}
              if cfg.is_gated else
              {"wi": lin(cfg.d_model, cfg.d_ff), "wo": lin(cfg.d_ff, cfg.d_model)})
        return {
            "attn": {"q": lin(cfg.d_model, cfg.inner_dim), "k": lin(cfg.d_model, cfg.inner_dim),
                     "v": lin(cfg.d_model, cfg.inner_dim), "o": lin(cfg.inner_dim, cfg.d_model)},
            "attn_norm": torch.ones(cfg.d_model, device=dev, dtype=dtype),
            "ff": ff,
            "ff_norm": torch.ones(cfg.d_model, device=dev, dtype=dtype),
        }

    params = {
        "shared": randn(cfg.vocab_size, cfg.d_model),
        "relative_attention_bias": randn(cfg.relative_attention_num_buckets, cfg.num_heads),
        "layers": [layer() for _ in range(cfg.num_layers)],
        "final_norm": torch.ones(cfg.d_model, device=dev, dtype=dtype),
    }
    return params
