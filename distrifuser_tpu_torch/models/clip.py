"""CLIP text encoders (SD's ViT-L and SDXL's OpenCLIP bigG) in PyTorch.

Counterpart of distrifuser_tpu/models/clip.py: a pre-LN transformer with
causal masking, quick-GeLU (ViT-L) or GeLU (bigG) MLPs, EOS-token pooling
and an optional text projection.  The 77-token causal self-attention stays
plain PyTorch ops, as it was XLA ops in the reference (it is not the flash
kernel's non-causal function).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..ops.linear import linear
from ..parallel.compress import asdense
from .unet import cast_params, layer_norm, load_config_source


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"  # "gelu" for OpenCLIP bigG
    eos_token_id: int = 49407
    projection_dim: Optional[int] = None  # set for SDXL text_encoder_2


def clip_vit_l_config() -> CLIPTextConfig:
    """openai/clip-vit-large-patch14: SD 1.x / SDXL text_encoder."""
    return CLIPTextConfig()


def open_clip_bigg_config() -> CLIPTextConfig:
    """laion/CLIP-ViT-bigG-14: SDXL text_encoder_2."""
    return CLIPTextConfig(
        hidden_size=1280,
        num_hidden_layers=32,
        num_attention_heads=20,
        intermediate_size=5120,
        hidden_act="gelu",
        projection_dim=1280,
    )


def open_clip_vith_config() -> CLIPTextConfig:
    """OpenCLIP ViT-H/14 text tower as SD 2.x snapshots ship it: 23 layers
    (the penultimate-layer truncation), GeLU MLPs, final hidden state."""
    return CLIPTextConfig(
        hidden_size=1024,
        num_hidden_layers=23,
        num_attention_heads=16,
        intermediate_size=4096,
        hidden_act="gelu",
    )


def clip_config_from_json(source) -> CLIPTextConfig:
    """A CLIPTextConfig from a transformers `text_encoder/config.json`
    (path or dict).  ``projection_dim`` is kept only for a
    CLIPTextModelWithProjection (SDXL's text_encoder_2): plain
    CLIPTextModel snapshots carry the field too, with no text_projection
    weights to apply it."""
    cfg = load_config_source(source)
    with_projection = "CLIPTextModelWithProjection" in (cfg.get("architectures") or [])
    return CLIPTextConfig(
        vocab_size=cfg.get("vocab_size", 49408),
        hidden_size=cfg.get("hidden_size", 768),
        num_hidden_layers=cfg.get("num_hidden_layers", 12),
        num_attention_heads=cfg.get("num_attention_heads", 12),
        intermediate_size=cfg.get("intermediate_size", 3072),
        max_position_embeddings=cfg.get("max_position_embeddings", 77),
        hidden_act=cfg.get("hidden_act", "quick_gelu"),
        eos_token_id=cfg.get("eos_token_id", 49407),
        projection_dim=cfg.get("projection_dim") if with_projection else None,
    )


def tiny_clip_config(hidden: int = 32) -> CLIPTextConfig:
    return CLIPTextConfig(
        vocab_size=1000,
        hidden_size=hidden,
        num_hidden_layers=2,
        num_attention_heads=4,
        intermediate_size=64,
        projection_dim=hidden,
    )


def _act(name: str):
    if name == "quick_gelu":
        return lambda x: x * torch.sigmoid(1.702 * x)
    if name in ("gelu", "gelu_new"):
        return lambda x: F.gelu(x, approximate="none")
    raise ValueError(f"unknown activation {name!r}")


def _self_attn(p, x, heads: int, mask):
    b, l, c = x.shape
    d = c // heads
    q = (linear(p["q_proj"], x) * d**-0.5).reshape(b, l, heads, d)
    k = linear(p["k_proj"], x).reshape(b, l, heads, d)
    v = linear(p["v_proj"], x).reshape(b, l, heads, d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + mask
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, l, c)
    return linear(p["out_proj"], out)


def clip_text_forward(params, cfg: CLIPTextConfig, input_ids) -> Dict[str, Any]:
    """Returns {"hidden_states": [L+1 tensors], "last_hidden_state",
    "pooler_output", "text_embeds" (with a projection)};
    ``hidden_states[i]`` is the input to layer i, so SDXL's penultimate state
    is ``hidden_states[-2]``."""
    emb = params["token_embedding"]
    ids = torch.as_tensor(input_ids, device=emb.device)
    b, l = ids.shape
    # out-of-vocab ids clamp to the last row, as JAX's gather clamps them
    # (the hash tokenizer's BOS/EOS lie outside a tiny test vocab)
    x = emb[ids.clamp(0, emb.shape[0] - 1)] + params["position_embedding"][None, :l]
    mask = torch.triu(
        torch.full((l, l), float("-inf"), device=emb.device), diagonal=1
    )[None, None]

    hidden_states: List[Any] = [x]
    act = _act(cfg.hidden_act)
    for lp in params["layers"]:
        x = x + _self_attn(lp["self_attn"], layer_norm(lp["layer_norm1"], x),
                           cfg.num_attention_heads, mask)
        h = linear(lp["mlp"]["fc1"], layer_norm(lp["layer_norm2"], x))
        x = x + linear(lp["mlp"]["fc2"], act(h))
        hidden_states.append(x)

    last = layer_norm(params["final_layer_norm"], x)
    # EOS pooling as transformers CLIPTextModel: legacy eos_token_id == 2
    # pools at argmax(ids), otherwise at the first id equal to eos_token_id
    if cfg.eos_token_id == 2:
        eos_pos = ids.argmax(dim=1)
    else:
        eos_pos = (ids == cfg.eos_token_id).int().argmax(dim=1)
    pooled = last[torch.arange(b, device=ids.device), eos_pos]
    out = {
        "hidden_states": hidden_states,
        "last_hidden_state": last,
        "pooler_output": pooled,
    }
    if "text_projection" in params:
        out["text_embeds"] = pooled @ asdense(params["text_projection"]["kernel"])
    return out


def init_clip_params(gen: torch.Generator, cfg: CLIPTextConfig,
                     dtype=torch.float32):
    """Random parameter tree on ``gen``'s device, structured like the JAX
    init_clip_params tree."""
    d, m = cfg.hidden_size, cfg.intermediate_size
    dev = gen.device

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def lin(cin, cout):
        return {"kernel": randn(cin, cout) / cin**0.5,
                "bias": torch.zeros(cout, device=dev)}

    def norm():
        return {"scale": torch.ones(d, device=dev), "bias": torch.zeros(d, device=dev)}

    layers = [
        {
            "layer_norm1": norm(),
            "self_attn": {"q_proj": lin(d, d), "k_proj": lin(d, d),
                          "v_proj": lin(d, d), "out_proj": lin(d, d)},
            "layer_norm2": norm(),
            "mlp": {"fc1": lin(d, m), "fc2": lin(m, d)},
        }
        for _ in range(cfg.num_hidden_layers)
    ]
    params = {
        "token_embedding": randn(cfg.vocab_size, d) * 0.02,
        "position_embedding": randn(cfg.max_position_embeddings, d) * 0.01,
        "layers": layers,
        "final_layer_norm": norm(),
    }
    if cfg.projection_dim:
        params["text_projection"] = {"kernel": randn(d, cfg.projection_dim) / d**0.5}
    return cast_params(params, dtype)
