"""Attention: SDPA, the dense attention block, cached cross-attention.

Counterpart of distrifuser_tpu/ops/attention.py (``sdpa``, ``split_kv``,
``attention``, ``cross_attention``).  K and V stay fused in one ``to_kv``
projection; ``split_kv`` returns two strided views of it, which the kernel
reads in place.

``sdpa`` has one route per device: on a CUDA tensor every call launches
the flash kernel (ops/flash_attention.py), which masks ragged lengths such
as the 77 text tokens itself, so there is no length threshold, routing
table or fallback; on a CPU tensor it runs the kernel's plain version,
which also stands for the JAX package's XLA softmax route (``_sdpa_xla``).
``patch_self_attention`` is ROADMAP queue 1 item 7.
"""

from __future__ import annotations

from .flash_attention import flash_sdpa
from .linear import linear


def sdpa(q, k, v, *, heads: int):
    """Scaled dot-product attention over [B, L, C] tensors with H heads."""
    return flash_sdpa(q, k, v, heads=heads)


def split_kv(kv):
    """Split a fused [..., 2C] KV into (K, V) views."""
    return kv.chunk(2, dim=-1)


def attention(p, x, *, heads: int, encoder_hidden_states=None):
    """Dense attention block: q/kv projections, sdpa, out projection (the
    residual lives in the transformer block)."""
    enc = x if encoder_hidden_states is None else encoder_hidden_states
    q = linear(p["to_q"], x)
    k, v = split_kv(linear(p["to_kv"], enc))
    return linear(p["to_out"], sdpa(q, k, v, heads=heads))


def cross_attention(p, x, *, heads: int, encoder_hidden_states=None,
                    cached_kv=None):
    """Cross-attention over text tokens, with the text KV computed once per
    generation (``models.unet.precompute_text_kv``) when given."""
    q = linear(p["to_q"], x)
    if cached_kv is None:
        assert encoder_hidden_states is not None
        cached_kv = linear(p["to_kv"], encoder_hidden_states)
    k, v = split_kv(cached_kv)
    return linear(p["to_out"], sdpa(q, k, v, heads=heads))
