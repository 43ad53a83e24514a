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
``patch_self_attention`` is the displaced self-attention of the patch
path: queries from this rank's rows only, keys and values over the whole
image, gathered fresh in synchronous steps and, in stale steps, this rank's
fresh KV in its own slot of the previous step's gathered KV.  The kernel
then runs at Lq = L/n against Lk = L.  ``attn_impl="ring"`` replaces it by
ops/ring_attention.py ``ring_self_attention``.
"""

from __future__ import annotations

from ..parallel.context import PatchContext
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


def patch_self_attention(p, x, ctx: PatchContext, name: str, *, heads: int):
    """Self-attention of a row patch with one-step-stale peer KV.

    ``x``: this rank's tokens [B, L/n, C].  The layer's buffer is the
    gathered KV [n, B, L/n, 2C] in patch order."""
    q = linear(p["to_q"], x)
    k, v = split_kv(displaced_kv(linear(p["to_kv"], x), ctx, name))
    return linear(p["to_out"], sdpa(q, k, v, heads=heads))


def displaced_kv(kv, ctx: PatchContext, name: str, halves: int = 1):
    """The KV [B, L, 2C] that this rank's fresh KV ``kv`` [B, L/n, 2C]
    attends with under displaced patch parallelism (the UNet's
    self-attention and the DiT's and MMDiT's blocks alike): every rank's
    fresh KV, gathered, in a synchronous step; in a stale step the layer's
    buffer (the gathered KV [n, B, L/n, 2C] of the previous step) with this
    rank's slot fresh, its refresh issued for the next step.  A compressed
    refresh scales each row of 2C as one (``halves`` 1, the UNet's) or its
    k and v halves apart (2, the transformers')."""
    if ctx.n == 1:
        return kv
    if ctx.is_sync:
        return _flatten_seq(ctx.emit_sync_gather(name, kv, "attn"))  # [n, B, L/n, 2C]
    gathered = ctx.stale(name)
    if ctx.refresh_reads_stale("attn"):
        # residual coding and the partial refresh read this buffer as the
        # previous step left it
        gathered = gathered.clone()
    # fresh own slot, stale peer slots; the buffer is this step's to
    # change: the refresh below lands in a new one
    gathered[ctx.split_idx] = kv
    full_kv = _flatten_seq(gathered)
    if ctx.refresh:
        ctx.emit_refresh_gather(name, kv, "attn", halves)
    return full_kv


def _flatten_seq(gathered):
    """[n, B, L, C] -> [B, n*L, C] in patch order: a view at B = 1 (the CFG
    split), one copy at B > 1."""
    n, b, l, c = gathered.shape
    return gathered.transpose(0, 1).reshape(b, n * l, c)


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
