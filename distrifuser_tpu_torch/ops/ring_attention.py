"""Ring attention over the patch group: the peers' KV chunks stream around
the ranks instead of being gathered onto each.

Counterpart of distrifuser_tpu/ops/ring_attention.py (``ring_pass``,
``ring_self_attention``).  The gathered layout holds every peer's KV,
[n, B, L/n, 2C] a layer; the ring holds this rank's own chunk only, n times
less, and sends each chunk once around the group per step:

* this rank's own chunk is always fresh and is attended first, then an
  optional non-rotating ``kv_static`` block, then n - 1 hops: hop i brings
  the chunk of rank r - i - 1 (``collectives.ring_shift``, one send to the
  next rank and one receive from the previous).  Each hop's successor is
  issued before that hop's arrival is attended, so the transfer overlaps
  the flash kernel on the previous chunk (the JAX package's software
  pipelining);
* each chunk runs the flash kernel with its log-sum-exp output
  (``flash_sdpa(return_lse=True)``, float32 partials) and the partials
  merge in float32: ``lse = logaddexp(lse_a, lse_b)``, ``out =
  exp(lse_a - lse) * out_a + exp(lse_b - lse) * out_b``.  That merge is a
  small elementwise pass, not a kernel of the JAX package (whose ring
  computes plain ``_chunk_scores`` / ``_online_merge``);
* in a synchronous step the chunk that rotates is every rank's fresh KV
  (exact attention); in a stale step it is every rank's chunk of the
  previous step, held in the layer's buffer, so the next step's buffer is
  this step's own chunk and no refresh collective is needed.
"""

from __future__ import annotations

import torch

from ..parallel.collectives import ring_shift
from ..parallel.context import PatchContext
from .attention import sdpa, split_kv
from .flash_attention import flash_sdpa
from .linear import linear


def _chunk(q, kv, heads: int):
    """(out float32 [B, Lq, C], lse [B, H, Lq]) of q against one fused KV
    chunk [B, Lk, 2C]."""
    k, v = split_kv(kv)
    return flash_sdpa(q, k, v, heads=heads, return_lse=True)


def merge_partials(a, b, heads: int):
    """Two attention partials ``(out [B, Lq, C], lse [B, H, Lq])`` over
    disjoint KV sets, merged into the partial over their union, float32."""
    (out_a, lse_a), (out_b, lse_b) = a, b
    lse = torch.logaddexp(lse_a, lse_b)
    bsz, lq, c = out_a.shape

    def weighted(out, part_lse):
        w = torch.exp(part_lse - lse).transpose(1, 2).unsqueeze(-1)  # [B, Lq, H, 1]
        return out.view(bsz, lq, heads, c // heads) * w

    return (weighted(out_a, lse_a) + weighted(out_b, lse_b)).view(bsz, lq, c), lse


def ring_pass(q, kv_own, kv_rotating, n: int, group=None, *, heads: int,
              kv_static=None):
    """Attention of ``q`` [B, Lq, C] over this rank's ``kv_own`` chunk, the
    optional ``kv_static`` block and the ``kv_rotating`` chunks of the n - 1
    other ranks of ``group``, which arrive hop by hop: the normalized
    output, float32 [B, Lq, C]."""
    # hop 1 first: nothing needs it until the own (and static) chunk is done
    in_flight = ring_shift(kv_rotating, group, async_op=True) if n > 1 else None
    acc = _chunk(q, kv_own, heads)
    if kv_static is not None:
        acc = merge_partials(acc, _chunk(q, kv_static, heads), heads)
    for hop in range(n - 1):
        arrived = in_flight.wait()
        # the next hop leaves before this arrival is attended
        in_flight = ring_shift(arrived, group, async_op=True) if hop < n - 2 else None
        acc = merge_partials(acc, _chunk(q, arrived, heads), heads)
    return acc[0]


def ring_self_attention(p, x, ctx: PatchContext, name: str, *, heads: int):
    """Self-attention of a row patch with the peers' KV streamed around the
    ring: the output of ``patch_self_attention`` in both phases, with the
    layer's buffer this rank's own chunk [B, L/n, 2C] instead of the
    gathered [n, B, L/n, 2C]."""
    q = linear(p["to_q"], x)
    return linear(p["to_out"], ring_attend(q, linear(p["to_kv"], x), ctx, name,
                                           heads=heads))


def ring_attend(q, kv_local, ctx: PatchContext, name: str, *, heads: int,
                kv_static=None):
    """Attention of this rank's ``q`` [B, Lq, C] over its fresh own chunk
    ``kv_local`` [B, L/n, 2C], the optional non-rotating ``kv_static``
    block (the MMDiT's replicated context KV) and the peers' chunks around
    the ring (the fresh ones in a synchronous step, the previous step's in a
    stale one), in q's dtype; the layer's next buffer is this step's own
    chunk (the UNet's self-attention, the DiT's and the MMDiT's blocks
    alike)."""
    if ctx.n == 1:
        kv = kv_local if kv_static is None else torch.cat([kv_static, kv_local], dim=1)
        k, v = split_kv(kv)
        return sdpa(q, k, v, heads=heads)
    rotating = kv_local if ctx.is_sync else ctx.stale(name)
    if ctx.refresh:  # the next step's buffer: this step's own chunk
        ctx.emit(name, kv_local, "attn")
    return ring_pass(q, kv_local, rotating, ctx.n, ctx.group, heads=heads,
                     kv_static=kv_static).to(q.dtype)
