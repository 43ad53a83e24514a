"""The DiT's exact head-sharded attention layouts: Ulysses and USP.

Counterpart of the attention cores of distrifuser_tpu/parallel/dit_sp.py
(``block_body_ulysses`` and ``block_body_usp``).  Each rank holds the q, k
and v of its token rows [B, L/n, C]; neither layout keeps state, so a
stale step computes what a synchronous one does:

* ``ulysses_attend``: one all-to-all over the patch group re-shards q, k
  and v from token rows to heads (every token, H/n heads), the flash
  kernel attends over the whole sequence on those heads, and one more
  all-to-all sends each rank's output rows back with every head;
* ``usp_attend``: the patch group is factored as u x r
  (``DistriConfig.ulysses_degree`` = u, the ``sp_u_group`` and
  ``sp_r_group``): the all-to-all over the u ranks of ``sp_u_group`` gives
  [B, L·u/n, H/u] head shards, the exact ring over ``sp_r_group``
  (ops/ring_attention.py ``ring_pass``, every chunk fresh) attends over the
  other r - 1 assemblies, and the inverse all-to-all restores the rows.

The JAX package runs three all-to-alls in (q, k and v) and one out; here q,
k and v travel in one [n, B, L, 3, C/n] send buffer, whose received form
is a view [B, L·n, 3·C/n] at B = 1 that the kernel reads q, k and v from
in place.  The elements on the wire are the same.
"""

from __future__ import annotations

import torch.distributed as dist

from ..parallel.collectives import all_to_all
from .attention import sdpa
from .ring_attention import ring_pass


def _to_heads(q, kv, parts: int, group):
    """q [B, L, C] and the fused kv [B, L, 2C] of this rank's token rows as
    (q, fused kv) of every rank's rows, this rank's C/``parts`` columns of
    heads: [B, parts·L, C/parts] and [B, parts·L, 2C/parts], views of the
    received buffer at B = 1."""
    b, l, c = q.shape
    cp = c // parts
    send = q.new_empty((parts, b, l, 3, cp))  # slab j: heads of rank j
    send[:, :, :, 0] = q.view(b, l, parts, cp).permute(2, 0, 1, 3)
    send[:, :, :, 1:] = kv.view(b, l, 2, parts, cp).permute(3, 0, 1, 2, 4)
    qkv = all_to_all(send, group).transpose(0, 1).reshape(b, parts * l, 3 * cp)
    return qkv[..., :cp], qkv[..., cp:]


def _to_rows(out, parts: int, group):
    """This rank's heads of every rank's rows [B, parts·L, C/parts] back as
    its own rows with every head [B, L, C]."""
    b, lt, cp = out.shape
    l = lt // parts
    back = all_to_all(out.view(b, parts, l, cp).transpose(0, 1), group)  # [parts, B, L, cp]
    return back.permute(1, 2, 0, 3).reshape(b, l, parts * cp)


def ulysses_attend(q, kv, group, *, heads: int):
    """Exact self-attention of this rank's rows ``q`` [B, L/n, C] over every
    rank's fresh ``kv`` [B, L/n, 2C] by head sharding over ``group`` (n
    ranks, n dividing ``heads``): [B, L/n, C] in q's dtype."""
    n = dist.get_world_size(group)
    qh, kvh = _to_heads(q, kv, n, group)
    cp = qh.shape[-1]
    out = sdpa(qh, kvh[..., :cp], kvh[..., cp:], heads=heads // n)
    return _to_rows(out, n, group)


def usp_attend(q, kv, u_group, r_group, u: int, r: int, *, heads: int):
    """Exact self-attention as ``ulysses_attend`` over the patch group
    factored u x r: head sharding over ``u_group`` (u ranks; None at u = 1)
    and the fresh-KV ring over ``r_group`` (r ranks; None at r = 1)."""
    if u > 1:
        q, kv = _to_heads(q, kv, u, u_group)
    out = ring_pass(q, kv, kv, r, r_group, heads=heads // u).to(q.dtype)
    return _to_rows(out, u, u_group) if u > 1 else out
