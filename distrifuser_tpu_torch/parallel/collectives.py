"""Collectives of the patch path over torch.distributed.

Counterpart of distrifuser_tpu/parallel/collectives.py (``all_gather``,
``psum_mean``, ``psum``, ``neighbor_perms``, ``exchange_boundary_rows``,
``halo_exchange``, ``gather_rows``, ``gather_cols``, ``ring_perm`` and
``ring_shift``; ``ring_hop`` is the PipeFusion stage ring's hop, whose
sides may be idle; ``gather_batch`` gathers the image groups' outputs under
data parallelism; ``all_to_all`` is the JAX package's tiled
``lax.all_to_all`` of the DiT's head-sharded layouts).  Each function takes
the process group (``None`` for the default one) and, where the patch path
overlaps it with compute, an ``async_op`` form that returns a ``Pending``
handle whose ``wait()`` gives the result.  ``batched_all_gather`` and
``batched_halo_exchange`` are the flat exchanges of the batched refresh
(``PatchContext.flush``): one collective per dtype for every layer of a
step.

The ring hop of ring attention (``ring_shift``) sends this rank's chunk to
the next rank of the patch group and receives the previous rank's, both
wrapping, as one ``batch_isend_irecv`` pair.  One-byte payloads (int8, and
float8_e4m3fn, which gloo does not carry) travel as uint8 views.

The conv halo exchange is a neighbour exchange (``batch_isend_irecv``)
with zeros at the image border, as the JAX package's non-wrapping
``ppermute``: each rank moves only its two boundary slabs, not the
reference's n-peer all-gather, so the bytes match the JAX package's count.

Ranks that share a card run a gloo group over CUDA tensors: the payload is
then staged through pinned host memory (copy down, exchange, copy up),
chosen by the group's backend, not after a failure.  The copy down must
finish before gloo reads the host buffer, so staging synchronises the
host with the card's stream at every issue: such a world overlaps nothing,
and no CUDA graph can hold it (``stages_through_host``).  Under NCCL
``wait()`` makes the current stream wait for the collective, and every
collective here may be captured in a CUDA graph: on a card the all-gather
writes one flat output tensor, with no per-rank list to copy out of.
"""

from __future__ import annotations

from typing import Callable, List

import torch
import torch.distributed as dist

from ..ops._build import add_launches
from . import overlap


class Pending:
    """An issued collective: ``wait()`` waits for its works, copies a staged
    result back to the card and returns the finished value.  ``op`` names
    the collective for parallel/overlap.py's record (None for a handle that
    only wraps others)."""

    def __init__(self, works: List, finish: Callable[[], object], op: str = None):
        self._works = works
        self._finish = finish
        self._record = overlap.issued(op) if op is not None else None

    def wait(self):
        for work in self._works:
            work.wait()
        overlap.waited(self._record)
        return self._finish()


def stages_through_host(device: torch.device, group=None) -> bool:
    """Do CUDA payloads on ``device`` go through the host in ``group`` (gloo
    on a card: ranks that share one)?"""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The tensor a collective moves: a float8 payload as its uint8 view."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def _down(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of the CUDA tensor ``t``, complete on return."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host


def all_gather(x: torch.Tensor, group=None, *, async_op: bool = False):
    """Gather every rank's ``x`` into a new leading dim ``[n, *x.shape]``,
    in group-rank order."""
    n = dist.get_world_size(group)
    staged = stages_through_host(x.device, group)
    src = _wire(_down(x) if staged else x.contiguous())
    out = torch.empty((n, *x.shape), dtype=src.dtype, device=src.device,
                      pin_memory=staged)
    if src.is_cuda:  # NCCL: one flat output, which a CUDA graph can capture
        work = dist.all_gather_into_tensor(out.view(-1), src.reshape(-1), group=group,
                                           async_op=True)
    else:  # gloo (the CPU, or staged through the host): its list form
        work = dist.all_gather(list(out.unbind(0)), src, group=group, async_op=True)

    def finish():
        res = out.view(x.dtype)
        return res.to(x.device, non_blocking=True) if staged else res

    pending = Pending([work], finish, "all_gather")
    return pending if async_op else pending.wait()


def all_to_all(x: torch.Tensor, group=None, *, async_op: bool = False):
    """Send slab i of ``x`` [n, ...] to rank i of ``group`` and return
    [n, ...] whose slab i is what rank i sent this rank, in group-rank
    order (one ``all_to_all_single``).  Counts each call in
    ``all_to_all.launches``, which graph replays add to as the kernel
    wrappers' counts (parallel/graphs.py)."""
    n = dist.get_world_size(group)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all: {x.shape[0]} slabs for a group of {n} ranks")
    staged = stages_through_host(x.device, group)
    src = _down(x) if staged else x.contiguous()
    out = torch.empty(src.shape, dtype=src.dtype, device=src.device, pin_memory=staged)
    work = dist.all_to_all_single(out, src, group=group, async_op=True)
    add_launches(all_to_all)

    def finish():
        return out.to(x.device, non_blocking=True) if staged else out

    pending = Pending([work], finish, "all_to_all")
    return pending if async_op else pending.wait()


all_to_all.launches = 0


def psum_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the group: all-reduce sum, then divide by the group size
    (the reference's all_reduce(SUM) / n, pp/groupnorm.py:79-80)."""
    staged = stages_through_host(x.device, group)
    buf = _down(x) if staged else x.clone()
    Pending([dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group, async_op=True)],
            lambda: None, "all_reduce").wait()
    if staged:
        buf = buf.to(x.device)
    return buf / dist.get_world_size(group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group, a new tensor (the reference's all_reduce(SUM),
    tp/attention.py:159): the reduce of every tensor-parallel partial."""
    staged = stages_through_host(x.device, group)
    buf = _down(x) if staged else x.clone(memory_format=torch.contiguous_format)
    Pending([dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group, async_op=True)],
            lambda: None, "all_reduce").wait()
    return buf.to(x.device) if staged else buf


def neighbor_peers(group=None):
    """(previous, next) global ranks of this rank along the patch order of
    ``group``; None at the image border.  The single source of the halo
    edge convention, as ``neighbor_perms`` is in the JAX package."""
    group = dist.group.WORLD if group is None else group
    idx, n = dist.get_rank(group), dist.get_world_size(group)
    prev = dist.get_global_rank(group, idx - 1) if idx > 0 else None
    nxt = dist.get_global_rank(group, idx + 1) if idx < n - 1 else None
    return prev, nxt


def exchange_boundary_rows(bottom: torch.Tensor, top: torch.Tensor, group=None,
                           *, async_op: bool = False):
    """Send ``bottom`` to the next rank and ``top`` to the previous one;
    returns ``(from_prev, from_next)``: the previous rank's bottom and the
    next rank's top, zeros at the image border."""
    staged = stages_through_host(bottom.device, group)
    prev, nxt = neighbor_peers(group)
    dev, dtype = bottom.device, bottom.dtype
    if staged:
        bottom, top = _down(bottom), _down(top)
    else:
        bottom, top = bottom.contiguous(), top.contiguous()
    bottom, top = _wire(bottom), _wire(top)
    from_prev, from_next = torch.zeros_like(bottom), torch.zeros_like(top)
    ops = []
    if nxt is not None:
        ops += [dist.P2POp(dist.isend, bottom, nxt, group),
                dist.P2POp(dist.irecv, from_next, nxt, group)]
    if prev is not None:
        ops += [dist.P2POp(dist.isend, top, prev, group),
                dist.P2POp(dist.irecv, from_prev, prev, group)]
    works = dist.batch_isend_irecv(ops) if ops else []

    def finish():
        # the sent slabs stay referenced until the exchange is done
        del ops[:]
        got = from_prev.view(dtype), from_next.view(dtype)
        if staged:
            return tuple(t.to(dev, non_blocking=True) for t in got)
        return got

    pending = Pending(works, finish, "halo")
    return pending if async_op else pending.wait()


def ring_perm(group=None):
    """(previous, next) global ranks of this rank on the wrapping ring of
    ``group``: the ring hop sends to the next and receives from the
    previous (JAX ``ring_perm``)."""
    group = dist.group.WORLD if group is None else group
    idx, n = dist.get_rank(group), dist.get_world_size(group)
    return (dist.get_global_rank(group, (idx - 1) % n),
            dist.get_global_rank(group, (idx + 1) % n))


def ring_shift(x: torch.Tensor, group=None, *, async_op: bool = False):
    """One ring hop: send ``x`` to the next rank of ``group`` and return the
    previous rank's ``x`` (a new tensor), wrapping around."""
    staged = stages_through_host(x.device, group)
    prev, nxt = ring_perm(group)
    src = _wire(_down(x) if staged else x.contiguous())
    recv = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, nxt, group),
           dist.P2POp(dist.irecv, recv, prev, group)]
    works = dist.batch_isend_irecv(ops)

    def finish():
        del ops[:]  # the sent chunk stays referenced until the hop is done
        got = recv.view(x.dtype)
        return got.to(x.device, non_blocking=True) if staged else got

    pending = Pending(works, finish, "ring_shift")
    return pending if async_op else pending.wait()


def ring_hop(send, recv, device, group=None):
    """One hop of a ring where either side may be idle (PipeFusion's stage
    ring): send the tensors ``send`` (a sequence, or None) to the next rank
    of ``group`` and receive tensors of the ``(shape, dtype)`` pairs of
    ``recv`` (or None) on ``device`` from the previous one, wrapping;
    returns the received tensors as a list, or None.  The two neighbours'
    calls pair one send with one receive each, as ``ring_shift``'s do, but
    a rank whose peer is idle issues only its own side."""
    if stages_through_host(torch.device(device), group):
        raise ValueError("ring_hop moves card tensors over NCCL or CPU tensors over "
                         "gloo, not CUDA payloads staged through the host")
    prev, nxt = ring_perm(group)
    srcs = [_wire(t.contiguous()) for t in send or ()]
    bufs = [torch.empty(shape, device=device,
                        dtype=torch.uint8 if dtype == torch.float8_e4m3fn else dtype)
            for shape, dtype in recv or ()]
    ops = ([dist.P2POp(dist.isend, t, nxt, group) for t in srcs]
           + [dist.P2POp(dist.irecv, t, prev, group) for t in bufs])
    if ops:
        Pending(dist.batch_isend_irecv(ops), lambda: None, "ring_hop").wait()
    if recv is None:
        return None
    return [b.view(dtype) for b, (_, dtype) in zip(bufs, recv)]


def _by_dtype(items):
    """``items`` (tuples whose second entry is a tensor) grouped by that
    tensor's dtype, in first-seen order."""
    groups = {}
    for item in items:
        groups.setdefault(item[1].dtype, []).append(item)
    return list(groups.values())


def _flat(tensors) -> torch.Tensor:
    return torch.cat([_wire(t).reshape(-1) for t in tensors])


def batched_all_gather(parts, group=None, *, async_op: bool = False):
    """All-gather of many tensors, one flat collective per dtype: ``parts``
    is a list of ``(key, tensor)``; the result maps each key to its
    ``[n, *tensor.shape]``, as ``all_gather`` of that tensor alone gives."""
    issued = []
    for items in _by_dtype(parts):
        flat = _flat([t for _, t in items])
        issued.append((items, all_gather(flat, group, async_op=True)))

    def finish():
        out = {}
        for items, pending in issued:
            gathered = pending.wait()  # [n, total]
            off = 0
            for key, t in items:
                size = t.numel()
                piece = gathered[:, off:off + size].reshape(gathered.shape[0], *t.shape)
                out[key] = piece.view(t.dtype)
                off += size
        return out

    pending = Pending([], finish)
    return pending if async_op else pending.wait()


def batched_halo_exchange(parts, group=None, *, async_op: bool = False):
    """Boundary-row exchange of many layers, one flat neighbour pair per
    dtype: ``parts`` is a list of ``(key, top, bottom)``; the result maps
    each key to ``(from_prev, from_next)``, as ``exchange_boundary_rows``
    of that pair alone gives."""
    issued = []
    for items in _by_dtype(parts):
        bottoms = _flat([b for _, _, b in items])
        tops = _flat([t for _, t, _ in items])
        issued.append((items, exchange_boundary_rows(bottoms, tops, group,
                                                     async_op=True)))

    def finish():
        out = {}
        for items, pending in issued:
            from_prev, from_next = pending.wait()
            off = 0
            for key, top, _ in items:
                size = top.numel()
                out[key] = tuple(t[off:off + size].view(top.dtype).reshape(top.shape)
                                 for t in (from_prev, from_next))
                off += size
        return out

    pending = Pending([], finish)
    return pending if async_op else pending.wait()


def halo_exchange(x: torch.Tensor, halo: int, group=None, *, async_op: bool = False):
    """Boundary rows of the row patch ``x`` [B, h, W, C] with its spatial
    neighbours: ``(from_prev, from_next)``, the previous rank's bottom
    ``halo`` rows and the next rank's top ``halo`` rows, each
    [B, halo, W, C]; zeros at the image border, which is the zero padding
    a whole-image conv applies there."""
    if halo == 0 or dist.get_world_size(group) == 1:
        zeros = x.new_zeros((x.shape[0], halo, *x.shape[2:]))
        pending = Pending([], lambda: (zeros, zeros))
        return pending if async_op else pending.wait()
    return exchange_boundary_rows(x[:, x.shape[1] - halo:], x[:, :halo], group,
                                  async_op=async_op)


def gather_rows(patch: torch.Tensor, group=None) -> torch.Tensor:
    """Row patches [B, h, W, C] of the group, in patch order, as the whole
    [B, n*h, W, C] (the per-step output gather)."""
    g = all_gather(patch, group)
    return torch.cat(g.unbind(0), dim=1)


def gather_batch(part: torch.Tensor, group=None) -> torch.Tensor:
    """The batch shares [b, ...] of the group, in group-rank order, as the
    whole [n*b, ...] (the image groups' outputs under data parallelism)."""
    return all_gather(part, group).flatten(0, 1)


def gather_cols(patch: torch.Tensor, group=None) -> torch.Tensor:
    """Column patches [B, H, w, C] of the group, in patch order, as the
    whole [B, H, n*w, C] (naive patch parallelism's ``col`` scheme)."""
    g = all_gather(patch, group)
    return torch.cat(g.unbind(0), dim=2)
