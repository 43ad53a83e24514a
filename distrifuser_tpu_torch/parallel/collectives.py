"""Collectives of the patch path over torch.distributed.

Counterpart of distrifuser_tpu/parallel/collectives.py (``all_gather``,
``psum_mean``, ``psum``, ``neighbor_perms``, ``exchange_boundary_rows``,
``halo_exchange``, ``gather_rows``, ``gather_cols``).  Each function takes
the process group (``None`` for the default one) and, where the patch path
overlaps it with compute, an ``async_op`` form that returns a ``Pending``
handle whose ``wait()`` gives the result.

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


class Pending:
    """An issued collective: ``wait()`` waits for its works, copies a staged
    result back to the card and returns the finished value."""

    def __init__(self, works: List, finish: Callable[[], object]):
        self._works = works
        self._finish = finish

    def wait(self):
        for work in self._works:
            work.wait()
        return self._finish()


def stages_through_host(device: torch.device, group=None) -> bool:
    """Do CUDA payloads on ``device`` go through the host in ``group`` (gloo
    on a card: ranks that share one)?"""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


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
    src = _down(x) if staged else x.contiguous()
    out = torch.empty((n, *x.shape), dtype=x.dtype, device=src.device,
                      pin_memory=staged)
    if src.is_cuda:  # NCCL: one flat output, which a CUDA graph can capture
        work = dist.all_gather_into_tensor(out.view(-1), src.reshape(-1), group=group,
                                           async_op=True)
    else:  # gloo (the CPU, or staged through the host): its list form
        work = dist.all_gather(list(out.unbind(0)), src, group=group, async_op=True)

    def finish():
        return out.to(x.device, non_blocking=True) if staged else out

    pending = Pending([work], finish)
    return pending if async_op else pending.wait()


def psum_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """Mean over the group: all-reduce sum, then divide by the group size
    (the reference's all_reduce(SUM) / n, pp/groupnorm.py:79-80)."""
    staged = stages_through_host(x.device, group)
    buf = _down(x) if staged else x.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    if staged:
        buf = buf.to(x.device)
    return buf / dist.get_world_size(group)


def psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the group, a new tensor (the reference's all_reduce(SUM),
    tp/attention.py:159): the reduce of every tensor-parallel partial."""
    staged = stages_through_host(x.device, group)
    buf = _down(x) if staged else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
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
    dev = bottom.device
    if staged:
        bottom, top = _down(bottom), _down(top)
    else:
        bottom, top = bottom.contiguous(), top.contiguous()
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
        if staged:
            return (from_prev.to(dev, non_blocking=True),
                    from_next.to(dev, non_blocking=True))
        return from_prev, from_next

    pending = Pending(works, finish)
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


def gather_cols(patch: torch.Tensor, group=None) -> torch.Tensor:
    """Column patches [B, H, w, C] of the group, in patch order, as the
    whole [B, H, n*w, C] (naive patch parallelism's ``col`` scheme)."""
    g = all_gather(patch, group)
    return torch.cat(g.unbind(0), dim=2)
