"""The per-step context of the displaced patch path and its stale buffers.

Counterpart of distrifuser_tpu/parallel/context.py (``PatchContext``, its
refresh emissions, ``carry_unconsumed`` and the batched ``flush``).  The
JAX package carries the stale activations as a pytree through its compiled
loop; here they are an explicit dict of per-layer buffers, keyed by the
layer's module path, that the runner owns and hands from step to step:

* a synchronous step (step 0 .. warmup, or every step of ``full_sync``)
  exchanges fresh activations, blocking, and writes each exchanged buffer
  into ``state_out`` (``emit``): the seed of the stale phase;
* a stale step reads the previous step's buffers from ``state_in``
  (``stale``) and issues the exchange of its fresh activations as an
  asynchronous collective (``emit_refresh_*``) that the layers after it
  overlap; ``finish`` drains those refreshes at the end of the step and
  returns the next step's buffers.

The two dicts are the double buffer: a refresh lands in a new tensor of
``state_out`` and never in a buffer of ``state_in`` that the step is still
reading, and the runner swaps them between steps.  ``no_sync`` never
refreshes, so its buffers stay those of the last synchronous step.

The comm knobs act on the stale refreshes of halos ("conv2d") and KV
("attn") only, ``COMPRESS_KINDS``; GroupNorm moments and every synchronous
exchange stay exact:

* ``compress`` sends int8 / fp8 payloads with one float32 scale per row
  (the kernel of ops/quantize.py on the card) and dequantizes on arrival;
  "int8_residual" codes the delta against the previous reconstruction the
  buffers already hold, closed-loop, so the error does not accumulate.  A
  halo's sender keeps its own previous rows for that (``OWN_SUFFIX``, kind
  "local", free on the wire);
* ``refresh_fraction`` 1/k refreshes only rows {r, r+k, ...} of every
  payload, ``r = step % k`` (KV token rows, halo columns); ``step`` may be
  a device tensor, so one captured graph serves every rotation;
* ``batch_comm`` defers every refresh of the step to ``flush``: one flat
  all-gather per dtype and one flat halo pair, bit for bit the values the
  per-layer exchanges give.

Three per-context dicts replace the JAX package's process-wide registries
and are read by the runner's ``comm_volume_report``: ``kinds`` (what each
buffer is: "conv2d", "attn", "gn", "stepcache" or "local"), ``wire`` (the
bytes each exchange put on the wire) and ``carried`` (the buffers a step
passed through untouched, ``carry_unconsumed``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Set

import torch

from ..ops.quantize import quantize_rows
from . import collectives
from .compress import (COMPRESS_KINDS, dequantize, payload_mode, refresh_period,
                       scatter_every_kth, take_every_kth, wire_nbytes)

PHASE_SYNC = "sync"
PHASE_STALE = "stale"
# the sender-side own boundary rows that "int8_residual" halos code against
OWN_SUFFIX = "#own"


def _quantize(x: torch.Tensor, mode: str):
    """Per-row quantization of a refresh payload over its last axis:
    ``(payload, float32 scale of x.shape[:-1])``."""
    q, s = quantize_rows(x.reshape(-1, x.shape[-1]), payload_mode(mode))
    return q.reshape(x.shape), s.reshape(x.shape[:-1])


def _dequant(q, s):
    return dequantize(q, s, torch.float32)


@dataclasses.dataclass
class PatchContext:
    """What every patch op of one UNet evaluation reads: the patch count,
    the sync mode, the phase, this rank's patch index and process group,
    the comm knobs, the buffers of the previous step and the cached text
    KV.  ``step`` is the absolute step index (an int or a device tensor),
    which the partial refresh rotates by."""

    n: int  # ranks on the patch axis (n_device_per_batch)
    mode: str  # one of SYNC_MODES
    phase: str  # PHASE_SYNC | PHASE_STALE
    group: Any = None  # the batch_group: the n patch peers of one branch
    split_idx: int = 0
    attn_impl: str = "gather"  # "gather" | "ring" (ops/ring_attention.py)
    batch_comm: bool = False
    compress: str = "none"
    refresh_fraction: float = 1.0
    step: Any = None
    state_in: Optional[Dict[str, torch.Tensor]] = None
    state_out: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    kinds: Dict[str, str] = dataclasses.field(default_factory=dict)
    wire: Dict[str, int] = dataclasses.field(default_factory=dict)
    carried: Set[str] = dataclasses.field(default_factory=set)
    text_kv: Optional[Dict[str, torch.Tensor]] = None
    _emitted: Set[str] = dataclasses.field(default_factory=set)
    _pending: Dict[str, Any] = dataclasses.field(default_factory=dict)
    _def_gather: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    _def_halo: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    _batches: List[Any] = dataclasses.field(default_factory=list)

    @property
    def is_sync(self) -> bool:
        """Blocking fresh exchanges? (reference: warmup or full_sync)."""
        return self.phase == PHASE_SYNC or self.mode == "full_sync"

    @property
    def refresh(self) -> bool:
        """Does a stale step exchange its fresh activations for the next
        step?  Not under ``no_sync``, whose buffers stay warmup-stale."""
        return not (self.phase == PHASE_STALE and self.mode == "no_sync")

    def stale(self, name: str) -> torch.Tensor:
        buf = None if self.state_in is None else self.state_in.get(name)
        if buf is None:
            raise KeyError(
                f"no stale buffer for layer {name!r}: stale-phase steps must be "
                "seeded by a sync-phase step's buffers"
            )
        return buf

    def _claim(self, name: str, kind: str) -> None:
        if name in self._emitted:
            raise ValueError(f"duplicate state emission for layer {name!r}")
        self._emitted.add(name)
        self.kinds[name] = kind

    def emit(self, name: str, value: torch.Tensor, kind: str) -> None:
        """Record the freshly exchanged ``value`` as this layer's buffer."""
        self._claim(name, kind)
        self.state_out[name] = value

    # -- the refresh knobs ------------------------------------------------

    def _compress_for(self, kind: str) -> Optional[str]:
        """The compression mode of a refresh of this kind, or None when its
        payload goes out exact."""
        if self.compress == "none" or kind not in COMPRESS_KINDS:
            return None
        return self.compress

    def _partial_for(self, kind: str):
        """``(k, r)`` of a partial refresh of this kind, or None for a full
        one: the same kinds that compress thin."""
        k = refresh_period(self.refresh_fraction)
        if k <= 1 or kind not in COMPRESS_KINDS:
            return None
        if self.step is None:
            raise ValueError("partial refresh (refresh_fraction < 1) needs the "
                             "step index on PatchContext.step for its rotation")
        return k, self.step % k

    def refresh_reads_stale(self, kind: str) -> bool:
        """Does this step's refresh of ``kind`` read the previous buffer
        (residual coding, or the rows a partial refresh keeps)?  Then the op
        must leave that buffer as it was."""
        return self.refresh and (self._compress_for(kind) == "int8_residual"
                                 or self._partial_for(kind) is not None)

    def _take(self, name: str, x, k: int, r):
        """``take_every_kth`` of layer ``name``'s payload; a row count the
        period does not divide names the layer."""
        try:
            return take_every_kth(x, k, r)
        except ValueError as e:
            raise ValueError(f"layer {name!r}: {e}") from None

    # -- gathered refreshes (KV, GroupNorm moments) -----------------------

    def emit_refresh_gather(self, name: str, local: torch.Tensor, kind: str) -> None:
        """Start the all-gather of ``local`` over the patch group; its
        result ``[n, *local.shape]`` becomes this layer's next buffer —
        compressed, partial or deferred to ``flush`` as the knobs say."""
        self._claim(name, kind)
        mode = self._compress_for(kind)
        if self.batch_comm:  # DistriConfig keeps partial refresh out of here
            self._def_gather[name] = self._gather_record(name, local, mode)
            return
        partial = self._partial_for(kind)
        if partial is not None:
            self._partial_refresh_gather(name, local, mode, partial)
            return
        if mode is None:
            self.wire[name] = self.n * wire_nbytes(local.shape, local.element_size(), "none")
            self._pending[name] = collectives.all_gather(local, self.group, async_op=True)
            return
        rec = self._gather_record(name, local, mode)
        gq = collectives.all_gather(rec["q"], self.group, async_op=True)
        gs = collectives.all_gather(rec["s"], self.group, async_op=True)
        self._pending[name] = collectives.Pending(
            [], lambda: self._gather_value(rec, gq.wait(), gs.wait()))

    def _gather_record(self, name: str, local, mode: Optional[str]) -> Dict:
        """What one gather refresh sends: the raw tensor, or its payload and
        scales (against this rank's previous slot under residual coding),
        with its wire bytes registered (n x the local payload)."""
        self.wire[name] = self.n * wire_nbytes(local.shape, local.element_size(),
                                               mode or "none")
        if mode is None:
            return {"raw": local}
        src = local.float()
        prev = None
        if mode == "int8_residual":
            prev = self.stale(name)  # the same reconstruction on every peer
            src = src - prev[self.split_idx].float()
        q, s = _quantize(src, mode)
        return {"q": q, "s": s, "prev": prev, "dtype": local.dtype}

    @staticmethod
    def _gather_value(rec, gq, gs):
        new = _dequant(gq, gs)
        if rec["prev"] is not None:
            new = rec["prev"].float() + new
        return new.to(rec["dtype"])

    def _partial_refresh_gather(self, name: str, local, mode: Optional[str],
                                partial) -> None:
        """PCPP gather refresh: gather only rows {r, r+k, ...} of every
        rank's chunk and write them into the previous buffer; the other rows
        keep their previous reconstruction."""
        k, r = partial
        prev = self.stale(name)  # [n, B, L/n, C]
        sub = self._take(name, local, k, r)
        self.wire[name] = self.n * wire_nbytes(sub.shape, local.element_size(),
                                               mode or "none")
        if mode is None:
            g = collectives.all_gather(sub, self.group, async_op=True)
            self._pending[name] = collectives.Pending(
                [], lambda: scatter_every_kth(prev, g.wait(), k, r))
            return
        src = sub.float()
        if mode == "int8_residual":
            src = src - take_every_kth(prev[self.split_idx], k, r).float()
        q, s = _quantize(src, mode)
        gq = collectives.all_gather(q, self.group, async_op=True)
        gs = collectives.all_gather(s, self.group, async_op=True)

        def finish():
            new = _dequant(gq.wait(), gs.wait())
            if mode == "int8_residual":
                new = take_every_kth(prev, k, r).float() + new
            return scatter_every_kth(prev, new.to(local.dtype), k, r)

        self._pending[name] = collectives.Pending([], finish)

    # -- halo refreshes ---------------------------------------------------

    def emit_refresh_halos(self, name: str, x: torch.Tensor, halo: int) -> None:
        """Start the exchange of the boundary rows of ``x`` [B, h, W, C];
        the stacked ``[2, B, halo, W, C]`` (from previous, from next)
        becomes this layer's next buffer — compressed, partial or deferred
        as the knobs say."""
        self._claim(name, "conv2d")
        mode, partial = self._compress_for("conv2d"), self._partial_for("conv2d")
        if halo == 0 or self.n == 1:
            mode = partial = None  # nothing real moves
        top, bottom = x[:, :halo], x[:, x.shape[1] - halo:]
        if self.batch_comm:
            self._def_halo[name] = self._halo_record(name, top, bottom, mode)
            return
        if partial is not None:
            self._partial_refresh_halos(name, top, bottom, mode, partial)
            return
        if mode is None:
            self.wire[name] = 2 * wire_nbytes(top.shape, x.element_size(), "none")
            pending = collectives.halo_exchange(x, halo, self.group, async_op=True)
            self._pending[name] = collectives.Pending(
                [], lambda: torch.stack(pending.wait()))
            return
        rec = self._halo_record(name, top, bottom, mode)
        pq = collectives.exchange_boundary_rows(rec["q"][1], rec["q"][0], self.group,
                                                async_op=True)
        ps = collectives.exchange_boundary_rows(rec["s"][1], rec["s"][0], self.group,
                                                async_op=True)
        self._pending[name] = collectives.Pending(
            [], lambda: self._halo_value(rec, pq.wait(), ps.wait()))

    def _halo_record(self, name: str, top, bottom, mode: Optional[str]) -> Dict:
        """What one halo refresh sends (both boundary rows), with its wire
        bytes registered.  Under residual coding the sender's own-rows carry
        is refreshed with the reconstruction (previous rows plus the
        dequantized delta), never the raw rows: it must equal the base every
        receiver adds to, or the coding goes open-loop."""
        self.wire[name] = 2 * wire_nbytes(top.shape, top.element_size(), mode or "none")
        if mode is None:
            return {"raw": (top, bottom)}
        t, b = top.float(), bottom.float()
        prev = None
        if mode == "int8_residual":
            own = self.stale(name + OWN_SUFFIX)  # my previous [top, bottom]
            t, b = t - own[0].float(), b - own[1].float()
            prev = self.stale(name)  # what the receivers hold
        qt, st = _quantize(t, mode)
        qb, sb = _quantize(b, mode)
        if mode == "int8_residual":
            self._emit_own_halos(name, (own[0].float() + _dequant(qt, st)).to(top.dtype),
                                 (own[1].float() + _dequant(qb, sb)).to(top.dtype))
        return {"q": (qt, qb), "s": (st, sb), "prev": prev, "dtype": top.dtype}

    @staticmethod
    def _halo_value(rec, q, s):
        """The [2, B, halo, W, C] buffer from the exchanged payloads and
        scales ``(from_prev, from_next)`` of one compressed halo record."""
        halves = [_dequant(qi, si) for qi, si in zip(q, s)]
        if rec["prev"] is not None:
            halves = [rec["prev"][i].float() + h for i, h in enumerate(halves)]
        return torch.stack(halves).to(rec["dtype"])

    def _partial_refresh_halos(self, name: str, top, bottom, mode: Optional[str],
                               partial) -> None:
        """PCPP halo refresh: exchange only columns {r, r+k, ...} of the
        boundary rows (axis -2 of [B, halo, W, C]) and write them into the
        previous halos; residual coding keeps the own-rows carry in step by
        writing the same reconstructed columns into it."""
        k, r = partial
        prev = self.stale(name)  # [2, B, halo, W, C]
        sub_t, sub_b = self._take(name, top, k, r), self._take(name, bottom, k, r)
        self.wire[name] = 2 * wire_nbytes(sub_t.shape, top.element_size(), mode or "none")
        if mode is None:
            pending = collectives.exchange_boundary_rows(sub_b, sub_t, self.group,
                                                         async_op=True)
            self._pending[name] = collectives.Pending([], lambda: torch.stack(
                [scatter_every_kth(prev[i], h, k, r)
                 for i, h in enumerate(pending.wait())]))
            return
        t, b = sub_t.float(), sub_b.float()
        if mode == "int8_residual":
            own = self.stale(name + OWN_SUFFIX)
            own_t, own_b = (take_every_kth(o, k, r).float() for o in (own[0], own[1]))
            t, b = t - own_t, b - own_b
        qt, st = _quantize(t, mode)
        qb, sb = _quantize(b, mode)
        if mode == "int8_residual":
            self._emit_own_halos(
                name,
                scatter_every_kth(own[0], (own_t + _dequant(qt, st)).to(top.dtype), k, r),
                scatter_every_kth(own[1], (own_b + _dequant(qb, sb)).to(top.dtype), k, r))
        pq = collectives.exchange_boundary_rows(qb, qt, self.group, async_op=True)
        ps = collectives.exchange_boundary_rows(sb, st, self.group, async_op=True)

        def finish():
            halves = [_dequant(qi, si) for qi, si in zip(pq.wait(), ps.wait())]
            if mode == "int8_residual":
                halves = [take_every_kth(prev[i], k, r).float() + h
                          for i, h in enumerate(halves)]
            return torch.stack([scatter_every_kth(prev[i], h.to(top.dtype), k, r)
                                for i, h in enumerate(halves)])

        self._pending[name] = collectives.Pending([], finish)

    def _emit_own_halos(self, name: str, top, bottom) -> None:
        """Refresh the sender's own-rows carry of residual halo coding:
        kind "local", 0 bytes on the wire; nothing outside
        ``int8_residual``."""
        if self.compress != "int8_residual":
            return
        own = name + OWN_SUFFIX
        self.emit(own, torch.stack([top, bottom]), "local")
        self.wire[own] = 0

    def emit_sync_halos(self, name: str, x: torch.Tensor, halo: int):
        """Exchange fresh halos (blocking, exact), record them as this
        layer's buffer, seed the own-rows carry of residual coding, and
        return ``(from_prev, from_next)`` for the conv."""
        top, bottom = collectives.halo_exchange(x, halo, self.group)
        self.emit(name, torch.stack([top, bottom]), "conv2d")
        if self._compress_for("conv2d") is not None and halo and self.n > 1:
            self._emit_own_halos(name, x[:, :halo], x[:, x.shape[1] - halo:])
        return top, bottom

    # -- the end of the step ----------------------------------------------

    def flush(self) -> None:
        """Issue the refreshes ``batch_comm`` deferred: one flat all-gather
        per dtype over every layer's KV / moment payloads (a compressed
        layer's 8-bit payload and its float32 scales in their dtypes'
        batches) and one flat halo pair per dtype; ``finish`` splits them
        back into the per-layer buffers.  Nothing to do without deferred
        refreshes."""
        if self._def_gather:
            self._batches.append(self._flush_gathers(dict(self._def_gather)))
            self._def_gather.clear()
        if self._def_halo:
            self._batches.append(self._flush_halos(dict(self._def_halo)))
            self._def_halo.clear()

    def _flush_gathers(self, recs: Dict[str, Dict]):
        parts = []
        for name, rec in recs.items():
            if "raw" in rec:
                parts.append(((name, "raw"), rec["raw"]))
            else:
                parts += [((name, "q"), rec["q"]), ((name, "s"), rec["s"])]
        pending = collectives.batched_all_gather(parts, self.group, async_op=True)

        def finish():
            got = pending.wait()
            return {name: got[(name, "raw")] if "raw" in rec
                    else self._gather_value(rec, got[(name, "q")], got[(name, "s")])
                    for name, rec in recs.items()}

        return collectives.Pending([], finish)

    def _flush_halos(self, recs: Dict[str, Dict]):
        parts = []
        for name, rec in recs.items():
            if "raw" in rec:
                parts.append(((name, "raw"), *rec["raw"]))
            else:
                parts += [((name, "q"), *rec["q"]), ((name, "s"), *rec["s"])]
        pending = collectives.batched_halo_exchange(parts, self.group, async_op=True)

        def finish():
            got = pending.wait()
            return {name: torch.stack(got[(name, "raw")]) if "raw" in rec
                    else self._halo_value(rec, got[(name, "q")], got[(name, "s")])
                    for name, rec in recs.items()}

        return collectives.Pending([], finish)

    def carry_unconsumed(self) -> None:
        """Pass every buffer of ``state_in`` this step did not emit through
        to ``state_out`` unchanged (the same tensor), and record it in
        ``carried``: a shallow step of the step cache skips whole layers,
        and their buffers and the deep cache ride along.  Call after
        ``flush``."""
        assert not self._def_gather and not self._def_halo, (
            "carry_unconsumed must run after flush()")
        if self.state_in is None:
            return
        for name, value in self.state_in.items():
            if name not in self._emitted:
                self.state_out[name] = value
                self.carried.add(name)

    def finish(self) -> Dict[str, torch.Tensor]:
        """Drain the step's refreshes and return the next step's buffers:
        ``state_out``, or the unchanged ``state_in`` when the step emitted
        nothing (a ``no_sync`` stale step)."""
        self.flush()
        for name, pending in self._pending.items():
            self.state_out[name] = pending.wait()
        for pending in self._batches:
            self.state_out.update(pending.wait())
        self._pending.clear()
        self._batches.clear()
        if not self.state_out and self.state_in is not None:
            return self.state_in
        return self.state_out
