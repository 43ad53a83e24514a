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
  and dequantizes on arrival; "int8_residual" codes the delta against the
  previous reconstruction the buffers already hold, closed-loop, so the
  error does not accumulate.  A halo's sender keeps its own previous rows
  for that (``OWN_SUFFIX``, kind "local", free on the wire).  The codec of
  ops/quantize.py does all of it: one ``quantize_rows_grouped`` encodes a
  payload straight from the activation (the residual base and the partial
  refresh's rows folded in, a halo's two boundary slabs read in place) into
  one flat byte buffer of payloads then scales, which one collective
  moves; one ``dequantize_rows_grouped`` decodes it into the next step's
  new buffer (the kept rows of a partial refresh, the residual base, both
  halves of a halo and the sender's own rows of residual halo coding);
* ``refresh_fraction`` 1/k refreshes only rows {r, r+k, ...} of every
  payload, ``r = step % k`` (KV token rows, halo columns); ``step`` may be
  a device tensor, so one captured graph serves every rotation;
* ``batch_comm`` defers every refresh of the step to ``flush``: one flat
  all-gather per dtype and one flat halo pair for the exact payloads, and
  for the compressed ones one encode launch, one flat all-gather, one flat
  halo pair and one decode launch for the whole step, bit for bit the
  values the per-layer exchanges give.

Three per-context dicts replace the JAX package's process-wide registries
and are read by the runner's ``comm_volume_report``: ``kinds`` (what each
buffer is: "conv2d", "attn", "gn", "stepcache" or "local"), ``wire`` (the
bytes each exchange put on the wire) and ``carried`` (the buffers a step
passed through untouched, ``carry_unconsumed``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Set, Tuple

import torch

from ..ops.quantize import (DecodeSeg, EncodeSeg, dequantize_rows_grouped, payload_shape,
                            quantize_rows_grouped)
from . import collectives, overlap
from .compress import (COMPRESS_KINDS, payload_mode, refresh_period, scatter_every_kth,
                       take_every_kth, wire_nbytes)

PHASE_SYNC = "sync"
PHASE_STALE = "stale"
# the sender-side own boundary rows that "int8_residual" halos code against
OWN_SUFFIX = "#own"
_PAYLOAD_DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


@dataclasses.dataclass
class _Coded:
    """One compressed refresh: what the encoder reads (``enc``: the source
    rows, the residual base, the partial refresh's rotation) and what the
    decoder adds to (``base``), keeps rows of (``prev``) and, for a residual
    halo, reconstructs the sender's own rows from (``own``)."""

    name: str
    halo: bool  # a halo pair (two parts) or one all-gathered payload
    enc: EncodeSeg
    shape: Tuple[int, ...]  # the payload of one part
    base: Optional[torch.Tensor]
    prev: Optional[torch.Tensor]
    own: Optional[torch.Tensor]
    dtype: torch.dtype
    halves: int = 1  # column halves of a row, each scaled on its own


def _layout(shapes):
    """Byte offsets of each payload and scale block in a flat buffer that
    holds every payload, then (4-byte aligned) every float32 scale; and its
    size."""
    q_off, off = [], 0
    for shape in shapes:
        q_off.append(off)
        off += math.prod(shape)
    off = -(-off // 4) * 4
    s_off = []
    for shape in shapes:
        s_off.append(off)
        off += 4 * math.prod(shape[:-1])
    return list(zip(q_off, s_off)), off


def _views(buf, offsets, shape, dtype):
    """The payload [..., *shape] and scale [..., *shape[:-1]] views of one
    payload in the flat byte buffer ``buf`` [..., total]."""
    q_off, s_off = offsets
    n = math.prod(shape)
    q = buf[..., q_off:q_off + n].view(dtype).unflatten(-1, shape)
    s = buf[..., s_off:s_off + 4 * (n // shape[-1])].view(torch.float32)
    return q, s.unflatten(-1, shape[:-1])


def _halves(t, halves: int):
    """The ``halves`` column halves of t [..., halves * C] as the parts of
    one view [halves, 1, ..., C] (None stays None): no copy."""
    if t is None:
        return None
    return t.unflatten(-1, (halves, t.shape[-1] // halves)).movedim(-2, 0).unsqueeze(1)


def _half(t, h: int, halves: int):
    """Column half ``h`` of t [n, ..., halves * C] as [n, 1, ..., C] (None
    stays None): a view."""
    if t is None:
        return None
    c = t.shape[-1] // halves
    return t[..., h * c:(h + 1) * c].unsqueeze(1)


def _halo_slabs(x, halo: int):
    """``x[:, :halo]`` and ``x[:, h - halo:]`` of x [B, h, W, C] as the two
    parts of one strided view [2, B, halo, W, C]: no copy."""
    return x.as_strided((2, x.shape[0], halo, *x.shape[2:]),
                        (x.stride(1) * (x.shape[1] - halo), *x.stride()),
                        x.storage_offset())


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
    # issued exchanges, each finishing into {buffer name: next buffer}
    _pending: List[collectives.Pending] = dataclasses.field(default_factory=list)
    # what batch_comm defers to flush: exact gathers and halo pairs, and
    # compressed refreshes
    _def_gather: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    _def_halo: Dict[str, Tuple] = dataclasses.field(default_factory=dict)
    _def_coded: List[_Coded] = dataclasses.field(default_factory=list)

    def __post_init__(self) -> None:
        overlap.begin(self.phase)

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

    def _payload_shape(self, name: str, shape, partial):
        """The payload shape of layer ``name``'s rows of ``shape`` (thinned by
        a partial refresh); a row count the period does not divide names
        the layer."""
        try:
            return payload_shape(shape, partial)
        except ValueError as e:
            raise ValueError(f"layer {name!r}: {e}") from None

    def _take(self, name: str, x, k: int, r):
        """``take_every_kth`` of layer ``name``'s exact payload."""
        self._payload_shape(name, x.shape, (k, r))
        return take_every_kth(x, k, r)

    # -- the compressed refreshes: one encode and one decode launch --------

    def _gather_coded(self, name: str, local, mode: str, partial, halves: int) -> _Coded:
        """A compressed gather refresh of ``local`` (against this rank's
        previous slot under residual coding), its wire bytes registered (n x
        the local payload).  With ``halves`` = 2 each row's two column
        halves (a fused KV row's k and v) are coded as rows of their own,
        read in place: the payload is [2, 1, *local[:-1], C / 2]."""
        residual = mode == "int8_residual"
        prev = self.stale(name) if residual or partial is not None else None  # [n, *local]
        own = prev[self.split_idx] if residual else None
        if halves > 1:
            local, own = _halves(local, halves), _halves(own, halves)
        shape = self._payload_shape(name, local.shape, partial)
        self.wire[name] = self.n * wire_nbytes(shape, local.element_size(), mode)
        return _Coded(name, False, EncodeSeg(local, own, partial), shape,
                      prev if residual else None, prev if partial is not None else None,
                      None, local.dtype, halves)

    def _halo_coded(self, name: str, x, halo: int, mode: str, partial) -> _Coded:
        """A compressed halo refresh of the boundary rows of ``x``, its wire
        bytes registered.  Under residual coding the sender's own-rows carry
        is refreshed with the reconstruction (previous rows plus the
        decoded delta), never the raw rows: it must equal the base every
        receiver adds to, or the coding goes open-loop."""
        residual = mode == "int8_residual"
        slabs = _halo_slabs(x, halo)  # [2, B, halo, W, C]: top, bottom
        shape = self._payload_shape(name, slabs.shape[1:], partial)
        self.wire[name] = 2 * wire_nbytes(shape, x.element_size(), mode)
        own = prev = None
        if residual:
            own = self.stale(name + OWN_SUFFIX)  # my previous [top, bottom]
            self._claim(name + OWN_SUFFIX, "local")
            self.wire[name + OWN_SUFFIX] = 0
        if residual or partial is not None:
            prev = self.stale(name)  # [2, B, halo, W, C]: what the receivers hold
        return _Coded(name, True, EncodeSeg(slabs, own, partial), shape,
                      prev if residual else None, prev if partial is not None else None,
                      own, x.dtype)

    def _issue_coded(self, recs: List[_Coded]) -> collectives.Pending:
        """Encode ``recs`` in one launch into a flat send buffer (gathers) and
        a flat pair (halos: top payloads, bottom payloads), issue one
        all-gather and one halo exchange, and decode everything that arrives
        in one launch when the step ends."""
        mode = payload_mode(self.compress)
        pdt = _PAYLOAD_DTYPES[mode]
        gathers = [r for r in recs if not r.halo]
        halos = [r for r in recs if r.halo]
        device = recs[0].enc.x.device
        g_off, g_total = _layout([r.shape for r in gathers])
        h_off, h_total = _layout([r.shape for r in halos])
        g_buf = torch.empty((g_total,), dtype=torch.uint8, device=device) if gathers else None
        h_buf = torch.empty((2, h_total), dtype=torch.uint8, device=device) if halos else None
        g_out = [_views(g_buf, o, r.shape, pdt) for r, o in zip(gathers, g_off)]
        h_out = [_views(h_buf, o, r.shape, pdt) for r, o in zip(halos, h_off)]
        quantize_rows_grouped([r.enc._replace(out=out) for r, out in
                               zip(gathers + halos, g_out + h_out)], mode)
        pg = collectives.all_gather(g_buf, self.group, async_op=True) if gathers else None
        ph = (collectives.exchange_boundary_rows(h_buf[1], h_buf[0], self.group,
                                                 async_op=True) if halos else None)

        def finish():
            names, segs = [], []
            if gathers:
                got = pg.wait()  # [n, g_total]
                for r, o in zip(gathers, g_off):
                    q, s = _views(got, o, r.shape, pdt)
                    if r.halves == 1:
                        names.append(r.name)
                        segs.append(DecodeSeg(q, s, r.base, r.prev, r.enc.every))
                        continue
                    for h in range(r.halves):  # each half into a buffer of its own
                        names.append((r.name, h))
                        segs.append(DecodeSeg(q[:, h], s[:, h], _half(r.base, h, r.halves),
                                              _half(r.prev, h, r.halves), r.enc.every))
            if halos:
                arrived = ph.wait()  # (from previous, from next)
                for r, o, (own_q, own_s) in zip(halos, h_off, h_out):
                    q, s = zip(*(_views(b, o, r.shape, pdt) for b in arrived))
                    names.append(r.name)
                    segs.append(DecodeSeg(list(q), list(s), r.base, r.prev, r.enc.every))
                    if r.own is not None:
                        names.append(r.name + OWN_SUFFIX)
                        segs.append(DecodeSeg(own_q, own_s, r.own,
                                              r.own if r.enc.every is not None else None,
                                              r.enc.every))
            done, halves = {}, {}
            for name, buf in zip(names, dequantize_rows_grouped(segs, recs[0].dtype)):
                if isinstance(name, tuple):
                    halves.setdefault(name[0], []).append(buf.squeeze(1))
                else:
                    done[name] = buf
            # the decoder writes whole rows of a new buffer: the halves join
            # into the fused rows in one more pass
            done.update({name: torch.cat(parts, dim=-1) for name, parts in halves.items()})
            return done

        return collectives.Pending([], finish)

    # -- gathered refreshes (KV, GroupNorm moments) -----------------------

    def emit_refresh_gather(self, name: str, local: torch.Tensor, kind: str,
                            halves: int = 1) -> None:
        """Start the all-gather of ``local`` over the patch group; its
        result ``[n, *local.shape]`` becomes this layer's next buffer —
        compressed, partial or deferred to ``flush`` as the knobs say.
        ``halves`` = 2 gives a compressed payload one scale per column half
        of a row (the transformers' fused KV: one per k row and one per v
        row, as the JAX package codes ``stack([k, v])``); 1 one scale per
        row (the UNet's)."""
        self._claim(name, kind)
        with overlap.buffers([name], [kind]):
            self._refresh_gather(name, local, kind, halves)

    def _refresh_gather(self, name: str, local: torch.Tensor, kind: str,
                        halves: int) -> None:
        mode = self._compress_for(kind)
        partial = None if self.batch_comm else self._partial_for(kind)
        # (DistriConfig keeps partial refresh out of batch_comm)
        if mode is not None:
            rec = self._gather_coded(name, local, mode, partial, halves)
            if self.batch_comm:
                self._def_coded.append(rec)
            else:
                self._pending.append(self._issue_coded([rec]))
            return
        if self.batch_comm:
            self.wire[name] = self.n * wire_nbytes(local.shape, local.element_size(), "none")
            self._def_gather[name] = local
            return
        if partial is not None:
            self._partial_refresh_gather(name, local, partial)
            return
        self.wire[name] = self.n * wire_nbytes(local.shape, local.element_size(), "none")
        pending = collectives.all_gather(local, self.group, async_op=True)
        self._pending.append(collectives.Pending([], lambda: {name: pending.wait()}))

    def _partial_refresh_gather(self, name: str, local, partial) -> None:
        """Exact PCPP gather refresh: gather only rows {r, r+k, ...} of
        every rank's chunk and write them into the previous buffer; the
        other rows keep their previous values."""
        k, r = partial
        prev = self.stale(name)  # [n, B, L/n, C]
        sub = self._take(name, local, k, r)
        self.wire[name] = self.n * wire_nbytes(sub.shape, local.element_size(), "none")
        g = collectives.all_gather(sub, self.group, async_op=True)
        self._pending.append(collectives.Pending(
            [], lambda: {name: scatter_every_kth(prev, g.wait(), k, r)}))

    # -- halo refreshes ---------------------------------------------------

    def emit_refresh_halos(self, name: str, x: torch.Tensor, halo: int) -> None:
        """Start the exchange of the boundary rows of ``x`` [B, h, W, C];
        the stacked ``[2, B, halo, W, C]`` (from previous, from next)
        becomes this layer's next buffer — compressed, partial or deferred
        as the knobs say."""
        self._claim(name, "conv2d")
        with overlap.buffers([name], ["conv2d"]):
            self._refresh_halos(name, x, halo)

    def _refresh_halos(self, name: str, x: torch.Tensor, halo: int) -> None:
        mode, partial = self._compress_for("conv2d"), self._partial_for("conv2d")
        if halo == 0 or self.n == 1:
            mode = partial = None  # nothing real moves
        if mode is not None:
            rec = self._halo_coded(name, x, halo, mode, partial)
            if self.batch_comm:
                self._def_coded.append(rec)
            else:
                self._pending.append(self._issue_coded([rec]))
            return
        top, bottom = x[:, :halo], x[:, x.shape[1] - halo:]
        if partial is not None:
            self._partial_refresh_halos(name, top, bottom, partial)
            return
        self.wire[name] = 2 * wire_nbytes(top.shape, x.element_size(), "none")
        if self.batch_comm:
            self._def_halo[name] = (top, bottom)
            return
        pending = collectives.halo_exchange(x, halo, self.group, async_op=True)
        self._pending.append(collectives.Pending(
            [], lambda: {name: torch.stack(pending.wait())}))

    def _partial_refresh_halos(self, name: str, top, bottom, partial) -> None:
        """Exact PCPP halo refresh: exchange only columns {r, r+k, ...} of
        the boundary rows (axis -2 of [B, halo, W, C]) and write them into
        the previous halos."""
        k, r = partial
        prev = self.stale(name)  # [2, B, halo, W, C]
        sub_t, sub_b = self._take(name, top, k, r), self._take(name, bottom, k, r)
        self.wire[name] = 2 * wire_nbytes(sub_t.shape, top.element_size(), "none")
        pending = collectives.exchange_boundary_rows(sub_b, sub_t, self.group,
                                                     async_op=True)
        self._pending.append(collectives.Pending([], lambda: {name: torch.stack(
            [scatter_every_kth(prev[i], h, k, r) for i, h in enumerate(pending.wait())])}))

    def _emit_own_halos(self, name: str, top, bottom) -> None:
        """Seed the sender's own-rows carry of residual halo coding: kind
        "local", 0 bytes on the wire; nothing outside ``int8_residual``."""
        if self.compress != "int8_residual":
            return
        own = name + OWN_SUFFIX
        self.emit(own, torch.stack([top, bottom]), "local")
        self.wire[own] = 0

    def emit_sync_halos(self, name: str, x: torch.Tensor, halo: int):
        """Exchange fresh halos (blocking, exact), record them as this
        layer's buffer, seed the own-rows carry of residual coding, and
        return ``(from_prev, from_next)`` for the conv."""
        with overlap.buffers([name], ["conv2d"]):
            top, bottom = collectives.halo_exchange(x, halo, self.group)
        self.emit(name, torch.stack([top, bottom]), "conv2d")
        if self._compress_for("conv2d") is not None and halo and self.n > 1:
            self._emit_own_halos(name, x[:, :halo], x[:, x.shape[1] - halo:])
        return top, bottom

    def emit_sync_gather(self, name: str, local: torch.Tensor, kind: str) -> torch.Tensor:
        """All-gather ``local`` over the patch group (blocking, exact), record
        the ``[n, *local.shape]`` result as this layer's buffer and return
        it."""
        with overlap.buffers([name], [kind]):
            gathered = collectives.all_gather(local, self.group)
        self.emit(name, gathered, kind)
        return gathered

    # -- the end of the step ----------------------------------------------

    def flush(self) -> None:
        """Issue the refreshes ``batch_comm`` deferred: one flat all-gather
        per dtype over every layer's exact KV / moment payloads and one flat
        halo pair per dtype, and the compressed ones through one encode
        launch, one flat all-gather and one flat halo pair; ``finish``
        splits them back into the per-layer buffers (the compressed ones in
        one decode launch).  Nothing to do without deferred refreshes."""
        if not (self._def_gather or self._def_halo or self._def_coded):
            return
        previous = overlap.enter(overlap.FLUSH)
        if self._def_gather:
            parts = list(self._def_gather.items())
            with self._labelled(self._def_gather):
                pending = collectives.batched_all_gather(parts, self.group, async_op=True)
            self._pending.append(pending)
            self._def_gather.clear()
        if self._def_halo:
            parts = [(name, top, bottom) for name, (top, bottom) in self._def_halo.items()]
            with self._labelled(self._def_halo):
                pending = collectives.batched_halo_exchange(parts, self.group, async_op=True)
            self._pending.append(collectives.Pending([], lambda: {
                name: torch.stack(pair) for name, pair in pending.wait().items()}))
            self._def_halo.clear()
        if self._def_coded:
            with self._labelled([r.name for r in self._def_coded]):
                self._pending.append(self._issue_coded(self._def_coded))
            self._def_coded = []
        overlap.enter(previous)

    def _labelled(self, names):
        """parallel/overlap.py's label of a batched exchange of these
        layers' buffers."""
        names = list(names)
        return overlap.buffers(names, [self.kinds[name] for name in names])

    def carry_unconsumed(self) -> None:
        """Pass every buffer of ``state_in`` this step did not emit through
        to ``state_out`` unchanged (the same tensor), and record it in
        ``carried``: a shallow step of the step cache skips whole layers,
        and their buffers and the deep cache ride along.  Call after
        ``flush``."""
        assert not (self._def_gather or self._def_halo or self._def_coded), (
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
        overlap.enter(overlap.FINISH)
        self.flush()
        for pending in self._pending:
            self.state_out.update(pending.wait())
        self._pending.clear()
        overlap.enter(overlap.AFTER)
        if not self.state_out and self.state_in is not None:
            return self.state_in
        return self.state_out
