"""The per-step context of the displaced patch path and its stale buffers.

Counterpart of distrifuser_tpu/parallel/context.py (``PatchContext``,
``emit_refresh_gather``, ``emit_refresh_halos``, ``emit_sync_halos``).  The
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
``kinds`` records what each buffer is ("conv2d", "attn", "gn"), filled by
the op that emits it, for the runner's ``comm_volume_report``.  Refresh
compression, PCPP partial refresh and the batched flush of the JAX
context are ROADMAP queue 1 item 10.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from . import collectives

PHASE_SYNC = "sync"
PHASE_STALE = "stale"


@dataclasses.dataclass
class PatchContext:
    """What every patch op of one UNet evaluation reads: the patch count,
    the sync mode, the phase, this rank's patch index and process group,
    the buffers of the previous step and the cached text KV."""

    n: int  # ranks on the patch axis (n_device_per_batch)
    mode: str  # one of SYNC_MODES
    phase: str  # PHASE_SYNC | PHASE_STALE
    group: Any = None  # the batch_group: the n patch peers of one branch
    split_idx: int = 0
    state_in: Optional[Dict[str, torch.Tensor]] = None
    state_out: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    kinds: Dict[str, str] = dataclasses.field(default_factory=dict)
    text_kv: Optional[Dict[str, torch.Tensor]] = None
    _pending: Dict[str, Any] = dataclasses.field(default_factory=dict)

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
        if name in self.state_out or name in self._pending:
            raise ValueError(f"duplicate state emission for layer {name!r}")
        self.kinds[name] = kind

    def emit(self, name: str, value: torch.Tensor, kind: str) -> None:
        """Record the freshly exchanged ``value`` as this layer's buffer."""
        self._claim(name, kind)
        self.state_out[name] = value

    def emit_refresh_gather(self, name: str, local: torch.Tensor, kind: str) -> None:
        """Start the all-gather of ``local`` over the patch group; its
        result ``[n, *local.shape]`` becomes this layer's next buffer."""
        self._claim(name, kind)
        self._pending[name] = collectives.all_gather(local, self.group, async_op=True)

    def emit_refresh_halos(self, name: str, x: torch.Tensor, halo: int) -> None:
        """Start the exchange of the boundary rows of ``x`` [B, h, W, C];
        the stacked ``[2, B, halo, W, C]`` (from previous, from next)
        becomes this layer's next buffer."""
        self._claim(name, "conv2d")
        pending = collectives.halo_exchange(x, halo, self.group, async_op=True)
        self._pending[name] = collectives.Pending(
            [], lambda: torch.stack(pending.wait()))

    def emit_sync_halos(self, name: str, x: torch.Tensor, halo: int):
        """Exchange fresh halos (blocking), record them as this layer's
        buffer and return ``(from_prev, from_next)`` for the conv."""
        top, bottom = collectives.halo_exchange(x, halo, self.group)
        self.emit(name, torch.stack([top, bottom]), "conv2d")
        return top, bottom

    def finish(self) -> Dict[str, torch.Tensor]:
        """Drain the step's refreshes and return the next step's buffers:
        ``state_out``, or the unchanged ``state_in`` when the step emitted
        nothing (a ``no_sync`` stale step)."""
        for name, pending in self._pending.items():
            self.state_out[name] = pending.wait()
        self._pending.clear()
        if not self.state_out and self.state_in is not None:
            return self.state_in
        return self.state_out
