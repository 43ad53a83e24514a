"""Which collectives of a patch-path UNet evaluation can overlap its compute.

Counterpart of distrifuser_tpu/utils/overlap.py (``analyze_loop_collectives``).
The JAX package proves its claim from the compiled program: a stale step's
refresh is *deferred* when its value reaches only the loop carry, so the
scheduler may run it beside the rest of the step; it is *inline* when
something of the same step computes with it.  The port has no compiled
program to read.  Its collectives are issued and waited from Python, so
the same question is asked of the order in which that happens
(``record``):

* each collective (``collectives.Pending``) is recorded with the stage of
  the evaluation in which it was issued and the one in which its ``wait()``
  ran: ``forward`` (inside the UNet, from ``PatchContext``'s creation on),
  ``flush`` (``PatchContext.flush``, after the UNet returned), ``finish``
  (``PatchContext.finish``, which drains the step's refreshes) or
  ``after`` (the output gather, the CFG combine);
* a collective that ``PatchContext`` issues for a layer's buffer carries
  that buffer's name and kind ("conv2d" halos, "attn" KV, "gn" moments;
  every layer of a batched flush); the others (a ring hop, the output
  gather) carry none;
* the verdict (``Collective.verdict``): **deferred** when it was issued
  inside the forward and nothing waited for it before the forward
  returned (layers after it run between issue and wait); **flushed** when
  it was issued by ``flush``, after the forward, and waited in ``finish``
  with no compute between; **inline** otherwise (waited in the stage that
  issued it: what follows computes with it).

On a card under CUDA graphs the same order holds in every replay: a wait
becomes a stream dependency where the Python ``wait()`` ran at capture.
How much of a deferred refresh the card actually hides is a device-time
question (``chip_smoke.py --patch_only --profile``).  Recording costs
nothing when no ``record`` is active: the hooks return at once.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

FORWARD, FLUSH, FINISH, AFTER = "forward", "flush", "finish", "after"


@dataclasses.dataclass
class Collective:
    """One issued collective: what it was, which buffers it writes, and the
    stages of its issue and of its wait (None if never waited)."""

    op: str  # "all_gather", "halo", "ring_shift", "all_to_all" or "all_reduce"
    names: Tuple[str, ...]
    kinds: Tuple[str, ...]
    issued: str
    waited: Optional[str] = None

    @property
    def verdict(self) -> str:
        if self.issued == FORWARD and self.waited == FINISH:
            return "deferred"
        if self.issued == FLUSH and self.waited == FINISH:
            return "flushed"
        return "inline"

    def as_dict(self) -> Dict:
        return {"op": self.op, "names": list(self.names), "kinds": list(self.kinds),
                "issued": self.issued, "waited": self.waited, "verdict": self.verdict}


@dataclasses.dataclass
class Evaluation:
    """The collectives of one UNet evaluation, in issue order (the
    collectives after its ``finish`` up to the next evaluation too)."""

    phase: str
    collectives: List[Collective] = dataclasses.field(default_factory=list)


class _Recorder:
    def __init__(self):
        self.evaluations: List[Evaluation] = []
        self.stage = AFTER
        self.label: Tuple[Tuple[str, ...], Tuple[str, ...]] = ((), ())


_ACTIVE: Optional[_Recorder] = None


@contextlib.contextmanager
def record():
    """Record the collectives of every patch-path evaluation run inside the
    block; yields the list of ``Evaluation``, filled as they run."""
    global _ACTIVE
    previous, _ACTIVE = _ACTIVE, _Recorder()
    try:
        yield _ACTIVE.evaluations
    finally:
        _ACTIVE = previous


def begin(phase: str) -> None:
    """A UNet evaluation starts (``PatchContext`` is created)."""
    if _ACTIVE is not None:
        _ACTIVE.evaluations.append(Evaluation(phase))
        _ACTIVE.stage = FORWARD


def enter(stage: str) -> Optional[str]:
    """The evaluation enters ``stage``; returns the stage it left."""
    if _ACTIVE is None:
        return None
    previous, _ACTIVE.stage = _ACTIVE.stage, stage
    return previous


@contextlib.contextmanager
def buffers(names, kinds):
    """Collectives issued inside the block exchange these layers' buffers."""
    if _ACTIVE is None:
        yield
        return
    previous, _ACTIVE.label = _ACTIVE.label, (tuple(names), tuple(kinds))
    try:
        yield
    finally:
        _ACTIVE.label = previous


def issued(op: str) -> Optional[Collective]:
    """A collective was issued: its record, or None when not recording."""
    if _ACTIVE is None or not _ACTIVE.evaluations:
        return None
    names, kinds = _ACTIVE.label
    rec = Collective(op, names, kinds, _ACTIVE.stage)
    _ACTIVE.evaluations[-1].collectives.append(rec)
    return rec


def waited(rec: Optional[Collective]) -> None:
    """The collective of ``rec`` was waited for (the first wait counts)."""
    if rec is not None and rec.waited is None and _ACTIVE is not None:
        rec.waited = _ACTIVE.stage
