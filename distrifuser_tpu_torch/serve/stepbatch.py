"""Step-level continuous batching: the slot pool behind
``ServeConfig.step_batching``.

Counterpart of distrifuser_tpu/serve/stepbatch.py (``SlotState``,
``StepBatcher``), the same policy line for line.  The whole-batch
scheduler (serve/batcher.py) coalesces requests and then the batch OWNS
the card for its entire denoise loop -- a new request waits out up to 50
steps of someone else's generation, so under load the tail is
batch-shaped, not request-shaped.  Here the denoise loop becomes a slot
pool of per-request state:

* each slot holds one request's explicit stepwise carry (the runners'
  ``stepwise_carry_init`` / ``stepwise_carry_step``: latent, scheduler
  state and step-cache / patch buffers) and its step index;
* **between any two steps** the scheduler admits queued requests into
  free slots and retires finished ones -- a request joins the in-flight
  denoise within ~one step of arriving instead of one batch;
* the step cohort is ordered by **deadline slack** -- EDF over
  ``remaining_steps x calibrated per-step service`` (the SLO
  controller's calibration when it is on, a local EWMA of the round time
  otherwise); with ``step_width`` below the pool size this is true
  per-round step reordering, not just admission order;
* an arriving request that would miss its deadline can **preempt** the
  slackest occupied slot: the victim's carry is parked to HOST memory
  (freeing its device residency) and later resumes **bit-identically**
  -- the explicit carry replays the identical per-step evaluations in the
  identical order, so who joined or left around a request can never
  touch its numerics;
* every K steps an occupied slot emits a **progressive preview** (cheap
  host-side downsampled latent) through the request's ``on_progress``
  callback, traced as its own span.

Correctness bar (tests/test_torch_port_stepbatch.py, and on the card
``chip_smoke.py``'s step phase): each request's final image is
byte-identical across solo, joined-mid-flight, packed and
preempted-and-resumed executions at the same (prompt, seed, steps), and
equal to a solo monolithic call of the same stepwise pipeline.

Thread model: the ENTIRE slot pool -- slots, parked list, calibration --
is owned by the server's single scheduler thread (`InferenceServer._loop`
drives `_step_round`); cross-thread reads (gauges, snapshots) are plain
snapshot reads, like the rest of the serve metrics.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

from ..utils.config import StepBatchConfig
from .cache import ExecKey
from .queue import Request


@dataclasses.dataclass
class SlotState:
    """One resident request's step-granular execution state.

    ``work`` is the executor-opaque per-request denoise state (the
    explicit carry + encoded prompt for real pipelines; a dict for the
    fakes).  ``steps_done`` is the batcher's view of progress and always
    equals the executor's internal step index -- the two advance together
    in `step_run`.
    """

    request: Request
    work: Any
    base_key: ExecKey   # pre-ladder key (resilience bookkeeping identity)
    ekey: ExecKey       # the key actually executing (post-ladder)
    executor: Any
    compile_hit: bool
    steps_total: int
    steps_done: int = 0
    tier_idx: Optional[int] = None
    admit_ts: float = 0.0
    slot: int = -1          # occupied slot index; -1 while parked
    parked: bool = False
    preempts: int = 0
    previews: int = 0
    first_preview_s: Optional[float] = None
    # carry migration (serve/migration.py): set at admission when this
    # state resumed from an imported snapshot -- how many imports the
    # request has survived and how many completed steps they salvaged
    # (steps_done starts at the salvaged step, never 0).  Surfaced on
    # `ServeResult.migrations` / ``steps_salvaged``.
    migrations: int = 0
    steps_salvaged: int = 0

    @property
    def remaining(self) -> int:
        return max(0, self.steps_total - self.steps_done)

    @property
    def tenant(self) -> str:
        """Fairness identity of the resident request (the JAX package's
        per-tenant occupancy gauges group slots by it)."""
        return self.request.tenant


class StepBatcher:
    """Slot-pool bookkeeping + EDF/preemption policy (no I/O here: the
    server performs executor calls and future resolution; this class
    answers "who steps next, who joins, who parks").

    ``step_estimate`` (optional callable -> seconds or None) is the
    calibrated per-step service source (the JAX package's SLO controller
    supplies one); without it the local EWMA, seeded from
    ``config.step_service_prior_s``.
    """

    def __init__(self, config: StepBatchConfig,
                 clock: Callable[[], float],
                 step_estimate: Optional[Callable[[], Optional[float]]] = None,
                 pack_signature: Optional[Callable[[SlotState], Any]] = None):
        self.config = config
        self.clock = clock
        self._slots: List[Optional[SlotState]] = [None] * config.slots
        self._parked: List[SlotState] = []
        self._ewma: Optional[float] = None
        self._round_s_total = 0.0
        self._rounds_timed = 0
        self._step_estimate = step_estimate
        # pack-compatibility key of a state's next step (the executor's
        # `step_signature`; None = sequential-only) -- lets a width-
        # truncated cohort prefer slots that share the tightest state's
        # packed dispatch (config.pack_align)
        self._pack_signature = pack_signature
        # lifetime counters (scheduler-thread writes; snapshot reads)
        self.joins = 0
        self.leaves = 0
        self.preempt_count = 0
        self.resumes = 0
        self.rounds = 0
        self.pack_aligned = 0

    # -- pool accounting ---------------------------------------------------

    def occupied(self) -> List[SlotState]:
        return [s for s in self._slots if s is not None]

    @property
    def parked(self) -> List[SlotState]:
        return self._parked

    def free_slots(self) -> int:
        return sum(1 for s in self._slots if s is None)

    def admit(self, state: SlotState, _count_join: bool = True) -> int:
        """Place a state into a free slot (caller guarantees one)."""
        for i, s in enumerate(self._slots):
            if s is None:
                state.slot = i
                state.parked = False
                self._slots[i] = state
                if _count_join:
                    self.joins += 1
                return i
        raise AssertionError("admit() without a free slot")

    def remove(self, state: SlotState) -> None:
        """Retire a state from wherever it lives (slot or parked list) —
        completion, failure, cancel, deadline, stop all come through
        here, so the leave counter is the single source of truth."""
        if state.parked:
            self._parked = [p for p in self._parked if p is not state]
        elif 0 <= state.slot < len(self._slots) \
                and self._slots[state.slot] is state:
            self._slots[state.slot] = None
        state.slot = -1
        self.leaves += 1

    def park(self, state: SlotState) -> None:
        """Move an occupied state to the parked list (preemption): its
        slot frees for the preemptor; the carry resumes bit-identically
        later."""
        assert not state.parked and self._slots[state.slot] is state
        self._slots[state.slot] = None
        state.slot = -1
        state.parked = True
        state.preempts += 1
        self._parked.append(state)
        self.preempt_count += 1

    def unpark(self, state: SlotState) -> int:
        """Resume a parked state into a free slot (caller guarantees
        one).  Counts a resume, not a join -- the request never left."""
        assert state.parked
        self._parked = [p for p in self._parked if p is not state]
        state.parked = False
        self.resumes += 1
        return self.admit(state, _count_join=False)

    # -- calibrated per-step service ---------------------------------------

    def note_round(self, dt: float) -> None:
        """Record one cohort step's wall time (the EDF clock unit: one
        scheduling round advances each cohort member one step).  The
        EWMA is deliberately recency-weighted -- scheduling wants the
        CURRENT round cost; ``round_s_mean`` keeps the unweighted run
        mean for benches/gates."""
        if dt <= 0:
            return
        self._ewma = (dt if self._ewma is None
                      else 0.8 * self._ewma + 0.2 * dt)
        self._round_s_total += dt
        self._rounds_timed += 1

    def per_step_s(self) -> float:
        if self._step_estimate is not None:
            est = self._step_estimate()
            if est is not None and est > 0:
                return float(est)
        if self._ewma is not None:
            return self._ewma
        return float(self.config.step_service_prior_s)

    # -- EDF policy --------------------------------------------------------

    def slack(self, deadline: float, remaining_steps: int,
              now: float) -> float:
        """Deadline slack: time to deadline minus predicted remaining
        service (remaining steps x calibrated per-step service).  The
        EDF ordering key -- smaller = tighter."""
        return (deadline - now) - remaining_steps * self.per_step_s()

    def state_slack(self, state: SlotState, now: float) -> float:
        return self.slack(state.request.deadline, state.remaining, now)

    def request_slack(self, req: Request, now: float) -> float:
        return self.slack(req.deadline, req.num_inference_steps, now)

    def cohort(self, now: float) -> List[SlotState]:
        """The slots advancing this round: occupied states in ascending
        slack order (EDF), truncated to ``step_width`` (0 = all).

        With ``config.pack_align`` on and a pack-signature source wired
        (the executor's `step_signature`), a TRUNCATED cohort prefers
        slots that share the tightest state's packed dispatch: the EDF
        head always runs, same-signature slots fill the width next (in
        EDF order), and any remaining width goes to the tightest of the
        rest -- so the width the scheduler pays for packs into the fewest
        dispatches without ever skipping the tightest request.  Relative
        EDF order within the selection is preserved."""
        live = sorted(self.occupied(),
                      key=lambda s: self.state_slack(s, now))
        width = self.config.step_width
        if not width or len(live) <= width:
            return live
        if not self.config.pack_align or self._pack_signature is None:
            return live[:width]
        anchor_sig = self._sig_of(live[0])
        if anchor_sig is None:
            return live[:width]
        chosen = [True] + [False] * (len(live) - 1)
        taken = 1
        for i, s in enumerate(live[1:], start=1):
            if taken >= width:
                break
            if self._sig_of(s) == anchor_sig:
                chosen[i] = True
                taken += 1
        for i in range(1, len(live)):
            if taken >= width:
                break
            if not chosen[i]:
                chosen[i] = True
                taken += 1
        selection = [s for s, c in zip(live, chosen) if c]
        if selection != live[:width]:
            self.pack_aligned += 1
        return selection

    def _sig_of(self, state: SlotState) -> Any:
        """The state's pack signature, or None when unavailable (fakes
        without the hook, sequential-only configs, errors)."""
        try:
            return self._pack_signature(state)
        except Exception:  # noqa: BLE001 -- alignment is best-effort
            return None

    def pick_victim(self, newcomer_slack: float,
                    now: float) -> Optional[SlotState]:
        """The occupied state to park so a tighter request can run:
        the MOST-slack slot, and only when parking is strictly better
        than waiting -- the victim must have more room than the newcomer
        by ``preempt_margin_s``, positive slack of its own (parking must
        not create a new miss), and no prior preemption (no thrash: a
        once-parked request is never parked again)."""
        if not self.config.allow_preemption:
            return None
        best: Optional[SlotState] = None
        best_slack = None
        for s in self.occupied():
            if s.preempts or s.remaining == 0:
                continue
            sl = self.state_slack(s, now)
            if best_slack is None or sl > best_slack:
                best, best_slack = s, sl
        if best is None or best_slack <= 0:
            return None
        if best_slack <= newcomer_slack + self.config.preempt_margin_s:
            return None
        return best

    # -- observability -----------------------------------------------------

    def remaining_steps_total(self) -> int:
        return (sum(s.remaining for s in self.occupied())
                + sum(s.remaining for s in self._parked))

    def occupied_by_tenant(self) -> Dict[str, int]:
        """Occupied-slot count per tenant (parked excluded -- a parked
        request holds no device residency).  The per-tenant occupancy
        gauges read this through the snapshot-read policy."""
        counts: Dict[str, int] = {}
        for s in self.occupied():
            counts[s.tenant] = counts.get(s.tenant, 0) + 1
        return counts

    def snapshot(self) -> Dict[str, Any]:
        """JSON state for ``metrics_snapshot()["step_batching"]`` and the
        ``slo_snapshot()["step"]`` occupancy block the controller reads."""
        occ = self.occupied()
        return {
            "slots": len(self._slots),
            "occupied": len(occ),
            "occupied_by_tenant": self.occupied_by_tenant(),
            "parked": len(self._parked),
            "remaining_steps_total": self.remaining_steps_total(),
            "per_step_s": self.per_step_s(),
            "round_s_mean": (self._round_s_total / self._rounds_timed
                             if self._rounds_timed else 0.0),
            "joins": self.joins,
            "leaves": self.leaves,
            "preempts": self.preempt_count,
            "resumes": self.resumes,
            "rounds": self.rounds,
            "pack_aligned": self.pack_aligned,
        }
