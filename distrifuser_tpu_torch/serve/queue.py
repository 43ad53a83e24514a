"""Admission-controlled request queue for the inference service.

The queue is the service's backpressure boundary (PipeFusion-class serving
systems win throughput at this orchestration layer, not inside the model):

* **bounded depth** — `put` beyond ``max_depth`` raises `QueueFullError`,
  the 429-style signal an upstream load balancer retries against a less
  loaded replica.  Nothing is silently dropped.
* **deadlines** — every request carries an absolute expiry; the batcher
  rejects (never executes) requests whose deadline passed while queued.
  Late work is pure wasted mesh time, and executing it would also delay
  every live request behind it.
* **FIFO within a compatibility class** — `pop_where` scans in arrival
  order, so two requests for the same bucket can never reorder.
Thread model: producers call `put` from any thread; the single scheduler
thread (serve/server.py) drains via `wait_nonempty` / `pop_expired` /
`pop_where`; the step-granular scheduler (serve/stepbatch.py) peeks the
tightest-slack request (`peek_best` / `peek_urgent`) and takes it out
with `remove`.  All state is guarded by one lock + condition; the attached
policy is only ever called under that lock.

* **tenant-aware fairness (optional)** -- with a `TenancyPolicy`
  attached (serve/tenancy.py, configured via ``ServeConfig.gateway``),
  `put` additionally charges the submitting tenant's token bucket
  (`TenantQuotaError` when exhausted -- the per-tenant 429), and
  `peek_best` runs weighted deficit-round-robin ACROSS tenant
  sub-queues before EDF picks WITHIN the winning tenant -- a burst
  tenant cannot monopolize slots, deadlines still order each tenant's
  own work.  `remove` commits the DRR charge.  The whole-batch
  `pop_where` path keeps its FIFO semantics (quotas still apply at
  `put`; DRR shares are a property of the step-granular scheduler).
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from concurrent.futures import Future
from typing import Any, Callable, List, Optional

# Historical home of these errors — re-exported so `from .queue import
# QueueFullError` keeps working; the full typed hierarchy (Retryable vs
# Fatal) lives in serve/errors.py.
from ..utils import sync
from .errors import (  # noqa: F401  (re-exports)
    DeadlineExceededError,
    QueueFullError,
    ServeError,
    ServerClosedError,
)


_REQUEST_IDS = itertools.count()


@dataclasses.dataclass
class Request:
    """One generation request plus its lifecycle bookkeeping.

    ``deadline`` is absolute `time.monotonic()` time.  ``height``/``width``
    are the *requested* resolution; the batcher snaps them to ``bucket``
    (the compiled-program resolution) at scheduling time — the output is
    generated at bucket resolution, with the requested size recorded so a
    fronting layer can crop/resize.
    """

    prompt: str
    height: int
    width: int
    num_inference_steps: int
    deadline: float
    negative_prompt: str = ""
    guidance_scale: float = 5.0
    seed: int = 0
    # SLO class this request is held to ("default" unless the caller
    # says otherwise): completions feed the per-class rolling p50/p99
    # windows (server.slo_snapshot()) the closed-loop controller reads.
    slo_class: str = "default"
    # submitting tenant (serve/tenancy.py): the fairness identity the
    # queue's token buckets and DRR shares account against.  Untagged
    # requests ride the implicit default tenant; meaningless (and
    # ignored) when no tenant table is configured.
    tenant: str = "default"
    request_id: int = dataclasses.field(
        default_factory=lambda: next(_REQUEST_IDS)
    )
    enqueue_ts: float = dataclasses.field(default_factory=time.monotonic)
    future: Future = dataclasses.field(default_factory=Future)
    bucket: Optional[tuple] = None  # (h, w), set by the batcher
    # when the batcher pulled this request out of the queue into a batch
    # (None until then): the end of the queue-wait span, stamped at the
    # pop so tracing sees the coalesce time, not the later dispatch time
    dequeue_ts: Optional[float] = None
    # utils.trace.RequestTrace when request-scoped tracing is on (the
    # tracer-local ids the lifecycle hooks close spans against); None —
    # and completely untouched — when tracing is off
    trace: Any = None
    # progressive-preview callback (step-level continuous batching,
    # serve/stepbatch.py): ``on_progress(step, total_steps, preview)``
    # fires on the SCHEDULER thread every preview_interval steps with a
    # cheap downsampled-latent image -- keep it fast; a slow callback
    # stalls the whole step loop.  Set at construction, never mutated.
    on_progress: Any = None
    # carry migration (serve/migration.py): the DECODED snapshot
    # (`CarrySnapshot`) this re-dispatched request resumes from --
    # validated synchronously at submit, imported at step admission.
    # None for every fresh (non-migrated) request.  Set at construction,
    # never mutated.
    carry_snapshot: Any = None

    def expired(self, now: float) -> bool:
        return now >= self.deadline


@dataclasses.dataclass
class ServeResult:
    """What a request's future resolves to: outputs plus the per-request
    lifecycle metrics (the JSON artifact is aggregated from these)."""

    request_id: int
    output: Any
    bucket: tuple
    requested_size: tuple
    queue_wait_s: float
    execute_s: float
    e2e_s: float
    batch_size: int
    compile_hit: bool
    # resilience lifecycle: how many retry attempts this request's batch
    # burned before succeeding, and which sticky degradation rungs
    # (serve/resilience.py) were active for its executor key
    retries: int = 0
    degradations: tuple = ()
    # quality/placement audit trail: the ExecKey the request ACTUALLY
    # executed at (short tag — carries every compile-identity knob incl.
    # tier overrides and ladder rungs), the SLO-controller tier name it
    # dispatched under (None when the controller is off), and which fleet
    # replica served it (None on a bare single server).  Clients and
    # benches read these to audit quality degradation per request.
    exec_key: str = ""
    tier: Optional[str] = None
    replica: Optional[str] = None
    # step-level continuous batching (serve/stepbatch.py): how many
    # progressive previews this request's on_progress callback received,
    # the time from enqueue to the FIRST of them (the perceived-latency
    # number the bench gates), and how many times the request was
    # preempted mid-denoise (parked + resumed bit-identically).  All
    # zero/None on whole-batch servers.
    previews: int = 0
    first_preview_s: Optional[float] = None
    preempts: int = 0
    # carry migration (serve/migration.py): how many times this request
    # resumed from an imported carry snapshot (0 = never migrated), and
    # how many already-completed denoise steps those imports salvaged —
    # steps the fleet did NOT re-execute after a replica kill/drain.
    migrations: int = 0
    steps_salvaged: int = 0


class RequestQueue:
    """Bounded FIFO with predicate-scoped draining (see module docstring)."""

    def __init__(self, max_depth: int, policy=None):
        assert max_depth >= 1, max_depth
        self.max_depth = max_depth
        self._items: List[Request] = []
        self._lock = sync.Lock()
        self._nonempty = sync.Condition(self._lock)
        self._closed = False
        # optional serve/tenancy.TenancyPolicy -- set once before the
        # queue is shared (server construction), called ONLY under
        # self._lock thereafter (the policy owns no lock of its own)
        self.policy = policy
        self._seq = 0  # bumped on every put; lets waiters sleep until an
        # ARRIVAL rather than mere non-emptiness (batcher linger loop)

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def closed(self) -> bool:
        """True once close() ran; a closed queue never admits again."""
        with self._lock:
            return self._closed

    @property
    def seq(self) -> int:
        """Arrival sequence number (monotonic; see wait_arrival)."""
        with self._lock:
            return self._seq

    def put(self, req: Request) -> None:
        with self._lock:
            if self._closed:
                raise ServerClosedError("server is stopped")
            if self.policy is not None:
                # tenant quota first: a flooding tenant is rejected on
                # ITS budget (TenantQuotaError) before it can consume
                # the shared depth other tenants' admission rides on
                self.policy.admit(req)
            if len(self._items) >= self.max_depth:
                raise QueueFullError(
                    f"queue at max depth {self.max_depth}; retry later"
                )
            self._items.append(req)
            self._seq += 1
            self._nonempty.notify_all()

    def wait_nonempty(self, timeout: float) -> bool:
        """Block until the queue has an item (True) or timeout (False)."""
        with self._lock:
            if self._items:
                return True
            self._nonempty.wait(timeout)
            return bool(self._items)

    def wait_arrival(self, seen_seq: int, timeout: float) -> int:
        """Block until a put() lands after ``seen_seq`` (or timeout); returns
        the current sequence.  Unlike wait_nonempty this does NOT return
        immediately while incompatible requests sit queued — the batcher's
        linger loop would otherwise busy-spin a core for the whole window."""
        deadline = time.monotonic() + timeout
        with self._lock:
            while self._seq == seen_seq and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._nonempty.wait(remaining)
            return self._seq

    def pop_expired(self, now: float) -> List[Request]:
        """Remove and return every request whose deadline has passed."""
        with self._lock:
            dead = [r for r in self._items if r.expired(now)]
            if dead:
                self._items = [r for r in self._items if not r.expired(now)]
            return dead

    def pop_where(self, pred: Callable[[Request], bool],
                  limit: int) -> List[Request]:
        """Remove and return up to ``limit`` requests matching ``pred``,
        in arrival order (FIFO within the compatibility class)."""
        assert limit >= 0, limit
        with self._lock:
            taken: List[Request] = []
            kept: List[Request] = []
            for r in self._items:
                if len(taken) < limit and pred(r):
                    taken.append(r)
                else:
                    kept.append(r)
            self._items = kept
            return taken

    def close(self) -> List[Request]:
        """Stop admitting; return whatever was still queued (the server
        fails their futures with ServerClosedError)."""
        with self._lock:
            self._closed = True
            drained, self._items = self._items, []
            self._nonempty.notify_all()
            return drained

    def peek_best(self, score: Callable[[Request], float]) -> Optional[Request]:
        """The queued request minimizing ``score`` (ties broken by
        arrival order -- min() returns the first), NOT removed.  The
        step-granular scheduler's EDF admission: deadline slack
        deliberately supersedes FIFO there, because a slot pool has no
        compatibility classes to keep ordered -- fill and preemption peek
        the tightest-slack candidate, weigh it against parked carries or
        a potential victim, and only then `remove` it (single consumer:
        the scheduler thread is the only popper, so peek-then-remove
        cannot race another taker).

        With a tenancy policy attached, deficit-round-robin first picks
        WHICH tenant's turn it is, then ``score`` (EDF) picks within
        that tenant's sub-queue; the DRR charge commits at `remove`."""
        with self._lock:
            if not self._items:
                return None
            if self.policy is not None:
                groups: dict = {}
                for r in self._items:
                    groups.setdefault(r.tenant, []).append(r)
                pick = self.policy.select(groups, score)
                if pick is not None:
                    return pick
            return min(self._items, key=score)

    def peek_urgent(self, score: Callable[[Request], float]
                    ) -> Optional[Request]:
        """Policy-BLIND ``peek_best``: the globally tightest request by
        ``score``, ignoring any tenancy policy.  The deadline-rescue
        (preemption) path uses this: DRR's cursor legitimately camps on
        a backlogged tenant (turn continuity), which would hide another
        tenant's about-to-miss request from the rescue check entirely —
        fairness governs throughput shares, not rescues.  Rescue volume
        is still tenant-bounded upstream (token-bucket admission) and
        downstream (one preemption per round, one per victim).  The DRR
        accounting stays correct: `remove` falls back to a plain debit
        when the dequeued request is not the policy's parked pick."""
        with self._lock:
            if not self._items:
                return None
            return min(self._items, key=score)

    def remove(self, req: Request) -> bool:
        """Remove one specific request (identity match); False if it is
        no longer queued.  Commits the pending DRR charge when a
        tenancy policy is attached."""
        with self._lock:
            for i, r in enumerate(self._items):
                if r is req:
                    del self._items[i]
                    if self.policy is not None:
                        self.policy.charge(req, self._items)
                    return True
            return False

    def tenancy_snapshot(self) -> Optional[dict]:
        """Per-tenant accounting (tokens, deficits, admit/reject
        counts), or None when no policy is attached."""
        with self._lock:
            if self.policy is None:
                return None
            return self.policy.snapshot()
