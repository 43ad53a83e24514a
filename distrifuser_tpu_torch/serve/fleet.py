"""Fault-tolerant front router over a fleet of serving replicas (the JAX
package's serve/fleet.py).

A single `InferenceServer` is a total outage when its one scheduler
wedges.  `FleetRouter` lifts it to N `Replica` handles (serve/replica.py)
behind one admission boundary:

* **Admit once, route by health**: `submit()` scores every SERVING
  replica (`Replica.health_score`: breaker states, controller tier depth,
  rolling p99) and dispatches to the one maximizing

      routing_weight = score * capacity_weight / (1 + pending)

  — weighted least-degraded.  Mixed-capability replicas declare a
  ``capacity_weight`` (STADI's heterogeneous premise, arXiv 2509.04719):
  the load term steers toward spare healthy capacity, so a 2x replica
  absorbs ~2x the queue before a 1x one looks preferable, holding the
  fleet to one SLO.

* **Failover without double delivery**: a replica future resolving with
  a retryable error (retries exhausted, circuit open, watchdog, replica
  killed → `ServerClosedError`) re-dispatches the request onto another
  replica — only THEN, i.e. strictly after the prior replica's outcome
  is terminal, so a request's result is delivered exactly once and a
  dispatch that failed before completing never runs twice.  (The one
  exception where device work can physically run twice: a
  watchdog-ABANDONED dispatch may still finish in the background on the
  stuck replica — its result is discarded, same caveat as the
  single-server watchdog.)  Each re-dispatch draws from the fleet-wide
  `RetryBudget` and is bounded by ``FleetConfig.max_failovers``.  When
  no replica can take the request right now it is PARKED and
  re-dispatched from the housekeeping tick, with its ORIGINAL deadline
  — every re-dispatch passes the remaining TTL, never a fresh one.

* **Fleet-level graceful degradation** — the per-key `CircuitBreaker`
  semantics one level up: a replica whose health score floors (breakers
  tripped fleet-wide, p99 blown) or which fails
  ``drain_failure_threshold`` consecutive dispatches is auto-DRAINED
  (stops admitting, finishes in-flight).  ``probe_cooldown_s`` later it
  is probed half-open: exactly one live request routes to it; success
  resumes it, failure re-drains and re-arms.  A replica whose server
  STOPPED (the ``"replica"`` fault site's kill) is rebuilt via
  `restart_replica` / ``FleetConfig.auto_restart``.

* **Deterministic stop**: idempotent; every queued/in-flight future
  across all replicas resolves (`ServerClosedError` for undone work),
  including requests parked in the router awaiting re-dispatch — a
  failover racing `stop()` resolves, never leaks.

The 1-replica fleet is the degenerate case and behaves exactly like a
bare `InferenceServer`; the single-server API is unchanged.  Replicas may
share one card: each is its own server with its own scheduler thread.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import sync
from ..utils.config import FleetConfig, ServeConfig
from ..utils.metrics import MetricsRegistry
from .errors import (
    CarryExportedError,
    DeadlineExceededError,
    FatalError,
    LifecycleError,
    MigrationRejectedError,
    NoHealthyReplicaError,
    RetryableError,
    ServerClosedError,
)
from .replica import (
    REPLICA_DRAINING,
    REPLICA_SERVING,
    REPLICA_STOPPED,
    Replica,
)
from .resilience import RetryBudget


def routing_weight(score: float, capacity_weight: float,
                   pending: int) -> float:
    """The weighted least-degraded routing key:
    health score x declared capacity, discounted by the replica's
    outstanding work.  Pure math, unit-tested directly."""
    return score * capacity_weight / (1.0 + max(0, int(pending)))


@dataclasses.dataclass
class _FleetRequest:
    """One admitted request's router-side state: the parameters needed to
    re-dispatch it, the client-facing future, and the failover trail."""

    params: Dict[str, Any]
    future: Future
    deadline: float
    attempts: int = 0
    tried: set = dataclasses.field(default_factory=set)
    last_replica: Optional[str] = None
    last_error: Optional[BaseException] = None
    # carry migration (serve/migration.py): how many completed denoise
    # steps the snapshot currently riding ``params["carry_snapshot"]``
    # salvages — 0 when no snapshot rides.  Zeroed when a rejection
    # strips the snapshot (those steps re-execute from 0).
    salvaged_steps: int = 0


class _ReplicaSlot:
    """Router-side bookkeeping for one replica (fleet-lock-guarded)."""

    def __init__(self, replica: Replica, index: int):
        self.replica = replica
        self.index = index  # construction order: the deterministic tiebreak
        self.faulted = False  # auto-drained; owns the probe/restart cycle
        self.manual = False  # operator-drained; never probed back
        self.drained_at = 0.0
        self.probe_inflight = False
        self.restarting = False
        self.consecutive_failures = 0
        self.last_score = 1.0
        self.score_at = float("-inf")  # clock time of the last live score
        self.dispatched = 0
        self.completed = 0
        self.failed = 0


class FleetRouter:
    """Front router over N `Replica` handles (module docstring).

    ``replicas`` must have unique names; they should share one
    `MetricsRegistry` (pass the same object as each replica's
    ``registry`` and as ``registry`` here — `build_fleet` wires this) so
    the fleet exposes ONE metrics plane with per-replica labels.
    ``tracer`` (optional) lands routing/failover/lifecycle instants on
    the ``"fleet"`` track.
    """

    def __init__(
        self,
        replicas: Sequence[Replica],
        config: Optional[FleetConfig] = None,
        *,
        clock: Callable[[], float] = time.monotonic,
        tracer: Any = None,
        registry: Optional[MetricsRegistry] = None,
    ):
        reps = list(replicas)
        if not reps:
            raise ValueError("a fleet needs at least one replica")
        names = [r.name for r in reps]
        if len(set(names)) != len(names):
            raise ValueError(f"replica names must be unique, got {names}")
        self.config = config or FleetConfig()
        self.clock = clock
        self.tracer = tracer
        if registry is None:
            registry = next(
                (r.registry for r in reps if r.registry is not None), None)
        self.registry = registry if registry is not None else MetricsRegistry()
        self._slots: Dict[str, _ReplicaSlot] = {
            r.name: _ReplicaSlot(r, i) for i, r in enumerate(reps)
        }
        for r in reps:
            if r.tracer is None:
                r.tracer = tracer
        self.counters = self.registry.counter("fleet_requests")
        self.budget = RetryBudget(
            self.config.failover_budget,
            self.config.failover_budget_refill_per_s,
            clock=clock,
        )
        self._default_ttl = max(
            r.config.default_ttl_s for r in reps)
        self._lock = sync.RLock()
        self._parked: List[_FleetRequest] = []
        self._started = False
        self._stopping = False
        self._stopped = False
        self._tick_stop = sync.Event()
        self._tick_thread: Optional[threading.Thread] = None
        # a REBUILT router over the same shared registry (the documented
        # recovery path after stop()) must replace its predecessor's
        # gauges — their closures point at the dead router, and a bare
        # re-registration would conflict.  Counters are get-or-create and
        # deliberately continue across router generations.
        fleet_gauges = {
            "fleet_parked": lambda: float(len(self._parked)),
            "fleet_replicas_serving": lambda: float(sum(
                1 for s in self._slots.values()
                if s.replica.state == REPLICA_SERVING and not s.faulted
                and not s.manual)),
            "fleet_failover_budget_remaining":
                lambda: float(self.budget.remaining),
        }
        for gname, fn in fleet_gauges.items():
            self.registry.unregister(gname)
            self.registry.gauge(gname, fn)
        # elastic pool (serve/autoscale.py): attached only when enabled
        # so the fixed-fleet path pays nothing
        self.autoscaler = None
        if self.config.autoscale.enabled:
            from .autoscale import Autoscaler

            self.autoscaler = Autoscaler(self, self.config.autoscale)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "FleetRouter":
        """Start every replica IN PARALLEL (each warms before admitting
        — the warmup builds are independent, so fleet startup costs
        one warmup, not N) and the housekeeping tick thread
        (``FleetConfig.tick_s > 0``).  If any replica fails to start,
        the already-started ones are stopped before the error
        propagates — a failed fleet start leaks no scheduler threads.

        With the autoscaler attached (``FleetConfig.autoscale.enabled``)
        only the first ``min_replicas`` slots start; the surplus stays
        DORMANT — operator-drained and never started, costing no warmup
        — until sustained queue pressure scales it in."""
        if self._started:
            # a typed raise, not an assert: under ``python -O`` an assert
            # vanishes and a double start would "clean up" (stop) the
            # healthy serving replicas on its own error path
            raise LifecycleError("fleet already started")
        if self._stopped:
            raise ServerClosedError(
                "this fleet was stopped; build a new FleetRouter")
        slots = list(self._slots.values())
        if self.autoscaler is not None:
            n0 = self.autoscaler.min_replicas
            dormant = slots[n0:]
            slots = slots[:n0]
            with self._lock:
                for slot in dormant:
                    slot.manual = True  # dormant: routing-invisible,
                    # un-started (STARTING), scale-up's candidate pool
        errors: List[Tuple[str, BaseException]] = []

        def run(slot: _ReplicaSlot) -> None:
            try:
                slot.replica.start()
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                errors.append((slot.replica.name, exc))

        threads = [
            sync.Thread(target=run, args=(s,), daemon=True,
                             name=f"fleet-start-{s.replica.name}")
            for s in slots
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            for slot in slots:
                try:
                    slot.replica.stop(timeout=10.0)
                except Exception:  # noqa: BLE001 — best-effort cleanup
                    pass
            name, exc = errors[0]
            raise LifecycleError(
                f"replica {name} failed to start; the fleet was not "
                "brought up (already-started replicas were stopped)"
            ) from exc
        self._started = True
        if self.config.tick_s > 0:
            self._tick_stop.clear()
            self._tick_thread = sync.Thread(
                target=self._tick_loop, name="distrifuser-fleet-tick",
                daemon=True)
            self._tick_thread.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Idempotent, deterministic shutdown: stop routing, stop every
        replica (their queued/in-flight futures resolve), and fail every
        parked request with `ServerClosedError`.  A failover racing this
        resolves its future too — `_park` and `_failover` check the
        stopping flag under the fleet lock."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            self._stopping = True
        self._tick_stop.set()
        if self._tick_thread is not None:
            self._tick_thread.join(timeout)
            self._tick_thread = None
        # replicas stop IN PARALLEL, mirroring start(): shutdown is
        # bounded by the slowest single replica, not the sum — each
        # replica's stop() is itself bounded by its join timeouts
        stoppers = [
            sync.Thread(
                target=lambda s=slot: s.replica.stop(timeout),
                daemon=True, name=f"fleet-stop-{slot.replica.name}")
            for slot in self._slots.values()
        ]
        for t in stoppers:
            t.start()
        for t in stoppers:
            t.join(timeout + 5.0)
        with self._lock:
            parked, self._parked = self._parked, []
        for fr in parked:
            self.counters.inc("parked_closed")
            self._resolve(fr.future,
                          exc=ServerClosedError("fleet stopped"))
        self._started = False

    def __enter__(self) -> "FleetRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- replica administration --------------------------------------------

    def replica(self, name: str) -> Replica:
        return self._slots[name].replica

    def replica_names(self) -> List[str]:
        return list(self._slots)

    def _check_not_stopping(self, what: str) -> None:
        """Every operator lifecycle path shares the stop latch the
        auto-restart path enforces: a stopped fleet must never (re)start
        a replica it can no longer stop."""
        with self._lock:
            if self._stopping:
                raise ServerClosedError(
                    f"fleet is stopped; cannot {what} replicas")

    def drain_replica(self, name: str, release: bool = False,
                      timeout: Optional[float] = None,
                      drain_deadline_s: Optional[float] = None) -> None:
        """Operator drain (scale-down): stop routing here, let in-flight
        work finish; with ``release`` also stop the server once quiescent.
        Unlike an auto-drain this is never probed back — `resume_replica`
        is the explicit inverse.

        ``drain_deadline_s`` bounds the drain (serve/replica.py): after
        that many seconds the server stops anyway and EXPORTS every
        remaining mid-denoise carry — the failed futures come back here
        as `CarryExportedError` and the failover path re-dispatches each
        at its exported step on another replica (carry migration), so
        scale-down completes within the deadline without re-running
        anyone's completed steps."""
        self._check_not_stopping("drain")
        slot = self._slots[name]
        with self._lock:
            slot.manual = True
        self.counters.inc("manual_drains")
        self._trace("drain", replica=name, kind="manual")
        slot.replica.drain(release=release, timeout=timeout,
                           drain_deadline_s=drain_deadline_s)

    def resume_replica(self, name: str) -> None:
        self._check_not_stopping("resume")
        slot = self._slots[name]
        slot.replica.resume()
        with self._lock:
            slot.manual = False
            slot.faulted = False
            slot.probe_inflight = False
            slot.consecutive_failures = 0

    def restart_replica(self, name: str, timeout: float = 30.0) -> None:
        """Rebuild a stopped/faulted replica (fresh server generation,
        warmed before admitting) and return it to the routing pool.
        Refuses on a stopping/stopped fleet; a stop() racing the rebuild
        wins — the resurrected replica is stopped again, never leaked."""
        self._check_not_stopping("restart")
        slot = self._slots[name]
        slot.replica.restart(timeout)
        with self._lock:
            stopping = self._stopping
            if not stopping:
                slot.faulted = False
                slot.manual = False
                slot.probe_inflight = False
                slot.consecutive_failures = 0
                slot.drained_at = 0.0
        if stopping:
            slot.replica.stop(timeout)
            raise ServerClosedError(
                "fleet stopped during the restart; the replica was "
                "stopped again")
        self.counters.inc("restarts")
        self._trace("restart", replica=name)

    # -- submission ---------------------------------------------------------

    def submit(
        self,
        prompt: str,
        *,
        height: int,
        width: int,
        negative_prompt: str = "",
        num_inference_steps: Optional[int] = None,
        guidance_scale: float = 5.0,
        seed: int = 0,
        ttl_s: Optional[float] = None,
        slo_class: str = "default",
        tenant: str = "default",
        on_progress: Optional[Callable[..., Any]] = None,
    ) -> Future:
        """Admit one request to the fleet; returns a Future of
        `ServeResult` (whose ``replica``/``tier``/``exec_key`` fields say
        where and at what quality it actually ran).  Raises the routed
        replica's admission error — or `NoHealthyReplicaError` when no
        replica can admit at all — immediately; later failures fail over
        transparently and only surface when the failover policy is
        exhausted.  ``tenant`` (per-tenant fair queuing, tenancy-
        configured replicas only) rides every dispatch like
        ``slo_class`` — each replica holds the request to that tenant's
        quota and DRR share.  ``on_progress`` (progressive previews,
        step-batching replicas only) rides every dispatch, including
        failover re-dispatches — a preview stream may restart on the new
        replica."""
        if not self._started or self._stopping:
            raise ServerClosedError("fleet is not running")
        params = dict(
            prompt=prompt, height=height, width=width,
            negative_prompt=negative_prompt,
            num_inference_steps=num_inference_steps,
            guidance_scale=guidance_scale, seed=seed, ttl_s=ttl_s,
            slo_class=slo_class, tenant=tenant, on_progress=on_progress,
        )
        ttl = self._default_ttl if ttl_s is None else float(ttl_s)
        fr = _FleetRequest(params=params, future=Future(),
                           deadline=self.clock() + ttl)
        self.counters.inc("submitted")
        ok, exc = self._try_dispatch(fr)
        if not ok:
            self.counters.inc("rejected_unroutable")
            raise exc if exc is not None else NoHealthyReplicaError(
                "no replica is serving; retry after a probe or restart "
                "returns capacity"
            )
        return fr.future

    # -- routing ------------------------------------------------------------

    def _candidates(self) -> Tuple[Optional[_ReplicaSlot],
                                   List[_ReplicaSlot]]:
        """(probe_slot, healthy slots best-first).  ``probe_slot`` is an
        auto-drained replica whose cooldown elapsed — the half-open
        probe target, offered before the healthy pool so it actually
        gets re-tested under traffic (exactly one probe is in flight at
        a time; `_try_dispatch` latches it under the lock)."""
        cfg = self.config
        now = self.clock()
        with self._lock:
            slots = list(self._slots.values())
        probe: Optional[_ReplicaSlot] = None
        scored: List[Tuple[float, int, _ReplicaSlot]] = []
        for slot in slots:
            rep = slot.replica
            if slot.manual:
                continue
            if slot.faulted:
                if (not slot.probe_inflight and not slot.restarting
                        and rep.state == REPLICA_DRAINING
                        and now - slot.drained_at >= cfg.probe_cooldown_s
                        and (probe is None or slot.index < probe.index)):
                    probe = slot
                continue
            if rep.state != REPLICA_SERVING:
                continue
            # the full health score walks every breaker + class window —
            # too heavy per dispatch.  The tick refreshes it every
            # tick_s; here we reuse the cached score unless it is stale
            # (always fresh when the tick thread is off, i.e. tick_s=0 —
            # the deterministic-test mode).
            if cfg.tick_s <= 0 or now - slot.score_at >= cfg.tick_s:
                score = rep.health_score(cfg.p99_ref_s)
                # the cached score is also refreshed by the tick thread:
                # distrisched pinned the unlocked write pair as a
                # write-write race, so both writers take the router lock
                with self._lock:
                    slot.last_score = score
                    slot.score_at = now
            score = slot.last_score
            if score <= cfg.health_floor:
                continue  # routed around now; the tick will drain it
            w = routing_weight(score, rep.capacity_weight, rep.pending())
            scored.append((w, slot.index, slot))
        scored.sort(key=lambda t: (-t[0], t[1]))
        return probe, [s for _, _, s in scored]

    def _try_dispatch(self, fr: _FleetRequest
                      ) -> Tuple[bool, Optional[BaseException]]:
        """Route one request: probe target first, then untried healthy
        replicas best-first, then already-tried ones (the replica whose
        failure triggered this failover last).  Returns (dispatched?,
        last synchronous rejection)."""
        probe_slot, ranked = self._candidates()
        order: List[Tuple[_ReplicaSlot, bool]] = []
        if probe_slot is not None and probe_slot.replica.name not in fr.tried:
            order.append((probe_slot, True))
        fresh = [s for s in ranked if s.replica.name not in fr.tried]
        seen = [s for s in ranked if s.replica.name in fr.tried
                and s.replica.name != fr.last_replica]
        again = [s for s in ranked if s.replica.name == fr.last_replica]
        order.extend((s, False) for s in fresh + seen + again)
        # the client's TTL is ONE budget across every dispatch: re-submit
        # with the REMAINING time, not the original ttl_s — otherwise each
        # failover would grant a fresh full deadline and a 2s-TTL request
        # could run max_failovers x 2s
        remaining = fr.deadline - self.clock()
        if remaining <= 0:
            self.counters.inc("expired_before_dispatch")
            self._resolve(fr.future, exc=DeadlineExceededError(
                "request deadline lapsed before (re-)dispatch"))
            return True, None  # disposed of, nothing to park
        params = dict(fr.params)
        params["ttl_s"] = remaining
        last_exc: Optional[BaseException] = None
        for slot, is_probe in order:
            rep = slot.replica
            if is_probe:
                with self._lock:
                    if slot.probe_inflight or not slot.faulted:
                        continue  # lost the probe race / already healed
                    slot.probe_inflight = True
                self.counters.inc("probes")
                self._trace("probe", replica=rep.name)
            try:
                inner = self._submit_to(rep, params, is_probe, fr)
            except (RetryableError, ServerClosedError) as exc:
                last_exc = exc
                if is_probe:
                    self._probe_failed(slot)
                continue
            with self._lock:
                slot.dispatched += 1
            fr.tried.add(rep.name)
            fr.last_replica = rep.name
            self._trace("dispatch", replica=rep.name,
                        attempt=fr.attempts)
            inner.add_done_callback(
                lambda f, fr=fr, slot=slot, p=is_probe:
                self._on_replica_done(fr, slot, f, p))
            return True, None
        return False, last_exc

    def _submit_to(self, rep: Replica, params: Dict[str, Any],
                   is_probe: bool, fr: _FleetRequest) -> Future:
        """One dispatch edge.  A SYNCHRONOUS `MigrationRejectedError`
        (the replica's submit refused the riding carry snapshot —
        corrupt envelope, identity drift) strips the snapshot and
        retries THIS replica once from step 0: a bad snapshot says
        nothing about replica health and must not cascade across the
        fleet as a string of per-replica failures."""
        try:
            return rep.submit(probe=is_probe, **params)
        except MigrationRejectedError:
            if not params.get("carry_snapshot"):
                raise
            self._note_migration_rejected(fr)
            params.pop("carry_snapshot", None)
            fr.params.pop("carry_snapshot", None)
            return rep.submit(probe=is_probe, **params)

    def _note_migration_rejected(self, fr: _FleetRequest) -> None:
        """Accounting for one stripped snapshot: the steps it would have
        salvaged are now re-executed from 0."""
        self.counters.inc("migrations_rejected")
        self._trace("migrate_rejected", steps_lost=fr.salvaged_steps)
        if fr.salvaged_steps:
            self.counters.inc("fleet_steps_reexecuted", fr.salvaged_steps)
            fr.salvaged_steps = 0

    # -- outcome handling (runs on replica scheduler/decode threads) --------

    @staticmethod
    def _resolve(future: Future, *, result=None,
                 exc: Optional[BaseException] = None) -> None:
        """set_result/set_exception tolerating cancelled/raced futures
        (same contract as the server's `_resolve`)."""
        try:
            if exc is not None:
                future.set_exception(exc)
            else:
                future.set_result(result)
        except Exception:
            pass

    def _on_replica_done(self, fr: _FleetRequest, slot: _ReplicaSlot,
                         inner: Future, was_probe: bool) -> None:
        rep = slot.replica
        try:
            exc = inner.exception()
        except BaseException:  # noqa: BLE001 — cancelled inner future
            exc = ServerClosedError(
                f"replica {rep.name} future cancelled")
        if exc is None:
            with self._lock:
                slot.completed += 1
                slot.consecutive_failures = 0
                healed = was_probe and slot.faulted
                if was_probe:
                    slot.probe_inflight = False
                    slot.faulted = False
            if healed:
                self.counters.inc("probe_successes")
                self._trace("probe_success", replica=rep.name)
                if rep.state == REPLICA_DRAINING:
                    rep.resume()
            self.counters.inc("completed")
            result = inner.result()
            salvaged = getattr(result, "steps_salvaged", 0)
            if salvaged:
                # a migrated request finished: the adopting replica
                # resumed at the exported step — these completed steps
                # were NOT re-executed anywhere
                self.counters.inc("steps_salvaged", salvaged)
                self._trace("migrate_complete", replica=rep.name,
                            steps=salvaged)
            self._resolve(fr.future, result=result)
            return
        # the replica's outcome is TERMINAL (its own retry loop is done):
        # only now may the request move to a different replica
        fr.last_error = exc
        # REQUEST-fatal outcomes (expired deadline, no covering bucket —
        # FatalError minus the infrastructure-shaped ServerClosedError)
        # say nothing about the replica's health: a client spamming
        # oversized resolutions must not drain a healthy fleet, so they
        # skip the consecutive-failure / drain / probe-re-arm
        # bookkeeping entirely
        request_fatal = (isinstance(exc, FatalError)
                         and not isinstance(exc, ServerClosedError))
        # a rejected carry snapshot is the SNAPSHOT's failure (corrupt
        # bytes, version skew, key drift) — the replica that refused it
        # is healthy, so it must not accrue toward the drain threshold
        migration_rejected = isinstance(exc, MigrationRejectedError)
        self.counters.inc("replica_failures")
        with self._lock:
            slot.failed += 1
            if not request_fatal and not migration_rejected:
                slot.consecutive_failures += 1
            trip = (not request_fatal and not migration_rejected
                    and slot.consecutive_failures
                    >= self.config.drain_failure_threshold)
        if was_probe:
            if request_fatal:
                # inconclusive probe: the replica answered, the request
                # was doomed — release the latch so the next submit
                # probes again without re-arming the cooldown
                with self._lock:
                    slot.probe_inflight = False
                self.counters.inc("probe_inconclusive")
            else:
                self.counters.inc("probe_failures")
                self._probe_failed(slot)
        elif trip:
            self._auto_drain(slot, reason="consecutive_failures")
        if request_fatal:
            # doomed on every replica: failing over would burn budget
            # re-proving it
            self.counters.inc("failed_fatal")
            self._resolve(fr.future, exc=exc)
            return
        if self._stopping:
            self._resolve(fr.future,
                          exc=ServerClosedError("fleet stopped"))
            return
        self._failover(fr, exc)

    def _failover(self, fr: _FleetRequest, exc: BaseException) -> None:
        if isinstance(exc, MigrationRejectedError):
            # the importing replica refused the riding snapshot: strip
            # it and fall back to the pre-migration from-step-0 retry —
            # never resume from bytes a replica cannot prove intact
            if fr.params.pop("carry_snapshot", None) is not None:
                self._note_migration_rejected(fr)
        elif isinstance(exc, CarryExportedError):
            if exc.snapshot is not None:
                # the dying replica exported this request's mid-denoise
                # carry: re-dispatch WITH the snapshot so the adopting
                # replica resumes at the exported step, not step 0
                fr.params["carry_snapshot"] = exc.snapshot
                fr.salvaged_steps = exc.steps_done
                self.counters.inc("migrations")
                self._trace("migrate", frm=fr.last_replica,
                            step=exc.steps_done)
            elif exc.steps_done > 0:
                # progress died with the replica (export off or failed):
                # the steps beyond any OLDER still-riding snapshot will
                # re-execute — account for them
                resumable = (fr.salvaged_steps
                             if fr.params.get("carry_snapshot") else 0)
                lost = max(0, exc.steps_done - resumable)
                if lost:
                    self.counters.inc("fleet_steps_reexecuted", lost)
        fr.attempts += 1
        if fr.attempts > self.config.max_failovers:
            self.counters.inc("failover_exhausted")
            self._resolve(fr.future, exc=exc)
            return
        if not self.budget.acquire():
            self.counters.inc("failover_budget_exhausted")
            self._resolve(fr.future, exc=exc)
            return
        self.counters.inc("failovers")
        self._trace("failover", attempt=fr.attempts,
                    error=type(exc).__name__,
                    frm=fr.last_replica)
        ok, _ = self._try_dispatch(fr)
        if not ok:
            self._park(fr)

    def _park(self, fr: _FleetRequest) -> None:
        """No replica can take the request right now: hold it in the
        router; the tick re-dispatches (or expires) it.  Under stop, the
        future resolves immediately — parked work never leaks."""
        with self._lock:
            if self._stopping:
                parked_ok = False
            else:
                self._parked.append(fr)
                parked_ok = True
        if parked_ok:
            self.counters.inc("parked")
            self._trace("park", attempt=fr.attempts)
        else:
            self._resolve(fr.future,
                          exc=ServerClosedError("fleet stopped"))

    # -- fleet-level degradation -------------------------------------------

    def _auto_drain(self, slot: _ReplicaSlot, reason: str) -> None:
        with self._lock:
            if slot.faulted or slot.manual:
                return
            slot.faulted = True
            slot.drained_at = self.clock()
            slot.probe_inflight = False
        self.counters.inc("auto_drains")
        self._trace("auto_drain", replica=slot.replica.name, reason=reason)
        if slot.replica.state == REPLICA_SERVING:
            slot.replica.drain()

    def _probe_failed(self, slot: _ReplicaSlot) -> None:
        with self._lock:
            slot.probe_inflight = False
            slot.faulted = True
            slot.drained_at = self.clock()  # re-arm the cooldown
        self._trace("probe_failure", replica=slot.replica.name)

    # -- housekeeping -------------------------------------------------------

    def _tick_loop(self) -> None:
        while not self._tick_stop.wait(self.config.tick_s):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the tick must keep ticking
                import traceback

                self.counters.inc("tick_errors")
                traceback.print_exc()

    def tick(self) -> None:
        """One housekeeping pass (the tick thread's body; tests call it
        directly on an injected clock): floor-score auto-drain, fault
        adoption of externally-stopped (killed) replicas, background
        auto-restart, parked-request re-dispatch/expiry, and — with the
        autoscaler attached — one elastic-pool policy evaluation."""
        cfg = self.config
        now = self.clock()
        with self._lock:
            if self._stopping:
                return
            slots = list(self._slots.values())
        for slot in slots:
            rep = slot.replica
            if slot.manual:
                continue
            if slot.faulted:
                if (cfg.auto_restart and not slot.restarting
                        and rep.state == REPLICA_STOPPED
                        and now - slot.drained_at >= cfg.restart_cooldown_s):
                    self._restart_async(slot)
                continue
            if rep.state == REPLICA_STOPPED:
                # killed out from under the router (the "replica" fault
                # site): adopt it into the fault cycle so probe/restart
                # own its recovery
                self._auto_drain(slot, reason="stopped")
                continue
            if rep.state == REPLICA_SERVING:
                score = rep.health_score(cfg.p99_ref_s)
                with self._lock:  # paired with _candidates' refresh
                    slot.last_score = score
                    slot.score_at = now
                if score <= cfg.health_floor:
                    self._auto_drain(slot, reason="health_floor")
        # parked work: expire what cannot make its deadline, retry the rest
        with self._lock:
            parked, self._parked = self._parked, []
        still: List[_FleetRequest] = []
        for fr in parked:
            if fr.future.cancelled():
                continue
            if now >= fr.deadline:
                self.counters.inc("parked_expired")
                self._resolve(fr.future, exc=DeadlineExceededError(
                    "request expired while parked awaiting re-dispatch"))
                continue
            ok, _ = self._try_dispatch(fr)
            if ok:
                self.counters.inc("unparked")
            else:
                still.append(fr)
        if still:
            with self._lock:
                if self._stopping:
                    drain_now, still = still, []
                else:
                    self._parked.extend(still)
                    drain_now = []
            for fr in drain_now:
                self._resolve(fr.future,
                              exc=ServerClosedError("fleet stopped"))
        if self.autoscaler is not None:
            self.autoscaler.tick(now)

    def _restart_async(self, slot: _ReplicaSlot) -> None:
        with self._lock:
            if slot.restarting or self._stopping:
                return
            slot.restarting = True

        def run():
            with self._lock:
                if self._stopping:
                    slot.restarting = False
                    return
            try:
                slot.replica.restart()
            except Exception:  # noqa: BLE001 — retried next cooldown
                with self._lock:
                    slot.restarting = False
                    slot.drained_at = self.clock()
                self.counters.inc("restart_failures")
                return
            with self._lock:
                slot.restarting = False
                stopping = self._stopping
                if not stopping:
                    slot.faulted = False
                    slot.probe_inflight = False
                    slot.consecutive_failures = 0
            if stopping:
                # stop() raced (or already finished — its replica.stop was
                # a no-op on the then-STOPPED handle): the resurrected
                # replica must not outlive the fleet
                slot.replica.stop(timeout=10.0)
                return
            self.counters.inc("restarts")
            self._trace("restart", replica=slot.replica.name, kind="auto")

        sync.Thread(target=run, daemon=True,
                         name=f"fleet-restart-{slot.replica.name}").start()

    # -- observability ------------------------------------------------------

    def _trace(self, name: str, **args) -> None:
        if self.tracer is not None:
            self.tracer.event(name, track="fleet", args=args or None)

    def health(self) -> Dict[str, Any]:
        """Fleet liveness/readiness: per-replica lifecycle + score, and
        a rolled-up status ("ok" while any replica serves cleanly)."""
        replicas = {}
        serving = 0
        with self._lock:
            slots = list(self._slots.items())
        for name, slot in slots:
            rep = slot.replica
            entry = rep.snapshot()
            entry.update({
                "score": slot.last_score,
                "faulted": slot.faulted,
                "manual_drained": slot.manual,
                "probe_inflight": slot.probe_inflight,
                "consecutive_failures": slot.consecutive_failures,
            })
            replicas[name] = entry
            if (rep.state == REPLICA_SERVING and not slot.faulted
                    and not slot.manual):
                serving += 1
        degraded = serving < len(replicas)
        return {
            "status": ("ok" if serving and not degraded
                       else "degraded" if serving else "down"),
            "serving_replicas": serving,
            "total_replicas": len(replicas),
            "parked": len(self._parked),
            "failover_budget_remaining": self.budget.remaining,
            "replicas": replicas,
        }

    def metrics_snapshot(self) -> Dict[str, Any]:
        """The fleet metrics artifact: a ``"fleet"`` aggregate block
        (router counters + per-replica routing state) plus each live
        replica's full server snapshot under its name."""
        with self._lock:
            slots = list(self._slots.items())
        per_replica = {}
        servers = {}
        for name, slot in slots:
            rep = slot.replica
            entry = rep.snapshot()
            entry.update({
                "score": slot.last_score,
                "faulted": slot.faulted,
                "manual_drained": slot.manual,
                "dispatched": slot.dispatched,
                "completed": slot.completed,
                "failed": slot.failed,
            })
            per_replica[name] = entry
            servers[name] = (rep.server.metrics_snapshot()
                             if rep.server is not None else None)
        return {
            "fleet": {
                "requests": self.counters.snapshot(),
                "parked": len(self._parked),
                "failover_budget_remaining": self.budget.remaining,
                "replicas": per_replica,
                "autoscale": (self.autoscaler.snapshot()
                              if self.autoscaler is not None else None),
            },
            "replicas": servers,
        }


def build_fleet(
    factory_for: Callable[[str], Callable[[Any], Any]],
    config: Optional[ServeConfig] = None,
    fleet_config: Optional[FleetConfig] = None,
    *,
    replicas: Sequence[Tuple[str, float]] = (("r0", 1.0),),
    model_id: str = "model",
    scheduler: str = "ddim",
    mesh_plan: str = "dp1.cfg1.sp1",
    clock: Callable[[], float] = time.monotonic,
    fault_plan=None,
    tracer: Any = None,
) -> FleetRouter:
    """Convenience constructor: one shared `MetricsRegistry`, one
    `ServeConfig` for every replica, ``factory_for(name)`` returning each
    replica's executor factory (pass ``lambda name: shared_factory`` to
    share one), and ``replicas`` as (name, capacity_weight) pairs."""
    registry = MetricsRegistry()
    reps = [
        Replica(
            name,
            factory_for(name),
            config,
            capacity_weight=weight,
            model_id=model_id,
            scheduler=scheduler,
            mesh_plan=mesh_plan,
            clock=clock,
            fault_plan=fault_plan,
            registry=registry,
            tracer=tracer,
        )
        for name, weight in replicas
    ]
    return FleetRouter(reps, fleet_config, clock=clock, tracer=tracer,
                       registry=registry)
