"""One replica of the serving fleet: a lifecycle-managed `InferenceServer`
(the JAX package's serve/replica.py).

`InferenceServer` already bundles everything one card needs — the
scheduler thread, its `ResilienceEngine` (breakers, ladder, watchdog),
`SLOController`, `ExecutorCache`, and metrics scope.  `Replica` lifts
that bundle behind a replica-addressable handle with an EXPLICIT
lifecycle state machine, so the fleet router (serve/fleet.py) can treat
"one server" as a unit that is born, warmed, drained, probed, killed, and
rebuilt:

    starting -> warming -> serving <-> draining -> stopped -> warming ...

* **starting**: the handle exists; no server, no traffic.
* **warming**: the server is being built and its warmup buckets built
  and captured — the replica takes NO traffic until every configured
  bucket key has an executor (`InferenceServer.start(warmup=True)` builds
  before spawning the scheduler), so a fresh or restarted replica never
  serves cold.
* **serving**: admitting; the only state `health_score()` scores above 0.
* **draining**: not admitting (the router stops routing here; `submit`
  rejects), but the server keeps running so queued + in-flight work
  FINISHES.  ``drained`` turns True when nothing is pending.  A drained
  replica can `resume()` (the fleet's half-open probe path) or be
  released (`drain(release=True)` waits for quiescence, then stops).
* **stopped**: the server is shut down; queued futures were failed with
  `ServerClosedError`.  `start()` from here is a RESTART — a fresh
  server generation over the same handle (per-generation metric labels
  keep the shared registry collision-free).

Health scoring (the routing signal):

    score = breaker_factor * tier_factor * latency_factor   in [0, 1]

* ``breaker_factor`` = 1 - open_circuits / tracked_circuits — the
  resilience engine's breaker states, aggregated;
* ``tier_factor``    = 1 - 0.5 * deepest_class_tier / n_tiers — the SLO
  controller's tier depth (a replica serving everyone at reduced steps
  is degraded even if nothing is failing);
* ``latency_factor`` = min(1, p99_ref / worst rolling class p99) when
  the fleet provides a reference p99 (`slo_snapshot` windows).

Non-serving replicas score 0.0.

Fault injection: the ``"replica"`` site (serve/faults.py) is consulted at
the top of every monolithic executor dispatch AND every step-granular
cohort step, keyed by the REPLICA NAME (``key_substr`` targets one
replica).  The ``kill`` kind models the replica process dying: the handle
transitions to STOPPED, its server shuts down in the background (queued
work fails with `ServerClosedError` for the router to re-dispatch), and
the in-flight batch fails terminally — except mid-denoise carries under
step batching, which the dying scheduler EXPORTS (serve/migration.py) so
the fleet migrates them instead of re-running from step 0.

Several replicas may share one card, each with its own scheduler thread;
what a build on one thread must not do to another thread's dispatch is the
executor layer's business (serve/executors.py `card_build_lock`), not this
module's.  ``server.aot_store`` is None until the AOT store is ported, so
a warm-up's deserialize seconds are 0.  A replica spans one rank:
`refuse_ranked_replica` refuses a ``mesh_plan`` or an executor over more
(ROADMAP item 16, step 16h); a pipeline over n ranks is served by one
`InferenceServer` (serve/ranks.py).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import sync
from ..utils.config import ServeConfig
from .errors import LifecycleError, ServerClosedError
from .faults import FaultPlan, InjectedReplicaKilled
from .server import InferenceServer

# Lifecycle states (ordered for humans; legality lives in _TRANSITIONS).
REPLICA_STARTING = "starting"
REPLICA_WARMING = "warming"
REPLICA_SERVING = "serving"
REPLICA_DRAINING = "draining"
REPLICA_STOPPED = "stopped"

REPLICA_STATES = (REPLICA_STARTING, REPLICA_WARMING, REPLICA_SERVING,
                  REPLICA_DRAINING, REPLICA_STOPPED)

_TRANSITIONS = {
    REPLICA_STARTING: (REPLICA_WARMING, REPLICA_STOPPED),
    REPLICA_WARMING: (REPLICA_SERVING, REPLICA_STOPPED),
    REPLICA_SERVING: (REPLICA_DRAINING, REPLICA_STOPPED),
    REPLICA_DRAINING: (REPLICA_SERVING, REPLICA_STOPPED),
    REPLICA_STOPPED: (REPLICA_WARMING,),  # restart
}


class _ReplicaSiteKey:
    """Key object handed to the ``"replica"`` fault site: stringifies to
    the replica name so `FaultRule.key_substr` targets one replica."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def short(self) -> str:
        return self.name

    def __str__(self) -> str:
        return self.name


class _FaultGuardedExecutor:
    """Executor wrapper consulting the ``"replica"`` fault site before
    every monolithic dispatch AND every step-granular cohort step, so a
    ``kill`` rule can fell a replica mid-denoise (the carry-migration
    chaos path).  Everything else (``batch_size``,
    ``attach_prompt_cache``, stage programs, the remaining step hooks)
    delegates — note the staged path calls stage methods directly, so
    replica faults fire on ``__call__``/``step_run`` only."""

    def __init__(self, inner: Any, replica: "Replica"):
        self._inner = inner
        self._replica = replica

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def __call__(self, *args, **kwargs):
        self._replica._check_replica_fault()
        return self._inner(*args, **kwargs)

    def step_run(self, works):
        self._replica._check_replica_fault()
        return self._inner.step_run(works)


def _mesh_size(mesh_plan: str) -> int:
    """Ranks of a `DistriConfig.mesh_plan` tag ("dp1.cfg2.sp2" -> 4)."""
    size = 1
    for part in mesh_plan.split("."):
        digits = "".join(ch for ch in part if ch.isdigit())
        size *= int(digits) if digits else 1
    return size


def refuse_ranked_replica(mesh_plan: str = "dp1.cfg1.sp1", world_size: int = 1) -> None:
    """A replica is one server on one rank: a fleet whose replicas each
    span n ranks needs 2·n processes and a design of its own (a control
    channel a replica, failover that stops a whole world), which comes
    with ROADMAP item 16, step 16h.  Raise ``ValueError`` naming it for a
    ``mesh_plan`` of more than one rank or an executor over more than one
    (`PipelineExecutor.world_size`, `serve.ranks.RankedExecutor`)."""
    ranks = max(_mesh_size(mesh_plan), int(world_size))
    if ranks > 1:
        raise ValueError(
            f"a fleet replica spans one rank; this one would span {ranks} "
            f"({mesh_plan if _mesh_size(mesh_plan) > 1 else 'its executor'}).  "
            "Replicas that span ranks come with ROADMAP item 16, step 16h "
            "(a fleet of replicas over n ranks); serve over n ranks with "
            "serve.ranks.serve_over_ranks and one InferenceServer instead")


class Replica:
    """Handle for one fleet replica; see the module docstring.

    ``executor_factory``/``config``/``model_id``/``scheduler``/
    ``mesh_plan``/``fault_plan`` are the `InferenceServer` construction
    surface — the replica builds a FRESH server from them on every
    (re)start.  ``capacity_weight`` declares relative capacity for the
    router's weighted routing (a replica twice as fast declares 2.0).
    ``registry`` is the fleet-shared `MetricsRegistry`; every server
    generation scopes itself under ``{"replica": name, "generation": n}``
    labels so restarts never collide with their predecessor's metrics.
    """

    def __init__(
        self,
        name: str,
        executor_factory: Callable[[Any], Any],
        config: Optional[ServeConfig] = None,
        *,
        capacity_weight: float = 1.0,
        model_id: str = "model",
        scheduler: str = "ddim",
        mesh_plan: str = "dp1.cfg1.sp1",
        clock: Callable[[], float] = time.monotonic,
        fault_plan: Optional[FaultPlan] = None,
        registry: Any = None,
        tracer: Any = None,
    ):
        if not name:
            raise ValueError("replica name must be non-empty")
        refuse_ranked_replica(mesh_plan=mesh_plan)
        if capacity_weight <= 0:
            raise ValueError(
                f"capacity_weight must be > 0, got {capacity_weight}"
            )
        self.name = str(name)
        self.capacity_weight = float(capacity_weight)
        self.executor_factory = executor_factory
        self.config = config or ServeConfig()
        self.model_id = model_id
        self.scheduler = scheduler
        self.mesh_plan = mesh_plan
        self.clock = clock
        self.fault_plan = fault_plan
        self.registry = registry
        self.tracer = tracer
        self.server: Optional[InferenceServer] = None
        self.killed = False
        self.generation = 0
        # outstanding background stop of a killed generation (see
        # _on_killed); joined by the next start() before metric pruning
        self._bg_stop: Optional[threading.Thread] = None
        self._state = REPLICA_STARTING
        self._warm_nonce = 0  # which start() owns the current WARMING
        # last completed warm-up's wall time + build/deserialize split
        # (0.0 until the first start() finishes) — the scale-up latency
        self.last_warmup_s = 0.0
        self.last_warmup_compile_s = 0.0
        self.last_warmup_deserialize_s = 0.0
        self._history: List[Tuple[float, str, str]] = []
        # RLock: lifecycle methods nest (restart = stop + start), and the
        # kill path transitions from a watchdog worker thread
        self._lock = sync.RLock()

    # -- state machine ------------------------------------------------------

    @property
    def state(self) -> str:
        return self._state

    @property
    def history(self) -> List[Tuple[float, str, str]]:
        """(t, from, to) transition log — what the lifecycle tests pin."""
        with self._lock:
            return list(self._history)

    def _transition(self, to: str) -> None:
        with self._lock:
            frm = self._state
            if to not in _TRANSITIONS[frm]:
                raise LifecycleError(
                    f"replica {self.name}: illegal lifecycle transition "
                    f"{frm} -> {to}"
                )
            self._state = to
            self._history.append((self.clock(), frm, to))
        if self.tracer is not None:
            self.tracer.event(f"replica_{to}", track="fleet",
                              args={"replica": self.name, "from": frm})

    # -- lifecycle ----------------------------------------------------------

    def start(self, warmup: bool = True) -> "Replica":
        """starting/stopped -> warming -> serving.  Warming builds a
        fresh server and (with ``warmup``, the default) builds the
        configured warmup buckets BEFORE the scheduler admits traffic;
        from STOPPED this is a restart (new server generation, same
        handle).  The warm-up wall time and its build-vs-deserialize
        split land in the generation-scoped registry
        (``replica_warmup_s`` / ``replica_warmup_compile_s`` /
        ``replica_warmup_deserialize_s``, the names the JAX package
        gives them) and as a "warmup" span on the fleet trace track.

        The build + warmup runs OUTSIDE the lifecycle lock — real warmup
        builds and captures take seconds, and `stop()`/`drain()` must stay
        responsive (their timeout contract).  Concurrent starts are
        excluded by the WARMING transition itself; a `stop()` landing
        mid-warm wins — the freshly built server is discarded.  The
        warming NONCE makes the discard check generation-exact: a
        stop+restart pair landing mid-warm re-enters WARMING, and
        without the nonce the first starter would adopt the second's
        WARMING state and serve its own (conceptually dead) server (two
        racing restart()s could both report success yet leave the
        replica stopped)."""
        with self._lock:
            if self._state not in (REPLICA_STARTING, REPLICA_STOPPED):
                raise LifecycleError(
                    f"replica {self.name} cannot start from {self._state}"
                )
            self._transition(REPLICA_WARMING)
            self._warm_nonce += 1
            nonce = self._warm_nonce
            self.killed = False
            bg, old = self._bg_stop, self.server
            self._bg_stop = None
        # the previous generation must be FULLY stopped before its
        # metrics are pruned: a still-draining scheduler/decode worker
        # could otherwise re-register just-pruned label sets (which no
        # later prune would ever remove, resurrecting the leak).  Done
        # outside the lock — a kill's background stop may take a while,
        # and stop()/drain() must stay responsive meanwhile.
        if bg is not None:
            bg.join(timeout=30.0)
        if old is not None:
            old.stop(timeout=30.0)  # idempotent; guarantees the join ran
        with self._lock:
            if self.registry is not None and self.generation > 0:
                # the dead generation's metrics (whose gauge closures pin
                # the stopped server) leave the shared registry before
                # the new generation registers — bounded growth per
                # replica, not per restart
                self.registry.prune({
                    "replica": self.name,
                    "generation": str(self.generation),
                })
            self.generation += 1
            reg = self.registry
            if reg is not None:
                # per-generation scope: a restarted server re-creates its
                # gauges/rings; distinct labels keep the shared registry
                # from rejecting them as conflicting registrations
                reg = reg.scoped({"generation": str(self.generation)})
        tt0 = self.tracer.clock() if self.tracer is not None else 0.0
        t0 = time.monotonic()
        try:
            server = InferenceServer(
                self._build_executor,
                self.config,
                model_id=self.model_id,
                scheduler=self.scheduler,
                mesh_plan=self.mesh_plan,
                clock=self.clock,
                fault_plan=self.fault_plan,
                registry=reg,
                replica_name=self.name,
            )
            server.start(warmup=warmup)
        except Exception:
            with self._lock:
                if (self._state == REPLICA_WARMING
                        and self._warm_nonce == nonce):
                    self._transition(REPLICA_STOPPED)
            raise
        # warm-up accounting: wall time from "start decided to warm" to
        # "server warmed", split into build seconds (the executor
        # cache's build clock) and deserialize seconds (the AOT store's
        # clock, 0 while the store is not ported)
        warmup_s = time.monotonic() - t0
        aot = server.aot_store
        compile_s = float(server.cache.stats()["build_seconds"])
        deser_s = float(aot.stats()["deserialize_seconds"]) if aot else 0.0
        with self._lock:
            if self._state != REPLICA_WARMING or self._warm_nonce != nonce:
                # stop() (or a full stop+restart cycle) raced the warmup
                # and won: THIS warming is over, so the fresh server must
                # not serve — and must not adopt a successor's WARMING
                server.stop(timeout=5.0)
                return self
            self.server = server
            self.last_warmup_s = warmup_s
            self.last_warmup_compile_s = compile_s
            self.last_warmup_deserialize_s = deser_s
            self._transition(REPLICA_SERVING)
        # without a fleet-shared registry the gauges land on the server's
        # own (fresh every generation, so no re-registration conflict);
        # on the shared one they need the replica label the server adds
        # to its own metrics, or sibling replicas' gauges would collide
        target = (reg.scoped({"replica": self.name})
                  if reg is not None else server.registry)
        target.gauge("replica_warmup_s", lambda v=warmup_s: v)
        target.gauge("replica_warmup_compile_s", lambda v=compile_s: v)
        target.gauge("replica_warmup_deserialize_s",
                     lambda v=deser_s: v)
        if self.tracer is not None:
            self.tracer.complete(
                "warmup", tt0, self.tracer.clock(), track="fleet",
                args={"replica": self.name, "warmup_s": round(warmup_s, 6),
                      "compile_s": round(compile_s, 6),
                      "deserialize_s": round(deser_s, 6)})
        return self

    def drain(self, release: bool = False,
              timeout: Optional[float] = None,
              drain_deadline_s: Optional[float] = None) -> None:
        """Stop admitting; queued + in-flight work FINISHES (the server
        keeps running).  With ``release`` additionally wait (wall-clock,
        up to ``timeout`` seconds) for quiescence and then stop — the
        scale-down path.  Without it the replica stays DRAINING and can
        `resume()` (the fleet's half-open probe).

        ``drain_deadline_s`` BOUNDS the drain: wait that many wall-clock
        seconds for quiescence, then stop the server anyway.  Under step
        batching the forced stop EXPORTS every remaining mid-denoise
        carry (serve/migration.py — the futures fail with
        `CarryExportedError` carrying the snapshot) so the fleet
        re-dispatches each one at its current step on another replica: a
        slow request delays scale-down by at most the deadline and loses
        none of its completed steps."""
        with self._lock:
            if self._state == REPLICA_SERVING:
                self._transition(REPLICA_DRAINING)
        if drain_deadline_s is not None:
            deadline = time.monotonic() + float(drain_deadline_s)
            while self.pending() > 0 and time.monotonic() < deadline:
                time.sleep(0.005)
            self.stop(timeout=30.0 if timeout is None else float(timeout))
            return
        if release:
            deadline = time.monotonic() + (30.0 if timeout is None
                                           else float(timeout))
            while self.pending() > 0 and time.monotonic() < deadline:
                time.sleep(0.005)
            self.stop(timeout=30.0 if timeout is None else timeout)

    def resume(self) -> None:
        """draining -> serving (the probe succeeded / the drain was
        called off)."""
        with self._lock:
            if self._state == REPLICA_DRAINING:
                self._transition(REPLICA_SERVING)

    def stop(self, timeout: float = 30.0) -> None:
        """-> stopped.  Deterministic and idempotent: the server's
        `stop()` fails every still-queued future with
        `ServerClosedError`."""
        with self._lock:
            server = self.server
            if self._state == REPLICA_STOPPED:
                server = None  # already stopped (or never started)
            else:
                self._transition(REPLICA_STOPPED)
        if server is not None:
            server.stop(timeout)

    def restart(self, timeout: float = 30.0) -> "Replica":
        """Stop (if needed) and start a fresh server generation —
        recovery for a killed/faulted replica.  Not lock-wrapped as a
        whole (the warmup must not block stop()/drain()); a concurrent
        second restart loses the WARMING transition race and raises."""
        self.stop(timeout)
        return self.start()

    # -- traffic ------------------------------------------------------------

    def submit(self, prompt: str, *, probe: bool = False, **kwargs):
        """Admit one request on this replica (the router's dispatch
        edge).  Rejects with `ServerClosedError` unless SERVING — or
        DRAINING with ``probe=True``, the single-request half-open path
        the fleet uses to re-test a drained replica."""
        st = self._state
        server = self.server
        allowed = st == REPLICA_SERVING or (probe and st == REPLICA_DRAINING)
        if server is None or not allowed:
            raise ServerClosedError(
                f"replica {self.name} is {st}; not admitting"
                + ("" if st != REPLICA_DRAINING else " (draining)")
            )
        return server.submit(prompt, **kwargs)

    def _build_executor(self, key):
        ex = self.executor_factory(key)
        refuse_ranked_replica(world_size=getattr(ex, "world_size", 1))
        if self.fault_plan is not None:
            return _FaultGuardedExecutor(ex, self)
        return ex

    def _check_replica_fault(self) -> None:
        plan = self.fault_plan
        if plan is None:
            return
        try:
            plan.check("replica", key=_ReplicaSiteKey(self.name))
        except InjectedReplicaKilled:
            self._on_killed()
            raise

    def _on_killed(self) -> None:
        """The ``kill`` fault fired: this replica's process "died".
        Transition to STOPPED immediately (the router stops picking it
        on its next look) and signal the server's shutdown SYNCHRONOUSLY
        (`request_stop`: stop flag + queue drain, no join) so the
        in-flight batch fails terminally on its next retry check instead
        of racing a background thread and possibly retrying on a "dead"
        replica.  The blocking part of the shutdown (scheduler join)
        runs on a background thread — the caller is a watchdog worker
        inside the server's own dispatch, so a full stop() here would
        deadlock the join."""
        with self._lock:
            if self._state == REPLICA_STOPPED:
                return
            self.killed = True
            server = self.server
            self._transition(REPLICA_STOPPED)
        if server is not None:
            server.request_stop()
            bg = sync.Thread(
                target=lambda: server.stop(timeout=10.0),
                name=f"replica-kill-{self.name}", daemon=True,
            )
            # started BEFORE it is published: a racing restart that reads
            # the handle must never join an unstarted thread (stdlib join
            # raises, wedging the replica in WARMING).  A reader in the
            # gap sees None, which is safe — start() falls back to
            # old.stop(), whose join covers the same shutdown.  The store
            # itself takes the lock (an unlocked write would race
            # start()'s clear).
            bg.start()
            with self._lock:
                self._bg_stop = bg

    # -- signals ------------------------------------------------------------

    def pending(self) -> int:
        """Queued + dispatched-but-unresolved request count (0 once
        stopped) — what drain-completion and the router's load term
        read.  Cheap by design: called per fleet dispatch."""
        server = self.server
        if server is None or self._state == REPLICA_STOPPED:
            return 0
        return server.pending()

    @property
    def drained(self) -> bool:
        """True when DRAINING and nothing is pending: in-flight work has
        finished and the replica may be released or probed."""
        return self._state == REPLICA_DRAINING and self.pending() == 0

    def health_score(self, p99_ref_s: Optional[float] = None) -> float:
        """The routing signal in [0, 1] (module docstring formula);
        0.0 unless SERVING.  Any-thread: reads only snapshot surfaces."""
        server = self.server
        if server is None or self.killed or self._state != REPLICA_SERVING:
            return 0.0
        res = server.resilience.snapshot()
        n_circ = len(res["circuits"])
        n_open = len(res["open_circuits"])
        score = 1.0 - (n_open / n_circ if n_circ else 0.0)
        ctl = server.controller
        if ctl is not None:
            classes = ctl.snapshot()["classes"]
            if classes:
                depth = max(c["tier"] for c in classes.values())
                score *= 1.0 - 0.5 * (depth / max(1, len(ctl.tiers)))
        if p99_ref_s:
            slo = server.slo_snapshot()
            p99s = [w["p99"] for w in slo["classes"].values()
                    if w.get("window", 0) and "p99" in w]
            if p99s and max(p99s) > p99_ref_s:
                score *= p99_ref_s / max(p99s)
        return max(0.0, min(1.0, score))

    def snapshot(self) -> Dict[str, Any]:
        """JSON-friendly replica state for the fleet's metrics plane."""
        return {
            "state": self._state,
            "capacity_weight": self.capacity_weight,
            "generation": self.generation,
            "killed": self.killed,
            "pending": self.pending(),
            "transitions": len(self._history),
        }

    def __repr__(self) -> str:
        return (f"Replica({self.name!r}, state={self._state!r}, "
                f"weight={self.capacity_weight:g})")
