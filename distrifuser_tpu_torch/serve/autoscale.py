"""Elastic replica-pool autoscaler riding the fleet housekeeping tick (the
JAX package's serve/autoscale.py).

`FleetRouter` (serve/fleet.py) treats its replica set as fixed: every
configured slot starts at `start()` and serves until stopped.  That is
the right shape when warming a replica is expensive — you pay it once, up
front.  Where a warm-up is cheap enough (the JAX package's persistent AOT
executable store makes it so there; the port's warm-up is a pipeline
build and graph capture, and its store comes later), capacity can FOLLOW
load instead of being provisioned for the peak.

`Autoscaler` closes that loop.  Attached by the router when
``FleetConfig.autoscale.enabled``, it runs on the existing housekeeping
tick and scales the ACTIVE pool (slots not operator-drained) between
``min_replicas`` and ``max_replicas`` from the step-granular occupancy
model the SLO controller reads (`InferenceServer.slo_snapshot()["step"]`):

* **Pressure** is fleet demand over fleet capacity in SLOT-UNITS:
  occupied + parked denoise slots + queued requests (per-step accounting
  on step-batching replicas; queue + in-flight on monolithic ones) plus
  router-parked requests, divided by the serving slot capacity.  1.0
  means every denoise slot is busy and nothing waits; above it, work
  queues.

* **Scale up** when pressure holds at or above ``pressure_high`` for
  ``up_sustain_s``: one dormant slot (never-started, or released by an
  earlier scale-down) is started on a background thread and joins
  routing when SERVING.

* **Scale down** when pressure holds at or below ``pressure_low`` for
  ``down_sustain_s``: the emptiest serving replica is drained via
  ``FleetRouter.drain_replica(release=True, drain_deadline_s=...)`` —
  the carry-migration path: in-flight work finishes or exports its mid-denoise
  carry at the deadline and resumes on a surviving replica, so
  scale-down discards no completed steps.

* **One operation at a time**, ``cooldown_s`` between decisions, and
  sustain windows on both edges — the classic hysteresis trio, so a
  bursty queue cannot flap the pool.

Determinism: `tick(now)` takes the clock value from the router tick, all
policy state moves under the autoscaler's own lock, and tests drive it
with an injected clock — the only threads are
the scale operations themselves, which tests join by polling replica
state exactly like the restart path's tests.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, TYPE_CHECKING

from ..utils import sync
from ..utils.config import AutoscaleConfig
from .replica import REPLICA_SERVING, REPLICA_STARTING, REPLICA_STOPPED

if TYPE_CHECKING:  # pragma: no cover - import cycle guard (fleet -> us)
    from .fleet import FleetRouter


def fleet_pressure(demand: float, capacity: float) -> float:
    """Demand over capacity in slot-units; infinite when demand exists
    but nothing serves (the all-replicas-down edge must read as maximal
    pressure, not zero).  Pure math, unit-tested directly."""
    if capacity <= 0.0:
        return float("inf") if demand > 0.0 else 0.0
    return demand / capacity


class Autoscaler:
    """The policy loop (module docstring).  Constructed by `FleetRouter`
    when ``FleetConfig.autoscale.enabled``; not a public entry point.

    All mutable policy state (`_above_since`/`_below_since` sustain
    marks, the cooldown stamp, the single-operation latch, the last
    computed pressure) moves under ``_lock`` — `tick` runs on the fleet
    tick thread while scale operations complete on their own background
    threads and tests poke the loop directly.
    """

    def __init__(self, router: "FleetRouter", config: AutoscaleConfig):
        self.router = router
        self.config = config
        self.clock = router.clock
        self.registry = router.registry
        self.counters = self.registry.counter("fleet_autoscale")
        self._lock = sync.Lock()
        self._above_since: Optional[float] = None
        self._below_since: Optional[float] = None
        self._last_action_at = float("-inf")
        self._op_inflight = False
        self._last_pressure = 0.0
        # rebuilt-router contract mirrors the fleet gauges: replace any
        # predecessor's closures, never conflict
        gauges = {
            "fleet_autoscale_pressure": lambda: float(self._last_pressure),
            "fleet_autoscale_active": lambda: float(self.active_count()),
        }
        for gname, fn in gauges.items():
            self.registry.unregister(gname)
            self.registry.gauge(gname, fn)

    # -- bounds -------------------------------------------------------------

    @property
    def max_replicas(self) -> int:
        """``max_replicas`` with 0 meaning "every configured slot"."""
        n = len(self.router._slots)
        m = self.config.max_replicas
        return n if m <= 0 else min(m, n)

    @property
    def min_replicas(self) -> int:
        return min(self.config.min_replicas, len(self.router._slots))

    def active_count(self) -> int:
        """Slots currently in (or joining) the routing pool: everything
        not operator-drained.  A slot mid-start or mid-auto-restart
        counts — its capacity is committed even if not yet admitting."""
        with self.router._lock:
            return sum(1 for s in self.router._slots.values()
                       if not s.manual)

    # -- the occupancy signal -----------------------------------------------

    def pressure(self) -> float:
        """Fleet demand / fleet capacity in slot-units (module
        docstring).  Reads only snapshot surfaces — any-thread."""
        router = self.router
        with router._lock:
            slots = list(router._slots.values())
            parked = len(router._parked)
        demand = float(parked)
        capacity = 0.0
        for slot in slots:
            rep = slot.replica
            if slot.manual or rep.state != REPLICA_SERVING:
                continue
            server = rep.server
            if server is None:
                continue
            snap = server.slo_snapshot()
            step = snap.get("step")
            if step is not None:
                # step-granular pool: capacity is the slot pool, demand
                # is occupied + parked-for-a-slot + still-queued
                capacity += float(step["slots"]) * rep.capacity_weight
                demand += (step["occupied"] + step["parked"]
                           + snap["queue_depth"])
            else:
                # monolithic server: one batch at a time is "one slot"
                capacity += 1.0 * rep.capacity_weight
                demand += (snap["queue_depth"]
                           + snap["inflight_requests"])
        return fleet_pressure(demand, capacity)

    # -- the policy loop ----------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One policy evaluation (called from `FleetRouter.tick`).
        Returns the action taken ("up"/"down") or None — the return is
        for tests; effects go through the router."""
        cfg = self.config
        if now is None:
            now = self.clock()
        p = self.pressure()
        with self._lock:
            self._last_pressure = p if p != float("inf") else -1.0
            # sustain bookkeeping: a mark survives only while its side
            # of the band holds
            if p >= cfg.pressure_high:
                if self._above_since is None:
                    self._above_since = now
            else:
                self._above_since = None
            if p <= cfg.pressure_low:
                if self._below_since is None:
                    self._below_since = now
            else:
                self._below_since = None
            if self._op_inflight:
                return None
            if now - self._last_action_at < cfg.cooldown_s:
                return None
            up = (self._above_since is not None
                  and now - self._above_since >= cfg.up_sustain_s)
            down = (self._below_since is not None
                    and now - self._below_since >= cfg.down_sustain_s)
        if up:
            return self._scale_up(now)
        if down:
            return self._scale_down(now)
        return None

    # -- scale operations ---------------------------------------------------

    def _pick_dormant(self) -> Optional[str]:
        """Lowest-index operator-drained slot that can start: dormant
        (never started) or released by an earlier scale-down.  Skips
        anything with a scale/restart op already riding it."""
        with self.router._lock:
            cands = [
                s for s in self.router._slots.values()
                if s.manual and not s.restarting
                and s.replica.state in (REPLICA_STARTING, REPLICA_STOPPED)
            ]
            cands.sort(key=lambda s: s.index)
            return cands[0].replica.name if cands else None

    def _pick_victim(self) -> Optional[str]:
        """Emptiest serving replica, highest index breaking ties — the
        last slot added is the first released, keeping the steady-state
        pool prefix-stable."""
        with self.router._lock:
            cands = [
                s for s in self.router._slots.values()
                if not s.manual and not s.restarting
                and s.replica.state == REPLICA_SERVING
            ]
            if not cands:
                return None
            cands.sort(key=lambda s: (s.replica.pending(), -s.index))
            return cands[0].replica.name

    def _scale_up(self, now: float) -> Optional[str]:
        if self.active_count() >= self.max_replicas:
            self.counters.inc("up_blocked_max")
            return None
        name = self._pick_dormant()
        if name is None:
            self.counters.inc("up_no_candidate")
            return None
        router = self.router
        slot = router._slots[name]
        with self._lock:
            self._op_inflight = True
            self._last_action_at = now
            self._above_since = None
        with router._lock:
            # joins the pool NOW for bounds/active accounting; invisible
            # to routing until the replica reaches SERVING
            slot.manual = False
            slot.restarting = True
        self.counters.inc("scale_ups")
        router._trace("scale_up", replica=name,
                      pressure=round(self._last_pressure, 4))

        def run():
            try:
                slot.replica.start()  # warm-from-store when present
            except Exception:  # noqa: BLE001 — re-evaluated next tick
                with router._lock:
                    slot.manual = True  # back out of the pool
                self.counters.inc("scale_up_failures")
            finally:
                with router._lock:
                    slot.restarting = False
                with self._lock:
                    self._op_inflight = False

        sync.Thread(target=run, daemon=True,
                    name=f"fleet-scale-up-{name}").start()
        return "up"

    def _scale_down(self, now: float) -> Optional[str]:
        if self.active_count() <= self.min_replicas:
            self.counters.inc("down_blocked_min")
            return None
        name = self._pick_victim()
        if name is None:
            self.counters.inc("down_no_candidate")
            return None
        router = self.router
        with self._lock:
            self._op_inflight = True
            self._last_action_at = now
            self._below_since = None
        self.counters.inc("scale_downs")
        router._trace("scale_down", replica=name,
                      pressure=round(self._last_pressure, 4))

        def run():
            try:
                # the carry-migration drain: in-flight work finishes or
                # exports at the deadline and resumes elsewhere — zero
                # completed steps re-execute (drain_replica docstring)
                router.drain_replica(
                    name, release=True,
                    drain_deadline_s=self.config.drain_deadline_s)
            except Exception:  # noqa: BLE001 — e.g. a racing fleet stop
                self.counters.inc("scale_down_failures")
            finally:
                with self._lock:
                    self._op_inflight = False

        sync.Thread(target=run, daemon=True,
                    name=f"fleet-scale-down-{name}").start()
        return "down"

    # -- observability ------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "pressure": self._last_pressure,
                "active": self.active_count(),
                "min": self.min_replicas,
                "max": self.max_replicas,
                "op_inflight": self._op_inflight,
                "counters": self.counters.snapshot(),
            }
