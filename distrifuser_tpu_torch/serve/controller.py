"""Closed-loop SLO controller: load-driven tier selection over the
quality/cost lattice (the JAX package's serve/controller.py).

The serving stack has a ladder of quality/cost knobs -- denoise step
count, the temporal step cache, stale-refresh wire compression and PCPP
partial refresh.  The failure-driven degradation ladder
(serve/resilience.py) moves along it when something breaks; this module
moves along it under *load*, steering on `InferenceServer.slo_snapshot()`
(per-slo_class rolling p50/p99 plus the queue-depth and inflight gauges):

* a validated, ordered **tier table** (`TierSpec`) walks the lattice from
  full quality to progressively cheaper executors -- step cache, wire
  compression, PCPP partial refresh, reduced steps -- with **admission
  control** past the last tier;
* per SLO class, `SLOController` holds the current tier and, on every
  scheduler tick, compares each tier's PREDICTED latency (calibrated
  per-batch service time x the tier's cost multiplier x the queue-depth
  load factor) against the class's p99 target, walking one rung per
  cooldown toward the cheapest tier that holds the SLO -- and back toward
  full quality, with margin, when load subsides;
* the scheduler maps each batch's key through the winning tier
  (`apply_tier`) -- a different `ExecKey`, so full-quality and degraded
  executors coexist in the `ExecutorCache` like every other key family;
* every decision is traced (track "controller") and counted
  (MetricsRegistry: per-class tier gauges, per-tier dispatch counters,
  transition counters).

**Precedence vs the failure ladder**: the controller picks the tier and
maps the key FIRST; the resilience engine then tracks breakers and sticky
degradation rungs per *tier key* and applies its rungs on top
(`ResilienceEngine.degraded_key`).  Ladder rungs therefore always win.

Determinism: every decision is a pure function of (injected clock,
`slo_snapshot`, the calibration ring) -- replayed load on the same clock
produces the identical tier walk.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import sync
from ..utils.config import validate_step_cache_knobs
from .cache import ExecKey

# The virtual rung past the last tier: reject at admission instead of
# dispatching work that cannot hold its SLO (serve/errors.py
# AdmissionRejectedError).  Not a TierSpec — nothing executes there.
ADMISSION = "admission_control"


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """One rung of the quality/cost lattice.

    ``cost`` is the tier's predicted service-time multiplier relative to
    the full tier (1.0) — the controller's forward model, calibrated
    against measured completions via cost-normalized observations.  The
    knob fields are ``None`` = leave the key's value alone; set = override
    on `apply_tier`.  ``steps_scale`` multiplies the request's step count
    (floor 1).  Knob overrides other than ``steps_scale`` apply to
    displaced-patch keys only — a pipefusion bucket still benefits from
    the step scaling, but the patch-protocol knobs don't exist there."""

    name: str
    cost: float
    step_cache: Optional[Tuple[int, int]] = None
    comm_compress: Optional[str] = None
    refresh_fraction: Optional[float] = None
    steps_scale: float = 1.0

    def validate(self) -> None:
        if not self.name or self.name == ADMISSION:
            raise ValueError(f"invalid tier name {self.name!r}")
        if not (0.0 < self.cost <= 1.0):
            raise ValueError(
                f"tier {self.name!r}: cost must be in (0, 1], got {self.cost}"
            )
        if self.step_cache is not None:
            validate_step_cache_knobs(*self.step_cache)
        if self.comm_compress is not None:
            from ..parallel.compress import validate_mode

            validate_mode(self.comm_compress)
        if self.refresh_fraction is not None:
            from ..parallel.compress import validate_refresh_fraction

            validate_refresh_fraction(self.refresh_fraction)
        if not (0.0 < self.steps_scale <= 1.0):
            raise ValueError(
                f"tier {self.name!r}: steps_scale must be in (0, 1], got "
                f"{self.steps_scale}"
            )


# The default walk down the lattice: full → step
# cache → wire compression → PCPP partial refresh → reduced steps →
# admission control at the extreme.  Costs are the forward-model priors —
# the closed loop corrects for a mesh where they are off, since tier
# escalation keys off MEASURED windows too.
DEFAULT_TIERS: Tuple[TierSpec, ...] = (
    TierSpec("full", 1.0),
    TierSpec("step_cache", 0.75, step_cache=(2, 1)),
    TierSpec("comm_compress", 0.65, step_cache=(2, 1), comm_compress="int8"),
    TierSpec("partial_refresh", 0.55, step_cache=(2, 1),
             comm_compress="int8", refresh_fraction=0.5),
    TierSpec("reduced_steps", 0.3, step_cache=(2, 1), comm_compress="int8",
             refresh_fraction=0.5, steps_scale=0.5),
)


def normalize_tier_table(tiers: Sequence[Any]) -> Tuple[TierSpec, ...]:
    """Validate a tier table (ControllerConfig.tiers): TierSpec instances
    or mapping entries, unique names, the first tier the cost-1.0
    identity, costs strictly decreasing (the walk must actually get
    cheaper — equal-cost rungs would make the controller burn a cooldown
    for nothing).  () resolves to `DEFAULT_TIERS`."""
    if not tiers:
        return DEFAULT_TIERS
    specs: List[TierSpec] = []
    for entry in tiers:
        if isinstance(entry, TierSpec):
            spec = entry
        elif isinstance(entry, dict):
            kw = dict(entry)
            if kw.get("step_cache") is not None:
                kw["step_cache"] = tuple(int(x) for x in kw["step_cache"])
            spec = TierSpec(**kw)
        else:
            raise ValueError(
                f"tier table entries must be TierSpec or dict, got "
                f"{type(entry).__name__}"
            )
        spec.validate()
        specs.append(spec)
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"tier names must be unique, got {names}")
    if specs[0].cost != 1.0:
        raise ValueError(
            "the first tier is the full-quality identity and must have "
            f"cost 1.0, got {specs[0].cost} ({specs[0].name!r})"
        )
    for a, b in zip(specs, specs[1:]):
        if b.cost >= a.cost:
            raise ValueError(
                f"tier costs must strictly decrease along the table: "
                f"{a.name!r} ({a.cost}) -> {b.name!r} ({b.cost})"
            )
    return tuple(specs)


def apply_tier(key: ExecKey, tier: TierSpec) -> ExecKey:
    """Map a bucket's base `ExecKey` through one tier's knob overrides.

    Patch-protocol knobs (step cache, comm_compress, refresh_fraction)
    apply to displaced-patch keys only; ``steps_scale`` applies to every
    key.  The ladder's sticky rungs compose ON TOP of the returned key
    (`ResilienceEngine.degraded_key`), so a rung like ``step_cache_off``
    overrides the tier's cadence — ladder wins, controller retracts."""
    repl: Dict[str, Any] = {}
    if tier.steps_scale != 1.0:
        repl["steps"] = max(1, int(round(key.steps * tier.steps_scale)))
    if key.parallelism == "patch":
        if tier.step_cache is not None:
            repl["step_cache_interval"] = int(tier.step_cache[0])
            repl["step_cache_depth"] = int(tier.step_cache[1])
        if tier.comm_compress is not None:
            repl["comm_compress"] = tier.comm_compress
        if tier.refresh_fraction is not None:
            repl["refresh_fraction"] = float(tier.refresh_fraction)
    return dataclasses.replace(key, **repl) if repl else key


@dataclasses.dataclass
class _ClassState:
    """Per-SLO-class controller state (scheduler-thread mutations; the
    ``tier`` int is read racily by `admit` — a torn read is impossible
    for a GIL-word int, and admission staleness is bounded by one poll)."""

    tier: int = 0
    last_change: float = 0.0
    transitions: int = 0


class SLOController:
    """Per-class tier selection on the injected server clock.

    ``decide``/``poll`` run on the scheduler thread only; ``admit`` and
    ``observe_batch`` are any-thread (lock-guarded where it matters).
    ``snapshot_fn`` is `InferenceServer.slo_snapshot` (or any callable
    with its schema) — the ONE signal surface the controller steers on.
    """

    def __init__(
        self,
        config,
        *,
        clock: Callable[[], float],
        batch_hint: int,
        registry=None,
        tracer=None,
        prompt_cache=None,
    ):
        self.config = config
        self.tiers: Tuple[TierSpec, ...] = tuple(config.tiers)
        self.clock = clock
        self.batch_hint = max(1, int(batch_hint))
        self.tracer = tracer
        self.registry = registry
        self.prompt_cache = prompt_cache
        self._lock = sync.Lock()
        self._classes: Dict[str, _ClassState] = {}
        # cost-normalized per-batch service observations (ring): a batch
        # completing in t seconds at tier i contributes t / cost_i — the
        # full-tier-equivalent service time the predictions scale from
        self._service: List[float] = []
        self._service_sum = 0.0
        # step-granular calibration (step-level continuous batching,
        # serve/stepbatch.py): cost-normalized per-STEP service ring —
        # one cohort step completing in t at mean member cost c
        # contributes t / c.  Feeds both the EDF slack clock and the
        # step-mode occupancy prediction below.
        self._step_service: List[float] = []
        self._step_service_sum = 0.0
        self._dispatches = (registry.counter("serve_controller_dispatches")
                            if registry is not None else None)
        self._transitions = (
            registry.counter("serve_controller_transitions")
            if registry is not None else None)

    # -- shared state helpers -----------------------------------------------

    def _state(self, slo_class: str) -> _ClassState:
        with self._lock:
            st = self._classes.get(slo_class)
            if st is None:
                st = _ClassState(last_change=self.clock())
                self._classes[slo_class] = st
                if self.registry is not None:
                    self.registry.gauge(
                        "serve_controller_tier",
                        labels={"slo_class": slo_class},
                    ).set(0.0)
            return st

    def target(self, slo_class: str) -> float:
        slo = self.config.slo_p99_s
        return float(slo.get(slo_class, slo["default"]))

    def service_estimate(self) -> float:
        """Calibrated full-tier-equivalent per-batch service seconds
        (config.service_prior_s until completions arrive)."""
        with self._lock:
            if not self._service:
                return float(self.config.service_prior_s)
            return self._service_sum / len(self._service)

    def observe_batch(self, tier_idx: Optional[int], exec_s: float) -> None:
        """Record one completed batch's execute seconds, normalized by the
        tier it ran at (any thread — staged decode workers complete
        concurrently with the scheduler)."""
        if tier_idx is None:
            tier_idx = 0
        cost = self.tiers[min(int(tier_idx), len(self.tiers) - 1)].cost
        v = float(exec_s) / cost
        with self._lock:
            self._service.append(v)
            self._service_sum += v
            if len(self._service) > self.config.service_window:
                self._service_sum -= self._service.pop(0)

    def observe_step(self, mean_cost: float, step_s: float,
                     requests: int = 1,
                     dispatches: Optional[int] = None) -> None:
        """Record one cohort denoise step's wall seconds at the cohort's
        mean tier cost (scheduler thread; step-granular servers call this
        instead of per-batch observations — occupancy there is per-step,
        not per-batch).

        ``requests``/``dispatches`` normalize for packed dispatch
        (serve/executors.py step_run): a round that advances R requests
        in D evaluations records the per-REQUEST service ``step_s x
        D/R``, so the step-granular occupancy model and EDF slack don't
        over-predict by exactly the pack factor.  Omitted (or equal, the
        sequential executors), the observation is the raw round time —
        the pre-pack behavior."""
        if dispatches is None:
            dispatches = requests
        v = (float(step_s) / max(float(mean_cost), 1e-9)
             * (float(dispatches) / max(float(requests), 1.0)))
        with self._lock:
            self._step_service.append(v)
            self._step_service_sum += v
            if len(self._step_service) > self.config.service_window:
                self._step_service_sum -= self._step_service.pop(0)

    def step_service_estimate(self) -> Optional[float]:
        """Calibrated full-tier-equivalent per-STEP service seconds, or
        None before any step completed (the step batcher then falls back
        to its own prior/EWMA)."""
        with self._lock:
            if not self._step_service:
                return None
            return self._step_service_sum / len(self._step_service)

    # -- the decision loop (scheduler thread) -------------------------------

    def _predicted(self, idx: int, s_full: float, load_batches: float) -> float:
        """Forward model: a request dispatched now at tier ``idx`` waits
        out the backlog and then its own batch — (1 + backlog-in-batches)
        batch services at the tier's cost."""
        return s_full * self.tiers[idx].cost * (1.0 + load_batches)

    def _effective_service(self) -> float:
        s = self.service_estimate()
        share = self.config.encode_share
        if share and self.prompt_cache is not None:
            s *= 1.0 - share * self.prompt_cache.hit_rate()
        return s

    def _step_predictor(self, snapshot: Dict[str, Any]):
        """Step-granular occupancy forward model (step-level continuous
        batching; the satellite accounting fix): a whole-batch server's
        request waits out (1 + backlog-in-batches) BATCH services, but a
        slot-pool request only waits its own steps plus the backlog's
        steps amortized over the slot width — predicting whole-batch
        completion there over-escalates tiers by roughly the pool width.
        Returns predicted(idx) over ``cost x per_step x (own_steps +
        backlog_steps / slots)``, or None when the snapshot carries no
        step block (whole-batch server)."""
        step = snapshot.get("step")
        if not step:
            return None
        calibrated = self.step_service_estimate()
        per_step = (calibrated if calibrated is not None
                    else float(step.get("per_step_s", 0.0))
                    or self.config.service_prior_s / self.batch_hint)
        own_steps = float(step.get("steps_hint", 1))
        backlog = (snapshot.get("queue_depth", 0) * own_steps
                   + float(step.get("remaining_steps_total", 0)))
        slots = max(1, int(step.get("slots", 1)))

        def predicted(idx: int) -> float:
            return (self.tiers[idx].cost * per_step
                    * (own_steps + backlog / slots))

        return predicted

    def poll(self, snapshot: Dict[str, Any]) -> None:
        """One decision tick over every known SLO class (scheduler
        thread): walk each class one rung toward the least-degraded tier
        whose predicted latency holds its target, under the hysteresis
        cooldowns.  ``snapshot`` is `slo_snapshot()` — when it carries a
        ``"step"`` occupancy block the step-granular forward model
        replaces the whole-batch one (see `_step_predictor`)."""
        now = self.clock()
        cfgc = self.config
        s_full = self._effective_service()
        load_batches = (
            snapshot.get("queue_depth", 0) + snapshot.get(
                "inflight_requests", 0)
        ) / self.batch_hint
        predicted = self._step_predictor(snapshot)
        if predicted is None:
            def predicted(idx: int) -> float:  # noqa: E306 — whole-batch
                return self._predicted(idx, s_full, load_batches)
        with self._lock:
            classes = set(self._classes)
        classes.update(snapshot.get("classes", {}))
        for cls in sorted(classes):
            st = self._state(cls)
            target = self.target(cls)
            # least-degraded tier whose prediction holds the target
            desired = len(self.tiers)
            for idx in range(len(self.tiers)):
                if predicted(idx) <= target:
                    desired = idx
                    break
            # measured breach forces at least one rung down: the forward
            # model may flatter a card whose real service is slower.
            # Only under live load — an idle server's window still holds
            # the burst's latencies (until slo_max_age_s ages them out),
            # and escalating on ghosts would wedge every class at
            # admission with nothing running.
            window = snapshot.get("classes", {}).get(cls, {})
            if (load_batches > 0
                    and window.get("window", 0) >= cfgc.min_samples
                    and window.get("p99", 0.0) > target):
                desired = max(desired, st.tier + 1)
            desired = min(desired, len(self.tiers))  # admission is the cap
            if desired > st.tier:
                if now - st.last_change >= cfgc.escalate_cooldown_s:
                    self._move(cls, st, st.tier + 1, now, "escalate")
            elif desired < st.tier:
                if (now - st.last_change >= cfgc.retract_cooldown_s
                        and predicted(min(st.tier - 1, len(self.tiers) - 1))
                        <= cfgc.retract_margin * target):
                    self._move(cls, st, st.tier - 1, now, "retract")

    def _tier_name(self, idx: int) -> str:
        return ADMISSION if idx >= len(self.tiers) else self.tiers[idx].name

    def _move(self, cls: str, st: _ClassState, to: int, now: float,
              kind: str) -> None:
        frm = st.tier
        st.tier = to
        st.last_change = now
        st.transitions += 1
        name = self._tier_name(to)
        if self._transitions is not None:
            self._transitions.inc(f"{kind}:{cls}:{name}")
        if self.registry is not None:
            self.registry.gauge(
                "serve_controller_tier", labels={"slo_class": cls}
            ).set(float(to))
        if self.tracer is not None:
            self.tracer.event(
                f"tier_{kind}", track="controller",
                args={"slo_class": cls, "from": self._tier_name(frm),
                      "to": name})

    # -- scheduler-side reads ------------------------------------------------

    def admit(self, slo_class: str) -> bool:
        """Admission control (any thread, submit path): False when the
        class currently sits past the last tier — even the cheapest
        program cannot hold its SLO, so the request is rejected with the
        typed 429 instead of queued into certain lateness."""
        return self._state(str(slo_class)).tier < len(self.tiers)

    def tier_for_batch(self, slo_classes: Sequence[str]) -> Tuple[int, TierSpec]:
        """The tier one coalesced batch dispatches at: the CHEAPEST tier
        any member class currently needs (a cheaper tier is faster for
        everyone in the batch; a richer one would blow the tight class's
        SLO).  Admission-parked classes clamp to the last real tier —
        their queued survivors still execute, as cheaply as possible."""
        idx = 0
        for cls in slo_classes:
            idx = max(idx, self._state(str(cls)).tier)
        idx = min(idx, len(self.tiers) - 1)
        return idx, self.tiers[idx]

    def count_dispatch(self, tier_idx: int, n_requests: int) -> None:
        if self._dispatches is not None:
            self._dispatches.inc(self.tiers[tier_idx].name, n_requests)

    # -- observability -------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON state for `metrics_snapshot()["controller"]`."""
        with self._lock:
            classes = {
                cls: {
                    "tier": st.tier,
                    "tier_name": self._tier_name(st.tier),
                    "transitions": st.transitions,
                }
                for cls, st in sorted(self._classes.items())
            }
        return {
            "tiers": [t.name for t in self.tiers] + [ADMISSION],
            "service_estimate_s": self.service_estimate(),
            # step-granular calibration (None until a step-mode server
            # observed its first cohort step)
            "step_service_estimate_s": self.step_service_estimate(),
            "classes": classes,
        }
