"""Retry/backoff, circuit breaking, watchdog, and the degradation ladder.

The serve scheduler (serve/server.py) is one thread driving one pipeline
(on one card, or over n ranks from rank 0: serve/ranks.py); a
failed compile, a transient execute error, a hung device, or an OOM must
cost bounded time and never kill that thread.  This module holds the
policy pieces, all clock-injectable so the math is testable without
sleeping:

* `BackoffPolicy` — exponential backoff with seeded jitter, pure schedule
  math (`delay(attempt)`);
* `RetryBudget` — a global cap on retries across all requests, so a
  correlated failure storm degrades to fast-fail instead of retry
  amplification;
* `CircuitBreaker` — per-`ExecKey` closed → open → half-open machine: a
  poisoned bucket sheds with `CircuitOpenError` in O(dispatch) time
  instead of burning queue time re-failing, and heals via a single probe
  after the cooldown;
* `Watchdog` — bounds batch execution wall-time by running the dispatch
  on an abandonable worker thread; a hang fails the batch
  (`WatchdogTimeoutError`), not the scheduler;
* `DegradationLadder` — the ordered OOM/compile-failure response: split
  the coalesced batch, then per-key program degradations (step-cache off
  → stepwise loop → smaller bucket), each gated by `ResilienceConfig` and
  recorded in metrics.  Ladder steps are *numerically safe*: batch
  membership never changes a request's image (per-request seeded
  latents), and the stepwise loop is the same numerics as the fused scan
  (the eager step-by-step loop, here reused as a policy);
* `ResilienceEngine` — the per-server facade tying these together with
  per-key sticky state and a `snapshot()` for health reporting.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..utils import sync
from ..utils.config import ResilienceConfig
from ..utils.metrics import RingLog
from .cache import ExecKey
from .errors import BuildFailedError, FatalError, WatchdogTimeoutError, is_oom

# Degradation rung names (ordered; also the metric/health vocabulary).
RUNG_SPLIT = "split_batch"
RUNG_STAGING_OFF = "staging_off"
RUNG_STEP_CACHE_OFF = "step_cache_off"
RUNG_PIPELINE_OFF = "pipeline_off"
RUNG_STEPWISE = "stepwise_fallback"
RUNG_WEIGHT_QUANT = "weight_quant_on"
RUNG_BUCKET = "bucket_fallback"


def failure_kind(exc: BaseException) -> str:
    """Classify a dispatch failure for the retry/degradation policy:
    ``"oom"`` (degrade via the ladder), ``"compile"`` (degrade, but
    splitting the batch cannot help — the program, not the data, failed),
    ``"transient"`` (plain retry), ``"fatal"`` (no retry).

    Build failures classify as ``"compile"`` even when memory-shaped:
    the compiled *program* is what failed, so the remedy is a cheaper
    program (the key rungs), never a narrower batch — the compiled batch
    width is a property of the executor, not of the coalesced batch."""
    if isinstance(exc, BuildFailedError):
        return "compile"
    if is_oom(exc):
        return "oom"
    if isinstance(exc, FatalError):
        return "fatal"
    return "transient"


class BackoffPolicy:
    """Exponential backoff with seeded, bounded jitter.

    ``delay(attempt)`` for attempt 1, 2, ... is
    ``min(base * multiplier**(attempt-1), max) * (1 + jitter * u)`` with
    ``u`` uniform in [-1, 1] from this policy's own RNG — deterministic
    per seed, no global random state."""

    def __init__(self, base_s: float, multiplier: float, max_s: float,
                 jitter: float, seed: int = 0):
        assert base_s >= 0 and multiplier >= 1 and max_s >= base_s, (
            base_s, multiplier, max_s)
        assert 0.0 <= jitter < 1.0, jitter
        self.base_s = base_s
        self.multiplier = multiplier
        self.max_s = max_s
        self.jitter = jitter
        self._rng = random.Random(seed)

    def delay(self, attempt: int) -> float:
        assert attempt >= 1, attempt
        d = min(self.base_s * self.multiplier ** (attempt - 1), self.max_s)
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return d

    def schedule(self, attempts: int) -> List[float]:
        """The next ``attempts`` delays (consumes the jitter stream)."""
        return [self.delay(i + 1) for i in range(attempts)]


class RetryBudget:
    """Global (server-wide) retry token bucket: every retry anywhere
    draws one token.  Under a correlated failure storm the bucket empties
    and failures surface immediately — bounded work, no retry
    amplification — while ``refill_per_s`` trickles capacity back so a
    long-lived server's routine transient blips never permanently strip
    it of retries (``refill_per_s=0`` gives a strict lifetime cap).
    Clock-injectable, so refill math is testable without sleeping."""

    def __init__(self, total: int, refill_per_s: float = 0.0,
                 clock: Callable[[], float] = time.monotonic):
        assert total >= 0, total
        assert refill_per_s >= 0, refill_per_s
        self.total = total
        self.refill_per_s = refill_per_s
        self.clock = clock
        self._tokens = float(total)
        self._last = clock()
        self._lock = sync.Lock()

    def _refill_locked(self) -> None:
        now = self.clock()
        if self.refill_per_s > 0 and now > self._last:
            self._tokens = min(
                float(self.total),
                self._tokens + (now - self._last) * self.refill_per_s,
            )
        self._last = now

    def acquire(self) -> bool:
        with self._lock:
            self._refill_locked()
            if self._tokens < 1.0:
                return False
            self._tokens -= 1.0
            return True

    @property
    def remaining(self) -> int:
        with self._lock:
            self._refill_locked()
            return int(self._tokens)


class CircuitBreaker:
    """Closed → open → half-open breaker for one executor key.

    * CLOSED: everything flows; ``failure_threshold`` *consecutive*
      failures trip it OPEN.
    * OPEN: ``allow()`` is False (callers shed with `CircuitOpenError`)
      until ``cooldown_s`` has elapsed.
    * HALF_OPEN: exactly one probe is allowed through; its success closes
      the breaker, its failure re-opens (and re-arms the cooldown).

    All transitions take the injected ``clock`` so tests drive them
    without sleeping.  Not internally locked, and deliberately so: ONLY
    the owning scheduler thread calls the mutating methods (`allow`,
    `record_success`, `record_failure`), while `state()`/`snapshot()` —
    reachable from any thread via ``health()``/``metrics_snapshot()`` —
    are PURE reads that report the effective state without transitioning
    (a reader must never be able to reset the probe-in-flight latch out
    from under the scheduler)."""

    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"

    def __init__(self, failure_threshold: int, cooldown_s: float,
                 clock: Callable[[], float] = time.monotonic):
        assert failure_threshold >= 1, failure_threshold
        assert cooldown_s >= 0, cooldown_s
        self.failure_threshold = failure_threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self.times_opened = 0

    def _cooled(self) -> bool:
        return self.clock() - self._opened_at >= self.cooldown_s

    def state(self) -> str:
        """Effective state — a pure read, safe from any thread."""
        if self._state == self.OPEN and self._cooled():
            return self.HALF_OPEN
        return self._state

    def _maybe_half_open(self) -> None:
        # mutating cooldown transition: scheduler-thread-only callers
        if self._state == self.OPEN and self._cooled():
            self._state = self.HALF_OPEN
            self._probe_inflight = False

    def allow(self) -> bool:
        """May a dispatch for this key proceed right now?  In HALF_OPEN
        the first call is the probe; further calls shed until the probe's
        outcome is recorded."""
        self._maybe_half_open()
        if self._state == self.CLOSED:
            return True
        if self._state == self.HALF_OPEN and not self._probe_inflight:
            self._probe_inflight = True
            return True
        return False

    def record_success(self) -> None:
        self._state = self.CLOSED
        self._consecutive_failures = 0
        self._probe_inflight = False

    def record_failure(self) -> None:
        self._maybe_half_open()
        self._consecutive_failures += 1
        if self._state == self.HALF_OPEN:
            self._trip()  # failed probe: straight back to OPEN
        elif (self._state == self.CLOSED
              and self._consecutive_failures >= self.failure_threshold):
            self._trip()

    def _trip(self) -> None:
        self._state = self.OPEN
        self._opened_at = self.clock()
        self._probe_inflight = False
        self.times_opened += 1

    def snapshot(self) -> Dict[str, Any]:
        return {
            "state": self.state(),
            "consecutive_failures": self._consecutive_failures,
            "times_opened": self.times_opened,
        }


class Watchdog:
    """Bound a callable's wall-time without killing the calling thread.

    ``run(fn)`` executes ``fn`` on a fresh daemon worker; if it does not
    finish within ``timeout_s`` the call raises `WatchdogTimeoutError`
    and the worker is *abandoned* (Python threads cannot be killed — the
    stalled device work eventually finishes or dies on its own; its result
    lands in a dead holder and is discarded).  ``timeout_s <= 0``
    disables the bound (``fn`` runs inline).

    The card is never double-dispatched: the next ``run()`` after an
    abandonment first waits (up to another ``timeout_s``) for the
    abandoned worker to drain, and sheds with `WatchdogTimeoutError` if
    it is still running — a retry can therefore never overlap the stuck
    call's device work, and at most ONE abandoned worker exists at a
    time.  One worker is spawned per call: the abandoned thread cannot be
    reused, which rules out a single-worker pool.

    Over n ranks (serve/ranks.py) the abandoned call is a command that may
    sit inside a collective the other ranks entered (or wait for a rank
    that hangs in one, or that left the operation between two
    collectives, as a rank does on an OOM of its own).  So a timeout there
    also aborts the data groups on every rank (`RankLeader.abort`): on
    NCCL the waiting collectives end, on gloo they leave through the
    groups' timeout, and each follower abandons its lane as this watchdog
    abandons its worker.  The next dispatch rebuilds the groups once the
    abandoned command has ended, and sheds with `WatchdogTimeoutError`
    after another ``timeout_s`` while it still runs -- the bound above,
    held over the ranks (`InferenceServer._ranks_rebuild`).  The server
    keeps serving, as the JAX package's does.

    Single-consumer by design (the scheduler thread); ``timeouts`` is
    observability."""

    def __init__(self, timeout_s: float):
        self.timeout_s = timeout_s
        self.timeouts = 0  # observability; incremented on every firing
        self._abandoned: Optional[threading.Event] = None

    @property
    def abandoned_event(self) -> Optional[threading.Event]:
        """The done-event of the currently abandoned worker (None when no
        abandonment is outstanding).  Callers holding resources the
        abandoned work still uses (the staged pipeline's executor pins)
        wait on it before releasing them."""
        return self._abandoned

    def run(self, fn: Callable[[], Any]) -> Any:
        if self.timeout_s <= 0:
            return fn()
        if self._abandoned is not None:
            # a previously abandoned worker may still hold the card:
            # serialize behind it rather than dispatching concurrently
            if not self._abandoned.wait(self.timeout_s):
                self.timeouts += 1
                raise WatchdogTimeoutError(
                    f"previously abandoned batch still running after a "
                    f"further {self.timeout_s:.3f}s; shedding this dispatch"
                )
            self._abandoned = None
        done = sync.Event()
        holder: List[Tuple[str, Any]] = []

        def work():
            try:
                holder.append(("ok", fn()))
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                holder.append(("err", exc))
            finally:
                done.set()

        t = sync.Thread(target=work, name="serve-watchdog-work",
                             daemon=True)
        t.start()
        if not done.wait(self.timeout_s):
            self.timeouts += 1
            self._abandoned = done
            raise WatchdogTimeoutError(
                f"batch execution exceeded the {self.timeout_s:.3f}s "
                "watchdog bound; batch abandoned"
            )
        status, value = holder[0]
        if status == "err":
            raise value
        return value


@dataclasses.dataclass
class KeyResilience:
    """Sticky per-`ExecKey` resilience state: its breaker, the degradation
    rungs applied so far (in order), and the batch-size cap the split rung
    learned.  Rungs are sticky by design — a bucket that OOM'd at the
    fused program will OOM again; re-discovering that per request would
    burn a retry every time."""

    breaker: CircuitBreaker
    rungs: List[str] = dataclasses.field(default_factory=list)
    batch_cap: Optional[int] = None
    last_error: str = ""
    # rungs retracted because applying them proved deterministically
    # impossible for this key's build function (executors.apply_key_policy raised
    # DegradationInapplicableError — e.g. weight_quant_on against a
    # tensor/pipefusion pipeline): pinned so next_rung never re-picks them
    inapplicable: List[str] = dataclasses.field(default_factory=list)


class DegradationLadder:
    """Ordered response to OOM/compile failures.

    ``next_rung(state, kind, key, batch_size)`` picks the next applicable
    rung (or None when the ladder is exhausted):

    1. `split_batch` (OOM only, batch > 1): halve the coalesced batch and
       retry the halves — per-request seeded latents make the halves
       bit-identical to the unsplit batch, so this is free of quality
       cost.  It relieves memory that scales with the REQUEST count (the
       stacked per-request latents draw, dynamic-width executors, host
       buffers); an OOM inside a fixed-width compiled program is not
       helped by narrower request batches (PipelineExecutor pads back to
       the compiled width), and falls through — after at most
       log2(batch) split attempts, once per key thanks to the sticky
       cap — to the program-level rungs below;
    2. `staging_off` (staged servers only, serve/staging.py): stop
       pipelining this key's batches — with up to ``max_inflight_batches``
       batches resident, overlap is the cheapest memory to give back, and it
       changes neither the program nor the numerics (the key itself is
       unchanged; the server routes the key monolithically);
    3. `step_cache_off`: recompile without the temporal step-cache
       cadence (its deep-feature carry is memory the graphed program can live
       without);
    4. `pipeline_off` (pipefusion keys only; `allow_pipeline_off`):
       rebuild the key as displaced patch parallelism
       (parallelism="patch", pipe_patches dropped) — the degraded key is
       EXACTLY the key a patch-parallel bucket uses, so the rebuild is
       bit-identical to a fresh patch executor and shares its cache
       entry.  This is the pipefusion analog of `stepwise_fallback`
       (which never applies to pipefusion keys — there is no host-driven
       stepwise loop to fall back to);
    5. `stepwise_fallback`: swap the fused scan for the host-driven
       stepwise loop — the eager step-by-step loop reused as a policy: same
       numerics, a much smaller program to compile and hold;
    6. `weight_quant_on` (off by default — the first rung whose outputs
       CHANGE, within the pinned parity tolerances): rebuild the key with
       int8 quantized weights (ExecKey.weight_quant="int8",
       executors.apply_key_policy quantizes the built tree) — roughly
       halves the executor's weight memory, the biggest single give-back,
       while keeping the resolution contract bucket_fallback would break;
    7. `bucket_fallback` (off by default — it changes the output
       resolution contract): serve the request at the next smaller
       configured bucket.

    ``apply(key, rungs)`` maps an `ExecKey` through the applied rungs to
    the key that should actually execute (``staging_off`` is a dispatch-
    mode rung: it leaves the key unchanged)."""

    KEY_RUNGS = (RUNG_STAGING_OFF, RUNG_STEP_CACHE_OFF, RUNG_PIPELINE_OFF,
                 RUNG_STEPWISE, RUNG_WEIGHT_QUANT, RUNG_BUCKET)

    def __init__(self, config: ResilienceConfig,
                 buckets: Sequence[Tuple[int, int]] = (),
                 staging: bool = False):
        self.config = config
        # does the owning server pipeline its dispatches?  gates the
        # staging_off rung (a monolithic server has no staging to turn off)
        self.staging = staging
        # area-major, like serve.batcher.BucketTable
        self.buckets = tuple(sorted(
            {(int(h), int(w)) for h, w in buckets},
            key=lambda hw: (hw[0] * hw[1], hw),
        ))

    def _smaller_bucket(self, key: ExecKey) -> Optional[Tuple[int, int]]:
        smaller = [b for b in self.buckets
                   if b[0] * b[1] < key.height * key.width]
        return smaller[-1] if smaller else None

    def _applicable(self, rung: str, key: ExecKey) -> bool:
        cfg = self.config
        if rung == RUNG_STAGING_OFF:
            return self.staging and cfg.allow_staging_off
        if rung == RUNG_STEP_CACHE_OFF:
            return cfg.allow_step_cache_off and key.step_cache_interval > 1
        if rung == RUNG_PIPELINE_OFF:
            return (cfg.allow_pipeline_off
                    and key.parallelism == "pipefusion")
        if rung == RUNG_STEPWISE:
            # never for pipefusion keys: no host-driven stepwise loop
            # exists there — pipeline_off is their program-level rung
            return (cfg.allow_stepwise_fallback
                    and key.exec_mode == "fused"
                    and key.parallelism != "pipefusion")
        if rung == RUNG_WEIGHT_QUANT:
            return cfg.allow_weight_quant_on and key.weight_quant == "none"
        if rung == RUNG_BUCKET:
            return (cfg.allow_bucket_fallback
                    and self._smaller_bucket(key) is not None)
        return False

    def next_rung(self, state: KeyResilience, kind: str, key: ExecKey,
                  batch_size: int) -> Optional[str]:
        if kind not in ("oom", "compile"):
            return None
        if (kind == "oom" and self.config.allow_batch_split and batch_size > 1):
            return RUNG_SPLIT  # not a key rung: recorded as batch_cap
        if len(state.rungs) >= self.config.max_degradations:
            return None
        degraded = self.apply(key, state.rungs)
        for rung in self.KEY_RUNGS:
            if (rung not in state.rungs
                    and rung not in state.inapplicable
                    and self._applicable(rung, degraded)):
                return rung
        return None

    def apply(self, key: ExecKey, rungs: Sequence[str]) -> ExecKey:
        for rung in rungs:
            # RUNG_STAGING_OFF changes the dispatch mode, not the key
            if rung == RUNG_STEP_CACHE_OFF:
                key = dataclasses.replace(
                    key, step_cache_interval=1, step_cache_depth=0)
            elif rung == RUNG_PIPELINE_OFF:
                # the degraded key IS the patch bucket's key: the rebuild
                # shares its cache entry bit-for-bit
                key = dataclasses.replace(
                    key, parallelism="patch", pipe_patches=0)
            elif rung == RUNG_STEPWISE:
                key = dataclasses.replace(key, exec_mode="stepwise")
            elif rung == RUNG_WEIGHT_QUANT:
                # int8 over fp8: universally available, and the rung's
                # point is bytes — both payloads are 1 byte/element
                key = dataclasses.replace(key, weight_quant="int8")
            elif rung == RUNG_BUCKET:
                b = self._smaller_bucket(key)
                if b is not None:
                    key = dataclasses.replace(key, height=b[0], width=b[1])
        return key


class ResilienceEngine:
    """Per-server facade over the policy pieces plus per-key sticky state.

    Owned and driven by `InferenceServer`'s single scheduler thread;
    ``snapshot()`` may be read from any thread (dict copies under GIL
    semantics, same consistency class as the rest of the serve metrics).
    """

    def __init__(
        self,
        config: Optional[ResilienceConfig] = None,
        *,
        buckets: Sequence[Tuple[int, int]] = (),
        clock: Callable[[], float] = time.monotonic,
        sleep: Optional[Callable[[float], Any]] = None,
        staging: bool = False,
        tracer: Any = None,
    ):
        self.config = config or ResilienceConfig()
        self.clock = clock
        # optional utils.trace.Tracer: breaker transitions and ladder
        # moves land as instants on the "resilience" track so a Perfetto
        # view shows WHY a key's requests started shedding/degrading.
        # None (default) = zero tracing overhead on the failure path.
        self.tracer = tracer
        # sleep is injectable so (a) tests never block and (b) the server
        # passes a stop-interruptible wait, keeping stop() deterministic
        # even mid-backoff
        self.sleep = sleep if sleep is not None else time.sleep
        self.backoff = BackoffPolicy(
            self.config.backoff_base_s, self.config.backoff_multiplier,
            self.config.backoff_max_s, self.config.backoff_jitter,
            seed=self.config.seed,
        )
        self.budget = RetryBudget(self.config.retry_budget,
                                  self.config.retry_budget_refill_per_s,
                                  clock=self.clock)
        self.watchdog = Watchdog(self.config.watchdog_timeout_s)
        self.ladder = DegradationLadder(self.config, buckets,
                                        staging=staging)
        self.last_errors = RingLog(capacity=self.config.last_errors_capacity)
        # _keys_lock guards MAP membership only (insert/evict in
        # key_state, iteration copy in snapshot) — snapshot() is
        # documented as any-thread, and a health poll overlapping the
        # first dispatch for a new key must not hit "dict changed size
        # during iteration".  The KeyResilience VALUES stay
        # scheduler-owned.  The map is LRU-bounded (max_tracked_keys):
        # ExecKey space is request-controlled (steps is a submit
        # parameter), so per-key state must not grow — nor the health
        # payload serialize — one entry per distinct key ever seen.
        # Eviction prefers "boring" state (closed breaker, no rungs):
        # open circuits and learned degradations are the state worth
        # keeping.
        from collections import OrderedDict

        self._keys: "OrderedDict[ExecKey, KeyResilience]" = OrderedDict()
        self._keys_lock = sync.Lock()

    # -- per-key state ------------------------------------------------------

    @staticmethod
    def _boring(st: KeyResilience) -> bool:
        return (st.breaker.state() == CircuitBreaker.CLOSED
                and not st.rungs and st.batch_cap is None)

    def key_state(self, key: ExecKey) -> KeyResilience:
        with self._keys_lock:
            st = self._keys.get(key)
            if st is not None:
                self._keys.move_to_end(key)
                return st
            st = KeyResilience(breaker=CircuitBreaker(
                self.config.breaker_failure_threshold,
                self.config.breaker_cooldown_s,
                clock=self.clock,
            ))
            self._keys[key] = st
            if len(self._keys) > self.config.max_tracked_keys:
                # never victimize the key just inserted (it is always the
                # freshest AND "boring" — a fresh breaker with no rungs —
                # so a naive scan would evict it on every lookup and its
                # circuit could never trip); prefer the oldest boring
                # OTHER entry, else the oldest other entry outright
                victim = next(
                    (k for k, s in self._keys.items()
                     if k != key and self._boring(s)),
                    None,
                )
                if victim is None:
                    victim = next(k for k in self._keys if k != key)
                del self._keys[victim]
            return st

    def allow(self, key: ExecKey) -> bool:
        return self.key_state(key).breaker.allow()

    def _breaker_transition(self, key: ExecKey, breaker: CircuitBreaker,
                            mutate: Callable[[], None]) -> None:
        """Run one breaker mutation, emitting a trace instant when the
        effective state changed (trip, re-open, heal)."""
        if self.tracer is None:
            mutate()
            return
        before = breaker.state()
        mutate()
        after = breaker.state()
        if after != before:
            self.tracer.event(f"breaker_{after}", track="resilience",
                              args={"key": key.short(), "from": before})

    def on_success(self, key: ExecKey) -> None:
        br = self.key_state(key).breaker
        self._breaker_transition(key, br, br.record_success)

    def note_error(self, key: ExecKey, exc: BaseException) -> None:
        """Record an attempt failure for observability (health's
        last_errors) WITHOUT feeding the breaker — retried attempts are
        not dispatch outcomes."""
        st = self.key_state(key)
        st.last_error = f"{type(exc).__name__}: {exc}"
        self.last_errors.add(f"{key.short()}: {st.last_error}")

    def on_failure(self, key: ExecKey, exc: BaseException) -> None:
        """Record a TERMINAL dispatch failure: the breaker counts whole
        failed dispatch sequences (retries exhausted / fatal / contract
        violation), never individual retried attempts — otherwise any
        single transient blip that exhausts max_retries would also trip
        the circuit, conflating two separately-tuned policies."""
        self.note_error(key, exc)
        br = self.key_state(key).breaker
        self._breaker_transition(key, br, br.record_failure)

    def record_terminal_failure(self, key: ExecKey) -> None:
        """Breaker-only terminal mark for a failure whose error was
        already ring-logged via note_error (the retry loop's exhaustion
        branches)."""
        br = self.key_state(key).breaker
        self._breaker_transition(key, br, br.record_failure)

    def degrade(self, key: ExecKey, kind: str,
                batch_size: int) -> Optional[str]:
        """Advance the key's sticky degradation state; returns the rung
        taken (the caller implements `split_batch`; key rungs apply via
        `degraded_key`), or None when the ladder is exhausted."""
        st = self.key_state(key)
        rung = self.ladder.next_rung(st, kind, key, batch_size)
        if rung == RUNG_SPLIT:
            cap = max(1, (batch_size + 1) // 2)
            st.batch_cap = cap if st.batch_cap is None else min(st.batch_cap,
                                                                cap)
        elif rung is not None:
            st.rungs.append(rung)
        if rung is not None and self.tracer is not None:
            self.tracer.event(f"degrade_{rung}", track="resilience",
                              args={"key": key.short(), "kind": kind})
        return rung

    def retract_rung(self, key: ExecKey, rung: str) -> Optional[str]:
        """Un-apply a sticky rung whose application proved impossible for
        this key's build function (the build raised through
        `executors.apply_key_policy`'s DegradationInapplicableError) and
        pin it inapplicable so `next_rung` never re-picks it — a transient
        OOM must not become a permanently failing key.  Returns the rung
        when it was actually retracted, None when it was never applied
        (the key itself requested the impossible field: that is the
        caller's contract error, and the normal retry path fails it)."""
        st = self.key_state(key)
        if rung not in st.rungs:
            return None
        st.rungs.remove(rung)
        if rung not in st.inapplicable:
            st.inapplicable.append(rung)
        if self.tracer is not None:
            self.tracer.event(f"retract_{rung}", track="resilience",
                              args={"key": key.short()})
        return rung

    def degraded_key(self, key: ExecKey) -> ExecKey:
        with self._keys_lock:
            st = self._keys.get(key)
        if st is None or not st.rungs:
            return key
        return self.ladder.apply(key, st.rungs)

    def batch_cap(self, key: ExecKey) -> Optional[int]:
        with self._keys_lock:
            st = self._keys.get(key)
        return st.batch_cap if st is not None else None

    # -- retry bookkeeping --------------------------------------------------

    def acquire_retry(self) -> bool:
        return self.budget.acquire()

    def backoff_delay(self, attempt: int) -> float:
        return self.backoff.delay(attempt)

    # -- observability ------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-friendly resilience state for `InferenceServer.health()`
        and the metrics artifact (schema in docs/SERVING.md).  Callable
        from any thread: the key map is copied under its lock before
        iterating."""
        with self._keys_lock:
            items = list(self._keys.items())
        circuits = {k.short(): st.breaker.snapshot() for k, st in items}
        degradations = {}
        for k, st in items:
            if st.rungs or st.batch_cap is not None or st.inapplicable:
                entry: Dict[str, Any] = {"rungs": list(st.rungs)}
                if st.batch_cap is not None:
                    entry["batch_cap"] = st.batch_cap
                if st.inapplicable:
                    entry["inapplicable"] = list(st.inapplicable)
                degradations[k.short()] = entry
        return {
            "circuits": circuits,
            "open_circuits": sorted(
                s for s, c in circuits.items() if c["state"] != "closed"),
            "degradations": degradations,
            "retry_budget_remaining": self.budget.remaining,
            "watchdog_timeouts": self.watchdog.timeouts,
            "last_errors": self.last_errors.snapshot(),
        }
