"""The long-lived inference server: admission -> micro-batch -> execute.

`InferenceServer` ties the serve pieces together around one pipeline,
which spans one card or, through serve/ranks.py, n ranks:

* `submit()` (any thread) runs admission control and returns a
  `concurrent.futures.Future` resolving to a `ServeResult`;
* a single scheduler thread drains the queue through the `MicroBatcher`,
  fetches the bucket's executor from the `ExecutorCache` (warm = hit, cold
  = build and capture), runs the coalesced batch through it, and resolves
  the futures (the executor pads to its prepared batch width and strips);
* every request's lifecycle (queue wait, batch size, cache hit/miss,
  execute and end-to-end latency) lands in streaming histograms
  (utils/metrics.py) exported as one JSON artifact.

One scheduler thread is deliberate: the service owns one pipeline, and
its card runs one program at a time -- extra dispatch threads would only
interleave builds with execution.  Concurrency lives in the *queue*
(callers block on futures, not on the card) and in the batcher that turns
queue depth into batch width.

Failures are policy, not luck (serve/resilience.py, configured by
`ServeConfig.resilience`): build/execute errors are typed
(serve/errors.py), retried with exponential backoff under a global retry
budget; a hung batch is bounded by the watchdog and fails without killing
the scheduler; a key that keeps failing trips its circuit breaker and
sheds fast with `CircuitOpenError`; OOM/compile failures walk the
graceful-degradation ladder (split the coalesced batch -- bit-identical
outputs, per-request seeds -- then rebuild without the step cache, then
the stepwise loop, then int8 weights, then a smaller bucket).  A real
``torch.cuda.OutOfMemoryError`` is an OOM here (`errors.is_oom`); before
the ladder rebuilds, the failed call's traceback is dropped, so the
device memory its frames held goes back to the allocator.  `health()`
snapshots the whole picture.  A `FaultPlan` (serve/faults.py) can inject
any of these failures deterministically at the named sites
``"build"``/``"execute"``.

The executor contract (what `executor_factory(key)` must return):
  * ``batch_size`` attribute -- the prepared batch width to pad to;
  * ``__call__(prompts, negative_prompts, guidance_scale, seeds) -> list``
    of per-request outputs, ``len == len(prompts)`` (already unpadded).
`serve/executors.py` adapts the port's pipelines; `serve/testing.py` has
the deterministic weightless fakes used by tests and the demo.

Over the whole-batch path (ROADMAP item 16, step 16a) two disciplines
switch on as in the JAX package (steps 16b and 16c):

* ``pipeline_stages``: coalesced batches run through the three-stage
  worker pipeline of serve/staging.py (encode, denoise, decode overlapped
  across batches, at most ``max_inflight_batches`` resident), with the
  ``staging_off`` rung falling a failing key back to this path;
  ``prompt_cache_capacity`` puts serve/promptcache.py's LRU in front of
  every executor's text encode;
* ``step_batching``: the denoise loop becomes the slot pool of
  serve/stepbatch.py -- requests join, leave, park and pack between
  denoise steps (``ExecKey.exec_mode="step"``), stream previews, and on
  stop export their carries for migration (serve/migration.py);
  ``submit(carry_snapshot=...)`` resumes one.

Over either discipline, as in the JAX package (steps 16d and 16e):

* ``controller.enabled``: the closed-loop SLO controller
  (serve/controller.py) maps each batch's (or step admission's) key
  through the tier its classes need, and rejects at admission past the
  last tier (`AdmissionRejectedError`);
* ``gateway.tenants``: per-tenant token-bucket quotas and weighted
  deficit-round-robin in the queue (serve/tenancy.py);
* ``gateway.port``: the HTTP/SSE gateway (serve/gateway.py,
  `start_gateway`);
* a server is one replica of a fleet (serve/replica.py, serve/fleet.py,
  serve/autoscale.py) through ``registry`` / ``replica_name``.

Over n ranks (step 16f, serve/ranks.py ``serve_over_ranks``) the server
runs on rank 0 and its executors are `RankedExecutor` s: every build,
dispatch, stage and step operation runs as a command on every rank, and
the followers' failures come back typed.  A failure or a hang on one rank
inside an operation aborts the data groups on every rank; before the next
command the server drops every executor and the ranks make the data
groups anew (``_ranks_rebuild``), and the error walks the ladder as on one
card (``health()["ranks"]``: the generation, aborts, rebuilds).
Everything else -- whole-batch,
staging, step batching, the controller, tenancy, the gateway -- runs as
on one card.  The AOT store (16g) comes with a later step, and this
server refuses it until then with a ``ValueError`` naming the step.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import Future
from typing import Any, Callable, Dict, List, Optional

from ..utils import sync
from ..utils.config import ServeConfig
from ..utils.metrics import Counter, MetricsRegistry
from ..utils.trace import RequestTrace, Tracer
from .batcher import BatchKey, BucketTable, MicroBatcher
from .cache import ExecKey, ExecutorCache
from .errors import (
    AdmissionRejectedError,
    BuildFailedError,
    CarryExportedError,
    CircuitOpenError,
    DeadlineExceededError,
    DegradationInapplicableError,
    ExecuteFailedError,
    ExecutorContractError,
    FatalError,
    MigrationRejectedError,
    NoBucketError,
    QueueFullError,
    ResourceExhaustedError,
    RetryableError,
    ServeError,
    ServerClosedError,
    TenantQuotaError,
    WatchdogTimeoutError,
    is_oom,
)
from .faults import FaultPlan
from .migration import (
    check_identity,
    check_key_compatible,
    decode_snapshot,
    encode_snapshot,
)
from .queue import Request, RequestQueue, ServeResult
from .resilience import (
    RUNG_SPLIT,
    RUNG_STAGING_OFF,
    ResilienceEngine,
    failure_kind,
)

ROADMAP_STEP = {
    "aot_cache": "16g (the AOT store)",
}


def _not_ported(what: str, step: str) -> ValueError:
    return ValueError(
        f"{what} is not ported to the PyTorch serve plane yet: it comes with "
        f"ROADMAP item 16, step {ROADMAP_STEP[step]}")


def refuse_unported(config: ServeConfig) -> None:
    """Raise ``ValueError`` for every setting whose subsystem the port's
    serve plane does not carry yet (ROADMAP item 16, step 16g).
    `ServeConfig` itself accepts it, as the JAX package's does; the server
    refuses to run with it on.  Every discipline serves over any
    ``mesh_plan`` since step 16f."""
    if config.aot_cache.dir:
        raise _not_ported("the AOT executable store (aot_cache.dir)", "aot_cache")


class InferenceServer:
    """Async request scheduler with continuous micro-batching over one
    pipeline.

    ``executor_factory(key: ExecKey)`` builds (and prepares) the executor
    for a bucket; ``model_id``/``scheduler``/``mesh_plan`` identify the
    served model in cache keys -- pass ``distri_config.mesh_plan`` when
    wrapping real pipelines so a layout change invalidates the cache keys.
    ``fault_plan`` (chaos/testing) injects failures at sites ``"build"``
    (around the factory) and ``"execute"`` (inside the watchdog-bounded
    dispatch).  ``ranks`` is rank 0's `serve.ranks.RankLeader` when the
    executors span n ranks (`serve.ranks.serve_over_ranks` builds the
    server so): evicted executors and dropped staged works are released
    on the followers, a watchdog timeout aborts the data groups on every
    rank, the next dispatch rebuilds them (``_ranks_rebuild``), and
    ``stop()`` stops the followers.
    """

    def __init__(
        self,
        executor_factory: Callable[[ExecKey], Any],
        config: Optional[ServeConfig] = None,
        *,
        model_id: str = "model",
        scheduler: str = "ddim",
        mesh_plan: str = "dp1.cfg1.sp1",
        clock: Callable[[], float] = time.monotonic,
        fault_plan: Optional[FaultPlan] = None,
        registry: Optional[MetricsRegistry] = None,
        replica_name: Optional[str] = None,
        ranks: Any = None,
    ):
        self.config = config or ServeConfig()
        refuse_unported(self.config)
        self.ranks = ranks
        # the last rebuild of the data groups over n ranks: its seconds
        self._ranks_rebuild_s: Optional[float] = None
        self.model_id = model_id
        self.scheduler = scheduler
        self.mesh_plan = mesh_plan
        self.clock = clock
        self.fault_plan = fault_plan
        self.replica_name = replica_name
        self.queue = RequestQueue(self.config.max_queue_depth)
        # Per-tenant fair queuing (serve/tenancy.py): a non-empty tenant
        # table in ServeConfig.gateway turns the queue tenant-aware --
        # token-bucket quotas at put(), weighted DRR feeding peek_best().
        # None when unconfigured: the queue stays pure EDF and the
        # tenant-off request path runs zero tenancy code.
        self.tenancy = None
        if self.config.gateway.tenants:
            from .tenancy import TenancyPolicy

            self.tenancy = TenancyPolicy(self.config.gateway, clock=clock)
            self.queue.policy = self.tenancy
        # self.prompt_cache is created below (it needs the registry); the
        # factory wrapper reads the attribute lazily at build time, which
        # always happens after __init__ completes (warmup/start/dispatch)
        self.prompt_cache = None

        def _factory(key, _inner=executor_factory):
            # the "build" site wraps WHATEVER factory was passed, so fake
            # and real executors get build faults through one code path --
            # and every built executor gets the server's prompt cache
            # attached when it knows how to use one
            if self.fault_plan is not None:
                self.fault_plan.check("build", key=key)
            ex = _inner(key)
            if (self.prompt_cache is not None
                    and hasattr(ex, "attach_prompt_cache")):
                ex.attach_prompt_cache(self.prompt_cache)
            return ex

        self.cache = ExecutorCache(
            _factory, capacity=self.config.cache_capacity,
            on_evict=self._on_evict if ranks is not None else None,
        )
        obs = self.config.observability
        # Request-scoped tracing (utils/trace.py): None when off -- every
        # hook below is guarded, so the tracing-off request path runs no
        # tracing code at all
        self.tracer = (Tracer(clock=clock, capacity=obs.trace_capacity)
                       if obs.trace else None)
        self.cache.tracer = self.tracer
        # The AOT executable store comes with step 16g of ROADMAP item 16
        # (``aot_cache.dir`` is refused until then); a replica reads the
        # attribute for its warm-up's deserialize seconds.
        self.aot_store = None
        # Unified metrics plane (utils/metrics.py MetricsRegistry): every
        # Counter/LatencyHistogram/RingLog the server and its sub-pieces
        # mutate is OWNED here under hierarchical names, so /metrics
        # (Prometheus), /metrics.json, and metrics_snapshot() all render
        # one source of truth.  A shared registry plus a replica_name
        # gives every metric this server creates a {"replica": name}
        # label.
        base_registry = registry if registry is not None else MetricsRegistry()
        self.registry = (base_registry.scoped({"replica": replica_name})
                         if replica_name is not None else base_registry)
        self.counters = self.registry.counter("serve_requests")
        self.hist_queue_wait = self.registry.histogram(
            "serve_latency_seconds", labels={"phase": "queue_wait"})
        self.hist_execute = self.registry.histogram(
            "serve_latency_seconds", labels={"phase": "execute"})
        self.hist_e2e = self.registry.histogram(
            "serve_latency_seconds", labels={"phase": "e2e"})
        self._batch_sizes = self.registry.counter("serve_batch_size")
        # SLO signal plumbing: rolling-window p50/p99 per SLO class + the
        # queue-depth and inflight gauges, all readable via slo_snapshot()
        self._slo_window = obs.slo_window
        self._slo_max_age = obs.slo_max_age_s
        self._inflight_c = Counter()  # "requests": dispatched, unresolved
        self.registry.gauge("serve_queue_depth",
                            lambda: float(len(self.queue)))
        self.registry.gauge("serve_inflight_requests",
                            lambda: float(self._inflight_c.get("requests")))
        self.registry.gauge("serve_cache_entries",
                            lambda: float(len(self.cache)))
        self.registry.gauge("serve_cache_hits",
                            lambda: float(self.cache.hits))
        self.registry.gauge("serve_cache_misses",
                            lambda: float(self.cache.misses))
        self.registry.gauge(
            "serve_retry_budget_remaining",
            lambda: float(self.resilience.budget.remaining))
        # per-tenant metrics plane (tenancy on only): admission counters
        # keyed admitted/rejected_quota/completed, a rolling queue-wait
        # window per tenant, and a live token gauge read from the policy
        # snapshot.  Tenant tables are static config, so the label sets
        # are bounded by construction.
        self._tenant_counters: Dict[str, Counter] = {}
        self._tenant_wait = {}
        if self.tenancy is not None:
            for tname in self.tenancy.tenant_names:
                self._tenant_counters[tname] = self.registry.counter(
                    "serve_tenant_requests", labels={"tenant": tname})
                self._tenant_wait[tname] = self.registry.rolling(
                    "serve_tenant_queue_wait_s",
                    window=obs.slo_window, labels={"tenant": tname},
                    clock=clock, max_age_s=obs.slo_max_age_s)
                self.registry.gauge(
                    "serve_tenant_tokens",
                    (lambda t=tname: float(
                        (self.queue.tenancy_snapshot() or {})
                        .get(t, {}).get("tokens", 0.0))),
                    labels={"tenant": tname})
        self.metrics_endpoint = None
        self.gateway_endpoint = None
        self.batcher = MicroBatcher(
            self.queue,
            BucketTable(self.config.buckets),
            model_id=model_id,
            scheduler=scheduler,
            max_batch_size=self.config.max_batch_size,
            batch_window_s=self.config.batch_window_s,
            on_reject=self._reject,
            clock=clock,
            batch_cap=self._batch_cap_for,
        )
        self._stop = sync.Event()
        self.resilience = ResilienceEngine(
            self.config.resilience,
            buckets=self.batcher.table.buckets,
            clock=clock,
            # backoff sleeps become stop-interruptible waits: stop() never
            # waits out a backoff schedule
            sleep=self._stop.wait,
            staging=self.config.pipeline_stages,
            tracer=self.tracer,
        )
        # Prompt/embedding LRU cache (serve/promptcache.py): repeated
        # prompts skip text-encode; the hit rate rides the registry
        if self.config.prompt_cache_capacity > 0:
            from .promptcache import PromptCache

            self.prompt_cache = PromptCache(
                self.config.prompt_cache_capacity,
                counter=self.registry.counter("serve_prompt_cache"),
            )
            self.registry.register("serve_prompt_cache_state",
                                   self.prompt_cache)
        # the resilience ring log joins the unified registry (JSON render;
        # the Prometheus exposition skips free-text rings by design)
        self.registry.register("serve_last_errors",
                               self.resilience.last_errors)
        self.registry.gauge(
            "serve_watchdog_timeouts",
            lambda: float(self.resilience.watchdog.timeouts))
        # Closed-loop SLO controller (serve/controller.py): per-slo_class
        # tier selection over the quality/cost lattice, admission control
        # at the extreme.  None when off -- the controller-off dispatch
        # path runs zero controller code, same convention as the tracer.
        self.controller = None
        if self.config.controller.enabled:
            from .controller import SLOController

            self.controller = SLOController(
                self.config.controller,
                clock=clock,
                batch_hint=self.config.max_batch_size,
                registry=self.registry,
                tracer=self.tracer,
                prompt_cache=self.prompt_cache,
            )
        # Step-level continuous batching (serve/stepbatch.py): the denoise
        # loop becomes a slot pool of per-request carries -- requests join
        # and leave BETWEEN STEPS, EDF reorders the cohort, low-slack
        # arrivals preempt the slackest slot, and occupied slots stream
        # progressive previews.  None when off -- the whole-batch dispatch
        # path runs zero step-pool code, the tracer/controller convention.
        self.stepbatch = None
        if self.config.step_batching.enabled:
            from .stepbatch import StepBatcher

            self.stepbatch = StepBatcher(
                self.config.step_batching,
                clock=clock,
                # pack-compatibility key source for width-truncated
                # cohorts (StepBatchConfig.pack_align)
                pack_signature=self._step_pack_signature,
                # calibrated per-step service from the controller when it
                # is on (EDF's clock unit); the batcher's own EWMA
                # otherwise
                step_estimate=(self.controller.step_service_estimate
                               if self.controller is not None else None),
            )
            # pack-efficiency: real request rows per dispatched row
            # capacity across the server lifetime (1.0 = every packed
            # dispatch full; sequential dispatches drag it toward 1/width)
            self._pack_rows_total = 0
            self._pack_capacity_total = 0
            self.registry.gauge(
                "serve_stepbatch_pack_fill",
                lambda: (self._pack_rows_total / self._pack_capacity_total
                         if self._pack_capacity_total else 0.0))
            self.hist_first_preview = self.registry.histogram(
                "serve_latency_seconds", labels={"phase": "first_preview"})
            self.registry.gauge(
                "serve_slot_occupied",
                lambda: float(len(self.stepbatch.occupied())))
            self.registry.gauge(
                "serve_slot_parked",
                lambda: float(len(self.stepbatch.parked)))
            self.registry.gauge(
                "serve_slot_capacity",
                lambda: float(self.config.step_batching.slots))
            if self.tenancy is not None:
                # per-tenant slot occupancy: the live fairness picture
                for tname in self.tenancy.tenant_names:
                    self.registry.gauge(
                        "serve_tenant_slot_occupied",
                        (lambda t=tname: float(
                            self.stepbatch.occupied_by_tenant()
                            .get(t, 0))),
                        labels={"tenant": tname})
        # Staged pipelining (serve/staging.py): three stage workers overlap
        # text-encode, denoise, and VAE-decode across micro-batches.  The
        # scheduler thread submits and drains outcome events; futures
        # resolve from the decode worker.
        self.staging = None
        if self.config.pipeline_stages:
            from .staging import StagePipeline

            self.staging = StagePipeline(
                max_inflight=self.config.max_inflight_batches,
                watchdog_timeout_s=self.config.resilience.watchdog_timeout_s,
                clock=clock,
                counters=self.counters,
                on_success=self._staged_success,
                on_failure=self._staged_failure,
                on_release=self._staged_release,
                fault_plan=fault_plan,
                registry=self.registry,
                tracer=self.tracer,
            )
        self._thread: Optional[threading.Thread] = None
        self._started = False
        # guards the two lifecycle cells concurrent stop()/start() callers
        # mutate (stop() is idempotent from any thread); reads stay
        # unlocked snapshot reads
        self._lifecycle_lock = sync.Lock()

    # -- lifecycle ---------------------------------------------------------

    def start(self, warmup: bool = True) -> "InferenceServer":
        """Spin up the scheduler thread; with ``warmup``, first prefetch
        the configured hot buckets so their builds happen before the
        first request is admitted."""
        assert self._thread is None, "server already started"
        if self.queue.closed:
            # stop() closed the queue for good: a "restarted" server
            # would be a zombie -- scheduler alive, every submit rejected
            # by the closed queue.  Refuse loudly instead.
            raise ServerClosedError(
                "this server was stopped (its queue is closed); build a "
                "new InferenceServer to serve again"
            )
        if warmup and self.config.warmup_buckets:
            self._warmup()
        if (self.config.observability.metrics_port is not None
                and self.metrics_endpoint is None):
            self.start_metrics_endpoint()
        if (self.config.gateway.port is not None
                and self.gateway_endpoint is None):
            self.start_gateway()
        self._stop.clear()
        t = sync.Thread(
            target=self._loop, name="distrifuser-serve", daemon=True
        )
        with self._lifecycle_lock:
            self._started = True
            self._thread = t
            # started inside the lock: a concurrent stop() reads the
            # handle under the same lock and joins it
            t.start()
        return self

    def request_stop(self) -> None:
        """Non-blocking shutdown signal, safe from ANY thread -- including
        from inside a dispatch, where a full `stop()` would deadlock on the
        scheduler join.  Stops admitting, fails every still-queued future
        with `ServerClosedError`, and marks the scheduler so the in-flight
        retry loop fails its batch terminally at the next check.  A later
        `stop()` completes the shutdown (join, staging drain, endpoint
        teardown)."""
        self._stop.set()
        for req in self.queue.close():
            self.counters.inc("rejected_server_closed")
            self._trace_finish(req, "server_closed")
            self._resolve(req.future, exc=ServerClosedError("server stopped"))

    def stop(self, timeout: float = 30.0) -> None:
        """Graceful, deterministic shutdown: stop admitting, fail EVERY
        still-queued future with `ServerClosedError` (including batches
        the batcher pops after the stop flag is set), interrupt any
        backoff sleep, and join the scheduler.  The one batch possibly
        in flight on the card completes normally (its wall-time is
        bounded by the watchdog), so `stop()` returns within roughly
        ``max(timeout, one batch)`` with no future left unresolved."""
        self.request_stop()
        if self.gateway_endpoint is not None:
            # first: stop accepting HTTP and resolve every open SSE
            # stream (closed-mark + wake), so no client socket outlives
            # the scheduler it was streaming from
            self.gateway_endpoint.stop()
            self.gateway_endpoint = None
        if self.staging is not None:
            # drain the stage queues deterministically: every staged batch
            # not yet through decode fails with ServerClosedError (the
            # stage invocation in progress finishes, bounded by its
            # watchdog), so no staged future is left unresolved either
            self.staging.stop(timeout)
        with self._lifecycle_lock:
            t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                # still draining a long dispatch: KEEP the handle --
                # health() must keep reporting scheduler_alive truthfully,
                # and start()'s assert must refuse to spawn a second
                # scheduler over the one still owning the card
                self.counters.inc("stop_join_timeouts")
            else:
                with self._lifecycle_lock:
                    if self._thread is t:
                        self._thread = None
        if self.metrics_endpoint is not None:
            self.metrics_endpoint.stop()
            self.metrics_endpoint = None
        if self.ranks is not None:
            # the scheduler and the stage workers have posted their last
            # command: the followers' loops end
            self.ranks.close()
        with self._lifecycle_lock:
            self._started = False

    def _on_evict(self, key: ExecKey, executor) -> None:
        """Cache release hook over n ranks: the followers drop their
        executor of an evicted (or invalidated) key."""
        release = getattr(executor, "evict_on_followers", None)
        if release is not None:
            release()

    def _ranks_aborted(self) -> bool:
        """Over n ranks: the data groups were aborted and wait for the
        rebuild, so no command with collectives may run."""
        return self.ranks is not None and self.ranks.aborted is not None

    def _ranks_abort(self, exc: Exception) -> Optional[BaseException]:
        """A watchdog timeout over n ranks: the timed-out command may sit
        inside a collective that the other ranks entered, so the data
        groups are aborted on every rank (serve/ranks.py, step 1) and the
        next dispatch rebuilds them.  The watchdog has abandoned the
        command's worker, as the JAX package's abandons its program.
        Returns the rank's failure that had already aborted the groups
        (`RankLeader.abort_cause`: rank 0 was still inside a gloo
        collective, which only its timeout ends), which the caller reads in
        place of the timeout; None without one."""
        if self.ranks is None:
            return None
        cause = self.ranks.abort_cause
        self.ranks.abort(f"watchdog timeout over {self.ranks.world} ranks: {exc}")
        return cause

    def _ranks_rebuild(self) -> None:
        """Over n ranks, once the data groups were aborted: drop every
        executor (their graphs hold the aborted communicators), make the
        data groups anew on every rank (`RankLeader.rebuild`; it sheds with
        `WatchdogTimeoutError` while the aborted command still runs after
        another watchdog bound) and move each step work that did not fail
        onto the rebuilt executor of its key.  Scheduler thread only."""
        ranks = self.ranks
        if ranks is None or ranks.aborted is None:
            return
        t0 = time.monotonic()
        self.cache.invalidate_all()
        ranks.rebuild(self.config.resilience.watchdog_timeout_s)
        self._ranks_rebuild_s = time.monotonic() - t0
        self.counters.inc("ranks_rebuilds")
        if self.stepbatch is None:
            return
        for state in list(self.stepbatch.occupied()) + list(self.stepbatch.parked):
            try:
                executor, _ = self.cache.get(state.ekey, pin=True)
            except Exception as exc:  # noqa: BLE001 -- typed below
                self.counters.inc("failed_build")
                self._step_fail_state(state, BuildFailedError(
                    f"executor rebuild failed for {state.ekey.short()}: "
                    f"{type(exc).__name__}: {exc}"))
                continue
            self.cache.unpin(state.executor)
            state.executor = executor

    def __enter__(self) -> "InferenceServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _warmup(self) -> None:
        """Best-effort warmup prefetch: a failed warmup build must not
        abort startup.  The failure is recorded in metrics and the key's
        resilience state -- the first request for the bucket rebuilds
        through the full retry/degradation machinery -- and the remaining
        warmup keys still prefetch."""
        for key in self._warmup_keys():
            try:
                self.cache.get(key)
            except Exception as exc:  # noqa: BLE001 — recorded, not fatal
                self.counters.inc("warmup_build_failures")
                self.resilience.on_failure(key, BuildFailedError(
                    f"warmup build failed for {key.short()}: "
                    f"{type(exc).__name__}: {exc}"
                ))

    def _warmup_keys(self) -> List[ExecKey]:
        keys = []
        table = self.batcher.table
        for entry in self.config.warmup_buckets:
            h, w = entry[0], entry[1]
            steps = entry[2] if len(entry) > 2 else self.config.default_steps
            bh, bw = table.snap(h, w)
            keys.append(self._exec_key_for(bh, bw, steps,
                                           cfg=self.config.warmup_cfg))
        return keys

    def _exec_key_for(self, h: int, w: int, steps: int, cfg: bool) -> ExecKey:
        # per-bucket strategy map (ServeConfig.bucket_parallelism, keyed
        # by post-snap bucket): one server may hold patch-parallel and
        # pipeline-parallel executors for different resolution buckets
        parallelism = self.config.bucket_parallelism.get(
            (h, w), self.config.parallelism)
        pipe_patches = (int(self.config.pipe_patches or 0)
                        if parallelism == "pipefusion" else 0)
        return ExecKey(
            model_id=self.model_id,
            scheduler=self.scheduler,
            height=h,
            width=w,
            steps=steps,
            cfg=cfg,
            mesh_plan=self.mesh_plan,
            step_cache_interval=self.config.step_cache_interval,
            step_cache_depth=self.config.step_cache_depth,
            comm_compress=self.config.comm_compress,
            # the PCPP knob is a patch-protocol field: pipefusion buckets
            # key at 1.0 (ExecKey validation would reject anything else)
            refresh_fraction=(self.config.refresh_fraction
                              if parallelism == "patch" else 1.0),
            weight_quant=self.config.weight_quant,
            quant_compute=self.config.quant_compute,
            # the step-granular dispatch discipline is executor-distinct:
            # a slot-pool server's executors run the eager per-step
            # evaluations with an explicit external carry
            exec_mode=("step" if self.config.step_batching.enabled
                       else "fused"),
            parallelism=parallelism,
            pipe_patches=pipe_patches,
        )

    def _batch_cap_for(self, key: BatchKey) -> Optional[int]:
        """Batcher hook: the sticky batch-size ceiling the split_batch
        degradation learned for this key (None = no cap)."""
        return self.resilience.batch_cap(
            self._exec_key_for(key.height, key.width, key.steps, key.cfg)
        )

    # -- submission (any thread) ------------------------------------------

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
        carry_snapshot: Optional[bytes] = None,
    ) -> Future:
        """Admit one request; returns a Future of `ServeResult`.

        Raises `QueueFullError` (backpressure -- retry against another
        replica or later), `AdmissionRejectedError` (the SLO controller
        parked the class past its last tier -- controller on only),
        `TenantQuotaError` (the submitting tenant's token bucket is empty
        -- per-tenant 429, tenancy on only) or `ServerClosedError`
        immediately; deadline, bucket, circuit-breaker, and execution
        failures fail the *future*
        instead, since they are decided at scheduling time.  Every error
        is a `ServeError`: `RetryableError` means the same request may
        succeed later/elsewhere, `FatalError` means it cannot.

        ``slo_class`` tags the request for the per-class rolling-latency
        windows (`slo_snapshot`) -- the signal the SLO controller steers
        on.

        ``tenant`` is the fairness identity (serve/tenancy.py): with a
        tenant table configured it must name a known tenant (or the
        implicit default), and the request is held to that tenant's
        quota and DRR share.  Ignored when tenancy is off.

        ``on_progress(step, total_steps, preview)`` -- progressive
        previews (step-level continuous batching only): fires on the
        scheduler thread every ``step_batching.preview_interval`` steps
        with a cheap downsampled-latent image.  Keep it fast; ignored on
        whole-batch servers.

        ``carry_snapshot`` -- carry migration (serve/migration.py): the
        encoded bytes a stopped server exported for this same request
        (`CarryExportedError.snapshot`).  Decoded and identity-checked
        HERE, synchronously -- `MigrationRejectedError` (retryable) means
        the caller must strip the snapshot and resubmit from step 0;
        ExecKey compatibility is checked later at step admission, where
        the executing key is known.  Step-batching servers only."""
        if not self._started or self._stop.is_set():
            raise ServerClosedError("server is not running")
        snap = None
        if carry_snapshot is not None:
            if self.stepbatch is None:
                raise MigrationRejectedError(
                    "carry import needs step-level continuous batching "
                    "(ServeConfig.step_batching.enabled) on the importing "
                    "replica"
                )
            data = carry_snapshot
            if self.fault_plan is not None:
                # chaos site: corruption in flight between servers
                data = self.fault_plan.mutate("migrate.import", data)
            try:
                snap = decode_snapshot(data)
                check_identity(snap, prompt=prompt, seed=seed)
            except MigrationRejectedError:
                self.counters.inc("migrations_rejected")
                raise
        if self.controller is not None and not self.controller.admit(
                str(slo_class)):
            # the controller's extreme rung: even the cheapest tier cannot
            # hold this class's SLO under the current load -- reject at
            # admission (typed 429) instead of queueing certain lateness
            self.counters.inc("rejected_admission")
            raise AdmissionRejectedError(
                f"slo_class {slo_class!r} is admission-controlled: the "
                "cheapest quality tier cannot hold its p99 target at the "
                "current load; retry later or against another replica"
            )
        steps = (self.config.default_steps if num_inference_steps is None
                 else num_inference_steps)
        ttl = self.config.default_ttl_s if ttl_s is None else ttl_s
        req = Request(
            prompt=prompt,
            negative_prompt=negative_prompt,
            height=height,
            width=width,
            num_inference_steps=steps,
            guidance_scale=guidance_scale,
            seed=seed,
            slo_class=str(slo_class),
            tenant=str(tenant),
            deadline=self.clock() + ttl,
            enqueue_ts=self.clock(),
            on_progress=on_progress,
            carry_snapshot=snap,
        )
        if self.tracer is not None:
            self._trace_submit(req, steps)
        self.counters.inc("submitted")
        try:
            self.queue.put(req)
        except QueueFullError:
            self.counters.inc("rejected_queue_full")
            self._trace_finish(req, "queue_full")
            raise
        except TenantQuotaError:
            self.counters.inc("rejected_tenant_quota")
            tc = self._tenant_counters.get(req.tenant)
            if tc is not None:
                tc.inc("rejected_quota")
            self._trace_finish(req, "tenant_quota")
            raise
        tc = self._tenant_counters.get(req.tenant)
        if tc is not None:
            tc.inc("admitted")
        return req.future

    # -- tracing hooks (all no-ops when config.observability.trace is off) --

    def _trace_submit(self, req: Request, steps: int) -> None:
        """Open the request's root + queue-wait spans (its whole track)."""
        tr = self.tracer
        tid = tr.new_trace()
        track = f"req/{tid}"
        root = tr.begin("request", track=track, trace=tid, args={
            "requested": f"{req.height}x{req.width}",
            "steps": steps,
            "slo_class": req.slo_class,
        })
        tr.event("enqueue", track=track, trace=tid)
        qspan = tr.begin("queue_wait", track=track, trace=tid, parent=root)
        req.trace = RequestTrace(trace_id=tid, track=track, root=root,
                                 queue_span=qspan)

    def _trace_dequeue(self, req: Request, batch_span: int,
                       batch_size: int) -> None:
        """Close the queue-wait span at the batcher's pop time and mark
        the coalesce, flow-linking the member to the batch span."""
        rt = req.trace
        if rt is None or rt.done:
            return
        tr = self.tracer
        ts = req.dequeue_ts if req.dequeue_ts is not None else self.clock()
        tr.end(rt.queue_span, t=ts, args={"batch_span": batch_span})
        rt.queue_span = None
        tr.event("coalesce", track=rt.track, trace=rt.trace_id, t=ts,
                 args={"batch_span": batch_span, "batch_size": batch_size})
        rt.flow_id = tr.new_flow()
        tr.flow(rt.flow_id, "s", track="scheduler", name="member")

    def _trace_finish(self, req: Request, outcome: str,
                      args: Optional[dict] = None) -> None:
        """Terminal mark for one request: close any still-open queue span
        and the root span with the outcome.  Idempotent — races between
        cancel, deadline, and stop() must not double-close."""
        rt = req.trace
        if rt is None or rt.done or self.tracer is None:
            return
        rt.done = True
        tr = self.tracer
        if rt.queue_span is not None:
            tr.end(rt.queue_span, args={"outcome": outcome})
            rt.queue_span = None
        a = {"outcome": outcome}
        if args:
            a.update(args)
        tr.event("complete" if outcome == "completed" else outcome,
                 track=rt.track, trace=rt.trace_id)
        tr.end(rt.root, args=a)

    # -- scheduling loop (single thread) ----------------------------------

    @staticmethod
    def _resolve(future, *, result=None, exc: Optional[Exception] = None) -> None:
        """set_result/set_exception tolerating an already-resolved future
        (a caller may cancel() while the request is queued — that must not
        take down the scheduler thread)."""
        try:
            if exc is not None:
                future.set_exception(exc)
            else:
                future.set_result(result)
        except Exception:
            pass  # cancelled/raced future: the caller gave up on it

    _OUTCOMES = {
        "CarryExportedError": "carry_exported",
        "MigrationRejectedError": "migration_rejected",
        "ServerClosedError": "server_closed",
        "DeadlineExceededError": "deadline_exceeded",
        "CircuitOpenError": "shed_circuit_open",
        "NoBucketError": "no_bucket",
        "WatchdogTimeoutError": "watchdog_timeout",
    }

    def _fail_batch(self, batch: List[Request], exc: Exception) -> None:
        outcome = self._OUTCOMES.get(type(exc).__name__,
                                     type(exc).__name__)
        for req in batch:
            self._trace_finish(req, outcome)
            self._resolve(req.future, exc=exc)

    def _reject(self, req: Request, exc: Exception) -> None:
        if isinstance(exc, DeadlineExceededError):
            self.counters.inc("rejected_deadline")
        elif isinstance(exc, NoBucketError):
            self.counters.inc("rejected_no_bucket")
        else:
            self.counters.inc("rejected_other")
        self._trace_finish(
            req, self._OUTCOMES.get(type(exc).__name__,
                                    type(exc).__name__))
        self._resolve(req.future, exc=exc)

    def _loop(self) -> None:
        # The scheduler thread IS the service: an unexpected error
        # (contract-violating executor, future-callback bug) must fail
        # loudly in metrics and keep serving, never die silently.
        import traceback

        if self.stepbatch is not None:
            # step-level continuous batching: the slot-pool round loop
            # replaces whole-batch dispatch entirely for this server
            try:
                while not self._stop.is_set():
                    try:
                        if self.controller is not None:
                            self.controller.poll(self.slo_snapshot())
                        busy = self._step_round()
                    except Exception:  # noqa: BLE001
                        self.counters.inc("scheduler_errors")
                        traceback.print_exc()
                        continue
                    if not busy:
                        # idle: sleep until an arrival (or the stop flag's
                        # next check) instead of spinning the pool
                        self.queue.wait_nonempty(0.05)
            finally:
                # deterministic drain on the owner thread: every resident
                # carry (occupied AND parked) resolves its future -- the
                # step-mode analog of close() draining the queue
                self._step_drain()
            return

        while not self._stop.is_set():
            try:
                # staged outcomes ride an event queue back here: the
                # breaker/ladder mutating methods are scheduler-thread-only
                self._drain_staged_outcomes()
                if self.controller is not None:
                    # one decision tick per scheduler round -- also while
                    # idle, so an admission-parked class can retract when
                    # the load that parked it drains away
                    self.controller.poll(self.slo_snapshot())
                got = self.batcher.next_batch(timeout=0.05)
            except Exception:  # noqa: BLE001
                self.counters.inc("scheduler_errors")
                traceback.print_exc()
                continue
            if got is None:
                continue
            key, batch = got
            if self._stop.is_set():
                # popped concurrently with stop(): fail deterministically,
                # exactly like the still-queued futures close() drained
                self.counters.inc("rejected_server_closed", len(batch))
                self._fail_batch(batch, ServerClosedError("server stopped"))
                continue
            try:
                self._execute(key, batch)
            except Exception as exc:  # noqa: BLE001
                self.counters.inc("scheduler_errors")
                traceback.print_exc()
                self._fail_batch(batch, exc)

    # -- the step-granular scheduling round (serve/stepbatch.py) -----------
    #
    # One round = reap -> fill -> preempt -> advance one step -> previews
    # -> retire.  Everything here runs on the single scheduler thread; the
    # slot pool is its private state (lock-discipline registry entry).

    def _step_round(self) -> bool:
        """One slot-pool scheduling round; returns whether any work
        happened (False lets the loop sleep on the queue condition)."""
        sb = self.stepbatch
        try:
            self._ranks_rebuild()
        except WatchdogTimeoutError:
            # the aborted command still runs: nothing over the ranks can
            # run before it ends (its works wait, their deadlines run)
            self.counters.inc("watchdog_timeouts")
            return True
        now = self.clock()
        busy = False
        for req in self.queue.pop_expired(now):
            self._reject(req, DeadlineExceededError(
                f"request {req.request_id} expired after "
                f"{now - req.enqueue_ts:.3f}s in queue"
            ))
            busy = True
        busy = self._step_reap(now) or busy
        busy = self._step_fill(now) or busy
        busy = self._step_preempt(now) or busy
        if self._ranks_aborted():
            return True  # a failed admission aborted: rebuild first
        cohort = sb.cohort(self.clock())
        if cohort:
            sb.rounds += 1
            stepped = self._step_advance(cohort)
            if stepped:
                self._step_previews(stepped)
            if self._ranks_aborted():
                return True  # the next round rebuilds before it retires
            self._step_retire_finished()
            busy = True
        return busy

    def _step_slack_score(self, now: float):
        sb = self.stepbatch

        def score(req: Request) -> float:
            return sb.request_slack(req, now)

        return score

    def _step_release(self, state, *, abort: bool) -> None:
        """Common teardown for one slot state leaving the pool: buffers,
        pin, pool membership, inflight gauge."""
        self.stepbatch.remove(state)
        self._inflight_c.inc("requests", -1)
        if abort:
            try:
                state.executor.step_abort(state.work)
            except Exception:  # noqa: BLE001 -- release is best-effort
                pass
        self.cache.unpin(state.executor)

    def _step_fail_state(self, state, exc: Exception) -> None:
        outcome = self._OUTCOMES.get(type(exc).__name__,
                                     type(exc).__name__)
        self._step_release(state, abort=True)
        self._trace_finish(state.request, outcome)
        self._resolve(state.request.future, exc=exc)

    def _step_fail_group_deferred(self, members, exc: Exception,
                                  after) -> None:
        """Fail a watchdog-ABANDONED cohort group: resolve the futures
        and free the slots NOW, but defer every member's buffer release
        and executor unpin behind the orphaned worker's done-event with
        ONE waiter thread -- the staged pipeline's deferral protocol (the
        abandoned thread still mutates the work dicts and runs the
        denoiser; freeing either under it would be a
        use-after-free)."""
        outcome = self._OUTCOMES.get(type(exc).__name__,
                                     type(exc).__name__)
        for m in members:
            self.stepbatch.remove(m)
            self._inflight_c.inc("requests", -1)
            self._trace_finish(m.request, outcome)
            self._resolve(m.request.future, exc=exc)

        def waiter(_members=list(members), _ev=after):
            _ev.wait()
            for m in _members:
                try:
                    m.executor.step_abort(m.work)
                except Exception:  # noqa: BLE001 -- best-effort
                    pass
                self.cache.unpin(m.executor)

        sync.Thread(target=waiter, name="serve-step-deferred-release",
                    daemon=True).start()

    def _step_reap(self, now: float) -> bool:
        """Drop cancelled futures (client gave up -- free the slot early)
        and fail PARKED states whose deadline lapsed: a parked request is
        not on the card, so the in-flight completes-late exemption does
        not apply to it."""
        sb = self.stepbatch
        busy = False
        for state in list(sb.occupied()) + list(sb.parked):
            if state.request.future.cancelled():
                self.counters.inc("step_cancelled")
                self._step_release(state, abort=True)
                self._trace_finish(state.request, "cancelled")
                busy = True
            elif state.parked and state.request.expired(now):
                self.counters.inc("rejected_deadline")
                self._step_fail_state(state, DeadlineExceededError(
                    f"request {state.request.request_id} expired while "
                    f"parked at step {state.steps_done}/"
                    f"{state.steps_total}"
                ))
                busy = True
        return busy

    def _step_fill(self, now: float) -> bool:
        """Fill free slots in ascending-slack (EDF) order from the parked
        list and the queue jointly -- a resumed carry competes with fresh
        arrivals on the same deadline math."""
        sb = self.stepbatch
        busy = False
        score = self._step_slack_score(now)
        while sb.free_slots() > 0 and not self._ranks_aborted():
            parked = (min(sb.parked, key=lambda s: sb.state_slack(s, now))
                      if sb.parked else None)
            queued = self.queue.peek_best(score)
            take_parked = parked is not None and (
                queued is None
                or sb.state_slack(parked, now) <= score(queued))
            if take_parked:
                try:
                    parked.executor.step_resume(parked.work)
                except Exception as exc:  # noqa: BLE001 -- typed fail
                    self.counters.inc("failed_execute")
                    self._step_fail_state(parked, ExecuteFailedError(
                        f"step resume failed for {parked.ekey.short()}: "
                        f"{type(exc).__name__}: {exc}"))
                    busy = True
                    continue
                sb.unpark(parked)
                self.counters.inc("step_resumes")
                if self.tracer is not None and parked.request.trace:
                    rt = parked.request.trace
                    self.tracer.event("resume", track=rt.track,
                                      trace=rt.trace_id,
                                      args={"step": parked.steps_done})
                busy = True
            elif queued is not None:
                if not self.queue.remove(queued):
                    break  # raced close(); the drain path owns it now
                self._step_admit(queued, now)
                busy = True
            else:
                break
        return busy

    def _step_request_key(self, req: Request):
        """The ONE derivation of a request's admission identity -- bucket
        snap -> base key -> controller tier -- shared by `_step_admit` and
        the preemption pre-check so the two can never drift.  Returns
        ``(bucket, base_key, tier_idx)``; raises `NoBucketError`."""
        bh, bw = self.batcher.table.snap(req.height, req.width)
        base_key = self._exec_key_for(bh, bw, req.num_inference_steps,
                                      cfg=req.guidance_scale > 1.0)
        tier_idx = None
        if self.controller is not None:
            from .controller import apply_tier

            tier_idx, tier = self.controller.tier_for_batch([req.slo_class])
            base_key = apply_tier(base_key, tier)
        return (bh, bw), base_key, tier_idx

    def _step_admit(self, req: Request, now: float) -> bool:
        """Admit one request into a free slot: snap, tier-map, breaker
        gate, pinned executor fetch, and `step_begin` (encode + seeded
        latent + carry init).  Failures are ONE terminal dispatch failure
        (no step-granular retry loop -- the staged-pipeline convention),
        with the ladder advancing on OOM/compile kinds."""
        sb = self.stepbatch
        try:
            (bh, bw), base_key, tier_idx = self._step_request_key(req)
        except NoBucketError as exc:
            self._reject(req, exc)
            return False
        if not self.resilience.allow(base_key):
            self._shed(base_key, [req])
            return False
        ekey = self.resilience.degraded_key(base_key)
        try:
            executor, hit = self.cache.get(ekey, pin=True)
        except Exception as exc:  # noqa: BLE001 -- typed below
            bexc = exc if isinstance(exc, ServeError) else BuildFailedError(
                f"executor build failed for {ekey.short()}: "
                f"{type(exc).__name__}: {exc}")
            self._step_admit_failure(req, base_key, ekey, bexc,
                                     invalidate=False)
            return False
        if not hasattr(executor, "step_begin"):
            self.cache.unpin(executor)
            self._step_admit_failure(req, base_key, ekey, BuildFailedError(
                f"executor for {ekey.short()} has no step-granular "
                "contract (step_begin/step_run) -- step batching needs a "
                "patch-parallel pipeline or a step-capable fake"),
                invalidate=False)
            return False
        snap = req.carry_snapshot
        try:
            if snap is not None:
                # carry migration import: the snapshot's envelope and
                # request identity were validated at submit; HERE the
                # executing key is known, so compatibility is the last
                # gate before grafting the leaves into a fresh work dict
                check_key_compatible(snap, ekey)
                if not hasattr(executor, "step_import"):
                    raise MigrationRejectedError(
                        f"executor for {ekey.short()} has no step_import "
                        "-- cannot adopt a migrated carry")
                work = executor.step_import(
                    snap.meta, list(snap.leaves), req.prompt,
                    req.negative_prompt, req.seed, req.guidance_scale)
            else:
                work = executor.step_begin(req.prompt, req.negative_prompt,
                                           req.seed, req.guidance_scale)
        except MigrationRejectedError as exc:
            # a bad snapshot is the SNAPSHOT's failure, not this
            # server's: fail typed without feeding the breaker/ladder --
            # the caller strips the snapshot and retries from step 0
            self.cache.unpin(executor)
            self.counters.inc("migrations_rejected")
            self._fail_batch([req], exc)
            return False
        except Exception as exc:  # noqa: BLE001 -- typed below
            self.cache.unpin(executor)
            wexc = exc if isinstance(exc, ServeError) else (
                ResourceExhaustedError(
                    f"step admit OOM for {ekey.short()}: {exc}")
                if is_oom(exc) else ExecuteFailedError(
                    f"step admit failed for {ekey.short()}: "
                    f"{type(exc).__name__}: {exc}"))
            self._step_admit_failure(req, base_key, ekey, wexc,
                                     invalidate=True)
            return False
        from .stepbatch import SlotState

        salvaged = snap.step if snap is not None else 0
        state = SlotState(
            request=req, work=work, base_key=base_key, ekey=ekey,
            executor=executor, compile_hit=hit, steps_total=ekey.steps,
            tier_idx=tier_idx, admit_ts=self.clock(),
            steps_done=salvaged, steps_salvaged=salvaged,
            migrations=1 if snap is not None else 0,
        )
        slot = sb.admit(state)
        self._inflight_c.inc("requests", 1)
        req.bucket = (bh, bw)
        req.dequeue_ts = state.admit_ts
        self.counters.inc("step_joins")
        if snap is not None:
            self.counters.inc("carries_imported")
            self.counters.inc("steps_salvaged", salvaged)
        if tier_idx is not None:
            self.controller.count_dispatch(tier_idx, 1)
        if self.tracer is not None and req.trace is not None:
            rt = req.trace
            if rt.queue_span is not None:
                self.tracer.end(rt.queue_span, t=state.admit_ts)
                rt.queue_span = None
            self.tracer.event("join", track=rt.track, trace=rt.trace_id,
                              args={"slot": slot, "key": ekey.short(),
                                    "steps": state.steps_total})
            if snap is not None:
                self.tracer.event("migrate_in", track=rt.track,
                                  trace=rt.trace_id,
                                  args={"step": salvaged,
                                        "of": state.steps_total})
        return True

    def _step_admit_failure(self, req: Request, base_key: ExecKey,
                            ekey: ExecKey, exc: Exception,
                            invalidate: bool) -> None:
        self.resilience.on_failure(base_key, exc)
        kind = failure_kind(exc)
        if kind in ("oom", "compile"):
            rung = self.resilience.degrade(base_key, kind, 1)
            if rung is not None:
                self.counters.inc("degraded_" + rung)
                if invalidate:
                    self.cache.invalidate(ekey)
        self.counters.inc("failed_build"
                          if isinstance(exc, BuildFailedError)
                          else "failed_execute")
        self._fail_batch([req], exc)

    def _step_preempt(self, now: float) -> bool:
        """Deadline-aware preemption: when the pool is full and the
        tightest queued request would miss its deadline waiting for the
        earliest natural free slot -- but still makes it if admitted now --
        park the slackest occupied slot (bit-identical resume later) and
        admit the newcomer.  At most one preemption per round."""
        sb = self.stepbatch
        if (not self.config.step_batching.allow_preemption
                or sb.free_slots() > 0 or self._ranks_aborted()):
            return False
        occupied = sb.occupied()
        if not occupied:
            return False
        # the globally tightest request (the JAX package's policy-blind
        # peek, which a tenant table's deficit-round-robin turn cannot hide)
        cand = self.queue.peek_urgent(self._step_slack_score(now))
        if cand is None:
            return False
        slack_now = sb.request_slack(cand, now)
        if slack_now < 0:
            return False  # already doomed -- preempting trades a second miss
        min_remaining = min(s.remaining for s in occupied)
        waits_out = sb.slack(cand.deadline,
                             cand.num_inference_steps + min_remaining, now)
        if waits_out >= 0:
            return False  # waiting is safe; don't pay the park
        # cheap admission pre-checks BEFORE touching a victim: a newcomer
        # its bucket table or circuit breaker would reject anyway must
        # not cost an innocent slot a carry round-trip and its one-time
        # no-thrash budget -- SAME derivation as _step_admit, so the two
        # gates cannot drift
        try:
            _, cand_key, _ = self._step_request_key(cand)
        except NoBucketError:
            return False  # the regular fill path rejects it typed
        if not self.resilience.allow(cand_key):
            return False  # shedding would free no slot for the newcomer
        victim = sb.pick_victim(slack_now, now)
        if victim is None:
            return False
        try:
            victim.executor.step_park(victim.work)
        except Exception as exc:  # noqa: BLE001 -- typed fail, no park
            self.counters.inc("failed_execute")
            self._step_fail_state(victim, ExecuteFailedError(
                f"step park failed for {victim.ekey.short()}: "
                f"{type(exc).__name__}: {exc}"))
            return True
        sb.park(victim)
        self.counters.inc("step_preempts")
        if self.tracer is not None and victim.request.trace is not None:
            rt = victim.request.trace
            self.tracer.event("preempt", track=rt.track, trace=rt.trace_id,
                              args={"step": victim.steps_done,
                                    "by": cand.request_id})
        admitted = (self.queue.remove(cand)
                    and self._step_admit(cand, now))
        if not admitted and sb.free_slots() > 0 and not self._ranks_aborted():
            # the preemption fizzled past the pre-checks (build/encode
            # failure, raced close): give the victim its slot -- and its
            # no-thrash budget -- straight back instead of leaving it
            # parked for a vacant pool (over n ranks, after an abort, it
            # stays parked: the fill resumes it after the rebuild)
            sb.unpark(victim)
            sb.resumes -= 1
            sb.preempt_count -= 1
            victim.preempts -= 1
            self.counters.inc("step_preempts", -1)
            try:
                victim.executor.step_resume(victim.work)
            except Exception as exc:  # noqa: BLE001 -- typed fail
                self.counters.inc("failed_execute")
                self._step_fail_state(victim, ExecuteFailedError(
                    f"step resume failed for {victim.ekey.short()}: "
                    f"{type(exc).__name__}: {exc}"))
        return True

    def _step_pack_signature(self, state):
        """Pack-compatibility key of a slot's next step for the batcher's
        width-aligned cohort (`StepBatcher.cohort`): the executor's
        `step_signature`, None when the executor has no pack support
        (fakes without the hook, sequential-only configs)."""
        fn = getattr(state.executor, "step_signature", None)
        if fn is None:
            return None
        try:
            return fn(state.work)
        except Exception:  # noqa: BLE001 -- alignment is best-effort
            return None

    def _step_advance(self, cohort) -> list:
        """Advance the cohort one denoise step, grouped by executor (a
        group shares one pipeline; its step is one watchdog-bounded
        dispatch, packed into as few evaluations as the signatures allow).  A group failure is ONE terminal dispatch
        failure for every member -- no step-granular retry.  Returns the
        states that actually stepped."""
        sb = self.stepbatch
        stepped = []
        round_dispatches = 0
        groups: Dict[int, list] = {}
        for state in cohort:
            groups.setdefault(id(state.executor), []).append(state)
        round_t0 = self.clock()
        for members in groups.values():
            executor = members[0].executor
            ekey = members[0].ekey
            base_key = members[0].base_key
            works = [m.work for m in members]

            def call(_ex=executor, _works=works, _ekey=ekey):
                if self.fault_plan is not None:
                    self.fault_plan.check("execute", key=_ekey,
                                          batch_size=len(_works))
                _ex.step_run(_works)

            wd = self.resilience.watchdog
            prev_abandoned = wd.abandoned_event
            try:
                wd.run(call)
            except Exception as exc:  # noqa: BLE001 -- typed below
                # a FRESH abandonment means the watchdog's orphaned
                # thread is still executing THIS group's step: the
                # members' buffer release and executor unpin must wait
                # for it (the staged pipeline's deferral protocol)
                abandoned = wd.abandoned_event
                fresh_abandon = (isinstance(exc, WatchdogTimeoutError)
                                 and abandoned is not None
                                 and abandoned is not prev_abandoned)
                if self._stop.is_set() and not fresh_abandon:
                    # raced a stop/kill mid-round: leave every remaining
                    # member RESIDENT instead of failing it -- the loop's
                    # finally-drain exports each carry for migration (the
                    # dispatch failed before any member's step advanced,
                    # so the carries are valid at their current step),
                    # and a dying server must not feed its own breaker
                    break
                if isinstance(exc, WatchdogTimeoutError):
                    self.counters.inc("watchdog_timeouts")
                    exc = self._ranks_abort(exc) or exc
                if isinstance(exc, ServeError):
                    texc = exc
                elif is_oom(exc):
                    texc = ResourceExhaustedError(
                        f"step execute OOM for {ekey.short()} at cohort "
                        f"{len(works)}: {exc}")
                else:
                    texc = ExecuteFailedError(
                        f"step execute failed for {ekey.short()}: "
                        f"{type(exc).__name__}: {exc}")
                # one terminal dispatch failure for the whole group
                # (members share base_key through the shared executor)
                self.resilience.on_failure(base_key, texc)
                kind = failure_kind(texc)
                if kind in ("oom", "compile"):
                    rung = self.resilience.degrade(base_key, kind, 1)
                    if rung is not None:
                        self.counters.inc("degraded_" + rung)
                        self.cache.invalidate(ekey)
                self.counters.inc("failed_execute", len(members))
                if fresh_abandon:
                    self._step_fail_group_deferred(members, texc,
                                                   abandoned)
                else:
                    for m in members:
                        self._step_fail_state(m, texc)
                if self._ranks_aborted():
                    # the other groups step after the rebuild, next round
                    break
                continue
            self.resilience.on_success(base_key)
            for m in members:
                m.steps_done += 1
                stepped.append(m)
            self.counters.inc("steps_executed", len(members))
            # pack-efficiency accounting (serve/executors.py step_run):
            # how many evaluations this group's step cost and how many
            # real request rows they carried
            stats = getattr(executor, "step_pack_stats", None)
            if stats:
                nd = int(stats.get("dispatches", 0))
                nr = int(stats.get("packed_rows", 0))
                round_dispatches += nd
                self.counters.inc("stepbatch_dispatches", nd)
                self.counters.inc("stepbatch_packed_rows", nr)
                self._pack_rows_total += nr
                self._pack_capacity_total += int(
                    stats.get("rows_capacity", 0))
                if (nd < len(members) and self.tracer is not None
                        and members[0].request.trace is not None):
                    rt = members[0].request.trace
                    self.tracer.event(
                        "packed-step", track=rt.track, trace=rt.trace_id,
                        args={"members": len(members), "dispatches": nd,
                              "rows": nr})
            else:
                # executors without pack accounting dispatch per member
                round_dispatches += len(members)
        if stepped:
            # calibrate on the WHOLE round, not per executor group: the
            # EDF clock unit is "one more step for this slot", and a slot
            # advances once per round -- a round that serially dispatches
            # three bucket groups costs the sum, and slack math priced at
            # a single group's time would flatter every deadline
            round_dt = self.clock() - round_t0
            sb.note_round(round_dt)
            if self.controller is not None:
                costs = [self.controller.tiers[
                    min(m.tier_idx or 0, len(self.controller.tiers) - 1)
                ].cost for m in stepped]
                # per-REQUEST service: a packed dispatch advances several
                # requests for one evaluation, so the round time is
                # normalized by the pack factor -- without this the
                # step-granular occupancy model over-predicts by exactly
                # how well the executor packs
                self.controller.observe_step(sum(costs) / len(costs),
                                             round_dt,
                                             requests=len(stepped),
                                             dispatches=round_dispatches)
        return stepped

    def _step_previews(self, stepped) -> None:
        """Emit progressive previews for stepped slots that are due: a
        cheap host-side downsampled latent through the request's
        on_progress callback, traced as its own span.  Callback errors
        are counted, never fatal -- a client's slow/broken callback must
        not take down the step loop."""
        k = self.config.step_batching.preview_interval
        if not k:
            return
        for state in stepped:
            req = state.request
            if req.on_progress is None or state.steps_done % k:
                continue
            t0 = self.clock()
            try:
                img = state.executor.step_preview(
                    state.work, self.config.step_batching.preview_size)
                req.on_progress(state.steps_done, state.steps_total, img)
            except Exception:  # noqa: BLE001 -- counted, never fatal
                self.counters.inc("preview_errors")
                continue
            t1 = self.clock()
            state.previews += 1
            self.counters.inc("step_previews")
            if state.first_preview_s is None:
                state.first_preview_s = t1 - req.enqueue_ts
                self.hist_first_preview.observe(state.first_preview_s)
            if self.tracer is not None and req.trace is not None:
                rt = req.trace
                self.tracer.complete("preview", t0, t1, track=rt.track,
                                     trace=rt.trace_id, parent=rt.root,
                                     args={"step": state.steps_done,
                                           "of": state.steps_total})

    def _step_retire_finished(self) -> None:
        """Decode + resolve every occupied slot whose denoise finished --
        the leave side of continuous batching, freeing slots for the next
        round's joiners."""
        for state in list(self.stepbatch.occupied()):
            if state.steps_done < state.steps_total:
                continue
            try:
                out = state.executor.step_finish(state.work)
            except Exception as exc:  # noqa: BLE001 -- typed fail
                texc = exc if isinstance(exc, ServeError) else (
                    ExecuteFailedError(
                        f"step decode failed for {state.ekey.short()}: "
                        f"{type(exc).__name__}: {exc}"))
                self.resilience.on_failure(state.base_key, texc)
                self.counters.inc("failed_execute")
                self._step_fail_state(state, texc)
                continue
            self._step_complete(state, out, self.clock())

    def _step_complete(self, state, out, t1: float) -> None:
        """Success bookkeeping for one step-granular request -- the
        request-shaped mirror of `_complete_batch`."""
        req = state.request
        queue_wait = state.admit_ts - req.enqueue_ts
        exec_s = t1 - state.admit_ts
        e2e = t1 - req.enqueue_ts
        self.hist_queue_wait.observe(queue_wait)
        self.hist_execute.observe(exec_s)
        self.hist_e2e.observe(e2e)
        self.slo_window(req.slo_class).observe(e2e)
        self._tenant_observe(req, queue_wait)
        self.counters.inc("completed")
        self.counters.inc("requests_compile_hit" if state.compile_hit
                          else "requests_compile_miss")
        self.counters.inc("denoise_steps_total", state.steps_total)
        if req.expired(t1):
            self.counters.inc("completed_late")
        tier_name = (self.controller.tiers[state.tier_idx].name
                     if state.tier_idx is not None
                     and self.controller is not None else None)
        degradations = tuple(
            self.resilience.key_state(state.base_key).rungs)
        if req.trace is not None and self.tracer is not None:
            rt = req.trace
            self.tracer.complete(
                "execute", state.admit_ts, t1, track=rt.track,
                trace=rt.trace_id, parent=rt.root,
                args={"bucket": f"{state.ekey.height}x{state.ekey.width}",
                      "steps": state.steps_total,
                      "preempts": state.preempts,
                      "compile_hit": state.compile_hit})
            self._trace_finish(req, "completed", args={
                "previews": state.previews,
                "preempts": state.preempts})
        result = ServeResult(
            request_id=req.request_id,
            output=out,
            bucket=(state.ekey.height, state.ekey.width),
            requested_size=(req.height, req.width),
            queue_wait_s=queue_wait,
            execute_s=exec_s,
            e2e_s=e2e,
            batch_size=1,
            compile_hit=state.compile_hit,
            retries=0,
            degradations=degradations,
            exec_key=state.ekey.short(),
            tier=tier_name,
            replica=self.replica_name,
            previews=state.previews,
            first_preview_s=state.first_preview_s,
            preempts=state.preempts,
            migrations=state.migrations,
            steps_salvaged=state.steps_salvaged,
        )
        self._step_release(state, abort=False)
        self._resolve(req.future, result=result)

    def _step_export(self, state) -> Optional[bytes]:
        """Serialize one resident carry for migration, or None when no
        snapshot can ride out: export disabled, the executor lacks the
        hook, the carry is at step 0 (nothing to salvage) or already
        finished (retire, don't migrate), or the export itself failed --
        the drain path then falls back to progress-only accounting."""
        if not self.config.step_batching.export_carries:
            return None
        if not (0 < state.steps_done < state.steps_total):
            return None
        executor = state.executor
        if not hasattr(executor, "step_export"):
            return None
        try:
            extra, leaves = executor.step_export(state.work)
            extra = dict(extra)
            family = str(extra.pop("family", ""))
            # the executor's own step index is authoritative -- it and
            # steps_done advance together, but the carry is what resumes
            step = int(extra.pop("step", state.steps_done))
            data = encode_snapshot(
                ekey=state.ekey, family=family, step=step,
                steps_total=state.steps_total,
                request_id=str(state.request.request_id),
                prompt=state.request.prompt, seed=state.request.seed,
                leaves=list(leaves), extra=extra or None,
            )
        except Exception:  # noqa: BLE001 -- export is best-effort
            self.counters.inc("carry_export_failed")
            return None
        if self.fault_plan is not None:
            # chaos site: truncation/corruption during the export write
            data = self.fault_plan.mutate("migrate.export", data,
                                          key=state.ekey)
        return data

    def _step_drain(self) -> None:
        """Deterministic stop: every resident carry (occupied + parked)
        resolves its future and releases its buffers -- no step-mode
        future is ever left unresolved.  With ``export_carries`` on, a
        mid-denoise carry first serializes (serve/migration.py) and
        rides out on `CarryExportedError.snapshot` so a caller (the JAX
        package's fleet, a client) resumes it on another server instead of
        re-running
        from step 0; a carry that cannot export still reports its
        ``steps_done`` so the caller can count the steps it is about to
        re-execute."""
        sb = self.stepbatch
        try:
            self._ranks_rebuild()  # the exports are commands over the ranks
        except Exception:  # noqa: BLE001 -- the exports then fail typed
            pass
        for state in list(sb.occupied()) + list(sb.parked):
            self.counters.inc("rejected_server_closed")
            data = self._step_export(state)
            if data is not None:
                self.counters.inc("carries_exported")
                if (self.tracer is not None
                        and state.request.trace is not None):
                    rt = state.request.trace
                    self.tracer.event(
                        "migrate_out", track=rt.track, trace=rt.trace_id,
                        args={"step": state.steps_done,
                              "of": state.steps_total,
                              "bytes": len(data)})
                exc: ServerClosedError = CarryExportedError(
                    f"server stopped at step {state.steps_done}/"
                    f"{state.steps_total}; carry exported for migration",
                    snapshot=data, steps_done=state.steps_done)
            elif (self.config.step_batching.export_carries
                    and state.steps_done > 0):
                # export was ON but this carry could not serialize:
                # progress-only accounting still rides out so the caller
                # can count the steps it is about to re-execute.  With
                # export OFF the operator opted out of migration -- the
                # documented contract is the plain ServerClosedError path
                exc = CarryExportedError(
                    f"server stopped at step {state.steps_done}/"
                    f"{state.steps_total}; carry not exportable",
                    snapshot=None, steps_done=state.steps_done)
            else:
                exc = ServerClosedError("server stopped")
            self._step_fail_state(state, exc)

    # -- the resilient execute path ---------------------------------------

    def _execute(self, key: BatchKey, batch: List[Request]) -> None:
        dispatch_ts = self.clock()
        # staged outcomes that landed while this batch was forming must
        # reach the breaker/ladder BEFORE the allow()/routing decisions
        self._drain_staged_outcomes()
        base_key = self._exec_key_for(key.height, key.width, key.steps,
                                      key.cfg)
        # Closed-loop tier selection (serve/controller.py): map the bucket
        # key through the cheapest tier any member class needs BEFORE the
        # resilience layer sees it -- breakers and sticky ladder rungs then
        # track per TIER key, and degraded_key() composes the rungs on top
        # of the tier's knobs, so ladder rungs always win.
        tier_idx = None
        if self.controller is not None:
            from .controller import apply_tier

            tier_idx, tier = self.controller.tier_for_batch(
                [r.slo_class for r in batch])
            base_key = apply_tier(base_key, tier)
        batch_span = None
        if self.tracer is not None:
            targs = {"bucket": f"{key.height}x{key.width}",
                     "n": len(batch), "key": base_key.short(),
                     "traces": [r.trace.trace_id for r in batch
                                if r.trace is not None]}
            if tier_idx is not None:
                targs["tier"] = self.controller.tiers[tier_idx].name
            batch_span = self.tracer.begin(
                "batch", track="scheduler", t=dispatch_ts, args=targs)
            for req in batch:
                self._trace_dequeue(req, batch_span, len(batch))
        if not self.resilience.allow(base_key):
            self._shed(base_key, batch)
            if self.tracer is not None:
                self.tracer.end(batch_span, args={"outcome": "shed"})
            return
        if tier_idx is not None:
            # counted only past the breaker gate: a shed batch never ran
            # at the tier, and the per-tier dispatch counters are read as
            # tier THROUGHPUT exactly when the card is failing
            self.controller.count_dispatch(tier_idx, len(batch))
        # inflight gauge: dispatched-but-unresolved requests (the SLO
        # controller's second queue signal).  Every exit path below must
        # balance it -- staged submissions hand the decrement to
        # _staged_release, which fires exactly once per submitted batch.
        self._inflight_c.inc("requests", len(batch))
        staged = self._execute_staged(key, base_key, batch, dispatch_ts,
                                      tier_idx)
        if staged == "submitted":
            if self.tracer is not None:
                self.tracer.end(batch_span, args={"outcome": "staged"})
            return
        if staged == "failed":
            self._inflight_c.inc("requests", -len(batch))
            if self.tracer is not None:
                self.tracer.end(batch_span, args={"outcome": "failed"})
            return
        try:
            self._execute_resilient(key, base_key, batch, dispatch_ts,
                                    tier_idx)
        finally:
            # batch span first, THEN the inflight decrement: a client
            # observing inflight==0 knows the scheduler has made its
            # last tracer/clock call for this batch
            if self.tracer is not None:
                self.tracer.end(batch_span)
            self._inflight_c.inc("requests", -len(batch))

    # -- resilient dispatch ------------------------------------------------

    # -- the staged execute path -------------------------------------------

    def _drain_staged_outcomes(self) -> None:
        """Apply finished staged batches' breaker/ladder bookkeeping on
        the scheduler thread.  A staged failure is ONE terminal dispatch
        failure (there is no intra-stage retry loop); OOM/compile kinds
        advance the sticky degradation ladder -- ``staging_off`` first, so
        a key that cannot afford the overlap's residency falls back to
        the monolithic path (which still has the full retry machinery)."""
        if self.staging is None:
            return
        for base_key, ekey, exc in self.staging.drain_outcomes():
            if exc is None:
                self.resilience.on_success(base_key)
                continue
            self.resilience.on_failure(base_key, exc)
            kind = failure_kind(exc)
            if kind in ("oom", "compile"):
                # batch_size=1 deliberately skips RUNG_SPLIT: staged
                # dispatches never split (splitting is the retry loop's
                # move), so the ladder advances straight to the key rungs
                rung = self.resilience.degrade(base_key, kind, 1)
                if rung is not None:
                    self.counters.inc("degraded_" + rung)
                    if rung != RUNG_STAGING_OFF:
                        # the poisoned executor must not satisfy the next
                        # dispatch (same contract as the monolithic path)
                        self.cache.invalidate(ekey)

    def _staging_routed(self, base_key: ExecKey) -> bool:
        return (self.staging is not None
                and RUNG_STAGING_OFF
                not in self.resilience.key_state(base_key).rungs)

    def _execute_staged(self, key: BatchKey, base_key: ExecKey,
                        batch: List[Request], dispatch_ts: float,
                        tier_idx: Optional[int] = None) -> str:
        """Submit the batch to the stage pipeline.  Returns
        ``"submitted"`` (the pipeline owns the batch now -- its inflight
        decrement rides `_staged_release`), ``"failed"`` (consumed by a
        terminal failure here), or ``"fallthrough"`` to the monolithic
        path (staging off/degraded for this key, or an executor without
        stage programs)."""
        if not self._staging_routed(base_key):
            return "fallthrough"
        from .staging import StagedBatch

        ekey = self.resilience.degraded_key(base_key)
        try:
            self._ranks_rebuild()
            # pinned for the batch's whole trip: LRU eviction or
            # invalidate() must never free a pipeline a stage worker is
            # about to run (ExecutorCache defers the release to unpin)
            executor, hit = self.cache.get(ekey, pin=True)
        except Exception as exc:  # noqa: BLE001 -- typed below
            bexc = exc if isinstance(exc, ServeError) else BuildFailedError(
                f"executor build failed for {ekey.short()}: "
                f"{type(exc).__name__}: {exc}"
            )
            # one terminal dispatch failure, like a stage failure -- the
            # ladder may force staging off so the NEXT dispatch retries
            # through the monolithic machinery
            self.resilience.on_failure(base_key, bexc)
            kind = failure_kind(bexc)
            if kind in ("oom", "compile"):
                rung = self.resilience.degrade(base_key, kind, 1)
                if rung is not None:
                    self.counters.inc("degraded_" + rung)
            self.counters.inc("failed_build", len(batch))
            self._fail_batch(batch, bexc)
            return "failed"
        if not hasattr(executor, "encode_stage"):
            # executor has no stage contract (plain fakes, custom
            # adapters): unpin and run monolithically
            self.cache.unpin(executor)
            return "fallthrough"
        sb = StagedBatch(
            batch_key=key, base_key=base_key, ekey=ekey, requests=batch,
            executor=executor, compile_hit=hit, dispatch_ts=dispatch_ts,
            tier=tier_idx,
        )
        if not self.staging.submit(sb):
            # pipeline is stopping: deterministic close, like the queued
            # futures stop() drains
            self.cache.unpin(executor)
            self.counters.inc("rejected_server_closed", len(batch))
            self._fail_batch(batch, ServerClosedError("server stopped"))
            return "failed"
        return "submitted"

    def _staged_success(self, sb, outputs, t0: float, t1: float) -> None:
        """Decode-worker callback: resolve and record one completed staged
        batch (counters/histograms are thread-safe; breaker bookkeeping
        rides drain_outcomes instead)."""
        shallow = int(getattr(sb.executor, "shallow_steps", 0))
        degradations = tuple(self.resilience.key_state(sb.base_key).rungs)
        self._complete_batch(
            sb.batch_key, sb.ekey, sb.requests, outputs, sb.dispatch_ts,
            t0, t1, sb.compile_hit, retries=0, degradations=degradations,
            shallow_steps=shallow, tier=sb.tier,
        )

    def _staged_failure(self, sb, exc: Exception) -> None:
        """Stage-worker callback: fail one staged batch's futures, counted
        by failure type (mirrors the monolithic counters)."""
        n = len(sb.requests)
        if isinstance(exc, ServerClosedError):
            self.counters.inc("rejected_server_closed", n)
        elif isinstance(exc, DeadlineExceededError):
            self.counters.inc("rejected_deadline", n)
        elif isinstance(exc, WatchdogTimeoutError):
            self.counters.inc("watchdog_timeouts")
            self.counters.inc("failed_execute", n)
            self._ranks_abort(exc)
        elif isinstance(exc, BuildFailedError):
            self.counters.inc("failed_build", n)
        elif isinstance(exc, FatalError):
            self.counters.inc("failed_fatal", n)
        else:
            self.counters.inc("failed_execute", n)
        self._fail_batch(sb.requests, exc)

    def _staged_release(self, sb) -> None:
        # fires exactly once per submitted staged batch, on ANY exit path
        # (success, failure, cancel-drop, stop): the executor unpin and
        # the inflight decrement both belong to "the batch left the
        # pipeline"
        self._inflight_c.inc("requests", -len(sb.requests))
        drop = getattr(sb.executor, "drop_work_on_followers", None)
        if drop is not None and sb.work is not None:
            drop(sb.work)
        self.cache.unpin(sb.executor)

    def _shed(self, ekey: ExecKey, batch: List[Request]) -> None:
        """Circuit open: fail fast with the 503-style typed error — the
        whole point is spending O(dispatch) time, not queue/retry time,
        on a key that keeps failing."""
        self.counters.inc("shed_circuit_open", len(batch))
        self._fail_batch(batch, CircuitOpenError(
            f"circuit open for {ekey.short()}: shedding fast; retry after "
            f"the {self.config.resilience.breaker_cooldown_s:.1f}s cooldown "
            "or against another replica"
        ))

    def _get_executor(self, ekey: ExecKey):
        """Cache fetch with build failures wrapped into the typed
        hierarchy (`BuildFailedError`; message keeps the OOM shape
        visible when the compile itself exhausted memory)."""
        try:
            return self.cache.get(ekey)
        except ServeError:
            raise
        except Exception as exc:
            raise BuildFailedError(
                f"executor build failed for {ekey.short()}: "
                f"{type(exc).__name__}: {exc}"
            ) from exc

    def _dispatch(self, ekey: ExecKey, key: BatchKey, executor,
                  batch: List[Request]):
        """One watchdog-bounded batched executor invocation; execute
        failures come back typed (`ResourceExhaustedError` for OOM shapes,
        `ExecuteFailedError` otherwise, `WatchdogTimeoutError` on hang)."""
        prompts = [r.prompt for r in batch]
        negs = [r.negative_prompt for r in batch]
        seeds = [r.seed for r in batch]
        t0 = self.clock()

        def call():
            if self.fault_plan is not None:
                self.fault_plan.check("execute", key=ekey,
                                      batch_size=len(batch))
            return executor(prompts, negs, key.guidance_scale, seeds)

        try:
            outputs = self.resilience.watchdog.run(call)
        except WatchdogTimeoutError as exc:
            self.counters.inc("watchdog_timeouts")
            cause = self._ranks_abort(exc)
            if cause is None:
                raise
            raise self._execute_error(ekey, batch, cause) from exc
        except ServeError:
            raise
        except Exception as exc:
            raise self._execute_error(ekey, batch, exc) from exc
        t1 = self.clock()
        if len(outputs) != len(batch):
            # contract violation, NOT a transient fault: the typed escape
            # (outside the ServeError hierarchy, serve/errors.py) bubbles
            # past the retry loop to the _loop guard, which fails the
            # batch and counts a scheduler_error
            raise ExecutorContractError(
                f"executor returned {len(outputs)} outputs for a batch of "
                f"{len(batch)}"
            )
        return outputs, t0, t1

    @staticmethod
    def _execute_error(ekey: ExecKey, batch: List[Request],
                       exc: BaseException) -> Exception:
        """A batched execute failure, typed: itself if a `ServeError`,
        `ResourceExhaustedError` for OOM shapes, else `ExecuteFailedError`."""
        if isinstance(exc, ServeError):
            return exc
        if is_oom(exc):
            # the failed call's frames (and the device memory their
            # tensors hold) are reachable through this traceback, and
            # the chained error outlives the ladder's rebuild: keep
            # the exception and its text, drop the frames
            exc.__traceback__ = None
            return ResourceExhaustedError(
                f"batched execute OOM for {ekey.short()} at batch "
                f"{len(batch)}: {exc}")
        return ExecuteFailedError(
            f"batched execute failed for {ekey.short()}: "
            f"{type(exc).__name__}: {exc}")

    def _execute_resilient(self, key: BatchKey, base_key: ExecKey,
                           batch: List[Request], dispatch_ts: float,
                           tier_idx: Optional[int] = None) -> None:
        """Bounded retry loop around (build -> dispatch) with the
        degradation ladder on OOM/compile failures.  Splitting recurses
        with fresh attempt budgets (depth is bounded by log2(batch));
        every retry anywhere draws from the global retry budget."""
        res = self.resilience
        rcfg = self.config.resilience
        attempts = 0
        while True:
            if self._stop.is_set():
                self.counters.inc("rejected_server_closed", len(batch))
                self._fail_batch(batch, ServerClosedError("server stopped"))
                return
            ekey = res.degraded_key(base_key)
            try:
                self._ranks_rebuild()
                executor, hit = self._get_executor(ekey)
                outputs, t0, t1 = self._dispatch(ekey, key, executor, batch)
            except FatalError as exc:
                res.on_failure(base_key, exc)
                self.counters.inc("failed_fatal", len(batch))
                self._fail_batch(batch, exc)
                return
            except RetryableError as exc:
                # attempt-level: observability only — the breaker counts
                # TERMINAL dispatch failures (below), so exhausting
                # max_retries and tripping the circuit stay separately
                # tuned policies
                res.note_error(base_key, exc)
                kind = failure_kind(exc)
                failed_counter = ("failed_build"
                                  if isinstance(exc, BuildFailedError)
                                  else "failed_execute")
                cause = exc.__cause__
                if (isinstance(exc, BuildFailedError)
                        and isinstance(cause, DegradationInapplicableError)
                        and res.retract_rung(base_key, cause.rung)):
                    # the rung can NEVER build for this key's build function
                    # (e.g. weight_quant_on against tensor/pipefusion):
                    # un-apply it and retry at the retracted key instead
                    # of turning a transient OOM into a permanently
                    # failing key; the pin in KeyResilience.inapplicable
                    # keeps the ladder from re-picking it
                    self.counters.inc("degradation_retracted_" + cause.rung)
                elif kind in ("oom", "compile"):
                    rung = res.degrade(base_key, kind, len(batch))
                    if rung == RUNG_SPLIT:
                        if not res.acquire_retry():
                            self.counters.inc("retry_budget_exhausted")
                            self.counters.inc(failed_counter, len(batch))
                            res.record_terminal_failure(base_key)
                            self._fail_batch(batch, exc)
                            return
                        self.counters.inc("retries")
                        self.counters.inc("degraded_split_batch")
                        if self.tracer is not None:
                            self.tracer.event(
                                "split_batch", track="scheduler",
                                args={"key": ekey.short(),
                                      "n": len(batch)})
                        mid = (len(batch) + 1) // 2
                        self._execute_resilient(key, base_key, batch[:mid],
                                                dispatch_ts, tier_idx)
                        self._execute_resilient(key, base_key, batch[mid:],
                                                dispatch_ts, tier_idx)
                        return
                    if rung is not None:
                        self.counters.inc("degraded_" + rung)
                        # the poisoned program must not satisfy the retry
                        self.cache.invalidate(ekey)
                attempts += 1
                if attempts > rcfg.max_retries:
                    self.counters.inc(failed_counter, len(batch))
                    res.record_terminal_failure(base_key)
                    self._fail_batch(batch, exc)
                    return
                if not res.acquire_retry():
                    self.counters.inc("retry_budget_exhausted")
                    self.counters.inc(failed_counter, len(batch))
                    res.record_terminal_failure(base_key)
                    self._fail_batch(batch, exc)
                    return
                self.counters.inc("retries")
                if self.tracer is not None:
                    self.tracer.event(
                        "retry", track="scheduler",
                        args={"attempt": attempts, "kind": kind,
                              "key": ekey.short(),
                              "error": type(exc).__name__})
                res.sleep(res.backoff_delay(attempts))
                continue
            except Exception as exc:
                # non-ServeError escape (executor contract violation):
                # destined for the _loop guard, but the breaker must still
                # see it — a HALF_OPEN probe that dies this way would
                # otherwise leave the probe-inflight latch set forever,
                # permanently shedding the key with no healing path
                res.on_failure(base_key, exc)
                raise
            # ---- success ------------------------------------------------
            res.on_success(base_key)
            self._complete_batch(
                key, ekey, batch, outputs, dispatch_ts, t0, t1, hit,
                retries=attempts,
                degradations=tuple(res.key_state(base_key).rungs),
                shallow_steps=int(getattr(executor, "shallow_steps", 0)),
                tier=tier_idx,
            )
            return

    def _complete_batch(self, key: BatchKey, ekey: ExecKey,
                        batch: List[Request], outputs, dispatch_ts: float,
                        t0: float, t1: float, hit: bool, *, retries: int,
                        degradations: tuple, shallow_steps: int,
                        tier: Optional[int] = None) -> None:
        """Per-request success bookkeeping shared by the monolithic and
        staged dispatch paths: counters, latency histograms, and future
        resolution.  Thread-safe (staged batches complete on the decode
        worker while the scheduler thread completes monolithic ones)."""
        self.counters.inc("batches")
        ekey_short = ekey.short()
        # tier pinning (ServeResult audit trail): resolve the tier index
        # to its name once per batch -- None when the controller is off
        tier_name = (self.controller.tiers[tier].name
                     if tier is not None and self.controller is not None
                     else None)
        self.counters.inc("requests_compile_hit" if hit
                          else "requests_compile_miss", len(batch))
        self._batch_sizes.inc(f"size_{len(batch)}")
        exec_s = t1 - t0
        if self.controller is not None:
            # calibrate the controller's forward model: one cost-
            # normalized batch-service observation per completed batch
            self.controller.observe_batch(tier, t1 - t0)
        # shallow-step share: how much of the card's time the step cache
        # saved from full network evaluations (0 when the cache is off)
        self.counters.inc("denoise_steps_total", key.steps * len(batch))
        if shallow_steps:
            self.counters.inc("denoise_steps_shallow",
                              shallow_steps * len(batch))
        for req, out in zip(batch, outputs):
            queue_wait = dispatch_ts - req.enqueue_ts
            e2e = t1 - req.enqueue_ts
            self.hist_queue_wait.observe(queue_wait)
            self.hist_execute.observe(exec_s)
            self.hist_e2e.observe(e2e)
            self.slo_window(req.slo_class).observe(e2e)
            self._tenant_observe(req, queue_wait)
            self.counters.inc("completed")
            if req.expired(t1):
                # deadline lapsed while IN FLIGHT: deadlines gate
                # scheduling, never abandon device work — the caller
                # still gets the result, and the lateness is counted
                self.counters.inc("completed_late")
            if req.trace is not None and self.tracer is not None:
                rt = req.trace
                self.tracer.complete(
                    "execute", t0, t1, track=rt.track, trace=rt.trace_id,
                    parent=rt.root,
                    args={"bucket": f"{ekey.height}x{ekey.width}",
                          "batch_size": len(batch), "compile_hit": hit})
                if rt.flow_id is not None:
                    # finish the batch->member flow arrow inside the
                    # execute slice
                    self.tracer.flow(rt.flow_id, "f", track=rt.track,
                                     t=t0, name="member")
                self._trace_finish(req, "completed", args={
                    "retries": retries,
                    "degradations": list(degradations),
                    "batch_size": len(batch)})
            self._resolve(req.future, result=ServeResult(
                request_id=req.request_id,
                output=out,
                bucket=(ekey.height, ekey.width),
                requested_size=(req.height, req.width),
                queue_wait_s=queue_wait,
                execute_s=exec_s,
                e2e_s=e2e,
                batch_size=len(batch),
                compile_hit=hit,
                retries=retries,
                degradations=degradations,
                exec_key=ekey_short,
                tier=tier_name,
                replica=self.replica_name,
            ))

    def _tenant_observe(self, req: Request, queue_wait: float) -> None:
        """Per-tenant completion accounting (no-op when tenancy is off):
        the rolling queue-wait window, plus the completed count."""
        tc = self._tenant_counters.get(req.tenant)
        if tc is not None:
            tc.inc("completed")
        w = self._tenant_wait.get(req.tenant)
        if w is not None:
            w.observe(queue_wait)

    # -- observability -----------------------------------------------------

    def slo_window(self, slo_class: str):
        """The rolling e2e-latency window for one SLO class (created on
        first use; one `RollingQuantile` per class in the registry).
        Samples age out after ``observability.slo_max_age_s`` on the
        server clock — without the bound the windows are time-blind and
        an idle server pins minutes-old p99s into the controller."""
        return self.registry.rolling(
            "serve_slo_e2e_seconds", window=self._slo_window,
            labels={"slo_class": str(slo_class)},
            clock=self.clock, max_age_s=self._slo_max_age)

    def pending(self) -> int:
        """Queued + dispatched-but-unresolved request count — the cheap
        load signal the fleet router reads per dispatch (unlike
        `slo_snapshot`, no class windows are rendered)."""
        return len(self.queue) + int(self._inflight_c.get("requests"))

    def slo_snapshot(self) -> Dict[str, Any]:
        """The interface the closed-loop SLO controller
        (serve/controller.py) reads: current queue depth, dispatched-but-unresolved request
        count, and per-SLO-class rolling p50/p99 over the last
        ``observability.slo_window`` completions.  O(classes · window)
        and any-thread-safe — poll it as fast as you like."""
        classes = {}
        # one family, not the whole registry: health()/the controller
        # poll this, and a scrape must not pay for every histogram
        for lbls, window in self.registry.family("serve_slo_e2e_seconds"):
            classes[lbls.get("slo_class", "default")] = window.snapshot()
        snap = {
            "queue_depth": len(self.queue),
            "inflight_requests": self._inflight_c.get("requests"),
            "slo_window": self._slo_window,
            "classes": classes,
        }
        if self.stepbatch is not None:
            # step-granular occupancy block: the controller's forward
            # model switches to per-step accounting when this is present
            # (SLOController._step_predictor) -- occupancy is per-step,
            # not per-batch, on a slot-pool server
            sb = self.stepbatch
            snap["step"] = {
                "slots": self.config.step_batching.slots,
                "occupied": len(sb.occupied()),
                "parked": len(sb.parked),
                "remaining_steps_total": sb.remaining_steps_total(),
                "per_step_s": sb.per_step_s(),
                "steps_hint": self.config.default_steps,
            }
        return snap

    def metrics_prometheus(self) -> str:
        """The unified registry in Prometheus text exposition format —
        what the ``--metrics_port`` endpoint serves at ``/metrics``."""
        return self.registry.to_prometheus()

    def start_gateway(self, port: Optional[int] = None):
        """Serve the generation plane over stdlib HTTP/SSE
        (serve/gateway.py): ``POST /v1/generate``, SSE progress at
        ``GET /v1/requests/<id>/events``, result polling, and cancel.
        Auto-started by `start()` when ``config.gateway.port`` is set;
        ``port=0`` binds ephemerally (read
        ``server.gateway_endpoint.port``).  Stopped by `stop()` before
        the scheduler drains, so every open stream resolves."""
        from .gateway import Gateway

        if self.gateway_endpoint is not None:
            return self.gateway_endpoint
        cfg = self.config.gateway
        if port is None:
            port = cfg.port or 0
        self.gateway_endpoint = Gateway(
            self, config=cfg, registry=self.registry,
            tracer=self.tracer, clock=self.clock,
        ).start(port=int(port))
        return self.gateway_endpoint

    def start_metrics_endpoint(self, port: Optional[int] = None):
        """Serve the metrics plane over stdlib HTTP: ``/metrics``
        (Prometheus text), ``/metrics.json`` (registry JSON), and
        ``/healthz`` (the `health()` snapshot).  Auto-started by
        `start()` when ``observability.metrics_port`` is set; ``port=0``
        binds ephemerally (read ``server.metrics_endpoint.port``)."""
        from ..utils.metrics import MetricsHTTPEndpoint

        if self.metrics_endpoint is not None:
            return self.metrics_endpoint
        if port is None:
            port = self.config.observability.metrics_port or 0
        self.metrics_endpoint = MetricsHTTPEndpoint(
            prom=self.metrics_prometheus,
            json_snapshot=lambda: self.registry.snapshot(),
            health=self.health,
            port=int(port),
            host=self.config.observability.metrics_host,
        ).start()
        return self.metrics_endpoint

    def dump_observability(self, directory: str) -> Dict[str, str]:
        """Write the whole observability surface as files into
        ``directory`` (created if needed): ``metrics.json`` (the serve
        artifact snapshot), ``registry.json`` (the raw registry),
        ``metrics.prom`` (Prometheus text), ``health.json``,
        ``slo.json``, and — when tracing is on — ``trace.json``
        (Perfetto-loadable).  Returns {name: path}."""
        import os

        os.makedirs(directory, exist_ok=True)
        paths: Dict[str, str] = {}

        def dump_json(name, payload):
            path = os.path.join(directory, name)
            with open(path, "w") as f:
                json.dump(payload, f, indent=2, sort_keys=True)
                f.write("\n")
            paths[name] = path

        dump_json("metrics.json", self.metrics_snapshot())
        dump_json("registry.json", self.registry.snapshot())
        dump_json("health.json", self.health())
        dump_json("slo.json", self.slo_snapshot())
        prom_path = os.path.join(directory, "metrics.prom")
        with open(prom_path, "w") as f:
            f.write(self.metrics_prometheus())
        paths["metrics.prom"] = prom_path
        if self.tracer is not None:
            trace_path = os.path.join(directory, "trace.json")
            self.tracer.export(trace_path)
            paths["trace.json"] = trace_path
        return paths

    def health(self) -> Dict[str, Any]:
        """Liveness/readiness snapshot (docs/SERVING.md schema): queue
        depth, scheduler liveness, per-key circuit states, active
        degradations, retry budget, and the most recent errors."""
        res = self.resilience.snapshot()
        c = self.counters.snapshot()
        degraded = bool(res["open_circuits"] or res["degradations"])
        t = self._thread  # one read: a concurrent stop may None the attr
        if self._ranks_aborted():
            degraded = True  # the data groups wait for their rebuild
        status = "degraded" if degraded else "ok"
        snap = {
            "status": status,
            "queue_depth": len(self.queue),
            "scheduler_alive": bool(t is not None and t.is_alive()),
            "requests": {
                k: c.get(k, 0)
                for k in ("submitted", "completed", "completed_late",
                          "retries", "shed_circuit_open",
                          "watchdog_timeouts", "failed_build",
                          "failed_execute", "scheduler_errors")
            },
            **res,
        }
        if self.ranks is not None:
            # over n ranks: the world, the data groups' generation, why
            # they were aborted (None while they serve), the aborts and
            # rebuilds so far, the last rebuild's seconds and the commands
            # posted so far
            from ..utils.config import data_group_generation

            r = self.ranks
            snap["ranks"] = {"world": r.world, "generation": data_group_generation(),
                             "aborted": r.aborted, "aborts": r.aborts,
                             "rebuilds": r.rebuilds, "rebuild_s": self._ranks_rebuild_s,
                             "commands": r.commands}
        return snap

    def metrics_snapshot(self) -> Dict[str, Any]:
        """JSON-friendly service metrics — the serve artifact schema
        (docs/SERVING.md) consumed by scripts/serve_bench.py."""
        sizes = self._batch_sizes.snapshot()
        n_batches = sum(sizes.values())
        n_reqs = sum(int(k.split("_")[1]) * v for k, v in sizes.items())
        reqs = self.counters.snapshot()
        steps_total = reqs.get("denoise_steps_total", 0)
        steps_shallow = reqs.get("denoise_steps_shallow", 0)
        return {
            "model_id": self.model_id,
            "scheduler": self.scheduler,
            "mesh_plan": self.mesh_plan,
            # which fleet replica this server is (None on a bare server)
            "replica": self.replica_name,
            "config": {
                "max_queue_depth": self.config.max_queue_depth,
                "max_batch_size": self.config.max_batch_size,
                "batch_window_s": self.config.batch_window_s,
                "cache_capacity": self.config.cache_capacity,
                "buckets": [list(b) for b in self.batcher.table.buckets],
                "pipeline_stages": self.config.pipeline_stages,
                "max_inflight_batches": self.config.max_inflight_batches,
            },
            "requests": reqs,
            "step_cache": {
                "interval": self.config.step_cache_interval,
                "depth": self.config.step_cache_depth,
                "steps_total": steps_total,
                "steps_shallow": steps_shallow,
                "shallow_share": (steps_shallow / steps_total
                                  if steps_total else 0.0),
            },
            "latency_s": {
                "queue_wait": self.hist_queue_wait.snapshot(),
                "execute": self.hist_execute.snapshot(),
                "e2e": self.hist_e2e.snapshot(),
            },
            "batch_size": {
                "hist": sizes,
                "mean": (n_reqs / n_batches) if n_batches else 0.0,
            },
            "cache": self.cache.stats(),
            # per-executor weight bytes on the device (quantization-aware,
            # None for non-reporting executors)
            "weights": {
                "weight_quant": self.config.weight_quant,
                "quant_compute": self.config.quant_compute,
                "per_executor_nbytes": self.cache.weight_bytes(),
            },
            "resilience": self.resilience.snapshot(),
            # per-stage queue-wait/service histograms + denoise-gap
            # fraction (None on monolithic servers)
            "staging": (self.staging.snapshot()
                        if self.staging is not None else None),
            # slot-pool state + join/leave/preempt/resume lifetime
            # counters (None on whole-batch servers)
            "step_batching": (self.stepbatch.snapshot()
                              if self.stepbatch is not None else None),
            # per-tenant fair-queue accounting: token/deficit state plus
            # admit/reject/dequeue counts (None when tenancy is off)
            "tenancy": self.queue.tenancy_snapshot(),
            # the tracing + SLO plane (docs/OBSERVABILITY.md): trace ring
            # stats (None when tracing is off) and the rolling-window SLO
            # signals the closed-loop controller reads
            "observability": {
                "trace": (self.tracer.stats()
                          if self.tracer is not None else None),
                "slo": self.slo_snapshot(),
            },
            # the closed-loop SLO controller's tier state (None when off)
            "controller": (self.controller.snapshot()
                           if self.controller is not None else None),
            # prompt/embedding cache in front of text-encode (None when off)
            "prompt_cache": (self.prompt_cache.snapshot()
                             if self.prompt_cache is not None else None),
        }

    def export_metrics(self, path: str) -> Dict[str, Any]:
        snap = self.metrics_snapshot()
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
            f.write("\n")
        return snap
