"""The long-lived inference server: admission -> micro-batch -> execute.

`InferenceServer` ties the serve pieces together around ONE card:

* `submit()` (any thread) runs admission control and returns a
  `concurrent.futures.Future` resolving to a `ServeResult`;
* a single scheduler thread drains the queue through the `MicroBatcher`,
  fetches the bucket's executor from the `ExecutorCache` (warm = hit, cold
  = build and capture), runs the coalesced batch through it, and resolves
  the futures (the executor pads to its prepared batch width and strips);
* every request's lifecycle (queue wait, batch size, cache hit/miss,
  execute and end-to-end latency) lands in streaming histograms
  (utils/metrics.py) exported as one JSON artifact.

One scheduler thread is deliberate: the service owns one card, and the
card runs one program at a time -- extra dispatch threads would only
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

This is the whole-batch path of the JAX package's server (ROADMAP item 16,
step 16a).  What switches on over it there comes with later steps, and
the server refuses it until then with a ``ValueError`` naming the step:
staging and the prompt cache (16b), step batching (16c), the SLO
controller, tenancy and the gateway (16d), and the AOT store (16g).
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
    BuildFailedError,
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
    WatchdogTimeoutError,
    is_oom,
)
from .faults import FaultPlan
from .queue import Request, RequestQueue, ServeResult
from .resilience import RUNG_SPLIT, ResilienceEngine, failure_kind

ROADMAP_STEP = {
    "pipeline_stages": "16b (staging and the prompt cache)",
    "prompt_cache": "16b (staging and the prompt cache)",
    "step_batching": "16c (step batching and carry migration)",
    "controller": "16d (the controller, tenancy and the gateway)",
    "tenancy": "16d (the controller, tenancy and the gateway)",
    "gateway": "16d (the controller, tenancy and the gateway)",
    "aot_cache": "16g (the AOT store)",
}


def _not_ported(what: str, step: str) -> ValueError:
    return ValueError(
        f"{what} is not ported to the PyTorch serve plane yet: it comes with "
        f"ROADMAP item 16, step {ROADMAP_STEP[step]}")


def refuse_unported(config: ServeConfig) -> None:
    """Raise ``ValueError`` for every setting whose subsystem this step of
    ROADMAP item 16 does not port.  `ServeConfig` itself accepts them, as
    the JAX package's does; the server refuses to run with them on."""
    if config.pipeline_stages:
        raise _not_ported("ServeConfig(pipeline_stages=True)", "pipeline_stages")
    if config.prompt_cache_capacity > 0:
        raise _not_ported("ServeConfig(prompt_cache_capacity > 0)", "prompt_cache")
    if config.step_batching.enabled:
        raise _not_ported("step_batching.enabled", "step_batching")
    if config.controller.enabled:
        raise _not_ported("controller.enabled", "controller")
    if config.gateway.tenants:
        raise _not_ported("a gateway tenant table (gateway.tenants)", "tenancy")
    if config.gateway.port is not None:
        raise _not_ported("the HTTP/SSE gateway (gateway.port)", "gateway")
    if config.aot_cache.dir:
        raise _not_ported("the AOT executable store (aot_cache.dir)", "aot_cache")


class InferenceServer:
    """Async request scheduler with continuous micro-batching over one card.

    ``executor_factory(key: ExecKey)`` builds (and prepares) the executor
    for a bucket; ``model_id``/``scheduler``/``mesh_plan`` identify the
    served model in cache keys -- pass ``distri_config.mesh_plan`` when
    wrapping real pipelines so a layout change invalidates the cache keys.
    ``fault_plan`` (chaos/testing) injects failures at sites ``"build"``
    (around the factory) and ``"execute"`` (inside the watchdog-bounded
    dispatch).
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
    ):
        self.config = config or ServeConfig()
        refuse_unported(self.config)
        self.model_id = model_id
        self.scheduler = scheduler
        self.mesh_plan = mesh_plan
        self.clock = clock
        self.fault_plan = fault_plan
        self.replica_name = replica_name
        self.queue = RequestQueue(self.config.max_queue_depth)

        def _factory(key, _inner=executor_factory):
            # the "build" site wraps WHATEVER factory was passed, so fake
            # and real executors get build faults through one code path
            if key.exec_mode == "step":
                raise _not_ported("an ExecKey(exec_mode='step')", "step_batching")
            if self.fault_plan is not None:
                self.fault_plan.check("build", key=key)
            return _inner(key)

        self.cache = ExecutorCache(
            _factory, capacity=self.config.cache_capacity
        )
        obs = self.config.observability
        # Request-scoped tracing (utils/trace.py): None when off -- every
        # hook below is guarded, so the tracing-off request path runs no
        # tracing code at all
        self.tracer = (Tracer(clock=clock, capacity=obs.trace_capacity)
                       if obs.trace else None)
        self.cache.tracer = self.tracer
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
        self.metrics_endpoint = None
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
            tracer=self.tracer,
        )
        # the resilience ring log joins the unified registry (JSON render;
        # the Prometheus exposition skips free-text rings by design)
        self.registry.register("serve_last_errors",
                               self.resilience.last_errors)
        self.registry.gauge(
            "serve_watchdog_timeouts",
            lambda: float(self.resilience.watchdog.timeouts))
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
        `stop()` completes the shutdown (join, endpoint teardown)."""
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
        with self._lifecycle_lock:
            self._started = False

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
            exec_mode="fused",
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
        replica or later) or `ServerClosedError` immediately; deadline,
        bucket, circuit-breaker, and execution failures fail the *future*
        instead, since they are decided at scheduling time.  Every error
        is a `ServeError`: `RetryableError` means the same request may
        succeed later/elsewhere, `FatalError` means it cannot.

        ``slo_class`` tags the request for the per-class rolling-latency
        windows (`slo_snapshot`).  ``tenant`` is accepted and carried, as
        on a JAX server without a tenant table; ``on_progress`` is ignored,
        as on the JAX package's whole-batch servers (previews need step
        batching).  ``carry_snapshot`` (carry migration) needs step
        batching, so it is rejected with `MigrationRejectedError`, as the
        JAX package rejects it without step batching."""
        if not self._started or self._stop.is_set():
            raise ServerClosedError("server is not running")
        if carry_snapshot is not None:
            raise MigrationRejectedError(
                "carry import needs step-level continuous batching "
                "(ServeConfig.step_batching.enabled) on the importing "
                "replica, which comes with ROADMAP item 16, step "
                + ROADMAP_STEP["step_batching"]
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

        while not self._stop.is_set():
            try:
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

    def _execute(self, key: BatchKey, batch: List[Request]) -> None:
        dispatch_ts = self.clock()
        base_key = self._exec_key_for(key.height, key.width, key.steps,
                                      key.cfg)
        batch_span = None
        if self.tracer is not None:
            targs = {"bucket": f"{key.height}x{key.width}",
                     "n": len(batch), "key": base_key.short(),
                     "traces": [r.trace.trace_id for r in batch
                                if r.trace is not None]}
            batch_span = self.tracer.begin(
                "batch", track="scheduler", t=dispatch_ts, args=targs)
            for req in batch:
                self._trace_dequeue(req, batch_span, len(batch))
        if not self.resilience.allow(base_key):
            self._shed(base_key, batch)
            if self.tracer is not None:
                self.tracer.end(batch_span, args={"outcome": "shed"})
            return
        # inflight gauge: dispatched-but-unresolved requests
        self._inflight_c.inc("requests", len(batch))
        try:
            self._execute_resilient(key, base_key, batch, dispatch_ts)
        finally:
            # batch span first, THEN the inflight decrement: a client
            # observing inflight==0 knows the scheduler has made its
            # last tracer/clock call for this batch
            if self.tracer is not None:
                self.tracer.end(batch_span)
            self._inflight_c.inc("requests", -len(batch))

    # -- resilient dispatch ------------------------------------------------

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
        except WatchdogTimeoutError:
            self.counters.inc("watchdog_timeouts")
            raise
        except ServeError:
            raise
        except Exception as exc:
            if is_oom(exc):
                # the failed call's frames (and the device memory their
                # tensors hold) are reachable through this traceback, and
                # the chained error outlives the ladder's rebuild: keep
                # the exception and its text, drop the frames
                exc.__traceback__ = None
                raise ResourceExhaustedError(
                    f"batched execute OOM for {ekey.short()} at batch "
                    f"{len(batch)}: {exc}"
                ) from exc
            raise ExecuteFailedError(
                f"batched execute failed for {ekey.short()}: "
                f"{type(exc).__name__}: {exc}"
            ) from exc
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

    def _execute_resilient(self, key: BatchKey, base_key: ExecKey,
                           batch: List[Request], dispatch_ts: float) -> None:
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
                                                dispatch_ts)
                        self._execute_resilient(key, base_key, batch[mid:],
                                                dispatch_ts)
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
            )
            return

    def _complete_batch(self, key: BatchKey, ekey: ExecKey,
                        batch: List[Request], outputs, dispatch_ts: float,
                        t0: float, t1: float, hit: bool, *, retries: int,
                        degradations: tuple, shallow_steps: int) -> None:
        """Per-request success bookkeeping: counters, latency histograms,
        and future resolution."""
        self.counters.inc("batches")
        ekey_short = ekey.short()
        self.counters.inc("requests_compile_hit" if hit
                          else "requests_compile_miss", len(batch))
        self._batch_sizes.inc(f"size_{len(batch)}")
        exec_s = t1 - t0
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
                replica=self.replica_name,
            ))

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
        """The interface the JAX package's closed-loop SLO controller
        reads: current queue depth, dispatched-but-unresolved request
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
        return snap

    def metrics_prometheus(self) -> str:
        """The unified registry in Prometheus text exposition format —
        what the ``--metrics_port`` endpoint serves at ``/metrics``."""
        return self.registry.to_prometheus()

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
        return {
            "status": "degraded" if degraded else "ok",
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
            # the subsystems of later steps of ROADMAP item 16: staging,
            # step batching and tenancy (None on these servers, as on a
            # JAX server with them off)
            "staging": None,
            "step_batching": None,
            "tenancy": None,
            # the tracing + SLO plane (docs/OBSERVABILITY.md): trace ring
            # stats (None when tracing is off) and the rolling-window SLO
            # signals the closed-loop controller reads
            "observability": {
                "trace": (self.tracer.stats()
                          if self.tracer is not None else None),
                "slo": self.slo_snapshot(),
            },
            # the SLO controller and the prompt cache (later steps)
            "controller": None,
            "prompt_cache": None,
        }

    def export_metrics(self, path: str) -> Dict[str, Any]:
        snap = self.metrics_snapshot()
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, sort_keys=True)
            f.write("\n")
        return snap
