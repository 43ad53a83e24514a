"""Staged serving pipeline: overlap text-encode, denoise, and VAE-decode
across micro-batches.

Counterpart of distrifuser_tpu/serve/staging.py (``StagedBatch``,
``StagePipeline``), the same protocol line for line.  The monolithic
dispatch runs text-encode, the N-step denoise, VAE decode, and the
device->host copy serially on one thread, so the denoiser idles through
every encode, decode, and transfer.  Here three stage workers connected by
hand-off queues form a software pipeline over coalesced batches:

    encode worker  : tokenize + text-encode + draw the seeded latents
    denoise worker : the prepared denoise loop (graph replays on the card)
    decode worker  : chunked VAE decode + host conversion + future
                     resolution

While batch k denoises, batch k+1 encodes and batch k-1 decodes -- the
steady-state throughput ceiling moves from 1/sum(stage times) to
1/max(stage times), with the denoise stage the bottleneck resource by
construction.  On the card each stage issues its work on a CUDA stream of
its own and synchronises that stream before it hands the batch on
(serve/executors.py), so a stage's service time is device work, and the
consumer never reads a tensor its producer is still writing.

Invariants:

* **Memory cap** -- at most ``max_inflight_batches`` batches hold device
  buffers at once, enforced by a semaphore acquired at submission and
  released when the batch leaves the pipeline by ANY path (success,
  failure, cancel, stop).  Submission blocks the scheduler thread while
  the pipeline is full -- backpressure that deepens the request queue and
  widens the next coalesced batch rather than growing residency.
* **Stage isolation** -- each stage invocation runs under its own
  watchdog (`ResilienceConfig.watchdog_timeout_s`); a hung stage fails
  its batch, never the workers.  Executors are *pinned* in the
  `ExecutorCache` for the batch's whole trip, so LRU eviction or
  `invalidate` can never free a pipeline a stage worker is about to run;
  a batch whose stage the watchdog abandoned unpins only once that stage
  has finished (`_release(after=...)`).
* **One terminal failure** -- a failure in any stage fails the whole
  batch once (typed, serve/errors.py) and surfaces to the scheduler
  thread through `drain_outcomes()` as ONE terminal dispatch failure for
  the circuit breaker; there is no intra-stage retry loop (the
  resilience layer's sticky degradations -- including forcing staging off
  via the ``staging_off`` rung -- handle repeat offenders).
* **Cancel/deadline propagation** -- a batch whose every future was
  cancelled is dropped at the next stage boundary; a batch whose every
  request deadline lapsed before its denoise stage begins is failed with
  `DeadlineExceededError` instead of burning card time (deadlines gate
  scheduling -- and the denoise dispatch is a scheduling point -- but
  never abandon device work already started).
* **Deterministic stop** -- `stop()` drains every stage queue: batches
  not yet through decode fail with `ServerClosedError`, the stage
  invocation in progress is allowed to finish (bounded by its watchdog),
  and every submitted future is resolved before `stop()` returns.

Observability: per-stage queue-wait and service-time histograms plus the
**denoise-gap fraction** (`utils.metrics.GapTracker`) -- the share of the
denoise stage's busy envelope the denoiser sat idle, i.e. the latency the
overlap failed to hide.  The overlap is measured, not asserted.
"""

from __future__ import annotations

import queue as queue_mod
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..utils import sync
from ..utils.metrics import Counter, GapTracker, LatencyHistogram
from .cache import ExecKey
from .errors import (
    DeadlineExceededError,
    ExecuteFailedError,
    ResourceExhaustedError,
    ServeError,
    ServerClosedError,
    WatchdogTimeoutError,
    is_oom,
)
from .resilience import Watchdog

STAGES = ("encode", "denoise", "decode")

_SENTINEL = object()


class StagedBatch:
    """One coalesced batch's trip through the stage pipeline: the requests
    and their executor (pinned in the cache for the whole trip), plus the
    in-flight product handed from stage to stage."""

    __slots__ = ("batch_key", "base_key", "ekey", "requests",
                 "guidance_scale", "executor", "compile_hit", "dispatch_ts",
                 "started_ts", "stage_ready_ts", "work", "tier")

    def __init__(self, *, batch_key, base_key: ExecKey, ekey: ExecKey,
                 requests, executor, compile_hit: bool, dispatch_ts: float,
                 tier: Optional[int] = None):
        self.batch_key = batch_key
        self.base_key = base_key
        self.ekey = ekey
        self.requests = list(requests)
        self.guidance_scale = batch_key.guidance_scale
        self.executor = executor
        self.compile_hit = compile_hit
        self.dispatch_ts = dispatch_ts
        self.started_ts: Optional[float] = None  # encode-stage entry
        self.stage_ready_ts = dispatch_ts  # when the next stage could start
        self.work: Any = None
        # the SLO-controller tier index the batch dispatches at (None
        # when the controller is off)
        self.tier = tier

    @property
    def prompts(self) -> List[str]:
        return [r.prompt for r in self.requests]

    @property
    def negative_prompts(self) -> List[str]:
        return [r.negative_prompt for r in self.requests]

    @property
    def seeds(self) -> List[int]:
        return [r.seed for r in self.requests]

    def cancelled(self) -> bool:
        return all(r.future.cancelled() for r in self.requests)

    def expired(self, now: float) -> bool:
        return all(r.expired(now) for r in self.requests)


class StagePipeline:
    """The three-stage worker pipeline (module docstring).

    Callbacks (all may run on stage-worker threads -- they must only touch
    thread-safe state; breaker/ladder bookkeeping instead rides the
    `drain_outcomes()` queue back to the scheduler thread):

    * ``on_success(sb, outputs, t_start, t_end)`` -- decode finished;
      resolve futures and record request metrics;
    * ``on_failure(sb, exc)`` -- the batch failed (stage error, watchdog,
      deadline, stop); fail futures and count by type;
    * ``on_release(sb)`` -- the batch left the pipeline by any path;
      unpin its executor.
    """

    def __init__(
        self,
        *,
        max_inflight: int = 2,
        watchdog_timeout_s: float = 0.0,
        clock: Callable[[], float] = time.monotonic,
        counters: Optional[Counter] = None,
        on_success: Optional[Callable[..., None]] = None,
        on_failure: Optional[Callable[..., None]] = None,
        on_release: Optional[Callable[..., None]] = None,
        fault_plan=None,
        registry=None,
        tracer=None,
    ):
        assert max_inflight >= 1, max_inflight
        self.max_inflight = max_inflight
        self.clock = clock
        self.counters = counters if counters is not None else Counter()
        # optional utils.trace.Tracer: each stage invocation lands as a
        # span on its stage's track ("stage/encode" etc.) tagged with the
        # member trace ids, so the Perfetto view shows the overlap -- the
        # measured form of "batch k+1 encodes under batch k's denoise"
        self.tracer = tracer
        # chaos composition: the server's "execute"-site faults fire at
        # the denoise stage (the staged analog of the monolithic
        # watchdog-bounded dispatch), so a chaos run against a staged
        # server exercises the staged failure machinery too
        self.fault_plan = fault_plan
        self.on_success = on_success
        self.on_failure = on_failure
        self.on_release = on_release
        self._slots = sync.Semaphore(max_inflight)
        self._stop = sync.Event()
        self._lock = sync.Lock()
        # serializes submit()'s stop-check-then-enqueue against stop()'s
        # flag-set: without it a submit racing stop() could enqueue AFTER
        # the worker consumed its sentinel and exited, orphaning the
        # batch's futures forever
        self._submit_lock = sync.Lock()
        self._inflight = 0
        self.peak_inflight = 0
        self.submitted = 0
        self.completed = 0
        self.failed = 0
        # metric primitives live in the unified MetricsRegistry when the
        # owning server passes one (hierarchical names + stage labels,
        # rendered by /metrics); standalone pipelines (direct tests) keep
        # private instances -- the objects and snapshots are identical
        if registry is not None:
            self.hist_wait = {
                s: registry.histogram("serve_stage_wait_seconds",
                                      labels={"stage": s})
                for s in STAGES
            }
            self.hist_service = {
                s: registry.histogram("serve_stage_service_seconds",
                                      labels={"stage": s})
                for s in STAGES
            }
            self.denoise_gap = registry.gap("serve_denoise_gap")
        else:
            self.hist_wait = {s: LatencyHistogram() for s in STAGES}
            self.hist_service = {s: LatencyHistogram() for s in STAGES}
            self.denoise_gap = GapTracker()
        self._queues = {s: sync.Queue() for s in STAGES}
        self._watchdogs = {s: Watchdog(watchdog_timeout_s) for s in STAGES}
        self._outcomes: "deque[Tuple[ExecKey, ExecKey, Optional[Exception]]]" = deque()
        self._threads = [
            sync.Thread(target=self._worker, args=(s,),
                             name=f"serve-stage-{s}", daemon=True)
            for s in STAGES
        ]
        for t in self._threads:
            t.start()

    # -- scheduler-thread surface ------------------------------------------

    def submit(self, sb: StagedBatch) -> bool:
        """Enter the pipeline, blocking while ``max_inflight`` batches are
        resident (the memory cap doubling as backpressure).  Returns False
        when the pipeline is stopping -- the caller fails the batch."""
        while not self._stop.is_set():
            if self._slots.acquire(timeout=0.05):
                with self._submit_lock:
                    if self._stop.is_set():
                        # stop() holds/held the submit lock when setting
                        # the flag, so a put that reaches the queue is
                        # always BEFORE the sentinel -- the worker aborts
                        # it deterministically before exiting
                        self._slots.release()
                        return False
                    with self._lock:
                        self._inflight += 1
                        self.peak_inflight = max(self.peak_inflight,
                                                 self._inflight)
                        self.submitted += 1
                    sb.stage_ready_ts = self.clock()
                    self._queues["encode"].put(sb)
                return True
        return False

    def drain_outcomes(self) -> List[Tuple[ExecKey, ExecKey, Optional[Exception]]]:
        """(base_key, executed ekey, exc-or-None) per finished batch, for
        the scheduler thread's breaker/ladder bookkeeping -- stage workers
        never mutate resilience state directly (the breaker's mutating
        methods are scheduler-thread-only by contract)."""
        out = []
        while True:
            try:
                out.append(self._outcomes.popleft())
            except IndexError:
                return out

    # -- internals ----------------------------------------------------------

    def _release(self, sb: StagedBatch, after=None) -> None:
        """Give back the batch's inflight slot now; run ``on_release``
        (the executor unpin) immediately, or -- when ``after`` is the done
        event of a watchdog-abandoned worker still executing this batch's
        stage -- only once that worker drains, so the unpin can never free
        a pipeline the abandoned thread is still running against."""
        with self._lock:
            self._inflight -= 1
        self._slots.release()
        if self.on_release is None:
            return
        if after is None:
            self.on_release(sb)
            return

        def waiter():
            after.wait()
            self.on_release(sb)

        sync.Thread(target=waiter, name="serve-stage-deferred-unpin",
                         daemon=True).start()

    def _fail(self, sb: StagedBatch, exc: Exception, *,
              record: bool = True, release_after=None) -> None:
        with self._lock:
            self.failed += 1
        if record:
            self._outcomes.append((sb.base_key, sb.ekey, exc))
        try:
            if self.on_failure is not None:
                self.on_failure(sb, exc)
        except Exception:  # noqa: BLE001 -- a callback bug must not kill
            # the stage worker (the pipeline would stall forever); loud
            # in counters + stderr, like the server's scheduler guard
            import traceback

            self.counters.inc("staged_callback_errors")
            traceback.print_exc()
        finally:
            self._release(sb, after=release_after)

    def _wrap(self, stage: str, sb: StagedBatch,
              exc: BaseException) -> Exception:
        if isinstance(exc, ServeError):
            return exc  # watchdog timeouts etc. arrive already typed
        if is_oom(exc):
            wrapped: Exception = ResourceExhaustedError(
                f"staged {stage} OOM for {sb.ekey.short()} at batch "
                f"{len(sb.requests)}: {exc}"
            )
        else:
            wrapped = ExecuteFailedError(
                f"staged {stage} failed for {sb.ekey.short()}: "
                f"{type(exc).__name__}: {exc}"
            )
        wrapped.__cause__ = exc
        return wrapped

    def _stage_call(self, stage: str, sb: StagedBatch) -> Any:
        ex = sb.executor
        if stage == "encode":
            return ex.encode_stage(sb.prompts, sb.negative_prompts, sb.seeds)
        if stage == "denoise":
            if self.fault_plan is not None:
                self.fault_plan.check("execute", key=sb.ekey,
                                      batch_size=len(sb.requests))
            return ex.denoise_stage(sb.work, sb.guidance_scale)
        return ex.decode_stage(sb.work)

    def _worker(self, stage: str) -> None:
        q = self._queues[stage]
        idx = STAGES.index(stage)
        nxt = STAGES[idx + 1] if idx + 1 < len(STAGES) else None
        wd = self._watchdogs[stage]
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            sb: StagedBatch = item
            now = self.clock()
            if self._stop.is_set():
                # stop() drains deterministically: work not yet through
                # decode fails; no breaker event (the service stopped, the
                # key did nothing wrong)
                self._fail(sb, ServerClosedError("server stopped"),
                           record=False)
                continue
            if sb.cancelled():
                # every rider gave up: drop at the stage boundary, spend
                # no further stage time on it
                self.counters.inc("staged_cancelled")
                self._release(sb)
                continue
            if stage == "denoise" and sb.expired(now):
                # every rider's deadline lapsed before device work began;
                # the denoise dispatch is a scheduling point, so this is
                # a rejection, not an abandonment
                self.counters.inc("staged_expired")
                self._fail(sb, DeadlineExceededError(
                    f"all {len(sb.requests)} requests expired before the "
                    "denoise stage"
                ), record=False)
                continue
            self.hist_wait[stage].observe(now - sb.stage_ready_ts)
            t0 = self.clock()
            if stage == "denoise":
                self.denoise_gap.begin(t0)
            prev_abandoned = wd.abandoned_event
            try:
                out = wd.run(lambda: self._stage_call(stage, sb))
            except Exception as exc:  # noqa: BLE001 -- typed + reported
                if stage == "denoise":
                    self.denoise_gap.end(self.clock())
                # a FRESH abandonment means the watchdog's orphaned thread
                # is still executing THIS batch's stage: its executor
                # unpin must wait for that thread (a stale abandonment
                # belongs to an earlier batch -- this one never started)
                abandoned = wd.abandoned_event
                fresh = (isinstance(exc, WatchdogTimeoutError)
                         and abandoned is not None
                         and abandoned is not prev_abandoned)
                if self.tracer is not None:
                    self.tracer.event(
                        f"{stage}_failed", track=f"stage/{stage}",
                        args={"key": sb.ekey.short(),
                              "error": type(exc).__name__})
                self._fail(sb, self._wrap(stage, sb, exc),
                           release_after=abandoned if fresh else None)
                continue
            t1 = self.clock()
            if stage == "denoise":
                self.denoise_gap.end(t1)
            self.hist_service[stage].observe(t1 - t0)
            if self.tracer is not None:
                self.tracer.complete(
                    stage, t0, t1, track=f"stage/{stage}",
                    args={"n": len(sb.requests), "key": sb.ekey.short(),
                          "traces": [r.trace.trace_id for r in sb.requests
                                     if r.trace is not None]},
                )
            if stage == "encode":
                sb.started_ts = t0
            if nxt is not None:
                sb.work = out
                sb.stage_ready_ts = t1
                self._queues[nxt].put(sb)
                continue
            # decode finished: resolve
            if len(out) != len(sb.requests):
                # executor contract violation -- terminal, typed like the
                # monolithic path's RuntimeError (feeds the breaker)
                self._fail(sb, RuntimeError(
                    f"staged executor returned {len(out)} outputs for a "
                    f"batch of {len(sb.requests)}"
                ))
                continue
            with self._lock:
                self.completed += 1
            self._outcomes.append((sb.base_key, sb.ekey, None))
            started = sb.started_ts if sb.started_ts is not None else t0
            try:
                if self.on_success is not None:
                    self.on_success(sb, out, started, t1)
            except Exception:  # noqa: BLE001 -- see _fail: worker survives
                import traceback

                self.counters.inc("staged_callback_errors")
                traceback.print_exc()
            finally:
                self._release(sb)

    # -- lifecycle -----------------------------------------------------------

    def stop(self, timeout: float = 10.0) -> None:
        """Deterministic drain (module docstring): every batch inside the
        pipeline resolves before return -- ``ServerClosedError`` for work
        that had not completed decode.  Joins stage-by-stage in pipeline
        order so an upstream worker can no longer feed a downstream queue
        after the downstream drain."""
        with self._submit_lock:
            # under the submit lock: every racing submit either enqueued
            # BEFORE this (its batch precedes the sentinel and is aborted
            # by the worker) or sees the flag and refuses
            self._stop.set()
        deadline = time.monotonic() + timeout
        for stage, t in zip(STAGES, self._threads):
            self._queues[stage].put(_SENTINEL)
            t.join(max(0.05, deadline - time.monotonic()))
            if t.is_alive():
                # a stage invocation is still running past its watchdog
                # bound: drain its queue here so no future is left pending,
                # and leave another sentinel for whenever it unsticks
                self.counters.inc("staged_stop_join_timeouts")
                while True:
                    try:
                        item = self._queues[stage].get_nowait()
                    except queue_mod.Empty:
                        break
                    if item is not _SENTINEL:
                        self._fail(item, ServerClosedError("server stopped"),
                                   record=False)
                self._queues[stage].put(_SENTINEL)

    # -- observability -------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-friendly staged-pipeline metrics (docs/SERVING.md schema):
        per-stage queue-wait/service histograms, the denoise-gap fraction,
        and residency accounting."""
        with self._lock:
            inflight = self._inflight
            peak = self.peak_inflight
            submitted = self.submitted
            completed = self.completed
            failed = self.failed
        return {
            "max_inflight_batches": self.max_inflight,
            "inflight": inflight,
            "peak_inflight": peak,
            "submitted": submitted,
            "completed": completed,
            "failed": failed,
            "stages": {
                s: {
                    "queue_wait": self.hist_wait[s].snapshot(),
                    "service": self.hist_service[s].snapshot(),
                }
                for s in STAGES
            },
            "denoise_gap": self.denoise_gap.snapshot(),
            "watchdog_timeouts": sum(w.timeouts
                                     for w in self._watchdogs.values()),
        }
