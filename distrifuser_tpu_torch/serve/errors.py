"""Typed error hierarchy for the serve layer.

Every failure a request can see is a `ServeError` subclass, split by the
ONE property callers and the retry policy need without string matching:
is the request itself doomed, or could the same request succeed later /
elsewhere / degraded?

* `RetryableError` — transient or capacity-shaped: the request as posed is
  fine, the attempt failed.  HTTP analogs: 429 (`QueueFullError`), 503
  (`CircuitOpenError`), 504 (`WatchdogTimeoutError`).  Upstream load
  balancers should retry against another replica or after backoff; the
  in-server retry policy (serve/resilience.py) retries build/execute
  flavors itself before surfacing them.
* `FatalError` — the request can never succeed as posed: it expired, the
  server is gone, or no bucket covers it.  Retrying verbatim is wasted
  work.

`ResourceExhaustedError` subclasses `ExecuteFailedError` because an OOM
*is* a failed execution — but it is also the trigger for the graceful-
degradation ladder (batch split, step-cache off, stepwise fallback,
smaller bucket), so it keeps its own type.  `is_oom` recognizes the typed
error, PyTorch's ``torch.cuda.OutOfMemoryError`` (and a ``RuntimeError``
whose message says ``CUDA out of memory``, as older releases raise it), and
the injected fault's RESOURCE_EXHAUSTED-shaped message
(serve/faults.py).

Definitions live here (a leaf module, importable from anywhere in the
package without cycles); `serve/queue.py` and `serve/batcher.py`
re-export their historical names so existing imports keep working.  The
errors keep the JAX package's names and places in the hierarchy, so that
callers can catch them alike: admission control (`AdmissionRejectedError`),
tenant quotas (`TenantQuotaError`), the fleet (`NoHealthyReplicaError`,
`LifecycleError`), carry export (`CarryExportedError`) and a rejected
import (`MigrationRejectedError`).  The AOT store's rejection comes with
the store.
"""

from __future__ import annotations

import torch


class ServeError(RuntimeError):
    """Base class for serve-layer rejections and failures."""


class RetryableError(ServeError):
    """Transient: the same request may succeed on retry (here or on
    another replica).  The in-server retry policy only ever retries
    these."""


class FatalError(ServeError):
    """Terminal for this request: retrying it verbatim cannot succeed."""


# -- retryable ---------------------------------------------------------------


class QueueFullError(RetryableError):
    """Admission rejected: queue at max depth (HTTP-429 analog)."""


class CircuitOpenError(RetryableError):
    """Shed fast: this request's compiled-executor key has tripped its
    circuit breaker (HTTP-503 analog).  Retry after the cooldown, or
    against a replica whose breaker for the key is closed."""


class AdmissionRejectedError(RetryableError):
    """The closed-loop SLO controller (serve/controller.py) rejected the
    request at admission: under the current load, even the cheapest tier
    of the quality/cost ladder cannot hold this SLO class's p99 target —
    executing the request would blow its own SLO *and* everyone else's
    queue.  HTTP-429 analog, like `QueueFullError`, but driven by
    predicted latency rather than queue depth; retry against another
    replica or after the load subsides."""


class TenantQuotaError(RetryableError):
    """The tenant-aware fair queue (serve/tenancy.py) rejected the
    request at admission: the submitting tenant's token bucket is empty
    (its configured ``rate_rps``/``burst`` quota is exhausted) or the
    tenant is unknown to the configured tenant table.  HTTP-429 analog,
    like `QueueFullError`, but scoped to ONE tenant — other tenants'
    requests still admit, which is the point of per-tenant quotas.
    Retry after the bucket refills (``1/rate_rps`` seconds buys one
    token)."""


class NoHealthyReplicaError(RetryableError):
    """The fleet router (serve/fleet.py) found no replica able to admit
    this request right now: every replica is draining, stopped, faulted,
    or rejecting at its own admission boundary.  HTTP-503 analog, like
    `CircuitOpenError` but fleet-scoped; retry after backoff — a probe or
    restart may return capacity."""


class WatchdogTimeoutError(RetryableError):
    """Batch execution exceeded the watchdog wall-time bound; the batch
    was abandoned (HTTP-504 analog).  The mesh work may still be running
    on the abandoned worker thread — its result is discarded."""


class BuildFailedError(RetryableError):
    """Executor construction (pipeline build + ahead-of-time compile)
    failed.  Retryable because the degradation ladder may succeed with a
    cheaper program (step-cache off, stepwise loop, smaller bucket)."""


class DegradationInapplicableError(ValueError):
    """A key's degradation-relevant field cannot be forced onto the built
    pipeline — deterministically, for every rebuild (e.g. the
    ``weight_quant_on`` rung against a tensor/pipefusion build function whose
    pre-sharded kernels can never quantize, or ``stepwise_fallback``
    against PipeFusion).  Raised by `executors.apply_key_policy`;
    the server's retry loop RETRACTS the named rung for that key (it is
    pinned inapplicable, never re-picked) instead of retrying a build
    that can only fail the same way.  A ValueError, not a ServeError:
    direct `apply_key_policy` callers keep seeing the exception class the
    underlying pipeline hooks always raised."""

    def __init__(self, message: str, rung: str):
        super().__init__(message)
        self.rung = rung


class ExecuteFailedError(RetryableError):
    """The batched mesh dispatch raised.  The original exception rides
    ``__cause__``."""


class MigrationRejectedError(RetryableError):
    """A carry snapshot (serve/migration.py) failed validation at import:
    truncated or checksum-corrupt envelope, format-version skew, ExecKey
    or executor-family incompatibility, or identity mismatch against the
    re-dispatched request.  Retryable because the REQUEST is fine — only
    the salvage attempt failed: the fleet strips the snapshot and falls
    back to the pre-migration from-step-0 retry path, never resuming
    from bytes it cannot prove intact."""


class ResourceExhaustedError(ExecuteFailedError):
    """OOM-shaped failure (``torch.cuda.OutOfMemoryError`` or injected):
    the trigger for the graceful-degradation ladder."""


class LifecycleError(FatalError):
    """An operator-API call violated a lifecycle state machine: starting
    an already-started fleet, restarting a replica from a state with no
    such transition, an illegal replica state-machine edge.  Fatal for
    the *call* (retrying the same transition verbatim cannot succeed),
    and still a RuntimeError via ServeError, so operator code catching
    RuntimeError keeps working."""


class ExecutorContractError(RuntimeError):
    """An executor broke its batching contract (e.g. returned N outputs
    for a batch of M).  Deliberately NOT a ServeError: the typed
    retry/breaker routing must not see it — a contract violation is a
    bug, not a transient fault, so it bubbles past the retry loop to the
    scheduler-loop guard, which fails the batch and counts a
    scheduler_error.  The name (rather than a bare RuntimeError) keeps
    the escape auditable: distrilint's typed-raises checker flags bare
    generic raises in serve/*."""


# -- fatal -------------------------------------------------------------------


class DeadlineExceededError(FatalError):
    """Request expired while waiting for a batch slot; it was NOT executed."""


class ServerClosedError(FatalError):
    """Submitted to (or still queued in) a server that has been stopped."""


class CarryExportedError(ServerClosedError):
    """Terminal FOR THIS REPLICA: the stopping/draining server exported
    the request's mid-denoise carry instead of finishing it.  ``snapshot``
    carries the encoded bytes (serve/migration.py) when export succeeded,
    None when only the progress accounting survived; ``steps_done`` is
    how many denoise steps the carry had completed.  A `ServerClosedError`
    subclass on purpose: the fleet router already treats that class as
    NOT request-fatal, so the existing failover path fires — it just
    re-dispatches the snapshot (resume at ``steps_done``) instead of the
    request from step 0."""

    def __init__(self, message: str, *, snapshot: "bytes | None" = None,
                 steps_done: int = 0):
        super().__init__(message)
        self.snapshot = snapshot
        self.steps_done = int(steps_done)


class NoBucketError(FatalError):
    """Requested resolution exceeds every configured bucket."""


def is_oom(exc: BaseException) -> bool:
    """OOM detector spanning the typed error, the caching allocator's
    ``torch.cuda.OutOfMemoryError`` (older PyTorch raised a plain
    ``RuntimeError`` saying ``CUDA out of memory``) and injected faults
    (``RESOURCE_EXHAUSTED: ...``, serve/faults.py), and another rank's OOM
    as rank 0 raises it over n ranks (``oom`` set: serve/ranks.py
    `RankFailedError`)."""
    if isinstance(exc, (ResourceExhaustedError, torch.cuda.OutOfMemoryError)):
        return True
    if getattr(exc, "oom", False) is True:
        return True
    msg = str(exc)
    return "CUDA out of memory" in msg or "RESOURCE_EXHAUSTED" in msg
