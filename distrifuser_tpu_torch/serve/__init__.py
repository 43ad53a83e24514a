"""distrifuser_tpu_torch.serve -- the long-lived inference service.

The JAX package's serve plane (ROADMAP item 16, steps 16a-16f), on one
card or over n ranks, with its module and public names:

* `RequestQueue` -- bounded admission with deadlines (serve/queue.py);
* `MicroBatcher` + `BucketTable` -- continuous micro-batching with shape
  bucketing (serve/batcher.py);
* `ExecutorCache` -- LRU cache of prepared executors with startup warmup
  (serve/cache.py);
* `InferenceServer` -- the scheduler thread tying them together, with
  per-request lifecycle metrics and a `health()` snapshot
  (serve/server.py);
* resilience layer -- typed errors (serve/errors.py; a real
  ``torch.cuda.OutOfMemoryError`` is an OOM), retry/backoff + per-key
  circuit breakers + execution watchdog + the graceful-degradation ladder
  (serve/resilience.py), and deterministic fault injection
  (serve/faults.py) so all of it is testable on the CPU;
* `StagePipeline` / `StagedBatch` -- encode, denoise and decode
  overlapped across micro-batches (serve/staging.py), with `PromptCache`
  in front of the text encode (serve/promptcache.py);
* `StepBatcher` / `SlotState` -- step-level continuous batching: requests
  join, leave, park and pack between denoise steps (serve/stepbatch.py),
  and their carries migrate between servers (serve/migration.py);
* `SLOController` -- load-driven tier selection over the quality/cost
  lattice (`DEFAULT_TIERS`, `apply_tier`) with admission control past the
  last tier (serve/controller.py);
* `Gateway` + `TenancyPolicy` -- the streaming HTTP/SSE front end
  (serve/gateway.py: ``POST /v1/generate``, SSE progress and previews,
  cancel; images on the wire by `encode_image` / `decode_image`) over
  per-tenant token-bucket quotas (`TokenBucket`) and weighted
  deficit-round-robin in the queue (serve/tenancy.py);
* `Replica` + `FleetRouter` -- lifecycle-managed replicas (starting,
  warming, serving, draining, stopped) behind a health-scored router
  with failover, carry migration, auto-drain, half-open probes and
  auto-restart (serve/replica.py, serve/fleet.py, `build_fleet`), and the
  elastic pool of serve/autoscale.py (`Autoscaler`, `fleet_pressure`);
* `PipelineExecutor` -- adapter from the port's pipelines
  (serve/executors.py); `serve.testing` has the weightless fakes;
* `serve_over_ranks` -- serving a pipeline over n ranks: rank 0's
  `InferenceServer` drives every other rank's executors over a control
  channel of its own (serve/ranks.py: `RankLeader`, `RankFollower`,
  `RankedExecutor`, `RankFailedError`).

``python -m distrifuser_tpu_torch.serve --demo`` runs a CPU-only
end-to-end demonstration (serve/__main__.py; ``--gateway-port`` runs it
through the gateway).  The AOT store comes with a later step of ROADMAP
item 16 (16g), and a fleet of replicas that span ranks with another
(16h); `InferenceServer` and `Replica` refuse them until then.
"""

from ..utils.config import (
    DEFAULT_BUCKETS,
    AutoscaleConfig,
    ControllerConfig,
    FleetConfig,
    GatewayConfig,
    ObservabilityConfig,
    ResilienceConfig,
    ServeConfig,
    StepBatchConfig,
    TenantConfig,
)
from ..utils.metrics import MetricsRegistry
from ..utils.trace import StepTimeline, Tracer
from .autoscale import Autoscaler, fleet_pressure
from .batcher import BatchKey, BucketTable, MicroBatcher
from .cache import ExecKey, ExecutorCache
from .controller import (
    ADMISSION,
    DEFAULT_TIERS,
    SLOController,
    TierSpec,
    apply_tier,
)
from .errors import (
    AdmissionRejectedError,
    BuildFailedError,
    CarryExportedError,
    CircuitOpenError,
    DeadlineExceededError,
    ExecuteFailedError,
    FatalError,
    LifecycleError,
    MigrationRejectedError,
    NoBucketError,
    NoHealthyReplicaError,
    QueueFullError,
    ResourceExhaustedError,
    RetryableError,
    ServeError,
    ServerClosedError,
    TenantQuotaError,
    WatchdogTimeoutError,
    is_oom,
)
from .faults import FaultPlan, FaultRule, install_fault_plan
from .fleet import FleetRouter, build_fleet, routing_weight
from .gateway import Gateway, decode_image, encode_image, sse_format
from .httpbase import HTTPServerHost
from .migration import (
    CarrySnapshot,
    check_identity,
    check_key_compatible,
    decode_snapshot,
    encode_snapshot,
)
from .promptcache import PromptCache
from .queue import Request, RequestQueue, ServeResult
from .ranks import (
    RankedExecutor,
    RankFailedError,
    RankFollower,
    RankLeader,
    current_command,
    serve_over_ranks,
)
from .replica import (
    REPLICA_DRAINING,
    REPLICA_SERVING,
    REPLICA_STARTING,
    REPLICA_STATES,
    REPLICA_STOPPED,
    REPLICA_WARMING,
    Replica,
)
from .resilience import (
    BackoffPolicy,
    CircuitBreaker,
    DegradationLadder,
    ResilienceEngine,
    RetryBudget,
    Watchdog,
)
from .server import InferenceServer
from .staging import StagedBatch, StagePipeline
from .stepbatch import SlotState, StepBatcher
from .tenancy import TenancyPolicy, TokenBucket


def __getattr__(name):
    # Lazy: executors.py adapts the pipelines; keep `import
    # distrifuser_tpu_torch.serve` light for fake-only callers (tests, demo).
    if name in ("PipelineExecutor", "pipeline_executor_factory", "apply_key_policy"):
        from . import executors

        return getattr(executors, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ADMISSION",
    "AdmissionRejectedError",
    "AutoscaleConfig",
    "Autoscaler",
    "BackoffPolicy",
    "BatchKey",
    "BucketTable",
    "BuildFailedError",
    "CarryExportedError",
    "CarrySnapshot",
    "CircuitBreaker",
    "CircuitOpenError",
    "ControllerConfig",
    "DEFAULT_BUCKETS",
    "DEFAULT_TIERS",
    "DeadlineExceededError",
    "DegradationLadder",
    "ExecKey",
    "ExecuteFailedError",
    "ExecutorCache",
    "FatalError",
    "FaultPlan",
    "FaultRule",
    "FleetConfig",
    "FleetRouter",
    "Gateway",
    "GatewayConfig",
    "HTTPServerHost",
    "InferenceServer",
    "LifecycleError",
    "MetricsRegistry",
    "MicroBatcher",
    "MigrationRejectedError",
    "NoBucketError",
    "NoHealthyReplicaError",
    "ObservabilityConfig",
    "PipelineExecutor",
    "PromptCache",
    "QueueFullError",
    "RankFailedError",
    "RankFollower",
    "RankLeader",
    "RankedExecutor",
    "REPLICA_DRAINING",
    "REPLICA_SERVING",
    "REPLICA_STARTING",
    "REPLICA_STATES",
    "REPLICA_STOPPED",
    "REPLICA_WARMING",
    "Replica",
    "Request",
    "RequestQueue",
    "ResilienceConfig",
    "ResilienceEngine",
    "ResourceExhaustedError",
    "RetryBudget",
    "RetryableError",
    "SLOController",
    "ServeConfig",
    "ServeError",
    "ServeResult",
    "ServerClosedError",
    "SlotState",
    "StagePipeline",
    "StagedBatch",
    "StepBatchConfig",
    "StepBatcher",
    "StepTimeline",
    "TenancyPolicy",
    "TenantConfig",
    "TenantQuotaError",
    "TierSpec",
    "TokenBucket",
    "Tracer",
    "Watchdog",
    "WatchdogTimeoutError",
    "apply_key_policy",
    "apply_tier",
    "build_fleet",
    "check_identity",
    "check_key_compatible",
    "current_command",
    "decode_image",
    "decode_snapshot",
    "encode_image",
    "encode_snapshot",
    "fleet_pressure",
    "install_fault_plan",
    "is_oom",
    "pipeline_executor_factory",
    "routing_weight",
    "serve_over_ranks",
    "sse_format",
]
