"""distrifuser_tpu_torch.serve -- the long-lived inference service on one card.

The whole-batch path of the JAX package's serve plane (ROADMAP item 16,
step 16a), with its module and public names:

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
* `PipelineExecutor` -- adapter from the port's pipelines
  (serve/executors.py); `serve.testing` has the weightless fakes.

``python -m distrifuser_tpu_torch.serve --demo`` runs a CPU-only
end-to-end demonstration (serve/__main__.py).  Staging and the prompt
cache, step batching, the SLO controller, tenancy and the gateway, the
fleet, carry migration and the AOT store come with later steps of
ROADMAP item 16; `InferenceServer` refuses their settings until then.
"""

from ..utils.config import (
    DEFAULT_BUCKETS,
    ControllerConfig,
    GatewayConfig,
    ObservabilityConfig,
    ResilienceConfig,
    ServeConfig,
    StepBatchConfig,
    TenantConfig,
)
from ..utils.metrics import MetricsRegistry
from ..utils.trace import Tracer
from .batcher import BatchKey, BucketTable, MicroBatcher
from .cache import ExecKey, ExecutorCache
from .errors import (
    AdmissionRejectedError,
    BuildFailedError,
    CarryExportedError,
    CircuitOpenError,
    DeadlineExceededError,
    ExecuteFailedError,
    FatalError,
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
from .httpbase import HTTPServerHost
from .queue import Request, RequestQueue, ServeResult
from .resilience import (
    BackoffPolicy,
    CircuitBreaker,
    DegradationLadder,
    ResilienceEngine,
    RetryBudget,
    Watchdog,
)
from .server import InferenceServer


def __getattr__(name):
    # Lazy: executors.py adapts the pipelines; keep `import
    # distrifuser_tpu_torch.serve` light for fake-only callers (tests, demo).
    if name in ("PipelineExecutor", "pipeline_executor_factory", "apply_key_policy"):
        from . import executors

        return getattr(executors, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AdmissionRejectedError",
    "BackoffPolicy",
    "BatchKey",
    "BucketTable",
    "BuildFailedError",
    "CarryExportedError",
    "CircuitBreaker",
    "CircuitOpenError",
    "ControllerConfig",
    "DEFAULT_BUCKETS",
    "DeadlineExceededError",
    "DegradationLadder",
    "ExecKey",
    "ExecuteFailedError",
    "ExecutorCache",
    "FatalError",
    "FaultPlan",
    "FaultRule",
    "GatewayConfig",
    "HTTPServerHost",
    "InferenceServer",
    "MetricsRegistry",
    "MicroBatcher",
    "MigrationRejectedError",
    "NoBucketError",
    "NoHealthyReplicaError",
    "ObservabilityConfig",
    "PipelineExecutor",
    "QueueFullError",
    "Request",
    "RequestQueue",
    "ResilienceConfig",
    "ResilienceEngine",
    "ResourceExhaustedError",
    "RetryBudget",
    "RetryableError",
    "ServeConfig",
    "ServeError",
    "ServeResult",
    "ServerClosedError",
    "StepBatchConfig",
    "TenantConfig",
    "TenantQuotaError",
    "Tracer",
    "Watchdog",
    "WatchdogTimeoutError",
    "apply_key_policy",
    "install_fault_plan",
    "is_oom",
    "pipeline_executor_factory",
]
