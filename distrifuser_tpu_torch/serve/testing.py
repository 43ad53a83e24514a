"""Deterministic weightless fakes for the serve layer.

Everything the scheduler does -- admission, bucketing, coalescing,
deadlines, cache hits/evictions, metrics -- is independent of what the
executor computes, so tests and the ``--demo`` entry point drive the real
scheduler with these fakes: no weights, no devices, milliseconds per
"generation", and outputs that are a pure function of (prompt, seed,
bucket, steps) so any reordering or cross-request mixup is detectable.
The images are byte for byte the JAX package's fakes' (numpy's
``RandomState`` seeded by a crc32), so the two packages' servers can be
compared result for result.
"""

from __future__ import annotations

import time
import zlib
from typing import Any, List

import numpy as np

from ..utils import sync
from .cache import ExecKey


def fake_image(prompt: str, seed: int, key: ExecKey) -> np.ndarray:
    """Deterministic tiny "image" for (prompt, seed, bucket, steps): an
    8x8x3 float array seeded from a crc32 of the identifying tuple."""
    h = zlib.crc32(
        f"{prompt}|{seed}|{key.height}x{key.width}|{key.steps}|{key.cfg}"
        .encode()
    )
    rng = np.random.RandomState(h % (2**31))
    return rng.rand(8, 8, 3).astype(np.float32)


class FakeExecutor:
    """Serve-executor fake: optional simulated step time, call log.

    ``batch_sizes`` records the *real* (unpadded) size of every invocation
    — what tests assert coalescing against.

    The simulated service time honors the key's quality/cost knobs
    (`effective_service_s`) so controller-driven tiers are measurably
    cheaper on fakes, with the knob-free key costing EXACTLY
    ``step_time_s * steps`` as before: shallow cadence steps cost a 0.35
    FLOP fraction (the JAX package's measured ratio), wire compression and PCPP
    partial refresh model a comm-bound mesh with multiplicative discounts.
    Deterministic — the SLO-bench goodput numbers reproduce.
    """

    # cost-model constants, shared with the docs' tier-table discussion
    SHALLOW_FRACTION = 0.35
    COMPRESS_DISCOUNT = 0.85

    def __init__(self, key: ExecKey, batch_size: int = 8,
                 step_time_s: float = 0.0):
        self.key = key
        self.batch_size = batch_size
        self.step_time_s = step_time_s
        self.batch_sizes: List[int] = []
        # mirror PipelineExecutor's shallow-step accounting from the key's
        # cadence so fake-backed servers exercise the share metrics too
        from ..parallel.stepcache import shallow_step_count

        self.shallow_steps = shallow_step_count(
            key.steps, warmup_steps=0, interval=key.step_cache_interval
        )

    def effective_service_s(self) -> float:
        """Key-aware simulated batch service time (see class docstring)."""
        key = self.key
        full = key.steps - self.shallow_steps
        eff = full + self.SHALLOW_FRACTION * self.shallow_steps
        m = 1.0
        if key.comm_compress != "none":
            m *= self.COMPRESS_DISCOUNT
        if key.refresh_fraction < 1.0:
            # refresh bytes scale with the fraction; comm is a ~40% share
            # of the modeled stale step, so half the refresh ≈ 0.8x
            m *= 0.6 + 0.4 * key.refresh_fraction
        return self.step_time_s * eff * m

    def __call__(self, prompts: List[str], negative_prompts: List[str],
                 guidance_scale: float, seeds: List[int]) -> List[Any]:
        assert len(prompts) == len(negative_prompts) == len(seeds)
        self.batch_sizes.append(len(prompts))
        if self.step_time_s:
            # batched invocation costs one pass regardless of batch size —
            # the whole point of coalescing
            time.sleep(self.effective_service_s())
        return [fake_image(p, s, self.key) for p, s in zip(prompts, seeds)]


class FakeExecutorFactory:
    """Counts builds and keeps every built executor inspectable.

    ``build_delay_s`` simulates the cost a cache miss pays (the pipeline
    build and graph capture), so load-generator runs show the warm/cold
    latency split without a card.
    """

    def __init__(self, batch_size: int = 8, build_delay_s: float = 0.0,
                 step_time_s: float = 0.0):
        self.batch_size = batch_size
        self.build_delay_s = build_delay_s
        self.step_time_s = step_time_s
        self.built: List[ExecKey] = []
        self.executors: List[FakeExecutor] = []

    def _new_executor(self, key: ExecKey) -> FakeExecutor:
        """Construction hook: subclasses override THIS (not __call__) so
        the build-delay simulation and built/executors bookkeeping live
        in exactly one place."""
        return FakeExecutor(key, batch_size=self.batch_size,
                            step_time_s=self.step_time_s)

    def __call__(self, key: ExecKey) -> FakeExecutor:
        if self.build_delay_s:
            time.sleep(self.build_delay_s)
        self.built.append(key)
        ex = self._new_executor(key)
        self.executors.append(ex)
        return ex

    def batch_sizes(self) -> List[int]:
        """Every invocation's real batch size, across all executors."""
        return [n for ex in self.executors for n in ex.batch_sizes]


class ExecutionLedger:
    """Fleet-wide completed-execution counter keyed by (prompt, seed).

    The fleet failover invariant — a request is re-dispatched only after
    its prior replica's outcome is terminal, so a dispatch that failed
    before completing never runs twice — is asserted by sharing one
    ledger across every replica's `LedgerFakeExecutorFactory`: each
    successful executor return records its requests, and
    ``max_count() <= 1`` proves no double execution (a dispatch
    killed/failed before returning never records).  Caveat: a
    watchdog-ABANDONED dispatch (``hang`` faults) may still finish in
    the background and record — its result is discarded by the watchdog,
    but the ledger honestly counts the physical execution, so assert
    ``max_count() == 1`` only under fault kinds that fail before
    completion (kill / errors / oom).  Thread-safe: replicas execute
    concurrently."""

    def __init__(self):

        self._lock = sync.Lock()
        self._counts: dict = {}

    def record(self, prompt: str, seed: int, replica: str = "") -> None:
        with self._lock:
            key = (prompt, int(seed))
            entry = self._counts.setdefault(key, [])
            entry.append(replica)

    def count(self, prompt: str, seed: int) -> int:
        with self._lock:
            return len(self._counts.get((prompt, int(seed)), []))

    def max_count(self) -> int:
        with self._lock:
            return max((len(v) for v in self._counts.values()), default=0)

    def snapshot(self) -> dict:
        """{(prompt, seed): [replica, ...]} of completed executions."""
        with self._lock:
            return {k: list(v) for k, v in self._counts.items()}


class LedgerFakeExecutor(FakeExecutor):
    """`FakeExecutor` recording every COMPLETED execution in a shared
    `ExecutionLedger` (faults injected before/at the call never record —
    exactly the semantics of work that died before producing output)."""

    def __init__(self, key: ExecKey, ledger: ExecutionLedger,
                 replica: str = "", batch_size: int = 8,
                 step_time_s: float = 0.0):
        super().__init__(key, batch_size=batch_size, step_time_s=step_time_s)
        self.ledger = ledger
        self.replica = replica

    def __call__(self, prompts: List[str], negative_prompts: List[str],
                 guidance_scale: float, seeds: List[int]) -> List[Any]:
        out = super().__call__(prompts, negative_prompts, guidance_scale,
                               seeds)
        for p, s in zip(prompts, seeds):
            self.ledger.record(p, s, self.replica)
        return out


class LedgerFakeExecutorFactory(FakeExecutorFactory):
    """Per-replica factory building `LedgerFakeExecutor`s against one
    shared ledger; ``replica`` tags which replica executed what."""

    def __init__(self, ledger: ExecutionLedger, replica: str = "",
                 batch_size: int = 8, build_delay_s: float = 0.0,
                 step_time_s: float = 0.0):
        super().__init__(batch_size=batch_size, build_delay_s=build_delay_s,
                         step_time_s=step_time_s)
        self.ledger = ledger
        self.replica = replica

    def _new_executor(self, key: ExecKey) -> LedgerFakeExecutor:
        return LedgerFakeExecutor(key, self.ledger, replica=self.replica,
                                  batch_size=self.batch_size,
                                  step_time_s=self.step_time_s)
