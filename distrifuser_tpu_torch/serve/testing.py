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
import torch

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


def fake_preview(prompt: str, seed: int, key: ExecKey,
                 step: int) -> np.ndarray:
    """Deterministic tiny preview for (prompt, seed, key, step): a 4x4x3
    float array — a pure function, so preview streams replay exactly."""
    h = zlib.crc32(
        f"preview|{prompt}|{seed}|{key.height}x{key.width}|{key.steps}|"
        f"{step}".encode()
    )
    rng = np.random.RandomState(h % (2**31))
    return rng.rand(4, 4, 3).astype(np.float32)


class StepFakeExecutor(FakeExecutor):
    """Serve-executor fake implementing the step-granular contract
    (serve/stepbatch.py) alongside the monolithic ``__call__``.

    One `step_run` call advances its whole cohort one denoise step and
    sleeps ONE key-aware step time (``effective_service_s() / steps``)
    regardless of cohort size — a batched step costs one pass, the same
    coalescing premise `FakeExecutor.__call__` models for whole batches.
    That is what makes continuous mode measurably request-shaped on the
    fakes: a joiner rides the next cohort step instead of waiting out a
    whole batch.  The real `PipelineExecutor.step_run` now matches this
    cost model: same-signature cohort members pack into ONE compiled
    dispatch (parallel/rowpack.py), so fake-measured ratios track the
    real executor's dispatch shape.  Outputs are `fake_image` either
    way, so solo, joined, preempted-and-resumed, and monolithic runs are
    byte-identical by construction — the scheduler behavior is what the
    tests interrogate.

    ``step_calls`` records every cohort step's size; ``park_calls`` /
    ``resume_calls`` count the preemption hand-offs; ``step_pack_stats``
    mirrors the real executor's pack-efficiency tallies (the whole fake
    cohort is one "dispatch"), so the server's stepbatch_* counters and
    fill gauge exercise on fakes.
    """

    def __init__(self, key: ExecKey, batch_size: int = 8,
                 step_time_s: float = 0.0):
        super().__init__(key, batch_size=batch_size,
                         step_time_s=step_time_s)
        self.step_calls: List[int] = []
        self.park_calls = 0
        self.resume_calls = 0
        self.step_pack_stats = {"dispatches": 0, "packed_rows": 0,
                                "rows_capacity": 0}

    def step_signature(self, work: dict):
        """Every fake work at the same step count packs together — the
        fake's cohort step IS one dispatch (`StepBatcher.cohort`'s
        pack_align source)."""
        return (id(self), self.key.steps)

    def step_time_per_step_s(self) -> float:
        return (self.effective_service_s() / self.key.steps
                if self.key.steps else 0.0)

    def step_begin(self, prompt: str, negative_prompt: str, seed: int,
                   guidance_scale: float) -> dict:
        return {"prompt": prompt, "seed": int(seed), "i": 0}

    def step_run(self, works: List[dict]) -> None:
        self.step_calls.append(len(works))
        self.step_pack_stats = {"dispatches": 1,
                                "packed_rows": len(works),
                                "rows_capacity": max(self.batch_size,
                                                     len(works))}
        if self.step_time_s:
            time.sleep(self.step_time_per_step_s())
        for w in works:
            w["i"] += 1

    def step_done(self, work: dict) -> bool:
        return work["i"] >= self.key.steps

    def step_finish(self, work: dict):
        return fake_image(work["prompt"], work["seed"], self.key)

    def step_abort(self, work: dict) -> None:
        pass  # no device buffers to release

    def step_park(self, work: dict) -> None:
        self.park_calls += 1

    def step_resume(self, work: dict) -> None:
        self.resume_calls += 1

    def step_preview(self, work: dict, max_size: int = 64) -> np.ndarray:
        return fake_preview(work["prompt"], work["seed"], self.key,
                            work["i"])

    # -- carry migration (serve/migration.py) ------------------------------
    #
    # The fake's "carry" is its step index plus the (prompt, seed)
    # identity, exported as one int32 leaf so the envelope's leaf
    # machinery (shape/dtype descriptors, checksum over raw bytes) is
    # exercised end to end even on fakes.

    def step_export(self, work: dict):
        extra = {"family": type(self).__name__, "step": int(work["i"])}
        return extra, [torch.tensor([work["i"]], dtype=torch.int32)]

    def step_import(self, meta: dict, leaves, prompt: str,
                    negative_prompt: str, seed: int,
                    guidance_scale: float) -> dict:
        from .errors import MigrationRejectedError

        family = type(self).__name__
        if meta.get("family") != family:
            raise MigrationRejectedError(
                f"carry snapshot family {meta.get('family')!r} cannot "
                f"import into a {family} executor"
            )
        step = int(meta["step"])
        if not (0 <= step <= self.key.steps):
            raise MigrationRejectedError(
                f"carry snapshot step {step} out of range for a "
                f"{self.key.steps}-step executor"
            )
        if (len(leaves) != 1 or tuple(leaves[0].shape) != (1,)
                or leaves[0].dtype != torch.int32
                or int(leaves[0][0]) != step):
            raise MigrationRejectedError(
                "carry snapshot leaves do not match the fake step "
                "executor's carry structure"
            )
        return {"prompt": prompt, "seed": int(seed), "i": step}


class StepFakeExecutorFactory(FakeExecutorFactory):
    """FakeExecutorFactory building step-granular fakes."""

    def _new_executor(self, key: ExecKey) -> StepFakeExecutor:
        return StepFakeExecutor(key, batch_size=self.batch_size,
                                step_time_s=self.step_time_s)

    def step_calls(self) -> List[int]:
        """Every cohort step's size, across all executors."""
        return [n for ex in self.executors
                for n in getattr(ex, "step_calls", ())]


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
        self._steps: dict = {}

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

    # -- step-granular records (carry migration) ---------------------------
    #
    # The migration invariant is STEP-scoped: a salvaged step is never
    # re-executed, so across the whole fleet every (request, step index)
    # pair runs exactly once.  `StepLedgerFakeExecutor` records each
    # completed denoise step here; ``max_step_count() <= 1`` proves zero
    # double-executed steps the same way ``max_count()`` proves it for
    # whole requests.

    def record_step(self, prompt: str, seed: int, step: int,
                    replica: str = "") -> None:
        with self._lock:
            per_req = self._steps.setdefault((prompt, int(seed)), {})
            per_req.setdefault(int(step), []).append(replica)

    def step_counts(self, prompt: str, seed: int) -> dict:
        """{step_index: [replica, ...]} of one request's executed steps."""
        with self._lock:
            return {i: list(v) for i, v in
                    self._steps.get((prompt, int(seed)), {}).items()}

    def max_step_count(self) -> int:
        """Max executions of any single (request, step) pair -- the
        exactly-once gate asserts this == 1 (0 with no steps)."""
        with self._lock:
            return max(
                (len(v) for per in self._steps.values()
                 for v in per.values()),
                default=0,
            )

    def steps_snapshot(self) -> dict:
        """{(prompt, seed): {step_index: [replica, ...]}}."""
        with self._lock:
            return {k: {i: list(v) for i, v in per.items()}
                    for k, per in self._steps.items()}


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


class StepLedgerFakeExecutor(StepFakeExecutor):
    """`StepFakeExecutor` recording every COMPLETED denoise step (and
    every completed request) in a shared `ExecutionLedger` — the
    step-granular evidence behind the carry-migration exactly-once gate:
    replica A records steps 0..k-1, the kill fires before step k
    records, and the importing replica B records k..N-1, so
    ``max_step_count() == 1`` proves salvaged steps never re-ran."""

    def __init__(self, key: ExecKey, ledger: ExecutionLedger,
                 replica: str = "", batch_size: int = 8,
                 step_time_s: float = 0.0):
        super().__init__(key, batch_size=batch_size,
                         step_time_s=step_time_s)
        self.ledger = ledger
        self.replica = replica

    def step_run(self, works: List[dict]) -> None:
        pending = [(w["prompt"], w["seed"], w["i"]) for w in works]
        super().step_run(works)
        # record AFTER the step completed — a step killed mid-dispatch
        # never records, exactly like work that died before output
        for prompt, seed, step in pending:
            self.ledger.record_step(prompt, seed, step, self.replica)

    def step_finish(self, work: dict):
        image = super().step_finish(work)
        self.ledger.record(work["prompt"], work["seed"], self.replica)
        return image


class StepLedgerFakeExecutorFactory(FakeExecutorFactory):
    """Per-replica factory building `StepLedgerFakeExecutor`s against
    one shared ledger; ``replica`` tags which replica executed what."""

    def __init__(self, ledger: ExecutionLedger, replica: str = "",
                 batch_size: int = 8, build_delay_s: float = 0.0,
                 step_time_s: float = 0.0):
        super().__init__(batch_size=batch_size, build_delay_s=build_delay_s,
                         step_time_s=step_time_s)
        self.ledger = ledger
        self.replica = replica

    def _new_executor(self, key: ExecKey) -> StepLedgerFakeExecutor:
        return StepLedgerFakeExecutor(
            key, self.ledger, replica=self.replica,
            batch_size=self.batch_size, step_time_s=self.step_time_s)

    def step_calls(self) -> List[int]:
        """Every cohort step's size, across all executors."""
        return [n for ex in self.executors
                for n in getattr(ex, "step_calls", ())]


class StageTracker:
    """Concurrent-residency probe shared by staged fakes: counts batches
    between encode-stage entry and decode-stage exit (the window in which
    a real batch holds device buffers) and records the peak -- what tests
    assert the ``max_inflight_batches`` memory cap against, independently of
    the pipeline's own semaphore accounting."""

    def __init__(self):

        self._lock = sync.Lock()
        self.current = 0
        self.peak = 0

    def enter(self) -> None:
        with self._lock:
            self.current += 1
            self.peak = max(self.peak, self.current)

    def exit(self) -> None:
        with self._lock:
            self.current -= 1


class StagedFakeExecutor(FakeExecutor):
    """Serve-executor fake implementing the three-stage contract
    (serve/staging.py) alongside the monolithic ``__call__``.

    Per-stage simulated times make overlap measurable without a card:
    sleeping stages do not compete for CPU, so a pipelined run's
    steady-state throughput approaches 1/max(stage) while the monolithic
    run pays 1/sum(stage) — the scheduler behavior under test, isolated
    from compute.  ``denoise_s`` defaults to ``step_time_s * steps`` so
    the monolithic path (which sleeps exactly that in ``__call__``) costs
    the same card time as the staged path.  Outputs are `fake_image`
    either way: staged and monolithic dispatch are bit-identical.

    ``fail_stage``/``fail_times`` inject ``fail_exc`` (default RuntimeError)
    into the first N invocations of one stage; ``stage_calls`` counts every
    stage entry for assertions.
    """

    def __init__(self, key: ExecKey, batch_size: int = 8,
                 step_time_s: float = 0.0, encode_s: float = 0.0,
                 denoise_s: float = None, decode_s: float = 0.0,
                 tracker: StageTracker = None, fail_stage: str = None,
                 fail_times: int = 0, fail_exc: Exception = None):
        super().__init__(key, batch_size=batch_size, step_time_s=step_time_s)
        self.encode_s = encode_s
        self.denoise_s = (step_time_s * key.steps if denoise_s is None
                          else denoise_s)
        self.decode_s = decode_s
        self.tracker = tracker
        self.fail_stage = fail_stage
        self.fail_times = fail_times
        self.fail_exc = fail_exc
        self.stage_calls = {"encode": 0, "denoise": 0, "decode": 0}
        # serve/promptcache.py contract (the server attaches its cache to
        # any executor exposing attach_prompt_cache): a hit skips the
        # simulated encode sleep, mirroring the real executor's skipped
        # tokenize + text-encode
        self.prompt_cache = None

    def attach_prompt_cache(self, cache):
        self.prompt_cache = cache
        return cache

    def _stage(self, name: str, sleep_s: float) -> None:
        self.stage_calls[name] += 1
        if self.fail_stage == name and self.fail_times > 0:
            self.fail_times -= 1
            if self.tracker is not None:
                # a failed batch leaves the pipeline here: balance the
                # encode-entry so residency probes stay correct under
                # fault injection.  (Batches DROPPED between stages —
                # cancel/stop — never re-enter the executor, so the
                # tracker is only meaningful for runs without drops.)
                self.tracker.exit()
            raise (self.fail_exc if self.fail_exc is not None
                   else RuntimeError(f"injected {name} stage failure"))
        if sleep_s:
            time.sleep(sleep_s)

    def __call__(self, prompts: List[str], negative_prompts: List[str],
                 guidance_scale: float, seeds: List[int]) -> List[Any]:
        # the monolithic dispatch runs every stage serially: its simulated
        # cost is the SUM of the stage times, so staged-vs-monolithic
        # benchmark ratios measure real overlap, not a handicapped baseline
        assert len(prompts) == len(negative_prompts) == len(seeds)
        self.batch_sizes.append(len(prompts))
        total = self.encode_s + self.denoise_s + self.decode_s
        if total:
            time.sleep(total)
        return [fake_image(p, s, self.key) for p, s in zip(prompts, seeds)]

    def encode_stage(self, prompts: List[str], negative_prompts: List[str],
                     seeds: List[int]):
        if self.tracker is not None:
            self.tracker.enter()
        if self.prompt_cache is not None:
            key = (("fake", self.key.model_id), tuple(prompts),
                   tuple(negative_prompts))
            self.prompt_cache.get_or_encode(
                key, lambda: self._stage("encode", self.encode_s) or True)
        else:
            self._stage("encode", self.encode_s)
        return {"prompts": list(prompts), "seeds": list(seeds)}

    def denoise_stage(self, work, guidance_scale: float):
        self._stage("denoise", self.denoise_s)
        return work

    def decode_stage(self, work) -> List[Any]:
        self._stage("decode", self.decode_s)
        out = [fake_image(p, s, self.key)
               for p, s in zip(work["prompts"], work["seeds"])]
        if self.tracker is not None:
            self.tracker.exit()
        return out


class StagedFakeExecutorFactory(FakeExecutorFactory):
    """FakeExecutorFactory building staged fakes; one shared `StageTracker`
    across every executor measures whole-service residency."""

    def __init__(self, batch_size: int = 8, build_delay_s: float = 0.0,
                 step_time_s: float = 0.0, encode_s: float = 0.0,
                 denoise_s: float = None, decode_s: float = 0.0,
                 fail_stage: str = None, fail_times: int = 0,
                 fail_exc: Exception = None):
        super().__init__(batch_size=batch_size, build_delay_s=build_delay_s,
                         step_time_s=step_time_s)
        self.encode_s = encode_s
        self.denoise_s = denoise_s
        self.decode_s = decode_s
        self.fail_stage = fail_stage
        self.fail_times = fail_times
        self.fail_exc = fail_exc
        self.tracker = StageTracker()

    def _new_executor(self, key: ExecKey) -> StagedFakeExecutor:
        return StagedFakeExecutor(
            key, batch_size=self.batch_size, step_time_s=self.step_time_s,
            encode_s=self.encode_s, denoise_s=self.denoise_s,
            decode_s=self.decode_s, tracker=self.tracker,
            fail_stage=self.fail_stage, fail_times=self.fail_times,
            fail_exc=self.fail_exc,
        )


class CollectiveFakeExecutor(StagedFakeExecutor, StepFakeExecutor):
    """The staged and step fakes over n ranks (serve/ranks.py): every
    operation issues two group operations over a gloo group of the world,
    as a real operation issues several collectives.  The first all-reduces
    the sequence number and op code of the command it runs in
    (`serve.ranks.current_command`) and fails unless every rank runs the
    same command; the second all-reduces the sequence number again.
    Between the two, ``fault_plan`` (this rank's) is consulted at site
    ``"collective"``: a fault there fires on one rank alone inside the
    operation, after its peers entered it, so they wait in the second
    group operation until the data groups' timeout or abort frees them
    (the failure a real out-of-memory between two collectives makes).
    Every operation that issues collectives in the real executor (a
    whole-batch call, the denoise and decode stages, the step contract)
    checks the ``data`` group; an encode checks a group of its own
    (``encode``).  So a command one rank missed, two commands with
    collectives running at once (ranks pairing a denoise with a decode),
    or an operation that ran outside a command fails (or hangs, which the
    tests bound).  ``log`` (shared with the factory) records each ``(seq,
    op)`` run."""

    def __init__(self, key: ExecKey, groups, log: List[Any], fault_plan=None, **kw):
        super().__init__(key, **kw)
        self.groups = groups
        self.log = log
        self.fault_plan = fault_plan

    def _collective(self, lane: str) -> None:
        import torch.distributed as dist

        from .ranks import OPS, current_command

        cmd = current_command()
        if cmd is None:
            raise AssertionError(
                "a collective fake operation ran outside a command of serve/ranks.py")
        seq, op = cmd
        code = OPS.index(op)
        group = self.groups[lane]
        got = torch.tensor([seq, code, -seq, -code], dtype=torch.int64)
        dist.all_reduce(got, op=dist.ReduceOp.MAX, group=group)
        if got.tolist() != [seq, code, -seq, -code]:
            raise AssertionError(
                f"rank {dist.get_rank()} ran command {seq} ({op}) on the {lane} group "
                f"while a peer ran another: max/min {got.tolist()}")
        if self.fault_plan is not None:
            self.fault_plan.check("collective", key=self.key)
        dist.all_reduce(torch.tensor([seq], dtype=torch.int64), group=group)
        self.log.append((seq, op))

    def __call__(self, prompts, negative_prompts, guidance_scale, seeds):
        self._collective("data")
        return super().__call__(prompts, negative_prompts, guidance_scale, seeds)

    def encode_stage(self, prompts, negative_prompts, seeds):
        self._collective("encode")
        return super().encode_stage(prompts, negative_prompts, seeds)

    def denoise_stage(self, work, guidance_scale: float):
        self._collective("data")
        return super().denoise_stage(work, guidance_scale)

    def decode_stage(self, work):
        self._collective("data")
        return super().decode_stage(work)

    def step_begin(self, prompt, negative_prompt, seed, guidance_scale):
        self._collective("data")
        return super().step_begin(prompt, negative_prompt, seed, guidance_scale)

    def step_run(self, works):
        self._collective("data")
        return super().step_run(works)

    def step_finish(self, work):
        self._collective("data")
        return super().step_finish(work)

    def step_abort(self, work):
        self._collective("data")
        return super().step_abort(work)

    def step_park(self, work):
        self._collective("data")
        return super().step_park(work)

    def step_resume(self, work):
        self._collective("data")
        return super().step_resume(work)

    def step_export(self, work):
        self._collective("data")
        return super().step_export(work)

    def step_import(self, meta, leaves, prompt, negative_prompt, seed, guidance_scale):
        self._collective("data")
        return super().step_import(meta, leaves, prompt, negative_prompt, seed,
                                   guidance_scale)


class FakeGroups:
    """The collective fakes' gloo groups over the world, ``data`` and
    ``encode``, by lane: each a data group of `utils.config` (so
    ``rebuild_data_groups`` makes them anew with the others), read at
    every operation, so an executor built before a rebuild uses the new
    generation's."""

    LANES = ("data", "encode")

    def __getitem__(self, lane: str):
        from ..utils.config import named_data_group

        return named_data_group("fake-" + lane, backend="gloo")


def fake_groups() -> FakeGroups:
    """The collective fakes' groups (`FakeGroups`), made now: call it on
    every rank in the same place of the order of groups."""
    groups = FakeGroups()
    for lane in FakeGroups.LANES:
        groups[lane]
    return groups


class CollectiveFakeExecutorFactory(StagedFakeExecutorFactory):
    """Builds `CollectiveFakeExecutor` s over ``groups`` (`fake_groups`: the
    fakes' two gloo groups over the world) with this rank's ``fault_plan``
    at site ``"collective"``.  ``log`` holds every ``(seq, op)`` its
    executors ran on this rank."""

    def __init__(self, groups, fault_plan=None, **kw):
        super().__init__(**kw)
        self.groups = groups
        self.fault_plan = fault_plan
        self.log: List[Any] = []

    def _new_executor(self, key: ExecKey) -> CollectiveFakeExecutor:
        return CollectiveFakeExecutor(
            key, self.groups, self.log, fault_plan=self.fault_plan,
            batch_size=self.batch_size,
            step_time_s=self.step_time_s, encode_s=self.encode_s,
            denoise_s=self.denoise_s, decode_s=self.decode_s, tracker=self.tracker,
            fail_stage=self.fail_stage, fail_times=self.fail_times,
            fail_exc=self.fail_exc)
