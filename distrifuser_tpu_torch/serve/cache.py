"""LRU cache of prepared executors.

A diffusion service's worst latency cliff is the request-path build: a
(resolution, steps) combination seen for the first time pays the pipeline
build and the capture of its CUDA graphs while the card idles.  This cache
makes that a *startup* cost instead of a *request* cost:

* entries are **executors** -- callables wrapping a fully prepared pipeline
  (pipeline construction + `prepare()`, which captures the denoiser's
  CUDA graphs at the bucket's shapes) for one `ExecKey`;
* the key is (model id, bucket HxW, steps, guidance mode, layout, knobs) --
  exactly the things that change the captured program.  Prompt, seed, and
  guidance *scale* are runtime inputs and share a program;
* **LRU bounded**: prepared executors pin device memory (each one's static
  buffers and graphs; the host trees may be shared), so capacity evicts
  the coldest bucket rather than growing without bound;
* `warmup` prefetches the hot buckets at startup, so steady-state traffic
  only ever hits.

Thread model: `get`/`warmup` are called by the single scheduler thread (or
startup thread before serving); a lock still guards the map so stats reads
from other threads are consistent.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from ..utils import sync


@dataclasses.dataclass(frozen=True)
class ExecKey:
    """Identity of one prepared executor, field for field the JAX
    package's, so that the two packages' servers key alike.  ``mesh_plan``
    is `DistriConfig.mesh_plan`: the same bucket on a different layout is
    a different program.  The step-cache cadence
    (``step_cache_interval``/``step_cache_depth``), ``comm_compress``,
    ``refresh_fraction``, ``weight_quant`` and ``quant_compute`` change what
    the prepared denoiser runs (its captured graphs, its weight tree), so
    two requests differing in any of them must not share an executor; a
    dense and an int8 executor of one bucket coexist in one cache (the
    resilience ladder's ``weight_quant_on`` rung moves OOM-degraded keys
    onto the smaller int8 one).  ``exec_mode`` selects the denoise loop's
    dispatch: "fused" replays the captured CUDA graphs, "stepwise" runs
    step by step eagerly (``set_stepwise``: the same numerics, no graphs
    to capture or hold; the ladder's ``stepwise_fallback`` rung); "step"
    is the step-granular serve mode (serve/stepbatch.py): the same eager
    per-step evaluations as "stepwise", driven one step at a time by the
    slot-pool scheduler with each request's carry held outside the
    pipeline, and kept distinct from "stepwise" so the two dispatch
    disciplines never share an executor.  ``parallelism`` ("patch" |
    "pipefusion") and ``pipe_patches`` (0 = build_pipeline's default, one
    patch per stage) are identity fields too: displaced patch parallelism
    and PipeFusion are different programs over the same ranks, and the
    ladder's ``pipeline_off`` rung rebuilds a failing pipefusion key as
    the *identical* key a patch bucket would use."""

    model_id: str
    scheduler: str
    height: int
    width: int
    steps: int
    cfg: bool
    mesh_plan: str
    step_cache_interval: int = 1
    step_cache_depth: int = 0
    comm_compress: str = "none"
    # PCPP partial refresh (DistriConfig.refresh_fraction semantics): the
    # strided refresh schedule is traced into the program, so a fraction
    # change is a different executable — the SLO controller's
    # partial_refresh tier keys its degraded programs through this field.
    refresh_fraction: float = 1.0
    weight_quant: str = "none"
    # Quantized-COMPUTE policy (DistriConfig.quant_compute semantics):
    # storage-only ("off") and compute-routed ("auto"/"dot"/"pallas")
    # executables trace different matmul paths — int8-storage and
    # int8-compute are DISTINCT compiled programs for the same bucket, so
    # the ladder/controller can hold both and the weight ledger never
    # aliases them.  Irrelevant (and unvalidated beyond membership) when
    # weight_quant="none": a dense program has no quantized kernels to
    # route, so "auto" and "off" trace identically — the field is kept
    # out of short() there.
    quant_compute: str = "auto"
    exec_mode: str = "fused"
    parallelism: str = "patch"
    pipe_patches: int = 0

    def __post_init__(self):
        if self.exec_mode not in ("fused", "stepwise", "step"):
            raise ValueError(
                f"exec_mode must be 'fused', 'stepwise', or 'step', got "
                f"{self.exec_mode!r}"
            )
        from ..parallel.compress import (
            COMPRESS_MODES,
            WEIGHT_QUANT_MODES,
            validate_refresh_fraction,
        )

        if self.comm_compress not in COMPRESS_MODES:
            raise ValueError(
                f"comm_compress must be one of {COMPRESS_MODES}, got "
                f"{self.comm_compress!r}"
            )
        validate_refresh_fraction(self.refresh_fraction)
        if self.refresh_fraction < 1.0 and self.parallelism != "patch":
            raise ValueError(
                "refresh_fraction < 1 (PCPP) applies to displaced-patch "
                "keys only (parallelism='patch'); a "
                f"{self.parallelism!r} key has no stale refresh to thin"
            )
        if self.weight_quant not in WEIGHT_QUANT_MODES:
            raise ValueError(
                f"weight_quant must be one of {WEIGHT_QUANT_MODES}, got "
                f"{self.weight_quant!r}"
            )
        from ..parallel.compress import validate_serve_quant_compute

        validate_serve_quant_compute(self.quant_compute, self.weight_quant)
        if self.parallelism not in ("patch", "pipefusion"):
            raise ValueError(
                f"ExecKey.parallelism must be 'patch' or 'pipefusion', "
                f"got {self.parallelism!r}"
            )
        if self.pipe_patches < 0:
            raise ValueError(
                f"pipe_patches must be >= 0, got {self.pipe_patches}"
            )
        if self.pipe_patches and self.parallelism != "pipefusion":
            raise ValueError(
                "pipe_patches is a pipefusion-only field; a patch key "
                "carrying it would silently alias two different compiled "
                "programs"
            )
        if self.parallelism == "pipefusion" and self.exec_mode != "fused":
            raise ValueError(
                f"exec_mode={self.exec_mode!r} does not exist for "
                "pipefusion keys (no host-driven per-step loop) — the "
                "ladder degrades them via pipeline_off instead, and step "
                "batching requires patch buckets"
            )

    def short(self) -> str:
        # every identity field appears (scheduler included): short() keys
        # the per-executor ledgers (weight_bytes, circuits, degradations),
        # so two resident keys must never collide to one tag
        g = "cfg" if self.cfg else "nocfg"
        sc = (f":sc{self.step_cache_interval}x{self.step_cache_depth}"
              if self.step_cache_interval > 1 else "")
        cc = ("" if self.comm_compress == "none"
              else f":{self.comm_compress}")
        pr = ("" if self.refresh_fraction >= 1.0
              else f":pr{self.refresh_fraction:g}")
        wq = ("" if self.weight_quant == "none"
              else f":wq-{self.weight_quant}")
        # storage-only vs compute-routed quantization are different
        # programs: tag every non-default policy on quantized keys
        # ("auto", the fleet default, stays untagged)
        qc = ("" if self.weight_quant == "none"
              or self.quant_compute == "auto"
              else f":qc-{self.quant_compute}")
        em = "" if self.exec_mode == "fused" else f":{self.exec_mode}"
        pf = ("" if self.parallelism == "patch"
              else f":pf{self.pipe_patches or ''}")
        return (f"{self.model_id}:{self.scheduler}:{self.height}x"
                f"{self.width}@{self.steps}st:{g}:{self.mesh_plan}"
                f"{sc}{cc}{pr}{wq}{qc}{em}{pf}")


class ExecutorCache:
    """LRU of prepared executors, keyed by `ExecKey`.

    ``build_fn(key)`` constructs and warms an executor (expected to be
    expensive: it builds a pipeline and captures its graphs);
    ``on_evict(key, executor)`` lets the owner release device buffers when
    an entry falls out.

    **Pinning** (the staged serving pipeline, serve/staging.py, and the
    step slot pool, serve/stepbatch.py): a staged batch holds its executor
    across three asynchronous stage invocations, and a resident step
    request across many rounds, so the LRU must not free the pipeline a
    worker is about to run.  ``get(key, pin=True)`` takes a refcount on the
    returned executor; ``unpin(executor)`` drops it.  Pinned entries are
    skipped by capacity eviction (capacity may be exceeded while every
    entry is pinned -- correctness over the memory bound, which
    `max_inflight_batches` / ``step_batching.slots`` already cap); an entry
    evicted by ``invalidate`` while pinned leaves the map immediately --
    the next ``get`` rebuilds -- but its ``on_evict`` release is DEFERRED
    to the last ``unpin``, so in-flight work never runs against freed
    buffers.  (The JAX package's cache also loads persisted executables
    from an AOT store; that comes with step 16g of ROADMAP item 16.)
    """

    def __init__(
        self,
        build_fn: Callable[[ExecKey], Any],
        capacity: int,
        on_evict: Optional[Callable[[ExecKey, Any], None]] = None,
    ):
        assert capacity >= 1, capacity
        self.build_fn = build_fn
        self.capacity = capacity
        self.on_evict = on_evict
        # optional utils.trace.Tracer (set by the owning server when
        # request-scoped tracing is on): hit/miss instants and build
        # spans land on the "cache" track, so a Perfetto view shows
        # exactly which dispatch paid a build.  None = zero overhead.
        self.tracer = None
        self._entries: "OrderedDict[ExecKey, Any]" = OrderedDict()
        self._lock = sync.Lock()
        # refcounts by executor identity (not key: a key may rebuild while
        # the old instance is still pinned by in-flight staged work)
        self._pins: Dict[int, int] = {}
        self._pin_refs: Dict[int, Any] = {}  # id -> executor (keeps id stable)
        self._deferred: Dict[int, Tuple[ExecKey, Any]] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.deferred_evictions = 0
        self.build_seconds = 0.0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, key: ExecKey) -> bool:
        with self._lock:
            return key in self._entries

    def _pin_locked(self, ex: Any) -> None:
        i = id(ex)
        self._pins[i] = self._pins.get(i, 0) + 1
        self._pin_refs[i] = ex

    def _pinned_locked(self, ex: Any) -> bool:
        return self._pins.get(id(ex), 0) > 0

    def pin_count(self, ex: Any) -> int:
        with self._lock:
            return self._pins.get(id(ex), 0)

    def unpin(self, ex: Any) -> None:
        """Drop one pin.  If the executor was evicted/invalidated while
        pinned, the LAST unpin fires its deferred ``on_evict``."""
        fire: Optional[Tuple[ExecKey, Any]] = None
        with self._lock:
            i = id(ex)
            n = self._pins.get(i, 0) - 1
            if n > 0:
                self._pins[i] = n
                return
            self._pins.pop(i, None)
            self._pin_refs.pop(i, None)
            fire = self._deferred.pop(i, None)
        if fire is not None and self.on_evict:
            self.on_evict(*fire)

    def _evict_locked(self, key: ExecKey, ex: Any) -> Optional[Tuple[ExecKey, Any]]:
        """Entry already removed from the map; returns the (key, ex) pair
        to release now, or None when the release is deferred to unpin."""
        self.evictions += 1
        if self._pinned_locked(ex):
            self.deferred_evictions += 1
            self._deferred[id(ex)] = (key, ex)
            return None
        return (key, ex)

    def get(self, key: ExecKey, pin: bool = False) -> Tuple[Any, bool]:
        """(executor, hit?) -- builds on miss, evicting LRU entries beyond
        capacity (never pinned ones).  The build runs outside the lock:
        stats reads never stall behind a build.  With ``pin=True`` the
        returned executor carries a refcount the caller must drop via
        ``unpin``."""
        hit_ex = None
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                self.hits += 1
                hit_ex = self._entries[key]
                if pin:
                    self._pin_locked(hit_ex)
            else:
                self.misses += 1
        if hit_ex is not None:
            # trace mark OUTSIDE the cache lock: the tracer has its own
            # lock, and nesting it inside this hot-path critical section
            # would serialize dispatch against every other tracer user
            if self.tracer is not None:
                self.tracer.event("cache_hit", track="cache",
                                  args={"key": key.short()})
            return hit_ex, True
        tracer = self.tracer
        tt0 = tracer.clock() if tracer is not None else 0.0
        t0 = time.monotonic()
        try:
            ex = self.build_fn(key)
        except BaseException:
            # failed builds still leave a trace mark: the retry loop's
            # next attempt shows up as a fresh build span after it
            if tracer is not None:
                tracer.event("build_failed", track="cache",
                             args={"key": key.short()})
            raise
        dt = time.monotonic() - t0
        if tracer is not None:
            tracer.complete("build", tt0, tracer.clock(), track="cache",
                            args={"key": key.short()})
        evicted: List[Tuple[ExecKey, Any]] = []
        with self._lock:
            self.build_seconds += dt
            self._entries[key] = ex
            self._entries.move_to_end(key)
            if pin:
                self._pin_locked(ex)
            over = len(self._entries) - self.capacity
            # oldest-first victims, skipping pinned entries (and the entry
            # just inserted: it is the MRU, but a capacity-1 cache makes it
            # the only candidate)
            for old_key in list(self._entries):
                if over <= 0:
                    break
                if old_key == key:
                    continue
                old_ex = self._entries[old_key]
                if self._pinned_locked(old_ex):
                    continue
                del self._entries[old_key]
                pair = self._evict_locked(old_key, old_ex)
                if pair is not None:
                    evicted.append(pair)
                over -= 1
        if self.on_evict:
            for old_key, old_ex in evicted:
                self.on_evict(old_key, old_ex)
        return ex, False

    def invalidate(self, key: ExecKey) -> bool:
        """Drop one entry (True if it was resident), firing ``on_evict``
        so its device buffers can be released -- DEFERRED to the last
        ``unpin`` when staged or step work still holds the executor.  The
        resilience layer uses this to evict a poisoned executor before
        retrying a degraded build -- a cached broken program must not
        satisfy the retry."""
        pair = None
        with self._lock:
            ex = self._entries.pop(key, None)
            if ex is not None:
                pair = self._evict_locked(key, ex)
        if ex is not None and self.tracer is not None:
            self.tracer.event("invalidate", track="cache",
                              args={"key": key.short()})
        if pair is not None and self.on_evict:
            self.on_evict(*pair)
        return ex is not None

    def invalidate_all(self) -> int:
        """`invalidate` every entry (oldest first); returns how many."""
        with self._lock:
            keys = list(self._entries)
        return sum(self.invalidate(k) for k in keys)

    def warmup(self, keys: Iterable[ExecKey]) -> int:
        """Prefetch executors for the given keys (startup path).  Returns
        how many were newly built.  Warmup misses are intentional -- they
        are the misses bought here so requests only ever hit."""
        built = 0
        for key in keys:
            _, hit = self.get(key)
            built += 0 if hit else 1
        return built

    def weight_bytes(self) -> Dict[str, Optional[int]]:
        """Per-resident-executor weight bytes on the device (None for
        executors that don't report -- fakes, custom adapters), surfaced
        by `InferenceServer.metrics_snapshot()`."""
        with self._lock:
            return {
                k.short(): getattr(ex, "weight_nbytes", None)
                for k, ex in self._entries.items()
            }

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "entries": [k.short() for k in self._entries],
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": (self.hits / total) if total else 0.0,
                "evictions": self.evictions,
                "deferred_evictions": self.deferred_evictions,
                "pinned": sum(1 for n in self._pins.values() if n > 0),
                "build_seconds": round(self.build_seconds, 6),
            }
