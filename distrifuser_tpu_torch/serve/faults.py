"""Seedable, deterministic fault injection for the serve layer.

Real deployments see failed compiles, transient execute errors, hung
devices, and OOMs (preempted/slow devices are the premise of STADI,
arXiv 2509.04719); nothing in a clean CPU test run does.  A `FaultPlan`
makes those events *reproducible*: named injection sites consult the plan,
and each matching `FaultRule` decides — from its own seeded RNG stream —
whether to raise, sleep, or pass.  The same plan + the same call sequence
at a site fires the same faults, so every resilience behavior (retry,
circuit breaking, watchdog, degradation ladder) is testable on the CPU.

Injection sites (the convention: sites are plain strings):

* ``"build"`` -- `InferenceServer` around `executor_factory(key)` (covers
  fake and real factories alike);
* ``"execute"`` -- `InferenceServer` inside the watchdog-wrapped batched
  dispatch (so a ``hang`` here is what the watchdog exists to bound);
* ``"executor.build"`` / ``"executor.execute"`` -- `pipeline_executor_factory`
  / `PipelineExecutor.__call__` for direct (server-less) executor use;
* ``"replica"`` -- `serve.replica.Replica` at the top of every monolithic
  executor dispatch AND every step-granular cohort step (``step_run``).
  The site's key stringifies to the REPLICA NAME, so ``key_substr``
  targets a named replica; combined with ``after_calls`` a rule kills /
  hangs / degrades that replica deterministically mid-load -- under step
  batching, after an exact number of denoise steps (fleet failover and
  carry migration are what the site exists to exercise);
* ``"migrate.export"`` / ``"migrate.import"`` -- the carry-migration wire
  (serve/migration.py): MUTATION sites consulted through
  `FaultPlan.mutate` on the encoded snapshot bytes as they leave the
  stopping server / arrive at the adopting one.  Only the
  ``snapshot_truncate`` / ``snapshot_corrupt`` kinds apply here.

The JAX package's ``"runner.compile"`` site (its compiled-loop builder) has
no counterpart here, and its ``"aotcache.*"`` sites come with the AOT
store.

Fault kinds:

* ``compile_error`` -- raises `InjectedCompileError`;
* ``execute_error`` -- raises `InjectedExecuteError`;
* ``oom`` -- raises `InjectedResourceExhausted`, whose message keeps the
  JAX package's RESOURCE_EXHAUSTED shape, so `errors.is_oom` classifies it
  as it classifies a real ``torch.cuda.OutOfMemoryError``;
* ``hang`` -- sleeps ``hang_s`` then returns normally, modelling a stalled
  device that eventually recovers.  Under a watchdog the call is abandoned
  at the timeout; the sleeping thread finishes in the background and its
  result is discarded;
* ``kill`` -- raises `InjectedReplicaKilled`, modelling a replica process
  dying mid-dispatch.  Only meaningful at the ``"replica"`` site: the
  `Replica` catches it in its executor wrapper, transitions to STOPPED,
  SYNCHRONOUSLY signals the server's shutdown (queued futures fail with
  `ServerClosedError`; the blocking scheduler join runs in the
  background), and re-raises so the in-flight batch fails terminally --
  the fleet router then fails the whole replica's load over;
* ``snapshot_truncate`` / ``snapshot_corrupt`` -- `FaultPlan.mutate` cuts
  the bytes in half / flips one byte at a deterministic offset.

Only the ``execute`` sites run under the watchdog.  A ``hang`` injected
at a build/compile site blocks its caller for the full ``hang_s`` —
which is the faithful simulation: executor builds are synchronous in the
scheduler thread (a slow compile service stalls admission-to-dispatch
exactly like this), and the watchdog deliberately does not bound them
because legitimate cold compiles take minutes.  Size ``hang_s``
accordingly when targeting a build site.
"""

from __future__ import annotations

import dataclasses
import random
import time
import zlib
from typing import Dict, Optional, Sequence, Tuple

from ..utils import sync

FAULT_KINDS = ("compile_error", "execute_error", "oom", "hang", "kill",
               "snapshot_truncate", "snapshot_corrupt")

# Data-mutation kinds: they never raise at a ``check`` site — they
# corrupt bytes passing through a ``mutate`` site (the carry-migration
# wire, serve/migration.py), and the RECEIVER's typed validation is what
# the chaos run interrogates.
MUTATE_KINDS = ("snapshot_truncate", "snapshot_corrupt")


class InjectedFault(Exception):
    """Marker base for injected faults (mixed into concrete kinds) so
    tests and metrics can tell injected failures from organic ones."""


class InjectedCompileError(RuntimeError, InjectedFault):
    pass


class InjectedExecuteError(RuntimeError, InjectedFault):
    pass


class InjectedResourceExhausted(RuntimeError, InjectedFault):
    """Message kept RESOURCE_EXHAUSTED-shaped, as in the JAX package, so a
    plan fires the same typed error in both packages; `errors.is_oom`
    sees it beside the real ``torch.cuda.OutOfMemoryError``."""


class InjectedReplicaKilled(RuntimeError, InjectedFault):
    """The ``kill`` kind at the ``"replica"`` site: the replica process
    "died" -- its in-flight dispatch fails with this, and the `Replica`
    handle shuts its server down (see serve/replica.py)."""


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One injection rule: WHERE (site + filters), WHAT (kind), WHEN
    (probability per call, or exact 0-based call indices at the site).

    Filters are checked before the rule's RNG is consulted, so a rule's
    random stream advances only on calls it could have fired on — the
    firing pattern is a pure function of (seed, the site's filtered call
    sequence).
    """

    site: str
    kind: str
    p: float = 0.0  # per-eligible-call probability
    at_calls: Tuple[int, ...] = ()  # exact site-call indices (0-based)
    after_calls: int = 0  # eligible only once the site saw >= this many calls
    min_batch: int = 0  # only fire when batch_size >= min_batch
    key_substr: str = ""  # only fire when ExecKey.short() contains this
    max_fires: int = -1  # -1 = unbounded
    hang_s: float = 10.0  # sleep length for kind == "hang"

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"fault kind must be one of {FAULT_KINDS}, got {self.kind!r}"
            )
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"fault probability must be in [0, 1], got {self.p}")
        if self.p == 0.0 and not self.at_calls:
            raise ValueError(
                f"rule {self.site}/{self.kind}: give a probability p > 0 or "
                "explicit at_calls indices — a rule that can never fire is a "
                "misconfigured plan, not a no-op"
            )
        if self.after_calls < 0:
            raise ValueError(
                f"after_calls must be >= 0, got {self.after_calls}"
            )


def _raise_fault(rule: FaultRule, site: str) -> None:
    msg = f"injected {rule.kind} at site {site!r}"
    if rule.kind == "compile_error":
        raise InjectedCompileError(msg)
    if rule.kind == "execute_error":
        raise InjectedExecuteError(msg)
    if rule.kind == "oom":
        raise InjectedResourceExhausted(
            f"RESOURCE_EXHAUSTED: {msg} (simulated out-of-memory while "
            "allocating device buffers)"
        )
    if rule.kind == "kill":
        raise InjectedReplicaKilled(msg)
    raise AssertionError(rule.kind)  # hang handled by the caller


class FaultPlan:
    """A seeded set of `FaultRule`s plus per-site call counters.

    ``check(site, key=..., batch_size=...)`` is the single entry point a
    site calls; it either returns (no fault), sleeps then returns
    (``hang``), or raises the injected exception.  At most one rule fires
    per call (first matching rule in declaration order wins).

    Thread-safe: the scheduler thread and watchdog worker threads consult
    the same plan.  ``fired()`` snapshots ``{(site, kind): count}`` so
    benches can report exactly what chaos was applied.
    """

    def __init__(self, rules: Sequence[FaultRule], seed: int = 0):
        self.rules = tuple(rules)
        self.seed = int(seed)
        self._lock = sync.Lock()
        self._site_calls: Dict[str, int] = {}
        self._fires: Dict[Tuple[str, str], int] = {}
        self._rule_fires = [0] * len(self.rules)
        # one independent deterministic stream per rule: interleaving of
        # *different* sites can never perturb a rule's pattern
        self._rngs = [
            random.Random(
                zlib.crc32(f"{self.seed}|{i}|{r.site}|{r.kind}".encode())
            )
            for i, r in enumerate(self.rules)
        ]

    # -- internals ----------------------------------------------------------

    def _eligible(self, rule: FaultRule, key, batch_size: Optional[int]) -> bool:
        if rule.min_batch and (batch_size is None or batch_size < rule.min_batch):
            return False
        if rule.key_substr:
            short = key.short() if hasattr(key, "short") else str(key)
            if key is None or rule.key_substr not in short:
                return False
        return True

    def _pick(self, site: str, key, batch_size: Optional[int],
              mutate: bool = False) -> Optional[FaultRule]:
        with self._lock:
            call_idx = self._site_calls.get(site, 0)
            self._site_calls[site] = call_idx + 1
            for i, rule in enumerate(self.rules):
                if rule.site != site:
                    continue
                if (rule.kind in MUTATE_KINDS) != mutate:
                    # raise-kinds fire from check(), mutate-kinds from
                    # mutate() — a rule can never cross the two APIs
                    continue
                if call_idx < rule.after_calls:
                    # index-gated like at_calls: the rule's RNG stream
                    # does not advance on calls before its window opens
                    continue
                if not self._eligible(rule, key, batch_size):
                    continue
                if 0 <= rule.max_fires <= self._rule_fires[i]:
                    continue
                fire = call_idx in rule.at_calls
                if not fire and rule.p > 0.0:
                    fire = self._rngs[i].random() < rule.p
                if fire:
                    self._rule_fires[i] += 1
                    k = (site, rule.kind)
                    self._fires[k] = self._fires.get(k, 0) + 1
                    return rule
            return None

    # -- the site API -------------------------------------------------------

    def check(self, site: str, key=None, batch_size: Optional[int] = None) -> None:
        """Consult the plan at ``site``; raise/sleep if a rule fires."""
        rule = self._pick(site, key, batch_size)
        if rule is None:
            return
        if rule.kind == "hang":
            time.sleep(rule.hang_s)
            return
        _raise_fault(rule, site)

    def mutate(self, site: str, data: bytes, key=None) -> bytes:
        """Consult the plan at a MUTATION ``site``: returns ``data``
        unchanged (no rule fired) or a deterministically corrupted copy
        (``snapshot_truncate`` halves it; ``snapshot_corrupt`` flips one
        mid-payload byte).  Never raises — the corruption's *detection*
        belongs to the receiver's validation, which is the code path
        under test."""
        rule = self._pick(site, key, None, mutate=True)
        if rule is None or not data:
            return data
        if rule.kind == "snapshot_truncate":
            return data[: len(data) // 2]
        # snapshot_corrupt: one flipped byte, deterministic position
        pos = len(data) // 2
        corrupted = bytearray(data)
        corrupted[pos] ^= 0xFF
        return bytes(corrupted)

    # -- observability ------------------------------------------------------

    def fired(self) -> Dict[str, int]:
        """``{"site/kind": count}`` of every fault fired so far."""
        with self._lock:
            return {f"{s}/{k}": n for (s, k), n in sorted(self._fires.items())}

    def site_calls(self) -> Dict[str, int]:
        with self._lock:
            return dict(sorted(self._site_calls.items()))


# The process-global plan lives in the stdlib-only leaf utils/chaos.py;
# re-exported here so chaos tools keep one import surface.
from ..utils.chaos import (  # noqa: E402, F401  (re-exports)
    active_fault_plan,
    clear_fault_plan,
    install_fault_plan,
)
