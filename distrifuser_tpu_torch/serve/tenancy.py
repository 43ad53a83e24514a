"""Per-tenant fair queuing for the serve plane: token-bucket admission
quotas plus weighted deficit-round-robin (DRR) scheduling shares.

The JAX package's serve/tenancy.py, ported as is.  The `RequestQueue`
alone orders purely by deadline (EDF via ``peek_best``): correct for one cooperative client, but one tenant's
burst of tight deadlines starves everyone else — EDF has no notion of
*whose* deadline.  `TenancyPolicy` splits fairness into the two places
it belongs:

* **Admission** (`admit`, called by ``RequestQueue.put``): each tenant
  has a token bucket (``TenantConfig.rate_rps``/``burst``).  An empty
  bucket rejects with the typed `TenantQuotaError` (HTTP 429) *before*
  the request consumes queue depth, so a flooding tenant cannot evict
  other tenants' admission headroom.
* **Scheduling** (`select`/`charge`, called by ``peek_best``/
  ``remove``): deficit round-robin across the tenants that currently
  have queued work.  Each pass credits a backlogged tenant
  ``drr_quantum * weight`` denoise steps of deficit; a tenant whose
  deficit covers its head request's cost (``num_inference_steps``) is
  served.  Within the serving tenant the scheduler's own score (EDF
  slack) picks the request — deadlines order a tenant's OWN work, the
  deficit bounds how much scheduler time the tenant takes from others.
  A tenant's deficit resets when its sub-queue goes idle (classic DRR:
  you cannot bank credit while absent).

``select`` must be SIDE-EFFECT-FREE against repeated peeks: the
scheduler peeks (possibly several times per fill round, and from the
preemption path, which never dequeues) before committing to at most one
dequeue.  So `select` *simulates* the DRR round on copies of the
deficits and parks the outcome as a pending decision; `charge` — called
by ``RequestQueue.remove`` for the request actually dequeued — commits
the pending decision when it matches, and falls back to a plain debit
when the scheduler removed something else (expiry reaping, tests).
Peeking N times then removing once therefore charges exactly once.

Thread-safety: the policy owns NO lock.  Every method is invoked by
`RequestQueue` while holding the queue's own ``_lock``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from ..utils.config import GatewayConfig, TenantConfig
from .errors import TenantQuotaError
from .queue import Request


class TokenBucket:
    """Lazy-refill token bucket: ``rate`` tokens/s up to ``burst``
    capacity.  ``rate=0`` disables the bucket (always admits).  NOT
    internally locked — the owning `TenancyPolicy` is called under the
    queue lock."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float]):
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self.tokens = float(burst)
        self.last_refill = clock()

    def try_take(self, n: float = 1.0) -> bool:
        if self.rate <= 0:
            return True
        now = self._clock()
        elapsed = max(0.0, now - self.last_refill)
        self.tokens = min(self.burst, self.tokens + elapsed * self.rate)
        self.last_refill = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class _TenantState:
    """Mutable per-tenant scheduling state (guarded via the queue lock)."""

    def __init__(self, config: TenantConfig, clock: Callable[[], float]):
        self.config = config
        self.bucket = TokenBucket(config.rate_rps, config.burst, clock)
        self.deficit = 0.0
        # lifetime accounting, surfaced in snapshot()/per-tenant metrics
        self.admitted = 0
        self.rejected_quota = 0
        self.dequeued = 0


class TenancyPolicy:
    """Token-bucket admission + weighted-DRR selection over tenant
    sub-queues.  Constructed from ``ServeConfig.gateway`` when its
    tenant table is non-empty; attached to a `RequestQueue` as
    ``queue.policy``."""

    def __init__(self, config: GatewayConfig,
                 clock: Callable[[], float] = time.monotonic):
        self.config = config
        self._clock = clock
        tenants = list(config.tenants)
        if config.default_tenant not in {t.name for t in tenants}:
            # untagged requests land on default_tenant; give it an
            # implicit unlimited-rate weight-1 entry rather than 429ing
            # every legacy caller
            tenants.append(TenantConfig(name=config.default_tenant))
        #: round-robin order is the configured table order
        self._order: List[str] = [t.name for t in tenants]
        self._state: Dict[str, _TenantState] = {
            t.name: _TenantState(t, clock) for t in tenants
        }
        self._cursor = 0  # index into _order where the next pass starts
        #: decision parked by the last `select`, committed by `charge`:
        #: (winner_request, post_deficits, winner_cursor)
        self._pending = None

    @property
    def tenant_names(self) -> List[str]:
        return list(self._order)

    # -- admission (RequestQueue.put, under the queue lock) ------------------

    def admit(self, req: Request) -> None:
        """Charge the tenant's token bucket; raises `TenantQuotaError`
        (unknown tenant, or bucket empty) — the request never enters
        the queue."""
        st = self._state.get(req.tenant)
        if st is None:
            raise TenantQuotaError(
                f"unknown tenant {req.tenant!r} (configured: "
                f"{', '.join(self._order)})"
            )
        if not st.bucket.try_take(1.0):
            st.rejected_quota += 1
            raise TenantQuotaError(
                f"tenant {req.tenant!r} quota exhausted "
                f"(rate {st.config.rate_rps}/s, burst {st.config.burst:g})"
            )
        st.admitted += 1

    # -- scheduling (peek_best / remove, under the queue lock) ---------------

    @staticmethod
    def _cost(req: Request) -> float:
        """DRR cost unit: denoise steps — the resource a request
        actually occupies a slot for."""
        return float(max(1, req.num_inference_steps))

    def _simulate(self, groups: Dict[str, List[Request]],
                  score: Callable[[Request], float]):
        """One DRR decision on COPIES of the mutable state: returns
        ``(winner_request, post_deficits, winner_tenant, post_cursor)``
        or ``(None, ...)`` when no known tenant has queued work.  Pure —
        `select` returns just the winner, `charge` commits the rest."""
        active = [t for t in self._order if groups.get(t)]
        if not active:
            return None, {}, None, self._cursor
        deficits = {t: self._state[t].deficit for t in active}
        cursor = self._cursor
        n = len(self._order)
        # bounded: every full rotation credits each active tenant
        # quantum*weight > 0, so some tenant's deficit reaches its head
        # cost within ceil(max_cost / (quantum * min_weight)) rotations
        while True:
            for off in range(n):
                name = self._order[(cursor + off) % n]
                if not groups.get(name):
                    continue
                head = min(groups[name], key=score)
                if deficits[name] >= self._cost(head):
                    return head, deficits, name, (cursor + off) % n
            for name in active:
                st = self._state[name]
                deficits[name] += self.config.drr_quantum * st.config.weight

    def select(self, groups: Dict[str, List[Request]],
               score: Callable[[Request], float]) -> Optional[Request]:
        """The request DRR would serve next: EDF-best (min ``score``)
        request of the tenant whose turn it is.  Repeat-peek safe: the
        committed state is untouched; the computed round is parked for
        `charge`.  Requests from tenants missing from the table
        (possible only if they bypassed `admit`) are invisible here and
        fall back to the queue's plain EDF."""
        winner, deficits, _, cursor = self._simulate(groups, score)
        self._pending = (winner, deficits, cursor)
        return winner

    def charge(self, req: Request, remaining: List[Request]) -> None:
        """Account one actual dequeue.  When ``req`` is the decision the
        last `select` parked, its simulated round (deficit credits +
        cursor) commits; otherwise — expiry reaping or a direct
        ``remove`` — the tenant is debited without advancing the round.
        ``remaining`` is the queue content AFTER removal: tenants with
        nothing left forfeit banked deficit (DRR idle reset)."""
        st = self._state.get(req.tenant)
        pending, self._pending = self._pending, None
        if st is None:
            return
        if pending is not None and pending[0] is req:
            _, deficits, cursor = pending
            for t, d in deficits.items():
                self._state[t].deficit = d
            # the cursor stays ON the winner: it keeps serving while its
            # deficit lasts (DRR turn continuity), then rotation moves on
            self._cursor = cursor
        st.deficit = max(0.0, st.deficit - self._cost(req))
        st.dequeued += 1
        backlogged = {r.tenant for r in remaining}
        for t, state in self._state.items():
            if t not in backlogged:
                state.deficit = 0.0

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant accounting for metrics/debugging (read under the
        queue lock by `RequestQueue.tenancy_snapshot`)."""
        out = {}
        for name, st in self._state.items():
            out[name] = {
                "weight": st.config.weight,
                "rate_rps": st.config.rate_rps,
                "burst": st.config.burst,
                "tokens": round(st.bucket.tokens, 6),
                "deficit": round(st.deficit, 6),
                "admitted": st.admitted,
                "rejected_quota": st.rejected_quota,
                "dequeued": st.dequeued,
            }
        return out
