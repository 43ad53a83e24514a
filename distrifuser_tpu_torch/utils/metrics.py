"""Serving metrics: streaming latency histograms, counters, SLO windows,
the unified registry and its Prometheus / HTTP exposition.

The serve layer's request lifecycle instrumentation (serve/server.py):
streaming accumulators with bounded memory regardless of request count,
JSON-friendly snapshots, one `MetricsRegistry` that owns every metric
under hierarchical names with labels, rendered as JSON
(``metrics_snapshot``, ``/metrics.json``) and as Prometheus text
(``/metrics``).  The JAX package's module also holds the image-quality
metrics (PSNR, LPIPS, FID) of the COCO evaluation scripts; they are not
ported yet (ROADMAP item 9).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

from . import sync

class LatencyHistogram:
    """Streaming latency histogram over geometric buckets.

    Serving metrics must survive millions of requests, so raw samples are
    never retained: observations land in log-spaced buckets (factor
    ``2**0.25`` per bucket ≈ 19% relative resolution — tighter than the
    2x-per-bucket Prometheus default) plus exact running count/sum/min/max.
    Quantiles interpolate within the bucket (log-midpoint), so reported
    percentiles carry the bucket's relative error, never more.

    Range: ``lo`` seconds to ``hi`` seconds; observations outside clamp to
    the boundary buckets (and still count exactly in min/max/sum).
    """

    _FACTOR = 2.0 ** 0.25

    def __init__(self, lo: float = 1e-4, hi: float = 1e3):
        assert 0 < lo < hi, (lo, hi)
        self.lo = lo
        self.hi = hi
        import math

        self._n_buckets = (
            int(math.ceil(math.log(hi / lo) / math.log(self._FACTOR))) + 1
        )
        self._counts = np.zeros(self._n_buckets, np.int64)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        # observe() is a read-modify-write on numpy storage; the staged
        # serving pipeline observes from stage workers concurrently with
        # the scheduler thread (serve/staging.py), same reason as Counter
        self._lock = sync.Lock()

    def _bucket(self, v: float) -> int:
        import math

        if v <= self.lo:
            return 0
        i = int(math.log(v / self.lo) / math.log(self._FACTOR))
        return min(i, self._n_buckets - 1)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._counts[self._bucket(v)] += 1
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def _quantile_locked(self, q: float) -> float:
        if self.count == 0:
            return float("nan")
        rank = q * (self.count - 1)
        cum = 0
        for i, c in enumerate(self._counts):
            cum += int(c)
            if cum > rank:
                # log-midpoint of bucket i, clamped to the observed range
                mid = self.lo * self._FACTOR ** (i + 0.5)
                return float(min(max(mid, self.min), self.max))
        return float(self.max)

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (0 <= q <= 1) by bucket interpolation,
        clamped to the exact observed [min, max].  Locked like observe():
        a reader walking ``_counts`` concurrently with a writer must not
        see a cumulative count ahead of ``self.count`` (readers take the
        same lock writers do)."""
        assert 0.0 <= q <= 1.0, q
        with self._lock:
            return self._quantile_locked(q)

    @property
    def mean(self) -> float:
        with self._lock:
            return self.sum / self.count if self.count else float("nan")

    def snapshot(self) -> Dict[str, float]:
        """JSON-friendly summary (the serve artifact schema).  One lock
        hold for the whole read, so count/sum/min/max and the quantiles
        all come from the same instant."""
        with self._lock:
            if self.count == 0:
                return {"count": 0}
            return {
                "count": self.count,
                "sum": self.sum,
                "mean": self.sum / self.count,
                "min": self.min,
                "max": self.max,
                "p50": self._quantile_locked(0.50),
                "p90": self._quantile_locked(0.90),
                "p99": self._quantile_locked(0.99),
            }


class Counter:
    """Named monotonic counters with a JSON-friendly snapshot.

    Locked: the serve layer increments from client threads (submit-path
    rejections) concurrently with the scheduler thread, and a bare
    read-modify-write would drop counts under that interleaving."""

    def __init__(self):

        self._c: Dict[str, int] = {}
        self._lock = sync.Lock()

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._c[name] = self._c.get(name, 0) + by

    def get(self, name: str) -> int:
        with self._lock:
            return self._c.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(sorted(self._c.items()))


class GapTracker:
    """Busy/idle accounting for one serially-used resource.

    Backs the staged serving pipeline's **denoise-gap fraction**
    (serve/staging.py): the denoise stage owns the mesh, so the fraction
    of wall-time between its first and last invocation that the mesh sat
    idle is exactly the latency the stage overlap failed to hide — the
    measurable form of "the throughput ceiling moves from
    1/sum(stage) to 1/max(stage)".  `begin(t)`/`end(t)` bracket each busy
    interval (single consumer — the stage worker); `snapshot()` is
    any-thread."""

    def __init__(self):

        self._lock = sync.Lock()
        self._t0 = None  # current interval start
        self.first_start = None
        self.last_end = None
        self.busy_s = 0.0
        self.intervals = 0

    def begin(self, t: float) -> None:
        with self._lock:
            assert self._t0 is None, "unbalanced GapTracker.begin"
            self._t0 = float(t)
            if self.first_start is None:
                self.first_start = float(t)

    def end(self, t: float) -> None:
        with self._lock:
            assert self._t0 is not None, "GapTracker.end without begin"
            self.busy_s += float(t) - self._t0
            self.last_end = float(t)
            self._t0 = None
            self.intervals += 1

    def snapshot(self) -> Dict[str, float]:
        """JSON-friendly summary.  ``gap_fraction`` is idle/span over the
        busy envelope [first_start, last_end]; 0.0 before two intervals
        exist (a single invocation has no between-batch gap to report)."""
        with self._lock:
            if self.first_start is None or self.last_end is None:
                return {"intervals": 0, "busy_s": 0.0, "span_s": 0.0,
                        "gap_s": 0.0, "gap_fraction": 0.0}
            span = self.last_end - self.first_start
            gap = max(0.0, span - self.busy_s)
            return {
                "intervals": self.intervals,
                "busy_s": self.busy_s,
                "span_s": span,
                "gap_s": gap,
                "gap_fraction": (gap / span) if span > 0 else 0.0,
            }


class RingLog:
    """Bounded ring of recent event strings (newest last).

    Backs the serve layer's ``last_errors`` health field: a service that
    has failed a million times must still answer "what went wrong
    *lately*" in O(capacity) memory.  Entries carry a monotonically
    increasing sequence number so a reader can tell two snapshots apart
    even when the ring content looks identical.  Locked for the same
    reason as `Counter` (scheduler + watchdog + snapshot threads)."""

    def __init__(self, capacity: int = 16):
        from collections import deque

        assert capacity >= 1, capacity
        self.capacity = capacity
        self._items = deque(maxlen=capacity)
        self._seq = 0
        self._lock = sync.Lock()

    def add(self, message: str) -> None:
        with self._lock:
            self._seq += 1
            self._items.append((self._seq, str(message)))

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def total(self) -> int:
        """How many events were EVER added (>= len, which is bounded)."""
        with self._lock:
            return self._seq

    def snapshot(self) -> list:
        """JSON-friendly ``[{"seq": n, "message": s}, ...]``, oldest first."""
        with self._lock:
            return [{"seq": n, "message": m} for n, m in self._items]


# --------------------------------------------------------------------------
# Unified metrics plane: registry + SLO signals + HTTP exposition
# --------------------------------------------------------------------------


class Gauge:
    """A point-in-time value: either callback-backed (``fn`` sampled at
    read time — queue depth, cache residency) or set-backed (`set`).
    Locked for the set path; callback gauges read whatever their callable
    reads (the callable owns its own consistency)."""

    def __init__(self, fn: Optional[Callable[[], float]] = None):

        self._fn = fn
        self._value = 0.0
        self._lock = sync.Lock()

    def set(self, value: float) -> None:
        assert self._fn is None, "callback gauge cannot be set"
        with self._lock:
            self._value = float(value)

    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception:  # noqa: BLE001 — a dead callback must not
                # take down a metrics scrape; NaN is the honest answer
                return float("nan")
        with self._lock:
            return self._value

    def snapshot(self) -> float:
        return self.value()


class RollingQuantile:
    """Rolling-window latency quantiles over a fixed-size ring buffer.

    The SLO controller (ROADMAP item 3) steers on *recent* p50/p99 per
    SLO class — a lifetime histogram answers "how has this service ever
    behaved", not "is the SLO holding right now".  ``observe`` is O(1)
    (ring write + counter); ``quantile`` sorts a copy of the window
    (O(w log w) on the rare read path — w is small and scrape-rate, not
    request-rate).  Locked like the other serve metrics: request
    completions land from the scheduler thread and the staged decode
    worker concurrently.

    ``max_age_s`` (with ``clock``) bounds how long a sample steers the
    reads: a count-only ring is time-blind — after a burst, entries from
    minutes ago keep pinning the p99 an idle server reports, and a
    closed-loop controller would keep steering on load that no longer
    exists.  Observations older than ``max_age_s`` at read time are
    excluded from every quantile/snapshot (the ring still holds them;
    ``count`` stays the lifetime total, the snapshot's ``window`` is the
    LIVE sample count)."""

    def __init__(self, window: int = 512,
                 clock: Optional[Callable[[], float]] = None,
                 max_age_s: Optional[float] = None):
        import time as _time

        assert window >= 1, window
        assert max_age_s is None or max_age_s > 0, max_age_s
        self.window = window
        self.max_age_s = max_age_s
        self.clock = clock if clock is not None else _time.monotonic
        self._buf = np.zeros(window, np.float64)
        self._ts = np.zeros(window, np.float64)
        self._n = 0  # total ever observed
        self._lock = sync.Lock()

    def observe(self, v: float) -> None:
        t = self.clock() if self.max_age_s is not None else 0.0
        with self._lock:
            i = self._n % self.window
            self._buf[i] = float(v)
            self._ts[i] = t
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def _window_locked(self) -> np.ndarray:
        n = min(self._n, self.window)
        vals = self._buf[:n]
        if self.max_age_s is not None and n:
            vals = vals[self._ts[:n] >= self.clock() - self.max_age_s]
        return np.sort(vals.copy())

    @staticmethod
    def _rank(w: np.ndarray, q: float) -> float:
        """Nearest-rank value of sorted window ``w`` — the ONE indexing
        convention quantile() and snapshot() share."""
        return float(w[min(int(q * (w.size - 1) + 0.5), w.size - 1)])

    def quantile(self, q: float) -> float:
        assert 0.0 <= q <= 1.0, q
        with self._lock:
            w = self._window_locked()
        if w.size == 0:
            return float("nan")
        return self._rank(w, q)

    def snapshot(self) -> Dict[str, float]:
        """JSON-friendly window summary — the SLO-signal record shape
        (docs/OBSERVABILITY.md): total count, window fill, and the
        rolling p50/p90/p99.  Count and window come from the same lock
        hold, so the fields are mutually consistent."""
        with self._lock:
            w = self._window_locked()
            n = self._n
        if w.size == 0:
            # every sample may have AGED out of the window while the
            # lifetime total keeps counting — a monotonic counter must
            # never go backwards on an idle server
            return {"count": n, "window": 0}
        return {
            "count": n,
            "window": int(w.size),
            "mean": float(w.mean()),
            "p50": self._rank(w, 0.50),
            "p90": self._rank(w, 0.90),
            "p99": self._rank(w, 0.99),
        }


def _prom_name(name: str) -> str:
    """Sanitize a hierarchical metric name to the Prometheus charset."""
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() and ch.isascii()) or ch in "_:"
                   else "_")
    s = "".join(out)
    return s if not s[:1].isdigit() else "_" + s


def _prom_label_value(v) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r"\""))


def _prom_value(v) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 2**53:
        return str(int(f))
    return repr(f)


class MetricsRegistry:
    """One owner for every serving metric, under hierarchical names with
    labels — the unified plane `InferenceServer.metrics_snapshot()` and
    the ``--metrics_port`` endpoint render from.

    Helpers get-or-create (same name + labels returns the SAME instance,
    so e.g. the staged pipeline and the server share one histogram
    family); registering a different metric *object* under an existing
    (name, labels) raises — two writers silently splitting one identity
    is how dashboards lie.  Any object with a ``snapshot()`` (Counter,
    LatencyHistogram, GapTracker, RingLog, RollingQuantile, Gauge)
    registers via `register`.

    Rendering: `snapshot()` is the JSON form (one entry per (name,
    labels)); `to_prometheus()` is the text exposition format — counters
    as counter families (the multi-key `Counter` renders one sample per
    key under a ``key`` label), histograms and rolling windows as
    summaries (quantile label + _sum/_count), gauges and gap trackers as
    gauges.  RingLogs are JSON-only (free-text events have no place in
    the numeric exposition)."""

    def __init__(self):

        self._lock = sync.Lock()
        # name -> list of (labels_dict, metric); list keeps insertion
        # order so renders are stable
        self._families: Dict[str, list] = {}

    @staticmethod
    def _label_key(labels: Optional[Dict[str, str]]):
        return tuple(sorted((labels or {}).items()))

    def register(self, name: str, metric, labels: Optional[Dict] = None):
        """Register (or fetch) ``metric`` under (name, labels)."""
        assert name, "metric name must be non-empty"
        lk = self._label_key(labels)
        with self._lock:
            fam = self._families.setdefault(name, [])
            for lbls, m in fam:
                if self._label_key(lbls) == lk:
                    if m is not metric:
                        raise ValueError(
                            f"metric {name!r} with labels {dict(lk)} is "
                            "already registered to a different object"
                        )
                    return m
            fam.append((dict(labels or {}), metric))
            return metric

    def get(self, name: str, labels: Optional[Dict] = None):
        lk = self._label_key(labels)
        with self._lock:
            for lbls, m in self._families.get(name, []):
                if self._label_key(lbls) == lk:
                    return m
        return None

    def family(self, name: str):
        """Every (labels, metric) registered under ``name`` — lets a
        reader snapshot ONE family (e.g. the SLO windows) without
        rendering the whole registry."""
        with self._lock:
            return [(dict(lbls), m) for lbls, m in
                    self._families.get(name, [])]

    def _get_or_create(self, name, labels, factory, kind):
        existing = self.get(name, labels)
        if existing is None:
            try:
                existing = self.register(name, factory(), labels)
            except ValueError:
                # lost a creation race to another thread (e.g. two
                # workers both completing the first request of a new SLO
                # class): use whoever won
                existing = self.get(name, labels)
        if not isinstance(existing, kind):
            raise ValueError(
                f"metric {name!r} already registered as "
                f"{type(existing).__name__}, not {kind.__name__}"
            )
        return existing

    # typed get-or-create helpers.  A repeat call with DIFFERENT
    # construction parameters raises instead of silently handing back
    # the first instance — same rationale as the object-conflict check:
    # two writers thinking they own different configurations of one
    # identity is how dashboards lie.

    @staticmethod
    def _check_params(name, existing, requested: Dict[str, Any]) -> None:
        for attr, want in requested.items():
            have = getattr(existing, attr)
            if have != want and not (have is want):
                raise ValueError(
                    f"metric {name!r} already registered with "
                    f"{attr}={have!r}; a second registration requested "
                    f"{attr}={want!r}"
                )

    def counter(self, name: str, labels: Optional[Dict] = None) -> Counter:
        return self._get_or_create(name, labels, Counter, Counter)

    def histogram(self, name: str, labels: Optional[Dict] = None,
                  lo: float = 1e-4, hi: float = 1e3) -> LatencyHistogram:
        h = self._get_or_create(
            name, labels, lambda: LatencyHistogram(lo, hi), LatencyHistogram
        )
        self._check_params(name, h, {"lo": lo, "hi": hi})
        return h

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None,
              labels: Optional[Dict] = None) -> Gauge:
        g = self._get_or_create(name, labels, lambda: Gauge(fn), Gauge)
        if fn is not None and g._fn is not fn:
            raise ValueError(
                f"gauge {name!r} is already registered with a different "
                "callback — re-registering would silently drop one of them"
            )
        return g

    def rolling(self, name: str, window: int = 512,
                labels: Optional[Dict] = None,
                clock: Optional[Callable[[], float]] = None,
                max_age_s: Optional[float] = None) -> RollingQuantile:
        rq = self._get_or_create(
            name, labels,
            lambda: RollingQuantile(window, clock=clock, max_age_s=max_age_s),
            RollingQuantile,
        )
        self._check_params(name, rq, {"window": window,
                                      "max_age_s": max_age_s})
        if clock is not None and rq.clock is not clock:
            raise ValueError(
                f"rolling window {name!r} is already registered with a "
                "different clock — two time bases under one identity is "
                "how aging lies"
            )
        return rq

    def gap(self, name: str, labels: Optional[Dict] = None) -> GapTracker:
        return self._get_or_create(name, labels, GapTracker, GapTracker)

    def ring(self, name: str, capacity: int = 16,
             labels: Optional[Dict] = None) -> RingLog:
        r = self._get_or_create(
            name, labels, lambda: RingLog(capacity), RingLog
        )
        self._check_params(name, r, {"capacity": capacity})
        return r

    # renders ---------------------------------------------------------------

    def scoped(self, labels: Dict[str, str]) -> "ScopedRegistry":
        """A label-scoping view over this registry: every metric created
        or fetched through the view carries ``labels`` merged in.  The
        fleet layer (serve/fleet.py) gives each replica's server a
        ``{"replica": name}`` scope over ONE shared registry, so two
        replicas' otherwise-identical gauges land as distinct label sets
        instead of colliding."""
        return ScopedRegistry(self, labels)

    def unregister(self, name: str, labels: Optional[Dict] = None) -> bool:
        """Remove ONE (name, labels) registration; True if it existed.
        For callback-backed gauges being handed to a successor owner
        (e.g. a rebuilt FleetRouter over the same shared registry) —
        get-or-create would return the predecessor's stale closure, and
        re-registering would conflict."""
        lk = self._label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if not fam:
                return False
            keep = [(l, m) for l, m in fam if self._label_key(l) != lk]
            if len(keep) == len(fam):
                return False
            if keep:
                self._families[name] = keep
            else:
                del self._families[name]
            return True

    def prune(self, labels: Dict[str, str]) -> int:
        """Unregister every metric whose labels carry ALL of ``labels``;
        returns how many were removed.  A restarted fleet replica prunes
        its previous server generation's scope here — without this, each
        generation's gauges (whose closures pin the dead server) would
        accumulate in the shared registry forever."""
        want = {str(k): str(v) for k, v in labels.items()}
        removed = 0
        with self._lock:
            for name in list(self._families):
                fam = self._families[name]
                keep = [
                    (lbls, m) for lbls, m in fam
                    if not all(lbls.get(k) == v for k, v in want.items())
                ]
                removed += len(fam) - len(keep)
                if keep:
                    self._families[name] = keep
                else:
                    del self._families[name]
        return removed

    def _items(self):
        with self._lock:
            return [
                (name, dict(lbls), m)
                for name, fam in sorted(self._families.items())
                for lbls, m in fam
            ]

    def snapshot(self) -> Dict[str, Any]:
        """JSON snapshot: ``{name: [{"labels": {...}, "type": ...,
        "data": snapshot()}, ...]}`` — one stable shape for artifacts and
        the ``/metrics.json`` endpoint."""
        out: Dict[str, Any] = {}
        for name, lbls, m in self._items():
            out.setdefault(name, []).append({
                "labels": lbls,
                "type": type(m).__name__,
                "data": m.snapshot(),
            })
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (version 0.0.4)."""
        lines: list = []
        typed: set = set()

        def labelstr(lbls: Dict[str, str], extra: Dict[str, str] = None):
            merged = dict(lbls)
            if extra:
                merged.update(extra)
            if not merged:
                return ""
            body = ",".join(
                f'{_prom_name(k)}="{_prom_label_value(v)}"'
                for k, v in sorted(merged.items())
            )
            return "{" + body + "}"

        def emit_type(pname: str, kind: str):
            if pname not in typed:
                typed.add(pname)
                lines.append(f"# TYPE {pname} {kind}")

        for name, lbls, m in self._items():
            pname = _prom_name(name)
            if isinstance(m, Counter):
                emit_type(pname, "counter")
                for key, v in m.snapshot().items():
                    lines.append(
                        f"{pname}{labelstr(lbls, {'key': key})} "
                        f"{_prom_value(v)}"
                    )
            elif isinstance(m, (LatencyHistogram, RollingQuantile)):
                emit_type(pname, "summary")
                snap = m.snapshot()
                for q, qv in (("0.5", "p50"), ("0.9", "p90"),
                              ("0.99", "p99")):
                    if qv in snap:
                        lines.append(
                            f"{pname}{labelstr(lbls, {'quantile': q})} "
                            f"{_prom_value(snap[qv])}"
                        )
                if isinstance(m, LatencyHistogram):
                    # _sum comes from the SAME locked snapshot as the
                    # count/quantiles — no torn cross-field reads
                    lines.append(f"{pname}_sum{labelstr(lbls)} "
                                 f"{_prom_value(snap.get('sum', 0.0))}")
                lines.append(f"{pname}_count{labelstr(lbls)} "
                             f"{_prom_value(snap.get('count', 0))}")
            elif isinstance(m, GapTracker):
                snap = m.snapshot()
                for field in ("gap_fraction", "busy_s", "span_s",
                              "intervals"):
                    sub = f"{pname}_{field}"
                    emit_type(sub, "gauge")
                    lines.append(f"{sub}{labelstr(lbls)} "
                                 f"{_prom_value(snap[field])}")
            elif isinstance(m, Gauge):
                emit_type(pname, "gauge")
                lines.append(f"{pname}{labelstr(lbls)} "
                             f"{_prom_value(m.value())}")
            elif isinstance(m, RingLog):
                continue  # free-text events: JSON render only
            else:  # generic snapshot()-bearing object: flatten numerics
                snap = m.snapshot()
                if isinstance(snap, dict):
                    for k, v in snap.items():
                        if isinstance(v, (int, float)):
                            sub = f"{pname}_{_prom_name(str(k))}"
                            emit_type(sub, "gauge")
                            lines.append(f"{sub}{labelstr(lbls)} "
                                         f"{_prom_value(v)}")
        return "\n".join(lines) + ("\n" if lines else "")


class ScopedRegistry:
    """A label-injecting proxy over one `MetricsRegistry`.

    Every typed helper (`counter`/`histogram`/`gauge`/`rolling`/`gap`/
    `ring`/`register`/`get`) merges the scope labels into the call's
    labels before delegating, so code written against a plain registry
    (the server, the staged pipeline, the controller) namespaces itself
    per replica without knowing the fleet exists.  `family` filters to
    entries whose labels carry the scope, so per-replica readers (e.g.
    `InferenceServer.slo_snapshot`) never see a sibling replica's
    windows.  `snapshot`/`to_prometheus` render the WHOLE base registry —
    one scrape surface for the fleet, which is the point of sharing it.
    """

    def __init__(self, base: "MetricsRegistry", labels: Dict[str, str]):
        # flatten nested scopes so .base is always the real registry
        scope: Dict[str, str] = {}
        while isinstance(base, ScopedRegistry):
            merged = dict(base.scope)
            merged.update(scope)
            scope = merged
            base = base.base
        scope.update({str(k): str(v) for k, v in (labels or {}).items()})
        self.base = base
        self.scope = scope

    def _merged(self, labels: Optional[Dict]) -> Dict[str, str]:
        merged = dict(self.scope)
        merged.update(labels or {})
        return merged

    def scoped(self, labels: Dict[str, str]) -> "ScopedRegistry":
        return ScopedRegistry(self, labels)

    def register(self, name: str, metric, labels: Optional[Dict] = None):
        return self.base.register(name, metric, self._merged(labels))

    def get(self, name: str, labels: Optional[Dict] = None):
        return self.base.get(name, self._merged(labels))

    def counter(self, name: str, labels: Optional[Dict] = None) -> Counter:
        return self.base.counter(name, self._merged(labels))

    def histogram(self, name: str, labels: Optional[Dict] = None,
                  lo: float = 1e-4, hi: float = 1e3) -> LatencyHistogram:
        return self.base.histogram(name, self._merged(labels), lo=lo, hi=hi)

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None,
              labels: Optional[Dict] = None) -> Gauge:
        return self.base.gauge(name, fn, self._merged(labels))

    def rolling(self, name: str, window: int = 512,
                labels: Optional[Dict] = None,
                clock: Optional[Callable[[], float]] = None,
                max_age_s: Optional[float] = None) -> RollingQuantile:
        return self.base.rolling(name, window, self._merged(labels),
                                 clock=clock, max_age_s=max_age_s)

    def gap(self, name: str, labels: Optional[Dict] = None) -> GapTracker:
        return self.base.gap(name, self._merged(labels))

    def ring(self, name: str, capacity: int = 16,
             labels: Optional[Dict] = None) -> RingLog:
        return self.base.ring(name, capacity, self._merged(labels))

    def family(self, name: str):
        """Only the base-family entries carrying this scope's labels."""
        return [
            (lbls, m) for lbls, m in self.base.family(name)
            if all(lbls.get(k) == v for k, v in self.scope.items())
        ]

    def unregister(self, name: str, labels: Optional[Dict] = None) -> bool:
        return self.base.unregister(name, self._merged(labels))

    def prune(self, labels: Optional[Dict] = None) -> int:
        return self.base.prune(self._merged(labels))

    def snapshot(self) -> Dict[str, Any]:
        return self.base.snapshot()

    def to_prometheus(self) -> str:
        return self.base.to_prometheus()


class MetricsHTTPEndpoint:
    """Stdlib-only HTTP exposition for a metrics plane:

    * ``GET /metrics`` — Prometheus text (``prom()``);
    * ``GET /metrics.json`` — the JSON snapshot (``json_snapshot()``);
    * ``GET /healthz`` — the health callback (503 when its ``status``
      is not "ok"/"degraded" — liveness stays cheap and JSON).

    ``port=0`` binds an ephemeral port (read ``.port`` after `start`).
    The server plumbing (SO_REUSEADDR-safe rebind on replica restart,
    bounded handler threads, deterministic shutdown) lives in
    `serve/httpbase.HTTPServerHost`, shared with the generation gateway;
    scrapes never touch the scheduler thread, and all three callbacks
    must therefore be any-thread-safe (the serve snapshots are, by
    construction)."""

    def __init__(self, *, prom: Callable[[], str],
                 json_snapshot: Optional[Callable[[], Dict]] = None,
                 health: Optional[Callable[[], Dict]] = None,
                 port: int = 0, host: str = "127.0.0.1"):
        self._prom = prom
        self._json = json_snapshot
        self._health = health
        self.host = host
        self.port = int(port)
        self._host = None

    def start(self) -> "MetricsHTTPEndpoint":
        import http.server
        import json as json_mod

        # lazy: utils.metrics is imported by the serve package, so a
        # module-level import of serve.httpbase would be circular
        from ..serve.httpbase import HTTPServerHost

        endpoint = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # noqa: D102 — scrape spam
                pass

            def _send(self, code: int, body: str, ctype: str):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):  # noqa: N802 — stdlib name
                try:
                    if self.path in ("/metrics", "/metrics/"):
                        self._send(200, endpoint._prom(),
                                   "text/plain; version=0.0.4")
                    elif self.path == "/metrics.json" and endpoint._json:
                        self._send(
                            200,
                            json_mod.dumps(endpoint._json(), sort_keys=True),
                            "application/json")
                    elif self.path == "/healthz" and endpoint._health:
                        h = endpoint._health()
                        ok = h.get("status") in ("ok", "degraded")
                        self._send(200 if ok else 503,
                                   json_mod.dumps(h, sort_keys=True),
                                   "application/json")
                    else:
                        self._send(404, "not found\n", "text/plain")
                except Exception as exc:  # noqa: BLE001 — scrape != crash
                    try:
                        self._send(500, f"{type(exc).__name__}: {exc}\n",
                                   "text/plain")
                    except Exception:
                        pass

        self._host = HTTPServerHost(
            Handler, host=self.host, port=self.port,
            thread_name="distrifuser-metrics-http",
        ).start()
        self.port = self._host.port
        return self

    def stop(self) -> None:
        if self._host is not None:
            self._host.stop()
            self._host = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
