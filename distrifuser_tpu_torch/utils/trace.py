"""Request-scoped tracing: spans, events, and Perfetto-loadable export.

`Tracer` records the life of every request through the serve layer
(enqueue, queue wait, coalescing into a micro-batch, executor cache
hit/miss/build, retry attempts, breaker/ladder events, execution,
completion) as spans and instant events on named tracks.
`StepTimeline` is the per-denoise-step view inside one generation.

Design constraints, in order:

* **Deterministic** -- the clock is injectable, every id comes from
  tracer-local counters (never the process-global request id), and
  `export()` orders events by (timestamp, sequence) with stable JSON
  serialization: same injected clock + same call sequence => byte-identical
  export.
* **Bounded** -- completed records land in a ring (``capacity``); a
  service that has traced a million requests still answers "what happened
  *lately*" in O(capacity) memory, with the drop count reported, never
  silent (`RingLog` convention).
* **Zero cost when off** -- the serve layer holds ``tracer = None`` when
  tracing is disabled and guards every call site, so the tracing-off
  request path executes no tracing code at all.

Export is the Chrome/Perfetto trace-event JSON format
(``{"traceEvents": [...]}``, "X"/"B"/"i"/"s"/"f" phases): load the file
at https://ui.perfetto.dev or chrome://tracing.  Tracks are logical
(``req/<trace>``, ``scheduler``, ``cache``, ``resilience``), not OS
threads -- each maps to a synthetic tid with a thread_name metadata
record, so the UI shows one swimlane per logical actor.
"""

from __future__ import annotations

import dataclasses
import json
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from . import sync

# One synthetic process for the whole service; tracks are "threads".
_PID = 1


def _us(t: float) -> int:
    """Seconds (clock domain) -> integer microseconds (trace domain).
    Integer so serialization is exact and exports byte-stable."""
    return int(round(t * 1e6))


@dataclasses.dataclass
class RequestTrace:
    """The per-request handle the serve layer stashes on `Request.trace`:
    the tracer-local trace id, the request's track name, and the span ids
    the lifecycle hooks close later.  Tracer-local ids (NOT the process-
    global request_id) keep exports deterministic across runs."""

    trace_id: int
    track: str
    root: int
    queue_span: Optional[int] = None
    flow_id: Optional[int] = None
    done: bool = False


class Tracer:
    """Bounded, thread-safe span/event recorder (module docstring).

    ``begin``/``end`` bracket open spans (cross-thread: begin on the
    submit thread, end on the scheduler thread); ``complete`` records a
    span whose start/end times are already known; ``event`` records an
    instant.  ``trace`` groups records belonging to one request;
    ``track`` picks the swimlane.  All timestamps come from the injected
    ``clock`` unless passed explicitly (same domain).
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 capacity: int = 8192):
        assert capacity >= 1, capacity
        self.clock = clock
        self.capacity = capacity
        self._lock = sync.Lock()
        self._records: deque = deque()
        self._open: Dict[int, Dict[str, Any]] = {}
        self._next_trace = 0
        self._next_span = 0
        self._next_seq = 0
        self._next_flow = 0
        self.dropped = 0
        self._t0 = clock()  # export origin: traces start near ts=0

    # -- id allocation ------------------------------------------------------

    def new_trace(self) -> int:
        with self._lock:
            self._next_trace += 1
            return self._next_trace

    def new_flow(self) -> int:
        with self._lock:
            self._next_flow += 1
            return self._next_flow

    # -- recording ----------------------------------------------------------

    def _push(self, rec: Dict[str, Any]) -> None:
        """Append one finished record to the ring (caller holds no lock)."""
        with self._lock:
            rec["seq"] = self._next_seq
            self._next_seq += 1
            if len(self._records) >= self.capacity:
                self._records.popleft()
                self.dropped += 1
            self._records.append(rec)

    def begin(self, name: str, *, track: str, trace: Optional[int] = None,
              parent: Optional[int] = None, args: Optional[dict] = None,
              t: Optional[float] = None) -> int:
        """Open a span; returns its id for `end`.  ``parent`` is another
        span id, recorded in args for structural assertions (the UI nests
        by track + time containment)."""
        with self._lock:
            self._next_span += 1
            sid = self._next_span
            self._open[sid] = {
                "name": name, "track": track, "trace": trace,
                "parent": parent, "t0": self.clock() if t is None else t,
                "args": dict(args or {}),
            }
        return sid

    def end(self, span_id: Optional[int], args: Optional[dict] = None,
            t: Optional[float] = None) -> None:
        """Close a span opened by `begin` (tolerates None/unknown ids —
        a raced double-close must never take down the scheduler)."""
        if span_id is None:
            return
        with self._lock:
            sp = self._open.pop(span_id, None)
        if sp is None:
            return
        t1 = self.clock() if t is None else t
        a = sp["args"]
        if args:
            a.update(args)
        self._emit_span(sp["name"], sp["track"], sp["trace"], sp["parent"],
                        span_id, sp["t0"], t1, a)

    def complete(self, name: str, t0: float, t1: float, *, track: str,
                 trace: Optional[int] = None, parent: Optional[int] = None,
                 args: Optional[dict] = None) -> int:
        """Record a span whose start/end are already measured (e.g. the
        executor invocation window the dispatch path timed anyway)."""
        with self._lock:
            self._next_span += 1
            sid = self._next_span
        self._emit_span(name, track, trace, parent, sid, t0, t1,
                        dict(args or {}))
        return sid

    def _emit_span(self, name, track, trace, parent, sid, t0, t1, args):
        a = dict(args)
        if trace is not None:
            a["trace"] = trace
        if parent is not None:
            a["parent"] = parent
        a["span"] = sid
        self._push({
            "ph": "X", "name": name, "track": track,
            "ts": _us(t0 - self._t0), "dur": max(0, _us(t1 - t0)),
            "args": a,
        })

    def event(self, name: str, *, track: str, trace: Optional[int] = None,
              args: Optional[dict] = None, t: Optional[float] = None) -> None:
        """Instant event on a track."""
        a = dict(args or {})
        if trace is not None:
            a["trace"] = trace
        self._push({
            "ph": "i", "name": name, "track": track,
            "ts": _us((self.clock() if t is None else t) - self._t0),
            "s": "t", "args": a,
        })

    def flow(self, flow_id: int, phase: str, *, track: str,
             t: Optional[float] = None, name: str = "link") -> None:
        """One end of a flow arrow (``phase`` "s" = start, "f" = finish):
        the serve layer draws batch-span -> member-request links with
        these.  Timestamps must fall inside an enclosing slice on the
        same track for the UI to anchor the arrow."""
        assert phase in ("s", "f"), phase
        rec: Dict[str, Any] = {
            "ph": phase, "name": name, "track": track, "id": flow_id,
            "ts": _us((self.clock() if t is None else t) - self._t0),
        }
        if phase == "f":
            rec["bp"] = "e"
        self._push(rec)

    # -- export -------------------------------------------------------------

    def records(self) -> List[Dict[str, Any]]:
        """Finished records, oldest first (copies — safe to mutate)."""
        with self._lock:
            return [dict(r) for r in self._records]

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "records": len(self._records),
                "dropped": self.dropped,
                "open_spans": len(self._open),
                "capacity": self.capacity,
                "traces": self._next_trace,
            }

    def trace_events(self) -> List[Dict[str, Any]]:
        """The Chrome trace-event list: metadata (track names) first, then
        every record ordered by (ts, seq) with tracks mapped to synthetic
        tids by sorted name — deterministic regardless of which thread
        registered a track first."""
        with self._lock:
            records = [dict(r) for r in self._records]
            open_spans = [
                (sid, dict(sp)) for sid, sp in sorted(self._open.items())
            ]
        # un-ended spans surface as "B" (begin-only) records so a trace
        # snapshotted mid-request still shows the in-flight work
        for sid, sp in open_spans:
            a = dict(sp["args"])
            if sp["trace"] is not None:
                a["trace"] = sp["trace"]
            if sp["parent"] is not None:
                a["parent"] = sp["parent"]
            a["span"] = sid
            records.append({
                "ph": "B", "name": sp["name"], "track": sp["track"],
                "ts": _us(sp["t0"] - self._t0), "args": a,
                "seq": 10**9 + sid,  # after every finished record at its ts
            })
        tracks = sorted({r["track"] for r in records})
        tids = {name: i + 1 for i, name in enumerate(tracks)}
        events: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": _PID, "tid": 0,
             "args": {"name": "distrifuser-serve"}},
        ]
        for name in tracks:
            events.append({
                "ph": "M", "name": "thread_name", "pid": _PID,
                "tid": tids[name], "args": {"name": name},
            })
        for r in sorted(records, key=lambda r: (r["ts"], r["seq"])):
            e = {k: v for k, v in r.items() if k not in ("track", "seq")}
            e["pid"] = _PID
            e["tid"] = tids[r["track"]]
            events.append(e)
        return events

    def export(self, path: Optional[str] = None) -> Dict[str, Any]:
        """The Perfetto-loadable payload; with ``path``, also written to
        disk with stable formatting (sorted keys, no whitespace churn) so
        deterministic runs produce byte-identical files."""
        payload = {"traceEvents": self.trace_events(),
                   "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(payload, f, sort_keys=True,
                          separators=(",", ":"))
                f.write("\n")
        return payload


# StepTimeline phase tags -> pipelines.comm_plan / stepcache phase keys
PHASE_TO_COMM = {"warmup": "sync", "full": "stale", "shallow": "shallow"}


class StepTimeline:
    """Wall-time and live comm-byte accounting per denoise step.

    Attach to a pipeline (``pipeline.step_timeline = StepTimeline()``) and
    every generation records one run: per-step wall timings tagged
    ``warmup``/``full``/``shallow`` (the step-cache cadence phases), plus
    a live comm-byte counter that adds each *executed* step's wire bytes
    from the runner's per-phase byte model as the loop advances.  Because
    the closed-form ``pipelines.comm_plan`` multiplies the same per-step
    bytes by `stepcache.phase_step_counts`, the two agree exactly iff the
    loop really executed the phase sequence the plan predicts — the byte
    model becomes a checked invariant instead of documentation
    (tests/test_torch_port_stepbatch.py pins it).

    Driven by the per-step callback, which the denoise loop fires after
    every step (eagerly or between graph replays).  Single writer (the
    loop thread); ``snapshot()`` is read-anywhere.

    ``tracer``/``track`` optionally mirror every step into a `Tracer` as
    ``step/<phase>`` spans, putting the denoise micro-timeline on the
    same Perfetto timeline as the request spans around it.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 tracer: Optional[Tracer] = None, track: str = "denoise"):
        self.clock = clock
        self.tracer = tracer
        self.track = track
        self._lock = sync.Lock()
        self.runs: List[Dict[str, Any]] = []
        self._cur: Optional[Dict[str, Any]] = None
        self._phase_of: Optional[Callable[[int], str]] = None
        self._bytes_per_step: Dict[str, int] = {}
        self._t_last = 0.0

    def begin_run(self, num_steps: int,
                  phase_of: Callable[[int], str],
                  bytes_per_step: Optional[Dict[str, int]] = None,
                  meta: Optional[dict] = None) -> None:
        """Start recording one generation: ``phase_of(i)`` tags each step
        (the pipeline passes the exact cadence arithmetic the loop runs);
        ``bytes_per_step`` is comm_plan's per-phase wire-byte model keyed
        ``sync``/``stale``/``shallow`` (None = bytes untracked, e.g. a
        runner without a byte model)."""
        with self._lock:
            self._cur = {
                "num_steps": int(num_steps),
                "steps": [],
                "phase_steps": {"warmup": 0, "full": 0, "shallow": 0},
                "phase_wall_s": {"warmup": 0.0, "full": 0.0, "shallow": 0.0},
                "comm_bytes": 0,
                "comm_bytes_tracked": bytes_per_step is not None,
                "meta": dict(meta or {}),
            }
            self._phase_of = phase_of
            self._bytes_per_step = dict(bytes_per_step or {})
            self._t_last = self.clock()

    def on_step(self, i: int) -> None:
        """Record step ``i`` finishing now (the per-step callback)."""
        t = self.clock()
        with self._lock:
            cur = self._cur
            if cur is None:
                return
            phase = self._phase_of(int(i))
            dt = t - self._t_last
            cur["steps"].append(
                {"step": int(i), "phase": phase, "wall_s": dt}
            )
            cur["phase_steps"][phase] += 1
            cur["phase_wall_s"][phase] += dt
            cur["comm_bytes"] += int(
                self._bytes_per_step.get(PHASE_TO_COMM[phase], 0)
            )
            t_prev, self._t_last = self._t_last, t
        if self.tracer is not None:
            self.tracer.complete(f"step/{phase}", t_prev, t,
                                 track=self.track, args={"step": int(i)})

    def end_run(self) -> None:
        with self._lock:
            if self._cur is not None:
                self.runs.append(self._cur)
                self._cur = None

    # -- reads --------------------------------------------------------------

    @property
    def comm_bytes(self) -> int:
        """Live wire bytes across every completed run (per device,
        gathered-buffer convention — the same unit as comm_plan)."""
        with self._lock:
            return sum(r["comm_bytes"] for r in self.runs)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-friendly aggregate: per-phase step counts and wall time
        across runs, live comm bytes, and the per-run records."""
        with self._lock:
            runs = [dict(r) for r in self.runs]
        agg_steps = {"warmup": 0, "full": 0, "shallow": 0}
        agg_wall = {"warmup": 0.0, "full": 0.0, "shallow": 0.0}
        for r in runs:
            for ph in agg_steps:
                agg_steps[ph] += r["phase_steps"][ph]
                agg_wall[ph] += r["phase_wall_s"][ph]
        return {
            "runs": len(runs),
            "phase_steps": agg_steps,
            "phase_wall_s": agg_wall,
            "comm_bytes": sum(r["comm_bytes"] for r in runs),
            "comm_bytes_tracked": all(
                r["comm_bytes_tracked"] for r in runs) if runs else False,
            "per_run": runs,
        }
