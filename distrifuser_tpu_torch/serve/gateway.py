"""The streaming HTTP/SSE front end over ``submit()`` (the JAX package's
serve/gateway.py).

What the serve plane does at step granularity (mid-denoise join/leave,
previews, preemption) reaches a client through an in-process callback;
this module is the wire.  Stdlib-only, riding the shared
`serve/httpbase.HTTPServerHost` plumbing:

* ``POST /v1/generate`` — JSON body (``prompt`` required; ``steps``,
  ``seed``, ``height``, ``width``, ``negative_prompt``,
  ``guidance_scale``, ``slo_class``, ``deadline`` (TTL seconds),
  ``tenant`` optional) → ``202 {"id": ...}``.
* ``GET /v1/requests/<id>/events`` — SSE stream: ``queued`` →
  ``preview``\\* (base64 downsampled latents via the
  ``on_progress`` hook, plus step/total progress) → exactly one
  terminal ``final`` / ``error`` / ``cancelled`` event.
* ``GET /v1/requests/<id>`` — poll the same state as JSON.
* ``POST /v1/requests/<id>/cancel`` — the existing future-cancel path.

Typed serve errors render as structured JSON with the matching HTTP
status: 429 for the capacity/quota family (`QueueFullError`,
`AdmissionRejectedError`, `TenantQuotaError`), 504 for deadline lapse,
503 on drain/circuit/no-replica, 400 for malformed requests, 404 for
unknown ids.

**Transport/state split.**  The `Gateway` core (connection table, event
buffers, submit/cancel/status/stream logic) never touches a socket: the
HTTP handler is a thin translation over `handle_generate` /
`handle_status` / `handle_cancel` / `next_events`, and socket-free
callers (tests) drive those same core methods directly.

**Backpressure.**  ``on_progress`` fires on the SCHEDULER thread and
must never block: each request's events land in a bounded drop-OLDEST
deque (``GatewayConfig.max_events``), so a slow or absent SSE consumer
costs dropped preview frames (counted in ``gateway_preview_drops``),
never scheduler time.  Terminal events are never dropped.

Works over an `InferenceServer` or a `FleetRouter` unchanged — the
backend contract is just ``submit(**params) -> Future``, so a
fleet-fronted gateway routes through failover untouched.

Images cross the wire as raw bytes with their shape and dtype name, as in
the JAX package: a served numpy array as it is, a tensor (on the card or
not) copied to the host first, and a bfloat16 tensor as its raw 2-byte
words under the dtype name ``"bfloat16"`` (the bytes a JAX bf16 array
gives), which `decode_image` turns back into a bfloat16 tensor, since
numpy has no such type.
"""

from __future__ import annotations

import base64
import itertools
import json
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils import sync
from ..utils.config import GatewayConfig
from ..utils.metrics import Counter
from .errors import (
    AdmissionRejectedError,
    CircuitOpenError,
    DeadlineExceededError,
    FatalError,
    NoBucketError,
    NoHealthyReplicaError,
    QueueFullError,
    RetryableError,
    ServeError,
    ServerClosedError,
    TenantQuotaError,
    WatchdogTimeoutError,
)

#: the gateway's trace track: submit, stream
#: open/close, cancel, and terminal outcomes as instant events
GATEWAY_TRACK = "gateway"

#: typed serve error -> HTTP status (subclass-aware via _error_status)
_STATUS_BY_TYPE: Tuple[Tuple[type, int], ...] = (
    (TenantQuotaError, 429),
    (QueueFullError, 429),
    (AdmissionRejectedError, 429),
    (DeadlineExceededError, 504),
    (WatchdogTimeoutError, 504),
    (ServerClosedError, 503),
    (CircuitOpenError, 503),
    (NoHealthyReplicaError, 503),
    (NoBucketError, 400),
)


def _error_status(exc: BaseException) -> int:
    for etype, status in _STATUS_BY_TYPE:
        if isinstance(exc, etype):
            return status
    if isinstance(exc, (ValueError, TypeError, KeyError)):
        return 400
    return 500


def _error_body(exc: BaseException) -> Dict[str, Any]:
    """The structured-JSON rendering of a typed serve error."""
    return {
        "error": type(exc).__name__,
        "message": str(exc),
        "retryable": isinstance(exc, RetryableError),
        "fatal": isinstance(exc, FatalError),
    }


def encode_image(arr: Any) -> Dict[str, Any]:
    """Lossless wire form of an image array: raw bytes base64'd plus the
    (shape, dtype) needed to reconstruct it exactly — `decode_image` of
    the payload is byte-identical to the in-process array.  A tensor is
    copied to the host first; a bfloat16 one travels as its raw 2-byte
    words under the name ``"bfloat16"``."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            raw, dtype = t.view(torch.int16).numpy().tobytes(), "bfloat16"
        else:
            raw, dtype = t.numpy().tobytes(), str(t.numpy().dtype)
        shape = t.shape
    else:
        a = np.asarray(arr)
        raw, dtype, shape = a.tobytes(), str(a.dtype), a.shape
    return {
        "image_b64": base64.b64encode(raw).decode("ascii"),
        "shape": [int(s) for s in shape],
        "dtype": dtype,
    }


def decode_image(payload: Dict[str, Any]) -> Any:
    """Inverse of `encode_image` (clients, tests): a numpy array, or a
    bfloat16 tensor for the ``"bfloat16"`` dtype numpy does not have."""
    raw = base64.b64decode(payload["image_b64"])
    if payload["dtype"] == "bfloat16":
        words = np.frombuffer(raw, dtype=np.int16).reshape(payload["shape"])
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    return np.frombuffer(raw, dtype=payload["dtype"]).reshape(
        payload["shape"])


def sse_format(name: str, data: Dict[str, Any]) -> bytes:
    """One server-sent event on the wire."""
    return (f"event: {name}\ndata: {json.dumps(data, sort_keys=True)}"
            "\n\n").encode()


class _GatewayRequest:
    """One HTTP-submitted generation's connection-table entry: the
    bounded event buffer SSE consumers drain, plus the retained terminal
    state polling reads.

    All mutation happens inside this lock; the entry itself is handed across threads via
    the gateway's table lock.  ``push`` is called from the scheduler
    thread (previews, done-callback) and NEVER blocks: overflow drops
    the OLDEST non-terminal event and counts it.
    """

    def __init__(self, rid: str, tenant: str, max_events: int,
                 clock: Callable[[], float]):
        self.id = rid
        self.tenant = tenant
        self.max_events = max(2, int(max_events))
        self.created_ts = clock()
        self.future = None  # set once by handle_generate before sharing
        self._lock = sync.Lock()
        self._cond = sync.Condition(self._lock)
        self._events: List[Tuple[int, str, Dict[str, Any]]] = []
        self._next_seq = 0
        self.dropped = 0
        self.done = False      # a terminal event was pushed
        self.closed = False    # gateway stop: streams must resolve NOW
        self.outcome = "pending"
        self.result: Optional[Dict[str, Any]] = None
        self.error: Optional[Dict[str, Any]] = None

    def push(self, name: str, data: Dict[str, Any]) -> int:
        """Append one event; returns how many buffered events were
        dropped to make room (0 or 1).  No-op after a terminal event."""
        with self._lock:
            if self.done:
                return 0
            self._events.append((self._next_seq, name, data))
            self._next_seq += 1
            ndropped = 0
            if len(self._events) > self.max_events:
                self._events.pop(0)
                self.dropped += 1
                ndropped = 1
            self._cond.notify_all()
            return ndropped

    def finish(self, name: str, data: Dict[str, Any], *,
               outcome: str, result: Optional[Dict[str, Any]] = None,
               error: Optional[Dict[str, Any]] = None) -> bool:
        """Push the terminal event and retain the terminal state; False
        if a terminal event already landed (exactly-one-terminal: the
        done-callback is the only caller, but cancel/final/stop races
        must collapse to one winner)."""
        with self._lock:
            if self.done:
                return False
            self._events.append((self._next_seq, name, data))
            self._next_seq += 1
            if len(self._events) > self.max_events:
                # never drop the terminal event itself — evict the
                # oldest NON-terminal instead (index 0 cannot be the
                # event just appended: max_events >= 2)
                self._events.pop(0)
                self.dropped += 1
            self.done = True
            self.outcome = outcome
            self.result = result
            self.error = error
            self._cond.notify_all()
            return True

    def close(self) -> None:
        """Gateway stop: resolve every stream on this entry — consumers
        wake, drain what is buffered, and terminate."""
        with self._lock:
            self.closed = True
            self._cond.notify_all()

    def next_events(self, cursor: int,
                    timeout: float) -> Tuple[List[Tuple[int, str, Dict]],
                                             bool]:
        """Events with sequence > ``cursor`` (gaps mean drops), waiting
        up to ``timeout`` for news; the flag is True when the stream is
        resolved (terminal event pushed, or entry closed) — the consumer
        exits once it has drained with the flag set."""
        with self._lock:
            evs = [e for e in self._events if e[0] > cursor]
            if not evs and not self.done and not self.closed:
                self._cond.wait(timeout)
                evs = [e for e in self._events if e[0] > cursor]
            return evs, (self.done or self.closed)

    def status(self) -> Dict[str, Any]:
        with self._lock:
            out = {
                "id": self.id,
                "tenant": self.tenant,
                "status": self.outcome,
                "dropped_previews": self.dropped,
            }
            if self.result is not None:
                out["result"] = self.result
            if self.error is not None:
                out["error"] = self.error
            return out


class Gateway:
    """The serving gateway: connection table + HTTP/SSE transport over
    any ``submit()`` backend (`InferenceServer` or `FleetRouter`).

    Construct, then `start` to bind the socket — or skip `start`
    entirely and drive the ``handle_*``/`next_events` core directly
    (tests).  `stop` is deterministic: no new
    submissions, every open SSE stream resolves, the listener closes.
    """

    def __init__(self, backend: Any, *,
                 config: Optional[GatewayConfig] = None,
                 registry: Any = None, tracer: Any = None,
                 clock: Callable[[], float] = time.monotonic):
        self.backend = backend
        self.config = config or GatewayConfig()
        self.tracer = tracer
        self.clock = clock
        self._lock = sync.Lock()
        self._requests: Dict[str, _GatewayRequest] = {}
        self._stopping = False
        self._ids = itertools.count()
        self._http = None
        if registry is not None:
            self.counters = registry.counter("gateway_requests")
            self._drops = registry.counter("gateway_preview_drops")
            registry.gauge("gateway_open_requests",
                           lambda: float(self.open_requests()))
        else:
            self.counters = Counter()
            self._drops = Counter()

    # -- core (socket-free: tests drive these) ------------------------------

    def open_requests(self) -> int:
        """Entries whose terminal event has not landed yet."""
        with self._lock:
            entries = list(self._requests.values())
        return sum(1 for gr in entries if not gr.done)

    def _trace_event(self, name: str, **args: Any) -> None:
        if self.tracer is not None:
            self.tracer.event(name, track=GATEWAY_TRACK, args=args)

    def _get(self, rid: str) -> Optional[_GatewayRequest]:
        with self._lock:
            return self._requests.get(rid)

    def _register(self, gr: _GatewayRequest) -> None:
        with self._lock:
            self._requests[gr.id] = gr
            # retention: evict oldest FINISHED entries beyond the bound;
            # pending entries are never evicted (their streams/futures
            # are live)
            excess = len(self._requests) - self.config.max_requests
            if excess > 0:
                for rid in [r for r, g in self._requests.items()
                            if g.done][:excess]:
                    del self._requests[rid]

    def handle_generate(self, body: Any) -> Tuple[int, Dict[str, Any]]:
        """``POST /v1/generate`` core: validate, submit to the backend,
        register the entry.  Returns ``(http_status, json_payload)`` —
        never raises for request-shaped problems."""
        with self._lock:
            if self._stopping:
                return 503, _error_body(
                    ServerClosedError("gateway is draining"))
        if not isinstance(body, dict):
            return 400, _error_body(ValueError("request body must be a "
                                               "JSON object"))
        prompt = body.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            return 400, _error_body(ValueError(
                "'prompt' (non-empty string) is required"))
        try:
            height = int(body.get("height", 512))
            width = int(body.get("width", 512))
            steps = (int(body["steps"]) if "steps" in body else None)
            seed = int(body.get("seed", 0))
            guidance = float(body.get("guidance_scale", 5.0))
            negative = str(body.get("negative_prompt", ""))
            slo_class = str(body.get("slo_class", "default"))
            tenant = str(body.get("tenant",
                                  self.config.default_tenant))
            ttl_s = (float(body["deadline"]) if "deadline" in body
                     else None)
        except (TypeError, ValueError, KeyError) as exc:
            return 400, _error_body(ValueError(f"malformed field: {exc}"))
        if steps is not None and steps < 1:
            return 400, _error_body(ValueError("'steps' must be >= 1"))
        if ttl_s is not None and ttl_s <= 0:
            return 400, _error_body(ValueError("'deadline' must be > 0 "
                                               "seconds"))
        rid = f"r{next(self._ids)}"
        gr = _GatewayRequest(rid, tenant, self.config.max_events,
                             self.clock)
        # queued lands before submit: event order is queued -> previews
        # -> terminal even when the backend resolves instantly
        gr.push("queued", {"id": rid, "tenant": tenant})
        try:
            future = self.backend.submit(
                prompt,
                height=height, width=width,
                negative_prompt=negative,
                num_inference_steps=steps,
                guidance_scale=guidance,
                seed=seed,
                ttl_s=ttl_s,
                slo_class=slo_class,
                tenant=tenant,
                on_progress=self._progress_cb(gr),
            )
        except ServeError as exc:
            self.counters.inc("rejected")
            self._trace_event("reject", id=rid, tenant=tenant,
                              error=type(exc).__name__)
            return _error_status(exc), _error_body(exc)
        gr.future = future
        self._register(gr)
        self.counters.inc("submitted")
        self._trace_event("generate", id=rid, tenant=tenant,
                          steps=steps, slo_class=slo_class)
        future.add_done_callback(
            lambda f, gr=gr: self._on_done(gr, f))
        return 202, {"id": rid, "tenant": tenant,
                     "events": f"/v1/requests/{rid}/events",
                     "poll": f"/v1/requests/{rid}"}

    def _progress_cb(self, gr: _GatewayRequest) -> Callable[..., None]:
        def on_progress(step: int, total_steps: int, preview: Any) -> None:
            # SCHEDULER thread: encode the (tiny, downsampled) preview
            # and push without ever blocking — overflow drops oldest
            data = {"step": int(step), "total_steps": int(total_steps)}
            try:
                data.update(encode_image(preview))
            except Exception:  # noqa: BLE001 — preview != request
                data["image_b64"] = None
            if gr.push("preview", data):
                self._drops.inc(gr.tenant)
        return on_progress

    def _on_done(self, gr: _GatewayRequest, future: Any) -> None:
        """Future resolution (any thread, usually the scheduler): store
        the terminal state and push exactly one terminal event."""
        before = gr.dropped
        try:
            self._resolve(gr, future)
        finally:
            # finish() on a full buffer evicts one more preview; keep
            # the metric equal to the entry's own drop count
            delta = gr.dropped - before
            if delta:
                self._drops.inc(gr.tenant, delta)

    def _resolve(self, gr: _GatewayRequest, future: Any) -> None:
        if future.cancelled():
            self.counters.inc("cancelled")
            gr.finish("cancelled", {"id": gr.id}, outcome="cancelled")
            self._trace_event("cancelled", id=gr.id, tenant=gr.tenant)
            return
        exc = future.exception()
        if exc is not None:
            body = _error_body(exc)
            body["status"] = _error_status(exc)
            self.counters.inc("failed")
            gr.finish("error", body, outcome="error", error=body)
            self._trace_event("error", id=gr.id, tenant=gr.tenant,
                              error=type(exc).__name__)
            return
        r = future.result()
        payload: Dict[str, Any] = {"id": gr.id}
        try:
            payload.update(encode_image(r.output))
        except Exception:  # noqa: BLE001 — non-array outputs still serve
            payload["image_b64"] = None
            payload["output_repr"] = repr(r.output)[:256]
        payload["metrics"] = {
            "queue_wait_s": r.queue_wait_s,
            "execute_s": r.execute_s,
            "e2e_s": r.e2e_s,
            "batch_size": r.batch_size,
            "compile_hit": r.compile_hit,
            "exec_key": r.exec_key,
            "tier": r.tier,
            "replica": r.replica,
            "previews": r.previews,
            "first_preview_s": r.first_preview_s,
            "preempts": r.preempts,
        }
        self.counters.inc("completed")
        gr.finish("final", payload, outcome="completed", result=payload)
        self._trace_event("final", id=gr.id, tenant=gr.tenant)

    def handle_status(self, rid: str) -> Tuple[int, Dict[str, Any]]:
        gr = self._get(rid)
        if gr is None:
            return 404, _error_body(KeyError(f"unknown request id {rid!r}"))
        return 200, gr.status()

    def handle_cancel(self, rid: str) -> Tuple[int, Dict[str, Any]]:
        gr = self._get(rid)
        if gr is None:
            return 404, _error_body(KeyError(f"unknown request id {rid!r}"))
        # `Future.cancel()` reports True again on an already-cancelled
        # future — "cancelled" here means THIS call won the race, so an
        # entry that already reached its terminal state reports False
        already = gr.done
        cancelled = (not already and gr.future is not None
                     and bool(gr.future.cancel()))
        self._trace_event("cancel", id=rid, won=cancelled)
        # the done-callback (fires synchronously on a successful
        # cancel) pushes the terminal "cancelled" event; a lost race
        # just reports the terminal state the request already reached
        return 200, {"id": rid, "cancelled": cancelled,
                     "status": gr.status()["status"]}

    def next_events(self, rid: str, cursor: int = -1,
                    timeout: float = 0.2):
        """Core of the SSE stream (and what scenarios/tests poll):
        ``(events_after_cursor, resolved)``; KeyError for unknown ids."""
        gr = self._get(rid)
        if gr is None:
            raise KeyError(rid)
        return gr.next_events(cursor, timeout)

    def stream_events(self, rid: str, poll_s: float = 0.2,
                      should_stop: Optional[Callable[[], bool]] = None):
        """Generator of ``(name, data)`` events until the stream
        resolves — drains everything buffered, then ends after the
        terminal event (or on close/stop)."""
        cursor = -1
        while True:
            events, resolved = self.next_events(rid, cursor,
                                                timeout=poll_s)
            for seq, name, data in events:
                cursor = seq
                yield name, data
            if resolved and not events:
                return
            if should_stop is not None and should_stop() and not events:
                return

    # -- lifecycle / transport ----------------------------------------------

    def start(self, port: Optional[int] = None) -> "Gateway":
        """Bind the HTTP listener (``port=0`` = ephemeral; default from
        config) and serve the four endpoints."""
        from .httpbase import HTTPServerHost

        if self._http is not None:
            return self
        if port is None:
            port = self.config.port or 0
        self._http = HTTPServerHost(
            self._make_handler(), host=self.config.host, port=int(port),
            thread_name="distrifuser-gateway",
            max_threads=self.config.max_threads,
        ).start()
        return self

    def stop(self) -> None:
        """Deterministic drain: refuse new submissions, resolve every
        open SSE stream (close-mark + wake), close the listener.  The
        backend and its in-flight futures are untouched — stopping the
        gateway is transport teardown, not request cancellation."""
        with self._lock:
            self._stopping = True
            entries = list(self._requests.values())
        if self._http is not None:
            # stop_event first (inside HTTPServerHost.stop) ends handler
            # write loops; entry close() below ends their event waits
            self._http.stop()
            self._http = None
        for gr in entries:
            gr.close()
        self._trace_event("gateway_stop", open=len(entries))

    @property
    def port(self) -> Optional[int]:
        return self._http.port if self._http is not None else None

    @property
    def url(self) -> Optional[str]:
        return self._http.url if self._http is not None else None

    # -- HTTP handler --------------------------------------------------------

    def _make_handler(self):
        import http.server

        gateway = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # noqa: D102 — request spam
                pass

            def _send_json(self, code: int, payload: Dict[str, Any]):
                data = (json.dumps(payload, sort_keys=True) + "\n").encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _read_body(self):
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except (TypeError, ValueError):
                    length = 0
                raw = self.rfile.read(min(length, 1 << 20)) if length \
                    else b""
                try:
                    return json.loads(raw.decode() or "{}")
                except (ValueError, UnicodeDecodeError):
                    return None

            def do_POST(self):  # noqa: N802 — stdlib name
                try:
                    path = self.path.split("?", 1)[0].rstrip("/")
                    if path == "/v1/generate":
                        body = self._read_body()
                        if body is None:
                            self._send_json(400, _error_body(
                                ValueError("request body is not valid "
                                           "JSON")))
                            return
                        self._send_json(*gateway.handle_generate(body))
                    elif (path.startswith("/v1/requests/")
                          and path.endswith("/cancel")):
                        rid = path[len("/v1/requests/"):-len("/cancel")]
                        self._send_json(*gateway.handle_cancel(rid))
                    else:
                        self._send_json(404, _error_body(
                            KeyError(f"no such endpoint {path!r}")))
                except BrokenPipeError:
                    pass  # client went away mid-response
                except Exception as exc:  # noqa: BLE001 — handler != crash
                    try:
                        self._send_json(500, _error_body(exc))
                    except Exception:
                        pass

            def do_GET(self):  # noqa: N802 — stdlib name
                try:
                    path = self.path.split("?", 1)[0].rstrip("/")
                    if (path.startswith("/v1/requests/")
                            and path.endswith("/events")):
                        rid = path[len("/v1/requests/"):-len("/events")]
                        self._stream(rid)
                    elif path.startswith("/v1/requests/"):
                        rid = path[len("/v1/requests/"):]
                        self._send_json(*gateway.handle_status(rid))
                    elif path == "/healthz":
                        health = getattr(gateway.backend, "health", None)
                        if health is None:
                            self._send_json(200, {"status": "ok"})
                        else:
                            h = health()
                            ok = h.get("status") in ("ok", "degraded")
                            self._send_json(200 if ok else 503, h)
                    else:
                        self._send_json(404, _error_body(
                            KeyError(f"no such endpoint {path!r}")))
                except BrokenPipeError:
                    pass
                except Exception as exc:  # noqa: BLE001 — handler != crash
                    try:
                        self._send_json(500, _error_body(exc))
                    except Exception:
                        pass

            def _stream(self, rid: str) -> None:
                if gateway._get(rid) is None:
                    self._send_json(404, _error_body(
                        KeyError(f"unknown request id {rid!r}")))
                    return
                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Connection", "close")
                self.end_headers()
                gateway.counters.inc("streams_opened")
                gateway._trace_event("stream_open", id=rid)
                stop_event = (self.server and gateway._http
                              and gateway._http.stop_event)
                try:
                    for name, data in gateway.stream_events(
                            rid,
                            should_stop=(stop_event.is_set if stop_event
                                         else None)):
                        self.wfile.write(sse_format(name, data))
                        self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError, OSError):
                    pass  # slow/gone consumer: its frames were dropped,
                    # never the scheduler's time
                finally:
                    gateway.counters.inc("streams_closed")
                    gateway._trace_event("stream_close", id=rid)

        return Handler
