"""Shared stdlib HTTP server plumbing for the serve plane's front doors.

Two endpoints face sockets: the metrics exposition
(`utils.metrics.MetricsHTTPEndpoint`) and the generation gateway
(`serve/gateway.py`).  The plumbing that is not obvious:

* **SO_REUSEADDR** -- a server restarted on the same configured port must
  not fail with ``EADDRINUSE`` while the previous socket sits in
  TIME_WAIT.  `HTTPServerHost` always sets it.
* **Deterministic shutdown with streams in flight** -- ``shutdown()``
  only stops the accept loop; an SSE handler mid-stream holds its
  connection open.  The host exposes a ``stop_event`` that streaming handlers poll,
  and `stop` sets it *first*, then drains the bounded handler-slot
  semaphore with a deadline so every in-flight handler is either finished
  or provably abandoned (daemon thread + socket timeout) before the
  listener closes.

Handler concurrency is bounded by a semaphore taken in the accept path:
excess connections wait in the listen backlog instead of spawning
unbounded threads against the scheduler's host.  All primitives come
from `utils/sync.py`, though in production they are the stdlib objects
themselves.
"""

from __future__ import annotations

import http.server
import time
from typing import Type

from ..utils import sync


class HTTPServerHost:
    """Owns one ``ThreadingHTTPServer`` + its serve thread for a caller-
    supplied ``BaseHTTPRequestHandler`` class.

    ``port=0`` binds an ephemeral port (read ``.port`` after `start`).
    Handlers that stream (SSE) must poll ``stop_event`` between writes
    and exit when it is set — that is the contract that makes `stop`
    deterministic.
    """

    def __init__(self, handler_cls: Type[http.server.BaseHTTPRequestHandler],
                 *, host: str = "127.0.0.1", port: int = 0,
                 thread_name: str = "distrifuser-http",
                 max_threads: int = 8, socket_timeout_s: float = 30.0):
        self.handler_cls = handler_cls
        self.host = host
        self.port = int(port)
        self.thread_name = thread_name
        self.max_threads = max(1, int(max_threads))
        self.socket_timeout_s = float(socket_timeout_s)
        #: set before the accept loop stops — streaming handlers poll this
        self.stop_event = sync.Event()
        self._slots = sync.Semaphore(self.max_threads)
        self._httpd = None
        self._thread = None

    def start(self) -> "HTTPServerHost":
        host = self

        class Server(http.server.ThreadingHTTPServer):
            daemon_threads = True
            # without this, a restart on the same port races
            # TIME_WAIT and fails with EADDRINUSE
            allow_reuse_address = True
            # we drain handlers ourselves with a deadline; the stdlib
            # join-on-close would wait unboundedly on a stalled client
            block_on_close = False

            def process_request(self, request, client_address):
                # bounded handler threads: saturation parks new
                # connections in the listen backlog, not in fresh threads
                host._slots.acquire()
                try:
                    request.settimeout(host.socket_timeout_s)
                    super().process_request(request, client_address)
                except Exception:
                    host._slots.release()
                    raise

            def process_request_thread(self, request, client_address):
                try:
                    super().process_request_thread(request, client_address)
                finally:
                    host._slots.release()

        self._httpd = Server((self.host, self.port), self.handler_cls)
        self.port = self._httpd.server_address[1]
        self.stop_event.clear()
        self._thread = sync.Thread(
            target=self._httpd.serve_forever,
            name=self.thread_name, daemon=True,
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 10.0) -> None:
        """Stop accepting, resolve in-flight handlers, close the socket.

        Order matters: ``stop_event`` first so streaming handlers exit
        their write loops, then the accept loop, then a deadline-bounded
        drain of every handler slot — a handler that outlives the
        deadline is abandoned (daemon thread; its socket timeout bounds
        how long it can linger)."""
        self.stop_event.set()
        if self._httpd is not None:
            self._httpd.shutdown()
            taken = 0
            deadline = time.monotonic() + timeout
            for _ in range(self.max_threads):
                left = max(0.0, deadline - time.monotonic())
                if not self._slots.acquire(timeout=left):
                    break
                taken += 1
            for _ in range(taken):
                self._slots.release()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    @property
    def running(self) -> bool:
        return self._httpd is not None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"
