"""The one place serve-plane code constructs synchronization primitives.

Every cross-thread interaction of the serve layer (and of the metric and
trace classes it shares across threads) goes through a factory here
instead of calling ``threading`` directly, so that a deterministic
scheduler can be installed in their place to explore the control plane's
interleavings (``install_runtime``), as the JAX package's serve layer
allows.

Production is a zero-overhead passthrough: with no runtime installed (the
default) every factory returns the stdlib object itself, not a proxy.
Under a runtime the factories return its virtual primitives, which yield
to the seeded scheduler at every acquire/release, wait/notify, queue op,
and thread start/join.

``Empty`` is re-exported so ``except sync.Empty`` works against both the
stdlib queue and a virtual one (a virtual queue raises the stdlib
exception type).
"""

from __future__ import annotations

import queue as _queue_mod
import threading as _threading
from queue import Empty  # noqa: F401  (re-export; virtual queues raise it)

#: the active deterministic runtime, or None in production.
_runtime = None


def install_runtime(runtime) -> None:
    """Route the factories to ``runtime`` (one at a time)."""
    global _runtime
    if _runtime is not None and runtime is not None:
        raise RuntimeError("a sync runtime is already installed")
    _runtime = runtime


def uninstall_runtime() -> None:
    global _runtime
    _runtime = None


def active_runtime():
    """The installed runtime, or None (production)."""
    return _runtime


# -- factories ---------------------------------------------------------------
#
# Signatures mirror the stdlib constructors the serve layer actually
# uses.  Each returns the stdlib object when no runtime is installed.


def Lock():
    if _runtime is None:
        return _threading.Lock()
    return _runtime.create_lock()


def RLock():
    if _runtime is None:
        return _threading.RLock()
    return _runtime.create_rlock()


def Condition(lock=None):
    if _runtime is None:
        return _threading.Condition(lock)
    return _runtime.create_condition(lock)


def Event():
    if _runtime is None:
        return _threading.Event()
    return _runtime.create_event()


def Semaphore(value: int = 1):
    if _runtime is None:
        return _threading.Semaphore(value)
    return _runtime.create_semaphore(value)


def Queue(maxsize: int = 0):
    if _runtime is None:
        return _queue_mod.Queue(maxsize)
    return _runtime.create_queue(maxsize)


def Thread(target=None, *, args=(), kwargs=None, name=None, daemon=None):
    if _runtime is None:
        return _threading.Thread(target=target, args=args, kwargs=kwargs,
                                 name=name, daemon=daemon)
    return _runtime.create_thread(target=target, args=args,
                                  kwargs=kwargs or {}, name=name)
