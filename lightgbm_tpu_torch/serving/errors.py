"""Typed serving errors (counterpart of ``lightgbm_tpu/serving/
errors.py``): overload, a missed deadline, shutdown and a failed hot swap
each raise an error a caller can branch on, never unbounded latency or a
wedged queue (reference: the failures LightGBM's C API reports through
``LGBM_GetLastError``, src/c_api.cpp)."""
from __future__ import annotations


class ServingError(RuntimeError):
    """The base of every serving failure."""


class ServingTimeout(ServingError):
    """A request's deadline passed before its response was made."""

    def __init__(self, what: str, deadline_ms: float):
        super().__init__(f"{what}: deadline of {deadline_ms:.0f} ms "
                         "exceeded")
        self.what = what
        self.deadline_ms = deadline_ms

    def __reduce__(self):
        # a copy is made through the real constructor (``args`` holds the
        # formatted message): ServeFuture raises a fresh copy each time
        return (type(self), (self.what, self.deadline_ms))


class ServerOverloaded(ServingError):
    """Admission refused a request: the bounded queue is full
    (``tpu_serve_queue_max`` rows)."""

    def __init__(self, queued_rows: int, queue_max: int):
        super().__init__(f"serving queue full ({queued_rows}/{queue_max} "
                         "rows queued); request shed")
        self.queued_rows = queued_rows
        self.queue_max = queue_max

    def __reduce__(self):
        return (type(self), (self.queued_rows, self.queue_max))


class ServerClosed(ServingError):
    """The server is draining or closed; no request is admitted."""


class SwapFailed(ServingError):
    """A hot swap did not commit (its warm-up or health check failed, or
    the commit overran its deadline); the previous model stays active."""
