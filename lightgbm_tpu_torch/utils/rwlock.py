"""Reader-writer lock for the public ``Booster`` and ``Dataset`` methods.

Counterpart of ``lightgbm_tpu/utils/rwlock.py`` (reference: the shared
mutex around every C API entry, src/c_api.cpp:163): many predictions run
side by side, while training and every change to a model run alone.
Public methods are decorated ``@read_locked`` or ``@write_locked`` against
the instance's ``_api_lock``.

* many readers, one writer, writer preference: a waiting writer holds new
  readers back, so a stream of predictions cannot starve training;
* re-entrant in a thread: a read inside a read, anything inside a write,
  a write inside a write;
* a read that asks for the write side raises ``RuntimeError`` instead of
  deadlocking: a read-locked method must not call a write-locked one;
* ``acquire_write(timeout=)`` gives up after ``timeout`` seconds (the
  training engine's final snapshot waits one deadline for an abandoned
  step, never longer).

The JAX package's race sanitizer and lock-order witness hooks are tooling
of ROADMAP A19 and are left out.
"""
from __future__ import annotations

import functools
import threading
import time
from typing import Optional


class RWLock:
    """Re-entrant reader-writer lock with writer preference. A copy (and a
    pickle) is a fresh lock."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0                     # threads holding the read side
        self._writer: Optional[int] = None    # the thread holding the write
        self._writer_depth = 0
        self._waiting_writers = 0
        self._local = threading.local()       # a thread's read depth

    def __deepcopy__(self, memo):
        return type(self)()

    def __reduce__(self):
        return (type(self), ())

    def _read_depth(self) -> int:
        return getattr(self._local, "depth", 0)

    def acquire_read(self) -> None:
        me = threading.get_ident()
        with self._cond:
            if self._writer == me or self._read_depth() > 0:
                self._local.depth = self._read_depth() + 1
                return
            while self._writer is not None or self._waiting_writers:
                self._cond.wait()
            self._readers += 1
            self._local.depth = 1

    def release_read(self) -> None:
        me = threading.get_ident()
        with self._cond:
            depth = self._read_depth()
            if depth <= 0:
                raise RuntimeError("release_read without acquire_read")
            self._local.depth = depth - 1
            if self._writer == me:
                return                        # a read nested in our write
            if depth == 1:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    def acquire_write(self, timeout: Optional[float] = None) -> bool:
        """Take the write side; with ``timeout`` (seconds) give up and
        return False when it is not free by then."""
        me = threading.get_ident()
        with self._cond:
            if self._writer == me:
                self._writer_depth += 1
                return True
            if self._read_depth() > 0:
                raise RuntimeError(
                    "read->write lock upgrade: a read-locked method called "
                    "a write-locked one; make the caller write-locked")
            end = None if timeout is None else time.monotonic() + timeout
            self._waiting_writers += 1
            try:
                while self._writer is not None or self._readers:
                    left = None if end is None else end - time.monotonic()
                    if left is not None and left <= 0:
                        return False
                    self._cond.wait(left)
            finally:
                self._waiting_writers -= 1
                if self._writer != me:
                    # readers held back by this waiter may go on
                    self._cond.notify_all()
            self._writer = me
            self._writer_depth = 1
            return True

    def release_write(self) -> None:
        with self._cond:
            if self._writer != threading.get_ident():
                raise RuntimeError("release_write by a non-holder")
            if self._writer_depth == 1 and self._read_depth() > 0:
                raise RuntimeError(
                    "release_write while reads taken under the write are "
                    "still held: the release order must be LIFO")
            self._writer_depth -= 1
            if self._writer_depth == 0:
                self._writer = None
                self._cond.notify_all()

    def read(self) -> "_Side":
        return _Side(self.acquire_read, self.release_read)

    def write(self) -> "_Side":
        return _Side(self.acquire_write, self.release_write)


class _Side:
    def __init__(self, acquire, release):
        self._acquire = acquire
        self._release = release

    def __enter__(self):
        self._acquire()
        return self

    def __exit__(self, *exc):
        self._release()
        return False


def _locked(kind: str, method):
    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        lock = self._api_lock
        with (lock.read() if kind == "read" else lock.write()):
            return method(self, *args, **kwargs)
    wrapper.__lock_kind__ = kind
    return wrapper


def read_locked(method):
    """Share the instance's lock for a public method that changes
    nothing."""
    return _locked("read", method)


def write_locked(method):
    """Hold the instance's lock alone for a public method that changes
    shared state."""
    return _locked("write", method)


class Mutex:
    """A re-entrant mutex (``with mutex:``) that copies and pickles as a
    fresh lock, for the device caches of objects a user may copy
    (``GBDT._trees_mu``)."""

    def __init__(self):
        self._lock = threading.RLock()

    def __enter__(self):
        self._lock.acquire()
        return self

    def __exit__(self, *exc):
        self._lock.release()
        return False

    def __deepcopy__(self, memo):
        return type(self)()

    def __reduce__(self):
        return (type(self), ())
