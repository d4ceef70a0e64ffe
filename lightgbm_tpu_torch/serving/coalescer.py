"""The micro-batch coalescer: many small requests, one device batch a tick.

Counterpart of ``lightgbm_tpu/serving/coalescer.py``. Concurrent requests
land in a bounded queue (a submit that would pass ``tpu_serve_queue_max``
rows raises :class:`ServerOverloaded`); one worker thread wakes each tick,
fails the requests whose deadline passed with :class:`ServingTimeout`,
takes a batch of one endpoint no larger than the largest warmed ladder
rung and hands it to the server as one device batch. LightGBM serves single
rows through its fast-path configs (``LGBM_BoosterPredictFor*SingleRowFast``,
src/c_api.cpp); on a card rows are gathered until they fill a rung.

* every admitted request completes exactly once: with a response of one
  model version, or with a typed error; nothing hangs;
* a slow tick (an injected ``hang@coalesce_tick``) turns into shedding at
  admission, never into an unbounded queue;
* a killed worker (``kill@coalesce_tick``) fails its batch and is
  respawned (``worker_restarts``);
* ``close(drain=True)`` stops admission, serves what is queued and joins
  the worker.

The JAX package's flight notes, spans and compile-phase counters are ROADMAP
A19 and are left out.
"""
from __future__ import annotations

import collections
import copy
import threading
import time
from typing import Callable, List, Optional

from ..analysis.faultinject import active_plan
from ..utils import log
from .errors import (ServerClosed, ServerOverloaded, ServingError,
                     ServingTimeout)


class ServeFuture:
    """Completion handle for one submitted request.

    ``result()`` is deadline-bounded by construction: with no explicit
    ``timeout`` it waits until the request's own deadline plus a small
    grace window (the server guarantees a structured completion by then),
    so no caller of the serving API can block forever."""

    #: extra wait past the request deadline before result() gives up —
    #: covers the tick that is busy serving when the deadline passes
    _GRACE_S = 5.0

    def __init__(self, arr, deadline_s: Optional[float],
                 deadline_ms: float, kind: str = "predict"):
        self.arr = arr                      # [n, F] float request rows
        self.n = int(arr.shape[0])
        self.kind = kind                    # predict | leaf | contrib
        self.deadline = (time.monotonic() + deadline_s
                         if deadline_s is not None else None)
        self.deadline_ms = deadline_ms
        self.version = None                 # model version that answered
        self.created_at = time.monotonic()
        # latency-attribution stamps (obs/drift.py ServingObserver):
        # popped_at when the tick cuts this request out of the queue,
        # served_at when the device response is host-materialized —
        # queue-wait / featurize+dispatch / slice-return fall out
        self.popped_at: Optional[float] = None
        self.served_at: Optional[float] = None
        self.completed_at: Optional[float] = None
        self._value = None
        self._error: Optional[BaseException] = None
        self._event = threading.Event()
        self._mu = threading.Lock()     # completion CAS: exactly one
        #                                 outcome wins (worker vs the
        #                                 client-side timeout in result)

    # -- completion (worker side) -------------------------------------------
    def _complete(self, version, value) -> None:
        with self._mu:
            if self._event.is_set():
                return
            self.version = version
            self._value = value
            self.arr = None     # release the request rows: callers keep
            #                     futures around for latency/version stats
            self.completed_at = time.monotonic()
            self._event.set()

    def _fail(self, err: BaseException) -> None:
        with self._mu:
            if self._event.is_set():
                return
            self._error = err
            # arr is NOT cleared here: a client-side result() timeout may
            # fire while this future sits in a popped in-flight batch,
            # and the worker still concatenates from arr — only
            # _complete (the worker, done with the rows) releases it
            self.completed_at = time.monotonic()
            self._event.set()

    # -- consumption (client side) ------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    @property
    def latency_s(self) -> Optional[float]:
        if self.completed_at is None:
            return None
        return self.completed_at - self.created_at

    def phase_times(self) -> Optional[dict]:
        """Per-request latency attribution: ``queue_wait_s`` (submit ->
        popped into a tick), ``serve_s`` (featurize + device dispatch +
        host materialization), ``complete_s`` (per-request slice/copy +
        completion). None until the request reached a tick (sheds and
        queue-expired timeouts never did).

        Stamps are clamped into ``created <= popped <= served <=
        completed`` order: a client-side result() timeout can complete
        the future BEFORE the worker stamps served_at (the completion
        CAS), and un-clamped that would feed negative phase seconds into
        the cumulative gauges."""
        if self.completed_at is None or self.popped_at is None:
            return None
        done = self.completed_at
        popped = min(self.popped_at, done)
        served = done if self.served_at is None \
            else min(max(self.served_at, popped), done)
        return {"queue_wait_s": popped - self.created_at,
                "serve_s": served - popped,
                "complete_s": done - served}

    def result(self, timeout: Optional[float] = None):
        if timeout is None:
            if self.deadline is not None:
                timeout = max(self.deadline - time.monotonic(), 0.0) \
                    + self._GRACE_S
            else:
                timeout = 60.0          # bounded even without a deadline
        if not self._event.wait(timeout):
            # record the timeout AS the future's outcome (CAS: if the
            # worker completes in this same instant, its result stands) —
            # client-visible state and the future never disagree
            self._fail(ServingTimeout("request", self.deadline_ms
                                      or timeout * 1000.0))
        if self._error is not None:
            # a FRESH copy per raise: concurrent/repeated result() calls
            # must not mutate one shared instance's __traceback__ across
            # threads (errors carry __reduce__ state for exact copies)
            raise copy.copy(self._error)
        return self._value


class MicroBatchCoalescer:
    """The bounded queue + tick worker behind a PredictionServer.

    ``serve_batch`` is called from the worker thread with a non-empty
    list of :class:`ServeFuture` and must complete every one of them
    (the server's implementation snapshots ONE model version per call,
    so a batch is never split across models)."""

    def __init__(self, serve_batch: Callable[[List[ServeFuture]], None],
                 *, tick_ms: float, queue_max_rows: int,
                 max_batch_rows: int, fault_config=None,
                 name: str = "serve", observer=None,
                 background_kinds=()):
        if queue_max_rows < 1:
            raise ValueError("tpu_serve_queue_max must be >= 1 row")
        if max_batch_rows < 1:
            raise ValueError("max_batch_rows must be >= 1")
        self._serve_batch = serve_batch
        self._tick_s = max(float(tick_ms), 0.0) / 1000.0
        self._queue_max_rows = int(queue_max_rows)
        self._max_batch_rows = int(max_batch_rows)
        self._fault_config = fault_config
        # quality-plane hook (obs/drift.py ServingObserver): on_future_done
        # per completed/failed future, on_tick_served per served tick
        # (the drift-flush cadence). Best-effort: observer failures must
        # never fail serving (_notify swallows + warns once)
        self._observer = observer
        self._observer_warned = False
        # background-tier request kinds (tpu_serve_background_kinds):
        # a background request only cuts a tick's batch when NO live
        # foreground request is queued — explanation (contrib) traffic
        # soaks idle ticks without touching predict/leaf latency
        self._background_kinds = frozenset(background_kinds)
        self._cv = threading.Condition()
        # each request holds >= 1 row and admission rejects past the row
        # bound first, so maxlen (a hard REQUEST cap) is never the
        # mechanism that drops: it bounds the queue
        self._q = collections.deque(maxlen=self._queue_max_rows)
        self._rows = 0                      # rows currently queued
        self._closing = False
        self._closed = False
        self.stats = {
            "submitted": 0, "served_requests": 0, "served_rows": 0,
            "ticks": 0, "shed": 0, "timeouts": 0, "errors": 0,
            "worker_restarts": 0, "max_queue_rows": 0,
            # per-endpoint-kind breakdown (ticks pop homogeneous-kind
            # batches, so every counter keys cleanly); the flat keys
            # above stay the aggregates for compatibility
            "kinds": {},
        }
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"lgbt-{name}-coalescer")
        self._thread.start()

    # -- admission (any thread) ---------------------------------------------
    def submit(self, arr, deadline_s: Optional[float],
               deadline_ms: float, kind: str = "predict") -> ServeFuture:
        n = int(arr.shape[0])
        if n < 1:
            raise ValueError("empty request (0 rows)")
        if n > self._max_batch_rows:
            raise ValueError(
                f"request of {n} rows exceeds the largest warmed serving "
                f"rung ({self._max_batch_rows}); slice it or warm a "
                "larger ladder (tpu_serve_warm_max_rows / "
                "tpu_predict_buckets)")
        if n > self._queue_max_rows:
            # structurally unservable, not transient overload: admission
            # could NEVER accept it, even on an idle server
            raise ValueError(
                f"request of {n} rows exceeds the admission bound "
                f"(tpu_serve_queue_max={self._queue_max_rows}); slice it "
                "or raise the bound")
        fut = ServeFuture(arr, deadline_s, deadline_ms, kind)
        with self._cv:
            if self._closing or self._closed:
                raise ServerClosed("server is draining/closed; "
                                   "request rejected")
            self.stats["submitted"] += 1
            self._kstats(kind)["submitted"] += 1
            if self._rows + n > self._queue_max_rows:
                self.stats["shed"] += 1
                self._kstats(kind)["shed"] += 1
                raise ServerOverloaded(self._rows, self._queue_max_rows)
            self._q.append(fut)
            self._rows += n
            self.stats["max_queue_rows"] = max(
                self.stats["max_queue_rows"], self._rows)
            self._cv.notify_all()
        return fut

    def _kstats(self, kind: str) -> dict:
        """Per-endpoint-kind counter block (created on first use); must
        be called under ``self._cv``."""
        ks = self.stats["kinds"].get(kind)
        if ks is None:
            ks = self.stats["kinds"][kind] = {
                "submitted": 0, "served_requests": 0, "served_rows": 0,
                "shed": 0, "timeouts": 0, "errors": 0}
        return ks

    def stats_snapshot(self) -> dict:
        """Consistent deep copy of the counters (the nested per-kind
        blocks must not alias the live dicts a tick mutates)."""
        with self._cv:
            out = {k: v for k, v in self.stats.items() if k != "kinds"}
            out["kinds"] = {k: dict(v)
                            for k, v in self.stats["kinds"].items()}
            return out

    def _notify(self, fut: ServeFuture) -> None:
        """Hand one completed/failed future to the quality-plane
        observer; never from under ``self._cv``, never raising."""
        if self._observer is None:
            return
        try:
            self._observer.on_future_done(fut)
        except Exception as err:  # noqa: BLE001 - telemetry is best-effort
            if not self._observer_warned:
                self._observer_warned = True
                log.warning(f"[serving] observer failed ({err!r}); "
                            "further failures suppressed")

    def queue_depth_rows(self) -> int:
        with self._cv:
            return self._rows

    def worker_alive(self) -> bool:
        return self._thread.is_alive()

    @property
    def max_batch_rows(self) -> int:
        return self._max_batch_rows

    def set_max_batch_rows(self, rows: int) -> None:
        """Re-bound the per-tick batch after a model swap (the new active
        model's largest warmed rung)."""
        if rows < 1:
            raise ValueError("max_batch_rows must be >= 1")
        with self._cv:
            self._max_batch_rows = int(rows)

    def set_background_kinds(self, kinds) -> None:
        """Re-point the background lane after a model swap (the new
        active model's ``tpu_serve_background_kinds``)."""
        with self._cv:
            self._background_kinds = frozenset(kinds)

    def set_fault_config(self, config) -> None:
        """Re-point the coalesce_tick fault site at the new active
        model's config after a swap — a candidate carrying
        ``tpu_fault_spec`` must arm (and a disarmed one must not stay
        armed) from the moment it serves."""
        self._fault_config = config

    # -- worker -------------------------------------------------------------
    def _pop_batch(self) -> Optional[List[ServeFuture]]:
        """Next batch (possibly empty after a deadline sweep), or None to
        exit. Blocks in SHORT bounded waits so close() is always
        responsive."""
        swept: List[ServeFuture] = []
        batch = self._pop_batch_locked(swept)
        for r in swept:                 # observer runs OUTSIDE the lock
            self._notify(r)
        return batch

    def _pop_batch_locked(self, swept: List[ServeFuture]
                          ) -> Optional[List[ServeFuture]]:
        with self._cv:
            while not self._q:
                if self._closing:
                    return None
                self._cv.wait(timeout=0.05)
            if self._tick_s > 0 and not self._closing:
                # the coalescing window: let concurrent submitters join
                # this tick's batch before it is cut. Re-wait until the
                # FULL window elapses — each submit's notify would
                # otherwise cut the wait (and the batch) at the first
                # concurrent arrival — but cut immediately once the
                # queue already fills the batch (waiting longer can only
                # add latency: nothing more fits this tick)
                end = time.monotonic() + self._tick_s
                while not self._closing \
                        and self._rows < self._max_batch_rows:
                    remaining = end - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
            now = time.monotonic()
            batch: List[ServeFuture] = []
            rows = 0
            bg = self._background_kinds
            # a background request only cuts a batch when no LIVE
            # foreground request is queued (expired ones sweep this pass
            # and must not pin the background lane another tick)
            has_fg = any(r.kind not in bg
                         and (r.deadline is None or now < r.deadline)
                         for r in self._q)
            kept: List[ServeFuture] = []
            stop = False
            while self._q:
                r = self._q.popleft()
                if stop:
                    kept.append(r)
                    continue
                if r.deadline is not None and now >= r.deadline:
                    self._rows -= r.n
                    self.stats["timeouts"] += 1
                    self._kstats(r.kind)["timeouts"] += 1
                    r._fail(ServingTimeout("request expired in queue",
                                           r.deadline_ms))
                    swept.append(r)
                    continue
                if r.n > self._max_batch_rows:
                    # admitted before a hot swap shrank the warmed-rung
                    # bound: serving it now would build the new model's
                    # caches in the request path, so it fails instead
                    self._rows -= r.n
                    self.stats["errors"] += 1
                    self._kstats(r.kind)["errors"] += 1
                    r._fail(ServingError(
                        f"request of {r.n} rows exceeds the active "
                        f"model's largest warmed rung "
                        f"({self._max_batch_rows}) after a model swap; "
                        "resubmit in smaller slices"))
                    swept.append(r)
                    continue
                if bg and has_fg and r.kind in bg:
                    # background lane: skipped (in place, order kept)
                    # while foreground traffic is queued — it serves on
                    # the first tick with an empty foreground queue
                    kept.append(r)
                    continue
                if batch and r.kind != batch[0].kind:
                    # one endpoint per tick: a batch is ONE device
                    # dispatch, and predict/leaf/contrib are distinct
                    # programs — mixed traffic serves FIFO on
                    # consecutive ticks instead of splitting a tick
                    kept.append(r)
                    stop = True
                    continue
                if batch and rows + r.n > self._max_batch_rows:
                    kept.append(r)
                    stop = True             # next tick's batch
                    continue
                self._rows -= r.n
                r.popped_at = now
                batch.append(r)
                rows += r.n
            for r in reversed(kept):
                self._q.appendleft(r)
            return batch

    def _drain_loop(self) -> None:
        while True:
            batch = self._pop_batch()
            if batch is None:
                return
            if not batch:
                continue
            rows = sum(r.n for r in batch)
            kind = batch[0].kind            # ticks are kind-homogeneous
            # count BEFORE the futures complete: clients synchronize on
            # result(), so a stats read right after it must already see
            # this batch (rolled back below if the tick fails)
            with self._cv:
                self.stats["ticks"] += 1
                self.stats["served_requests"] += len(batch)
                self.stats["served_rows"] += rows
                ks = self._kstats(kind)
                ks["served_requests"] += len(batch)
                ks["served_rows"] += rows
            try:
                # the slow-tick / worker-kill injection point: fired
                # OUTSIDE the queue lock, so a hanging tick converts into
                # admission-side shedding, never into blocked submitters
                active_plan(self._fault_config).fire(
                    "coalesce_tick", requests=len(batch))
                self._serve_batch(batch)
            except BaseException as err:  # noqa: BLE001 - classified below
                with self._cv:
                    self.stats["ticks"] -= 1
                    self.stats["served_requests"] -= len(batch)
                    self.stats["served_rows"] -= rows
                    self.stats["errors"] += 1
                    ks = self._kstats(kind)
                    ks["served_requests"] -= len(batch)
                    ks["served_rows"] -= rows
                    ks["errors"] += 1
                # one FRESH exception per future: concurrent result()
                # raises would otherwise mutate a shared instance's
                # __traceback__/__context__ across client threads
                msg = (str(err) if isinstance(err, ServingError)
                       else f"serving tick failed: {err!r}")
                for r in batch:
                    r._fail(ServingError(msg))
                    self._notify(r)
                if not isinstance(err, Exception):
                    raise           # a worker kill: respawn boundary below
                continue
            # success: futures first (their latency/SLO outcomes), then
            # the tick boundary — the drift-flush cadence sees this
            # tick's window fully accumulated
            for r in batch:
                self._notify(r)
            if self._observer is not None:
                try:
                    self._observer.on_tick_served(kind)
                except Exception as err:  # noqa: BLE001 - best-effort
                    if not self._observer_warned:
                        self._observer_warned = True
                        log.warning(f"[serving] observer tick hook "
                                    f"failed ({err!r}); further failures "
                                    "suppressed")

    def _run(self) -> None:
        while True:
            try:
                self._drain_loop()
                return                      # clean drain/close exit
            except BaseException as err:  # noqa: BLE001 - supervisor
                # the injected worker kill (faultinject.SimulatedKill) or
                # an unexpected crash: the in-flight batch already failed
                # structurally in _drain_loop; respawn so the queue keeps
                # draining instead of wedging
                log.warning(f"[serving] worker died ({err!r}); respawning")
                with self._cv:
                    self.stats["worker_restarts"] += 1
                    if self._closing:
                        return

    # -- shutdown -----------------------------------------------------------
    def close(self, drain: bool = True,
              timeout_s: Optional[float] = None) -> None:
        """Stop admission; serve (``drain=True``) or fail (``False``)
        whatever is queued; join the worker. Safe to call twice."""
        with self._cv:
            if self._closed:
                return
            self._closing = True
            if not drain:
                while self._q:
                    r = self._q.popleft()
                    self._rows -= r.n
                    r._fail(ServerClosed("server closed before serving "
                                         "this request"))
            self._cv.notify_all()
        if timeout_s is not None:
            self._thread.join(timeout_s)
        else:
            # the deliberate blocking drain: every queued request is
            # served (or structurally failed) before close returns
            self._thread.join()
        with self._cv:
            self._closed = True
            while self._q:                  # worker died / join timed out
                r = self._q.popleft()
                self._rows -= r.n
                r._fail(ServerClosed("server closed before serving this "
                                     "request"))
