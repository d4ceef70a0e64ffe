"""PredictionServer: the serving front over a booster and its successors.

Counterpart of ``lightgbm_tpu/serving/server.py``: the coalescer
(``coalescer.py``), the registry (``registry.py``) and the serving calls
of ``Booster`` (``predict_serving``, ``predict_leaf_serving``,
``predict_contrib_serving``) put together. Concurrent small requests
gather into one rung-sized device batch a tick, admission is bounded,
every request has a deadline, models swap atomically with rollback, and
``health()``/``ready()`` answer probes::

    server = booster.serve(tick_ms=2.0, deadline_ms=500)
    fut = server.submit(X_small)             # asynchronous, micro-batched
    y = fut.result()                         # == booster.predict(X_small)
    server.deploy("v2", retrained_booster)   # warmed, atomic swap
    server.close(drain=True)

The coalescer's worker thread launches on the card on the stream of the
thread that built the server, so a tick's work is ordered after the
deploy's, and each response comes to the host (the one device-to-host copy
of a tick) before its rows are sliced. The Prometheus endpoint
(``metrics_port``, a positive ``tpu_metrics_port``, ``serve_metrics``,
``metrics_text``) is ROADMAP A19 and raises ``NotImplementedError`` naming
it.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..analysis.faultinject import active_plan
from ..obs.drift import ServingObserver
from ..ops.predict import parse_bucket_ladder, warmup_rungs
from .coalescer import MicroBatchCoalescer, ServeFuture
from .errors import ServerOverloaded, ServingError
from .registry import ModelRegistry


class PredictionServer:
    """Micro-batching, deadline-aware, hot-swappable serving front.

    The serving-quality plane (``obs/drift.py`` ``ServingObserver``)
    rides along:
    per-request latency attribution histograms always; the on-device
    drift monitor when ``tpu_drift_flush_every > 0`` (or
    ``drift_flush_every=``), the SLO burn-rate tracker when
    ``tpu_serve_slo_ms > 0`` (or ``slo_ms=``)."""

    def __init__(self, booster=None, *, registry: Optional[ModelRegistry]
                 = None, version: str = "v0",
                 tick_ms: Optional[float] = None,
                 queue_max: Optional[int] = None,
                 deadline_ms: Optional[float] = None,
                 warm: bool = True, warm_max_rows: Optional[int] = None,
                 raw_score: bool = False, swap_deadline_s: float = 30.0,
                 metrics_port: Optional[int] = None,
                 slo_ms: Optional[float] = None,
                 slo_target: Optional[float] = None,
                 drift_flush_every: Optional[int] = None,
                 drift_psi_threshold: Optional[float] = None):
        if metrics_port is not None:
            raise NotImplementedError(
                "not in the PyTorch port yet: the serving metrics endpoint "
                "(metrics_port; ROADMAP A19)")
        self._registry = registry if registry is not None else ModelRegistry()
        self._raw_score = bool(raw_score)
        self._swap_deadline_s = float(swap_deadline_s)
        self._closed = False
        self._mu = threading.Lock()
        if booster is not None:
            self._registry.deploy(
                version, booster, warm=warm,
                warm_max_rows=warm_max_rows,
                deadline_s=self._swap_deadline_s,
                prepare_drift=(drift_flush_every > 0
                               if drift_flush_every is not None else None))
        _, active = self._registry.active()     # requires a deployed model
        cfg = active._gbdt.config
        if int(cfg.get("tpu_metrics_port", 0) or 0) > 0:
            raise NotImplementedError(
                "not in the PyTorch port yet: the serving metrics endpoint "
                "(tpu_metrics_port > 0; ROADMAP A19)")
        # the worker launches on this thread's stream (None on the CPU)
        dev = active._gbdt.device
        self._stream = (torch.cuda.current_stream(dev)
                        if dev.type == "cuda" else None)
        self._fault_config = cfg
        self._endpoints = active._serve_endpoints()
        tick_ms = (float(cfg.get("tpu_serve_tick_ms", 5.0))
                   if tick_ms is None else float(tick_ms))
        queue_max = (int(cfg.get("tpu_serve_queue_max", 8192))
                     if queue_max is None else int(queue_max))
        self._deadline_ms = (float(cfg.get("tpu_serve_deadline_ms", 1000.0))
                             if deadline_ms is None else float(deadline_ms))
        if warm_max_rows is None:
            warm_max_rows = int(cfg.get("tpu_serve_warm_max_rows", 0) or 0)
        self._warm_max_rows = warm_max_rows
        self._n_features = len(active._gbdt.mappers)
        # the serving-quality plane: built BEFORE the coalescer (whose
        # worker notifies it) and attached to the active model after
        self._obs = ServingObserver(
            cfg, slo_ms=slo_ms, slo_target=slo_target,
            drift_flush_every=drift_flush_every,
            drift_psi_threshold=drift_psi_threshold)
        self._coalescer = MicroBatchCoalescer(
            self._serve_batch, tick_ms=tick_ms, queue_max_rows=queue_max,
            max_batch_rows=self._resolve_max_batch(active),
            fault_config=cfg, observer=self._obs,
            background_kinds=self._background_kinds(cfg))
        try:
            self._attach_obs_model()
        except BaseException:
            # the worker is already running: a raise here (the drift
            # monitor's reference) must not leave it without a handle
            self._closed = True
            self._coalescer.close(drain=False)
            raise

    @staticmethod
    def _background_kinds(cfg) -> frozenset:
        """Resolved ``tpu_serve_background_kinds``: request kinds demoted
        to the background tier (they only cut a coalescer tick when no
        foreground request is queued). ``predict`` can never be demoted
        — it is THE latency-path endpoint the tier protects."""
        from ..utils import log
        raw = str(cfg.get("tpu_serve_background_kinds", "") or "")
        kinds = {k.strip().lower() for k in raw.split(",") if k.strip()}
        unknown = kinds - {"leaf", "contrib"}
        if unknown:
            log.warning(f"unknown tpu_serve_background_kinds "
                        f"{sorted(unknown)}; valid: leaf, contrib "
                        "(predict cannot be demoted)")
            kinds -= unknown
        return frozenset(kinds)

    # -- batch bound ---------------------------------------------------------
    def _resolve_max_batch(self, booster, version: Optional[str] = None
                           ) -> int:
        """The largest batch a tick may cut: the given (default: active)
        model's largest warmed rung (so no tick builds a cache), else the
        largest rung a warm-up would cover (an unwarmed server builds its
        caches in its first ticks)."""
        stats = self._registry.warm_stats(version)
        if stats and stats.get("rungs"):
            return int(max(stats["rungs"]))
        ladder = parse_bucket_ladder(
            booster._gbdt.config.get("tpu_predict_buckets", "auto"))
        return int(max(warmup_rungs(ladder, self._warm_max_rows)))

    # -- request path --------------------------------------------------------
    def submit(self, data, deadline_ms: Optional[float] = None,
               kind: str = "predict") -> ServeFuture:
        """Enqueue one request; returns its :class:`ServeFuture`.

        ``kind`` selects the endpoint: ``predict`` (scores), ``leaf``
        (per-tree leaf indices, reference PredictLeafIndex) or
        ``contrib`` (exact TreeSHAP contributions) — all through the
        same coalescer/deadline/ladder machinery, one device dispatch
        per tick. Endpoints are warmed per ``tpu_serve_endpoints``;
        submitting to an unlisted one raises (serving it cold would
        build its caches in the request path).

        Raises structured errors at the admission edge:
        ``ServerOverloaded`` (bounded queue full), ``ServerClosed``
        (draining), ``ValueError`` (shape/size/endpoint). ``deadline_ms``
        overrides ``tpu_serve_deadline_ms``; ``<= 0`` disables the
        deadline for this request (the future still bounds its own
        ``result()`` wait)."""
        if kind not in self._endpoints:
            raise ValueError(
                f"endpoint {kind!r} is not enabled on the active model "
                f"(tpu_serve_endpoints={','.join(self._endpoints)}); "
                "serving it unwarmed would build its caches in the "
                "request path")
        active_plan(self._fault_config).fire("request")
        # snapshot the request: submit is async, and np.asarray aliases a
        # caller-owned buffer — a client reusing its buffer would
        # otherwise have queued requests served with overwritten rows.
        # float32 IS the serving wire format (predict_serving casts
        # anyway; copying f32 here halves the queue's footprint)
        arr = np.array(data, dtype=np.float32, copy=True)
        if arr.ndim == 1:
            arr = arr.reshape(1, -1)
        if arr.ndim != 2 or arr.shape[1] != self._n_features:
            raise ValueError(
                f"request shape {arr.shape} does not match the active "
                f"model's {self._n_features} features")
        if deadline_ms is None:
            deadline_ms = self._deadline_ms
        deadline_s = (deadline_ms / 1000.0) if deadline_ms > 0 else None
        try:
            return self._coalescer.submit(
                arr, deadline_s, deadline_ms if deadline_ms > 0 else 0.0,
                kind)
        except ServerOverloaded:
            # a shed IS a failed request from the client's side: it must
            # burn the SLO error budget even though no future exists.
            # Guarded like every observer hook — a telemetry failure
            # must not replace the structured error clients catch
            try:
                self._obs.on_shed(kind)
            except Exception:  # noqa: BLE001 - telemetry is best-effort
                pass
            raise

    def submit_leaf(self, data, deadline_ms: Optional[float] = None
                    ) -> ServeFuture:
        """Enqueue one ``pred_leaf`` request (leaf-index embeddings)."""
        return self.submit(data, deadline_ms, kind="leaf")

    def submit_contrib(self, data, deadline_ms: Optional[float] = None
                       ) -> ServeFuture:
        """Enqueue one ``pred_contrib`` request (exact TreeSHAP)."""
        return self.submit(data, deadline_ms, kind="contrib")

    def predict(self, data, deadline_ms: Optional[float] = None,
                timeout: Optional[float] = None):
        """Synchronous convenience: ``submit(...).result(...)`` —
        micro-batched with every other in-flight request, equal to the
        active booster's ``predict(float32(data))`` (float32 is the
        serving wire format; ``submit`` casts there)."""
        return self.submit(data, deadline_ms).result(timeout=timeout)

    def predict_leaf(self, data, deadline_ms: Optional[float] = None,
                     timeout: Optional[float] = None):
        """Synchronous ``pred_leaf``: equals the active booster's
        ``predict(float32(data), pred_leaf=True)``."""
        return self.submit_leaf(data, deadline_ms).result(timeout=timeout)

    def predict_contrib(self, data, deadline_ms: Optional[float] = None,
                        timeout: Optional[float] = None):
        """Synchronous ``pred_contrib``: the device TreeSHAP twin of the
        active booster's ``predict(float32(data), pred_contrib=True)``
        (matches within documented f32 tolerance)."""
        return self.submit_contrib(data, deadline_ms).result(timeout=timeout)

    def _serve_batch(self, batch) -> None:
        """One tick: pin ONE model snapshot, run the concatenated batch
        through the device engine at a warmed rung, slice per-request
        rows on the host. A request is never split across models; the
        coalescer pops homogeneous-kind batches, so one tick is one
        endpoint's single device dispatch."""
        version, booster = self._registry.active()
        rows = sum(r.n for r in batch)
        if rows > self._resolve_max_batch(booster, version):
            # the batch was cut under the PREVIOUS model's warmed-rung
            # bound and a swap landed before this pin: serving it would
            # build caches in the request path (or overflow the ladder):
            # raise, and the coalescer fails every request structurally
            # (and counts the tick as an error, not as served)
            raise ServingError(
                f"batch of {rows} rows exceeds model {version!r}'s "
                "largest warmed rung (hot-swap landed mid-tick); "
                "resubmit")
        kind = batch[0].kind
        if kind not in booster._serve_endpoints():
            # admitted under the PREVIOUS model's endpoint set and a swap
            # landed before this pin: the new model never warmed this
            # kind, so serving it would build its caches in the request
            # path: it fails, like the oversized-rows case
            raise ServingError(
                f"endpoint {kind!r} is not enabled on model {version!r} "
                "(hot-swap landed mid-queue); resubmit against the new "
                "model's tpu_serve_endpoints")
        if len(batch) == 1:
            x = batch[0].arr
        else:
            x = np.concatenate([r.arr for r in batch], axis=0)
        with (torch.cuda.stream(self._stream) if self._stream is not None
              else contextlib.nullcontext()):
            out = self._serve_on_device(booster, version, kind, x)
        served_at = time.monotonic()
        off = 0
        for r in batch:
            r.served_at = served_at
            # a copy: views would pin the padded rung buffer
            r._complete(version, np.array(out[off:off + r.n]))
            off += r.n

    def _serve_on_device(self, booster, version, kind, x):
        """One tick's device dispatch; returns the rung-padded response
        on the host."""
        # drift window: the tick's binned matrix (and, for predict, the
        # raw margins) fold into the active monitor's device accumulators
        # — only when the monitor matches this tick's pinned version (a
        # swap landing mid-queue must not mix models' windows)
        drift = self._obs.drift_for(version)
        if kind == "leaf":
            out, _ = booster.predict_leaf_serving(x, observe=drift)
        elif kind == "contrib":
            out, _ = booster.predict_contrib_serving(x, observe=drift)
        else:
            out, _ = booster.predict_serving(x, raw_score=self._raw_score,
                                             observe=drift)
        return out

    # -- model management ----------------------------------------------------
    def deploy(self, version: str, booster, *, warm: bool = True,
               deadline_s: Optional[float] = None) -> Dict:
        """Pre-warm ``booster`` and atomically hot-swap it in (see
        ModelRegistry.deploy); live traffic keeps flowing on the old
        model until the commit lands, and a failed warmup/health check/
        deadline rolls back automatically."""
        stats = self._registry.deploy(
            version, booster, warm=warm, warm_max_rows=self._warm_max_rows,
            deadline_s=self._swap_deadline_s if deadline_s is None
            else float(deadline_s),
            # this server's drift arming (per-server override included)
            # decides whether the candidate's reference distributions
            # must materialize in the warm phase — the config knob alone
            # would miss booster.serve(drift_flush_every=...) servers
            prepare_drift=self._obs.flush_every > 0)
        self._after_model_change()
        return stats

    def rollback(self) -> str:
        """Re-activate the previously active model version."""
        v = self._registry.rollback()
        self._after_model_change()
        return v

    def warm(self) -> Dict:
        """Warm the active model's ladder now (servers constructed with
        ``warm=False`` are not ready() until this runs)."""
        stats = self._registry.warm_active(self._warm_max_rows)
        self._after_model_change()
        return stats

    def _after_model_change(self) -> None:
        _, active = self._registry.active()
        with self._mu:
            self._n_features = len(active._gbdt.mappers)
            self._fault_config = active._gbdt.config
            self._endpoints = active._serve_endpoints()
            self._coalescer.set_fault_config(active._gbdt.config)
            self._coalescer.set_max_batch_rows(
                self._resolve_max_batch(active))
            self._coalescer.set_background_kinds(
                self._background_kinds(active._gbdt.config))
        self._attach_obs_model()

    def _attach_obs_model(self) -> None:
        """(Re)point the quality plane at the active model: fresh drift
        reference + warmed accumulate programs per warmed rung."""
        version, active = self._registry.active()
        warm = self._registry.warm_stats(version) or {}
        self._obs.attach_model(version, active, warm.get("rungs") or [])

    @property
    def registry(self) -> ModelRegistry:
        return self._registry

    # -- probes --------------------------------------------------------------
    def health(self) -> Dict[str, Any]:
        """Liveness/readiness snapshot: device reachability, warm-program
        presence, queue depth, counters. Never raises — a health probe
        must answer during the exact failures it exists to surface."""
        device = _device_health(self._registry)
        active = self._registry.active_version()
        warm = self._registry.warm_stats(active) or {}
        stats = self._coalescer.stats_snapshot()
        ready = bool(device["ok"] and active is not None
                     and warm.get("rungs") and not self._closed
                     and self._coalescer.worker_alive())
        return {
            "ready": ready,
            "closed": self._closed,
            "device": device,
            "active_version": active,
            "versions": self._registry.versions(),
            "warm_rungs": list(warm.get("rungs") or []),
            "endpoints": list(self._endpoints),
            "queue_depth_rows": self._coalescer.queue_depth_rows(),
            "max_batch_rows": self._coalescer.max_batch_rows,
            "worker_alive": self._coalescer.worker_alive(),
            "swaps": self._registry.swaps,
            "failed_swaps": self._registry.failed_swaps,
            "stats": stats,
        }

    def ready(self) -> bool:
        """Readiness gate: device up, a warmed model active, worker
        alive, not draining."""
        return self.health()["ready"]

    # -- metrics ------------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        """The health snapshot with the quality plane's scalars and
        latency histograms. The JAX package also reports its compile and
        cache counters, which PyTorch's eager kernels do not have."""
        out = self.health()
        out["serving_obs"] = self._obs.snapshot()
        out["latency"] = self._obs.latency()
        return out

    def metrics_text(self) -> str:
        raise NotImplementedError("not in the PyTorch port yet: Prometheus "
                                  "text of the serving metrics (ROADMAP "
                                  "A19)")

    def serve_metrics(self, port: int = 0) -> int:
        raise NotImplementedError("not in the PyTorch port yet: the serving "
                                  "metrics endpoint (ROADMAP A19)")

    @property
    def stats(self) -> Dict[str, Any]:
        return self._coalescer.stats_snapshot()

    @property
    def observer(self) -> ServingObserver:
        """The serving-quality plane: latency histograms, drift monitor
        (``observer.drift``), SLO tracker (``observer.slo``)."""
        return self._obs

    # -- lifecycle -----------------------------------------------------------
    def close(self, drain: bool = True,
              timeout_s: Optional[float] = None) -> None:
        """Graceful shutdown: stop admission, drain (or fail) the queue,
        join the worker, flush any pending drift window."""
        self._closed = True
        self._coalescer.close(drain=drain, timeout_s=timeout_s)
        if not self._coalescer.worker_alive():
            # only after the worker actually exited: a timed-out join
            # (hung tick) leaves it running, and a concurrent final
            # flush would race its unsynchronized window accumulation
            self._obs.final_flush()

    def __enter__(self) -> "PredictionServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close(drain=exc == (None, None, None))
        return False


def _device_health(registry) -> Dict[str, Any]:
    """Whether the active model's device answers: a one-element round trip
    (never raises)."""
    try:
        _, booster = registry.active()
        dev = booster._gbdt.device
        ok = float(torch.ones(1, device=dev).sum().cpu()) == 1.0
        return {"ok": ok, "device": str(dev)}
    except Exception as err:  # noqa: BLE001 - a probe answers anyway
        return {"ok": False, "error": repr(err)[:200]}
