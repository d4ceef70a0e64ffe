"""The model registry: warm-then-flip hot swaps with rollback.

Counterpart of ``lightgbm_tpu/serving/registry.py``. A deploy warms the
candidate while the old model serves: its caches are built through every
warmed rung and endpoint (``Booster.warm_predict_ladder``: the device
trees, level heaps, quantized slab, TreeSHAP paths and tables, the
featurizer's state), one row of zeros must come back finite, and only then
does the active pointer flip, in one write under the registry's
reader-writer lock, under a deadline watchdog (``parallel/multihost.py``
``run_with_deadline``) and with an epoch token, so that a commit abandoned
at its deadline can never land later.

Any failure (a warm-up that raises, a non-finite probe, an injected
``hang@swap`` past the deadline) raises :class:`SwapFailed` and leaves the
registry as it was: the old model stays active. ``rollback()`` brings back
the previously active version. The JAX package's flight notes are ROADMAP
A19 and are left out.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..analysis.faultinject import active_plan
from ..utils import log
from ..utils.rwlock import RWLock
from .errors import ServingError, SwapFailed


class ModelRegistry:
    """Versioned boosters with one atomic ``active`` pointer."""

    def __init__(self):
        self._lock = RWLock()
        # serializes the token+commit phase of deploy (NOT the long
        # warmup, which stays concurrent): without it, two concurrent
        # deploys of DIFFERENT versions would stomp each other's commit
        # token and one would spuriously report "superseded"
        self._deploy_mu = threading.Lock()
        self._models: Dict[str, Any] = {}       # version -> Booster
        self._warm: Dict[str, Dict] = {}        # version -> warmup stats
        self._active: Optional[str] = None
        self._previous: Optional[str] = None
        self._commit_token: Optional[object] = None
        self.swaps = 0
        self.failed_swaps = 0

    # -- reads ---------------------------------------------------------------
    def active(self) -> Tuple[str, Any]:
        """(version, booster) snapshot — the per-tick model pin. A batch
        served from one snapshot is never split across models."""
        with self._lock.read():
            if self._active is None:
                raise ServingError("no active model deployed")
            return self._active, self._models[self._active]

    def get(self, version: str):
        with self._lock.read():
            return self._models[version]

    def versions(self) -> List[str]:
        with self._lock.read():
            return sorted(self._models)

    def active_version(self) -> Optional[str]:
        with self._lock.read():
            return self._active

    def warm_stats(self, version: Optional[str] = None) -> Optional[Dict]:
        with self._lock.read():
            v = version if version is not None else self._active
            return self._warm.get(v)

    def is_warm(self, version: Optional[str] = None) -> bool:
        stats = self.warm_stats(version)
        return bool(stats) and bool(stats.get("rungs"))

    # -- deploy / swap -------------------------------------------------------
    def deploy(self, version: str, booster, *, warm: bool = True,
               warm_max_rows: Optional[int] = None,
               health_check: bool = True,
               deadline_s: float = 30.0,
               prepare_drift: Optional[bool] = None) -> Dict:
        """Register ``booster`` as ``version`` and atomically make it
        active. Returns the candidate's warmup stats.

        The candidate is validated (device-servable), warmed, and
        health-checked BEFORE the commit; any failure raises
        :class:`SwapFailed` with the registry untouched. The commit
        itself runs under a ``deadline_s`` watchdog — a commit that
        hangs (``hang@swap``) is abandoned via an epoch token, so it can
        never flip the pointer after the deadline fired."""
        if version in self._models and self._models[version] is not booster:
            self.failed_swaps += 1
            raise SwapFailed(
                f"version {version!r} is already deployed with a "
                "different model; pick a new version string")
        try:
            inner = booster._device_serving_inner()
        except (NotImplementedError, AttributeError) as err:
            self.failed_swaps += 1
            raise SwapFailed(
                f"candidate {version!r} cannot take the device serving "
                f"path: {err}") from err
        if str(inner.config.get("tpu_predict_engine",
                                "batched")).lower() == "scan":
            # the scan path runs each request on its own shape: a server
            # on it has no ladder to warm and is never ready, so it is
            # refused up front
            self.failed_swaps += 1
            raise SwapFailed(
                f"candidate {version!r} uses tpu_predict_engine=scan "
                "(each request on its own shape); the serving layer "
                "needs the ladder of the walk or level engine")
        plan = active_plan(inner.config)
        warm_stats: Dict = {"rungs": [], "seconds": 0.0}
        try:
            if warm:
                warm_stats = booster.warm_predict_ladder(
                    max_rows=warm_max_rows)
            drift_armed = (prepare_drift if prepare_drift is not None
                           else int(inner.config.get(
                               "tpu_drift_flush_every", 0) or 0) > 0)
            if drift_armed:
                # the drift reference SHIPS with the model: materialize
                # the training-data bin-occupancy baseline AND the host
                # copy of the training margins here in the warm phase
                # (both cache), so the post-swap monitor attach — and
                # therefore the commit flip — never stalls on a
                # full-data occupancy pass. ``prepare_drift`` carries
                # the server's arming decision (per-server overrides
                # the config knob alone would miss)
                inner.drift_reference()
            if health_check:
                self._health_check(booster, version)
        except Exception as err:
            self.failed_swaps += 1
            raise SwapFailed(
                f"candidate {version!r} failed pre-swap warmup/health "
                f"check: {err}") from err

        self._deploy_mu.acquire()       # commit phase: one deploy at a
        #                                 time (warmup above ran outside)
        token = object()
        with self._lock.write():
            self._commit_token = token

        def _commit():
            # the hang/kill injection point sits INSIDE the deadline
            # watchdog, before the flip — the rollback contract under test
            plan.fire("swap", version=version)
            with self._lock.write():
                if self._commit_token is not token:
                    raise SwapFailed(
                        f"swap to {version!r} superseded after its "
                        "deadline; not committing")
                # re-verify the version guard UNDER the lock: the
                # unlocked pre-check races with a concurrent deploy of
                # the same version string during the (long) warmup phase
                if version in self._models \
                        and self._models[version] is not booster:
                    raise SwapFailed(
                        f"version {version!r} was deployed concurrently "
                        "with a different model; pick a new version "
                        "string")
                self._models[version] = booster
                self._warm[version] = warm_stats
                if self._active != version:
                    self._previous = self._active
                self._active = version
                self._commit_token = None

        from ..parallel.multihost import run_with_deadline
        try:
            run_with_deadline(_commit, deadline_s,
                              f"model swap to {version!r}")
        except BaseException as err:
            with self._lock.write():
                # a commit can outlive its deadline by a hair: the
                # watchdog fires while the worker is already inside the
                # write section (we block on it here, so by this read it
                # has finished) — if the flip actually LANDED, report
                # success instead of a phantom rollback that would leave
                # callers (and the server's post-swap rebinding) pinned
                # to a model that is no longer serving
                committed = (self._commit_token is not token
                             and self._models.get(version) is booster
                             and self._active == version)
                if self._commit_token is token:
                    # invalidate the abandoned commit worker: even if its
                    # thread wakes up later, the token check refuses it
                    self._commit_token = None
            if not committed:
                self.failed_swaps += 1
                log.warning(f"[serving] swap to {version!r} rolled back: "
                            f"{err!r}")
                if not isinstance(err, Exception):
                    raise               # injected kill: process-fatal
                raise SwapFailed(
                    f"swap to {version!r} did not commit (previous model "
                    f"stays active): {err}") from err
            log.warning(f"[serving] swap to {version!r} committed at the "
                        f"deadline edge ({err!r}); treating as success")
        finally:
            self._deploy_mu.release()
        self.swaps += 1
        log.info(f"[serving] model {version!r} active "
                 f"(warmed rungs: {warm_stats.get('rungs')}, endpoints: "
                 f"{warm_stats.get('endpoints')})")
        return warm_stats

    def _health_check(self, booster, version: str) -> None:
        """One probe row through the full serving path must be finite."""
        n_feat = len(booster._gbdt.mappers)
        out, n = booster.predict_serving(np.zeros((1, n_feat), np.float32))
        if not np.all(np.isfinite(np.asarray(out)[:n])):
            raise ValueError(
                f"health check produced non-finite predictions for "
                f"{version!r}")

    def warm_active(self, max_rows: Optional[int] = None) -> Dict:
        """Warm (or re-warm) the ACTIVE model's ladder and record the
        stats — the path for servers started with ``warm=False`` to
        reach readiness, and for re-warming after a ladder change."""
        version, booster = self.active()
        stats = booster.warm_predict_ladder(max_rows=max_rows)
        with self._lock.write():
            self._warm[version] = stats
        return stats

    # -- rollback ------------------------------------------------------------
    def rollback(self) -> str:
        """Re-activate the previously active version (bad-canary escape
        hatch); returns the version now active."""
        with self._lock.write():
            if self._previous is None or self._previous not in self._models:
                raise ServingError("no previous model version to roll "
                                   "back to")
            self._active, self._previous = self._previous, self._active
            log.warning(f"[serving] rolled back to model "
                        f"{self._active!r}")
            return self._active

    def retire(self, version: str) -> None:
        """Drop a non-active version from the registry."""
        with self._lock.write():
            if version == self._active:
                raise ServingError(
                    f"cannot retire the active version {version!r}; "
                    "deploy or roll back to another model first")
            self._models.pop(version, None)
            self._warm.pop(version, None)
            if self._previous == version:
                self._previous = None
