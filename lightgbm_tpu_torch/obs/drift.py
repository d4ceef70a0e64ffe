"""Serving-quality observation: the drift monitor, latency attribution and
the SLO tracker.

Counterpart of ``lightgbm_tpu/obs/drift.py``. A served model's reference
distributions ship with it: the training rows' bin occupancy of each
feature (``BinnedDataset.reference_bin_distribution``) and a fixed-edge
histogram of their raw scores. Every served batch's bins, already on the
card (``ops/device_bin.py``), and every predict batch's raw scores fold
into int32 device accumulators with ``index_add_``, queued after the
response's copy to the host; every ``tpu_drift_flush_every`` ticks the
window comes to the host in one copy and PSI and KL (numpy) compare it
with the reference, over groups of adjacent bins of about equal reference
mass. ``drift_detected`` fires when a feature's PSI reaches
``tpu_drift_psi_threshold``, ``drift_cleared`` below half of it (no
flapping). Every completed request lands in a fixed-bucket latency
histogram by (endpoint, version) and its phase times (queue wait, serve,
completion) add up by endpoint; with ``tpu_serve_slo_ms`` the SLO tracker
keeps 10 s buckets of good and bad requests and multi-window burn rates.

The JAX package also writes each flush to the ``tpu_metrics_path`` stream,
notes its events in the flight recorder and renders Prometheus text: those
are ROADMAP A19, and a server with drift on and ``tpu_metrics_path`` set
raises ``NotImplementedError`` naming it.
"""
from __future__ import annotations

import bisect
import collections
import math
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils import log

#: probability floor of the PSI/KL terms: an empty bin gives a large but
#: finite term
PSI_EPS = 1e-4

#: the score distribution's name in drift events
SCORE_FEATURE = "__score__"

#: the latency histogram's bucket bounds, milliseconds (+Inf implied)
LATENCY_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0)

#: cap on the features in a flush record for very wide data (drifted ones
#: always kept)
PSI_MAP_CAP = 64
PSI_MAP_FULL_MAX = 256


# -- divergence math (host side, numpy; shared with tests/CLI) --------------
def equal_mass_groups(ref_probs: np.ndarray, n_groups: int) -> np.ndarray:
    """Merge adjacent bins into ~equal reference-mass groups: ``[..., B]``
    probability rows -> ``[..., B]`` int group ids in ``[0, n_groups)``,
    monotone along the bin axis.

    PSI over the raw mapper bins is biased upward: a 255-bin quantile
    mapper holds ~0.4% reference mass per bin, and any finite serving
    window leaves most bins empty, so every empty bin pays the epsilon
    floor penalty and UNSHIFTED traffic reads as drifted. The standard
    construction compares ~10-20 equal-population buckets; grouping by
    cumulative reference mass recovers exactly that from the mapper's
    quantile bins (a feature with fewer bins than groups keeps its bins
    1:1). Bins empty in BOTH distributions then share the floor and
    contribute nothing."""
    p = np.asarray(ref_probs, np.float64)
    cum_before = np.cumsum(p, axis=-1) - p
    return np.minimum((cum_before * n_groups).astype(np.int64),
                      n_groups - 1)


def group_counts(counts: np.ndarray, gid: np.ndarray,
                 n_groups: int) -> np.ndarray:
    """Sum ``[F, B]`` per-bin counts into ``[F, G]`` per-group counts."""
    counts = np.asarray(counts, np.float64)
    f = counts.shape[0]
    flat = gid + np.arange(f, dtype=np.int64)[:, None] * n_groups
    return np.bincount(flat.ravel(), weights=counts.ravel(),
                       minlength=f * n_groups).reshape(f, n_groups)


def psi_rows(ref: np.ndarray, cur: np.ndarray,
             valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Population Stability Index per row: ``sum_b (q-p) * ln(q/p)``.

    ``ref``/``cur`` are ``[..., B]`` probability rows; ``valid`` masks
    the padded bin tail of features with fewer than B bins."""
    p = np.maximum(np.asarray(ref, np.float64), PSI_EPS)
    q = np.maximum(np.asarray(cur, np.float64), PSI_EPS)
    t = (q - p) * np.log(q / p)
    if valid is not None:
        t = np.where(valid, t, 0.0)
    return t.sum(axis=-1)


def kl_rows(ref: np.ndarray, cur: np.ndarray,
            valid: Optional[np.ndarray] = None) -> np.ndarray:
    """``KL(cur || ref)`` per row, with the same floor/mask as PSI."""
    p = np.maximum(np.asarray(ref, np.float64), PSI_EPS)
    q = np.maximum(np.asarray(cur, np.float64), PSI_EPS)
    t = q * np.log(q / p)
    if valid is not None:
        t = np.where(valid, t, 0.0)
    return t.sum(axis=-1)


# -- the device accumulates (reference: ``_bin_accum_fn`` and
# ``_score_accum_fn``, ``lightgbm_tpu/obs/drift.py:144-190``) ----------------
def _bin_accum(occ: torch.Tensor, bins: torch.Tensor, n_valid: int,
               num_features: int, bin_width: int, packed: bool) -> None:
    """``occ [F*B] += onehot(bins)`` over the first ``n_valid`` rows of a
    served batch's bins as the featurizer made them (``[rung, F]``, or
    nibble-packed), with ``index_add_`` on int32 on their device."""
    from ..ops.packed import bin_values, unpack4
    full = bin_values(unpack4(bins, num_features) if packed else bins)
    idx = full + torch.arange(num_features, device=bins.device)[None, :] \
        * bin_width
    live = (torch.arange(bins.shape[0], device=bins.device)
            < n_valid).to(torch.int32)
    occ.index_add_(0, idx.reshape(-1),
                   live[:, None].expand(idx.shape).reshape(-1))


def _score_accum(hist: torch.Tensor, raw: torch.Tensor, n_valid: int,
                 lo: float, width: float) -> None:
    """``hist [K, SB] += bincount(clamp(floor((raw - lo) / width)))`` over
    the first ``n_valid`` columns of a ``[K, rung]`` raw score batch."""
    k, sb = hist.shape
    idx = torch.clamp(torch.floor((raw - lo) / width), 0, sb - 1).to(
        torch.int64)
    idx = idx + torch.arange(k, device=raw.device)[:, None] * sb
    live = (torch.arange(raw.shape[1], device=raw.device)
            < n_valid).to(torch.int32)
    hist.view(-1).index_add_(0, idx.reshape(-1),
                             live[None, :].expand(idx.shape).reshape(-1))


def _host_bin_counts(bins: np.ndarray, n: int, num_features: int,
                     bin_width: int) -> np.ndarray:
    """Host twin of the device accumulate (``tpu_serve_featurize=host``)."""
    b = np.asarray(bins[:n], np.int64)
    idx = b + np.arange(num_features, dtype=np.int64)[None, :] * bin_width
    return np.bincount(idx.ravel(), minlength=num_features * bin_width)


def _score_bincount(scores: np.ndarray, lo: float, width: float,
                    score_bins: int) -> np.ndarray:
    """``[K, SB]`` fixed-edge histogram with the device program's exact
    clamp semantics (under/overflow lands in the edge bins)."""
    s = np.asarray(scores, np.float64)
    idx = np.clip(np.floor((s - lo) / width), 0,
                  score_bins - 1).astype(np.int64)
    k = np.arange(idx.shape[0], dtype=np.int64)[:, None] * score_bins
    return np.bincount((idx + k).ravel(),
                       minlength=idx.shape[0] * score_bins
                       ).reshape(idx.shape[0], score_bins)


class DriftMonitor:
    """One model's drift state: reference distributions, the window's
    device accumulators and hysteresis-gated PSI events (reference:
    ``DriftMonitor``, ``lightgbm_tpu/obs/drift.py:214-496``). Built when a
    model becomes active, from ``GBDT.drift_reference()``."""

    def __init__(self, version: str, booster, *, flush_every: int,
                 psi_threshold: float, score_bins: int,
                 drift_bins: int = 16, min_rows: int = 0):
        inner = booster._gbdt
        probs, nbins, ref_scores = inner.drift_reference()
        self.version = str(version)
        self.flush_every = int(flush_every)
        self.threshold = float(psi_threshold)
        #: hysteresis: cleared only below half the threshold
        self.exit_threshold = 0.5 * self.threshold
        self.feature_names = list(inner.feature_names)
        self._ref = np.asarray(probs, np.float64)
        self._nbins = np.asarray(nbins, np.int64)
        self._F, self._B = self._ref.shape
        # PSI over ~equal-reference-mass groups of adjacent bins: fine
        # bins leave most of a window's bins empty and cry wolf
        self._G = max(2, min(int(drift_bins), self._B))
        self._gid = equal_mass_groups(self._ref, self._G)
        rg = group_counts(self._ref, self._gid, self._G)
        self._ref_g = rg / np.maximum(rg.sum(axis=1, keepdims=True), 1e-12)
        # PSI's sampling noise is about (G-1)/rows: events wait for windows
        # of 20 G rows (gauges and records update at every flush)
        self.min_rows = int(min_rows) if int(min_rows) > 0 \
            else 20 * self._G
        self._packed = bool(inner._pred_pack4)
        self._device = inner.device
        self._K = int(inner.num_class)
        self._SB = max(int(score_bins), 2)
        self._SG = max(2, min(self._G, self._SB))
        if ref_scores is not None:
            rs = np.asarray(ref_scores, np.float64).reshape(self._K, -1)
            lo, hi = float(rs.min()), float(rs.max())
            pad = 0.05 * (hi - lo) or 0.5
            self._lo, self._hi = lo - pad, hi + pad
            self._width = (self._hi - self._lo) / self._SB
            self._set_score_ref(_score_bincount(rs, self._lo, self._width,
                                                self._SB))
        else:
            # no training scores: the first flushed window is the baseline
            self._score_ref = None
            self._score_gid = None
            self._lo, self._hi = -10.0, 10.0
            self._width = (self._hi - self._lo) / self._SB
        self._occ_dev = None
        self._shist_dev = None
        self._occ_host = np.zeros(self._F * self._B, np.int64)
        self._shist_host = np.zeros((self._K, self._SB), np.int64)
        self.window_rows = 0
        self.score_rows = 0
        self.flushes = 0
        #: device-to-host copies: one a flush, none a tick
        self.host_syncs = 0
        self.events_total = 0
        self._drifted = np.zeros(self._F, bool)
        self._score_drifted = False
        self._last_psi = np.zeros(self._F)
        self._last_kl = np.zeros(self._F)
        self._last_score_psi: Optional[float] = None
        self._gauges: Dict[str, Any] = {}
        self._gmu = threading.Lock()

    def _set_score_ref(self, hist: np.ndarray) -> None:
        p = np.asarray(hist, np.float64)
        p = p / np.maximum(p.sum(axis=1, keepdims=True), 1)
        self._score_gid = equal_mass_groups(p, self._SG)
        g = group_counts(p, self._score_gid, self._SG)
        self._score_ref = g / np.maximum(g.sum(axis=1, keepdims=True),
                                         1e-12)

    def _reset_device(self) -> None:
        # int32 counts: a float32 count stops at 2^24 rows a bin
        self._occ_dev = torch.zeros(self._F * self._B, dtype=torch.int32,
                                    device=self._device)
        self._shist_dev = torch.zeros((self._K, self._SB),
                                      dtype=torch.int32, device=self._device)

    def observe_binned(self, binned, n: int) -> None:
        """Fold a served batch's bins into the occupancy window: on the
        device for the featurizer's bins, a host bincount for the host
        binner's (``tpu_serve_featurize=host``)."""
        if isinstance(binned, np.ndarray):
            self._occ_host += _host_bin_counts(binned, int(n), self._F,
                                               self._B)
        else:
            if self._occ_dev is None:
                self._reset_device()
            _bin_accum(self._occ_dev, binned, int(n), self._F, self._B,
                       self._packed)
        self.window_rows += int(n)

    def observe_scores(self, raw, n: int) -> None:
        """Fold a predict batch's raw scores ``[K, rung]`` into the score
        histogram window."""
        if isinstance(raw, np.ndarray):
            self._shist_host += _score_bincount(
                raw[:, :int(n)], self._lo, self._width, self._SB)
        else:
            if self._shist_dev is None:
                self._reset_device()
            _score_accum(self._shist_dev, raw, int(n), self._lo,
                         self._width)
        self.score_rows += int(n)

    def warm(self, rungs: Sequence[int] = ()) -> None:
        """Allocate the window's device accumulators before traffic
        (PyTorch compiles nothing: the JAX package lowers one accumulate
        program a rung here)."""
        self._reset_device()

    def _psi_keep(self, psi: np.ndarray) -> List[int]:
        if self._F <= PSI_MAP_FULL_MAX:
            return list(range(self._F))
        top = np.argsort(psi)[::-1][:PSI_MAP_CAP]
        return sorted(set(top.tolist())
                      | set(np.nonzero(self._drifted)[0].tolist()))

    def flush(self) -> Dict[str, Any]:
        """Close the window: one device-to-host copy of the accumulators,
        PSI and KL against the reference, hysteresis-gated events; returns
        the flush record."""
        occ = np.asarray(self._occ_host, np.float64).copy()
        shist = np.asarray(self._shist_host, np.float64).copy()
        if self._occ_dev is not None:
            self.host_syncs += 1
            both = torch.cat([self._occ_dev, self._shist_dev.reshape(-1)])
            both = both.cpu().numpy().astype(np.float64)
            occ += both[:occ.size]
            shist += both[occ.size:].reshape(shist.shape)
            self._reset_device()
        self._occ_host[:] = 0
        self._shist_host[:] = 0
        rows, srows = self.window_rows, self.score_rows
        self.window_rows = 0
        self.score_rows = 0
        flush_no = self.flushes + 1
        occ = occ.reshape(self._F, self._B)
        events: List[Tuple[str, str, float]] = []
        low_traffic = rows < self.min_rows
        if rows > 0:
            occ_g = group_counts(occ, self._gid, self._G)
            cur = occ_g / max(rows, 1)
            psi = psi_rows(self._ref_g, cur)
            klv = kl_rows(self._ref_g, cur)
            # a feature of one bin cannot drift in bin space
            psi = np.where(self._nbins > 1, psi, 0.0)
            klv = np.where(self._nbins > 1, klv, 0.0)
            if not low_traffic:
                entered = (psi >= self.threshold) & ~self._drifted
                cleared = (psi < self.exit_threshold) & self._drifted
                for j in np.nonzero(entered)[0]:
                    events.append(("drift_detected",
                                   self.feature_names[j], float(psi[j])))
                for j in np.nonzero(cleared)[0]:
                    events.append(("drift_cleared",
                                   self.feature_names[j], float(psi[j])))
                self._drifted |= entered
                self._drifted &= ~cleared
            self._last_psi, self._last_kl = psi, klv
        else:
            psi, klv = self._last_psi, self._last_kl
        score_psi = None
        if srows > 0:
            if self._score_ref is None:
                self._set_score_ref(shist)
            sg = group_counts(shist, self._score_gid, self._SG)
            curs = sg / np.maximum(sg.sum(axis=1, keepdims=True), 1)
            score_psi = float(psi_rows(self._score_ref, curs).max())
            if srows >= self.min_rows:
                if score_psi >= self.threshold and not self._score_drifted:
                    self._score_drifted = True
                    events.append(("drift_detected", SCORE_FEATURE,
                                   score_psi))
                elif score_psi < self.exit_threshold \
                        and self._score_drifted:
                    self._score_drifted = False
                    events.append(("drift_cleared", SCORE_FEATURE,
                                   score_psi))
            self._last_score_psi = score_psi
        self.events_total += len(events)
        jmax = int(np.argmax(psi)) if self._F else 0
        drifted = [self.feature_names[j]
                   for j in np.nonzero(self._drifted)[0]]
        keep = self._psi_keep(psi)
        record = {
            "version": self.version, "flush": flush_no,
            "window_rows": rows, "score_rows": srows,
            "threshold": self.threshold,
            "psi": {self.feature_names[j]: float(psi[j]) for j in keep},
            "kl": {self.feature_names[j]: float(klv[j]) for j in keep},
            "max_psi": float(psi[jmax]) if self._F else 0.0,
            "max_feature": self.feature_names[jmax] if self._F else None,
            "score_psi": score_psi,
            "score_drifted": self._score_drifted,
            "low_traffic": low_traffic,
            "min_rows": self.min_rows,
            "drifted": drifted,
            "events": [{"event": e, "feature": f, "psi": p}
                       for e, f, p in events],
        }
        with self._gmu:
            self._gauges = {
                "psi": record["psi"], "score_psi": record["score_psi"],
                "max_psi": record["max_psi"],
                "max_feature": record["max_feature"],
                "drifted": drifted, "score_drifted": self._score_drifted,
                "flushes": flush_no, "window_rows": rows,
                "events_total": self.events_total}
        self.flushes = flush_no     # last: the completion clients poll
        return record

    def gauges(self) -> Dict[str, Any]:
        with self._gmu:
            return dict(self._gauges)


class LatencyHistogram:
    """Fixed-bucket latency histogram (Prometheus ``le`` semantics)."""

    __slots__ = ("counts", "sum_ms", "count")

    def __init__(self):
        self.counts = [0] * (len(LATENCY_BUCKETS_MS) + 1)  # + overflow
        self.sum_ms = 0.0
        self.count = 0

    def observe(self, ms: float) -> None:
        self.counts[bisect.bisect_left(LATENCY_BUCKETS_MS, ms)] += 1
        self.sum_ms += float(ms)
        self.count += 1

    def snapshot(self) -> Dict[str, Any]:
        return {"counts": list(self.counts), "sum_ms": self.sum_ms,
                "count": self.count}


class SloTracker:
    """Rolling good/bad counts + multi-window error-budget burn rates.

    10 s buckets over a 1 h horizon; ``burn_rate(w)`` is the window's
    bad fraction over the allowed ``1 - target`` budget — 1.0 means
    spending the error budget exactly as fast as the SLO allows."""

    BUCKET_S = 10.0
    HORIZON_S = 3600.0
    WINDOWS_S = (("5m", 300.0), ("1h", 3600.0))

    def __init__(self, slo_ms: float, target: float):
        self.slo_ms = float(slo_ms)
        self.target = min(max(float(target), 0.0), 1.0 - 1e-9)
        self._n = int(self.HORIZON_S / self.BUCKET_S)
        self._good = np.zeros(self._n, np.int64)
        self._bad = np.zeros(self._n, np.int64)
        self._ids = np.full(self._n, -1, np.int64)
        self.good_total = 0
        self.bad_total = 0
        self.alerting = False

    def _slot(self, now: float) -> int:
        bid = int(now / self.BUCKET_S)
        s = bid % self._n
        if self._ids[s] != bid:       # lazily retire the stale horizon
            self._good[s] = 0
            self._bad[s] = 0
            self._ids[s] = bid
        return s

    def record(self, good: bool, now: Optional[float] = None) -> None:
        s = self._slot(time.monotonic() if now is None else now)
        if good:
            self._good[s] += 1
            self.good_total += 1
        else:
            self._bad[s] += 1
            self.bad_total += 1

    def window_counts(self, window_s: float,
                      now: Optional[float] = None) -> Tuple[int, int]:
        now = time.monotonic() if now is None else now
        bid = int(now / self.BUCKET_S)
        k = min(int(math.ceil(window_s / self.BUCKET_S)), self._n)
        ids = np.arange(bid - k + 1, bid + 1, dtype=np.int64)
        slots = ids % self._n
        live = self._ids[slots] == ids
        return (int(self._good[slots][live].sum()),
                int(self._bad[slots][live].sum()))

    def burn_rate(self, window_s: float,
                  now: Optional[float] = None) -> float:
        g, b = self.window_counts(window_s, now)
        t = g + b
        if t == 0:
            return 0.0
        return (b / t) / max(1.0 - self.target, 1e-9)

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Any]:
        out = {"slo_ms": self.slo_ms, "target": self.target,
               "good_total": self.good_total, "bad_total": self.bad_total,
               "alerting": self.alerting}
        for name, w in self.WINDOWS_S:
            out[f"burn_{name}"] = round(self.burn_rate(w, now), 4)
        return out


class ServingObserver:
    """A server's quality plane (reference: ``ServingObserver``,
    ``lightgbm_tpu/obs/drift.py:587-868``): the coalescer tells it of every
    finished request (``on_future_done``) and served tick
    (``on_tick_served``, the drift flush's cadence); the server hands the
    active monitor (``drift_for``) to the serving calls. Latency
    histograms are always on, drift with ``tpu_drift_flush_every > 0``,
    the SLO tracker with ``tpu_serve_slo_ms > 0``."""

    def __init__(self, cfg, *, slo_ms=None, slo_target=None,
                 drift_flush_every=None, drift_psi_threshold=None):
        def get(key, default):
            try:
                return cfg.get(key, default)
            except Exception:  # noqa: BLE001 - a config-less observer
                return default
        self.flush_every = int(
            drift_flush_every if drift_flush_every is not None
            else get("tpu_drift_flush_every", 0) or 0)
        if self.flush_every > 0 and str(get("tpu_metrics_path", "") or ""):
            raise NotImplementedError(
                "not in the PyTorch port yet: drift flush records written "
                "to tpu_metrics_path (ROADMAP A19)")
        self.psi_threshold = float(
            drift_psi_threshold if drift_psi_threshold is not None
            else get("tpu_drift_psi_threshold", 0.2) or 0.2)
        self.score_bins = int(get("tpu_drift_score_bins", 32) or 32)
        self.drift_bins = int(get("tpu_drift_bins", 16) or 16)
        self.min_rows = int(get("tpu_drift_min_rows", 0) or 0)
        slo_ms = float(slo_ms if slo_ms is not None
                       else get("tpu_serve_slo_ms", 0.0) or 0.0)
        target = float(slo_target if slo_target is not None
                       else get("tpu_serve_slo_target", 0.99) or 0.99)
        self.slo = SloTracker(slo_ms, target) if slo_ms > 0 else None
        # burn-rate transitions are checked about once a second
        self._next_alert_check = 0.0
        self._mu = threading.Lock()
        self._hists: Dict[Tuple[str, str], LatencyHistogram] = {}
        self._phases: Dict[str, Dict[str, float]] = {}
        #: the versions whose histograms are kept (a refit loop swaps
        #: forever)
        self._recent_versions: collections.deque = collections.deque(
            maxlen=4)
        self._drift: Optional[DriftMonitor] = None
        self._ticks = 0

    def attach_model(self, version: str, booster,
                     rungs: Sequence[int]) -> None:
        """A fresh drift monitor for the now active model (a swap resets
        the window: the reference is the model's), and the histograms of
        versions long swapped out dropped."""
        version = str(version)
        with self._mu:
            if version in self._recent_versions:
                self._recent_versions.remove(version)
            self._recent_versions.append(version)
            keep = set(self._recent_versions)
            self._hists = {k: h for k, h in self._hists.items()
                           if k[1] in keep}
        if self.flush_every <= 0:
            return
        mon = DriftMonitor(version, booster, flush_every=self.flush_every,
                           psi_threshold=self.psi_threshold,
                           score_bins=self.score_bins,
                           drift_bins=self.drift_bins,
                           min_rows=self.min_rows)
        mon.warm(rungs or ())
        with self._mu:
            self._drift = mon

    def drift_for(self, version) -> Optional[DriftMonitor]:
        """The active monitor when it belongs to the tick's model version
        (a swap landing mid-queue must not mix two models' windows)."""
        d = self._drift
        if d is not None and d.version == str(version):
            return d
        return None

    @property
    def drift(self) -> Optional[DriftMonitor]:
        return self._drift

    def on_shed(self, kind: str) -> None:
        """A request shed at admission is a failed request for the SLO."""
        if self.slo is None:
            return
        with self._mu:
            self.slo.record(False)
        self._check_slo_alert()

    def on_future_done(self, fut) -> None:
        err = fut._error
        ok = err is None
        lat = fut.latency_s
        ph = fut.phase_times()
        with self._mu:
            if ok and lat is not None:
                key = (fut.kind, str(fut.version))
                h = self._hists.get(key)
                if h is None:
                    h = self._hists[key] = LatencyHistogram()
                h.observe(lat * 1e3)
            if ph:
                d = self._phases.get(fut.kind)
                if d is None:
                    d = self._phases[fut.kind] = {
                        "queue_wait_s": 0.0, "serve_s": 0.0,
                        "complete_s": 0.0, "count": 0}
                for k, v in ph.items():
                    d[k] += v
                d["count"] += 1
            if self.slo is not None:
                self.slo.record(ok and lat is not None
                                and lat * 1e3 <= self.slo.slo_ms)
        if self.slo is not None:
            self._check_slo_alert()

    def on_tick_served(self, kind: str) -> None:
        """A served tick: flush the drift window when due, check the burn
        rates."""
        with self._mu:
            self._ticks += 1
            t = self._ticks
        d = self._drift
        if d is not None and self.flush_every > 0 \
                and t % self.flush_every == 0:
            d.flush()
        if self.slo is not None:
            self._check_slo_alert(force=True)

    def _check_slo_alert(self, force: bool = False) -> None:
        s = self.slo
        now = time.monotonic()
        with self._mu:
            if not force and now < self._next_alert_check:
                return
            self._next_alert_check = now + 1.0
            burns = {name: s.burn_rate(w, now) for name, w in s.WINDOWS_S}
            short = s.WINDOWS_S[0][0]
            if not s.alerting and all(v > 1.0 for v in burns.values()):
                # every window burning: a blip the long one absorbed
                # does not alert
                s.alerting = True
                log.warning(f"[serving] SLO burn: {burns}")
            elif s.alerting and burns[short] <= 1.0:
                s.alerting = False

    def final_flush(self) -> None:
        """Flush a partial window when the server closes."""
        d = self._drift
        try:
            if d is not None and (d.window_rows or d.score_rows):
                d.flush()
        except Exception as err:  # noqa: BLE001 - telemetry on shutdown
            log.warning(f"[serving] final drift flush failed: {err!r}")

    def latency(self) -> Dict[str, Any]:
        """Each (endpoint, version)'s latency histogram and each
        endpoint's summed phase seconds."""
        with self._mu:
            return {"histograms": {f"{k}/{v}": h.snapshot()
                                   for (k, v), h in self._hists.items()},
                    "phases": {k: dict(v) for k, v in self._phases.items()}}

    def snapshot(self) -> Dict[str, Any]:
        """The quality plane's scalars (reference: ``snapshot``)."""
        with self._mu:
            ticks = self._ticks
        out: Dict[str, Any] = {"ticks": ticks}
        d = self._drift
        if d is not None:
            g = d.gauges()
            out["drift"] = {
                "flushes": d.flushes, "host_syncs": d.host_syncs,
                "window_rows": d.window_rows,
                "events_total": d.events_total,
                "features_drifted": len(g.get("drifted") or ()),
                "max_psi": g.get("max_psi") or 0.0,
                "score_psi": g.get("score_psi") or 0.0,
                "score_drifted": bool(g.get("score_drifted"))}
        if self.slo is not None:
            with self._mu:
                out["slo"] = self.slo.snapshot()
        return out
