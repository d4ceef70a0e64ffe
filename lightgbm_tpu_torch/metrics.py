"""Evaluation metrics (numpy, on the host).

Copies of the metrics of ``lightgbm_tpu/metrics.py`` (reference: src/metric/
{regression,binary,multiclass,rank,map,xentropy}_metric.hpp). As in
LightGBM's CUDA build, metrics run on the host once per evaluation, off the
training hot path. A multiclass metric takes ``[K, N]`` raw scores. The
ranking metrics (``ndcg``, ``map``) read the query boundaries of the set
they evaluate and report one value for each ``eval_at`` position, named
``ndcg@k`` (``eval_all``).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np

_EPS = 1e-15


class Metric:
    name = "metric"
    higher_better = False

    def __init__(self, config):
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = np.asarray(metadata.label, dtype=np.float64)
        self.weight = (np.asarray(metadata.weight, dtype=np.float64)
                       if metadata.weight is not None else None)
        self.sum_weight = (float(self.weight.sum()) if self.weight is not None
                           else float(num_data))

    def _avg(self, per_row: np.ndarray) -> float:
        if self.weight is not None:
            return float((per_row * self.weight).sum()
                         / max(self.sum_weight, _EPS))
        return float(per_row.mean())

    def eval(self, raw_score: np.ndarray, convert: Optional[Callable]) -> float:
        raise NotImplementedError


# -- regression (reference: src/metric/regression_metric.hpp) ---------------
class _PointwiseRegression(Metric):
    def point_loss(self, pred, label):
        raise NotImplementedError

    def eval(self, raw_score, convert):
        pred = (np.asarray(convert(raw_score)) if convert
                else np.asarray(raw_score))
        return self._avg(self.point_loss(pred.reshape(-1), self.label))


class L2Metric(_PointwiseRegression):
    name = "l2"

    def point_loss(self, pred, label):
        return (pred - label) ** 2


class RMSEMetric(L2Metric):
    name = "rmse"

    def eval(self, raw_score, convert):
        return float(np.sqrt(super().eval(raw_score, convert)))


class L1Metric(_PointwiseRegression):
    name = "l1"

    def point_loss(self, pred, label):
        return np.abs(pred - label)


class QuantileMetric(_PointwiseRegression):
    name = "quantile"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.get("alpha", 0.9))

    def point_loss(self, pred, label):
        d = label - pred
        return np.where(d >= 0, self.alpha * d, (self.alpha - 1.0) * d)


class HuberMetric(_PointwiseRegression):
    name = "huber"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.get("alpha", 0.9))

    def point_loss(self, pred, label):
        d = np.abs(pred - label)
        a = self.alpha
        return np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))


class FairMetric(_PointwiseRegression):
    name = "fair"

    def __init__(self, config):
        super().__init__(config)
        self.c = float(config.get("fair_c", 1.0))

    def point_loss(self, pred, label):
        x = np.abs(pred - label)
        c = self.c
        return c * x - c * c * np.log1p(x / c)


class PoissonMetric(_PointwiseRegression):
    name = "poisson"

    def point_loss(self, pred, label):
        return pred - label * np.log(np.maximum(pred, 1e-10))


class MAPEMetric(_PointwiseRegression):
    name = "mape"

    def point_loss(self, pred, label):
        return np.abs((label - pred) / np.maximum(1.0, np.abs(label)))


class GammaMetric(_PointwiseRegression):
    name = "gamma"

    def point_loss(self, pred, label):
        psafe = np.maximum(pred, 1e-10)
        return label / psafe + np.log(psafe)


class GammaDevianceMetric(_PointwiseRegression):
    name = "gamma_deviance"

    def point_loss(self, pred, label):
        f = label / np.maximum(pred, 1e-10)
        return 2.0 * (f - np.log(np.maximum(f, 1e-10)) - 1.0)


class TweedieMetric(_PointwiseRegression):
    name = "tweedie"

    def __init__(self, config):
        super().__init__(config)
        self.rho = float(config.get("tweedie_variance_power", 1.5))

    def point_loss(self, pred, label):
        p = np.maximum(pred, 1e-10)
        rho = self.rho
        return (-label * np.power(p, 1.0 - rho) / (1.0 - rho)
                + np.power(p, 2.0 - rho) / (2.0 - rho))


# -- binary (reference: src/metric/binary_metric.hpp) -----------------------
class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, raw_score, convert):
        p = (np.asarray(convert(raw_score)).reshape(-1) if convert
             else 1.0 / (1.0 + np.exp(-np.asarray(raw_score).reshape(-1))))
        p = np.clip(p, _EPS, 1.0 - _EPS)
        y = self.label
        return self._avg(-(y * np.log(p) + (1.0 - y) * np.log(1.0 - p)))


class BinaryErrorMetric(Metric):
    name = "binary_error"

    def eval(self, raw_score, convert):
        p = (np.asarray(convert(raw_score)).reshape(-1) if convert
             else np.asarray(raw_score).reshape(-1))
        pred = p > (0.5 if convert else 0.0)
        return self._avg((pred != (self.label > 0)).astype(np.float64))


def auc(label01: np.ndarray, score: np.ndarray, weight=None) -> float:
    """Weighted ROC-AUC via the rank statistic, ties counted half."""
    order = np.argsort(score, kind="mergesort")
    s = score[order]
    y = label01[order]
    w = weight[order] if weight is not None else np.ones_like(s)
    pos_w = w * (y > 0)
    neg_w = w * (y <= 0)
    total_pos = pos_w.sum()
    total_neg = neg_w.sum()
    if total_pos == 0 or total_neg == 0:
        return 1.0
    _, starts = np.unique(s, return_index=True)
    pos_per = np.add.reduceat(pos_w, starts)
    neg_per = np.add.reduceat(neg_w, starts)
    cum_neg_before = np.concatenate([[0.0], np.cumsum(neg_per)[:-1]])
    val = float((pos_per * (cum_neg_before + 0.5 * neg_per)).sum())
    return val / float(total_pos * total_neg)


class AUCMetric(Metric):
    name = "auc"
    higher_better = True

    def eval(self, raw_score, convert):
        return auc((self.label > 0).astype(np.float64),
                   np.asarray(raw_score).reshape(-1).astype(np.float64),
                   self.weight)


class AveragePrecisionMetric(Metric):
    """(reference: binary_metric.hpp AveragePrecisionMetric)"""
    name = "average_precision"
    higher_better = True

    def eval(self, raw_score, convert):
        score = np.asarray(raw_score).reshape(-1).astype(np.float64)
        y = (self.label > 0).astype(np.float64)
        w = self.weight if self.weight is not None else np.ones_like(y)
        order = np.argsort(-score, kind="mergesort")
        y, w = y[order], w[order]
        tp = np.cumsum(w * y)
        fp = np.cumsum(w * (1 - y))
        total_pos = tp[-1]
        if total_pos == 0:
            return 1.0
        precision = tp / np.maximum(tp + fp, _EPS)
        recall_delta = np.diff(np.concatenate([[0.0], tp])) / total_pos
        return float((precision * recall_delta).sum())


# -- multiclass (reference: src/metric/multiclass_metric.hpp) ---------------
class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, raw_score, convert):
        raw = np.asarray(raw_score)                        # [K, N]
        if convert:
            p = np.asarray(convert(raw.T))                 # [N, K]
        else:
            e = np.exp(raw - raw.max(axis=0, keepdims=True))
            p = (e / e.sum(axis=0, keepdims=True)).T
        idx = self.label.astype(np.int64)
        pt = np.clip(p[np.arange(len(idx)), idx], _EPS, None)
        return self._avg(-np.log(pt))


class MultiErrorMetric(Metric):
    name = "multi_error"

    def __init__(self, config):
        super().__init__(config)
        self.top_k = int(config.get("multi_error_top_k", 1))

    def eval(self, raw_score, convert):
        raw = np.asarray(raw_score)                        # [K, N]
        idx = self.label.astype(np.int64)
        if self.top_k <= 1:
            err = (raw.argmax(axis=0) != idx).astype(np.float64)
        else:
            true_score = raw[idx, np.arange(raw.shape[1])]
            rank = (raw > true_score[None, :]).sum(axis=0)
            err = (rank >= self.top_k).astype(np.float64)
        return self._avg(err)


class AucMuMetric(Metric):
    """Multiclass AUC-mu (reference: multiclass_metric.hpp, the auc_mu
    branch): the mean over class pairs of the AUC of a weighted score
    difference."""
    name = "auc_mu"
    higher_better = True

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.get("num_class", 1))
        k = self.num_class
        w = config.get("auc_mu_weights")
        if w is not None:
            if isinstance(w, str):
                w = [float(t) for t in w.split(",") if t.strip()]
            arr = np.asarray(list(w), np.float64).reshape(-1)
            if arr.size != k * k:
                raise ValueError(f"auc_mu_weights must have num_class^2 = "
                                 f"{k * k} entries, got {arr.size}")
            self.W = arr.reshape(k, k).copy()
        else:
            self.W = np.ones((k, k), np.float64)
        # the diagonal is always zero (reference: Config::GetAucMuWeights,
        # src/io/config.cpp:224)
        np.fill_diagonal(self.W, 0.0)

    def eval(self, raw_score, convert):
        raw = np.asarray(raw_score)                        # [K, N]
        idx = self.label.astype(np.int64)
        k = self.num_class
        aucs = []
        for a in range(k):
            for b in range(a + 1, k):
                sel = (idx == a) | (idx == b)
                if sel.sum() == 0 or (idx[sel] == a).all() \
                        or (idx[sel] == b).all():
                    continue
                # the separating direction (reference:
                # multiclass_metric.hpp:250-265): v = W[a] - W[b], decision
                # value (v[a] - v[b]) * (v . scores)
                v = self.W[a] - self.W[b]
                s = (v[a] - v[b]) * (v @ raw[:, sel])
                y = (idx[sel] == a).astype(np.float64)
                w = self.weight[sel] if self.weight is not None else None
                aucs.append(auc(y, s, w))
        return float(np.mean(aucs)) if aucs else 1.0


# -- ranking (reference: src/metric/rank_metric.hpp, NDCG via
#    dcg_calculator.cpp, and src/metric/map_metric.hpp) ----------------------
class _QueryMetric(Metric):
    higher_better = True

    def __init__(self, config):
        super().__init__(config)
        ks = config.get("eval_at", None) or [1, 2, 3, 4, 5]
        self.eval_at = [int(k) for k in ks]

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            raise ValueError(f"{self.name} metric requires query groups")
        self.qb = np.asarray(metadata.query_boundaries)

    def eval(self, raw_score, convert):
        return self.eval_all(raw_score)[0]

    def eval_all(self, raw_score) -> List[float]:
        raise NotImplementedError


class NDCGMetric(_QueryMetric):
    name = "ndcg"

    def __init__(self, config):
        super().__init__(config)
        self.label_gain = config.get("label_gain", None)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        max_label = int(self.label.max()) if len(self.label) else 0
        if self.label_gain is None:
            self.gains = (2.0 ** np.arange(max(max_label + 1, 2))) - 1.0
        else:
            self.gains = np.asarray(self.label_gain, dtype=np.float64)

    def eval_all(self, raw_score) -> List[float]:
        score = np.asarray(raw_score).reshape(-1).astype(np.float64)
        lbl = self.label.astype(np.int64)
        out = []
        for k in self.eval_at:
            vals = []
            for i in range(len(self.qb) - 1):
                s, e = self.qb[i], self.qb[i + 1]
                g = self.gains[lbl[s:e]]
                kk = min(k, e - s)
                order = np.argsort(-score[s:e], kind="mergesort")
                disc = 1.0 / np.log2(np.arange(kk) + 2.0)
                dcg = float((g[order[:kk]] * disc).sum())
                ideal = float((np.sort(g)[::-1][:kk] * disc).sum())
                vals.append(dcg / ideal if ideal > 0 else 1.0)
            out.append(float(np.mean(vals)) if vals else 1.0)
        return out


class MapMetric(_QueryMetric):
    name = "map"

    def eval_all(self, raw_score) -> List[float]:
        score = np.asarray(raw_score).reshape(-1).astype(np.float64)
        rel = (self.label > 0).astype(np.float64)
        out = []
        for k in self.eval_at:
            vals = []
            for i in range(len(self.qb) - 1):
                s, e = self.qb[i], self.qb[i + 1]
                order = np.argsort(-score[s:e], kind="mergesort")
                r = rel[s:e][order][:k]
                if r.sum() == 0:
                    vals.append(0.0)
                    continue
                prec = np.cumsum(r) / (np.arange(len(r)) + 1.0)
                vals.append(float((prec * r).sum() / min(rel[s:e].sum(), k)))
            out.append(float(np.mean(vals)) if vals else 1.0)
        return out


# -- cross-entropy (reference: src/metric/xentropy_metric.hpp) --------------
class CrossEntropyMetric(Metric):
    name = "cross_entropy"

    def eval(self, raw_score, convert):
        p = (np.asarray(convert(raw_score)).reshape(-1) if convert
             else 1.0 / (1.0 + np.exp(-np.asarray(raw_score).reshape(-1))))
        p = np.clip(p, _EPS, 1.0 - _EPS)
        y = self.label
        return self._avg(-(y * np.log(p) + (1 - y) * np.log(1 - p)))


class CrossEntropyLambdaMetric(Metric):
    name = "cross_entropy_lambda"

    def eval(self, raw_score, convert):
        raw = np.asarray(raw_score).reshape(-1)
        hhat = np.log1p(np.exp(raw))
        y = self.label
        return self._avg(hhat - y * np.log(np.maximum(1.0 - np.exp(-hhat),
                                                      _EPS)))


class KLDivMetric(Metric):
    """(reference: xentropy_metric.hpp KullbackLeiblerDivergence)"""
    name = "kldiv"

    def eval(self, raw_score, convert):
        p = (np.asarray(convert(raw_score)).reshape(-1) if convert
             else 1.0 / (1.0 + np.exp(-np.asarray(raw_score).reshape(-1))))
        p = np.clip(p, _EPS, 1.0 - _EPS)
        y = np.clip(self.label, 0.0, 1.0)
        ent = np.where((y > 0) & (y < 1),
                       y * np.log(np.maximum(y, _EPS))
                       + (1 - y) * np.log(np.maximum(1 - y, _EPS)), 0.0)
        ce = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return self._avg(ent + ce)


_METRICS = {m.name: m for m in (
    L2Metric, RMSEMetric, L1Metric, QuantileMetric, HuberMetric, FairMetric,
    PoissonMetric, MAPEMetric, GammaMetric, GammaDevianceMetric,
    TweedieMetric, BinaryLoglossMetric, BinaryErrorMetric, AUCMetric,
    AveragePrecisionMetric, MultiLoglossMetric, MultiErrorMetric,
    AucMuMetric, NDCGMetric, MapMetric, CrossEntropyMetric,
    CrossEntropyLambdaMetric, KLDivMetric)}


def create_metrics(names: Sequence[str], config) -> List[Metric]:
    """Metric objects for canonical names (config.resolve_metrics)."""
    return [_METRICS[n](config) for n in names]
