"""Evaluation metrics (numpy, on the host).

Copies of the pointwise regression, binary, multiclass and cross-entropy
metrics of ``lightgbm_tpu/metrics.py`` (reference: src/metric/
{regression,binary,multiclass,xentropy}_metric.hpp). As in LightGBM's CUDA
build, metrics run on the host once per evaluation, off the training hot
path. A multiclass metric takes ``[K, N]`` raw scores. The ranking metrics
and ``auc_mu`` are ROADMAP A12b; the others ROADMAP A4.
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


_METRICS = {m.name: m for m in (
    L2Metric, RMSEMetric, L1Metric, QuantileMetric, HuberMetric, FairMetric,
    PoissonMetric, MAPEMetric, GammaMetric, GammaDevianceMetric,
    TweedieMetric, BinaryLoglossMetric, BinaryErrorMetric, AUCMetric,
    MultiLoglossMetric, MultiErrorMetric, CrossEntropyMetric,
    CrossEntropyLambdaMetric)}


def create_metrics(names: Sequence[str], config) -> List[Metric]:
    """Metric objects for canonical names (config.resolve_metrics)."""
    return [_METRICS[n](config) for n in names]
