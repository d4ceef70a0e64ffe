"""Evaluation metrics (numpy, on the host).

Copies of ``binary_logloss`` and ``auc`` from ``lightgbm_tpu/metrics.py``
(reference: src/metric/binary_metric.hpp). As in LightGBM's CUDA build,
metrics run on the host once per evaluation, off the training hot path.
The other metrics are ROADMAP A4.
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


class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, raw_score, convert):
        p = (np.asarray(convert(raw_score)).reshape(-1) if convert
             else 1.0 / (1.0 + np.exp(-np.asarray(raw_score).reshape(-1))))
        p = np.clip(p, _EPS, 1.0 - _EPS)
        y = self.label
        return self._avg(-(y * np.log(p) + (1.0 - y) * np.log(1.0 - p)))


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


_METRICS = {"binary_logloss": BinaryLoglossMetric, "auc": AUCMetric}


def create_metrics(names: Sequence[str], config) -> List[Metric]:
    """Metric objects for canonical names (config.resolve_metrics)."""
    return [_METRICS[n](config) for n in names]
