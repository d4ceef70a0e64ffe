"""Objective functions, computed with torch ops on the training device.

Counterpart of ``lightgbm_tpu/objectives.py`` for the binary objective
(``BinaryLogloss``, ``objectives.py:272-335`` there; reference:
src/objective/binary_objective.hpp:21). Gradients depend only on the row's
own label, weight and score, because the compact grower keeps rows in a
per-tree permuted order: the trainer hands the label and weight columns in
that order to :meth:`BinaryLogloss.get_gradients`.

The other objectives are ROADMAP A12.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


class BinaryLogloss:
    """Binary cross-entropy on a sigmoid of the raw score."""

    name = "binary"

    def __init__(self, config):
        self.sigmoid = float(config.get("sigmoid", 1.0))
        self.is_unbalance = bool(config.get("is_unbalance", False))
        self.scale_pos_weight = float(config.get("scale_pos_weight", 1.0))

    def init(self, metadata, num_data: int) -> None:
        lbl = np.asarray(metadata.label)
        if not np.all(np.isin(np.unique(lbl), [0.0, 1.0])):
            raise ValueError("binary objective requires labels in {0, 1}")
        self.weight = metadata.weight
        if metadata.weight is not None:
            w = np.asarray(metadata.weight, np.float64)
            pos = float(w[lbl > 0].sum())
            neg = float(w.sum() - pos)
        else:
            pos = float((lbl > 0).sum())
            neg = float(len(lbl) - pos)
        # class weighting (reference: binary_objective.hpp:60-86 — the
        # minority class is upweighted to majority/minority)
        if self.is_unbalance and pos > 0 and neg > 0:
            self.label_weights = ((pos / neg, 1.0) if pos > neg
                                  else (1.0, neg / pos))   # (neg_w, pos_w)
        else:
            self.label_weights = (1.0, self.scale_pos_weight)
        self._pos, self._neg = pos, neg
        self._label01 = (lbl > 0).astype(np.float64)

    def get_gradients(self, score: torch.Tensor, label: torch.Tensor,
                      weight: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        sig = self.sigmoid
        y = (label > 0).to(torch.float32)
        p = torch.sigmoid(sig * score)
        neg_w, pos_w = self.label_weights
        w = torch.where(y > 0, pos_w, neg_w)
        grad = (p - y) * sig * w
        hess = p * (1.0 - p) * sig * sig * w
        if weight is not None:
            grad, hess = grad * weight, hess * weight
        return grad, hess

    def boost_from_score(self, class_id: int = 0) -> float:
        """sigmoid^-1 of the weighted positive rate (reference:
        binary_objective.hpp:94-108)."""
        if self.weight is not None:
            w = np.asarray(self.weight, np.float64)
            pavg = float((self._label01 * w).sum() / max(w.sum(), 1e-15))
        else:
            pavg = self._pos / max(self._pos + self._neg, 1.0)
        pavg = min(max(pavg, 1e-15), 1.0 - 1e-15)
        return float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)

    def convert_output(self, raw):
        """Raw score -> probability (numpy or torch in, same kind out)."""
        if isinstance(raw, torch.Tensor):
            return torch.sigmoid(self.sigmoid * raw)
        return 1.0 / (1.0 + np.exp(-self.sigmoid * np.asarray(raw)))


def create_objective(name: str, config):
    if name != "binary":
        raise NotImplementedError(
            f"objective {name!r} is not in the PyTorch port yet (ROADMAP A12)")
    return BinaryLogloss(config)
