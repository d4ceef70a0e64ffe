"""Objective functions, computed with torch ops on the training device.

Counterpart of ``lightgbm_tpu/objectives.py`` (reference:
include/LightGBM/objective_function.h, families in
src/objective/{regression,binary,multiclass,xentropy}_objective.hpp).
Gradients depend only on the row's own label, weight and score(s): the
compact grower keeps rows in a per-tree permuted order, so the trainer hands
the label and weight columns in that order to ``get_gradients`` (the JAX
package's objectives read their own copies instead). ``score`` is ``[N]``
for one model a row and ``[K, N]`` for the multiclass objectives
(``num_model_per_iteration = K``), whose gradients come back ``[K, N]``.

Here: binary, the pointwise regression objectives that need no leaf
renewal (L2, Huber, Fair, Poisson, Gamma, Tweedie), the two cross-entropy
objectives and multiclass softmax and one-vs-all. The objectives that renew
leaf outputs after growth (L1, quantile, MAPE) and the ranking objectives
are ROADMAP A12b.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_EPS = 1e-15


class Objective:
    """Base objective (reference: ObjectiveFunction, objective_function.h)."""

    name = "custom"
    num_model_per_iteration = 1
    # gradients depend only on this row's (label, weight, scores): required
    # by the compact grower, whose rows live in a per-tree permuted order
    row_elementwise = True
    # the gradient discretizer's hessian scale is max h for a constant
    # hessian, else max h / bins (reference: IsConstantHessian); set on
    # every class, so that no subclass inherits its parent's flag
    is_constant_hessian = False

    def __init__(self, config):
        self.config = config

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self._label_np = np.asarray(metadata.label, np.float64)
        self.weight = metadata.weight

    def get_gradients(self, score: torch.Tensor, label: torch.Tensor,
                      weight: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError

    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    def _convert(self, raw: torch.Tensor) -> torch.Tensor:
        return raw

    def convert_output(self, raw):
        """Raw score -> output (numpy or torch in, same kind out)."""
        if isinstance(raw, torch.Tensor):
            return self._convert(raw)
        return self._convert(torch.from_numpy(
            np.asarray(raw, np.float64))).numpy()

    def _avg_label(self) -> float:
        lbl = self._label_np
        if self.weight is not None:
            w = np.asarray(self.weight, np.float64)
            return float((lbl * w).sum() / max(w.sum(), _EPS))
        return float(lbl.mean())


def _weighted(grad, hess, weight):
    if weight is not None:
        return grad * weight, hess * weight
    return grad, hess


# ---------------------------------------------------------------------------
# Regression family (reference: src/objective/regression_objective.hpp)
# ---------------------------------------------------------------------------
class RegressionL2(Objective):
    """L2 loss (reference: RegressionL2loss, regression_objective.hpp:93)."""

    name = "regression"
    is_constant_hessian = True

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = bool(config.get("reg_sqrt", False))

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.sqrt:
            # in f32, as the labels the gradients see
            self._label_np = self._target(np.asarray(
                metadata.label, np.float32)).astype(np.float64)

    def _target(self, label):
        """The label the loss fits: sign(y) sqrt(|y|) with ``reg_sqrt``."""
        if not self.sqrt:
            return label
        if isinstance(label, torch.Tensor):
            return torch.sign(label) * torch.sqrt(torch.abs(label))
        return np.sign(label) * np.sqrt(np.abs(label))

    def get_gradients(self, score, label, weight=None):
        grad = score - self._target(label)
        return _weighted(grad, torch.ones_like(score), weight)

    def boost_from_score(self, class_id: int = 0) -> float:
        return self._avg_label()

    def _convert(self, raw):
        return torch.sign(raw) * raw * raw if self.sqrt else raw


class RegressionHuber(RegressionL2):
    """Huber loss (reference: RegressionHuberLoss,
    regression_objective.hpp:234)."""

    name = "huber"
    is_constant_hessian = True

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.get("alpha", 0.9))

    def get_gradients(self, score, label, weight=None):
        diff = score - self._target(label)
        grad = torch.where(torch.abs(diff) <= self.alpha, diff,
                           torch.sign(diff) * self.alpha)
        return _weighted(grad, torch.ones_like(score), weight)


class RegressionFair(RegressionL2):
    """Fair loss (reference: RegressionFairLoss,
    regression_objective.hpp:290)."""

    name = "fair"
    is_constant_hessian = False

    def __init__(self, config):
        super().__init__(config)
        self.c = float(config.get("fair_c", 1.0))

    def get_gradients(self, score, label, weight=None):
        diff = score - self._target(label)
        c = self.c
        grad = c * diff / (torch.abs(diff) + c)
        hess = c * c / ((torch.abs(diff) + c) ** 2)
        return _weighted(grad, hess, weight)


class RegressionPoisson(RegressionL2):
    """Poisson regression on log-link scores (reference:
    RegressionPoissonLoss, regression_objective.hpp:341)."""

    name = "poisson"
    is_constant_hessian = False

    def __init__(self, config):
        super().__init__(config)
        self.max_delta = float(config.get("poisson_max_delta_step", 0.7))

    def get_gradients(self, score, label, weight=None):
        grad = torch.exp(score) - label
        hess = torch.exp(score + self.max_delta)
        return _weighted(grad, hess, weight)

    def boost_from_score(self, class_id: int = 0) -> float:
        return float(np.log(max(self._avg_label(), _EPS)))

    def _convert(self, raw):
        return torch.exp(raw)


class RegressionGamma(RegressionPoisson):
    """Gamma deviance on log-link scores (reference: RegressionGammaLoss,
    regression_objective.hpp:578)."""

    name = "gamma"
    is_constant_hessian = False

    def get_gradients(self, score, label, weight=None):
        e = torch.exp(-score)
        return _weighted(1.0 - label * e, label * e, weight)


class RegressionTweedie(RegressionPoisson):
    """Tweedie deviance on log-link scores (reference:
    RegressionTweedieLoss, regression_objective.hpp:612)."""

    name = "tweedie"
    is_constant_hessian = False

    def __init__(self, config):
        super().__init__(config)
        self.rho = float(config.get("tweedie_variance_power", 1.5))

    def get_gradients(self, score, label, weight=None):
        rho = self.rho
        e1 = torch.exp((1.0 - rho) * score)
        e2 = torch.exp((2.0 - rho) * score)
        grad = -label * e1 + e2
        hess = -label * (1.0 - rho) * e1 + (2.0 - rho) * e2
        return _weighted(grad, hess, weight)


# ---------------------------------------------------------------------------
# Binary (reference: src/objective/binary_objective.hpp:21)
# ---------------------------------------------------------------------------
class BinaryLogloss(Objective):
    """Binary cross-entropy on a sigmoid of the raw score."""

    name = "binary"
    is_constant_hessian = False

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.get("sigmoid", 1.0))
        self.is_unbalance = bool(config.get("is_unbalance", False))
        self.scale_pos_weight = float(config.get("scale_pos_weight", 1.0))

    def init(self, metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        lbl = np.asarray(metadata.label)
        if not np.all(np.isin(np.unique(lbl), [0.0, 1.0])):
            raise ValueError("binary objective requires labels in {0, 1}")
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

    def get_gradients(self, score, label, weight=None):
        sig = self.sigmoid
        y = (label > 0).to(torch.float32)
        p = torch.sigmoid(sig * score)
        neg_w, pos_w = self.label_weights
        w = torch.where(y > 0, pos_w, neg_w)
        grad = (p - y) * sig * w
        hess = p * (1.0 - p) * sig * sig * w
        return _weighted(grad, hess, weight)

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

    def _convert(self, raw):
        return torch.sigmoid(self.sigmoid * raw)


# ---------------------------------------------------------------------------
# Multiclass (reference: src/objective/multiclass_objective.hpp)
# ---------------------------------------------------------------------------
class _Multiclass(Objective):
    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.get("num_class", 1))
        if self.num_class <= 1:
            raise ValueError(f"{self.name} requires num_class > 1")
        self.num_model_per_iteration = self.num_class

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        lbl = np.asarray(metadata.label).astype(np.int32)
        if lbl.min() < 0 or lbl.max() >= self.num_class:
            raise ValueError(
                f"multiclass labels must be in [0, {self.num_class}); got "
                f"range [{lbl.min()}, {lbl.max()}]")
        self._class_rates = (np.bincount(lbl, minlength=self.num_class)
                             / max(len(lbl), 1))

    def _onehot(self, label: torch.Tensor) -> torch.Tensor:
        classes = torch.arange(self.num_class, dtype=torch.float32,
                               device=label.device)
        return (label[None, :] == classes[:, None]).to(torch.float32)


class MulticlassSoftmax(_Multiclass):
    """Softmax over the K score rows (reference: MulticlassSoftmax,
    multiclass_objective.hpp:24). One tree per class per iteration."""

    name = "multiclass"
    is_constant_hessian = False

    def get_gradients(self, score, label, weight=None):
        p = torch.softmax(score, dim=0)                       # [K, N]
        grad = p - self._onehot(label)
        factor = self.num_class / (self.num_class - 1.0)
        hess = factor * p * (1.0 - p)
        return _weighted(grad, hess, None if weight is None
                         else weight[None, :])

    def _convert(self, raw):
        return torch.softmax(raw, dim=-1)                     # [..., K]


class MulticlassOVA(_Multiclass):
    """One-vs-all: K independent sigmoid losses (reference: MulticlassOVA,
    multiclass_objective.hpp:186)."""

    name = "multiclassova"
    is_constant_hessian = False

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.get("sigmoid", 1.0))

    def get_gradients(self, score, label, weight=None):
        sig = self.sigmoid
        p = torch.sigmoid(sig * score)
        grad = (p - self._onehot(label)) * sig
        hess = p * (1.0 - p) * sig * sig
        return _weighted(grad, hess, None if weight is None
                         else weight[None, :])

    def boost_from_score(self, class_id: int = 0) -> float:
        pavg = min(max(float(self._class_rates[class_id]), 1e-15), 1 - 1e-15)
        return float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)

    def _convert(self, raw):
        return torch.sigmoid(self.sigmoid * raw)


# ---------------------------------------------------------------------------
# Cross-entropy on labels in [0, 1] (reference:
# src/objective/xentropy_objective.hpp:44, :185)
# ---------------------------------------------------------------------------
class CrossEntropy(Objective):
    name = "cross_entropy"
    is_constant_hessian = False

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        lbl = self._label_np
        if lbl.min() < 0 or lbl.max() > 1:
            raise ValueError("cross_entropy labels must lie in [0, 1]")

    def get_gradients(self, score, label, weight=None):
        p = torch.sigmoid(score)
        return _weighted(p - label, p * (1.0 - p), weight)

    def boost_from_score(self, class_id: int = 0) -> float:
        pavg = min(max(self._avg_label(), 1e-15), 1 - 1e-15)
        return float(np.log(pavg / (1.0 - pavg)))

    def _convert(self, raw):
        return torch.sigmoid(raw)


class CrossEntropyLambda(Objective):
    """The intensity parametrization (reference: CrossEntropyLambda,
    xentropy_objective.hpp:185)."""

    name = "cross_entropy_lambda"
    is_constant_hessian = False

    def get_gradients(self, score, label, weight=None):
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-hhat)
        enf = torch.exp(-score)
        grad = (1.0 - label / torch.clamp(z, min=_EPS)) / (1.0 + enf)
        c = 1.0 / (1.0 - torch.exp(-epf))
        hess = epf / ((1.0 + epf) ** 2) * (
            1.0 + label * (1.0 - c + epf * c * c)
            / torch.clamp(z * z, min=_EPS) * z)
        # guard the blow-ups near score -> -inf
        grad = torch.nan_to_num(grad, nan=0.0, posinf=0.0, neginf=0.0)
        hess = torch.clamp(torch.nan_to_num(hess, nan=1.0, posinf=1.0,
                                            neginf=_EPS), min=_EPS)
        return _weighted(grad, hess, weight)

    def boost_from_score(self, class_id: int = 0) -> float:
        avg = max(self._avg_label(), 1e-15)
        return float(np.log(np.expm1(avg)) if avg < 30 else avg)

    def _convert(self, raw):
        return torch.log1p(torch.exp(raw))


# the objectives the port trains, by canonical name (config.py)
OBJECTIVES = {
    "regression": RegressionL2, "huber": RegressionHuber,
    "fair": RegressionFair, "poisson": RegressionPoisson,
    "gamma": RegressionGamma, "tweedie": RegressionTweedie,
    "binary": BinaryLogloss, "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA, "xentropy": CrossEntropy,
    "xentlambda": CrossEntropyLambda,
}


def create_objective(name: str, config) -> Objective:
    """The objective of a canonical name (``Config`` resolves aliases)."""
    if name not in OBJECTIVES:
        raise NotImplementedError(
            f"objective {name!r} is not in the PyTorch port yet (ROADMAP "
            "A12b)")
    return OBJECTIVES[name](config)
