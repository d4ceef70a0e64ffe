"""Objective functions, computed with torch ops on the training device.

Counterpart of ``lightgbm_tpu/objectives.py`` (reference:
include/LightGBM/objective_function.h, families in
src/objective/{regression,binary,multiclass,xentropy}_objective.hpp).
A pointwise objective's gradients depend only on the row's own label,
weight and score(s): the compact grower keeps rows in a per-tree permuted
order, so the trainer hands the label and weight columns in that order to
``get_gradients`` (the JAX package's objectives read their own copies
instead). ``score`` is ``[N]`` for one model a row and ``[K, N]`` for the
multiclass objectives (``num_model_per_iteration = K``), whose gradients
come back ``[K, N]``.

Here: binary, the regression family (L2, L1, Huber, Fair, Poisson,
quantile, MAPE, Gamma, Tweedie; L1, quantile and MAPE renew their leaf
outputs after growth, ``renew_leaves``, see ``ops/renew.py``), the two
cross-entropy objectives, multiclass softmax and one-vs-all, and the
ranking objectives ``lambdarank`` and ``rank_xendcg``. A ranking
objective's gradients couple the rows of a query (``row_elementwise``
False): it keeps its own label, weight and query arrays in the dataset's
row order from ``init`` and takes only the scores, in that order.
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
    # leaf outputs become each leaf's weighted renew_alpha-quantile of its
    # residuals after growth (reference: RenewTreeOutput)
    renew_leaves = False
    is_ranking = False
    # gradients change from call to call with equal scores (random draws,
    # state updated inside get_gradients): the compact grower's external
    # gradient route is closed to such an objective
    is_stochastic = False

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


class RegressionL1(RegressionL2):
    """L1 loss; leaf outputs renewed to the leaf's weighted median of its
    residuals (reference: RegressionL1loss, regression_objective.hpp:165)."""

    name = "regression_l1"
    is_constant_hessian = True
    renew_leaves = True
    renew_alpha = 0.5

    def get_gradients(self, score, label, weight=None):
        grad = torch.sign(score - self._target(label))
        return _weighted(grad, torch.ones_like(score), weight)


class RegressionQuantile(RegressionL2):
    """Quantile (pinball) loss with each leaf renewed to its weighted
    alpha-quantile (reference: RegressionQuantileloss,
    regression_objective.hpp:417)."""

    name = "quantile"
    is_constant_hessian = True
    renew_leaves = True

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.get("alpha", 0.9))
        self.renew_alpha = self.alpha

    def get_gradients(self, score, label, weight=None):
        diff = score - self._target(label)
        grad = torch.where(diff >= 0, 1.0 - self.alpha, -self.alpha)
        return _weighted(grad, torch.ones_like(score), weight)


class RegressionMAPE(RegressionL2):
    """MAPE loss (reference: RegressionMAPELOSS,
    regression_objective.hpp:498). ``init`` folds the label weight
    ``1 / max(1, |label|)`` into ``self.weight``, as the JAX package does:
    the gradients on both growers take it (the compact grower's carried
    weight column is the objective's). Leaf renewal, as in the JAX
    package, weighs rows by the metadata weight on the masked grower and by
    that carried column, label weight included, on the compact grower
    (ROADMAP C, notes)."""

    name = "mape"
    is_constant_hessian = True
    renew_leaves = True
    renew_alpha = 0.5

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        lbl = self._label_np.astype(np.float32)
        lw = (np.float32(1.0) / np.maximum(np.float32(1.0), np.abs(lbl)))
        self.weight = lw if self.weight is None else \
            np.asarray(self.weight, np.float32) * lw

    def get_gradients(self, score, label, weight=None):
        grad = torch.sign(score - self._target(label))
        return _weighted(grad, torch.ones_like(score), weight)


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


# ---------------------------------------------------------------------------
# Ranking (reference: src/objective/rank_objective.hpp, LambdarankNDCG :138,
# RankXENDCG :378)
# ---------------------------------------------------------------------------
def _pad_queries(boundaries: np.ndarray) -> Tuple[np.ndarray, int]:
    """``[Q, M]`` row indices of the queries (-1 pads each to the longest,
    M) from the query boundaries."""
    sizes = np.diff(boundaries)
    q = len(sizes)
    m = int(sizes.max()) if q else 1
    pos = np.arange(m, dtype=np.int64)[None, :]
    idx = boundaries[:-1, None].astype(np.int64) + pos
    return np.where(pos < sizes[:, None], idx, -1), m


class _Ranking(Objective):
    """The query layout both ranking objectives share (their flags are set
    on each of them), made once on the host at ``init`` and copied to a
    device at its first use: the padded
    ``[Q, M]`` row matrix, its mask, and the flat positions of its real
    entries, which list the rows in dataset order (queries are contiguous),
    so one gather takes ``[Q, M]`` values back to ``[N]`` rows."""

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            raise ValueError("ranking objective requires query groups "
                             "(set_group)")
        idx, self.max_query = _pad_queries(
            np.asarray(metadata.query_boundaries))
        self._query_rows = idx
        self._host = {"query_index": np.maximum(idx, 0),
                      "query_mask": idx >= 0,
                      "flat_rows": np.flatnonzero(idx >= 0)}
        self._dev = {}

    def _arrays(self, device) -> dict:
        """The host arrays on ``device`` (copied once a device)."""
        key = str(device)
        if key not in self._dev:
            self._dev[key] = {k: torch.from_numpy(np.ascontiguousarray(v))
                              .to(device) for k, v in self._host.items()}
        return self._dev[key]

    @staticmethod
    def _check_args(label, weight):
        if label is not None or weight is not None:
            raise ValueError("a ranking objective uses its own label and "
                             "weight in dataset order; pass scores only")

    def _to_rows(self, a, vals: torch.Tensor) -> torch.Tensor:
        """``[Q, M]`` values -> ``[N]`` in dataset row order."""
        return vals.reshape(-1)[a["flat_rows"]]


class LambdarankNDCG(_Ranking):
    """LambdaRank with |delta NDCG| weighting (reference: LambdarankNDCG,
    rank_objective.hpp:138-320), as the JAX package computes it: the
    queries padded to ``[Q, M]``, each sorted by score (a stable sort, so
    tied scores keep document order: at the first iteration every score
    of a query ties, and that order is the gradient), and the pairs of
    sorted positions (i < truncation level, j > i) evaluated as one
    ``[Qc, T, M]`` block a chunk of queries. The chunk only bounds memory:
    each query's gradients depend on its own rows alone.

    With ``position`` the scores are debiased by per-position biases, a
    device tensor that every call updates by a Newton step with the
    learning rate as its step (reference: UpdatePositionBiasFactors,
    rank_objective.hpp:296-331); the objective is then stochastic."""

    name = "lambdarank"
    is_ranking = True
    row_elementwise = False
    is_stochastic = False
    is_constant_hessian = False
    renew_leaves = False
    # pair-block elements a chunk: [Qc, T, M] f32 temporaries of 64 MiB
    _CHUNK_ELEMS = 1 << 24

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.get("sigmoid", 2.0))
        self.norm = bool(config.get("lambdarank_norm", True))
        self.truncation_level = int(config.get(
            "lambdarank_truncation_level", 30))
        self.label_gain = config.get("label_gain", None)
        self.bias_reg = float(config.get(
            "lambdarank_position_bias_regularization", 0.0))
        self.bias_lr = float(config.get("learning_rate", 0.1))

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        idx = self._query_rows
        lbl = np.asarray(metadata.label).astype(np.int32)
        max_label = int(lbl.max()) if len(lbl) else 0
        if self.label_gain is None:
            gains = (2.0 ** np.arange(max(max_label + 1, 2))) - 1.0
        else:
            gains = np.asarray(self.label_gain, dtype=np.float64)
            if len(gains) <= max_label:
                raise ValueError("label_gain shorter than max label + 1")
        row_gain = gains[lbl]
        # inverse max DCG a query, over the truncation level (reference:
        # LambdarankNDCG::Init)
        m = self.max_query
        gp = np.where(idx >= 0, row_gain[np.maximum(idx, 0)], -np.inf)
        gp = -np.sort(-gp, axis=1)
        k = min(m, self.truncation_level)
        disc = 1.0 / np.log2(np.arange(k) + 2.0)
        mdcg = np.sum(np.where(np.isfinite(gp[:, :k]), gp[:, :k], 0.0)
                      * disc[None, :], axis=1)
        self._host["row_gain"] = row_gain.astype(np.float32)
        self._host["inv_max_dcg"] = np.where(
            mdcg > 0, 1.0 / np.maximum(mdcg, 1e-300), 0.0).astype(np.float32)
        if self.weight is not None:
            self._host["weight"] = np.asarray(self.weight, np.float32)
        self.pos_biases = None
        if metadata.position is not None:
            pos = np.asarray(metadata.position).astype(np.int64)
            if len(pos) != num_data:
                raise ValueError("position length != num_data")
            self.num_position_ids = int(pos.max()) + 1
            wts = (np.asarray(metadata.weight, np.float64)
                   if metadata.weight is not None else np.ones(num_data))
            self._host["positions"] = pos
            self._host["pos_counts"] = np.bincount(
                pos, weights=(wts > 0).astype(np.float64),
                minlength=self.num_position_ids).astype(np.float32)
            self.is_stochastic = True

    def _chunk_grads(self, s, g, mask, inv_max_dcg):
        """Lambda gradients of one chunk of padded queries ``[Qc, M]``
        (reference: rank_objective.hpp:222-263)."""
        qc, m = s.shape
        t = min(self.truncation_level, m)
        sig = self.sigmoid
        dev = s.device
        order = torch.argsort(-s, dim=1, stable=True)
        rank_of = torch.empty_like(order).scatter_(
            1, order, torch.arange(m, device=dev).expand(qc, m))
        s_s = torch.gather(s, 1, order)
        g_s = torch.gather(g, 1, order)
        m_s = torch.gather(mask, 1, order)
        disc = 1.0 / torch.log2(torch.arange(m, dtype=torch.float32,
                                             device=dev) + 2.0)
        s_i, s_j = s_s[:, :t, None], s_s[:, None, :]
        g_i, g_j = g_s[:, :t, None], g_s[:, None, :]
        d_i, d_j = disc[None, :t, None], disc[None, None, :]
        upper = (torch.arange(t, device=dev)[:, None]
                 < torch.arange(m, device=dev)[None, :])
        pair_valid = (m_s[:, :t, None] & m_s[:, None, :] & (g_i != g_j)
                      & upper[None])
        delta = torch.abs((g_i - g_j) * (d_i - d_j)) \
            * inv_max_dcg[:, None, None]
        # lambda goes to the higher-labelled document of the pair
        i_high = g_i > g_j
        ds_high = torch.where(i_high, s_i - s_j, s_j - s_i)
        if self.norm:
            # score-distance regularization where the query's best and
            # worst scores differ (reference: rank_objective.hpp:242-244)
            n_valid = m_s.sum(dim=1)
            best = s_s[:, 0]
            worst = torch.gather(
                s_s, 1, torch.clamp(n_valid - 1, min=0)[:, None])[:, 0]
            delta = torch.where((best != worst)[:, None, None],
                                delta / (0.01 + torch.abs(ds_high)), delta)
        p = torch.sigmoid(sig * ds_high)
        lam_h = torch.where(pair_valid, sig * (p - 1.0) * delta, 0.0)
        hes = torch.where(pair_valid, sig * sig * p * (1.0 - p) * delta, 0.0)
        lam_i = torch.where(i_high, lam_h, -lam_h)
        pad = (0, m - t)
        grad_s = torch.nn.functional.pad(lam_i.sum(dim=2), pad) \
            - lam_i.sum(dim=1)
        hess_s = torch.nn.functional.pad(hes.sum(dim=2), pad) \
            + hes.sum(dim=1)
        if self.norm:
            # (reference: norm_, rank_objective.hpp:259-263)
            sum_l = 2.0 * (-lam_h).sum(dim=(1, 2))
            scale = torch.where(
                sum_l > 0, torch.log2(1.0 + sum_l)
                / torch.clamp(sum_l, min=_EPS), 1.0)
            grad_s = grad_s * scale[:, None]
            hess_s = hess_s * scale[:, None]
        # back to document order within the query
        return torch.gather(grad_s, 1, rank_of), \
            torch.gather(hess_s, 1, rank_of)

    def get_gradients(self, score, label=None, weight=None):
        """``[N]`` gradients and hessians of ``[N]`` scores in dataset row
        order."""
        self._check_args(label, weight)
        a = self._arrays(score.device)
        if "positions" in a:
            if self.pos_biases is None:
                self.pos_biases = torch.zeros(self.num_position_ids,
                                              dtype=torch.float32,
                                              device=score.device)
            # the ranking sees position-debiased scores (reference:
            # rank_objective.hpp:70)
            score = score + self.pos_biases[a["positions"]]
        idx, mask = a["query_index"], a["query_mask"]
        s = torch.where(mask, score[idx], -torch.inf)
        g = torch.where(mask, a["row_gain"][idx], 0.0)
        q, m = s.shape
        t = min(self.truncation_level, m)
        chunk = max(1, self._CHUNK_ELEMS // (t * m))
        parts = [self._chunk_grads(s[c:c + chunk], g[c:c + chunk],
                                   mask[c:c + chunk],
                                   a["inv_max_dcg"][c:c + chunk])
                 for c in range(0, q, chunk)]
        grad = self._to_rows(a, torch.cat([p[0] for p in parts]))
        hess = self._to_rows(a, torch.cat([p[1] for p in parts]))
        grad, hess = _weighted(grad, hess, a.get("weight"))
        if "positions" in a:
            # Newton step on the position biases, fed the weighted lambdas
            # (reference: UpdatePositionBiasFactors)
            pid, cnt = a["positions"], a["pos_counts"]
            d1 = torch.zeros_like(self.pos_biases).index_add_(0, pid, -grad)
            d2 = torch.zeros_like(self.pos_biases).index_add_(0, pid, -hess)
            d1 = d1 - self.pos_biases * self.bias_reg * cnt
            d2 = d2 - self.bias_reg * cnt
            self.pos_biases = self.pos_biases + \
                self.bias_lr * d1 / (torch.abs(d2) + 0.001)
        return grad, hess


class RankXENDCG(_Ranking):
    """The listwise cross-entropy surrogate of NDCG (reference: RankXENDCG,
    rank_objective.hpp:378): a softmax over each query's scores against a
    target from the labels perturbed by exponential(1) draws (gamma(1)),
    new draws every call. The draws come from a ``torch.Generator`` on the
    scores' device, seeded from ``objective_seed`` and the call count;
    ``draws`` (``[Q, M]``) passes them in instead (the tests feed the JAX
    package's, whose threefry stream torch cannot reproduce)."""

    name = "rank_xendcg"
    is_ranking = True
    row_elementwise = False
    is_stochastic = True
    is_constant_hessian = False
    renew_leaves = False

    def __init__(self, config):
        super().__init__(config)
        self.seed = int(config.get("objective_seed", 5) or 5)
        self._calls = 0
        self._gen = None

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        phi = (2.0 ** np.asarray(metadata.label, np.float64)) - 1.0
        self._host["row_phi"] = phi.astype(np.float32)
        if self.weight is not None:
            self._host["weight"] = np.asarray(self.weight, np.float32)

    def _draws(self, shape, device) -> torch.Tensor:
        if self._gen is None or self._gen.device != device:
            self._gen = torch.Generator(device=device)
        # within 32 bits: the CPU generator keeps only the low 32 of a seed
        self._gen.manual_seed((self.seed * 1_000_003 + self._calls)
                              & 0xFFFF_FFFF)
        return torch.empty(shape, dtype=torch.float32,
                           device=device).exponential_(generator=self._gen)

    def get_gradients(self, score, label=None, weight=None, draws=None):
        self._check_args(label, weight)
        a = self._arrays(score.device)
        idx, mask = a["query_index"], a["query_mask"]
        s = torch.where(mask, score[idx], -torch.inf)
        phi = torch.where(mask, a["row_phi"][idx], 0.0)
        gam = self._draws(phi.shape, score.device) if draws is None \
            else draws
        self._calls += 1
        rho = phi / torch.clamp(gam, min=_EPS)
        denom = torch.where(mask, rho, 0.0).sum(dim=1, keepdim=True)
        target = rho / torch.clamp(denom, min=_EPS)
        p = torch.where(mask, torch.softmax(s, dim=1), 0.0)
        grad = self._to_rows(a, p - torch.where(mask, target, 0.0))
        hess = torch.clamp(self._to_rows(a, p * (1.0 - p)), min=_EPS)
        return _weighted(grad, hess, a.get("weight"))


# the objectives the port trains, by canonical name (config.py)
OBJECTIVES = {
    "regression": RegressionL2, "regression_l1": RegressionL1,
    "huber": RegressionHuber, "fair": RegressionFair,
    "poisson": RegressionPoisson, "quantile": RegressionQuantile,
    "mape": RegressionMAPE, "gamma": RegressionGamma,
    "tweedie": RegressionTweedie, "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax, "multiclassova": MulticlassOVA,
    "xentropy": CrossEntropy, "xentlambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG, "rank_xendcg": RankXENDCG,
}


def create_objective(name: str, config) -> Objective:
    """The objective of a canonical name (``Config`` resolves aliases)."""
    if name not in OBJECTIVES:
        raise ValueError(f"Unknown objective: {name!r}")
    return OBJECTIVES[name](config)
