"""Linear leaves (``linear_tree=true``).

Counterpart of ``lightgbm_tpu/boosting/linear.py`` (reference:
src/treelearner/linear_tree_learner.cpp): each leaf of a grown tree gets a
weighted ridge least-squares model ``beta = -(X^T H X + lambda I)^{-1} X^T
g`` over the numerical features on its path, the ridge on the features'
diagonal only (not the intercept). Rows with a NaN in those features are
skipped; a leaf with fewer than ``2 (F + 1)`` rows, no path feature, or a
failed or non-finite solve keeps its constant value; coefficients at or
below 1e-35 are dropped. A row's output is ``leaf_const + x . coeff``, or
the constant leaf value when one of its features is NaN (LightGBM's
tree.h Predict).

The fit runs in float64 numpy on the host, as in the JAX package and in
LightGBM, whose CUDA learner has no linear trees: the tree grows on the
device, then its row leaves and gradients come to the host in one copy.
"""
from __future__ import annotations

from typing import List

import numpy as np

_ZERO = 1e-35


def path_features(host, leaf: int, is_cat: np.ndarray) -> List[int]:
    """The numerical features on the path from the root to ``leaf``,
    sorted (reference: ``path_features``, linear_tree_learner.cpp
    GetLeafMap/InitLinear)."""
    nn = host.num_nodes
    parent = np.full(max(nn, 1), -1, np.int64)
    for side in (host.left_child[:nn], host.right_child[:nn]):
        inner = np.flatnonzero(side >= 0)
        parent[side[inner]] = inner
    feats = set()
    node = int(host.leaf_parent[leaf]) if nn else -1
    while node >= 0:
        f = int(host.split_feature[node])
        if f >= 0 and not bool(is_cat[f]):
            feats.add(f)
        node = int(parent[node])
    return sorted(feats)


def fit_linear_leaves(host, raw: np.ndarray, row_leaf: np.ndarray,
                      grad: np.ndarray, hess: np.ndarray, is_cat: np.ndarray,
                      linear_lambda: float, shrinkage: float = 1.0) -> None:
    """Fit each leaf's linear model into ``host`` (``leaf_const``,
    ``leaf_features``, ``leaf_coeff``, ``is_linear``). ``host.leaf_value``
    already holds the shrunk constant outputs: the fitted coefficients are
    scaled by ``shrinkage`` here, the constant fallbacks kept as they are
    (reference: ``fit_linear_leaves``, ``lightgbm_tpu/boosting/
    linear.py:44-92``)."""
    width = len(host.leaf_value)
    host.leaf_const = np.array(host.leaf_value, np.float64)
    host.leaf_features = [[] for _ in range(width)]
    host.leaf_coeff = [[] for _ in range(width)]
    host.is_linear = True
    # each leaf's rows, in one stable sort
    order = np.argsort(row_leaf, kind="stable")
    bounds = np.searchsorted(row_leaf[order], np.arange(width + 1))
    for leaf in range(host.num_leaves):
        feats = path_features(host, leaf, is_cat)
        rows = order[bounds[leaf]:bounds[leaf + 1]]
        if not feats or rows.size == 0:
            continue
        x = raw[np.ix_(rows, feats)]
        ok = ~np.isnan(x).any(axis=1)
        rows, x = rows[ok], x[ok]
        # too few rows for a stable solve (LightGBM: num < num_feat * 2)
        if rows.size < 2 * (len(feats) + 1):
            continue
        g = grad[rows].astype(np.float64)
        h = hess[rows].astype(np.float64)
        xi = np.column_stack([x, np.ones(len(x))])
        xthx = xi.T @ (xi * h[:, None])
        diag = np.arange(len(feats))
        xthx[diag, diag] += linear_lambda
        try:
            beta = -np.linalg.solve(xthx, xi.T @ g)
        except np.linalg.LinAlgError:
            continue
        if not np.isfinite(beta).all():
            continue
        beta = beta * shrinkage
        keep = np.abs(beta[:-1]) > _ZERO
        host.leaf_features[leaf] = [f for f, k in zip(feats, keep) if k]
        host.leaf_coeff[leaf] = [float(b) for b, k in zip(beta[:-1], keep)
                                 if k]
        host.leaf_const[leaf] = float(beta[-1])


def linear_leaf_outputs(host, raw: np.ndarray, leaf: np.ndarray
                        ) -> np.ndarray:
    """``[N]`` float64 outputs of a linear tree for rows ``raw`` whose
    leaves are ``leaf``: ``leaf_const + x . coeff``, the constant leaf
    value where a needed feature is NaN (reference:
    ``linear_leaf_outputs``, ``lightgbm_tpu/boosting/linear.py:96-112``)."""
    out = np.asarray(host.leaf_value, np.float64)[leaf]
    for lf in range(host.num_leaves):
        rows = np.flatnonzero(leaf == lf)
        if rows.size == 0:
            continue
        feats = host.leaf_features[lf]
        if not feats:
            out[rows] = host.leaf_const[lf]
            continue
        x = raw[np.ix_(rows, feats)]
        ok = ~np.isnan(x).any(axis=1)
        out[rows[ok]] = host.leaf_const[lf] + x[ok] @ np.asarray(
            host.leaf_coeff[lf])
    return out


def add_bias_linear(host, bias: float) -> None:
    """Fold the init score into the constants of a linear tree."""
    host.leaf_const = np.asarray(host.leaf_const) + bias
