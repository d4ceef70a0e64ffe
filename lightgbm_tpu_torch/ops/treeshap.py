"""TreeSHAP on the host, in float64 numpy: the models that route on raw
values.

The port's copy of ``lightgbm_tpu/ops/treeshap.py`` (the exact tree SHAP
path attribution of Lundberg et al., "Consistent Individualized Feature
Attribution for Tree Ensembles"; reference: Tree::TreeSHAP in
src/io/tree.cpp, driven from GBDT::PredictContrib). A model loaded from
text, and the loaded base of a continued booster, hold raw-value thresholds
and no bins, so their contributions route each row on its raw float64
values here, as their predictions do (``model_io.LoadedGBDT``). The
decisions of every node for every row come from ``LoadedTree.go_left`` in
one vectorised pass; the EXTEND/UNWIND recursion is the reference's, row by
row. A trained booster's contributions run on the device
(``ops/treeshap_device.py``).
"""
from __future__ import annotations

import numpy as np


class _Path:
    """Decision-path state for the EXTEND/UNWIND recursion."""

    __slots__ = ("feature", "zero_fraction", "one_fraction", "pweight")

    def __init__(self, depth_cap: int):
        self.feature = np.full(depth_cap, -1, np.int64)
        self.zero_fraction = np.zeros(depth_cap)
        self.one_fraction = np.zeros(depth_cap)
        self.pweight = np.zeros(depth_cap)

    def copy_to(self, other: "_Path", n: int) -> None:
        other.feature[:n] = self.feature[:n]
        other.zero_fraction[:n] = self.zero_fraction[:n]
        other.one_fraction[:n] = self.one_fraction[:n]
        other.pweight[:n] = self.pweight[:n]


def _extend(p: _Path, unique_depth: int, zero_fraction: float,
            one_fraction: float, feature: int) -> None:
    p.feature[unique_depth] = feature
    p.zero_fraction[unique_depth] = zero_fraction
    p.one_fraction[unique_depth] = one_fraction
    p.pweight[unique_depth] = 1.0 if unique_depth == 0 else 0.0
    ud = unique_depth
    for i in range(ud - 1, -1, -1):
        p.pweight[i + 1] += one_fraction * p.pweight[i] * (i + 1) / (ud + 1)
        p.pweight[i] = zero_fraction * p.pweight[i] * (ud - i) / (ud + 1)


def _unwind(p: _Path, unique_depth: int, path_index: int) -> None:
    one = p.one_fraction[path_index]
    zero = p.zero_fraction[path_index]
    ud = unique_depth
    next_one_portion = p.pweight[ud]
    for i in range(ud - 1, -1, -1):
        if one != 0.0:
            tmp = p.pweight[i]
            p.pweight[i] = next_one_portion * (ud + 1) / ((i + 1) * one)
            next_one_portion = tmp - p.pweight[i] * zero * (ud - i) / (ud + 1)
        else:
            p.pweight[i] = p.pweight[i] * (ud + 1) / (zero * (ud - i))
    for i in range(path_index, ud):
        p.feature[i] = p.feature[i + 1]
        p.zero_fraction[i] = p.zero_fraction[i + 1]
        p.one_fraction[i] = p.one_fraction[i + 1]


def _unwound_sum(p: _Path, unique_depth: int, path_index: int) -> float:
    one = p.one_fraction[path_index]
    zero = p.zero_fraction[path_index]
    ud = unique_depth
    total = 0.0
    next_one_portion = p.pweight[ud]
    for i in range(ud - 1, -1, -1):
        if one != 0.0:
            tmp = next_one_portion * (ud + 1) / ((i + 1) * one)
            total += tmp
            next_one_portion = p.pweight[i] - tmp * zero * (ud - i) / (ud + 1)
        else:
            total += p.pweight[i] / (zero * (ud - i) / (ud + 1))
    return total


def tree_expected_value(left_child, right_child, leaf_value, node_count,
                        leaf_count, num_nodes: int) -> float:
    """A tree's cover-weighted mean output (row-independent: it goes to
    the bias column once a row)."""
    if num_nodes == 0:
        return float(leaf_value[0])

    def cover(node: int) -> float:
        if node < 0:
            return max(float(leaf_count[-(node + 1)]), 1e-12)
        return max(float(node_count[node]), 1e-12)

    def value(node: int) -> float:
        if node < 0:
            return float(leaf_value[-(node + 1)])
        lc, rc = int(left_child[node]), int(right_child[node])
        cl, cr = cover(lc), cover(rc)
        return (value(lc) * cl + value(rc) * cr) / (cl + cr)

    return value(0)


def tree_shap_one_row(go_left_fn, split_feature, left_child, right_child,
                      leaf_value, node_count, leaf_count, num_nodes: int,
                      phi: np.ndarray, max_depth: int,
                      expected_value: float) -> None:
    """Add one tree's SHAP values for one row into ``phi [F+1]``;
    ``go_left_fn(node)`` is the row's decision at ``node``."""
    if num_nodes == 0:
        phi[-1] += float(leaf_value[0])
        return
    depth_cap = max_depth + 2

    def cover(node: int) -> float:
        if node < 0:
            return max(float(leaf_count[-(node + 1)]), 1e-12)
        return max(float(node_count[node]), 1e-12)

    def recurse(node: int, path: _Path, unique_depth: int,
                parent_zero: float, parent_one: float,
                parent_feature: int) -> None:
        p = _Path(depth_cap)
        path.copy_to(p, unique_depth)
        _extend(p, unique_depth, parent_zero, parent_one, parent_feature)
        if node < 0:
            leaf = -(node + 1)
            for i in range(1, unique_depth + 1):
                w = _unwound_sum(p, unique_depth, i)
                phi[p.feature[i]] += (
                    w * (p.one_fraction[i] - p.zero_fraction[i])
                    * float(leaf_value[leaf]))
            return
        f = int(split_feature[node])
        left = go_left_fn(node)
        hot = int(left_child[node]) if left else int(right_child[node])
        cold = int(right_child[node]) if left else int(left_child[node])
        node_cover = cover(node)
        hot_zero = cover(hot) / node_cover
        cold_zero = cover(cold) / node_cover
        incoming_zero, incoming_one = 1.0, 1.0
        new_depth = unique_depth + 1
        # a feature already on the path: undo its earlier element first
        prev = -1
        for i in range(1, unique_depth + 1):
            if p.feature[i] == f:
                prev = i
                break
        if prev >= 0:
            incoming_zero = p.zero_fraction[prev]
            incoming_one = p.one_fraction[prev]
            _unwind(p, unique_depth, prev)
            new_depth = unique_depth
        recurse(hot, p, new_depth, hot_zero * incoming_zero,
                incoming_one, f)
        recurse(cold, p, new_depth, cold_zero * incoming_zero, 0.0, f)

    phi[-1] += expected_value
    recurse(0, _Path(depth_cap), 0, 1.0, 1.0, -1)


def loaded_tree_depth(t) -> int:
    """The most internal nodes on a root-to-leaf path of a ``LoadedTree``."""
    if t.num_nodes == 0:
        return 0
    best = 0
    stack = [(0, 1)]
    while stack:
        node, d = stack.pop()
        for child in (int(t.left_child[node]), int(t.right_child[node])):
            if child < 0:
                best = max(best, d)
            else:
                stack.append((child, d + 1))
    return best


def loaded_booster_contrib(models, X: np.ndarray,
                           num_tree_per_iteration: int,
                           num_features: int) -> np.ndarray:
    """SHAP contributions ``[N, K*(F+1)]`` of ``LoadedTree``s on raw rows,
    each class's bias last. Linear trees attribute their constant leaf
    values, as the reference and LightGBM do (TreeSHAP reads
    ``leaf_value_``, never the leaf coefficients)."""
    X = np.ascontiguousarray(np.atleast_2d(X), np.float64)
    n = X.shape[0]
    k = max(num_tree_per_iteration, 1)
    out = np.zeros((n, k, num_features + 1))
    for t_idx, t in enumerate(models):
        cls = t_idx % k
        depth = loaded_tree_depth(t)
        ev = tree_expected_value(t.left_child, t.right_child, t.leaf_value,
                                 t.internal_count, t.leaf_count, t.num_nodes)
        dec = t.go_left(X)                                  # [N, nodes]
        for r in range(n):
            row_dec = dec[r]
            tree_shap_one_row(
                row_dec.__getitem__, t.split_feature, t.left_child,
                t.right_child, t.leaf_value, t.internal_count, t.leaf_count,
                t.num_nodes, out[r, cls], depth, ev)
    return out.reshape(n, k * (num_features + 1))
