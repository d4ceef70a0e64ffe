"""What ``Booster.predict`` gives besides scores, and ``Booster.refit``, in
the port on the CPU, held against the JAX package on the same numpy
inputs: ``pred_leaf``, ``pred_contrib`` (TreeSHAP: the plain version of the
device op for the port's own trees, the host recursion for loaded ones),
``pred_early_stop`` and ``refit``.

Tolerances. On the same trees (the JAX model's trees carried across, or
its model text loaded in both) leaf indices are equal and contributions
agree within ``1e-9`` relative and ``1e-9 * max|leaf value|`` absolute:
both sides add the same float64 terms, in another order. Trees trained by
each package are equal split for split (binary gradients on a 1/64 grid,
the ``dyadic`` fixture; the JAX package's bag draws, ``same_bags``) with
leaf values within f32 rounding, so their contributions agree within
``rtol=1e-5, atol=1e-6`` (``tests/test_interop.py:93-107``). Early-stopped
predictions agree within 1e-5 and refit leaves within 1e-6 relative.

Cases stay small (at most 2,000 rows, 31 leaves, 12 rounds, 150 rows
explained): the JAX package's TreeSHAP is Python recursion.
"""
import logging

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.convert import booster_from_arrays
from lightgbm_tpu_torch.ops.treeshap import (tree_expected_value,
                                             tree_shap_one_row)
from lightgbm_tpu_torch.ops.treeshap_device import (build_shap_paths,
                                                    tree_shap)
from test_torch_constraints import dyadic  # noqa: F401
from test_torch_sampling import jax_uniform
from torch_shap_trees import random_forest, random_rows

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
        "verbosity": -1}
JAX = {"tpu_fused": "off"}
CPU = {"device_type": "cpu"}
N_SHAP = 150


def _rows(n=2000, f=8, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    z = X[:, 0] - 0.4 * X[:, 2] + 0.3 * X[:, 3] - 0.3 * X[:, 6] \
        + 0.3 * rng.randn(n)
    return rng, X, z


def _onehot(n=1500, groups=40, card=8, dense=4, seed=3):
    rng = np.random.RandomState(seed)
    cats = rng.randint(0, card, size=(n, groups))
    X = np.zeros((n, groups * card))
    for g in range(groups):
        X[np.arange(n), g * card + cats[:, g]] = 1.0
    X = np.concatenate([X, rng.randn(n, dense)], axis=1)
    y = (X @ (rng.randn(X.shape[1]) * 0.5) + 0.4 * rng.randn(n) > 0)
    return X, y.astype(np.float64)


def case_data(case):
    """``(X, y, Dataset keywords, parameters, rounds)`` of a case."""
    rng, X, z = _rows()
    y = (z > 0).astype(np.float64)
    kw, p, rounds = {}, dict(BASE), 6
    if case == "binary_nan":
        for j in (1, 4):
            X[rng.rand(len(X)) < 0.1, j] = np.nan
    elif case == "regression":
        y = z
        p["objective"] = "regression"
    elif case == "multiclass":
        y = np.digitize(z, [-0.6, 0.6]).astype(np.float64)
        p.update(objective="multiclass", num_class=3)
        rounds = 4
    elif case == "categorical":
        X[:, 5] = rng.randint(0, 12, len(X))
        X[:, 7] = rng.randint(0, 3, len(X))
        y = ((z + np.isin(X[:, 5], [1, 4, 9])) > 0.5).astype(np.float64)
        kw = {"categorical_feature": [5, 7]}
    elif case == "efb":
        X, y = _onehot()
        p["num_leaves"] = 7
        rounds = 4
    elif case == "linear":
        y = z + np.where(X[:, 5] > 0, 0.75, -0.75)
        X[rng.rand(len(X)) < 0.1, 0] = np.nan
        p.update(objective="regression", linear_tree=True,
                 linear_lambda=0.1)
        kw = {"params": {"linear_tree": True}}
        rounds = 4
    elif case == "rf":
        p.update(boosting="rf", bagging_fraction=0.632, bagging_freq=1,
                 feature_fraction=0.8)
        rounds = 4
    elif case == "dart":
        p.update(boosting="dart", drop_rate=0.5, skip_drop=0.0)
    return X, y, kw, p, rounds


@pytest.fixture
def same_bags(monkeypatch):
    """The port's bags from the JAX package's draws (RF)."""
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    init = gbdt_mod.GBDT.__init__

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        self.sample_strategy.draws = jax_uniform
    monkeypatch.setattr(gbdt_mod.GBDT, "__init__", patched)


def train_both(case):
    X, y, kw, p, rounds = case_data(case)
    bj = lgb.train(dict(p, **JAX), lgb.Dataset(X, label=y, **kw), rounds)
    bt = lgt.train(dict(p, **CPU), lgt.Dataset(X, y, **kw), rounds)
    for a, b in zip(bj._gbdt.models, bt._gbdt.models):
        n = a.num_nodes
        assert b.num_nodes == n
        for name in ("split_feature", "split_bin", "left_child",
                     "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:n],
                                          getattr(a, name)[:n])
    assert len(bj._gbdt.models) == len(bt._gbdt.models)
    return bj, bt, X


def assert_same_contrib(ours, theirs, leaf_values):
    """The same trees: within 1e-9 relative and 1e-9 * max|leaf value|."""
    assert ours.dtype == np.float64 and ours.shape == theirs.shape
    scale = max(float(np.max(np.abs(v))) for v in leaf_values)
    np.testing.assert_allclose(ours, theirs, rtol=1e-9, atol=1e-9 * scale)


def raw_by_leaves(models, leaves, k):
    """Each class's sum of the constant leaf values the rows land in."""
    out = np.zeros((leaves.shape[0], k))
    for i, m in enumerate(models):
        out[:, i % k] += np.asarray(m.leaf_value, np.float64)[leaves[:, i]]
    return out


@pytest.mark.parametrize("case", ["binary_nan", "regression", "multiclass",
                                  "categorical", "efb", "linear", "rf",
                                  "dart"])
def test_leaf_and_contrib_of_trained_trees_match_jax(case, dyadic,
                                                     same_bags):
    """Trees trained by each package: leaf indices equal, contributions
    within 1e-5; they sum to the raw score, except for linear trees (their
    constant leaf values) and a random forest (the sum over its
    iterations, undivided, as in the reference)."""
    bj, bt, X = train_both(case)
    Xs = X[:N_SHAP]
    lt = bt.predict(Xs, pred_leaf=True)
    assert lt.dtype == np.int32 and lt.shape == (N_SHAP, bt.num_trees())
    np.testing.assert_array_equal(lt, bj.predict(Xs, pred_leaf=True))
    _kernels.reset_counts()
    ct = bt.predict(Xs, pred_contrib=True)
    assert _kernels.PLAIN_CALLS["treeshap"] == 1
    cj = bj.predict(Xs, pred_contrib=True)
    assert ct.shape == cj.shape and ct.dtype == np.float64
    np.testing.assert_allclose(ct, cj, rtol=1e-5, atol=1e-6)
    g = bt._gbdt
    k = g.num_class
    sums = ct.reshape(N_SHAP, k, -1).sum(-1)
    raw = bt.predict(Xs, raw_score=True).reshape(N_SHAP, k)
    if case == "efb":
        assert g._efb is not None
    if case == "linear":
        assert any(m.is_linear for m in g.models)
        np.testing.assert_allclose(sums, raw_by_leaves(g.models, lt, k),
                                   rtol=1e-6, atol=1e-6)
        assert np.abs(sums - raw).max() > 1e-3
    elif case == "rf":
        np.testing.assert_allclose(sums / g.current_iteration(), raw,
                                   rtol=1e-5, atol=1e-5)
    else:
        assert np.all(np.abs(sums - raw) <= 1e-5 * (1 + np.abs(raw)))


def _carry(bj):
    """The JAX booster's trees and mappers as a port Booster."""
    fields = ("split_feature", "split_bin", "default_left", "left_child",
              "right_child", "leaf_value", "leaf_depth", "split_gain",
              "leaf_weight", "leaf_count", "internal_value",
              "internal_weight", "internal_count", "cat_bitset")
    trees = [dict({k: np.asarray(getattr(t, k)) for k in fields},
                  num_leaves=t.num_leaves, num_nodes=t.num_nodes,
                  shrinkage=t.shrinkage) for t in bj._gbdt.models]
    ms = bj._gbdt.train_set.mappers
    return booster_from_arrays(
        trees, [m.bin_upper_bounds for m in ms], [m.nan_bin for m in ms],
        [m.missing_type for m in ms], [m.num_bins for m in ms],
        params=dict(bj.params, **CPU),
        value_ranges=[(m.min_value, m.max_value) for m in ms],
        bin_to_cats=[m.bin_to_cat if m.is_categorical else None
                     for m in ms])


@pytest.mark.parametrize("case", ["binary_nan", "multiclass", "categorical",
                                  "efb"])
def test_contrib_of_the_same_trees_matches_jax(case, dyadic):
    """The JAX model's own trees, carried across (bin-space routing, per
    original feature under EFB) and as model text loaded in both packages
    (raw-value routing on the host): leaves equal, contributions within
    1e-9."""
    X, y, kw, p, rounds = case_data(case)
    bj = lgb.train(dict(p, **JAX), lgb.Dataset(X, label=y, **kw), rounds)
    Xs = X[:N_SHAP]
    lv = [m.leaf_value for m in bj._gbdt.models]
    carried = _carry(bj)
    np.testing.assert_array_equal(carried.predict(Xs, pred_leaf=True),
                                  bj.predict(Xs, pred_leaf=True))
    cj = bj.predict(Xs, pred_contrib=True)
    assert_same_contrib(carried.predict(Xs, pred_contrib=True), cj, lv)
    text = bj.model_to_string()
    lj = lgb.Booster(model_str=text)
    lt = lgt.Booster(model_str=text)
    np.testing.assert_array_equal(lt.predict(Xs, pred_leaf=True),
                                  lj.predict(Xs, pred_leaf=True))
    assert_same_contrib(lt.predict(Xs, pred_contrib=True),
                        lj.predict(Xs, pred_contrib=True), lv)


@pytest.mark.parametrize("start,num", [(0, 2), (2, 3), (4, None), (1, -1),
                                       (5, None)])
def test_windows_and_one_row_match_jax(start, num, dyadic):
    """``start_iteration``/``num_iteration`` windows of leaves and
    contributions, on the trained booster and its loaded text, and one 1-D
    row."""
    X, y, kw, p, _ = case_data("binary_nan")
    bj = lgb.train(dict(p, **JAX), lgb.Dataset(X, label=y), 6)
    bt = lgt.train(dict(p, **CPU), lgt.Dataset(X, y), 6)
    Xs = X[:60]
    win = dict(start_iteration=start, num_iteration=num)
    leaves = bt.predict(Xs, pred_leaf=True, **win)
    np.testing.assert_array_equal(leaves,
                                  bj.predict(Xs, pred_leaf=True, **win))
    np.testing.assert_allclose(bt.predict(Xs, pred_contrib=True, **win),
                               bj.predict(Xs, pred_contrib=True, **win),
                               rtol=1e-5, atol=1e-6)
    text = bt.model_to_string()
    loaded = lgt.Booster(model_str=text)
    np.testing.assert_array_equal(loaded.predict(Xs, pred_leaf=True, **win),
                                  leaves)
    assert_same_contrib(
        loaded.predict(Xs, pred_contrib=True, **win),
        lgb.Booster(model_str=text).predict(Xs, pred_contrib=True, **win),
        [m.leaf_value for m in bt._gbdt.models])
    one = bt.predict(X[7], pred_contrib=True, **win)
    assert one.shape == (1, X.shape[1] + 1)
    np.testing.assert_allclose(one, bj.predict(X[7], pred_contrib=True,
                                               **win), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(bt.predict(X[7], pred_leaf=True, **win),
                                  bj.predict(X[7], pred_leaf=True, **win))


def test_continued_booster_matches_jax(dyadic):
    """A booster continued from a loaded model: leaves are the base's, then
    its own; contributions add over both (the base routed on raw values),
    in the global window."""
    X, y, kw, p, _ = case_data("binary_nan")
    base = lgb.train(dict(p, **JAX), lgb.Dataset(X, label=y), 3)
    text = base.model_to_string()
    bj = lgb.train(dict(p, **JAX), lgb.Dataset(X, label=y), 3,
                   init_model=lgb.Booster(model_str=text))
    bt = lgt.train(dict(p, **CPU), lgt.Dataset(X, y), 3,
                   init_model=lgt.Booster(model_str=text))
    assert bt.num_trees() == 6
    Xs = X[:100]
    for win in ({}, {"start_iteration": 2, "num_iteration": 2},
                {"start_iteration": 4}, {"num_iteration": 2}):
        np.testing.assert_array_equal(bt.predict(Xs, pred_leaf=True, **win),
                                      bj.predict(Xs, pred_leaf=True, **win))
        np.testing.assert_allclose(
            bt.predict(Xs, pred_contrib=True, **win),
            bj.predict(Xs, pred_contrib=True, **win), rtol=1e-5, atol=1e-6)
    phi = bt.predict(Xs, pred_contrib=True)
    np.testing.assert_allclose(phi.sum(1), bt.predict(Xs, raw_score=True),
                               atol=1e-5)


def _recursion(models, binned, nan_bin, is_cat, k):
    """The reference's recursion (``ops/treeshap.py`` ``tree_shap_one_row``)
    on bin-space trees, row by row."""
    n, f = binned.shape
    out = np.zeros((n, k, f + 1))
    for ti, m in enumerate(models):
        ev = tree_expected_value(m.left_child, m.right_child, m.leaf_value,
                                 m.internal_count, m.leaf_count, m.num_nodes)
        for r in range(n):
            row = binned[r]

            def go_left(nd):
                fe, b = int(m.split_feature[nd]), int(row[m.split_feature[nd]])
                if is_cat[fe]:
                    w = m.cat_bitset[nd]
                    return b // 32 < len(w) and bool(
                        (int(w[b // 32]) >> (b % 32)) & 1)
                return b <= int(m.split_bin[nd]) or (
                    bool(m.default_left[nd]) and b == nan_bin[fe])
            tree_shap_one_row(go_left, m.split_feature, m.left_child,
                              m.right_child, m.leaf_value, m.internal_count,
                              m.leaf_count, m.num_nodes, out[r, ti % k], 64,
                              ev)
    return out


@pytest.mark.parametrize("cat,k", [((), 1), ((), 2), ((1, 3), 1)])
def test_plain_op_equals_the_recursion_on_random_trees(cat, k):
    """The plain op against the reference's recursion on random trees whose
    paths repeat features (three features on a 39-step path), with a
    constant tree, NaN bins and two-word bitsets: within 1e-12 of the
    output's scale; and they sum to the raw score."""
    nb = 40 if cat else 16
    models = random_forest(5, 5, nb, cat=cat, words=2 if cat else 1)
    is_cat = np.isin(np.arange(5), cat)
    nan_bin = np.full(5, nb - 1)
    X = random_rows(6, 80, 5, nb)
    paths = build_shap_paths(models, nan_bin, is_cat, "cpu")
    assert int(paths.path_len.max()) == 39 and int(paths.ulen.max()) <= 5
    ours = tree_shap(torch.from_numpy(X), paths, k).numpy()
    ref = _recursion(models, X, nan_bin, is_cat, k)
    np.testing.assert_allclose(ours, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    from lightgbm_tpu_torch.ops.predict import predict_leaf_batched
    from lightgbm_tpu_torch.boosting.gbdt import stack_trees
    leaves = predict_leaf_batched(
        torch.from_numpy(X), stack_trees(models, "cpu", is_cat),
        torch.from_numpy(nan_bin), 40).T.numpy()
    np.testing.assert_allclose(ours.sum(-1),
                               raw_by_leaves(models, leaves, k), atol=1e-12)


@pytest.mark.parametrize("case,freq", [("binary_nan", 2), ("binary_nan", 4),
                                       ("multiclass", 1), ("multiclass", 3),
                                       ("rf", 2), ("dart", 5)])
def test_pred_early_stop_matches_jax(case, freq, dyadic, same_bags):
    """Early-stopped predictions (keyword arguments and parameters) within
    1e-5 of the reference's, with rows stopped, where ``freq`` divides the
    iterations and where it does not; a margin of 1e9 stops nothing."""
    bj, bt, X = train_both(case)
    Xs = X[:500]
    stop = dict(pred_early_stop=True, pred_early_stop_margin=0.5,
                pred_early_stop_freq=freq)
    ours = bt.predict(Xs, **stop)
    np.testing.assert_allclose(ours, bj.predict(Xs, **stop), atol=1e-5)
    assert np.abs(ours - bt.predict(Xs)).max() > 1e-4
    np.testing.assert_allclose(bt.predict(Xs, raw_score=True, **stop),
                               bj.predict(Xs, raw_score=True, **stop),
                               atol=1e-5)
    plain = bt.predict(Xs)
    np.testing.assert_array_equal(
        bt.predict(Xs, **dict(stop, pred_early_stop_margin=1e9)), plain)
    # from the parameters, set by reset_parameter
    bt.reset_parameter(stop)
    np.testing.assert_array_equal(bt.predict(Xs), ours)
    np.testing.assert_array_equal(bt.predict(Xs, pred_early_stop=False),
                                  plain)


def test_pred_early_stop_leaves_regression_and_loaded_models(caplog):
    """Regression is never early stopped (the reference's predictor stops
    classification only); a loaded model warns and ignores it, as the
    reference's host path does."""
    X, y, kw, p, rounds = case_data("regression")
    bt = lgt.train(dict(p, **CPU), lgt.Dataset(X, y), 3)
    stop = dict(pred_early_stop=True, pred_early_stop_margin=0.01,
                pred_early_stop_freq=1)
    np.testing.assert_array_equal(bt.predict(X, **stop), bt.predict(X))
    Xb, yb, _, pb, _ = case_data("binary_nan")
    bb = lgt.train(dict(pb, **CPU), lgt.Dataset(Xb, yb), 4)
    loaded = lgt.Booster(params={"verbosity": 0},
                         model_str=bb.model_to_string())
    with caplog.at_level(logging.WARNING):
        out = loaded.predict(Xb, **stop)
    assert any("pred_early_stop is ignored" in r.getMessage()
               for r in caplog.records)
    np.testing.assert_array_equal(out, loaded.predict(Xb))
    with pytest.raises(NotImplementedError, match="A16"):
        bt.predict(X, validate_features=True)


@pytest.mark.parametrize("case", [
    "binary", "regression", "multiclass", "weights", "l1_l2", "decay_0",
    "decay_default", "decay_param", "decay_1"])
def test_refit_matches_jax(case, dyadic):
    """``refit`` of the same model text in both packages: leaf values within
    1e-6 relative, predictions within 1e-5; the decay from the argument, or
    from ``refit_decay_rate`` (its default 0.9, or set)."""
    kind = {"regression": "regression",
            "multiclass": "multiclass"}.get(case, "binary_nan")
    X, y, kw, p, _ = case_data(kind)
    params, args = {}, {}
    if case == "l1_l2":
        params = {"lambda_l1": 0.5, "lambda_l2": 2.0}
    if case == "weights":
        args["weight"] = np.random.RandomState(2).uniform(0.5, 2.0, 1000)
    args["decay_rate"] = {"decay_0": 0.0, "decay_1": 1.0,
                          "decay_default": None,
                          "decay_param": None}.get(case, 0.5)
    if case == "decay_param":
        params["refit_decay_rate"] = 0.75
    bt = lgt.train(dict(p, **CPU, **params), lgt.Dataset(X[1000:], y[1000:]),
                   4)
    text = bt.model_to_string()
    Xn, yn = X[:1000], y[:1000]
    # the reference's loaded Booster keeps no config, so there the
    # parameter's decay is passed as the argument it stands for
    jargs = dict(args, decay_rate=params.get("refit_decay_rate",
                                             args["decay_rate"]))
    rj = lgb.Booster(params=params, model_str=text).refit(Xn, yn, **jargs)
    rt = lgt.Booster(params=dict(params, **CPU),
                     model_str=text).refit(Xn, yn, **args)
    for a, b in zip(rj._gbdt.models, rt._gbdt.models):
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-6,
                                   atol=1e-9)
    np.testing.assert_allclose(rt.predict(Xn), rj.predict(Xn), atol=1e-5)
    old = lgt.Booster(model_str=text)._gbdt.models
    moved = any(np.abs(a.leaf_value - b.leaf_value).max() > 1e-6
                for a, b in zip(old, rt._gbdt.models))
    assert moved == (case != "decay_1")
    if case in ("binary", "decay_param"):
        # the trained booster refits as its own text does
        direct = bt.refit(Xn, yn, **args)
        assert direct.model_to_string() == rt.model_to_string()
    if case == "binary":
        with pytest.raises(TypeError, match="unsupported"):
            bt.refit(Xn, yn, nonsense=1)
