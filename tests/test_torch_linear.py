"""Linear leaves (``linear_tree``) in the port on the CPU, held against the
JAX package on the same numpy inputs.

* ``fit_linear_leaves`` and ``linear_leaf_outputs`` against the JAX
  package's on the same tree and rows (with NaNs, a categorical feature on
  a path, leaves too small to fit, several ``linear_lambda``): constants
  and coefficients within 1e-9 relative, outputs within 1e-9;
* training on the masked grower: trees equal split for split, the leaves'
  constants, features and coefficients within 1e-5, predictions within
  1e-5, rows with a NaN falling back to the constant leaf value; binary
  (the init score folded into the first tree's constants), validation with
  early stopping, and a run that stops with no split;
* model text: saved and reloaded within 1e-6 in both packages;
* the raw-data rules: a Dataset built without raw rows, and a validation
  set without them, raise the reference's errors; ``linear_tree`` with
  DART warns and trains constant leaves.

The data: 3,000 rows of 6 features, a tenth of one feature's values NaN.
"""
import logging

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.boosting import linear as jlinear
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.boosting import linear as tlinear
from test_torch_constraints import ORACLES, dyadic  # noqa: F401
from test_torch_sampling import assert_same_trees

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

BASE = {"objective": "regression", "num_leaves": 15, "min_data_in_leaf": 20,
        "verbosity": -1, "linear_tree": True}
CPU = {"device_type": "cpu"}


def _data(n=3000, seed=5, nan=True):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    y = 2 * X[:, 0] - X[:, 1] + 0.5 * X[:, 2] * (X[:, 3] > 0) \
        + 0.1 * rng.randn(n)
    if nan:
        X[rng.rand(n) < 0.1, 1] = np.nan
    return X, y


def train_both(params, rounds, X, y, valid=None, **kw):
    out = []
    for mod, extra in ((lgb, ORACLES["xla"]), (lgt, CPU)):
        # the reference keeps raw rows where the Dataset's own parameters
        # say linear_tree (its validation sets inherit them)
        dp = {"linear_tree": params.get("linear_tree", False)}
        ds = (mod.Dataset(X, y, params=dp) if mod is lgt
              else mod.Dataset(X, label=y, params=dp))
        vs = {}
        if valid is not None:
            Xv, yv = valid
            vs["valid_sets"] = [ds.create_valid(Xv, yv) if mod is lgt
                                else ds.create_valid(Xv, label=yv)]
        _kernels.reset_counts()
        out.append(mod.train(dict(params, **extra), ds, rounds, **vs, **kw))
    return out


def assert_same_linear(tj, tt, rtol=1e-5):
    assert_same_trees(tj, tt)
    for a, b in zip(tj, tt):
        nl = a.num_leaves
        assert b.is_linear and a.is_linear
        np.testing.assert_allclose(b.leaf_const[:nl], a.leaf_const[:nl],
                                   rtol=rtol, atol=1e-7)
        assert b.leaf_features[:nl] == a.leaf_features[:nl]
        for cb, ca in zip(b.leaf_coeff[:nl], a.leaf_coeff[:nl]):
            np.testing.assert_allclose(cb, ca, rtol=rtol, atol=1e-7)


# ---- the fit ------------------------------------------------------------

def _grown_tree(X, y, cat=False):
    """A port tree grown on ``X`` with its row leaves and gradients (the
    regression objective's, after one boost-from-average)."""
    p = dict(BASE, linear_tree=False, **CPU)
    ds = lgt.Dataset(X, y, categorical_feature=[4] if cat else "auto")
    bst = lgt.train(p, ds, 1)
    gb = bst._gbdt
    host = gb.models[0]
    binned = torch.from_numpy(ds._inner.binned)
    leaf = gb._routed_leaves(gb.host_tree_arrays(host), binned,
                             host.max_depth).numpy()
    grad = (np.mean(y) - y).astype(np.float32)
    return host, leaf, grad, np.ones_like(grad), \
        ds._inner.feature_is_categorical()


def _copy(host):
    import copy
    return copy.deepcopy(host)


@pytest.mark.parametrize("lam", [0.0, 0.1, 10.0])
@pytest.mark.parametrize("cat", [False, True])
def test_fit_matches_reference(lam, cat):
    X, y = _data()
    if cat:
        X[:, 4] = np.random.RandomState(3).randint(0, 6, len(X))
    host, leaf, grad, hess, is_cat = _grown_tree(X, y, cat)
    # a leaf too small to fit: its rows move to leaf 0's id but one
    small = np.flatnonzero(leaf == 1)[5:]
    leaf = leaf.copy()
    leaf[small] = 0
    hj, ht = _copy(host), _copy(host)
    jlinear.fit_linear_leaves(hj, X, leaf, grad, hess, is_cat, lam,
                              shrinkage=0.1)
    tlinear.fit_linear_leaves(ht, X, leaf, grad, hess, is_cat, lam,
                              shrinkage=0.1)
    nl = host.num_leaves
    np.testing.assert_allclose(ht.leaf_const, hj.leaf_const, rtol=1e-9,
                               atol=0)
    assert ht.leaf_features == hj.leaf_features
    for a, b in zip(ht.leaf_coeff, hj.leaf_coeff):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=0)
    assert sum(len(f) for f in ht.leaf_features) > 0
    # the small leaf keeps its constant value
    assert ht.leaf_features[1] == [] and \
        ht.leaf_const[1] == np.float64(host.leaf_value[1])
    if cat:
        assert all(4 not in f for f in ht.leaf_features[:nl])
    for j in range(nl):
        assert tlinear.path_features(ht, j, is_cat) \
            == jlinear.path_features(hj, j, is_cat)
    out_t = tlinear.linear_leaf_outputs(ht, X, leaf)
    out_j = jlinear.linear_leaf_outputs(hj, X, leaf)
    np.testing.assert_allclose(out_t, out_j, rtol=1e-9, atol=1e-12)
    # a NaN in a leaf's feature falls back to its constant value
    nan_rows = np.flatnonzero(np.isnan(X[:, 1]))
    with_f1 = [j for j in range(nl) if 1 in ht.leaf_features[j]]
    hit = nan_rows[np.isin(leaf[nan_rows], with_f1)]
    assert len(hit) > 0
    np.testing.assert_array_equal(out_t[hit],
                                  host.leaf_value[leaf[hit]].astype(
                                      np.float64))


# ---- training -----------------------------------------------------------

@pytest.mark.parametrize("lam", [0.0, 0.1])
def test_linear_trees_match_reference(lam):
    X, y = _data()
    p = dict(BASE, linear_lambda=lam)
    bj, bt = train_both(p, 4, X, y)
    assert not bt._gbdt.use_compact and bt._gbdt._linear
    assert sum(_kernels.LAUNCHES.values()) == 0
    assert_same_linear(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)
    # the train score holds the linear outputs
    np.testing.assert_allclose(bt._gbdt.train_score[0].numpy(),
                               bt.predict(X), atol=1e-5)
    assert bt._gbdt.linear_fit_s > 0


def test_binary_linear_folds_the_init_score(dyadic):
    X, y = _data(nan=False)
    yb = (y > 0.3).astype(float)
    bj, bt = train_both(dict(BASE, objective="binary"), 3, X, yb)
    init = bt._gbdt._init_scores[0]
    assert abs(init) > 1e-3
    assert_same_linear(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)


def test_linear_validation_with_early_stopping():
    X, y = _data()
    Xv, yv = _data(800, seed=8)
    p = dict(BASE, metric="l2", learning_rate=0.5, early_stopping_round=2)
    bj, bt = train_both(p, 30, X, y, valid=(Xv, yv))
    assert 0 < bt.best_iteration < 30
    assert bt.best_iteration == bj.best_iteration
    for metric, value in bj.best_score["valid_0"].items():
        assert bt.best_score["valid_0"][metric] == pytest.approx(value,
                                                                 abs=1e-6)
    assert_same_linear(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), atol=1e-5)
    np.testing.assert_allclose(bt._gbdt.valid_sets[0].score[0].numpy(),
                               bt.predict(Xv, num_iteration=len(
                                   bt._gbdt.models)), atol=1e-5)


def test_linear_run_with_no_split_stops():
    X, y = _data()
    p = dict(BASE, min_data_in_leaf=2000)
    bj, bt = train_both(p, 5, X, y)
    assert bt.num_trees() == bj.num_trees() == 1
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)


def test_linear_model_text_round_trip(tmp_path):
    X, y = _data()
    bj, bt = train_both(BASE, 4, X, y)
    pt, pj = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    bt.save_model(pt)
    bj.save_model(pj)
    text = open(pt).read()
    assert "is_linear=1" in text and "leaf_coeff=" in text
    want = bt.predict(X)
    for path in (pt, pj):
        np.testing.assert_allclose(lgt.Booster(model_file=path).predict(X),
                                   want, atol=1e-6)
    np.testing.assert_allclose(lgb.Booster(model_file=pt).predict(X), want,
                               atol=1e-6)
    # continued from the linear model: the loaded trees predict raw values
    ds = lgt.Dataset(X, y, free_raw_data=False)
    cont = lgt.train(dict(BASE, **CPU), ds, 2, init_model=pt)
    assert cont.num_trees() == 6
    np.testing.assert_allclose(
        cont.predict(X, num_iteration=4), want, atol=1e-5)


def test_linear_needs_raw_rows():
    X, y = _data()
    ds = lgt.Dataset(X, y, params=dict(CPU))
    ds.construct()
    with pytest.raises(ValueError, match="needs raw feature values"):
        lgt.train(dict(BASE, **CPU), ds, 1)
    ds = lgt.Dataset(X, y, params=dict(CPU, linear_tree=True))
    dv = lgt.Dataset(X[:100], y[:100], reference=ds, params=dict(CPU))
    dv.construct()
    with pytest.raises(ValueError, match="validation sets need raw data"):
        lgt.train(dict(BASE, **CPU), ds, 1, valid_sets=[dv])


def test_linear_with_dart_trains_constant_leaves(caplog):
    X, y = _data()
    p = dict(BASE, boosting="dart", skip_drop=0.0, verbosity=1)
    with caplog.at_level(logging.WARNING):
        bj, bt = train_both(p, 3, X, y)
    assert any(r.name == "lightgbm_tpu_torch" and "constant leaves"
               in r.getMessage() for r in caplog.records)
    assert not any(m.is_linear for m in bt._gbdt.models)
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
