"""``cv`` and ``CVBooster`` of the port on the CPU, held against the JAX
package's ``cv`` on the same numpy inputs: stratified binary folds on
both growers, regression, multiclass, lambdarank with whole queries a fold,
``folds`` given as pairs and as an object with ``split``,
``eval_train_metric``, early stopping on the fold means and seeded
bagging in every fold. The same result keys in the same order, means and
standard deviations within 1e-6, the same best iteration, each fold's
trees equal split for split and its predictions within 1e-6.

Two folds of equal size a run (the classes of the stratified cases have
even counts) and 15 leaves in every case: the JAX package compiles its
programs once a shape, and its ``cv`` results are kept for the tests
that reuse them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import objectives as jobj
from lightgbm_tpu_torch import objectives as tobj
from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

BASE = {"objective": "binary", "metric": "auc", "num_leaves": 15,
        "min_data_in_leaf": 10, "verbosity": -1}
JAX = {"tpu_fused": "off"}
CPU = {"device_type": "cpu"}


def data(n=2000, f=8, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    logit = X[:, 0] - 0.4 * X[:, 2] + 0.3 * X[:, 3] + 0.3 * rng.randn(n)
    return X, logit


X, LOGIT = data()
# 1,000 rows of each class; three classes of 666, 666 and 668 rows
Y = (LOGIT > np.median(LOGIT)).astype(np.float64)
Y3 = np.minimum(np.argsort(np.argsort(LOGIT)) // 666, 2).astype(np.float64)
_JAX_RUNS = {}


@pytest.fixture
def dyadic(monkeypatch):
    """Binary gradients and hessians on a 1/64 grid in both packages: leaf
    values are then exact in f32, so near-equal leaves do not swap order
    between the packages and part the AUCs of the first rounds."""
    jg, tg = (jobj.BinaryLogloss.get_gradients,
              tobj.BinaryLogloss.get_gradients)

    def jround(self, score):
        g, h = jg(self, score)
        return jnp.round(g * 64) / 64, jnp.maximum(jnp.round(h * 64), 1) / 64

    def tround(self, score, label, weight=None):
        g, h = tg(self, score, label, weight)
        return (torch.round(g * 64) / 64,
                torch.clamp(torch.round(h * 64), min=1) / 64)
    monkeypatch.setattr(jobj.BinaryLogloss, "get_gradients", jround)
    monkeypatch.setattr(tobj.BinaryLogloss, "get_gradients", tround)


@pytest.fixture
def same_bags(monkeypatch):
    """Every fold's bags from the JAX package's draws (``PRNGKey(seed)``,
    ``tests/test_torch_sampling.py``)."""
    init = gbdt_mod.GBDT.__init__

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        self.sample_strategy.draws = lambda seed, size: torch.from_numpy(
            np.array(jax.random.uniform(jax.random.PRNGKey(seed), (size,))))
    monkeypatch.setattr(gbdt_mod.GBDT, "__init__", patched)


def assert_same_trees(tj, tt):
    assert len(tj) == len(tt)
    for a, b in zip(tj, tt):
        n = a.num_nodes
        assert b.num_nodes == n and b.num_leaves == a.num_leaves
        for name in ("split_feature", "split_bin", "default_left",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:n],
                                          getattr(a, name)[:n], err_msg=name)
        np.testing.assert_allclose(b.leaf_value[:n + 1], a.leaf_value[:n + 1],
                                   rtol=0, atol=1e-5)


def dataset(mod, y, **kw):
    if mod is lgt:
        return lgt.Dataset(X, y, free_raw_data=False, **kw)
    return lgb.Dataset(X, label=y, free_raw_data=False, **kw)


def cv_both(name, params, y, rounds=3, ds_kw=None, port_cv_kw=None,
            **cv_kw):
    """The same ``cv`` call in both packages: ``(jax, port)`` results; the
    JAX package's kept under ``name``."""
    if name not in _JAX_RUNS:
        _JAX_RUNS[name] = lgb.cv(
            dict(params, **JAX), dataset(lgb, y, **(ds_kw or {})), rounds,
            nfold=2, return_cvbooster=True, **cv_kw)
    rt = lgt.cv(dict(params, **CPU), dataset(lgt, y, **(ds_kw or {})),
                rounds, nfold=2, return_cvbooster=True,
                **dict(cv_kw, **(port_cv_kw or {})))
    return _JAX_RUNS[name], rt


def assert_same_cv(rj, rt):
    keys = [k for k in rj if k != "cvbooster"]
    assert [k for k in rt if k != "cvbooster"] == keys
    for key in keys:
        np.testing.assert_allclose(rt[key], rj[key], rtol=0, atol=1e-6,
                                   err_msg=key)
    cj, ct = rj["cvbooster"], rt["cvbooster"]
    assert isinstance(ct, lgt.CVBooster)
    assert ct.best_iteration == cj.best_iteration
    assert len(ct.boosters) == len(cj.boosters)
    for bj, bt in zip(cj.boosters, ct.boosters):
        assert_same_trees(bj._gbdt.models, bt._gbdt.models)
        np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                                   atol=1e-6)
    # a method called on the CVBooster is called on every fold
    np.testing.assert_array_equal(ct.current_iteration(),
                                  [b.current_iteration()
                                   for b in ct.boosters])
    return keys


def test_stratified_binary_masked_with_train_metric(dyadic):
    rj, rt = cv_both("binary_masked", BASE, Y, eval_train_metric=True)
    assert assert_same_cv(rj, rt) == [
        "train auc-mean", "train auc-stdv", "valid auc-mean",
        "valid auc-stdv"]
    assert rt["valid auc-mean"][-1] > 0.9
    # each class split evenly over the folds
    for bst in rt["cvbooster"].boosters:
        assert bst.train_set.get_label().mean() == 0.5


def test_stratified_binary_compact_stops_on_the_means(dyadic):
    p = dict(BASE, tpu_grower="compact", metric=["binary_logloss", "auc"],
             learning_rate=0.9, min_data_in_leaf=2)
    rj, rt = cv_both("binary_compact", p, Y, rounds=4,
                     callbacks=[lgb.early_stopping(1, verbose=False)],
                     port_cv_kw={"callbacks": [lgt.early_stopping(
                         1, verbose=False)]})
    assert assert_same_cv(rj, rt) == [
        "valid binary_logloss-mean", "valid binary_logloss-stdv",
        "valid auc-mean", "valid auc-stdv"]
    best = rt["cvbooster"].best_iteration
    assert 0 < best < 4 and len(rt["valid auc-mean"]) == best
    for bst in rt["cvbooster"].boosters:
        assert bst.best_iteration == best
        assert bst._gbdt.use_compact


def test_regression_is_not_stratified(same_bags):
    """Regression folds are row folds; bagging and feature sampling keep
    their seeded draws in every fold (the bags from the JAX package's
    draws, the feature draws from numpy in both). The default
    ``bagging_seed``: at 5 the first fold's first tree meets two bins of
    one feature whose gains tie within f32 rounding (11.237691 against
    11.237688), and the packages' summation orders pick different ones,
    as ``train`` on the fold's rows alone does."""
    p = dict(BASE, objective="regression", metric=["l2", "l1"],
             bagging_fraction=0.7, bagging_freq=1, feature_fraction=0.8)
    rj, rt = cv_both("regression", p, LOGIT)
    assert assert_same_cv(rj, rt) == [
        "valid l2-mean", "valid l2-stdv", "valid l1-mean", "valid l1-stdv"]


def test_multiclass_matches_jax():
    w = np.random.RandomState(13).uniform(0.5, 1.5, len(Y3))
    p = dict(BASE, objective="multiclass", num_class=3,
             metric="multi_logloss")
    rj, rt = cv_both("multiclass", p, Y3, rounds=2, ds_kw={"weight": w})
    assert_same_cv(rj, rt)
    assert rt["cvbooster"].boosters[0].num_model_per_iteration() == 3


def test_lambdarank_keeps_queries_whole():
    sizes = np.full(100, 20)
    rel = np.clip(np.round(LOGIT + 1.5), 0, 3)
    p = dict(BASE, objective="lambdarank", metric="ndcg", eval_at=[5])
    rj, rt = cv_both("lambdarank", p, rel, ds_kw={"group": sizes})
    assert assert_same_cv(rj, rt) == ["valid ndcg@5-mean",
                                      "valid ndcg@5-stdv"]
    for bst in rt["cvbooster"].boosters:
        assert set(bst.train_set.get_group()) == {20}


class _Splitter:
    """An object with ``split`` (as scikit-learn's KFold has), yielding
    the given pairs."""

    def __init__(self, pairs):
        self.pairs = pairs

    def split(self, X, y=None, groups=None):
        assert len(X) == len(y) == len(self.pairs[0][0]) * 2
        yield from self.pairs


@pytest.mark.parametrize("how", ["pairs", "splitter"])
def test_folds_as_pairs_and_as_a_splitter(how, dyadic):
    """The JAX package's own stratified folds, handed to the port's cv:
    its results equal the JAX run's."""
    rj, _ = cv_both("binary_masked", BASE, Y, eval_train_metric=True)
    rows = np.arange(len(Y))
    pairs = [(np.setdiff1d(rows, te), te) for te in lgb.engine._make_n_folds(
        dataset(lgb, Y), 2, {}, 0, True, True, None)]
    folds = pairs if how == "pairs" else _Splitter(pairs)
    rt = lgt.cv(dict(BASE, **CPU), dataset(lgt, Y), 3, folds=folds,
                eval_train_metric=True, return_cvbooster=True)
    assert_same_cv(rj, rt)


def test_cv_needs_the_raw_data():
    ds = lgt.Dataset(X, Y, params=CPU).construct()
    with pytest.raises(ValueError, match="raw data"):
        lgt.cv(dict(BASE, **CPU), ds, 2)
    # metrics= and num_boost_round in the parameters
    res = lgt.cv(dict(BASE, num_iterations=2, **CPU), dataset(lgt, Y), 5,
                 nfold=2, metrics="binary_logloss")
    assert list(res) == ["valid binary_logloss-mean",
                         "valid binary_logloss-stdv"]
    assert len(res["valid binary_logloss-mean"]) == 2


def test_cv_refuses_init_model_and_init_scores():
    """``init_model`` and a Dataset's init scores raise naming their item:
    the JAX package's cv ignores both, so no reference holds them yet."""
    p = dict(BASE, **CPU)
    base = lgt.train(p, lgt.Dataset(X, Y, params=CPU), 1)
    with pytest.raises(NotImplementedError, match=r"A16 \(cv init\)"):
        lgt.cv(p, dataset(lgt, Y), 2, nfold=2, init_model=base)
    with pytest.raises(NotImplementedError, match=r"A16 \(cv init\)"):
        lgt.cv(p, dataset(lgt, Y, init_score=np.zeros(len(Y))), 2, nfold=2)
