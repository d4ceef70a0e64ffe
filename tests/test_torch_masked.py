"""The port's masked grower (``lightgbm_tpu_torch.ops.grower.grow_tree``)
and the small-data training path on the CPU (``device_type="cpu"``, the
plain versions of the kernels) against the JAX package.

* ``grow_tree`` against the JAX ``grow_tree`` (``hist_impl="xla"``, no
  step buckets) on the same bins, gradients and hessians, with NaN bins:
  the trees are equal split for split (feature, bin, default_left, children),
  ``row_leaf`` is equal, and leaf values agree within 1e-5. The gradients
  lie on a 1/64 grid, so both packages' histograms are exact and a tie
  between candidate splits breaks alike (with arbitrary floats the two f32
  sum orders leave different residues in bins a leaf does not use, which can
  move a threshold across such a bin);
* ``lightgbm_tpu_torch.train`` at 5,000 x 8 rows, where ``tpu_grower=auto``
  takes the masked grower, with ``max_bin=63`` and the sublane layout,
  against ``lightgbm_tpu.train`` with the same parameters (auto -> masked,
  the XLA histogram on the CPU): the trees are equal split for split and
  predictions agree within 1e-5. The data has NaNs in one feature only, where
  no leaf is left with a single non-NaN bin, so the mirrored-NaN tie of
  ROADMAP.md section C cannot arise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.ops.grower import GrowerParams as JaxGrowerParams
from lightgbm_tpu.ops.grower import grow_tree as jax_grow_tree
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.ops.grower import GrowerParams, grow_tree

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

BASE = {"objective": "binary", "learning_rate": 0.1, "min_data_in_leaf": 20,
        "verbosity": -1}


def _binned_data(n, f, max_bin, seed):
    """A port-binned matrix with NaN bins in two features, and its
    mappers' arrays."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n) < 0.1, 1] = np.nan
    X[rng.rand(n) < 0.05, 3] = np.nan
    ds = lgt.Dataset(X, (X[:, 0] > 0).astype(float),
                     params={"max_bin": max_bin,
                             "device_type": "cpu"}).construct()._inner
    return (ds.binned, ds.feature_num_bins(), ds.feature_nan_bins(),
            ds.feature_has_nan(), ds.max_num_bins)


def _dyadic_grad_hess(n, seed):
    """Gradients and hessians on a 1/64 grid: every histogram sum, and every
    parent-minus-smaller difference, is exact in f32 whatever the order, so
    the two packages see equal histograms and break ties between candidate
    splits (a threshold next to a bin that is empty in the leaf) alike."""
    rng = np.random.RandomState(seed)
    grad = (rng.randint(-64, 65, n) / 64.0).astype(np.float32)
    hess = (rng.randint(1, 17, n) / 64.0).astype(np.float32)
    return grad, hess


def _assert_same_tree(tj, tt, n_nodes=None):
    n = int(tj.num_nodes)
    assert int(tt.num_nodes) == n
    if n_nodes is not None:
        assert n == n_nodes
    for name in ("split_feature", "split_bin", "default_left", "left_child",
                 "right_child"):
        np.testing.assert_array_equal(np.asarray(getattr(tt, name))[:n],
                                      np.asarray(getattr(tj, name))[:n],
                                      err_msg=name)


@pytest.mark.parametrize("max_bin,leaves", [(63, 15), (63, 31), (255, 15),
                                            (255, 31)])
def test_grow_tree_matches_jax(max_bin, leaves):
    binned, nb, nanb, has_nan, B = _binned_data(3001, 6, max_bin,
                                                seed=leaves + max_bin)
    n = binned.shape[0]
    grad, hess = _dyadic_grad_hess(n, seed=leaves)
    cnt = np.ones(n, np.float32)
    fmask = np.ones(binned.shape[1], bool)
    kw = dict(num_leaves=leaves, num_bins=B, lambda_l2=0.5,
              min_data_in_leaf=20)
    tj, rj = jax_grow_tree(
        jnp.asarray(binned), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(cnt), jnp.asarray(nb), jnp.asarray(nanb),
        jnp.asarray(has_nan), jnp.zeros(len(nb), bool), jnp.asarray(fmask),
        JaxGrowerParams(hist_impl="xla", any_cat=False, **kw))
    _kernels.reset_counts()
    layout = "sublane" if B <= 64 else "lane"
    tt, rt = grow_tree(
        torch.from_numpy(binned), torch.from_numpy(grad),
        torch.from_numpy(hess), torch.from_numpy(cnt),
        torch.from_numpy(nb.astype(np.int64)),
        torch.from_numpy(nanb.astype(np.int64)), torch.from_numpy(has_nan),
        torch.from_numpy(fmask), GrowerParams(hist_layout=layout, **kw))
    _assert_same_tree(tj, tt, leaves - 1)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_allclose(tt.leaf_value.numpy(), np.asarray(tj.leaf_value),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tt.leaf_count.numpy(), np.asarray(tj.leaf_count))
    np.testing.assert_allclose(tt.split_gain.numpy(), np.asarray(tj.split_gain),
                               rtol=1e-4)
    # the root and one smaller-child histogram a split, all plain on the CPU
    kernel = "histogram_sublane" if layout == "sublane" else "histogram"
    assert _kernels.PLAIN_CALLS[kernel] == leaves
    assert sum(_kernels.LAUNCHES.values()) == 0


def test_grow_tree_stops_without_gain():
    """min_data_in_leaf leaves room for a few splits only: the remaining
    iterations are no-ops, and the tree is the JAX package's."""
    binned, nb, nanb, has_nan, B = _binned_data(300, 4, 63, seed=5)
    grad, hess = _dyadic_grad_hess(300, seed=2)
    cnt = np.ones(300, np.float32)
    kw = dict(num_leaves=31, num_bins=B, min_data_in_leaf=60)
    tj, rj = jax_grow_tree(
        jnp.asarray(binned), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(cnt), jnp.asarray(nb), jnp.asarray(nanb),
        jnp.asarray(has_nan), jnp.zeros(4, bool), jnp.ones(4, bool),
        JaxGrowerParams(hist_impl="xla", any_cat=False, **kw))
    tt, rt = grow_tree(
        torch.from_numpy(binned), torch.from_numpy(grad),
        torch.from_numpy(hess), torch.from_numpy(cnt),
        torch.from_numpy(nb.astype(np.int64)),
        torch.from_numpy(nanb.astype(np.int64)), torch.from_numpy(has_nan),
        torch.ones(4, dtype=torch.bool), GrowerParams(hist_layout="sublane",
                                                      **kw))
    assert 0 < int(tt.num_nodes) < 30
    _assert_same_tree(tj, tt)
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_allclose(tt.leaf_value.numpy(), np.asarray(tj.leaf_value),
                               rtol=1e-5, atol=1e-6)


def _small_data(n=5000, f=8, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 3] + 0.4 * X[:, f - 1] * X[:, 1]
         + 0.3 * rng.randn(n) > 0).astype(np.float64)
    X[rng.rand(n) < 0.05, 2] = np.nan
    return X, y


@pytest.mark.parametrize("layout", ["sublane", "lane"])
def test_train_masked_matches_jax(layout):
    X, y = _small_data()
    p = dict(BASE, num_leaves=31, max_bin=63, tpu_hist_layout=layout)
    bj = lgb.train(p, lgb.Dataset(X, label=y), 5)
    _kernels.reset_counts()
    bt = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y), 5)
    assert not bt._gbdt.use_compact
    assert bt._gbdt.grower_params.hist_layout == layout
    kernel = "histogram_sublane" if layout == "sublane" else "histogram"
    assert _kernels.PLAIN_CALLS[kernel] == 5 * 31
    assert sum(_kernels.LAUNCHES.values()) == 0
    assert _kernels.PLAIN_CALLS["fused_split"] == 0
    tj, tt = bj._gbdt.models, bt._gbdt.models
    assert len(tj) == len(tt) == 5
    for a, b in zip(tj, tt):
        _assert_same_tree(a, b, 30)
        # the JAX package pads its leaf arrays to a power-of-two rung. A
        # small leaf's gradient sum is its parent's minus its sibling's,
        # and f32 cancellation there leaves errors of a few 1e-6 absolute
        np.testing.assert_allclose(b.leaf_value, a.leaf_value[:31], rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)


def test_train_masked_with_validation_and_weights():
    """Sample weights, L2, a depth limit and a validation set on the masked
    path: the same predictions and validation metrics as the JAX
    package."""
    X, y = _small_data(3000, 6, seed=8)
    w = np.random.RandomState(1).rand(3000) + 0.5
    Xv, yv = X[2500:], y[2500:]
    X, y, w = X[:2500], y[:2500], w[:2500]
    p = dict(BASE, num_leaves=15, max_bin=63, metric="auc,binary_logloss",
             lambda_l2=1.0, max_depth=4, tpu_hist_layout="sublane")
    jev, tev = {}, {}
    jds = lgb.Dataset(X, label=y, weight=w)
    tds = lgt.Dataset(X, y, weight=w)
    bj = lgb.train(p, jds, 4, valid_sets=[jds.create_valid(Xv, label=yv)],
                   callbacks=[lgb.record_evaluation(jev)])
    bt = lgt.train(dict(p, device_type="cpu"), tds, 4,
                   valid_sets=[tds.create_valid(Xv, yv)],
                   callbacks=[lgt.record_evaluation(tev)])
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), atol=1e-5)
    assert max(t.max_depth for t in bt._gbdt.models) <= 4
    for metric in ("auc", "binary_logloss"):
        np.testing.assert_allclose(tev["valid_0"][metric],
                                   jev["valid_0"][metric], rtol=1e-5)


def test_grower_selection():
    """auto: masked below 65,536 rows; compact when asked for; sublane above
    64 bins warns and runs lane."""
    X, y = _small_data(500, 4)
    p = dict(BASE, num_leaves=7, device_type="cpu")
    b = lgt.train(dict(p, tpu_grower="compact"), lgt.Dataset(X, y), 1)
    assert b._gbdt.use_compact
    b = lgt.train(dict(p, tpu_grower="masked", tpu_hist_layout="sublane",
                       max_bin=255), lgt.Dataset(X, y), 1)
    assert not b._gbdt.use_compact
    assert b._gbdt.grower_params.hist_layout == "lane"
    b = lgt.train(dict(p, tpu_hist_layout="diagonal"), lgt.Dataset(X, y), 1)
    assert b._gbdt.grower_params.hist_layout == "lane"
