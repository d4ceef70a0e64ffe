"""Categorical features in the port (lightgbm_tpu_torch) against the JAX
package, on the CPU (``device_type="cpu"``, the plain versions of the
kernels).

* categorical bin mappers (category tables, bins) and bin matrices are
  equal to the JAX package's, with NaN, negative and rare categories and
  more categories than ``max_bin`` leaves room for;
* ``best_split`` picks the same feature, bitset, direction and threshold,
  and its gain agrees within 1e-5, on random ``[F, B, 4]`` histograms of
  rows whose gradients lie on a 1/64 grid (every sum is exact, so the
  sorted scan's order of categories cannot differ by a rounding), for
  one-hot, sorted and numerical winners and with the ``min_data_per_group``
  gate active; the batched scan equals the single scans;
* the masked grower (``grow_tree``) grows the JAX grower's trees split for
  split (bitsets included) and the same ``row_leaf`` from dyadic gradients;
* ``train`` on the masked and the compact grower, for each objective here:
  the trees equal the JAX package's split for split (against
  ``tpu_fused=off`` on the compact grower; a sorted categorical split may
  be its exactly tied mirror, see ``assert_same_trees``), predictions agree
  within 1e-5, and within 1e-4 of the fused Pallas kernel in interpret
  mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.io import dataset as jds
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.ops.grower import GrowerParams as JaxGrowerParams
from lightgbm_tpu.ops.grower import grow_tree as jax_grow_tree
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.io import dataset as tds
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.grower import GrowerParams, grow_tree

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

BASE = {"num_leaves": 15, "learning_rate": 0.1, "min_data_in_leaf": 20,
        "min_data_per_group": 20, "cat_smooth": 2.0, "verbosity": -1}


def _cat_data(n, seed, nan=True):
    """Two numerical features (one with NaN) and three categorical ones:
    40 categories with a rare tail, negative codes and NaN (sorted scan),
    3 categories (one-hot: 4 bins <= max_cat_to_onehot) and 12 categories.
    The target follows categories that are not contiguous in code order."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, 5))
    X[:, 0] = rng.randn(n)
    X[:, 1] = np.minimum(rng.geometric(0.08, n) - 1, 60)
    X[:, 2] = rng.randint(0, 3, n)
    X[:, 3] = rng.randn(n)
    X[:, 4] = rng.randint(0, 12, n)
    if nan:
        X[rng.rand(n) < 0.05, 1] = np.nan
        X[rng.rand(n) < 0.03, 1] = -1.0
        X[rng.rand(n) < 0.05, 3] = np.nan
    signal = (X[:, 0] + 1.5 * np.isin(X[:, 1], [2, 5, 6, 11, 17])
              - np.where(X[:, 2] == 1, 1.0, 0.0)
              + 0.8 * np.isin(X[:, 4], [1, 4, 9]))
    return X, signal + 0.3 * rng.randn(n)


CAT = [1, 2, 4]


@pytest.mark.parametrize("max_bin,min_data_in_bin", [(255, 3), (15, 3),
                                                     (15, 40)])
def test_categorical_binning_matches_jax(max_bin, min_data_in_bin):
    X, _ = _cat_data(4000, seed=max_bin + min_data_in_bin)
    kw = dict(max_bin=max_bin, min_data_in_bin=min_data_in_bin,
              categorical_feature=CAT)
    a = jds.BinnedDataset.construct(X, enable_bundle=False, **kw)
    b = tds.BinnedDataset.construct(X, **kw)
    assert b.categorical_features == a.categorical_features == CAT
    np.testing.assert_array_equal(b.feature_is_categorical(),
                                  a.feature_is_categorical())
    for ma, mb in zip(a.mappers, b.mappers):
        assert (ma.num_bins, ma.missing_type, ma.nan_bin, ma.default_bin) \
            == (mb.num_bins, mb.missing_type, mb.nan_bin, mb.default_bin)
        assert ma.cat_to_bin == mb.cat_to_bin
        np.testing.assert_array_equal(ma.bin_to_cat, mb.bin_to_cat)
    np.testing.assert_array_equal(a.binned, b.binned)
    # unseen and missing values: NaN, infinities, negatives, an unknown
    # category, a fractional code
    probe = np.array([np.nan, np.inf, -3.0, 1e6, 2.7, 0.0, 5.0])
    for j in CAT:
        np.testing.assert_array_equal(b.mappers[j].value_to_bin(probe),
                                      a.mappers[j].value_to_bin(probe))
    # a validation set binned with the training mappers
    Xv, _ = _cat_data(500, seed=99)
    va = jds.BinnedDataset.construct(Xv, reference=a, enable_bundle=False)
    vb = tds.BinnedDataset.construct(Xv, reference=b)
    np.testing.assert_array_equal(va.binned, vb.binned)


def test_categorical_feature_by_name():
    X, y = _cat_data(600, seed=2)
    names = [f"f{i}" for i in range(5)]
    by_name = lgt.Dataset(X, y, feature_name=names,
                          categorical_feature=["f1", "name:f2", "4"],
                          params={"device_type": "cpu"}).construct()._inner
    by_param = lgt.Dataset(X, y, params={"device_type": "cpu",
                                         "categorical_feature": "1,2,4"}
                           ).construct()._inner
    assert by_name.categorical_features == by_param.categorical_features \
        == CAT
    np.testing.assert_array_equal(by_name.binned, by_param.binned)


def _hist(seed, F=5, B=64):
    """A [F, B, 4] histogram of random rows (gradients on a 1/64 grid):
    categorical features with 2-4 bins (one-hot) or more (sorted), the
    rest numerical."""
    rng = np.random.RandomState(seed)
    nb = rng.randint(3, B + 1, size=F)
    is_cat = rng.rand(F) < 0.6
    onehot = is_cat & (rng.rand(F) < 0.3)
    nb[onehot] = rng.randint(2, 5, size=int(onehot.sum()))
    n = rng.randint(300, 3000)
    bins = (rng.rand(n, F) * nb).astype(int)
    effect = rng.randn(F, B)
    g = np.round((effect[np.arange(F)[None], bins].sum(1)
                  + rng.randn(n)) * 64) / 64
    h = rng.randint(1, 17, n) / 64
    ch = np.stack([g, h, np.ones(n), np.ones(n)], 1).astype(np.float32)
    hist = np.zeros((F, B, 4), np.float32)
    for f in range(F):
        np.add.at(hist[f], bins[:, f], ch)
    return hist, nb.astype(np.int32), is_cat


SPLIT_PARAMS = [
    {},
    {"min_data_per_group": 200.0, "max_cat_threshold": 8},
    {"lambda_l2": 1.0, "cat_smooth": 1.0, "min_data_per_group": 50.0},
    {"cat_l2": 0.0, "max_cat_to_onehot": 8, "min_data_in_leaf": 5.0},
]


@pytest.mark.parametrize("kw", SPLIT_PARAMS)
@pytest.mark.parametrize("seed", range(6))
def test_best_split_categorical_matches_jax(kw, seed):
    hist, nb, is_cat = _hist(seed * 7 + len(kw))
    F = len(nb)
    tot = hist[0].sum(0)
    nan_bin = np.zeros(F, np.int32)
    has_nan = np.zeros(F, bool)
    fmask = np.ones(F, bool)
    j = jsplit.best_split(
        jnp.asarray(hist), jnp.float32(tot[0]), jnp.float32(tot[1]),
        jnp.float32(tot[2]), jnp.asarray(nb), jnp.asarray(nan_bin),
        jnp.asarray(has_nan), jnp.asarray(is_cat), jnp.asarray(fmask),
        jsplit.SplitParams(**kw))
    t = tsplit.best_split(
        torch.from_numpy(hist), torch.tensor(tot[0]), torch.tensor(tot[1]),
        torch.tensor(tot[2]), torch.from_numpy(nb),
        torch.from_numpy(nan_bin), torch.from_numpy(has_nan),
        torch.from_numpy(fmask), tsplit.SplitParams(**kw),
        torch.from_numpy(is_cat))
    for name in ("feature", "bin", "default_left", "is_cat_l2"):
        assert int(getattr(t, name)) == int(getattr(j, name)), name
    np.testing.assert_array_equal(t.cat_bitset.numpy(),
                                  np.asarray(j.cat_bitset).view(np.int32))
    np.testing.assert_allclose(float(t.gain), float(j.gain), rtol=1e-5)
    for name in ("left_grad", "left_hess", "left_count", "left_rows"):
        np.testing.assert_allclose(float(getattr(t, name)),
                                   float(getattr(j, name)), rtol=1e-5,
                                   atol=1e-4)


def test_categorical_scan_batched_equals_single():
    hs = [_hist(s) for s in (3, 4)]
    _, nb, is_cat = hs[0]
    stack = np.stack([h[0] for h in hs])
    tots = stack[:, 0].sum(axis=1)
    F = len(nb)
    args = (torch.from_numpy(nb), torch.zeros(F, dtype=torch.int64),
            torch.zeros(F, dtype=torch.bool), torch.ones(F, dtype=torch.bool),
            tsplit.SplitParams(min_data_per_group=50.0),
            torch.from_numpy(is_cat))
    both = tsplit.best_split(torch.from_numpy(stack),
                             *(torch.from_numpy(tots[:, i]) for i in range(3)),
                             *args)
    for i in range(2):
        one = tsplit.best_split(torch.from_numpy(stack[i]),
                                *(torch.tensor(tots[i, c]) for c in range(3)),
                                *args)
        for a, b in zip(both, one):
            assert torch.equal(a[i], b)


def test_pack_bin_bitset_matches_jax():
    rng = np.random.RandomState(0)
    mask = rng.rand(3, 70) < 0.4
    mask[0, 31] = mask[1, 63] = True
    got = tsplit.pack_bin_bitset(torch.from_numpy(mask))
    for i in range(3):
        ref = np.asarray(jsplit.pack_bin_bitset(jnp.asarray(mask[i])))
        np.testing.assert_array_equal(got[i].numpy(), ref.view(np.int32))


@pytest.mark.parametrize("max_bin,leaves", [(63, 15), (255, 31)])
def test_grow_tree_categorical_matches_jax(max_bin, leaves):
    X, _ = _cat_data(3001, seed=leaves)
    ds = lgt.Dataset(X, np.zeros(len(X)), categorical_feature=CAT,
                     params={"max_bin": max_bin,
                             "device_type": "cpu"}).construct()._inner
    rng = np.random.RandomState(leaves)
    n = len(X)
    # dyadic gradients that follow the categorical signal
    sig = np.isin(X[:, 1], [2, 5, 6, 11]) - 0.5 * (X[:, 2] == 1)
    grad = (np.round((sig + rng.randn(n)) * 16) / 64).astype(np.float32)
    hess = (rng.randint(1, 17, n) / 64.0).astype(np.float32)
    cnt = np.ones(n, np.float32)
    nb, nanb = ds.feature_num_bins(), ds.feature_nan_bins()
    has_nan, is_cat = ds.feature_has_nan(), ds.feature_is_categorical()
    fmask = np.ones(5, bool)
    kw = dict(num_leaves=leaves, num_bins=ds.max_num_bins, lambda_l2=0.5,
              min_data_in_leaf=20, min_data_per_group=30.0, cat_smooth=2.0)
    tj, rj = jax_grow_tree(
        jnp.asarray(ds.binned), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(cnt), jnp.asarray(nb), jnp.asarray(nanb),
        jnp.asarray(has_nan), jnp.asarray(is_cat), jnp.asarray(fmask),
        JaxGrowerParams(hist_impl="xla", **kw))
    layout = "sublane" if ds.max_num_bins <= 64 else "lane"
    tt, rt = grow_tree(
        torch.from_numpy(ds.binned), torch.from_numpy(grad),
        torch.from_numpy(hess), torch.from_numpy(cnt),
        torch.from_numpy(nb.astype(np.int64)),
        torch.from_numpy(nanb.astype(np.int64)), torch.from_numpy(has_nan),
        torch.from_numpy(fmask), GrowerParams(hist_layout=layout, **kw),
        is_cat_arr=torch.from_numpy(is_cat))
    nn = int(tj.num_nodes)
    assert int(tt.num_nodes) == nn == leaves - 1
    for name in ("split_feature", "split_bin", "default_left", "left_child",
                 "right_child"):
        np.testing.assert_array_equal(np.asarray(getattr(tt, name))[:nn],
                                      np.asarray(getattr(tj, name))[:nn],
                                      err_msg=name)
    np.testing.assert_array_equal(
        tt.cat_bitset.numpy()[:nn],
        np.asarray(tj.cat_bitset)[:nn].view(np.int32))
    sf = np.asarray(tt.split_feature)[:nn]
    assert np.isin(sf, [1, 4]).any() and (sf == 2).any()
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_allclose(tt.leaf_value.numpy(),
                               np.asarray(tj.leaf_value), rtol=1e-5,
                               atol=1e-6)


def _labels(objective, signal):
    if objective == "binary":
        return (signal > np.median(signal)).astype(float)
    if objective == "poisson":
        return np.floor(np.exp(0.4 * signal))
    return signal


def _train_both(X, y, params, jax_extra, rounds=3):
    jb = lgb.train(dict(params, **jax_extra),
                   lgb.Dataset(X, label=y, categorical_feature=CAT), rounds)
    tb = lgt.train(dict(params, device_type="cpu"),
                   lgt.Dataset(X, y, categorical_feature=CAT), rounds)
    return jb, tb


def tree_leaves(tree, binned, nan_bins, is_cat):
    """The leaf of each row of a ``[N, F]`` bin matrix in a HostTree (a
    numpy walk with the routing of ``go_left_pred``)."""
    n = len(binned)
    cur = np.full(n, 0 if tree.num_nodes else -1, np.int64)
    rows = np.arange(n)
    for _ in range(tree.num_nodes):
        live = cur >= 0
        if not live.any():
            break
        node = cur[live]
        f = tree.split_feature[node]
        v = binned[rows[live], f].astype(np.int64)
        words = np.asarray(tree.cat_bitset, np.uint32)[node, v // 32]
        left = np.where(is_cat[f], (words >> (v % 32)) & 1 == 1,
                        (v <= tree.split_bin[node])
                        | (tree.default_left[node] & (v == nan_bins[f])))
        cur[live] = np.where(left, tree.left_child[node],
                             tree.right_child[node])
    return -(cur + 1)


def assert_same_trees(tj, tt, ds, leaf_atol=1e-5):
    """The port's trees ``tt`` against the JAX package's ``tj`` on the
    training set ``ds`` (the port's BinnedDataset): split for split,
    bitsets included, leaf values within ``leaf_atol`` (the two packages
    sum f32 histograms in another order). One exact tie is allowed: a
    sorted categorical split and its mirror (the complement of its bins,
    children swapped) have the same gain in exact arithmetic when every bin
    holding rows of the node takes part in the scan, and f32 rounding of
    differently ordered sums picks one. Such a tree must then hold the same
    splits (features and gains) and send every training row to a leaf of
    the same value."""
    assert len(tj) == len(tt)
    is_cat = ds.feature_is_categorical()
    nan_bins = ds.feature_nan_bins()
    for a, b in zip(tj, tt):
        n = a.num_nodes
        assert b.num_nodes == n
        fields = ("split_feature", "split_bin", "default_left", "left_child",
                  "right_child")
        same = all(np.array_equal(getattr(b, k)[:n], getattr(a, k)[:n])
                   for k in fields) and np.array_equal(
            np.asarray(b.cat_bitset)[:n].astype(np.uint32),
            np.asarray(a.cat_bitset)[:n].astype(np.uint32))
        if same:
            np.testing.assert_allclose(b.leaf_value[:n + 1],
                                       a.leaf_value[:n + 1], rtol=0,
                                       atol=leaf_atol)
            continue
        assert is_cat[np.asarray(a.split_feature[:n])].any()
        np.testing.assert_array_equal(np.sort(b.split_feature[:n]),
                                      np.sort(a.split_feature[:n]))
        np.testing.assert_allclose(np.sort(b.split_gain[:n]),
                                   np.sort(a.split_gain[:n]), rtol=1e-4)
        la = tree_leaves(a, ds.binned, nan_bins, is_cat)
        lb = tree_leaves(b, ds.binned, nan_bins, is_cat)
        pairs = np.unique(np.stack([la, lb]), axis=1).shape[1]
        assert pairs == len(np.unique(la)) == len(np.unique(lb))
        np.testing.assert_allclose(np.asarray(b.leaf_value)[lb],
                                   np.asarray(a.leaf_value)[la], rtol=0,
                                   atol=leaf_atol)


@pytest.mark.parametrize("objective", ["regression", "binary", "poisson"])
@pytest.mark.parametrize("grower", ["masked", "compact"])
def test_train_categorical_matches_jax(grower, objective):
    X, signal = _cat_data(2500, seed=5)
    y = _labels(objective, signal)
    p = dict(BASE, objective=objective, tpu_grower=grower)
    _kernels.reset_counts()
    jb, tb = _train_both(X, y, p, {"tpu_fused": "off"})
    assert tb._gbdt.use_compact == (grower == "compact")
    assert sum(_kernels.LAUNCHES.values()) == 0
    assert_same_trees(jb._gbdt.models, tb._gbdt.models, tb.train_set._inner)
    splits = np.concatenate([t.split_feature[:t.num_nodes]
                             for t in tb._gbdt.models])
    assert np.isin(splits, [1, 4]).any() and (splits == 2).any()
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), atol=1e-5,
                               rtol=1e-5)
    Xn, _ = _cat_data(400, seed=77)
    np.testing.assert_allclose(tb.predict(Xn, raw_score=True),
                               jb.predict(Xn, raw_score=True), atol=1e-5,
                               rtol=1e-5)


def test_train_categorical_matches_fused_kernel_interpret():
    X, signal = _cat_data(1203, seed=9, nan=False)
    p = dict(BASE, objective="regression", tpu_grower="compact")
    jb, tb = _train_both(X, signal, p, {"tpu_fused_interpret": True,
                                        "tpu_fused_block": 128})
    np.testing.assert_allclose(tb.predict(X), jb.predict(X), atol=1e-4)
