"""The port's training path end to end on the CPU (``device_type="cpu"``,
the plain versions of the kernels) against the JAX package.

* the binary objective's gradients, hessians and boost-from-average;
* ``lightgbm_tpu_torch.train`` through the compact grower against
  ``lightgbm_tpu.train`` with ``tpu_grower=compact``: without the fused
  kernel (``tpu_fused=off``) the trees must be equal split for split, leaf
  values within rtol 1e-5 (atol 1e-6 for values near 0) and predictions
  within 1e-6 (both accumulate f32 histograms, in another order); against the fused Pallas kernel in
  interpret mode, whose hi/lo-bf16 histogram can move a gain in the fifth
  digit, predictions agree within 1e-4. The data (seed 7 of the pack4
  tests' Higgs-like generator, no NaN) has no near-tie between candidate
  splits, so the trees are equal there too;
* ``lightgbm_tpu_torch.convert``: trees trained by the JAX package, carried
  over as numpy arrays, predict what the JAX booster predicts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.dataset import Metadata as JaxMetadata
from lightgbm_tpu.objectives import BinaryLogloss as JaxBinary
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.boosting import create_boosting
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import booster_from_arrays, dataset_from_arrays
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.objectives import BinaryLogloss

BASE = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1,
        "min_data_in_leaf": 20, "verbosity": -1}


def _higgs_like(n, f, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] - 0.4 * X[:, 2] + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


@pytest.mark.parametrize("kw", [{}, {"is_unbalance": True},
                                {"scale_pos_weight": 3.0, "sigmoid": 0.7}])
@pytest.mark.parametrize("weighted", [False, True])
def test_binary_objective(kw, weighted):
    rng = np.random.RandomState(0)
    n = 500
    label = (rng.rand(n) < 0.3).astype(np.float32)
    weight = rng.rand(n).astype(np.float32) + 0.5 if weighted else None
    score = (rng.randn(n) * 2).astype(np.float32)
    md, jmd = Metadata(n), JaxMetadata(n)
    for m in (md, jmd):
        m.set_label(label)
        m.set_weight(weight)
    params = dict(kw, objective="binary")
    port, ref = BinaryLogloss(Config(params)), JaxBinary(JaxConfig(params))
    port.init(md, n)
    ref.init(jmd, n)
    g, h = port.get_gradients(
        torch.from_numpy(score), torch.from_numpy(label),
        None if weight is None else torch.from_numpy(weight))
    rg, rh = ref.get_gradients(jnp.asarray(score))
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=1e-6,
                               atol=1e-7)
    assert port.boost_from_score(0) == pytest.approx(ref.boost_from_score(0),
                                                     rel=1e-12)
    np.testing.assert_allclose(np.asarray(port.convert_output(score)),
                               np.asarray(ref.convert_output(score)),
                               rtol=1e-6)


def _train_both(X, y, jax_extra, rounds=3, Xv=None, yv=None, params=None):
    p = dict(BASE, **(params or {}))
    jp = dict(p, tpu_grower="compact", **jax_extra)
    tp = dict(p, tpu_grower="compact", device_type="cpu")
    jev, tev = {}, {}
    jds = lgb.Dataset(X, label=y, params=jp)
    tds = lgt.Dataset(X, y, params=tp)
    jkw, tkw = {}, {}
    if Xv is not None:
        jkw = {"valid_sets": [jds.create_valid(Xv, label=yv)],
               "callbacks": [lgb.record_evaluation(jev)]}
        tkw = {"valid_sets": [tds.create_valid(Xv, yv)],
               "callbacks": [lgt.record_evaluation(tev)]}
    bj = lgb.train(jp, jds, rounds, **jkw)
    bt = lgt.train(tp, tds, rounds, **tkw)
    return bj, bt, jev, tev


def _assert_same_trees(tj, tt, leaf_rtol=1e-5):
    """JAX HostTrees ``tj`` and port HostTrees ``tt`` are equal split for
    split."""
    assert len(tj) == len(tt)
    for a, b in zip(tj, tt):
        n = a.num_nodes
        assert b.num_nodes == n and b.num_leaves == a.num_leaves
        for name in ("split_feature", "split_bin", "default_left",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:n],
                                          getattr(a, name)[:n], err_msg=name)
        # a leaf value near 0 comes from a cancelling gradient sum: its
        # error is relative to the larger leaf values (about 0.1-0.2 here)
        np.testing.assert_allclose(b.leaf_value[:n + 1],
                                   a.leaf_value[:n + 1], rtol=leaf_rtol,
                                   atol=1e-6)


def test_train_matches_unfused_compact_grower():
    X, y = _higgs_like(1203, 6)
    _kernels.reset_counts()
    bj, bt, _, _ = _train_both(X, y, {"tpu_fused": "off"})
    _assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    assert all(t.num_nodes == 14 for t in bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-6)
    # the CPU run went through the plain versions only: one fused split per
    # tree node plus the root, each with its histogram
    calls = 3 * 15
    assert _kernels.PLAIN_CALLS["fused_split"] == calls
    assert _kernels.PLAIN_CALLS["histogram"] == calls
    assert sum(_kernels.LAUNCHES.values()) == 0


def test_train_matches_fused_kernel_interpret():
    X, y = _higgs_like(1203, 6)
    bj, bt, _, _ = _train_both(X, y, {"tpu_fused_interpret": True,
                                      "tpu_fused_block": 128})
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-4)
    # leaf values -G/H inherit the hi/lo-bf16 split's 2^-16 relative error
    # of G and of H
    _assert_same_trees(bj._gbdt.models, bt._gbdt.models, leaf_rtol=1e-4)


def test_train_with_nan_weights_and_validation():
    """NaN-missing features, a depth limit, L2 and a validation set: same predictions and the same validation metrics. With
    NaN bins two mirrored splits (a threshold with missing right, or the
    complement with missing left) can tie exactly, so only the
    predictions, not the split records, are compared."""
    rng = np.random.RandomState(3)
    X, y = _higgs_like(1500, 6, seed=5)
    X[rng.rand(*X.shape) < 0.08] = np.nan
    Xv, yv = X[1200:], y[1200:]
    X, y = X[:1200], y[:1200]
    params = {"metric": "auc,binary_logloss", "max_depth": 4,
              "lambda_l2": 1.0, "max_bin": 63}
    bj, bt, jev, tev = _train_both(X, y, {"tpu_fused": "off"}, 4, Xv, yv,
                                   params)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), atol=1e-6)
    assert max(t.max_depth for t in bt._gbdt.models) <= 4
    for metric in ("auc", "binary_logloss"):
        np.testing.assert_allclose(tev["valid_0"][metric],
                                   jev["valid_0"][metric], rtol=1e-6)


def test_sample_weights_match():
    X, y = _higgs_like(1000, 5, seed=9)
    w = np.random.RandomState(4).rand(1000) + 0.25
    p = dict(BASE, tpu_grower="compact")
    bj = lgb.train(dict(p, tpu_fused="off"),
                   lgb.Dataset(X, label=y, weight=w), 3)
    bt = lgt.train(dict(p, device_type="cpu"),
                   lgt.Dataset(X, y, weight=w), 3)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)


def test_convert_round_trip():
    """JAX-trained trees, mapper arrays and init score as numpy arrays ->
    a port Booster with the same predictions."""
    rng = np.random.RandomState(1)
    X, y = _higgs_like(1203, 6, seed=2)
    X[rng.rand(*X.shape) < 0.05] = np.nan
    bj = lgb.train(dict(BASE, tpu_grower="compact", tpu_fused="off"),
                   lgb.Dataset(X, label=y), 4)
    init = float(bj._gbdt._init_scores[0])
    trees = []
    for i, t in enumerate(bj._gbdt.models):
        d = {k: np.asarray(getattr(t, k)) for k in (
            "split_feature", "split_bin", "default_left", "left_child",
            "right_child", "leaf_value", "leaf_depth")}
        if i == 0:
            d["leaf_value"] = d["leaf_value"] - np.float32(init)
        d.update(num_leaves=t.num_leaves, num_nodes=t.num_nodes,
                 shrinkage=t.shrinkage)
        trees.append(d)
    mappers = bj._gbdt.train_set.mappers
    bt = booster_from_arrays(
        trees, [m.bin_upper_bounds for m in mappers],
        [m.nan_bin for m in mappers], [m.missing_type for m in mappers],
        [m.num_bins for m in mappers], init_score=init,
        params={"objective": "binary", "device_type": "cpu"})
    assert bt.num_trees() == 4
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)
    Xn = np.random.RandomState(8).randn(300, 6)
    Xn[::7, 2] = np.nan
    np.testing.assert_allclose(bt.predict(Xn, raw_score=True),
                               bj.predict(Xn, raw_score=True), atol=1e-6)


def test_dataset_from_arrays_trains_like_jax():
    """The JAX package's bin matrix and mapper arrays -> a port
    BinnedDataset equal to the port's own binning, on which the port's GBDT
    grows the JAX package's trees."""
    X, y = _higgs_like(1203, 6, seed=4)
    X[np.random.RandomState(2).rand(len(X)) < 0.03, 1] = np.nan
    jp = dict(BASE, tpu_grower="compact", tpu_fused="off",
              enable_bundle=False)
    jds = lgb.Dataset(X, label=y, params=jp)
    bj = lgb.train(jp, jds, 3)
    ms = jds._inner.mappers
    ds = dataset_from_arrays(
        jds._inner.binned, [m.bin_upper_bounds for m in ms],
        [m.nan_bin for m in ms], [m.missing_type for m in ms],
        [m.num_bins for m in ms], y)
    own = lgt.Dataset(X, y, params={"device_type": "cpu"}).construct()._inner
    np.testing.assert_array_equal(ds.binned, own.binned)
    for a, b in zip(ds.mappers, own.mappers):
        assert (a.num_bins, a.nan_bin, a.default_bin) == \
            (b.num_bins, b.nan_bin, b.default_bin)
    cfg = Config(dict(BASE, device_type="cpu"))
    gbdt = create_boosting(cfg, ds, BinaryLogloss(cfg), torch.device("cpu"))
    for _ in range(3):
        gbdt.train_one_iter()
    _assert_same_trees(bj._gbdt.models, gbdt.models)
    with pytest.raises(ValueError, match="NaN bin"):
        dataset_from_arrays(
            jds._inner.binned, [m.bin_upper_bounds for m in ms],
            [m.nan_bin + 1 for m in ms], [m.missing_type for m in ms],
            [m.num_bins for m in ms], y)


def test_booster_api():
    X, y = _higgs_like(800, 4, seed=6)
    ds = lgt.Dataset(X[:600], y[:600])
    dv = ds.create_valid(X[600:], y[600:])
    bst = lgt.Booster({"objective": "binary", "device_type": "cpu",
                       "num_leaves": 7, "metric": "auc", "verbosity": -1},
                      ds)
    bst.add_valid(dv, "valid")
    for _ in range(3):
        assert bst.update() is False
    assert bst.current_iteration() == 3
    (name, metric, value, higher), = bst.eval_valid()
    assert (name, metric, higher) == ("valid", "auc", True)
    assert 0.5 < value <= 1.0
    p = bst.predict(X)
    assert p.shape == (800,) and np.all((p > 0) & (p < 1))
    np.testing.assert_allclose(
        bst.predict(X, num_iteration=1, raw_score=True),
        bst._gbdt.predict_raw_matrix(X, 1)[0])


def test_constant_features_stop_training():
    X = np.ones((300, 3))
    y = (np.arange(300) % 2).astype(float)
    bst = lgt.train({"objective": "binary", "device_type": "cpu",
                     "verbosity": -1}, lgt.Dataset(X, y), 5)
    assert bst.current_iteration() == 0
    np.testing.assert_allclose(bst.predict(X), 0.5, atol=1e-6)
