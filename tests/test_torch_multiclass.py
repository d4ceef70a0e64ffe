"""Multiclass and the pointwise objectives of the port (lightgbm_tpu_torch)
against the JAX package, on the CPU (``device_type="cpu"``, the plain
versions of the kernels).

* every ported objective's gradients and hessians within 1e-6 relative of
  the JAX package's (``[K, N]`` for softmax and one-vs-all), with and
  without sample weights; ``boost_from_score`` and ``convert_output`` equal;
* every ported metric within 1e-6 relative on the same scores;
* ``train`` with ``multiclass`` and ``multiclassova`` (categorical features
  included) on the masked and the compact grower: the trees equal the JAX
  package's split for split (against ``tpu_fused=off`` on the compact
  grower; up to the mirrored categorical tie of
  ``test_torch_categorical.assert_same_trees``), in class order, and
  predictions (``[N, K]`` probabilities and
  raw scores) agree within 1e-5; within 1e-4 of the fused Pallas kernel in
  interpret mode; validation metrics agree within 1e-5;
* each pointwise objective trains on both growers to the JAX package's
  predictions;
* ``convert.py`` carries a JAX multiclass-categorical model (class-
  interleaved trees, bitsets, categorical mappers) into a port Booster that
  predicts what it predicts.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.dataset import Metadata as JaxMetadata
from lightgbm_tpu.metrics import create_metric as jax_create_metric
from lightgbm_tpu.objectives import create_objective as jax_create_objective
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.convert import booster_from_arrays
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.metrics import create_metrics
from lightgbm_tpu_torch.objectives import create_objective

from test_torch_categorical import assert_same_trees

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

N = 600


def _labels(objective, rng, n):
    if objective in ("multiclass", "multiclassova"):
        return rng.randint(0, 4, n).astype(np.float32)
    if objective in ("binary",):
        return (rng.rand(n) < 0.3).astype(np.float32)
    if objective in ("xentropy", "xentlambda"):
        return rng.rand(n).astype(np.float32)
    if objective in ("poisson", "gamma", "tweedie"):
        return (rng.poisson(2.0, n) + (objective == "gamma")).astype(
            np.float32)
    return (3.0 * rng.randn(n)).astype(np.float32)


OBJECTIVES = [
    ("regression", {}), ("regression", {"reg_sqrt": True}),
    ("huber", {"alpha": 0.7}), ("fair", {"fair_c": 0.5}),
    ("poisson", {"poisson_max_delta_step": 0.5}), ("gamma", {}),
    ("tweedie", {"tweedie_variance_power": 1.3}), ("xentropy", {}),
    ("xentlambda", {}), ("binary", {"sigmoid": 0.8}),
    ("multiclass", {"num_class": 4}),
    ("multiclassova", {"num_class": 4, "sigmoid": 1.5}),
]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective,kw", OBJECTIVES)
def test_objective_matches_jax(objective, kw, weighted):
    rng = np.random.RandomState(len(objective) + weighted)
    label = _labels(objective, rng, N)
    weight = (rng.rand(N) + 0.5).astype(np.float32) if weighted else None
    k = kw.get("num_class", 1)
    score = (rng.randn(k, N) * (0.5 if k > 1 else 1.0)).astype(np.float32)
    params = dict(kw, objective=objective)
    port = create_objective(Config(params).objective, Config(params))
    ref = jax_create_objective(JaxConfig(params).objective,
                               JaxConfig(params))
    md, jmd = Metadata(N), JaxMetadata(N)
    for m in (md, jmd):
        m.set_label(label)
        m.set_weight(weight)
    port.init(md, N)
    ref.init(jmd, N)
    assert port.num_model_per_iteration == k
    s = score if k > 1 else score[0]
    g, h = port.get_gradients(
        torch.from_numpy(s), torch.from_numpy(label),
        None if weight is None else torch.from_numpy(weight))
    rg, rh = ref.get_gradients(jnp.asarray(s))
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=1e-6,
                               atol=1e-6)
    for c in range(k):
        assert port.boost_from_score(c) == pytest.approx(
            ref.boost_from_score(c), rel=1e-12, abs=1e-12)
    raw = s.T if k > 1 else s
    np.testing.assert_allclose(np.asarray(port.convert_output(raw)),
                               np.asarray(ref.convert_output(raw)),
                               rtol=1e-6)


METRICS = [("l2", "regression"), ("rmse", "regression"),
           ("l1", "regression"), ("quantile", "regression"),
           ("huber", "regression"), ("fair", "regression"),
           ("mape", "regression"), ("poisson", "poisson"),
           ("gamma", "gamma"), ("gamma_deviance", "gamma"),
           ("tweedie", "tweedie"), ("binary_logloss", "binary"),
           ("binary_error", "binary"), ("auc", "binary"),
           ("multi_logloss", "multiclass"), ("multi_error", "multiclass"),
           ("multi_error", "multiclassova"),
           ("cross_entropy", "xentropy"),
           ("cross_entropy_lambda", "xentlambda")]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("metric,objective", METRICS)
def test_metric_matches_jax(metric, objective, weighted):
    rng = np.random.RandomState(3)
    label = _labels(objective, rng, N)
    weight = (rng.rand(N) + 0.5) if weighted else None
    params = {"objective": objective, "alpha": 0.6, "fair_c": 2.0,
              "tweedie_variance_power": 1.4}
    k = 1
    if objective.startswith("multiclass"):
        params.update(num_class=4, multi_error_top_k=1)
        k = 4
    raw = (rng.randn(k, N) if k > 1 else rng.randn(N)).astype(np.float32)
    cfg, jcfg = Config(params), JaxConfig(params)
    port = create_metrics([metric], cfg)[0]
    ref = jax_create_metric(metric, jcfg)
    md, jmd = Metadata(N), JaxMetadata(N)
    for m in (md, jmd):
        m.set_label(label)
        m.set_weight(weight)
    port.init(md, N)
    ref.init(jmd, N)
    obj = create_objective(cfg.objective, cfg)
    jobj = jax_create_objective(jcfg.objective, jcfg)
    got = port.eval(raw, obj.convert_output)
    want = ref.eval(raw, lambda r: np.asarray(jobj.convert_output(
        jnp.asarray(r))))
    assert got == pytest.approx(want, rel=1e-6, abs=1e-9)
    assert port.higher_better == ref.higher_better


def _mc_data(n, seed, k=3):
    """Five numerical features and two categorical ones (a 10-category
    feature for the sorted scan, a 3-category one for one-hot); k classes
    cut from a score at its quantiles."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 7)
    X[:, 2] = rng.randint(0, 10, n)
    X[:, 5] = rng.randint(0, 3, n)
    s = (X[:, 0] - 0.5 * X[:, 1] + np.isin(X[:, 2], [1, 4, 8])
         - 0.7 * (X[:, 5] == 2) + 0.3 * rng.randn(n))
    y = np.digitize(s, np.quantile(s, np.linspace(0, 1, k + 1)[1:-1]))
    return X, y.astype(np.float64)


MC_BASE = {"num_class": 3, "num_leaves": 15, "learning_rate": 0.1,
           "min_data_in_leaf": 20, "min_data_per_group": 20,
           "cat_smooth": 2.0, "verbosity": -1}
MC_CAT = [2, 5]


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
@pytest.mark.parametrize("grower", ["masked", "compact"])
def test_train_multiclass_matches_jax(grower, objective):
    X, y = _mc_data(2400, seed=1)
    Xv, yv = _mc_data(400, seed=2)
    p = dict(MC_BASE, objective=objective, tpu_grower=grower,
             metric="multi_logloss,multi_error")
    jev, tev = {}, {}
    jds = lgb.Dataset(X, label=y, categorical_feature=MC_CAT)
    bj = lgb.train(dict(p, tpu_fused="off"), jds, 3,
                   valid_sets=[jds.create_valid(Xv, label=yv)],
                   callbacks=[lgb.record_evaluation(jev)])
    _kernels.reset_counts()
    tds = lgt.Dataset(X, y, categorical_feature=MC_CAT)
    bt = lgt.train(dict(p, device_type="cpu"), tds, 3,
                   valid_sets=[tds.create_valid(Xv, yv)],
                   callbacks=[lgt.record_evaluation(tev)])
    assert bt._gbdt.use_compact == (grower == "compact")
    assert bt.num_trees() == 9 and bt.current_iteration() == 3
    assert sum(_kernels.LAUNCHES.values()) == 0
    assert_same_trees(bj._gbdt.models, bt._gbdt.models, tds._inner)
    pt, pj = bt.predict(X), bj.predict(X)
    assert pt.shape == (2400, 3)
    np.testing.assert_allclose(pt, pj, atol=1e-5)
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               bj.predict(Xv, raw_score=True), atol=1e-5)
    np.testing.assert_allclose(bt.predict(Xv, num_iteration=2),
                               bj.predict(Xv, num_iteration=2), atol=1e-5)
    for metric in ("multi_logloss", "multi_error"):
        np.testing.assert_allclose(tev["valid_0"][metric],
                                   jev["valid_0"][metric], rtol=1e-5)


def test_train_multiclass_matches_fused_kernel_interpret():
    X, y = _mc_data(1203, seed=4)
    p = dict(MC_BASE, objective="multiclass", tpu_grower="compact")
    # one row block a contraction (tpu_hist_mbatch=1): a smaller
    # interpret-mode program
    bj = lgb.train(dict(p, tpu_fused_interpret=True, tpu_fused_block=128,
                        tpu_hist_mbatch=1),
                   lgb.Dataset(X, label=y, categorical_feature=MC_CAT), 3)
    bt = lgt.train(dict(p, device_type="cpu"),
                   lgt.Dataset(X, y, categorical_feature=MC_CAT), 3)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-4)


def _reg_labels(objective, X, seed):
    rng = np.random.RandomState(seed)
    s = 0.6 * X[:, 0] - 0.4 * X[:, 1] + 0.5 * np.isin(X[:, 2], [1, 4, 8])
    if objective in ("poisson", "gamma", "tweedie"):
        return rng.poisson(np.exp(s)) + (objective == "gamma")
    if objective in ("xentropy", "xentlambda"):
        return 1.0 / (1.0 + np.exp(-2.0 * s + 0.2 * rng.randn(len(s))))
    return 2.0 * s + 0.3 * rng.randn(len(s))


@pytest.mark.parametrize("objective", ["regression", "huber", "fair",
                                       "poisson", "gamma", "tweedie",
                                       "xentropy", "xentlambda"])
@pytest.mark.parametrize("grower", ["masked", "compact"])
def test_train_pointwise_objective_matches_jax(grower, objective):
    X, _ = _mc_data(1500, seed=6)
    y = _reg_labels(objective, X, seed=7)
    p = {"objective": objective, "num_leaves": 7, "learning_rate": 0.1,
         "min_data_in_leaf": 20, "verbosity": -1, "tpu_grower": grower}
    bj = lgb.train(dict(p, tpu_fused="off"), lgb.Dataset(X, label=y), 3)
    bt = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y), 3)
    assert bt._gbdt.use_compact == (grower == "compact")
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5,
                               rtol=1e-5)


def test_convert_multiclass_categorical_round_trip():
    """A JAX multiclass model with categorical splits, carried over as
    numpy arrays, predicts what the JAX booster predicts (on new data with
    unseen categories and NaN too)."""
    X, y = _mc_data(1800, seed=8)
    p = dict(MC_BASE, objective="multiclassova", tpu_grower="masked")
    bj = lgb.train(p, lgb.Dataset(X, label=y, categorical_feature=MC_CAT), 3)
    fields = ("split_feature", "split_bin", "default_left", "left_child",
              "right_child", "leaf_value", "leaf_depth", "cat_bitset")
    trees = [dict({f: np.asarray(getattr(t, f)) for f in fields},
                  num_leaves=t.num_leaves, num_nodes=t.num_nodes,
                  shrinkage=t.shrinkage) for t in bj._gbdt.models]
    assert any(np.asarray(t["cat_bitset"]).any() for t in trees)
    ms = bj._gbdt.train_set.mappers
    bt = booster_from_arrays(
        trees, [m.bin_upper_bounds for m in ms], [m.nan_bin for m in ms],
        [m.missing_type for m in ms], [m.num_bins for m in ms],
        params={"objective": "multiclassova", "num_class": 3,
                "device_type": "cpu"},
        bin_to_cats=[m.bin_to_cat if m.is_categorical else None
                     for m in ms])
    assert bt.num_trees() == 9 and bt.current_iteration() == 3
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)
    Xn, _ = _mc_data(300, seed=9)
    Xn[::5, 2] = 17.0
    Xn[::7, 2] = np.nan
    Xn[::11, 0] = np.nan
    np.testing.assert_allclose(bt.predict(Xn, raw_score=True),
                               bj.predict(Xn, raw_score=True), atol=1e-6)
