"""Leaf renewal of the port (``regression_l1``, ``quantile``, ``mape``)
against the JAX package, on the CPU (``device_type="cpu"``, the plain
versions of the kernels).

* ``ops/renew.py`` ``renew_leaf_quantile`` equals the JAX function exactly
  on unit weights and on weights on a 1/64 grid (the cumulative sums are
  exact, so both pick the same row), with empty leaves, leaves whose rows
  all weigh 0, ties at the crossing and alpha at 0.1, 0.5 and 0.9;
* the three objectives' gradients, ``boost_from_score`` and flags equal
  the JAX objectives' (every objective's flags are checked, so that no
  class inherits a wrong one);
* ``train`` on both growers: the trees equal the JAX package's split for
  split (against ``tpu_fused=off``; quantile also against the fused kernel
  in interpret mode), leaf values within 1e-6 and predictions within 1e-6;
* MAPE's label weight, as the JAX package applies it: the gradients take
  it on both growers, the masked grower renews with the metadata weight and
  the compact grower with its carried weight column, label weight included
  (a JAX-only test shows the reference doing so);
* a quantile model's text names its alpha and loads into the JAX package.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.dataset import Metadata as JaxMetadata
from lightgbm_tpu.objectives import create_objective as jax_create_objective
from lightgbm_tpu.ops.renew import renew_leaf_quantile as jax_renew
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.config import OBJECTIVE_ALIASES, Config
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.objectives import OBJECTIVES, create_objective
from lightgbm_tpu_torch.ops.renew import renew_leaf_quantile

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

RENEW = ["regression_l1", "quantile", "mape"]


@pytest.mark.parametrize("alpha", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("weights", ["unit", "grid64", "zero_leaf"])
def test_renew_leaf_quantile_matches_jax(weights, alpha):
    rng = np.random.RandomState(int(alpha * 10))
    n, L = 3000, 12
    # residuals on a coarse grid: many ties, some at the crossing
    residual = (rng.randint(-40, 40, n) / 8.0).astype(np.float32)
    row_leaf = rng.randint(0, L - 3, n).astype(np.int32)    # 3 empty leaves
    if weights == "unit":
        w = np.ones(n, np.float32)
    else:
        w = (rng.randint(0, 64, n) / 64.0).astype(np.float32)
    if weights == "zero_leaf":
        w[row_leaf == 2] = 0.0
    got = renew_leaf_quantile(torch.from_numpy(residual),
                              torch.from_numpy(w),
                              torch.from_numpy(row_leaf), L, alpha)
    want = np.asarray(jax_renew(jnp.asarray(residual), jnp.asarray(w),
                                jnp.asarray(row_leaf), L, alpha))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.float32 and got.shape == (L,)
    assert np.all(want[L - 3:] == 0.0)
    if weights == "zero_leaf":
        assert want[2] == 0.0


def test_renew_tie_at_the_crossing():
    """Half the weight sits exactly at the crossing: the first row whose
    cumulative weight reaches alpha * total is the one taken."""
    residual = torch.tensor([3.0, 1.0, 2.0, 2.0, 5.0, 1.0])
    w = torch.tensor([1.0, 1.0, 0.5, 0.5, 1.0, 0.0])
    leaf = torch.tensor([0, 0, 0, 0, 0, 0], dtype=torch.int32)
    got = renew_leaf_quantile(residual, w, leaf, 2, 0.5)
    want = np.asarray(jax_renew(jnp.asarray(residual.numpy()),
                                jnp.asarray(w.numpy()),
                                jnp.asarray(leaf.numpy()), 2, 0.5))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[0]) == 2.0 and float(got[1]) == 0.0


@pytest.mark.parametrize("name", sorted(set(OBJECTIVE_ALIASES.values())))
def test_objective_flags_match_jax(name):
    params = {"objective": name, "num_class": 3 if "multiclass" in name
              else 1}
    port = create_objective(Config(params).objective, Config(params))
    ref = jax_create_objective(name, JaxConfig(params))
    for flag in ("is_constant_hessian", "row_elementwise", "renew_leaves",
                 "is_ranking", "is_stochastic"):
        assert getattr(port, flag) == getattr(ref, flag, False), flag
    if port.renew_leaves:
        assert port.renew_alpha == ref.renew_alpha
    assert name in OBJECTIVES


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective", RENEW)
def test_renew_objective_gradients_match_jax(objective, weighted):
    rng = np.random.RandomState(5)
    n = 500
    label = (3.0 * rng.randn(n)).astype(np.float32)
    label[::17] = 0.0
    weight = (rng.rand(n) + 0.5).astype(np.float32) if weighted else None
    score = rng.randn(n).astype(np.float32)
    score[::13] = label[::13]                 # diff == 0 picks a branch
    params = {"objective": objective, "alpha": 0.7}
    port = create_objective(Config(params).objective, Config(params))
    ref = jax_create_objective(objective, JaxConfig(params))
    md, jmd = Metadata(n), JaxMetadata(n)
    for m in (md, jmd):
        m.set_label(label)
        m.set_weight(weight)
    port.init(md, n)
    ref.init(jmd, n)
    w = None if port.weight is None else torch.from_numpy(
        np.asarray(port.weight, np.float32))
    g, h = port.get_gradients(torch.from_numpy(score),
                              torch.from_numpy(label), w)
    rg, rh = ref.get_gradients(jnp.asarray(score))
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(
        np.asarray(port.weight) if port.weight is not None else None,
        np.asarray(ref.weight) if ref.weight is not None else None)
    assert port.boost_from_score() == pytest.approx(
        ref.boost_from_score(), rel=1e-12, abs=1e-12)


def _reg_data(n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    X[::11, 3] = np.nan
    y = 2.0 * X[:, 0] - X[:, 1] + 0.5 * rng.standard_t(3, n) + 3.0
    w = rng.randint(1, 64, n) / 64.0
    return X, y, w


def _assert_same_trees(tj, tt, atol=1e-6):
    assert len(tj) == len(tt)
    for a, b in zip(tj, tt):
        n = a.num_nodes
        assert b.num_nodes == n
        for k in ("split_feature", "split_bin", "default_left",
                  "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, k)[:n],
                                          np.asarray(getattr(a, k))[:n], k)
        np.testing.assert_allclose(b.leaf_value[:n + 1],
                                   np.asarray(a.leaf_value)[:n + 1],
                                   rtol=0, atol=atol)


PARAMS = {"num_leaves": 7, "min_data_in_leaf": 20, "learning_rate": 0.2,
          "alpha": 0.9, "verbosity": -1}


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("grower", ["masked", "compact"])
@pytest.mark.parametrize("objective", RENEW)
def test_train_renewal_matches_jax(objective, grower, weighted):
    X, y, w = _reg_data(2000, seed=1)
    w = w if weighted else None
    p = dict(PARAMS, objective=objective, tpu_grower=grower,
             metric=["l1", "quantile", "mape"])
    Xv, yv, _ = _reg_data(300, seed=2)
    jev, tev = {}, {}
    jds = lgb.Dataset(X, label=y, weight=w)
    bj = lgb.train(dict(p, tpu_fused="off"), jds, 3,
                   valid_sets=[jds.create_valid(Xv, label=yv)],
                   callbacks=[lgb.record_evaluation(jev)])
    _kernels.reset_counts()
    tds = lgt.Dataset(X, y, weight=w)
    bt = lgt.train(dict(p, device_type="cpu"), tds, 3,
                   valid_sets=[tds.create_valid(Xv, yv)],
                   callbacks=[lgt.record_evaluation(tev)])
    assert bt._gbdt.use_compact == bj._gbdt._use_compact \
        == (grower == "compact")
    assert sum(_kernels.LAUNCHES.values()) == 0
    _assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                               atol=1e-6)
    for m in ("l1", "quantile", "mape"):
        np.testing.assert_allclose(tev["valid_0"][m], jev["valid_0"][m],
                                   rtol=1e-6)


def test_train_quantile_matches_fused_kernel_interpret():
    X, y, w = _reg_data(2000, seed=3)
    p = dict(PARAMS, objective="quantile", tpu_grower="compact")
    bj = lgb.train(dict(p, tpu_fused_interpret=True, tpu_fused_block=128),
                   lgb.Dataset(X, label=y, weight=w), 2)
    bt = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y, weight=w),
                   2)
    assert bt._gbdt.use_compact and bj._gbdt._use_compact
    _assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), rtol=0,
                               atol=1e-6)


def test_jax_mape_weights_by_grower():
    """The reference's MAPE, JAX only: ``init`` folds the label weight
    into ``obj.weight``; the compact grower carries ``obj.weight`` as its
    weight column (read by its gradients and its renewal), while the
    masked grower renews with ``row_weight``, the metadata weight."""
    X, y, w = _reg_data(2000, seed=4)
    lw = 1.0 / np.maximum(1.0, np.abs(y.astype(np.float32)))
    p = dict(PARAMS, objective="mape")
    bc = lgb.train(dict(p, tpu_grower="compact", tpu_fused="off"),
                   lgb.Dataset(X, label=y, weight=w), 1)
    g = bc._gbdt
    folded = np.asarray(g.objective.weight)
    np.testing.assert_allclose(folded, w.astype(np.float32) * lw, rtol=1e-6)
    rid, wcol = g._compact_cols(g._compact["work"], g._cx_rowid,
                                g._cx_weight)
    carried = np.empty_like(folded)
    carried[np.asarray(rid).astype(np.int64)] = np.asarray(wcol)
    np.testing.assert_array_equal(carried, folded)
    bm = lgb.train(dict(p, tpu_grower="masked"),
                   lgb.Dataset(X, label=y, weight=w), 1)
    np.testing.assert_array_equal(np.asarray(bm._gbdt.row_weight),
                                  w.astype(np.float32))
    assert not np.allclose(np.asarray(bm._gbdt.row_weight),
                           np.asarray(bm._gbdt.objective.weight))


def test_quantile_text_loads_in_jax(tmp_path):
    X, y, _ = _reg_data(1500, seed=6)
    bt = lgt.train(dict(PARAMS, objective="quantile", alpha=0.8,
                        device_type="cpu"), lgt.Dataset(X, y), 4)
    text = bt.model_to_string()
    assert "objective=quantile alpha:0.8" in text
    back = lgt.Booster(model_str=text)
    np.testing.assert_allclose(back.predict(X), bt.predict(X), atol=1e-6)
    assert back._gbdt.objective.alpha == 0.8
    np.testing.assert_allclose(lgb.Booster(model_str=text).predict(X),
                               bt.predict(X), atol=1e-6)
