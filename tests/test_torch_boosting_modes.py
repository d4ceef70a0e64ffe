"""DART and random-forest boosting and forced splits in the port on the CPU,
held against the JAX package on the same numpy inputs.

* DART on both growers (the compact grower against ``tpu_fused=off`` and
  against the fused kernel in interpret mode): plain drops,
  ``uniform_drop``, ``xgboost_dart_mode``, ``max_drop``, multiclass (K
  trees dropped together); the same drop lists and tree weights, trees
  equal split for split, validation metrics within 1e-6, predictions
  within 1e-5; rollback, continued training and model text;
* random forest on the masked grower with the JAX package's bag draws
  (``sample_strategy.draws``): binary, feature sampling alone, quantile
  renewal against the init score; the train and validation scores as
  running averages; ``average_output`` in saved and loaded text; the
  ``ValueError``s and the lazy-CEGB warning;
* forced splits: the schedule, trees whose first splits follow the JSON
  with gain 0 on forced nodes, a categorical feature raising, and data of
  65,536 rows or more still taking the masked grower (with RF and linear
  leaves).

Binary gradients are rounded to a 1/64 grid in both packages (``dyadic``),
so every histogram sum is exact and no near tie is broken by f32 order.
The data: 3,000 rows of 8 features, 15 leaves.
"""
import json
import logging
import os

import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.boosting import dart as jdart
from lightgbm_tpu.boosting import gbdt as jgbdt
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.boosting import dart as tdart
from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
from lightgbm_tpu_torch.model_io import LoadedGBDT
from test_torch_constraints import ORACLES, _data, dyadic  # noqa: F401
from test_torch_sampling import assert_same_trees, jax_uniform

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
        "verbosity": -1, "metric": "binary_logloss"}
DART = {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0}
RF = {"boosting": "rf", "bagging_fraction": 0.632, "bagging_freq": 1,
      "feature_fraction": 0.8}


@pytest.fixture
def same_bags(monkeypatch):
    """Every port GBDT made in the test draws its bags from the JAX
    package's draws."""
    init = gbdt_mod.GBDT.__init__

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        self.sample_strategy.draws = jax_uniform
    monkeypatch.setattr(gbdt_mod.GBDT, "__init__", patched)


@pytest.fixture
def drops(monkeypatch):
    """The drop lists each package chose, in order: ``{"jax": [...],
    "port": [...]}``."""
    out = {"jax": [], "port": []}
    for key, cls in (("jax", jdart.DART), ("port", tdart.DART)):
        own = cls._select_drop

        def recording(self, own=own, key=key):
            d = own(self)
            out[key].append(list(d))
            return d
        monkeypatch.setattr(cls, "_select_drop", recording)
    return out


def train_both(params, rounds, oracle="xla", X=None, y=None, valid=True,
               **ds_kw):
    """The same ``train`` call in both packages with a validation set:
    ``(jax, port, jax evals, port evals)``."""
    if X is None:
        X, y, _ = _data()
    n_val = len(X) // 5
    out = []
    for mod, extra in ((lgb, ORACLES[oracle]), (lgt, {"device_type": "cpu"})):
        ds = (mod.Dataset(X[n_val:], y[n_val:], **ds_kw) if mod is lgt
              else mod.Dataset(X[n_val:], label=y[n_val:], **ds_kw))
        evals = {}
        kw = {}
        if valid:
            dv = (ds.create_valid(X[:n_val], y[:n_val]) if mod is lgt
                  else ds.create_valid(X[:n_val], label=y[:n_val]))
            kw = dict(valid_sets=[dv],
                      callbacks=[mod.record_evaluation(evals)])
        _kernels.reset_counts()
        out.append((mod.train(dict(params, **extra), ds, rounds, **kw),
                    evals))
    (bj, ej), (bt, et) = out
    return bj, bt, ej, et


def same_trees(tj, tt, leaf_atol=1e-5):
    """Equal split for split, leaf values within ``leaf_atol``."""
    if leaf_atol == 1e-5:
        return assert_same_trees(tj, tt)
    assert len(tj) == len(tt)
    for a, b in zip(tj, tt):
        n = a.num_nodes
        assert b.num_nodes == n
        for name in ("split_feature", "split_bin", "default_left",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:n],
                                          getattr(a, name)[:n], err_msg=name)
        np.testing.assert_allclose(b.leaf_value[:n + 1], a.leaf_value[:n + 1],
                                   rtol=0, atol=leaf_atol)


def check_same(bj, bt, ej, et, X, leaf_atol=1e-5):
    assert sum(_kernels.LAUNCHES.values()) == 0
    assert bt._gbdt.use_compact == bj._gbdt._use_compact
    same_trees(bj._gbdt.models, bt._gbdt.models, leaf_atol)
    assert [m.shrinkage for m in bt._gbdt.models] == pytest.approx(
        [m.shrinkage for m in bj._gbdt.models], rel=1e-12)
    for name in ej:
        for metric, values in ej[name].items():
            np.testing.assert_allclose(et[name][metric], values, rtol=0,
                                       atol=1e-6, err_msg=metric)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)


# ---- DART ---------------------------------------------------------------

DART_CASES = {
    "plain": {},
    "uniform": {"uniform_drop": True},
    "xgboost": {"xgboost_dart_mode": True},
    "max_drop": {"max_drop": 1, "drop_rate": 0.9},
    "skip": {"skip_drop": 0.5, "drop_seed": 11},
}


@pytest.mark.parametrize("grower", ["masked", "compact"])
@pytest.mark.parametrize("case", sorted(DART_CASES))
def test_dart_matches_reference(case, grower, dyadic, drops):
    X, y, _ = _data()
    p = {**BASE, **DART, **DART_CASES[case], "tpu_grower": grower}
    bj, bt, ej, et = train_both(p, 6)
    assert bt._gbdt.use_compact == (grower == "compact")
    assert drops["port"] == drops["jax"]
    assert sum(len(d) for d in drops["port"]) > 0
    if case == "max_drop":
        assert max(len(d) for d in drops["port"]) == 1
    assert bt._gbdt.tree_weight == pytest.approx(bj._gbdt.tree_weight,
                                                 rel=1e-12)
    assert bt._gbdt.sum_weight == pytest.approx(bj._gbdt.sum_weight,
                                                rel=1e-12)
    check_same(bj, bt, ej, et, X)


def test_dart_compact_matches_fused_kernel_interpret(dyadic, drops):
    X, y, _ = _data()
    p = dict(BASE, **DART, tpu_grower="compact")
    bj, bt, ej, et = train_both(p, 4, oracle="fused_interpret")
    assert drops["port"] == drops["jax"]
    assert bt._gbdt.use_compact
    check_same(bj, bt, ej, et, X)


@pytest.mark.parametrize("grower", ["masked", "compact"])
def test_dart_multiclass_drops_k_trees(grower, drops):
    """Three classes: a dropped iteration takes its three trees out
    together and puts them back scaled."""
    X, _, _ = _data()
    y = np.digitize(X[:, 0] - 0.5 * X[:, 2], [-0.5, 0.5]).astype(float)
    p = dict(BASE, **DART, objective="multiclass", num_class=3,
             metric="multi_logloss", num_leaves=7, tpu_grower=grower)
    bj, bt, ej, et = train_both(p, 4, X=X, y=y)
    assert drops["port"] == drops["jax"]
    assert len(bt._gbdt.models) == 12
    check_same(bj, bt, ej, et, X)


def test_dart_rollback_and_continued_training(dyadic, drops, tmp_path):
    """``rollback_one_iter`` between updates, then a DART run continued
    from the saved model (its loaded trees are never dropped)."""
    X, y, _ = _data()
    p = dict(BASE, **DART, tpu_grower="compact")
    boosters = {}
    for mod, extra in ((lgb, ORACLES["xla"]), (lgt, {"device_type": "cpu"})):
        ds = (mod.Dataset(X, y, free_raw_data=False) if mod is lgt
              else mod.Dataset(X, label=y, free_raw_data=False))
        b = mod.Booster(dict(p, **extra), ds)
        for _ in range(3):
            b.update()
        b.rollback_one_iter()
        b.update()
        b.update()
        boosters[mod] = b
    bj, bt = boosters[lgb], boosters[lgt]
    assert drops["port"] == drops["jax"]
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    # the train score after drops, rollback and normalization is the
    # model's own prediction of the training rows
    np.testing.assert_allclose(bt._gbdt.train_score_original_order()[0],
                               bt.predict(X, raw_score=True), atol=1e-5)
    path = str(tmp_path / "dart.txt")
    bt.save_model(path)
    cont = {}
    for mod, extra in ((lgb, ORACLES["xla"]), (lgt, {"device_type": "cpu"})):
        ds = (mod.Dataset(X, y, free_raw_data=False) if mod is lgt
              else mod.Dataset(X, label=y, free_raw_data=False))
        cont[mod] = mod.train(dict(p, **extra), ds, 3, init_model=path)
    assert_same_trees(cont[lgb]._gbdt.models, cont[lgt]._gbdt.models)
    np.testing.assert_allclose(cont[lgt].predict(X), cont[lgb].predict(X),
                               atol=1e-5)


def test_dart_model_text_matches_reference(dyadic, tmp_path):
    X, y, _ = _data()
    p = dict(BASE, **DART)
    bj, bt, _, _ = train_both(p, 5, valid=False)
    pj, pt = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    bj.save_model(pj)
    bt.save_model(pt)
    want = bt.predict(X)
    for path in (pj, pt):
        np.testing.assert_allclose(lgt.Booster(model_file=path).predict(X),
                                   want, atol=1e-6)
    np.testing.assert_allclose(lgb.Booster(model_file=pt).predict(X), want,
                               atol=1e-6)
    text = open(pt).read()
    assert "average_output" not in text
    # the scaled trees' shrinkage, as the reference writes it
    assert [ln for ln in text.splitlines() if ln.startswith("shrinkage=")] \
        == [ln for ln in open(pj).read().splitlines()
            if ln.startswith("shrinkage=")]


# ---- random forest ------------------------------------------------------

RF_CASES = {
    "binary": ({}, None),
    "feature_fraction_only": ({"bagging_fraction": 1.0, "bagging_freq": 0,
                               "feature_fraction": 0.6}, None),
    "quantile": ({"objective": "quantile", "alpha": 0.7,
                  "metric": "quantile"}, "logits"),
    "multiclass": ({"objective": "multiclass", "num_class": 3,
                    "metric": "multi_logloss", "num_leaves": 7}, "classes"),
}


def _rf_labels(X, kind, y):
    if kind == "logits":
        return np.round((X[:, 0] - 0.4 * X[:, 2]) * 64) / 64
    if kind == "classes":
        return np.digitize(X[:, 0] - 0.5 * X[:, 2], [-0.5, 0.5]).astype(
            float)
    return y


@pytest.mark.parametrize("case", sorted(RF_CASES))
def test_rf_matches_reference(case, dyadic, same_bags):
    X, y, _ = _data()
    extra, kind = RF_CASES[case]
    y = _rf_labels(X, kind, y)
    p = {**BASE, **RF, **extra}
    bj, bt, ej, et = train_both(p, 4, X=X, y=y)
    assert not bt._gbdt.use_compact
    assert all(m.shrinkage == 1.0 for m in bt._gbdt.models)
    # multiclass gradients are off the 1/64 grid: f32 sums in another
    # order part the leaves by up to a few 1e-5
    check_same(bj, bt, ej, et, X,
               leaf_atol=1e-4 if kind == "classes" else 1e-5)
    # the scores are running averages of the trees
    np.testing.assert_allclose(bt._gbdt.train_score.numpy(),
                               np.asarray(bj._gbdt.train_score), atol=1e-5)
    np.testing.assert_allclose(bt._gbdt.valid_sets[0].score.numpy(),
                               np.asarray(bj._gbdt.valid_sets[0].score),
                               atol=1e-5)
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), atol=1e-5)


def test_rf_average_output_in_model_text(dyadic, same_bags, tmp_path):
    X, y, _ = _data()
    bj, bt, _, _ = train_both(dict(BASE, **RF), 5, valid=False)
    pt, pj = str(tmp_path / "t.txt"), str(tmp_path / "j.txt")
    bt.save_model(pt)
    bj.save_model(pj)
    head = open(pt).read().split("Tree=0")[0].splitlines()
    assert "average_output" in head
    assert bt.dump_model()["average_output"] is True
    want = bt.predict(X)
    for path in (pt, pj):
        loaded = lgt.Booster(model_file=path)
        assert loaded._gbdt.average_output
        np.testing.assert_allclose(loaded.predict(X), want, atol=1e-6)
    np.testing.assert_allclose(lgb.Booster(model_file=pt).predict(X), want,
                               atol=1e-6)
    # a window of iterations averages over its own iterations
    np.testing.assert_allclose(bt.predict(X, num_iteration=2),
                               bj.predict(X, num_iteration=2), atol=1e-5)


@pytest.mark.parametrize("params", [
    {"bagging_fraction": 1.0, "bagging_freq": 0, "feature_fraction": 1.0},
    {"bagging_fraction": 0.5, "bagging_freq": 0, "feature_fraction": 1.0},
])
def test_rf_needs_sampling(params):
    X, y, _ = _data(n=500)
    for mod, extra in ((lgb, {}), (lgt, {"device_type": "cpu"})):
        ds = (mod.Dataset(X, y) if mod is lgt else mod.Dataset(X, label=y))
        with pytest.raises(ValueError, match="Random forest needs"):
            mod.train(dict(BASE, boosting="rf", **params, **extra), ds, 1)


def test_rf_refuses_custom_objectives():
    X, y, _ = _data(n=500)
    b = lgt.Booster(dict(BASE, **RF, device_type="cpu"), lgt.Dataset(X, y))

    def fobj(preds, data):
        return preds - y, np.ones_like(preds)
    with pytest.raises(ValueError, match="custom objectives"):
        b.update(fobj=fobj)


def test_rf_declines_lazy_cegb(dyadic, same_bags, caplog):
    X, y, _ = _data()
    p = dict(BASE, **RF, cegb_penalty_feature_lazy=[0.5] * 8)
    with caplog.at_level(logging.WARNING):
        bj, bt, ej, et = train_both(dict(p, verbosity=1), 3)
    for logger in ("lightgbm_tpu_torch", "lightgbm_tpu"):
        assert any(r.name == logger and "lazy penalty is ignored"
                   in r.getMessage() for r in caplog.records), logger
    assert bt._gbdt._cegb_lazy_np is None
    check_same(bj, bt, ej, et, X)


# ---- forced splits ------------------------------------------------------

FORCED = {"feature": 1, "threshold": 0.3,
          "left": {"feature": 3, "threshold": -0.2},
          "right": {"feature": 1, "threshold": 1.0,
                    "right": {"feature": 4, "threshold": 0.0,
                              "left": {"feature": 0, "threshold": 0.5}}}}


@pytest.fixture
def forced_path(tmp_path):
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(FORCED))
    return str(path)


def test_forced_schedule_matches_reference(forced_path):
    X, y, _ = _data()
    dj = lgb.Dataset(X, label=y).construct()
    dt = lgt.Dataset(X, y, params={"device_type": "cpu"}).construct()
    for leaves in (15, 3):
        want = jgbdt._forced_split_schedule(forced_path, dj._inner.mappers,
                                            leaves)
        got = gbdt_mod._forced_split_schedule(
            forced_path, dt._inner.mappers, leaves, torch.device("cpu"))
        assert len(got[0]) == min(5, leaves - 1)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("grower", ["auto", "compact"])
def test_forced_splits_match_reference(grower, forced_path, dyadic):
    X, y, _ = _data()
    p = dict(BASE, forcedsplits_filename=forced_path, tpu_grower=grower)
    bj, bt, ej, et = train_both(p, 3)
    assert not bt._gbdt.use_compact
    check_same(bj, bt, ej, et, X)
    sched = bt._gbdt._forced
    for m in bt._gbdt.models:
        # the first five splits follow the JSON breadth first: the split
        # of node k is the k-th forced split, with gain 0
        np.testing.assert_array_equal(m.split_feature[:5], [1, 3, 1, 4, 0])
        np.testing.assert_array_equal(m.split_bin[:5], sched[2].numpy())
        assert (m.split_gain[:5] == 0).all() and (m.split_gain[5:14] > 0
                                                   ).all()
        assert not m.default_left[:5].any()


def test_forced_split_on_a_categorical_feature_raises(tmp_path):
    X, y, _ = _data(cat=True)
    path = tmp_path / "forced.json"
    path.write_text(json.dumps({"feature": 5, "threshold": 3}))
    with pytest.raises(ValueError, match="categorical"):
        lgt.train(dict(BASE, forcedsplits_filename=str(path),
                       device_type="cpu"),
                  lgt.Dataset(X, y, categorical_feature=[5, 7]), 1)


@pytest.mark.parametrize("mode", ["forced", "rf", "linear"])
def test_large_data_takes_the_masked_grower(mode, forced_path, dyadic,
                                           same_bags):
    """From 65,536 rows ``auto`` takes the compact grower, except for
    forced splits, RF and linear leaves, as in the reference."""
    X, y, _ = _data(n=70_000)
    extra = {"forced": {"forcedsplits_filename": forced_path},
             "rf": RF, "linear": {"linear_tree": True}}[mode]
    if mode == "forced":
        FORCED_SMALL = {"feature": 1, "threshold": 0.3}
        with open(forced_path, "w") as fh:
            json.dump(FORCED_SMALL, fh)
    p = {**BASE, "num_leaves": 4, **extra}
    bj = lgb.train(dict(p, **ORACLES["xla"]), lgb.Dataset(X, label=y), 1)
    bt = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y), 1)
    assert not bt._gbdt.use_compact
    # the reference's RF keeps the compact grower's flag but grows every
    # tree with the masked grower (lightgbm_tpu/boosting/rf.py:70-84)
    assert bj._gbdt._use_compact == (mode == "rf")
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    base = lgt.train(dict(BASE, num_leaves=4, device_type="cpu"),
                     lgt.Dataset(X, y), 1)
    assert base._gbdt.use_compact


# ---- the parameters the port dropped unseen before (ROADMAP C3) --------

@pytest.mark.parametrize("window", [
    {"num_iteration_predict": 2}, {"start_iteration_predict": 1},
    {"start_iteration_predict": 1, "num_iteration_predict": 2}])
def test_prediction_window_from_params(window, dyadic, tmp_path):
    X, y, _ = _data()
    bj, bt, _, _ = train_both({**BASE, **window}, 4, valid=False)
    want = bj.predict(X)
    np.testing.assert_allclose(bt.predict(X), want, atol=1e-5)
    start = window.get("start_iteration_predict", 0)
    num = window.get("num_iteration_predict")
    np.testing.assert_allclose(
        bt.predict(X), bt.predict(X, start_iteration=start,
                                  num_iteration=num), atol=0)
    path = str(tmp_path / "m.txt")
    bt.save_model(path)
    full = lgt.Booster(model_file=path).predict(X)
    assert np.abs(bt.predict(X) - full).max() > 1e-3
    # the call's own arguments win
    np.testing.assert_allclose(bt.predict(X, start_iteration=2,
                                          num_iteration=1),
                               bj.predict(X, start_iteration=2,
                                          num_iteration=1), atol=1e-5)
    # a model loaded with the same parameters
    np.testing.assert_allclose(
        lgt.Booster(params=window, model_file=path).predict(X),
        lgb.Booster(params=window, model_file=path).predict(X), atol=1e-6)


def test_pred_early_stop_is_refused_where_the_reference_acts(dyadic):
    """Prediction early stopping, once refused, now acts where the
    reference acts (its name kept from then): set in the training
    parameters, or later by ``reset_parameter``, the port stops the same
    rows as the JAX package, within 1e-5."""
    X, y, _ = _data()
    p = dict(BASE, pred_early_stop=True, pred_early_stop_margin=0.5,
             pred_early_stop_freq=1)
    bj = lgb.train(dict(p, **ORACLES["xla"]), lgb.Dataset(X, label=y), 6)
    # the reference stops early on rows with a large margin
    assert np.abs(bj.predict(X) - bj.predict(X, pred_early_stop=False)
                  ).max() > 1e-4
    bt = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y), 6)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)
    np.testing.assert_allclose(bt.predict(X, pred_early_stop=False),
                               bj.predict(X, pred_early_stop=False),
                               atol=1e-5)
    bt = lgt.train(dict(BASE, device_type="cpu"), lgt.Dataset(X, y), 6)
    plain = bt.predict(X)
    bt.reset_parameter({"pred_early_stop": True,
                        "pred_early_stop_margin": 0.5,
                        "pred_early_stop_freq": 1})
    assert np.abs(bt.predict(X) - plain).max() > 1e-4
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)


def test_snapshot_freq_is_refused_where_the_reference_acts(tmp_path, dyadic):
    """Model snapshots, once refused, now act where the reference acts
    (the name kept from then): every ``snapshot_freq`` iterations (alias
    ``save_period``) ``{output_model}.snapshot_iter_{i}``, whose text is
    ``model_to_string(num_iteration=i)``, and whose trees are the JAX
    package's snapshot's."""
    X, y, _ = _data(n=500)
    out = str(tmp_path / "m.txt")
    p = dict(BASE, snapshot_freq=1, output_model=out)
    lgb.train(dict(p, **ORACLES["xla"]), lgb.Dataset(X, label=y), 2)
    assert (tmp_path / "m.txt.snapshot_iter_2").exists()
    port = str(tmp_path / "port.txt")
    bst = lgt.train(dict(BASE, save_period=1, output_model=port,
                         device_type="cpu"), lgt.Dataset(X, y), 2)
    for i in (1, 2):
        with open(f"{port}.snapshot_iter_{i}") as fh:
            text = fh.read()
        assert text == bst.model_to_string(num_iteration=i)
        with open(f"{out}.snapshot_iter_{i}") as fh:
            ref = LoadedGBDT(fh.read()).models
        mine = LoadedGBDT(text).models
        assert len(mine) == len(ref) == i
        for a, b in zip(mine, ref):
            np.testing.assert_array_equal(a.split_feature, b.split_feature)
            np.testing.assert_array_equal(a.threshold, b.threshold)
            np.testing.assert_allclose(a.leaf_value, b.leaf_value,
                                       atol=1e-5)
    # output_model alone writes no snapshot
    lgt.train(dict(BASE, output_model=str(tmp_path / "none.txt"),
                   device_type="cpu"), lgt.Dataset(X, y), 1)
    assert not any(f.startswith("none") for f in os.listdir(tmp_path))
