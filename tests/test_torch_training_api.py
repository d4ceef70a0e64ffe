"""The tuned training loop's API in the port on the CPU, held against the
JAX package on the same numpy inputs: early stopping (the callback and
``early_stopping_round``, ``first_metric_only``, ``min_delta``), custom
metrics (``feval``), custom objectives (``update(fobj=...)``, a callable or
``"none"`` objective), continued training (``init_model``,
``input_model``) with the merged model text, ``rollback_one_iter`` and
``reset_parameter`` (the callback and the method). Trees equal split for
split, predictions within 1e-5, metric values within 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.model_io import LoadedGBDT as JaxLoaded
from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
from lightgbm_tpu_torch.model_io import LoadedGBDT, merge_model_texts

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 10,
        "verbosity": -1}
JAX = {"tpu_fused": "off"}
CPU = {"device_type": "cpu"}


def higgs_like(n, f, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] - 0.4 * X[:, 2] + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def onehot(n=1500, groups=40, card=8, dense=4, seed=3):
    rng = np.random.RandomState(seed)
    cats = rng.randint(0, card, size=(n, groups))
    X = np.zeros((n, groups * card), np.float32)
    for g in range(groups):
        X[np.arange(n), g * card + cats[:, g]] = 1.0
    X = np.concatenate([X, rng.randn(n, dense).astype(np.float32)], axis=1)
    y = (X @ (rng.randn(X.shape[1]) * 0.5) + 0.4 * rng.randn(n) > 0
         ).astype(np.float64)
    return X, y


@pytest.fixture
def same_bags(monkeypatch):
    """The port's bags from the JAX package's draws (``PRNGKey(seed)``,
    ``tests/test_torch_sampling.py``)."""
    init = gbdt_mod.GBDT.__init__

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        self.sample_strategy.draws = lambda seed, size: torch.from_numpy(
            np.array(jax.random.uniform(jax.random.PRNGKey(seed), (size,))))
    monkeypatch.setattr(gbdt_mod.GBDT, "__init__", patched)


X, Y = higgs_like(2500, 8)
XV, YV = higgs_like(800, 8, seed=9)


def assert_same_trees(tj, tt):
    assert len(tj) == len(tt)
    for a, b in zip(tj, tt):
        n = a.num_nodes
        assert b.num_nodes == n and b.num_leaves == a.num_leaves
        for name in ("split_feature", "split_bin", "default_left",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:n],
                                          getattr(a, name)[:n], err_msg=name)
        # a small leaf's gradient sum is its parent's minus its sibling's,
        # and f32 cancellation there leaves errors of a few 1e-6 absolute
        np.testing.assert_allclose(b.leaf_value[:n + 1], a.leaf_value[:n + 1],
                                   rtol=0, atol=1e-5)


def both(params, rounds, jax_only=None, **kw):
    """The same ``train`` call in both packages: ``(jax, port)``."""
    out = []
    for mod, extra in ((lgb, dict(JAX, **(jax_only or {}))), (lgt, CPU)):
        ds = mod.Dataset(X, Y, free_raw_data=False) if mod is lgt \
            else mod.Dataset(X, label=Y, free_raw_data=False)
        dv = ds.create_valid(XV, YV) if mod is lgt \
            else ds.create_valid(XV, label=YV)
        out.append(mod.train(dict(params, **extra), ds, rounds,
                             valid_sets=[dv], **kw))
    return out


def assert_same_best(bj, bt):
    assert bt.best_iteration == bj.best_iteration
    assert list(bt.best_score) == list(bj.best_score)
    for name in bj.best_score:
        assert list(bt.best_score[name]) == list(bj.best_score[name])
        for metric, value in bj.best_score[name].items():
            assert bt.best_score[name][metric] == pytest.approx(value,
                                                                abs=1e-6)


# ---- early stopping ---------------------------------------------------------

@pytest.mark.parametrize("grower", ["compact", "masked"])
def test_early_stopping_round_matches_reference(grower):
    p = dict(BASE, metric=["auc", "binary_logloss"], learning_rate=0.6,
             early_stopping_round=3, tpu_grower=grower)
    bj, bt = both(p, 40)
    assert 0 < bt.best_iteration < 40
    assert_same_best(bj, bt)
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    # prediction stops at the best iteration
    np.testing.assert_allclose(bt.predict(XV), bj.predict(XV), atol=1e-5)
    np.testing.assert_allclose(
        bt.predict(XV), bt.predict(XV, num_iteration=bt.best_iteration))


@pytest.mark.parametrize("kw", [
    {"first_metric_only": True},
    {"min_delta": 1e-3},
    {"first_metric_only": True, "min_delta": 5e-4},
])
def test_early_stopping_callback_matches_reference(kw):
    """``binary_error`` first stalls early; with ``first_metric_only`` only
    it decides, else the logloss keeps the run going."""
    p = dict(BASE, metric=["binary_error", "binary_logloss"],
             learning_rate=0.6)
    bj, bt = (mod.train(
        dict(p, **extra), mod.Dataset(X, Y) if mod is lgt
        else mod.Dataset(X, label=Y), 40,
        valid_sets=[mod.Dataset(X, Y).create_valid(XV, YV) if mod is lgt
                    else mod.Dataset(X, label=Y).create_valid(XV, label=YV)],
        callbacks=[mod.early_stopping(4, verbose=False, **kw)])
        for mod, extra in ((lgb, JAX), (lgt, CPU)))
    assert 0 < bt.best_iteration < 40
    assert_same_best(bj, bt)


def test_early_stopping_needs_validation_data():
    with pytest.raises(ValueError, match="greater than zero"):
        lgt.early_stopping(0)
    bst = lgt.train(dict(BASE, early_stopping_round=2, **CPU),
                    lgt.Dataset(X, Y), 4)
    assert bst.best_iteration == -1 and bst.current_iteration() == 4


def test_early_stopping_ignores_the_training_data():
    p = dict(BASE, metric="binary_logloss", learning_rate=0.6,
             early_stopping_round=3)
    for mod, extra in ((lgb, JAX), (lgt, CPU)):
        ds = mod.Dataset(X, Y) if mod is lgt else mod.Dataset(X, label=Y)
        dv = ds.create_valid(XV, YV) if mod is lgt \
            else ds.create_valid(XV, label=YV)
        b = mod.train(dict(p, **extra), ds, 40, valid_sets=[ds, dv],
                      valid_names=["train", "valid"])
        if mod is lgb:
            bj = b
    assert_same_best(bj, b)
    assert list(b.best_score) == ["train", "valid"]


# ---- custom metrics ----------------------------------------------------------

def mean_pred(preds, data):
    return "mean_pred", float(np.mean(preds)), False


def weighted_error(preds, data):
    y = np.asarray(data.get_label())
    w = data.get_weight()
    w = np.ones_like(y) if w is None else np.asarray(w)
    return [("werr", float(np.sum(w * ((preds > 0) != (y > 0))) / w.sum()),
             False),
            ("n", float(len(y)), True)]


@pytest.mark.parametrize("grower", ["compact", "masked"])
def test_feval_matches_reference(grower):
    """Custom metrics on the raw scores in the dataset's order (the compact
    grower's train scores un-permuted), a callable or a list, on the
    training data too."""
    p = dict(BASE, metric="auc", tpu_grower=grower)
    res = {}
    for mod, extra in ((lgb, JAX), (lgt, CPU)):
        ds = mod.Dataset(X, Y) if mod is lgt else mod.Dataset(X, label=Y)
        dv = ds.create_valid(XV, YV) if mod is lgt \
            else ds.create_valid(XV, label=YV)
        evals = {}
        mod.train(dict(p, **extra), ds, 3, valid_sets=[ds, dv],
                  valid_names=["train", "valid"],
                  feval=[mean_pred, weighted_error],
                  callbacks=[mod.record_evaluation(evals)])
        res[mod] = evals
    ej, et = res[lgb], res[lgt]
    assert list(et) == list(ej) == ["train", "valid"]
    for name in ej:
        assert list(et[name]) == list(ej[name]) \
            == ["auc", "mean_pred", "werr", "n"]
        for metric in ej[name]:
            np.testing.assert_allclose(et[name][metric], ej[name][metric],
                                       atol=1e-6)


def test_feval_multiclass_gets_rows_by_classes():
    y3 = np.argmax(X[:, :3], axis=1).astype(np.float64)
    seen = {}

    def probe(preds, data):
        seen["shape"] = preds.shape
        return "zero", 0.0, False
    ds = lgt.Dataset(X, y3)
    bst = lgt.train(dict(BASE, objective="multiclass", num_class=3, **CPU),
                    ds, 2, valid_sets=[ds], feval=probe)
    assert seen["shape"] == (len(X), 3)
    # the training data named in valid_sets takes its name
    assert bst.eval_train(probe)[1:] == [("valid_0", "zero", 0.0, False)]


# ---- custom objectives -------------------------------------------------------

def logloss(preds, data):
    """The binary logloss, by hand."""
    y = np.asarray(data.get_label())
    p = 1.0 / (1.0 + np.exp(-preds))
    return p - y, p * (1.0 - p)


def _fobj_booster(mod, params, fobj_rounds):
    ds = mod.Dataset(X, Y) if mod is lgt else mod.Dataset(X, label=Y)
    b = mod.Booster(params, ds)
    for _ in range(fobj_rounds):
        b.update(fobj=logloss)
    return b


@pytest.mark.parametrize("grower", ["compact", "masked"])
def test_fobj_trees_match_reference(same_bags, grower):
    """Caller-supplied gradients come in the dataset's row order: a run
    that would take the compact grower moves to the masked one before its
    first tree, as the JAX package's does."""
    p = dict(BASE, tpu_grower=grower, bagging_fraction=0.7, bagging_freq=1)
    bj = _fobj_booster(lgb, dict(p, **JAX), 4)
    bt = _fobj_booster(lgt, dict(p, **CPU), 4)
    assert not bt._gbdt.use_compact and not bj._gbdt._use_compact
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)


def test_fobj_equals_the_builtin_objective():
    """A hand-written logloss trains the built-in ``binary`` model without
    boost-from-average (a custom objective never boosts from the
    average)."""
    p = dict(BASE, tpu_grower="masked", **CPU)
    bt = _fobj_booster(lgt, p, 4)
    builtin = lgt.train(dict(p, boost_from_average=False),
                        lgt.Dataset(X, Y), 4)
    assert_same_trees(builtin._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(X), builtin.predict(X), atol=1e-5)


def test_fobj_after_compact_training_raises():
    b = lgt.Booster(dict(BASE, tpu_grower="compact", **CPU),
                    lgt.Dataset(X, Y))
    b.update()
    assert b._gbdt.use_compact
    with pytest.raises(RuntimeError, match="compact training started"):
        b.update(fobj=logloss)


@pytest.mark.parametrize("objective", ["callable", "none"])
def test_custom_objective_parameter(objective):
    """``objective`` a callable (used by every ``update``) or ``"none"``
    (``fobj`` required): no built-in objective, raw scores out, the model
    text's ``objective=custom``."""
    obj = logloss if objective == "callable" else "none"
    out = {}
    for mod, extra in ((lgb, JAX), (lgt, CPU)):
        ds = mod.Dataset(X, Y) if mod is lgt else mod.Dataset(X, label=Y)
        b = mod.Booster(dict(BASE, objective=obj, **extra), ds)
        for _ in range(3):
            if objective == "callable":
                b.update()
            else:
                b.update(fobj=logloss)
        out[mod] = b
    bj, bt = out[lgb], out[lgt]
    assert bt._gbdt.objective is None and not bt._gbdt.use_compact
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)
    np.testing.assert_allclose(bt.predict(X), bt.predict(X, raw_score=True))
    assert "objective=custom" in bt.model_to_string()
    if objective == "none":
        with pytest.raises(ValueError, match="fobj"):
            bt.update()


def test_fobj_gradient_size_is_checked():
    b = lgt.Booster(dict(BASE, tpu_grower="masked", **CPU),
                    lgt.Dataset(X, Y))
    with pytest.raises(ValueError, match="num_class"):
        b.update(fobj=lambda p, d: (p[:10], p[:10]))


# ---- continued training -----------------------------------------------------

def _continued(mod, extra, params, first, second, how):
    ds = mod.Dataset(X, Y, free_raw_data=False) if mod is lgt \
        else mod.Dataset(X, label=Y, free_raw_data=False)
    b1 = mod.train(dict(params, **extra), ds, first)
    ds2 = mod.Dataset(X, Y, free_raw_data=False) if mod is lgt \
        else mod.Dataset(X, label=Y, free_raw_data=False)
    dv = ds2.create_valid(XV, YV) if mod is lgt \
        else ds2.create_valid(XV, label=YV)
    dv.free_raw_data = False
    evals = {}
    kw = {"valid_sets": [dv], "callbacks": [mod.record_evaluation(evals)]}
    if how == "booster":
        b2 = mod.train(dict(params, **extra), ds2, second, init_model=b1,
                       **kw)
    else:
        path = how
        b1.save_model(path)
        b2 = mod.train(dict(params, input_model=path, **extra), ds2, second,
                       **kw)
    return b1, b2, evals


def _trees(text):
    return [c for c in text.split("Tree=")[1:]]


@pytest.mark.parametrize("grower,how", [("compact", "booster"),
                                        ("masked", "booster"),
                                        ("compact", "input_model")])
def test_continued_training_matches_reference(grower, how, tmp_path):
    p = dict(BASE, tpu_grower=grower, metric="binary_logloss")
    path = str(tmp_path / "first.txt")
    _, bj, ej = _continued(lgb, JAX, p, 3, 2,
                           "booster" if how == "booster" else path + ".j")
    b1, bt, et = _continued(lgt, CPU, p, 3, 2,
                            "booster" if how == "booster" else path)
    assert bt._gbdt.use_compact == bj._gbdt._use_compact \
        == (grower == "compact")
    # no boost-from-average: the loaded model's scores seed the run
    assert bt._gbdt._init_scores == [0.0]
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    assert bt.num_trees() == bj.num_trees() == 5
    assert bt.current_iteration() == bj.current_iteration() == 5
    np.testing.assert_allclose(bt.predict(XV), bj.predict(XV), atol=1e-5)
    np.testing.assert_allclose(et["valid_0"]["binary_logloss"],
                               ej["valid_0"]["binary_logloss"], atol=1e-6)
    # the continued valid scores are the 5-tree model's
    np.testing.assert_allclose(
        bt._gbdt.valid_sets[0].score.numpy()[0],
        bt.predict(XV, raw_score=True), atol=1e-5)
    # the merged text: the first model's trees, then the new ones
    tt, tj = bt.model_to_string(), bj.model_to_string()
    lt, lj = LoadedGBDT(tt), JaxLoaded(tj)
    assert len(lt.models) == len(lj.models) == 5
    for a, b in zip(lj.models, lt.models):
        for name in ("split_feature", "left_child", "right_child",
                     "decision_type"):
            np.testing.assert_array_equal(getattr(b, name),
                                          getattr(a, name))
        np.testing.assert_allclose(b.threshold, a.threshold, rtol=1e-6)
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, atol=1e-5)
    first = _trees(b1.model_to_string().split("end of trees")[0])
    merged = _trees(tt.split("end of trees")[0])
    for i in range(3):
        assert merged[i].split("\n", 1)[1] == first[i].split("\n", 1)[1]
    # stock LightGBM finds tree i at the sum of the first i tree_sizes
    header = tt.split("Tree=0")[0]
    sizes = [int(v) for v in
             header.split("tree_sizes=")[1].split("\n")[0].split()]
    assert len(sizes) == 5
    at = len(header)
    for i, size in enumerate(sizes):
        assert tt[at:].startswith(f"Tree={i}\n")
        at += size
    assert tt[at - 1:].startswith("end of trees")
    # it reloads in the port and in the JAX package
    np.testing.assert_allclose(lgt.Booster(model_str=tt).predict(XV),
                               bt.predict(XV), atol=1e-6)
    np.testing.assert_allclose(lgb.Booster(model_str=tt).predict(XV),
                               bt.predict(XV), atol=1e-6)
    np.testing.assert_allclose(bt.feature_importance(),
                               bj.feature_importance())


def test_continued_prediction_windows():
    p = dict(BASE, tpu_grower="masked")
    b1, b2, _ = _continued(lgt, CPU, p, 3, 2, "booster")
    full = b2.predict(XV, raw_score=True)
    np.testing.assert_allclose(b2.predict(XV, raw_score=True,
                                          num_iteration=3),
                               b1.predict(XV, raw_score=True), atol=1e-6)
    np.testing.assert_allclose(
        b2.predict(XV, raw_score=True, num_iteration=1, start_iteration=3)
        + b2.predict(XV, raw_score=True, num_iteration=1, start_iteration=4)
        + b1.predict(XV, raw_score=True), full, atol=1e-5)
    # a cut text keeps the leading iterations
    cut = lgt.Booster(model_str=b2.model_to_string(num_iteration=4))
    assert cut.num_trees() == 4
    np.testing.assert_allclose(cut.predict(XV, raw_score=True),
                               b2.predict(XV, raw_score=True,
                                          num_iteration=4), atol=1e-6)
    # dump_model of a continued booster: the JAX package's (its
    # lightgbm_tpu/basic.py:1328-1331) dump of the merged text
    from lightgbm_tpu.model_io import loaded_dump as jax_loaded_dump
    assert b2.dump_model() == jax_loaded_dump(JaxLoaded(
        b2.model_to_string()))
    assert b2.dump_model(num_iteration=4) == jax_loaded_dump(JaxLoaded(
        b2.model_to_string(num_iteration=4)))


def test_continued_training_needs_raw_data():
    b1 = lgt.train(dict(BASE, **CPU), lgt.Dataset(X, Y), 2)
    ds = lgt.Dataset(X, Y, params=CPU)
    ds.construct()
    with pytest.raises(ValueError, match="free_raw_data"):
        lgt.train(dict(BASE, **CPU), ds, 1, init_model=b1)


def test_merge_model_texts_matches_reference():
    """The port's merge of two texts equals the JAX package's."""
    b1 = lgt.train(dict(BASE, **CPU), lgt.Dataset(X, Y), 2)
    b2 = lgt.train(dict(BASE, num_leaves=5, **CPU), lgt.Dataset(X, Y), 3)
    from lightgbm_tpu.model_io import merge_model_texts as jax_merge
    for cut in (None, 1):
        assert merge_model_texts(b1.model_to_string(), b2.model_to_string(),
                                 pre_num_iteration=cut) \
            == jax_merge(b1.model_to_string(), b2.model_to_string(),
                         pre_num_iteration=cut)


# ---- rollback and reset_parameter --------------------------------------------

@pytest.mark.parametrize("case", ["compact", "masked", "efb", "multiclass"])
def test_rollback_matches_reference(case):
    """After 3 rounds and a rollback the validation scores are the 2-round
    model's predictions; the next tree equals the JAX package's."""
    Xd, yd = (onehot() if case == "efb" else (X, Y))
    p = dict(BASE, tpu_grower="masked" if case == "masked" else "compact")
    if case == "efb":
        # the grower of tests/test_torch_sampling.py's bundled case, so
        # that the JAX package compiles its program once for both
        p["num_leaves"] = 15
    if case == "multiclass":
        yd = np.argmax(X[:, :3], axis=1).astype(np.float64)
        p.update(objective="multiclass", num_class=3)
    Xva, yva = Xd[:500], yd[:500]
    out = {}
    for mod, extra in ((lgb, JAX), (lgt, CPU)):
        ds = mod.Dataset(Xd, yd) if mod is lgt else mod.Dataset(Xd, label=yd)
        b = mod.Booster(dict(p, **extra), ds)
        b.add_valid(ds.create_valid(Xva, yva) if mod is lgt
                    else ds.create_valid(Xva, label=yva), "v")
        for _ in range(3):
            b.update()
        b.rollback_one_iter()
        assert b.current_iteration() == 2
        out[mod] = b
    bj, bt = out[lgb], out[lgt]
    if case == "efb":
        assert bt._gbdt._efb is not None
    score = bt._gbdt.valid_sets[0].score.numpy()
    raw = bt.predict(Xva, raw_score=True)
    np.testing.assert_allclose(score, raw.T if raw.ndim == 2 else raw[None],
                               atol=1e-5)
    raw = bt.predict(Xd, raw_score=True)
    np.testing.assert_allclose(bt._gbdt.train_score_original_order(),
                               raw.T if raw.ndim == 2 else raw[None],
                               atol=1e-5)
    for b in (bj, bt):
        b.update()
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(Xd), bj.predict(Xd), atol=1e-5)


def test_rollback_of_nothing_is_a_no_op():
    b = lgt.Booster(dict(BASE, **CPU), lgt.Dataset(X, Y))
    b.rollback_one_iter()
    assert b.current_iteration() == 0 and b.num_trees() == 0


@pytest.mark.parametrize("grower", ["compact", "masked"])
def test_reset_parameter_callback_matches_reference(grower):
    p = dict(BASE, tpu_grower=grower, feature_fraction=0.7)
    cb = {"learning_rate": lambda i: 0.1 * 0.8 ** i,
          "num_leaves": [7, 5, 9, 4],
          "min_data_in_leaf": [10, 30, 5, 20],
          "lambda_l2": lambda i: float(i),
          "feature_fraction": [0.7, 0.5, 1.0, 0.9]}
    bj, bt = (mod.train(dict(p, **extra),
                        mod.Dataset(X, Y) if mod is lgt
                        else mod.Dataset(X, label=Y), 4,
                        callbacks=[mod.reset_parameter(**cb)])
              for mod, extra in ((lgb, JAX), (lgt, CPU)))
    assert [m.num_leaves for m in bt._gbdt.models] \
        == [m.num_leaves for m in bj._gbdt.models]
    assert max(m.num_leaves for m in bt._gbdt.models) == 9
    assert [m.shrinkage for m in bt._gbdt.models] == pytest.approx(
        [0.1 * 0.8 ** i for i in range(4)])
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)


def test_reset_parameter_method():
    out = {}
    for mod, extra in ((lgb, JAX), (lgt, CPU)):
        ds = mod.Dataset(X, Y) if mod is lgt else mod.Dataset(X, label=Y)
        b = mod.Booster(dict(BASE, tpu_grower="compact", **extra), ds)
        b.update()
        b.reset_parameter({"num_leaves": 12, "eta": 0.05,
                           "max_depth": 3})
        b.update()
        out[mod] = b
    bj, bt = out[lgb], out[lgt]
    assert bt.params["num_leaves"] == 12
    assert bt._gbdt.models[1].shrinkage == pytest.approx(0.05)
    assert bt._gbdt.models[1].max_depth <= 3
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    # linear_tree is read when training starts: as in the reference, a
    # reset records it and the next trees keep constant leaves
    for b in (bj, bt):
        b.reset_parameter({"linear_tree": True})
        b.update()
    assert bt.params["linear_tree"] is True
    assert not any(m.is_linear for m in bt._gbdt.models)
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)


def test_reset_parameter_callback_checks_lists():
    with pytest.raises(ValueError, match="num_boost_round"):
        lgt.train(dict(BASE, **CPU), lgt.Dataset(X, Y), 3,
                  callbacks=[lgt.reset_parameter(learning_rate=[0.1])])
    with pytest.raises(ValueError, match="list and callable"):
        lgt.train(dict(BASE, **CPU), lgt.Dataset(X, Y), 3,
                  callbacks=[lgt.reset_parameter(learning_rate=0.1)])


def test_the_tuned_script_runs():
    """The loop a tuned LightGBM script writes, end to end on the CPU:
    sampling, early stopping, a schedule, a custom metric, continued
    training and a rollback."""
    params = {"objective": "binary", "metric": "auc", "num_leaves": 15,
              "feature_fraction": 0.8, "bagging_fraction": 0.8,
              "bagging_freq": 5, "feature_fraction_bynode": 0.8,
              "early_stopping_round": 5, "verbosity": -1, **CPU}
    ds = lgt.Dataset(X, Y, free_raw_data=False)
    dv = ds.create_valid(XV, YV)
    dv.free_raw_data = False
    bst = lgt.train(params, ds, 60, valid_sets=[dv], feval=mean_pred,
                    callbacks=[lgt.reset_parameter(
                        learning_rate=lambda i: 0.3 * 0.99 ** i)])
    assert 0 < bst.best_iteration <= 60
    assert set(bst.best_score["valid_0"]) == {"auc", "mean_pred"}
    assert bst.best_score["valid_0"]["auc"] > 0.9
    bst2 = lgt.train(dict(params, early_stopping_round=0), ds, 3,
                     init_model=bst)
    assert bst2.num_trees() == bst.best_iteration + 3
    n = bst.current_iteration()
    bst.rollback_one_iter()
    assert bst.current_iteration() == n - 1
    pred = bst.predict(XV)
    assert pred.shape == (len(XV),) and np.isfinite(pred).all()
