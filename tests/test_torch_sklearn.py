"""The scikit-learn estimators of the port on the CPU, held against the
JAX package's on the same numpy inputs: the regressor, the binary and
multiclass classifier, string labels, ``class_weight="balanced"``, the
ranker with ``group``, ``eval_set`` with early stopping, a callable
``eval_metric``, and ``get_params``/``set_params``. Predictions and
``predict_proba`` within 1e-6; ``best_iteration_``, ``evals_result_``
(within 1e-6), ``feature_importances_`` and ``classes_`` equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import objectives as jobj
from lightgbm_tpu_torch import objectives as tobj

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

KW = {"n_estimators": 3, "num_leaves": 7, "min_child_samples": 10,
      "verbosity": -1}
JAX = {"tpu_fused": "off"}
CPU = {"device_type": "cpu"}

_rng = np.random.RandomState(7)
X = _rng.randn(2000, 8).astype(np.float32)
LOGIT = X[:, 0] - 0.4 * X[:, 2] + 0.3 * X[:, 3] + 0.3 * _rng.randn(2000)
Y = (LOGIT > 0).astype(np.float64)
Y3 = np.digitize(LOGIT, [-0.5, 0.5])
W = _rng.uniform(0.5, 1.5, 2000)
XV = X[:400] + 0.1


@pytest.fixture(autouse=True)
def dyadic(monkeypatch):
    """Binary gradients and hessians on a 1/64 grid in both packages: the
    leaf values are exact in f32, so no near tie parts the trees."""
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


def l1_raw(y_true, y_pred):
    return "l1_raw", float(np.mean(np.abs(y_true - y_pred))), False


# case -> (estimator class name, constructor arguments, fit arguments)
CASES = {
    "regressor": ("LGBMRegressor", {}, {"y": LOGIT}),
    "binary": ("LGBMClassifier", {}, {"y": Y}),
    "multiclass": ("LGBMClassifier", {}, {"y": Y3, "sample_weight": W}),
    "string_labels": ("LGBMClassifier", {},
                      {"y": np.array(["no", "yes"])[Y.astype(int)]}),
    "balanced": ("LGBMClassifier", {"class_weight": "balanced"},
                 {"y": np.where(LOGIT > 0.8, "hi", "lo")}),
    "ranker": ("LGBMRanker", {},
               {"y": np.clip(np.round(LOGIT + 1.5), 0, 3),
                "group": np.full(100, 20)}),
    "eval_set_early_stopping": (
        "LGBMRegressor", {"n_estimators": 12, "learning_rate": 0.9,
                          "num_leaves": 31, "early_stopping_rounds": 2},
        {"y": LOGIT, "eval_set": [(XV, LOGIT[:400])],
         "eval_metric": ["l2", "l1"]}),
    "callable_eval_metric": (
        "LGBMRegressor", {},
        {"y": LOGIT, "eval_set": [(XV, LOGIT[:400]), (X, LOGIT)],
         "eval_names": ["shifted", "train"], "eval_metric": l1_raw}),
}


def fit_both(case):
    name, ctor, fit = CASES[case]
    out = []
    for mod, extra in ((lgb, JAX), (lgt, CPU)):
        est = getattr(mod, name)(**dict(KW, **ctor, **extra))
        kw = dict(fit)
        out.append(est.fit(X, kw.pop("y"), **kw))
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_estimator_matches_jax(case):
    ej, et = fit_both(case)
    if isinstance(et, lgt.LGBMClassifier):
        np.testing.assert_array_equal(et.predict(XV), ej.predict(XV))
        np.testing.assert_array_equal(et.classes_, ej.classes_)
        assert et.n_classes_ == ej.n_classes_
        proba = et.predict_proba(XV)
        assert proba.shape == (len(XV), et.n_classes_)
        np.testing.assert_allclose(proba, ej.predict_proba(XV), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(et.predict(XV, raw_score=True),
                                   ej.predict(XV, raw_score=True), rtol=0,
                                   atol=1e-6)
    else:
        np.testing.assert_allclose(et.predict(XV), ej.predict(XV), rtol=0,
                                   atol=1e-6)
    assert et.best_iteration_ == ej.best_iteration_
    np.testing.assert_array_equal(et.feature_importances_,
                                  ej.feature_importances_)
    assert et.n_features_in_ == ej.n_features_in_ == 8
    assert et.feature_name_ == ej.feature_name_
    assert list(et.evals_result_) == list(ej.evals_result_)
    for data, metrics in ej.evals_result_.items():
        assert list(et.evals_result_[data]) == list(metrics)
        for metric, values in metrics.items():
            np.testing.assert_allclose(et.evals_result_[data][metric],
                                       values, rtol=0, atol=1e-6)
    assert isinstance(et.booster_, lgt.Booster)
    if case == "eval_set_early_stopping":
        assert 0 < et.best_iteration_ < 12
    if case == "callable_eval_metric":
        assert list(et.evals_result_["shifted"]) == ["l2", "l1_raw"]


def test_get_params_and_set_params():
    """The same parameters and LightGBM parameter mapping as the JAX
    package's estimators, after ``set_params`` of a constructor argument
    and of another parameter; no fit is needed."""
    ests = [mod.LGBMClassifier(num_leaves=15, subsample=0.8,
                               colsample_bytree=0.7, reg_lambda=1.0,
                               random_state=3, extra_trees=True)
            for mod in (lgb, lgt)]
    for est in ests:
        est.set_params(learning_rate=0.05, max_bin=63)
    assert ests[1].get_params() == ests[0].get_params()
    assert ests[1]._lgb_params() == ests[0]._lgb_params()
    params = ests[1]._lgb_params()
    assert params["bagging_fraction"] == 0.8 and params["seed"] == 3
    assert params["objective"] == "binary" and params["max_bin"] == 63
    with pytest.raises(ValueError, match="group"):
        lgt.LGBMRanker(**CPU).fit(X, Y)
    with pytest.raises(AttributeError):
        lgt.LGBMRegressor().booster_
