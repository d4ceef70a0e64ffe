"""The scikit-learn estimators: ``LGBMModel``, ``LGBMRegressor``,
``LGBMClassifier`` and ``LGBMRanker``.

Copy of ``lightgbm_tpu/sklearn.py`` for the port (reference:
python-package/lightgbm/sklearn.py — LGBMModel :486, LGBMRegressor :1314,
LGBMClassifier :1424, LGBMRanker :1678). The constructor's arguments map to
LightGBM's parameters (``_lgb_params``); any other keyword argument is a
parameter as it is, ``device_type="cpu"`` included (the default is the
card). ``fit`` takes ``eval_set`` with its weights, groups and init scores,
``class_weight`` (a dict, or ``"balanced"``: n / (classes x count), used
where no ``sample_weight`` is given), and ``eval_metric`` as metric names
or a callable ``f(y_true, y_pred) -> (name, value, is_higher_better)`` on
raw scores. The classifier encodes any labels (strings too) as their
sorted unique values' indices. scikit-learn is not imported: the
estimators follow its conventions (``get_params``/``set_params``, fitted
attributes ending in ``_``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .engine import train as train_fn

_CONSTRUCTOR_ARGS = (
    "boosting_type", "num_leaves", "max_depth", "learning_rate",
    "n_estimators", "subsample_for_bin", "objective", "class_weight",
    "min_split_gain", "min_child_weight", "min_child_samples", "subsample",
    "subsample_freq", "colsample_bytree", "reg_alpha", "reg_lambda",
    "random_state", "n_jobs", "importance_type")

# constructor argument -> (LightGBM parameter, default)
_PARAM_NAMES = {
    "boosting_type": ("boosting", "gbdt"),
    "subsample": ("bagging_fraction", 1.0),
    "subsample_freq": ("bagging_freq", 0),
    "colsample_bytree": ("feature_fraction", 1.0),
    "reg_alpha": ("lambda_l1", 0.0),
    "reg_lambda": ("lambda_l2", 0.0),
    "min_split_gain": ("min_gain_to_split", 0.0),
    "min_child_weight": ("min_sum_hessian_in_leaf", 1e-3),
    "min_child_samples": ("min_data_in_leaf", 20),
    "subsample_for_bin": ("bin_construct_sample_cnt", 200000),
}


class LGBMModel:
    """(reference: sklearn.py:486, ``lightgbm_tpu/sklearn.py:21-209``)"""

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[Union[str, Callable]] = None,
                 class_weight=None, min_split_gain: float = 0.0,
                 min_child_weight: float = 1e-3, min_child_samples: int = 20,
                 subsample: float = 1.0, subsample_freq: int = 0,
                 colsample_bytree: float = 1.0, reg_alpha: float = 0.0,
                 reg_lambda: float = 0.0, random_state=None,
                 n_jobs: Optional[int] = None,
                 importance_type: str = "split", **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self._other_params: Dict[str, Any] = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._n_features: Optional[int] = None
        self._classes = None
        self._n_classes: Optional[int] = None
        self._evals_result: Dict = {}
        self._best_iteration: int = -1

    # -- scikit-learn's parameter protocol ----------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {k: getattr(self, k) for k in _CONSTRUCTOR_ARGS}
        params.update(self._other_params)
        return params

    def set_params(self, **params) -> "LGBMModel":
        for key, value in params.items():
            if key in _CONSTRUCTOR_ARGS:
                setattr(self, key, value)
            else:
                self._other_params[key] = value
        return self

    def _default_objective(self) -> str:
        return "regression"

    def _lgb_params(self) -> Dict[str, Any]:
        """The estimator's arguments as LightGBM parameters."""
        params = self.get_params()
        for key in ("n_estimators", "importance_type", "class_weight",
                    "n_jobs"):
            params.pop(key, None)
        objective = params.pop("objective", None)
        for arg, (name, default) in _PARAM_NAMES.items():
            params[name] = params.pop(arg, default)
        seed = params.pop("random_state", None)
        if seed is not None:
            params["seed"] = seed if isinstance(seed, int) else 0
        params["objective"] = (objective if objective is not None
                               else self._default_objective())
        return params

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            feature_name="auto", categorical_feature="auto",
            callbacks=None, init_model=None) -> "LGBMModel":
        params = self._lgb_params()
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric
        if self.class_weight is not None and sample_weight is None:
            sample_weight = _class_weight_to_sample_weight(self.class_weight,
                                                           y)
        train_set = Dataset(X, label=y, weight=sample_weight,
                            init_score=init_score, group=group,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature,
                            params=params, free_raw_data=False)
        valid_sets, valid_names = [], []
        if isinstance(eval_set, tuple):
            eval_set = [eval_set]
        for i, (vx, vy) in enumerate(eval_set or []):
            if vx is X and vy is y:
                valid_sets.append(train_set)
            else:
                def nth(seq):
                    return seq[i] if seq else None
                valid_sets.append(train_set.create_valid(
                    vx, label=vy, weight=nth(eval_sample_weight),
                    group=nth(eval_group), init_score=nth(eval_init_score)))
            valid_names.append(eval_names[i] if eval_names
                               else f"valid_{i}")
        self._evals_result = {}
        cbs = list(callbacks or [])
        cbs.append(callback_mod.record_evaluation(self._evals_result))
        self._Booster = train_fn(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None, valid_names=valid_names or None,
            feval=(_wrap_sklearn_feval(eval_metric) if callable(eval_metric)
                   else None),
            init_model=init_model, callbacks=cbs)
        self._best_iteration = self._Booster.best_iteration
        self._n_features = train_set.num_feature()
        return self

    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs):
        if self._Booster is None:
            raise ValueError("Estimator not fitted, call fit first")
        return self._Booster.predict(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, pred_leaf=pred_leaf,
            pred_contrib=pred_contrib, **kwargs)

    # -- fitted attributes (reference: sklearn.py properties) ---------------
    @property
    def booster_(self) -> Booster:
        if self._Booster is None:
            raise AttributeError("No booster found; call fit first")
        return self._Booster

    @property
    def best_iteration_(self) -> int:
        return self._best_iteration

    @property
    def evals_result_(self) -> Dict:
        return self._evals_result

    @property
    def n_features_(self) -> Optional[int]:
        return self._n_features

    @property
    def n_features_in_(self) -> Optional[int]:
        return self._n_features

    @property
    def feature_importances_(self) -> np.ndarray:
        return self.booster_.feature_importance(self.importance_type)

    @property
    def feature_name_(self) -> List[str]:
        return self.booster_.feature_name()


class LGBMRegressor(LGBMModel):
    """(reference: sklearn.py:1314)"""

    def _default_objective(self) -> str:
        return "regression"


class LGBMClassifier(LGBMModel):
    """(reference: sklearn.py:1424): binary, or multiclass (``num_class``
    set from the labels) for more than two classes."""

    def _default_objective(self) -> str:
        return "binary"

    def fit(self, X, y, **kwargs) -> "LGBMClassifier":
        y = np.asarray(y)
        self._classes = np.unique(y)
        self._n_classes = len(self._classes)
        if self._n_classes > 2:
            self._other_params.setdefault("num_class", self._n_classes)
            if self.objective is None:
                self.objective = "multiclass"
        super().fit(X, np.searchsorted(self._classes, y), **kwargs)
        return self

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self) -> Optional[int]:
        return self._n_classes

    def predict_proba(self, X, raw_score: bool = False,
                      num_iteration: Optional[int] = None, **kwargs):
        """``[N, classes]`` probabilities (raw scores with ``raw_score``)."""
        result = super().predict(X, raw_score=raw_score,
                                 num_iteration=num_iteration, **kwargs)
        if raw_score or result.ndim > 1:
            return result
        return np.stack([1.0 - result, result], axis=1)

    def predict(self, X, raw_score: bool = False, num_iteration=None,
                pred_leaf: bool = False, pred_contrib: bool = False,
                **kwargs):
        """The most probable class label (raw scores, leaves or
        contributions where asked)."""
        if raw_score or pred_leaf or pred_contrib:
            return super().predict(X, raw_score=raw_score,
                                   num_iteration=num_iteration,
                                   pred_leaf=pred_leaf,
                                   pred_contrib=pred_contrib, **kwargs)
        proba = self.predict_proba(X, num_iteration=num_iteration, **kwargs)
        return self._classes[np.argmax(proba, axis=1)]


class LGBMRanker(LGBMModel):
    """(reference: sklearn.py:1678): lambdarank; ``fit`` needs ``group``
    (query sizes in row order)."""

    def _default_objective(self) -> str:
        return "lambdarank"

    def fit(self, X, y, group=None, **kwargs) -> "LGBMRanker":
        if group is None:
            raise ValueError("Should set group for ranking task")
        return super().fit(X, y, group=group, **kwargs)


def _class_weight_to_sample_weight(class_weight, y) -> np.ndarray:
    """Each row's class weight: a dict's, or ``"balanced"``'s n / (number
    of classes x the class's count); 1 for a class a dict leaves out."""
    y = np.asarray(y)
    if class_weight == "balanced":
        classes, counts = np.unique(y, return_counts=True)
        weights = {c: len(y) / (len(classes) * cnt)
                   for c, cnt in zip(classes, counts)}
    elif isinstance(class_weight, dict):
        weights = class_weight
    else:
        raise ValueError(f"Unsupported class_weight: {class_weight!r}")
    return np.array([weights.get(v, 1.0) for v in y], dtype=np.float64)


def _wrap_sklearn_feval(feval: Callable) -> Callable:
    """``f(y_true, y_pred) -> (name, value, is_higher_better)`` as a
    ``feval`` of ``train`` (reference: _EvalFunctionWrapper,
    sklearn.py:238)."""

    def _inner(preds, dataset):
        return feval(np.asarray(dataset.get_label()), preds)

    return _inner
