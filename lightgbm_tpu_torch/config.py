"""Parameter schema for lightgbm_tpu_torch.

Counterpart of ``lightgbm_tpu/config.py``: one ``PARAMS`` table (name ->
(default, type, aliases)) from which the alias table and defaults derive,
and a ``Config`` object with the same alias resolution and consistency
checks (reference: include/LightGBM/config.h:39, src/io/config.cpp:286).

Two things differ from the JAX package:

* ``device_type`` (alias ``device``) defaults to ``"cuda"`` (``"gpu"`` is
  an alias) and accepts ``"cpu"``; any other value raises. The device is
  explicit: asking for ``"cuda"`` where no card is present raises at
  dataset construction or training (see :func:`resolve_device`).
* Parameters outside what the port implements raise ``NotImplementedError``
  naming the ROADMAP item that will bring them (:meth:`Config.check_supported`)
  instead of being ignored.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Tuple

from .utils import log

PARAMS: Dict[str, Tuple[Any, type, Tuple[str, ...]]] = {
    # core
    "objective": ("regression", str, ("objective_type", "app", "application", "loss")),
    "boosting": ("gbdt", str, ("boosting_type", "boost")),
    "data_sample_strategy": ("bagging", str, ()),
    "num_iterations": (100, int, (
        "num_iteration", "n_iter", "num_tree", "num_trees", "num_round", "num_rounds",
        "nrounds", "num_boost_round", "n_estimators", "max_iter")),
    "learning_rate": (0.1, float, ("shrinkage_rate", "eta")),
    "num_leaves": (31, int, ("num_leaf", "max_leaves", "max_leaf", "max_leaf_nodes")),
    "tree_learner": ("serial", str, ("tree", "tree_type", "tree_learner_type")),
    "num_machines": (1, int, ("num_machine",)),
    "input_model": ("", str, ("model_input", "model_in")),
    "num_threads": (0, int, ("num_thread", "nthread", "nthreads", "n_jobs")),
    "device_type": ("cuda", str, ("device",)),
    "seed": (None, int, ("random_seed", "random_state")),
    "deterministic": (False, bool, ()),
    # learning control
    "max_depth": (-1, int, ()),
    "min_data_in_leaf": (20, int, (
        "min_data_per_leaf", "min_data", "min_child_samples", "min_samples_leaf")),
    "min_sum_hessian_in_leaf": (1e-3, float, (
        "min_sum_hessian_per_leaf", "min_sum_hessian", "min_hessian", "min_child_weight")),
    "bagging_fraction": (1.0, float, ("sub_row", "subsample", "bagging")),
    "pos_bagging_fraction": (1.0, float, ("pos_sub_row", "pos_subsample", "pos_bagging")),
    "neg_bagging_fraction": (1.0, float, ("neg_sub_row", "neg_subsample", "neg_bagging")),
    "bagging_freq": (0, int, ("subsample_freq",)),
    "bagging_seed": (3, int, ("bagging_fraction_seed",)),
    "bagging_by_query": (False, bool, ()),
    "feature_fraction": (1.0, float, ("sub_feature", "colsample_bytree")),
    "feature_fraction_bynode": (1.0, float, ("sub_feature_bynode", "colsample_bynode")),
    "feature_fraction_seed": (2, int, ()),
    "extra_trees": (False, bool, ("extra_tree",)),
    "extra_seed": (6, int, ()),
    "early_stopping_round": (0, int, (
        "early_stopping_rounds", "early_stopping", "n_iter_no_change")),
    "first_metric_only": (False, bool, ()),
    "max_delta_step": (0.0, float, ("max_tree_output", "max_leaf_output")),
    "lambda_l1": (0.0, float, ("reg_alpha", "l1_regularization")),
    "lambda_l2": (0.0, float, ("reg_lambda", "lambda", "l2_regularization")),
    "min_gain_to_split": (0.0, float, ("min_split_gain",)),
    # constraints / cost-effective boosting / forced splits
    "monotone_constraints": (None, object, ("mc", "monotone_constraint")),
    "interaction_constraints": (None, object, ()),
    "forcedsplits_filename": ("", str, ("fs", "forced_splits_filename", "forced_splits_file", "forced_splits")),
    "cegb_penalty_split": (0.0, float, ()),
    "cegb_penalty_feature_lazy": (None, object, ()),
    "cegb_penalty_feature_coupled": (None, object, ()),
    "path_smooth": (0.0, float, ()),
    "feature_contri": (None, object, ("feature_contrib", "fc", "fp", "feature_penalty")),
    "verbosity": (1, int, ("verbose",)),
    "use_quantized_grad": (False, bool, ()),
    # dataset
    "linear_tree": (False, bool, ("linear_trees",)),
    "max_bin": (255, int, ("max_bins",)),
    "max_bin_by_feature": (None, object, ()),
    "min_data_in_bin": (3, int, ()),
    "bin_construct_sample_cnt": (200000, int, ("subsample_for_bin",)),
    "data_random_seed": (1, int, ("data_seed",)),
    # the port stores the dense bin matrix; EFB bundling is ROADMAP A13
    "enable_bundle": (False, bool, ("is_enable_bundle", "bundle")),
    "use_missing": (True, bool, ()),
    "zero_as_missing": (False, bool, ()),
    "categorical_feature": ("", object, ("cat_feature", "categorical_column", "cat_column", "categorical_features")),
    "forcedbins_filename": ("", str, ()),
    # objective
    "num_class": (1, int, ("num_classes",)),
    "is_unbalance": (False, bool, ("unbalance", "unbalanced_sets")),
    "scale_pos_weight": (1.0, float, ()),
    "sigmoid": (1.0, float, ()),
    "boost_from_average": (True, bool, ()),
    # metric
    "metric": (None, object, ("metrics", "metric_types")),
    "metric_freq": (1, int, ("output_freq",)),
    # grower selection knobs shared with the JAX package
    "tpu_grower": ("auto", str, ()),            # auto | compact (masked: A11)
    "tpu_hist_layout": ("auto", str, ("hist_layout",)),  # auto | lane
    "tpu_bin_pack4": (False, bool, ("bin_pack4",)),
}

OBJECTIVE_ALIASES: Dict[str, str] = {
    "regression": "regression", "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "mean_absolute_percentage_error": "mape", "gamma": "gamma",
    "tweedie": "tweedie", "binary": "binary", "multiclass": "multiclass",
    "softmax": "multiclass", "multiclassova": "multiclassova",
    "multiclass_ova": "multiclassova", "ova": "multiclassova", "ovr": "multiclassova",
    "xentropy": "xentropy", "cross_entropy": "xentropy", "xentlambda": "xentlambda",
    "cross_entropy_lambda": "xentlambda", "lambdarank": "lambdarank",
    "rank_xendcg": "rank_xendcg", "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg",
    "xe_ndcg_mart": "rank_xendcg", "xendcg_mart": "rank_xendcg",
}

METRIC_ALIASES: Dict[str, str] = {
    "auc": "auc",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "none": "none", "na": "none", "null": "none", "custom": "none",
}

DEVICE_ALIASES: Dict[str, str] = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}

_ALIAS_TABLE: Dict[str, str] = {}
for _name, (_d, _t, _aliases) in PARAMS.items():
    _ALIAS_TABLE[_name] = _name
    for _a in _aliases:
        _ALIAS_TABLE[_a] = _name


def alias_table() -> Dict[str, str]:
    return dict(_ALIAS_TABLE)


def _coerce(name: str, value: Any, typ: type) -> Any:
    if value is None:
        return None
    if typ is bool:
        if isinstance(value, str):
            return value.lower() in ("true", "1", "+", "yes")
        return bool(value)
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    if typ is str:
        return str(value)
    return value


class Config:
    """Resolved parameter set (reference: struct Config, config.h:39)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None):
        for name, (default, _typ, _aliases) in PARAMS.items():
            setattr(self, name, copy.copy(default))
        if params:
            self.set(params)

    def set(self, params: Dict[str, Any]) -> None:
        # canonical names win over aliases (reference: Config::KeepFirstValues)
        resolved: Dict[str, Any] = {}
        for key, value in params.items():
            canon = _ALIAS_TABLE.get(key)
            if canon is None:
                log.warning(f"Unknown parameter: {key}")
                continue
            if canon in resolved and key != canon:
                continue
            resolved[canon] = value
        for key, value in resolved.items():
            try:
                setattr(self, key, _coerce(key, value, PARAMS[key][1]))
            except (TypeError, ValueError) as e:
                log.fatal(f"Bad value {value!r} for parameter {key}: {e}")
        self._check_consistency()

    def get(self, name: str, default: Any = None) -> Any:
        value = getattr(self, name, None)
        return default if value is None else value

    def _check_consistency(self) -> None:
        obj = self.objective
        if isinstance(obj, str):
            if obj.lower() not in OBJECTIVE_ALIASES:
                log.fatal(f"Unknown objective: {obj!r}")
            self.objective = OBJECTIVE_ALIASES[obj.lower()]
        if self.boosting == "goss":
            self.boosting = "gbdt"
            self.data_sample_strategy = "goss"
        if self.boosting == "gbrt":
            self.boosting = "gbdt"
        if self.boosting == "random_forest":
            self.boosting = "rf"
        if self.boosting not in ("gbdt", "dart", "rf"):
            log.fatal(f"Unknown boosting type: {self.boosting}")
        dev = str(self.device_type).lower()
        if dev not in DEVICE_ALIASES:
            raise ValueError(
                f"device_type={self.device_type!r}: the port runs on 'cuda' "
                "(alias 'gpu') or 'cpu'")
        self.device_type = DEVICE_ALIASES[dev]
        if self.bagging_freq > 0 and not 0.0 < self.bagging_fraction < 1.0:
            self.bagging_freq = 0
        if self.num_leaves < 2:
            self.num_leaves = 2
        if self.max_bin < 2:
            log.fatal("max_bin should be >= 2")
        if self.verbosity is not None:
            log.set_verbosity(self.verbosity)
        self.metric = resolve_metrics(self.metric, self.objective)

    def check_supported(self, dataset_only: bool = False) -> None:
        """Raise ``NotImplementedError`` for every parameter outside the
        port's first slice, naming the ROADMAP item that brings it.
        ``dataset_only`` checks only the binning parameters (a Dataset is
        constructed before the objective is known)."""
        todo = []

        def need(cond: bool, what: str, item: str) -> None:
            if cond:
                todo.append(f"{what} (ROADMAP {item})")

        need(self.categorical_feature not in ("", None, "auto", []),
             "categorical features", "A12")
        need(self.enable_bundle, "EFB bundling (enable_bundle)", "A13")
        need(self.tpu_bin_pack4, "tpu_bin_pack4", "A15")
        need(bool(self.forcedbins_filename), "forced bins", "A3")
        need(self.max_bin > 255, "max_bin>255", "A3")
        if not dataset_only:
            need(self.objective != "binary",
                 f"objective={self.objective!r}", "A12")
            need(self.num_class > 1, "num_class>1", "A12")
            need(str(self.tree_learner).lower() != "serial",
                 f"tree_learner={self.tree_learner!r}", "A18")
            need(self.num_machines > 1, "num_machines>1", "A18")
            need(bool(self.input_model), "input_model", "A9")
            need(self.boosting != "gbdt", f"boosting={self.boosting!r}",
                 "A14")
            need(self.data_sample_strategy != "bagging",
                 f"data_sample_strategy={self.data_sample_strategy!r}",
                 "A14")
            need(self.bagging_freq > 0 or self.pos_bagging_fraction < 1.0
                 or self.neg_bagging_fraction < 1.0 or self.bagging_by_query,
                 "bagging", "A14")
            need(self.feature_fraction < 1.0, "feature_fraction<1", "A14")
            need(self.feature_fraction_bynode < 1.0,
                 "feature_fraction_bynode<1", "A14")
            need(self.extra_trees, "extra_trees", "A14")
            need(self.monotone_constraints is not None,
                 "monotone_constraints", "A14")
            need(self.interaction_constraints not in (None, "", []),
                 "interaction_constraints", "A14")
            need(self.cegb_penalty_split > 0.0
                 or self.cegb_penalty_feature_lazy is not None
                 or self.cegb_penalty_feature_coupled is not None,
                 "cost-effective gradient boosting", "A14")
            need(bool(self.forcedsplits_filename), "forced splits", "A14")
            need(self.path_smooth > 0.0, "path_smooth", "A14")
            need(self.feature_contri not in (None, "", []),
                 "feature_contri", "A14")
            need(self.linear_tree, "linear_tree", "A14")
            need(self.early_stopping_round > 0, "early stopping", "A8")
            need(self.use_quantized_grad, "use_quantized_grad", "A15")
            # the CUDA histograms add f32 atomics in no fixed order
            need(self.deterministic, "deterministic histograms", "B1/B2")
            grower = str(self.tpu_grower).lower()
            need(grower not in ("auto", "compact"),
                 f"tpu_grower={self.tpu_grower!r}", "A11")
            layout = str(self.tpu_hist_layout).lower()
            need(layout not in ("auto", "lane"),
                 f"tpu_hist_layout={self.tpu_hist_layout!r}", "B3")
        if todo:
            raise NotImplementedError(
                "not in the PyTorch port yet: " + "; ".join(todo))



def resolve_device(cfg: Config):
    """The ``torch.device`` a run uses. ``cuda`` without a card raises a
    ``RuntimeError``: the port never carries on quietly on the CPU."""
    import torch
    if cfg.device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device_type='cuda' but torch.cuda.is_available() is False "
                "(no CUDA device visible); pass device_type='cpu' to run the "
                "plain PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def resolve_metrics(metric: Any, objective: Any) -> List[str]:
    """The ``metric`` parameter as a canonical list (default: the
    objective's own metric)."""
    if metric is None or metric == "" or metric == []:
        return ["binary_logloss"] if objective == "binary" else []
    if isinstance(metric, str):
        metric = [m.strip() for m in metric.split(",") if m.strip()]
    out: List[str] = []
    for m in metric:
        canon = METRIC_ALIASES.get(str(m).lower())
        if canon is None:
            raise NotImplementedError(
                f"metric {m!r} is not in the PyTorch port yet (ROADMAP A4); "
                "it has binary_logloss and auc")
        if canon == "none":
            return []
        if canon not in out:
            out.append(canon)
    return out
