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

Every key of the JAX package's ``PARAMS`` is in one of three places: this
``PARAMS`` (the keys the port reads), ``REFUSED_PARAMS`` (keys the port
cannot honour yet: set away from their default they raise, naming their
ROADMAP item) or ``IGNORED_PARAMS`` (the TPU layout, serving, tracing and
thread switches, which change no result for the inputs the port takes: they
are accepted with one debug line). A key in none of them warns "Unknown
parameter" and is dropped, as in the JAX package.
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
    # GOSS (data_sample_strategy=goss; reference: config.h top_rate/other_rate)
    "top_rate": (0.2, float, ()),
    "other_rate": (0.1, float, ()),
    "feature_fraction": (1.0, float, ("sub_feature", "colsample_bytree")),
    "feature_fraction_bynode": (1.0, float, ("sub_feature_bynode", "colsample_bynode")),
    "feature_fraction_seed": (2, int, ()),
    "extra_trees": (False, bool, ("extra_tree",)),
    "extra_seed": (6, int, ()),
    # DART (reference: config.h drop_rate ... drop_seed)
    "drop_rate": (0.1, float, ("rate_drop",)),
    "max_drop": (50, int, ()),
    "skip_drop": (0.5, float, ()),
    "xgboost_dart_mode": (False, bool, ()),
    "uniform_drop": (False, bool, ()),
    "drop_seed": (4, int, ()),
    "early_stopping_round": (0, int, (
        "early_stopping_rounds", "early_stopping", "n_iter_no_change")),
    "first_metric_only": (False, bool, ()),
    "early_stopping_min_delta": (0.0, float, ()),
    "max_delta_step": (0.0, float, ("max_tree_output", "max_leaf_output")),
    "lambda_l1": (0.0, float, ("reg_alpha", "l1_regularization")),
    "lambda_l2": (0.0, float, ("reg_lambda", "lambda", "l2_regularization")),
    "min_gain_to_split": (0.0, float, ("min_split_gain",)),
    # categorical splits (reference: config.h:480-501)
    "min_data_per_group": (100, int, ()),
    "max_cat_threshold": (32, int, ()),
    "cat_l2": (10.0, float, ()),
    "cat_smooth": (10.0, float, ()),
    "max_cat_to_onehot": (4, int, ()),
    # constraints / cost-effective boosting / forced splits
    "monotone_constraints": (None, object, ("mc", "monotone_constraint")),
    "monotone_constraints_method": ("basic", str, ("monotone_constraining_method", "mc_method")),
    "monotone_penalty": (0.0, float, ("monotone_splits_penalty", "ms_penalty", "mc_penalty")),
    "interaction_constraints": (None, object, ()),
    "forcedsplits_filename": ("", str, ("fs", "forced_splits_filename", "forced_splits_file", "forced_splits")),
    "cegb_tradeoff": (1.0, float, ()),
    "cegb_penalty_split": (0.0, float, ()),
    "cegb_penalty_feature_lazy": (None, object, ()),
    "cegb_penalty_feature_coupled": (None, object, ()),
    "path_smooth": (0.0, float, ()),
    "feature_contri": (None, object, ("feature_contrib", "fc", "fp", "feature_penalty")),
    "verbosity": (1, int, ("verbose",)),
    # quantized-gradient training (reference: gradient_discretizer.cpp)
    "use_quantized_grad": (False, bool, ()),
    "num_grad_quant_bins": (4, int, ()),
    "quant_train_renew_leaf": (False, bool, ()),
    "stochastic_rounding": (True, bool, ()),
    # dataset
    "linear_tree": (False, bool, ("linear_trees",)),
    "linear_lambda": (0.0, float, ()),
    "max_bin": (255, int, ("max_bins",)),
    "max_bin_by_feature": (None, object, ()),
    "min_data_in_bin": (3, int, ()),
    "bin_construct_sample_cnt": (200000, int, ("subsample_for_bin",)),
    "data_random_seed": (1, int, ("data_seed",)),
    # Exclusive Feature Bundling (io/efb.py), on by default as in LightGBM
    "enable_bundle": (True, bool, ("is_enable_bundle", "bundle")),
    "max_conflict_rate": (1e-4, float, ()),
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
    "reg_sqrt": (False, bool, ()),
    "alpha": (0.9, float, ()),
    "fair_c": (1.0, float, ()),
    "poisson_max_delta_step": (0.7, float, ()),
    "tweedie_variance_power": (1.5, float, ()),
    # ranking (reference: config.h:1011-1040)
    "lambdarank_truncation_level": (30, int, ()),
    "lambdarank_norm": (True, bool, ()),
    "label_gain": (None, object, ()),
    "lambdarank_position_bias_regularization": (0.0, float, ()),
    "objective_seed": (5, int, ()),
    # metric
    "metric": (None, object, ("metrics", "metric_types")),
    "metric_freq": (1, int, ("output_freq",)),
    "eval_at": ((1, 2, 3, 4, 5), object, (
        "ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at")),
    "multi_error_top_k": (1, int, ()),
    "auc_mu_weights": (None, object, ()),
    # prediction: the default iteration window of Booster.predict, and its
    # early stopping (reference: config.h predict section)
    "start_iteration_predict": (0, int, ()),
    "num_iteration_predict": (-1, int, ()),
    "pred_early_stop": (False, bool, ()),
    "pred_early_stop_freq": (10, int, ()),
    "pred_early_stop_margin": (10.0, float, ()),
    # Booster.refit's default decay (reference: config.h refit_decay_rate)
    "refit_decay_rate": (0.9, float, ()),
    # model snapshots, read to be refused (ROADMAP A16)
    "snapshot_freq": (-1, int, ("save_period",)),
    # grower selection knobs shared with the JAX package
    "tpu_grower": ("auto", str, ()),            # auto | compact | masked
    "tpu_hist_layout": ("auto", str, ("hist_layout",)),  # auto|lane|sublane
    # 4-bit packed bin columns (compact records and prediction) where every
    # column has at most 16 bins; else a warning and u8 columns
    "tpu_bin_pack4": (False, bool, ("bin_pack4",)),
    # 0 = auto, 16 = the narrowed 16-bit quantized histogram (the compact
    # grower without the fused kernel only; with K2 a warning and 32
    # bits, as in the JAX package), 32
    "tpu_quant_hist_bits": (0, int, ("quant_hist_bits",)),
    # the compact grower's fused split kernel K2: auto | on | off; off
    # partitions and then histograms the smaller child (resolve_fused)
    "tpu_fused": ("auto", str, ()),
}

# the JAX package's keys the port cannot honour yet: name -> (default, type,
# aliases, ROADMAP item). Set away from the default, each raises at
# check_supported.
REFUSED_PARAMS: Dict[str, Tuple[Any, type, Tuple[str, ...], str]] = {
    # distributed learners
    "top_k": (20, int, ("topk",), "A18"),
    "pre_partition": (False, bool, ("is_pre_partition",), "A18"),
    "local_listen_port": (12400, int, ("local_port", "port"), "A18"),
    "time_out": (120, int, (), "A18"),
    "machine_list_filename": ("", str, (
        "machine_list_file", "machine_list", "mlist"), "A18"),
    "machines": ("", str, ("workers", "nodes"), "A18"),
    "tpu_mesh_shape": ("", str, ("mesh_shape",), "A18"),
    "num_shards": (0, int, (), "A18"),
    # the file loader and checkpoints
    "two_round": (False, bool, (
        "two_round_loading", "use_two_round_loading"), "A16"),
    "header": (False, bool, ("has_header",), "A16"),
    "label_column": ("", str, ("label",), "A16"),
    "weight_column": ("", str, ("weight",), "A16"),
    "group_column": ("", str, (
        "group", "group_id", "query_column", "query", "query_id"), "A16"),
    "ignore_column": ("", str, ("ignore_feature", "blacklist"), "A16"),
    "save_binary": (False, bool, (
        "is_save_binary", "is_save_binary_file"), "A16"),
    "precise_float_parser": (False, bool, (), "A16"),
    "parser_config_file": ("", str, (), "A16"),
    "tpu_checkpoint_dir": ("", str, ("checkpoint_dir",), "A16"),
    "tpu_checkpoint_freq": (0, int, ("checkpoint_freq",), "A16"),
    "tpu_checkpoint_keep": (3, int, ("checkpoint_keep",), "A16"),
    # serving: quantized leaves change the level engine's outputs
    "tpu_leaf_quant": ("off", str, (), "A17"),
    # tooling: injected faults
    "tpu_fault_spec": ("", str, (), "A19"),
}

# the JAX package's keys that change no result for the inputs the port
# takes: its TPU layout and engine switches, serving, tracing and metrics,
# threads and devices, the CLI's output switches, and output_model (read
# only with snapshot_freq, which is refused). name -> aliases; accepted
# with one debug line.
IGNORED_PARAMS: Dict[str, Tuple[str, ...]] = {
    "stop_check_freq": (), "force_col_wise": (), "force_row_wise": (),
    "is_enable_sparse": ("is_sparse", "enable_sparse", "sparse"),
    "feature_pre_filter": (),
    "predict_raw_score": ("is_predict_raw_score", "predict_rawscore",
                          "raw_score"),
    "predict_leaf_index": ("is_predict_leaf_index", "leaf_index"),
    "predict_contrib": ("is_predict_contrib", "contrib"),
    "predict_disable_shape_check": (),
    "is_provide_training_metric": ("training_metric", "is_training_metric",
                                   "train_metric"),
    "output_model": ("model_output", "model_out"),
    "gpu_platform_id": (), "gpu_device_id": (), "gpu_use_dp": (),
    "num_gpu": (),
    "tpu_hist_impl": (), "tpu_trace_dir": (), "tpu_trace_mode": ("trace_mode",),
    "tpu_metrics_path": ("metrics_path",),
    "tpu_flight_buffer": ("flight_buffer",),
    "tpu_metrics_port": ("metrics_port",),
    "tpu_rank_stats_every": ("rank_stats_every",),
    "tpu_straggler_factor": ("straggler_factor",),
    "tpu_part_block": (), "tpu_hist_block": (),
    "tpu_hist_mbatch": ("hist_mbatch",), "tpu_autotune": ("autotune",),
    "tpu_autotune_cache": ("autotune_cache",), "tpu_hist_scatter": (),
    "tpu_step_buckets": ("step_buckets",),
    "tpu_compile_cache_dir": ("compile_cache_dir",),
    "tpu_hist_overlap": ("hist_overlap",),
    "tpu_fused_block": (), "tpu_fused_interpret": (),
    "tpu_predict_tbatch": ("predict_tbatch",),
    "tpu_predict_buckets": ("predict_buckets",),
    "tpu_predict_engine": (), "tpu_level_depth_cap": (),
    "tpu_serve_tick_ms": ("serve_tick_ms",),
    "tpu_serve_queue_max": ("serve_queue_max",),
    "tpu_serve_deadline_ms": ("serve_deadline_ms",),
    "tpu_serve_warm_max_rows": ("serve_warm_max_rows",),
    "tpu_serve_featurize": ("serve_featurize",),
    "tpu_serve_endpoints": ("serve_endpoints",),
    "tpu_serve_background_kinds": ("serve_background_kinds",),
    "tpu_shap_tables": (), "tpu_shap_table_mb": (),
    "tpu_drift_flush_every": ("drift_flush_every",),
    "tpu_drift_psi_threshold": ("drift_psi_threshold",),
    "tpu_drift_score_bins": ("drift_score_bins",),
    "tpu_drift_bins": ("drift_bins",),
    "tpu_drift_min_rows": ("drift_min_rows",),
    "tpu_serve_slo_ms": ("serve_slo_ms",),
    "tpu_serve_slo_target": ("serve_slo_target",),
    "tpu_collective_deadline_s": ("collective_deadline",),
    "tpu_collective_retries": (),
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

# a custom objective, whose gradients come from ``fobj``: ``objective`` is
# then "custom" (or the callable itself)
CUSTOM_OBJECTIVES = ("custom", "none", "null", "na")

METRIC_ALIASES: Dict[str, str] = {
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression_l2": "l2",
    "regression": "l2",
    "rmse": "rmse", "root_mean_squared_error": "rmse", "l2_root": "rmse",
    "quantile": "quantile",
    "mape": "mape", "mean_absolute_percentage_error": "mape",
    "huber": "huber", "fair": "fair", "poisson": "poisson", "gamma": "gamma",
    "gamma_deviance": "gamma_deviance", "tweedie": "tweedie",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg",
    "xendcg": "ndcg", "xe_ndcg": "ndcg", "xe_ndcg_mart": "ndcg",
    "xendcg_mart": "ndcg",
    "map": "map", "mean_average_precision": "map",
    "auc": "auc",
    "average_precision": "average_precision",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "auc_mu": "auc_mu",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multiclass_ova": "multi_logloss", "ova": "multi_logloss",
    "ovr": "multi_logloss",
    "multi_error": "multi_error",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kldiv", "kldiv": "kldiv",
    "none": "none", "na": "none", "null": "none", "custom": "none",
}

# each objective's own metric (reference: the default metric of
# Config::CheckParamConflict / the JAX package's default_metric_for_objective)
DEFAULT_METRIC: Dict[str, str] = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber",
    "fair": "fair", "poisson": "poisson", "quantile": "quantile",
    "mape": "mape", "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary_logloss", "multiclass": "multi_logloss",
    "multiclassova": "multi_logloss", "xentropy": "cross_entropy",
    "xentlambda": "cross_entropy_lambda", "lambdarank": "ndcg",
    "rank_xendcg": "ndcg",
}

MULTICLASS_OBJECTIVES = ("multiclass", "multiclassova")

DEVICE_ALIASES: Dict[str, str] = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}

_ALIAS_TABLE: Dict[str, str] = {}
for _name, (_d, _t, _aliases) in PARAMS.items():
    _ALIAS_TABLE[_name] = _name
    for _a in _aliases:
        _ALIAS_TABLE[_a] = _name
# the refused and the ignored keys' names and aliases
_OTHER_ALIASES: Dict[str, str] = {}
for _name, _aliases in [(k, v[2]) for k, v in REFUSED_PARAMS.items()] \
        + list(IGNORED_PARAMS.items()):
    for _a in (_name,) + _aliases:
        _OTHER_ALIASES[_a] = _name


def alias_table() -> Dict[str, str]:
    return dict(_ALIAS_TABLE)


def _coerce(name: str, value: Any, typ: type) -> Any:
    if value is None:
        return None
    if name == "objective" and callable(value):
        return value                  # a custom objective function
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
        # REFUSED_PARAMS keys that were set, by canonical name
        self.refused: Dict[str, Any] = {}
        if params:
            self.set(params)

    def set(self, params: Dict[str, Any]) -> None:
        # canonical names win over aliases (reference: Config::KeepFirstValues)
        resolved: Dict[str, Any] = {}
        for key, value in params.items():
            canon = _ALIAS_TABLE.get(key)
            if canon is None:
                other = _OTHER_ALIASES.get(key)
                if other in REFUSED_PARAMS:
                    self.refused[other] = value
                elif other is not None:
                    log.debug(f"Parameter {key} changes nothing in the "
                              "PyTorch port; ignored")
                else:
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
        if isinstance(obj, str) and obj.lower() in CUSTOM_OBJECTIVES:
            self.objective = "custom"
        elif isinstance(obj, str):
            if obj.lower() not in OBJECTIVE_ALIASES:
                log.fatal(f"Unknown objective: {obj!r}")
            self.objective = OBJECTIVE_ALIASES[obj.lower()]
        elif not callable(obj):
            log.fatal(f"Unknown objective: {obj!r}")
        if self.boosting == "goss":
            self.boosting = "gbdt"
            self.data_sample_strategy = "goss"
        if self.boosting == "gbrt":
            self.boosting = "gbdt"
        if self.boosting == "random_forest":
            self.boosting = "rf"
        if self.boosting not in ("gbdt", "dart", "rf"):
            log.fatal(f"Unknown boosting type: {self.boosting}")
        self.data_sample_strategy = str(self.data_sample_strategy).lower()
        if self.data_sample_strategy not in ("bagging", "goss"):
            log.fatal("Unknown data_sample_strategy: "
                      f"{self.data_sample_strategy}")
        dev = str(self.device_type).lower()
        if dev not in DEVICE_ALIASES:
            raise ValueError(
                f"device_type={self.device_type!r}: the port runs on 'cuda' "
                "(alias 'gpu') or 'cpu'")
        self.device_type = DEVICE_ALIASES[dev]
        if self.objective in MULTICLASS_OBJECTIVES and self.num_class <= 1:
            log.fatal("Number of classes should be specified and greater "
                      "than 1 for multiclass training")
        if self.objective not in MULTICLASS_OBJECTIVES \
                and self.num_class != 1:
            log.fatal("Number of classes must be 1 for non-multiclass "
                      "training")
        if self.bagging_freq > 0 and not 0.0 < self.bagging_fraction < 1.0 \
                and self.data_sample_strategy == "bagging" \
                and not self.bagging_by_query:
            self.bagging_freq = 0
        if self.early_stopping_round < 0:
            self.early_stopping_round = 0
        if self.num_leaves < 2:
            self.num_leaves = 2
        if self.max_bin < 2:
            log.fatal("max_bin should be >= 2")
        if self.verbosity is not None:
            log.set_verbosity(self.verbosity)
        self.metric = resolve_metrics(self.metric, self.objective)

    def check_supported(self, dataset_only: bool = False) -> None:
        """Raise ``NotImplementedError`` for every parameter outside the
        port's slices so far, naming the ROADMAP item that brings it.
        ``dataset_only`` checks only the binning parameters (a Dataset is
        constructed before the objective is known)."""
        todo = []

        def need(cond: bool, what: str, item: str) -> None:
            if cond:
                todo.append(f"{what} (ROADMAP {item})")

        for name, value in self.refused.items():
            default, typ, _aliases, item = REFUSED_PARAMS[name]
            need(_coerce(name, value, typ) != default,
                 f"{name}={value!r}", item)
        if not dataset_only:
            need(str(self.tree_learner).lower() != "serial",
                 f"tree_learner={self.tree_learner!r}", "A18")
            need(self.num_machines > 1, "num_machines>1", "A18")
            need(self.snapshot_freq > 0, "snapshot_freq", "A16")
            # the CUDA histograms add f32 atomics in no fixed order
            need(self.deterministic, "deterministic histograms", "B1/B2")
        if todo:
            raise NotImplementedError(
                "not in the PyTorch port yet: " + "; ".join(todo))


def resolve_hist_layout(cfg: Config, num_bins: int) -> str:
    """``tpu_hist_layout`` as the histogram layout a run uses, with the
    semantics of ``resolve_layout`` (``lightgbm_tpu/engines/registry.py:
    348``): ``auto`` is ``lane`` (the port has no autotune cache yet,
    ROADMAP A19); ``sublane`` above 64 bins, and an unknown value, warn and
    use ``lane``."""
    mode = str(cfg.tpu_hist_layout or "auto").lower()
    if mode == "auto":
        return "lane"
    if mode not in ("lane", "sublane"):
        log.warning(f"tpu_hist_layout={mode!r} is not one of "
                    "auto|lane|sublane; using the lane layout")
        return "lane"
    if mode == "sublane" and num_bins > 64:
        log.warning(f"tpu_hist_layout=sublane needs num_bins <= 64 (got "
                    f"{num_bins}): using lane")
        return "lane"
    return mode


def resolve_fused(cfg: Config) -> bool:
    """``tpu_fused`` as the compact grower's choice of K2 (the on/off
    decision of ``resolve_fused_block``, ``lightgbm_tpu/engines/
    registry.py:422-452``): ``auto`` and ``on`` run the fused split kernel
    (the card always has it); ``off`` partitions with K2's partition alone
    and histograms the smaller child with K1 or K3; an unknown value warns
    and means ``auto``."""
    mode = str(cfg.tpu_fused or "auto").lower()
    if mode in ("off", "0", "false"):
        return False
    if mode not in ("auto", "on", "1", "true"):
        log.warning(f"tpu_fused={mode!r} is not one of auto|on|off; using "
                    "auto")
    return True


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
        default = DEFAULT_METRIC.get(objective)
        return [default] if default in METRIC_ALIASES else []
    if isinstance(metric, str):
        metric = [m.strip() for m in metric.split(",") if m.strip()]
    out: List[str] = []
    for m in metric:
        canon = METRIC_ALIASES.get(str(m).lower())
        if canon is None:
            raise ValueError(f"Unknown metric: {m!r}")
        if canon == "none":
            return []
        if canon not in out:
            out.append(canon)
    return out
