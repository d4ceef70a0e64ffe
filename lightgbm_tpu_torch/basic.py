"""User-facing ``Dataset`` and ``Booster``.

Counterpart of ``lightgbm_tpu/basic.py`` (reference:
python-package/lightgbm/basic.py): a lazily constructed ``Dataset`` and a
``Booster`` with ``update`` (``fobj``: a custom objective),
``rollback_one_iter``, ``reset_parameter``, ``predict``,
``eval_train``/``eval_valid`` (``feval``: custom metrics), ``refit``,
``current_iteration``, ``feature_importance`` and model text
(``save_model``, ``model_to_string``, ``dump_model``;
``Booster(model_file=...)`` / ``Booster(model_str=...)`` loads text written
by the port, the JAX package or stock LightGBM, and predicts on the host,
see ``model_io.py``). A Booster continued from a loaded model
(``train(init_model=...)``) keeps the loaded trees, which predict on the
host and are written first in its model text. ``predict`` also gives leaf
indices (``pred_leaf``), TreeSHAP contributions (``pred_contrib``: on the
device for the booster's own trees, on the host for loaded ones) and early
stopped classification scores (``pred_early_stop``). The device comes from the
``device_type`` parameter (default ``cuda``; ``cpu`` runs the plain PyTorch
versions of the kernels) and is never chosen silently: ``cuda`` without a
visible card raises.

Not here yet: ``cv``, sklearn and the CLI (ROADMAP A16).
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .config import Config, alias_table, resolve_device
from .io.dataset import BinnedDataset, Metadata
from .metrics import create_metrics
from .model_io import (LoadedGBDT, booster_to_dict, booster_to_string,
                       load_booster, loaded_dump, merge_model_texts)
from .objectives import create_objective

_DATASET_PARAM_KEYS = ("max_bin", "min_data_in_bin", "bin_construct_sample_cnt",
                       "use_missing", "zero_as_missing", "data_random_seed",
                       "max_bin_by_feature", "device_type", "enable_bundle",
                       "max_conflict_rate", "categorical_feature",
                       "forcedbins_filename", "tpu_bin_pack4",
                       "linear_tree")
# the keyword arguments of Booster.predict beside its named ones
_EARLY_STOP_KEYS = ("pred_early_stop", "pred_early_stop_margin",
                    "pred_early_stop_freq")


class Sequence:
    """Random-access rows for streaming Dataset construction (reference:
    ``lightgbm_tpu/basic.py:34-49``; LightGBM's ``lightgbm.Sequence``).
    A subclass implements ``__getitem__`` (an int: one row ``[F]``; a
    slice: rows ``[K, F]``) and ``__len__``; ``batch_size`` rows are read
    at a time. The raw ``[N, F]`` matrix is never made."""

    batch_size = 4096

    def __getitem__(self, idx):
        raise NotImplementedError("Sequence subclasses implement "
                                  "__getitem__")

    def __len__(self):
        raise NotImplementedError("Sequence subclasses implement __len__")


def _as_sequences(data) -> Optional[List[Sequence]]:
    """``data`` as a list of ``Sequence`` objects, or None where it is not
    one or a non-empty list of them."""
    if isinstance(data, Sequence):
        return [data]
    if isinstance(data, (list, tuple)) and data \
            and all(isinstance(s, Sequence) for s in data):
        return list(data)
    return None


def _maybe_series(x):
    if x is None:
        return None
    if hasattr(x, "values") and not isinstance(x, np.ndarray):
        return x.values
    return x


class Dataset:
    """Training/validation data container (reference: Dataset,
    basic.py:1900); binning happens at ``construct()``."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, position=None):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.position = position
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = copy.deepcopy(params) if params else {}
        self.free_raw_data = free_raw_data
        self._inner: Optional[BinnedDataset] = None

    def _update_params(self, params: Optional[Dict[str, Any]]) -> "Dataset":
        """Merge binning parameters from training params into a Dataset not
        yet constructed (training params win, canonical names over
        aliases)."""
        if not params or self._inner is not None:
            return self
        at = alias_table()
        incoming = {}
        for pass_aliases in (True, False):
            for key, value in params.items():
                canon = at.get(key, key)
                if canon in _DATASET_PARAM_KEYS \
                        and (key != canon) == pass_aliases:
                    incoming[canon] = value
        self.params.update(incoming)
        return self

    def construct(self) -> "Dataset":
        """(reference: Dataset.construct, basic.py:2517)"""
        if self._inner is not None:
            return self
        cfg = Config(self.params)
        cfg.check_supported(dataset_only=True)
        resolve_device(cfg)
        ref_inner = None
        if self.reference is not None:
            self.reference.construct()
            ref_inner = self.reference._inner
        if self.data is None:
            raise ValueError("Dataset has no data to construct from")
        feature_names = (None if self.feature_name == "auto"
                         else list(self.feature_name))
        # the argument, else the categorical_feature parameter
        cat = self.categorical_feature
        if cat is None or (isinstance(cat, str) and cat == "auto"):
            cat = cfg.categorical_feature
        common = dict(
            max_bin=cfg.max_bin,
            min_data_in_bin=cfg.min_data_in_bin,
            bin_construct_sample_cnt=cfg.bin_construct_sample_cnt,
            use_missing=cfg.use_missing,
            zero_as_missing=cfg.zero_as_missing,
            feature_names=feature_names,
            data_random_seed=cfg.get("data_random_seed", 1),
            reference=ref_inner,
            max_bin_by_feature=cfg.get("max_bin_by_feature"),
            categorical_feature=cat,
            enable_bundle=bool(cfg.enable_bundle),
            max_conflict_rate=float(cfg.max_conflict_rate),
            forcedbins_filename=str(cfg.forcedbins_filename or ""))
        seqs = _as_sequences(self.data)
        if seqs is not None:
            self._inner = BinnedDataset.construct_from_sequences(seqs,
                                                                 **common)
        else:
            # linear leaves fit on raw values (reference: basic.py:212-214,
            # LightGBM's dataset.h raw_data_)
            self._inner = BinnedDataset.construct(
                self.data, **common,
                keep_raw=not self.free_raw_data or bool(cfg.linear_tree))
        md = self._inner.metadata
        if self.label is not None:
            md.set_label(_maybe_series(self.label))
        md.set_weight(_maybe_series(self.weight))
        md.set_group(_maybe_series(self.group))
        md.set_init_score(self.init_score)
        md.set_position(_maybe_series(self.position))
        if self.free_raw_data:
            self.data = None
        return self

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, position=None) -> "Dataset":
        """A validation Dataset binned with this one's mappers (its own
        query groups for the ranking metrics)."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=self.params, position=position)

    def set_group(self, group) -> "Dataset":
        """Query sizes in row order (reference: Dataset.set_group)."""
        self.group = group
        if self._inner is not None:
            self._inner.metadata.set_group(group)
        return self

    def get_label(self):
        if self._inner is not None:
            return self._inner.metadata.label
        return self.label

    def get_group(self):
        if self._inner is not None:
            return self._inner.metadata.group
        return self.group

    def get_weight(self):
        if self._inner is not None:
            return self._inner.metadata.weight
        return self.weight

    def num_data(self) -> int:
        if self._inner is not None:
            return self._inner.num_data
        return int(np.asarray(self.data).shape[0])

    def num_feature(self) -> int:
        if self._inner is not None:
            return self._inner.num_total_features
        return int(np.asarray(self.data).shape[1])


class Booster:
    """The training/trained model handle (reference: Booster,
    basic.py:3586)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = copy.deepcopy(params) if params else {}
        self._valid_names: List[str] = []
        self._train_data_name = "training"
        self.best_iteration = -1
        self.best_score: Dict = {}
        self._custom_objective: Optional[Callable] = None
        self._pre_model = None
        if train_set is None:
            if model_file is None and model_str is None:
                raise ValueError("need at least one of train_set, model_file "
                                 "and model_str")
            if model_file is not None:
                with open(model_file) as fh:
                    model_str = fh.read()
            self.config = Config(self.params)
            self.device = None
            load_booster(self, model_str)
            return
        if not isinstance(train_set, Dataset):
            raise TypeError("Training data should be a Dataset instance")
        self.config = Config(self.params)
        self.config.check_supported()
        self.device = resolve_device(self.config)
        train_set._update_params(self.params)
        train_set.construct()
        self.train_set = train_set
        objective = self.config.objective
        if callable(objective):
            # a custom objective in the parameters (reference: basic.py
            # Booster.__init__, the JAX package's _custom_objective)
            self._custom_objective = objective
        from .boosting import create_boosting
        self._gbdt = create_boosting(
            self.config, train_set._inner,
            None if callable(objective) or objective == "custom"
            else create_objective(objective, self.config), self.device)
        self._gbdt.set_train_metrics(
            create_metrics(self.config.metric, self.config))

    @classmethod
    def _from_gbdt(cls, gbdt, params: Optional[Dict[str, Any]] = None
                   ) -> "Booster":
        """A prediction-only Booster around a ready model (convert.py)."""
        self = cls.__new__(cls)
        self.params = copy.deepcopy(params) if params else {}
        self.config = Config(self.params)
        self.device = gbdt.device
        self.train_set = None
        self._gbdt = gbdt
        self._valid_names = []
        self._train_data_name = "training"
        self.best_iteration = -1
        self.best_score = {}
        self._custom_objective = None
        self._pre_model = None
        return self

    # -- continued training (reference: init_model -> gbdt.cpp:250-258) -----
    def _attach_pre_model(self, pre_model, pre_train_raw: np.ndarray
                          ) -> None:
        """Seed the train scores with a loaded model's ``[K, N]`` raw
        predictions and keep its trees for prediction and model text
        (reference: ``_attach_pre_model``, ``lightgbm_tpu/basic.py:
        504-518``)."""
        self._gbdt.add_init_scores(pre_train_raw)
        self._pre_model = pre_model

    def _seed_valid_scores(self, which: int, pre_raw: np.ndarray) -> None:
        vs = self._gbdt.valid_sets[which]
        vs.score[:, :pre_raw.shape[1]] += torch.from_numpy(
            np.asarray(pre_raw, np.float32)).to(vs.score.device)

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """(reference: Booster.add_valid, basic.py:3963)"""
        if not isinstance(data, Dataset):
            raise TypeError("Validation data should be a Dataset instance")
        if data.reference is not self.train_set:
            if data._inner is not None:
                raise ValueError(
                    "validation Dataset was constructed without "
                    "reference=train_set; create it with "
                    "train_set.create_valid(...)")
            data.reference = self.train_set
        data._update_params(self.params)
        data.construct()
        self._gbdt.add_valid(data._inner, name,
                             create_metrics(self.config.metric, self.config))
        self._valid_names.append(name)
        return self

    def update(self, train_set: Optional[Dataset] = None,
               fobj: Optional[Callable] = None) -> bool:
        """One boosting iteration; True if no further split was possible
        (reference: Booster.update, basic.py:4092). ``fobj(preds,
        train_set) -> (grad, hess)``: a custom objective, given the raw
        scores (``[n, K]`` for K trees an iteration) and returning the
        gradients in the dataset's row order. A model loaded from text
        has no training state, as in the JAX package."""
        if train_set is not None:
            raise NotImplementedError(
                "changing train_set on update is not supported")
        fobj = fobj or self._custom_objective
        if fobj is None:
            return self._gbdt.train_one_iter()
        grad, hess = _call_custom_objective(fobj, self)
        return self._gbdt.train_one_iter(grad, hess)

    def rollback_one_iter(self) -> "Booster":
        """Remove the last iteration's trees (reference:
        Booster.rollback_one_iter)."""
        self._gbdt.rollback_one_iter()
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Change parameters for the next iterations (reference:
        Booster.reset_parameter -> GBDT::ResetConfig, gbdt.cpp:795):
        ``learning_rate``, ``num_leaves``, ``max_depth``,
        ``lambda_l1``/``lambda_l2``, ``min_data_in_leaf``,
        ``min_sum_hessian_in_leaf``, ``min_gain_to_split``,
        ``max_delta_step`` and ``feature_fraction`` (and their aliases)
        take effect. The JAX package's engine-registry knobs (its XLA
        step ladder, histogram engines and fused block size) have no
        counterpart in the port; other parameters are recorded in the
        model text's parameters and change nothing."""
        self.params.update(params)
        self.config.set(params)
        self.config.check_supported()
        self._gbdt.reset_config(self.config)
        return self

    def eval_train(self, feval=None):
        out = [(self._train_data_name, m, v, hb)
               for (_, m, v, hb) in self._gbdt.eval_train()]
        if feval is not None:
            out.extend(self._eval_custom(feval, self._train_data_name,
                                         None))
        return out

    def eval_valid(self, feval=None):
        out = self._gbdt.eval_valid()
        if feval is not None:
            for i, name in enumerate(self._valid_names):
                out.extend(self._eval_custom(feval, name, i))
        return out

    def _eval_custom(self, feval, name: str, which: Optional[int]):
        """``feval(preds, data) -> (name, value, higher_better)`` or a list
        of them, on the raw scores (``[n, K]`` for K trees an iteration) in
        the dataset's row order (reference: ``_eval_custom``,
        ``lightgbm_tpu/basic.py:789-822``); ``which``: the validation
        set's index, None for the training data."""
        fevals = feval if isinstance(feval, (list, tuple)) else [feval]
        gbdt = self._gbdt
        if which is None:
            raw = gbdt.train_score_original_order()
            data = self.train_set
        else:
            vs = gbdt.valid_sets[which]
            raw = vs.score.cpu().numpy()
            data = _DatasetView(vs.dataset)
        preds = raw[0] if raw.shape[0] == 1 else raw.T
        out = []
        for f in fevals:
            res = f(preds, data)
            for metric, value, hb in (res if isinstance(res, list)
                                      else [res]):
                out.append((name, metric, value, hb))
        return out

    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        """Predictions ``[N]``, or ``[N, K]`` for a model of K classes:
        the objective's output (probabilities for the classifiers), or raw
        scores with ``raw_score`` (reference: Booster.predict,
        ``lightgbm_tpu/basic.py:822-866``). ``pred_leaf``: leaf indices
        ``[N, T]`` int32 of the window's trees; ``pred_contrib``: TreeSHAP
        contributions ``[N, K*(F+1)]`` float64, each class's bias last.
        ``pred_early_stop``, ``pred_early_stop_margin`` and
        ``pred_early_stop_freq`` override the parameters of the same
        names."""
        unknown = sorted(set(kwargs) - set(_EARLY_STOP_KEYS))
        if unknown:
            raise NotImplementedError(
                f"predict arguments {unknown} are not in the PyTorch port "
                "yet (ROADMAP A16)")
        start_iteration, num_iteration = self._predict_window(
            start_iteration, num_iteration)
        arr = np.asarray(_maybe_series(data))
        (pre, pre_start, pre_cut, own_start, own_cut, pre_empty,
         own_empty) = self._global_tree_window(start_iteration,
                                               num_iteration)
        gbdt = self._gbdt
        if pred_leaf or pred_contrib:
            arr = np.atleast_2d(arr)
            method = ("predict_leaf_matrix" if pred_leaf
                      else "predict_contrib_matrix")
            parts = []
            if not pre_empty:
                parts.append(getattr(pre, method)(arr, pre_cut, pre_start))
            if not own_empty:
                parts.append(getattr(gbdt, method)(arr, own_cut, own_start))
            if pred_leaf:
                # the loaded base's trees, then the booster's own
                return (np.concatenate(parts, axis=1) if parts
                        else np.zeros((arr.shape[0], 0), np.int32))
            # contributions add over trees
            return (sum(parts) if parts else np.zeros(
                (arr.shape[0], gbdt.num_class * (arr.shape[1] + 1))))
        raw = (gbdt.predict_raw_matrix(arr, own_cut, own_start,
                                       self._predict_early_stop(kwargs))
               if not own_empty else None)
        if not pre_empty:
            pre_raw = pre.predict_raw_matrix(arr, pre_cut, pre_start)
            raw = pre_raw if raw is None else raw + pre_raw
        if raw is None:
            raw = np.zeros((gbdt.num_class, np.atleast_2d(arr).shape[0]),
                           np.float32)
        raw = raw[0] if raw.shape[0] == 1 else raw.T
        objective = gbdt.objective
        if raw_score or objective is None:
            return raw
        return np.asarray(objective.convert_output(raw))

    def _predict_early_stop(self, kwargs):
        """``(margin, freq)`` of prediction early stopping, or None
        (reference: ``_predict_early_stop``, ``lightgbm_tpu/basic.py:
        952-970``): keyword arguments over parameters, and only for a
        binary objective or K > 1 trees an iteration, as LightGBM's
        predictor does."""
        cfg = self.config
        if not kwargs.get("pred_early_stop", cfg.pred_early_stop):
            return None
        gbdt = self._gbdt
        name = getattr(gbdt.objective, "name", "")
        if name != "binary" and gbdt.num_class <= 1:
            return None
        return (float(kwargs.get("pred_early_stop_margin",
                                 cfg.pred_early_stop_margin)),
                int(kwargs.get("pred_early_stop_freq",
                               cfg.pred_early_stop_freq)))

    def refit(self, data, label, decay_rate: Optional[float] = None,
              weight=None, **kwargs) -> "Booster":
        """A new Booster with this model's trees and leaf values re-fit on
        ``data`` (reference: ``Booster.refit``, ``lightgbm_tpu/basic.py:
        524-571``; GBDT::RefitTree): gradients once an iteration, from the
        running f32 score, on the booster's device; each tree routes the
        rows on their raw values on the host; the leaf sums in float64 give
        ``decay * old + (1 - decay) * shrinkage * -ThL1(G) / (H + l2)``.
        ``decay_rate`` defaults to the ``refit_decay_rate`` parameter."""
        if kwargs:
            raise TypeError(
                f"refit got unsupported arguments: {sorted(kwargs)}")
        cfg = self.config
        if decay_rate is None:
            decay_rate = float(cfg.refit_decay_rate)
        lam1 = float(cfg.get("lambda_l1", 0.0))
        lam2 = float(cfg.get("lambda_l2", 0.0))
        loaded = LoadedGBDT(self.model_to_string())
        obj = loaded.objective
        if obj is None:
            raise ValueError("refit requires a model with a known objective")
        device = self.device or resolve_device(cfg)
        X = np.asarray(_maybe_series(data), np.float64)
        y = np.asarray(_maybe_series(label), np.float64)
        md = Metadata(len(y))
        md.set_label(y)
        md.set_weight(_maybe_series(weight))
        obj.init(md, len(y))
        label_t = torch.from_numpy(md.label).to(device)
        weight_t = (None if obj.weight is None else torch.from_numpy(
            np.asarray(obj.weight, np.float32)).to(device))
        k = loaded.num_class
        score = np.zeros((k, len(y)), np.float64)
        for it in range(len(loaded.models) // k):
            # gradients once an iteration (reference: gbdt.cpp:279-281)
            sc = torch.from_numpy(score.astype(np.float32)).to(device)
            if not obj.row_elementwise:
                g, h = obj.get_gradients(sc[0])
            else:
                g, h = obj.get_gradients(sc[0] if k == 1 else sc, label_t,
                                         weight_t)
            g = g.reshape(k, -1).cpu().numpy().astype(np.float64)
            h = h.reshape(k, -1).cpu().numpy().astype(np.float64)
            for cls in range(k):
                t = loaded.models[it * k + cls]
                leaf = t.route(X)
                gs = np.bincount(leaf, weights=g[cls], minlength=t.num_leaves)
                hs = np.bincount(leaf, weights=h[cls], minlength=t.num_leaves)
                thr = np.sign(gs) * np.maximum(np.abs(gs) - lam1, 0.0)
                new_val = -thr / (hs + lam2 + 1e-15) * t.shrinkage
                t.leaf_value = (decay_rate * t.leaf_value
                                + (1.0 - decay_rate) * new_val)
                score[cls] += t.leaf_value[leaf]
        return Booster(model_str=loaded.to_string())

    def _predict_window(self, start_iteration: int,
                        num_iteration: Optional[int]):
        """The prediction window's defaults from the booster's parameters
        (reference: ``_predict_window``, ``lightgbm_tpu/basic.py:934-950``):
        ``start_iteration_predict`` where ``start_iteration`` is 0, then
        ``num_iteration_predict`` where ``num_iteration`` is None, else the
        best iteration of an early-stopped run."""
        cfg = self.config
        if start_iteration == 0 and cfg.start_iteration_predict > 0:
            start_iteration = cfg.start_iteration_predict
        if num_iteration is None and cfg.num_iteration_predict > 0:
            num_iteration = cfg.num_iteration_predict
        if num_iteration is None and self.best_iteration > 0:
            num_iteration = self.best_iteration
        return start_iteration, num_iteration

    def _global_tree_window(self, start_iteration: int,
                            num_iteration: Optional[int]):
        """Split an iteration window over the loaded model's trees, then
        this booster's own (reference: ``_global_tree_window``,
        ``lightgbm_tpu/basic.py:911-933``): ``(pre, pre_start, pre_cut,
        own_start, own_cut, pre_empty, own_empty)``, a None cut meaning
        to the end."""
        pre = self._pre_model
        pre_iters = pre.current_iteration() if pre is not None else 0
        end = (start_iteration + num_iteration
               if num_iteration is not None and num_iteration > 0 else None)
        pre_start = min(start_iteration, pre_iters)
        pre_cut = (max(min(end, pre_iters) - pre_start, 0)
                   if end is not None else None)
        own_start = max(start_iteration - pre_iters, 0)
        own_cut = (max(end - pre_iters - own_start, 0)
                   if end is not None else None)
        pre_empty = pre is None or pre_start >= pre_iters or pre_cut == 0
        return (pre, pre_start, pre_cut, own_start, own_cut, pre_empty,
                own_cut == 0)

    def current_iteration(self) -> int:
        pre = self._pre_model
        return self._gbdt.current_iteration() + (
            pre.current_iteration() if pre is not None else 0)

    def num_trees(self) -> int:
        pre = self._pre_model
        return len(self._gbdt.models) + (
            len(pre.models) if pre is not None else 0)

    def feature_importance(self, importance_type: str = "split"
                           ) -> np.ndarray:
        """Splits (or gains) per feature, over the loaded model's trees too
        (reference: Booster.feature_importance)."""
        imp = self._gbdt.feature_importance(importance_type)
        pre = self._pre_model
        if pre is not None:
            pre_imp = pre.feature_importance(importance_type)
            out = np.zeros(max(len(imp), len(pre_imp)), np.float64)
            out[:len(imp)] += imp
            out[:len(pre_imp)] += pre_imp
            return out
        return imp

    def num_feature(self) -> int:
        return self._gbdt.num_features()

    # -- model text (reference: Booster.save_model, model_to_string and
    # dump_model of python-package/lightgbm/basic.py) -------------------------
    def model_to_string(self, num_iteration: Optional[int] = None) -> str:
        """The model as LightGBM v4 text (all trees unless
        ``num_iteration``); a loaded model returns its text as read."""
        if num_iteration is None and self.best_iteration > 0:
            num_iteration = self.best_iteration
        pre = self._pre_model
        if pre is None:
            return booster_to_string(self, num_iteration)
        # the loaded trees first (reference: models_ holds loaded, then new
        # trees, gbdt_model_text.cpp)
        pre_cut = own_cut = None
        if num_iteration is not None and num_iteration > 0:
            pre_cut = min(num_iteration, pre.current_iteration())
            own_cut = max(num_iteration - pre.current_iteration(), 0)
        return merge_model_texts(pre, booster_to_string(self, own_cut),
                                 pre_num_iteration=pre_cut)

    def save_model(self, filename: str,
                   num_iteration: Optional[int] = None) -> "Booster":
        with open(filename, "w") as fh:
            fh.write(self.model_to_string(num_iteration))
        return self

    def dump_model(self, num_iteration: Optional[int] = None
                   ) -> Dict[str, Any]:
        """The model as a JSON-ready dict (reference: GBDT::DumpModel). A
        continued booster dumps its merged model text, the loaded trees
        first, as the reference does (``lightgbm_tpu/basic.py:1323-1332``:
        the text round trip is exact for the loaded trees)."""
        if self._pre_model is not None:
            return loaded_dump(LoadedGBDT(self.model_to_string(
                num_iteration)))
        return booster_to_dict(self, num_iteration)


class _DatasetView:
    """The label, weight and groups of a validation set, for ``feval``."""

    def __init__(self, inner: BinnedDataset):
        self._inner = inner

    def get_label(self):
        return self._inner.metadata.label

    def get_weight(self):
        return self._inner.metadata.weight

    def get_group(self):
        return self._inner.metadata.group


def _call_custom_objective(fobj: Callable, booster: Booster):
    """``fobj(preds, train_set) -> (grad, hess)`` on the raw train scores
    in the dataset's row order, ``[n, K]`` for K trees an iteration; the
    gradients come back ``[n, K]`` or flat (reference:
    ``_call_custom_objective``, ``lightgbm_tpu/basic.py:1414-1431``).
    Reads the scores on the host: a custom objective's contract."""
    gbdt = booster._gbdt
    raw = gbdt.train_score_original_order()
    preds = raw[0] if raw.shape[0] == 1 else raw.T
    grad, hess = fobj(preds, booster.train_set)
    grad = np.asarray(grad, np.float32)
    hess = np.asarray(hess, np.float32)
    k, n = gbdt.num_class, gbdt.num_data
    if grad.size != k * n or hess.size != k * n:
        raise ValueError(f"gradient size {grad.size} and hessian size "
                         f"{hess.size} must be num_class * num_data = "
                         f"{k * n}")
    if k > 1:
        grad = grad.reshape(n, k).T
        hess = hess.reshape(n, k).T
    return grad, hess
