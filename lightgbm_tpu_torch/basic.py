"""User-facing ``Dataset`` and ``Booster``.

Counterpart of ``lightgbm_tpu/basic.py`` (reference:
python-package/lightgbm/basic.py): a lazily constructed ``Dataset`` (its
fields set before or after ``construct``, ``subset`` on the parent's bins,
``save_binary`` and a ``.npz``/``.bin`` path as ``data``) and a
``Booster`` with ``update`` (``fobj``: a custom objective),
``rollback_one_iter``, ``reset_parameter``, ``predict``,
``eval_train``/``eval_valid`` (``feval``: custom metrics), ``refit``,
``current_iteration``, ``num_model_per_iteration``, ``feature_name``,
``feature_importance``, ``lower_bound``/``upper_bound`` and model text
(``save_model``, ``model_to_string``, ``dump_model``, each over an
iteration window;
``Booster(model_file=...)`` / ``Booster(model_str=...)`` loads text written
by the port, the JAX package or stock LightGBM, and predicts on the host,
see ``model_io.py``). A Booster continued from a loaded model
(``train(init_model=...)``) keeps the loaded trees, which predict on the
host and are written first in its model text. ``predict`` also gives leaf
indices (``pred_leaf``), TreeSHAP contributions (``pred_contrib``: on the
device for the booster's own trees, on the host for loaded ones) and early
stopped classification scores (``pred_early_stop``). A trained booster also
serves on the device: ``predict_device``, ``predict_serving``,
``predict_leaf_serving``, ``predict_contrib_serving``,
``warm_predict_ladder`` and ``serve`` (a ``serving.PredictionServer``).
Every public method of both classes shares (reads) or holds (writes) the
instance's reader-writer lock (``utils/rwlock.py``): predictions run side
by side, training and every change to a model alone. The device comes from
the ``device_type`` parameter (default ``cuda``; ``cpu`` runs the plain
PyTorch versions of the kernels) and is never chosen silently: ``cuda``
without a visible card raises.
"""
from __future__ import annotations

import copy
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .config import Config, alias_table, resolve_device
from .io.dataset import BinnedDataset, Metadata
from .metrics import create_metrics
from .model_io import (LoadedGBDT, booster_to_dict, booster_to_string,
                       check_importance_type, load_booster, loaded_dump,
                       merge_model_texts)
from .objectives import create_objective
from .ops.determinism import deterministic_algorithms
from .utils import log
from .utils.rwlock import RWLock, read_locked, write_locked

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
        # public methods share or hold this lock (utils/rwlock.py)
        self._api_lock = RWLock()
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
        self.used_indices: Optional[np.ndarray] = None
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

    @write_locked
    def construct(self) -> "Dataset":
        """(reference: Dataset.construct, basic.py:2517)"""
        if self._inner is not None:
            return self
        cfg = Config(self.params)
        cfg.check_supported(dataset_only=True)
        resolve_device(cfg)
        if isinstance(self.data, str) and self.data.endswith((".npz",
                                                              ".bin")):
            # a binary dataset file (reference: ``lightgbm_tpu/basic.py:
            # 151-166``; LightGBM's DatasetLoader::LoadFromBinFile): its
            # own metadata, unless given here
            self._inner = BinnedDataset.load_binary(self.data)
            md = self._inner.metadata
            for value, setter in ((self.label, md.set_label),
                                  (self.weight, md.set_weight),
                                  (self.group, md.set_group),
                                  (self.init_score, md.set_init_score),
                                  (self.position, md.set_position)):
                if value is not None:
                    setter(_maybe_series(value))
            if self.free_raw_data:
                self.data = None
            return self
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

    @write_locked
    def subset(self, used_indices, params=None) -> "Dataset":
        """A Dataset of some of this one's rows on its bins and mappers, not
        binned again (reference: ``Dataset.subset``, ``lightgbm_tpu/
        basic.py:237-307``; LGBM_DatasetGetSubset): the rows sorted and
        unique, their label, weight, init score, positions and raw rows;
        ranking queries kept whole, else a ``ValueError``."""
        self.construct()
        idx = np.unique(np.asarray(used_indices, np.int64).reshape(-1))
        inner = self._inner
        sub = Dataset(None, reference=self, feature_name=self.feature_name,
                      categorical_feature=self.categorical_feature,
                      params=params or self.params,
                      free_raw_data=self.free_raw_data)
        sub.used_indices = idx
        si = BinnedDataset()
        for name in ("bundle_info", "mappers", "feature_names",
                     "max_num_bins", "num_total_features", "used_features",
                     "categorical_features"):
            setattr(si, name, getattr(inner, name))
        si.binned = inner.binned[idx]
        si.num_data = len(idx)
        if inner.raw_data is not None:
            si.raw_data = inner.raw_data[idx]
        src = inner.metadata
        md = si.metadata = Metadata(len(idx))
        if src.label is not None:
            md.set_label(src.label[idx])
        md.set_weight(None if src.weight is None else src.weight[idx])
        if src.init_score is not None:
            # class-major [K * N]
            md.set_init_score(src.init_score.reshape(
                -1, src.num_data)[:, idx].reshape(-1))
        md.set_position(None if src.position is None else src.position[idx])
        if src.query_boundaries is not None:
            qb = src.query_boundaries
            sizes = np.bincount(np.searchsorted(qb, idx, side="right") - 1,
                                minlength=len(qb) - 1)
            partial = (sizes > 0) & (sizes != np.diff(qb))
            if partial.any():
                raise ValueError(
                    "Dataset.subset would split query groups "
                    f"{np.nonzero(partial)[0][:5].tolist()}...; ranking "
                    "subsets must select whole queries")
            md.set_group(sizes[sizes > 0])
        sub._inner = si
        return sub

    @read_locked
    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None, position=None
                     ) -> "Dataset":
        """A validation Dataset binned with this one's mappers (its own
        query groups for the ranking metrics; ``params``: its own, else
        this one's)."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params,
                       free_raw_data=self.free_raw_data, position=position)

    # -- fields, before or after construct (reference: the set_field
    # family, ``lightgbm_tpu/basic.py:318-400``) ----------------------------
    @write_locked
    def set_label(self, label) -> "Dataset":
        self.label = label
        if self._inner is not None:
            self._inner.metadata.set_label(_maybe_series(label))
        return self

    @write_locked
    def set_weight(self, weight) -> "Dataset":
        self.weight = weight
        if self._inner is not None:
            self._inner.metadata.set_weight(_maybe_series(weight))
        return self

    @write_locked
    def set_group(self, group) -> "Dataset":
        """Query sizes in row order (reference: Dataset.set_group)."""
        self.group = group
        if self._inner is not None:
            self._inner.metadata.set_group(_maybe_series(group))
        return self

    @write_locked
    def set_init_score(self, init_score) -> "Dataset":
        self.init_score = init_score
        if self._inner is not None:
            self._inner.metadata.set_init_score(_maybe_series(init_score))
        return self

    @write_locked
    def set_position(self, position) -> "Dataset":
        self.position = position
        if self._inner is not None:
            self._inner.metadata.set_position(_maybe_series(position))
        return self

    @read_locked
    def get_field(self, name: str):
        getter = {"label": self.get_label, "weight": self.get_weight,
                  "group": self.get_group, "init_score": self.get_init_score}
        if name not in getter:
            raise KeyError(name)
        return getter[name]()

    @write_locked
    def set_field(self, name: str, value) -> "Dataset":
        setter = {"label": self.set_label, "weight": self.set_weight,
                  "group": self.set_group, "init_score": self.set_init_score,
                  "position": self.set_position}
        if name not in setter:
            raise KeyError(name)
        return setter[name](value)

    @write_locked
    def save_binary(self, filename: str) -> "Dataset":
        """Write the constructed Dataset to a binary file, which ``Dataset(
        filename)`` (or the JAX package's) loads without binning again."""
        self.construct()
        self._inner.save_binary(filename)
        return self

    @write_locked
    def get_feature_name(self) -> List[str]:
        self.construct()
        return list(self._inner.feature_names)

    @read_locked
    def get_label(self):
        if self._inner is not None and self._inner.metadata.label is not None:
            return self._inner.metadata.label
        return self.label

    @read_locked
    def get_group(self):
        if self._inner is not None:
            return self._inner.metadata.group
        return self.group

    @read_locked
    def get_weight(self):
        if self._inner is not None:
            return self._inner.metadata.weight
        return self.weight

    @read_locked
    def get_init_score(self):
        if self._inner is not None:
            return self._inner.metadata.init_score
        return self.init_score

    @read_locked
    def num_data(self) -> int:
        if self._inner is not None:
            return self._inner.num_data
        return int(np.asarray(self.data).shape[0])

    @read_locked
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
        # predictions share it, training and every change to the model
        # hold it alone (utils/rwlock.py; reference: basic.py:29, :85-87):
        # a checkpoint never sees a half-applied iteration, a served model
        # never a half-trained one
        self._api_lock = RWLock()
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
        self._api_lock = RWLock()
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

    @write_locked
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

    @write_locked
    def update(self, train_set: Optional[Dataset] = None,
               fobj: Optional[Callable] = None) -> bool:
        """One boosting iteration; True if no further split was possible
        (reference: Booster.update, basic.py:4092). ``fobj(preds,
        train_set) -> (grad, hess)``: a custom objective, given the raw
        scores (``[n, K]`` for K trees an iteration) and returning the
        gradients in the dataset's row order. A model loaded from text
        has no training state, as in the JAX package. With
        ``deterministic=True`` the iteration runs with PyTorch's
        deterministic algorithms on (``ops/determinism.py``), the setting
        before it restored after it."""
        if train_set is not None:
            raise NotImplementedError(
                "changing train_set on update is not supported")
        fobj = fobj or self._custom_objective
        with deterministic_algorithms(
                getattr(self._gbdt, "deterministic", False)):
            if fobj is None:
                return self._gbdt.train_one_iter()
            grad, hess = _call_custom_objective(fobj, self)
            return self._gbdt.train_one_iter(grad, hess)

    # -- checkpoint / resume (io/checkpoint.py) ------------------------------
    def _capture_checkpoint(self, callback_states: Optional[Dict] = None
                            ) -> Dict[str, Any]:
        """The complete training state (reference: ``_capture_checkpoint``,
        ``lightgbm_tpu/basic.py:722-730``): the trainer's, the booster's
        early-stopping bests and the engine's callback states."""
        state = self._gbdt.capture_training_state()
        state["best_iteration"] = int(self.best_iteration)
        state["best_score"] = copy.deepcopy(self.best_score)
        if callback_states:
            state["callbacks"] = callback_states
        return state

    @read_locked
    def save_checkpoint(self, directory: str, keep: int = 3,
                        callback_states: Optional[Dict] = None) -> str:
        """Write an atomic training snapshot into ``directory`` (write-
        temp-fsync-rename, a checksum, keep-last-``keep`` rotation;
        ``io/checkpoint.py``) and return its path (reference:
        ``save_checkpoint``, ``lightgbm_tpu/basic.py:732-751``). The state
        is captured under the read side of the booster's lock, so never
        inside an ``update``."""
        from .io.checkpoint import write_snapshot
        state = self._capture_checkpoint(callback_states)
        return write_snapshot(directory, int(state["iteration"]), state,
                              keep=keep)

    @write_locked
    def _restore_checkpoint(self, state: Dict[str, Any],
                            callbacks=None) -> None:
        """Rebind this booster to a snapshot; raises ``ValueError`` when it
        cannot resume this run (reference: ``_restore_checkpoint``,
        ``lightgbm_tpu/basic.py:753-771``)."""
        reason = self._gbdt.snapshot_compatible(state)
        if reason is not None:
            raise ValueError(reason)
        self._gbdt.restore_training_state(state)
        self.best_iteration = int(state.get("best_iteration", -1))
        self.best_score = state.get("best_score", {}) or {}
        saved = state.get("callbacks") or {}
        for cb in callbacks or ():
            key = getattr(cb, "_ckpt_key", None)
            cb_state = getattr(cb, "state", None)
            if key and key in saved and isinstance(cb_state, dict):
                cb_state.clear()
                cb_state.update(copy.deepcopy(saved[key]))

    @write_locked
    def rollback_one_iter(self) -> "Booster":
        """Remove the last iteration's trees (reference:
        Booster.rollback_one_iter)."""
        self._gbdt.rollback_one_iter()
        return self

    @write_locked
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

    @write_locked
    def eval_train(self, feval=None):
        out = [(self._train_data_name, m, v, hb)
               for (_, m, v, hb) in self._gbdt.eval_train()]
        if feval is not None:
            out.extend(self._eval_custom(feval, self._train_data_name,
                                         None))
        return out

    @write_locked
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

    @read_locked
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, validate_features: bool = False,
                **kwargs) -> np.ndarray:
        """Predictions ``[N]``, or ``[N, K]`` for a model of K classes:
        the objective's output (probabilities for the classifiers), or raw
        scores with ``raw_score`` (reference: Booster.predict,
        ``lightgbm_tpu/basic.py:822-866``). ``pred_leaf``: leaf indices
        ``[N, T]`` int32 of the window's trees; ``pred_contrib``: TreeSHAP
        contributions ``[N, K*(F+1)]`` float64, each class's bias last.
        ``pred_early_stop``, ``pred_early_stop_margin`` and
        ``pred_early_stop_freq`` override the parameters of the same
        names. ``validate_features`` is accepted as the JAX package accepts
        it (``lightgbm_tpu/basic.py:831``): rows of another width than the
        model's raise with it or without it."""
        unknown = sorted(set(kwargs) - set(_EARLY_STOP_KEYS))
        if unknown:
            raise TypeError(f"predict got unexpected arguments {unknown}")
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

    # -- serving (reference: ``lightgbm_tpu/basic.py:869-1223``) -----------
    def _device_serving_inner(self):
        """The trained GBDT behind the serving path, or a
        ``NotImplementedError`` naming why this booster cannot take it: a
        model loaded from text and a continued booster's loaded base
        predict on the host (ROADMAP A10c, A10e), and linear leaves on raw
        values (``predict``)."""
        inner = self._gbdt
        if isinstance(inner, LoadedGBDT) or not hasattr(inner,
                                                        "predict_raw_device"):
            raise NotImplementedError(
                "device serving needs a trained booster (models loaded "
                "from text predict on the host, ROADMAP A10c); use "
                "predict()")
        if self._pre_model is not None:
            raise NotImplementedError(
                "device serving does not take continued boosters (the "
                "loaded base predicts on the host, ROADMAP A10e); use "
                "predict()")
        if getattr(inner, "_linear", False):
            raise NotImplementedError(
                "device serving does not take linear_tree models (their "
                "leaves read raw values on the host); use predict()")
        return inner

    @read_locked
    def predict_device(self, data, start_iteration: int = 0,
                       num_iteration: Optional[int] = None) -> torch.Tensor:
        """Raw scores left on the device (reference: ``predict_device``,
        ``lightgbm_tpu/basic.py:869-905``): ``[N]``, or ``[N, K]`` for K
        classes, a tensor on the booster's device. The rows are binned on
        the host and padded to their ladder rung; above the ladder they
        run in slices of its top rung, joined on the device."""
        inner = self._device_serving_inner()
        start_iteration, num_iteration = self._predict_window(
            start_iteration, num_iteration)
        arr = np.asarray(_maybe_series(data), dtype=np.float64)
        raw = inner.predict_raw_rows(inner.bin_matrix(arr), num_iteration,
                                     start_iteration)
        if inner.average_output:
            raw = raw / inner.window_divisor(num_iteration, start_iteration)
        return raw[0] if raw.shape[0] == 1 else raw.T

    def _serving_request(self, data, start_iteration: int,
                         num_iteration: Optional[int]):
        """``(inner, start, num, rows as float32, n)``: every serving
        endpoint's preamble. float32 is the serving wire format in both
        featurize modes, so ``tpu_serve_featurize`` never changes a
        response."""
        inner = self._device_serving_inner()
        start_iteration, num_iteration = self._predict_window(
            start_iteration, num_iteration)
        arr = np.asarray(_maybe_series(data), dtype=np.float32)
        if arr.ndim == 1:
            arr = arr.reshape(1, -1)
        return inner, start_iteration, num_iteration, arr, arr.shape[0]

    @staticmethod
    def _serving_binned(inner, arr32: np.ndarray):
        """A batch's bins: the device featurizer's, at the rung (default),
        or the host's ``bin_matrix`` (``tpu_serve_featurize=host``), which
        the GBDT pads and uploads."""
        if inner._serve_featurize_mode() == "device":
            return inner.featurize_rung(arr32)
        return inner.bin_matrix(arr32)

    @read_locked
    def predict_serving(self, data, raw_score: bool = False,
                        start_iteration: int = 0,
                        num_iteration: Optional[int] = None, observe=None):
        """One serving batch: ``(scores at the rung on the host, n)``
        (reference: ``predict_serving``, ``lightgbm_tpu/basic.py:
        1022-1082``). Rows ``[:n]`` equal ``predict(float32(data))`` bit
        for bit: routing, the sums and the objective's conversion are per
        row. The batch pads to its ladder rung on the host and goes up in
        one copy; nothing on the device has a shape that depends on the
        request, and the caller slices its rows on the host. Honors the
        prediction window's parameters and ``pred_early_stop``.
        ``observe``: a drift monitor, whose device accumulates are queued
        after the response's copy to the host."""
        inner, start_iteration, num_iteration, arr, n = \
            self._serving_request(data, start_iteration, num_iteration)
        early = self._predict_early_stop({})
        binned = self._serving_binned(inner, arr)
        raw_dev = inner.predict_raw_device(
            binned, num_iteration, start_iteration, early_stop=early,
            device_packed=inner._pred_pack4)
        raw = raw_dev.cpu().numpy()
        if observe is not None:
            observe.observe_binned(binned, n)
            observe.observe_scores(raw_dev, n)
        if inner.average_output:
            raw = raw / inner.window_divisor(num_iteration, start_iteration)
        out = raw[0] if raw.shape[0] == 1 else raw.T
        if raw_score or inner.objective is None:
            return out, n
        return np.asarray(inner.objective.convert_output(out)), n

    @read_locked
    def predict_leaf_serving(self, data, start_iteration: int = 0,
                             num_iteration: Optional[int] = None,
                             observe=None):
        """One ``pred_leaf`` serving batch: ``(leaf indices [rung, T]
        int32, n)``, rows ``[:n]`` equal to ``predict(float32(data),
        pred_leaf=True)``."""
        inner, start_iteration, num_iteration, arr, n = \
            self._serving_request(data, start_iteration, num_iteration)
        binned = self._serving_binned(inner, arr)
        out = inner.predict_leaf_padded(binned, num_iteration,
                                        start_iteration,
                                        device_packed=inner._pred_pack4)
        if observe is not None:
            observe.observe_binned(binned, n)
        return out, n

    @read_locked
    def predict_contrib_serving(self, data, start_iteration: int = 0,
                                num_iteration: Optional[int] = None,
                                observe=None):
        """One ``pred_contrib`` serving batch: ``(contributions [rung,
        K*(F+1)] float64, n)`` through the tabled TreeSHAP where its
        tables fit ``tpu_shap_table_mb`` (else the loop kernel), rows
        ``[:n]`` within 1e-12 of a cell's scale of ``predict(float32(data),
        pred_contrib=True)``."""
        inner, start_iteration, num_iteration, arr, n = \
            self._serving_request(data, start_iteration, num_iteration)
        binned = self._serving_binned(inner, arr)
        out = inner.predict_contrib_padded(binned, num_iteration,
                                           start_iteration,
                                           device_packed=inner._pred_pack4)
        if observe is not None:
            observe.observe_binned(binned, n)
        return out, n

    def _serve_endpoints(self) -> tuple:
        """``tpu_serve_endpoints``: the request kinds this booster's
        servers warm and accept; ``predict`` always."""
        raw = str(self._gbdt.config.get("tpu_serve_endpoints", "predict")
                  or "predict")
        eps = {e.strip().lower() for e in raw.split(",") if e.strip()}
        unknown = eps - {"predict", "leaf", "contrib"}
        if unknown:
            log.warning(f"unknown tpu_serve_endpoints {sorted(unknown)}; "
                        "valid: predict, leaf, contrib")
            eps -= unknown
        eps.add("predict")
        return tuple(sorted(eps))

    @read_locked
    def warm_predict_ladder(self, max_rows: Optional[int] = None,
                            start_iteration: int = 0,
                            num_iteration: Optional[int] = None
                            ) -> Dict[str, Any]:
        """Run one request of zeros a rung through each endpoint of
        ``tpu_serve_endpoints`` (reference: ``warm_predict_ladder``,
        ``lightgbm_tpu/basic.py:1138-1211``), so that a server builds its
        caches (the window's device trees, level heaps, quantized slab,
        TreeSHAP paths and tables, featurizer state) before it takes
        traffic and a hot-swap candidate before it commits. Returns
        ``rungs``, ``endpoints`` and ``seconds``. The JAX package also
        reports ``lowerings``, ``backend_compiles`` and ``cache``: XLA's
        compiles, which PyTorch's eager kernels do not have, so they are
        left out rather than reported as 0. ``max_rows`` caps the rungs
        (``tpu_serve_warm_max_rows``); ``scan`` warms nothing."""
        from .analysis.faultinject import active_plan
        from .ops.predict import parse_bucket_ladder, warmup_rungs
        inner = self._device_serving_inner()
        cfg = inner.config
        if str(cfg.get("tpu_predict_engine", "batched")).lower() == "scan":
            return {"rungs": [], "seconds": 0.0,
                    "skipped": "tpu_predict_engine=scan runs each request "
                               "on its own shape"}
        if max_rows is None:
            max_rows = int(cfg.get("tpu_serve_warm_max_rows", 0) or 0)
        rungs = warmup_rungs(parse_bucket_ladder(
            cfg.get("tpu_predict_buckets", "auto")), max_rows)
        endpoints = self._serve_endpoints()
        plan = active_plan(cfg)
        n_feat = len(inner.mappers)
        t0 = time.perf_counter()
        for rung in rungs:
            plan.fire("warmup", rung=rung)
            dummy = np.zeros((rung, n_feat), np.float32)
            window = dict(start_iteration=start_iteration,
                          num_iteration=num_iteration)
            self.predict_serving(dummy, **window)
            if "leaf" in endpoints:
                self.predict_leaf_serving(dummy, **window)
            if "contrib" in endpoints:
                self.predict_contrib_serving(dummy, **window)
        return {"rungs": list(rungs), "endpoints": list(endpoints),
                "seconds": round(time.perf_counter() - t0, 3)}

    @read_locked
    def serve(self, **kwargs):
        """A ``serving.PredictionServer`` on this booster: micro-batches
        over the ladder, bounded admission, deadlines and a model registry
        for hot swaps. Keyword arguments override the ``tpu_serve_*``
        parameters (``tick_ms``, ``queue_max``, ``deadline_ms``,
        ``warm_max_rows``, ``warm``, ``version``, ``raw_score``); the
        Prometheus endpoint (``metrics_port``) is ROADMAP A19."""
        from .serving import PredictionServer
        return PredictionServer(self, **kwargs)

    @read_locked
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

    @read_locked
    def current_iteration(self) -> int:
        pre = self._pre_model
        return self._gbdt.current_iteration() + (
            pre.current_iteration() if pre is not None else 0)

    @read_locked
    def num_trees(self) -> int:
        pre = self._pre_model
        return len(self._gbdt.models) + (
            len(pre.models) if pre is not None else 0)

    @read_locked
    def num_model_per_iteration(self) -> int:
        """Trees an iteration: K for K classes, else 1."""
        return self._gbdt.num_class

    @read_locked
    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """Splits (or gains) per feature over the trees of the first
        ``iteration`` iterations (None or <= 0: all), the loaded model's
        first (reference: Booster.feature_importance)."""
        (pre, _, pre_cut, _, own_cut, pre_empty,
         own_empty) = self._global_tree_window(
             0, iteration if iteration and iteration > 0 else None)
        imp = (self._gbdt.feature_importance(importance_type, own_cut)
               if not own_empty else np.zeros(self.num_feature()))
        if pre is not None and not pre_empty:
            pre_imp = pre.feature_importance(importance_type, pre_cut)
            out = np.zeros(max(len(imp), len(pre_imp)), np.float64)
            out[:len(imp)] += imp
            out[:len(pre_imp)] += pre_imp
            return out
        return imp

    @read_locked
    def num_feature(self) -> int:
        return self._gbdt.num_features()

    @read_locked
    def feature_name(self) -> List[str]:
        return list(self._gbdt.feature_names)

    def _leaf_values(self):
        """Each tree's leaf values, the loaded model's and the own."""
        pre = self._pre_model
        models = list(self._gbdt.models) + (list(pre.models)
                                            if pre is not None else [])
        return [m.leaf_value[:m.num_leaves] for m in models]

    @read_locked
    def lower_bound(self) -> float:
        """The smallest leaf value of any tree (reference: ``lower_bound``,
        ``lightgbm_tpu/basic.py:1388``)."""
        return float(min((v.min() for v in self._leaf_values()),
                         default=0.0))

    @read_locked
    def upper_bound(self) -> float:
        """The largest leaf value of any tree."""
        return float(max((v.max() for v in self._leaf_values()),
                         default=0.0))

    # -- model text (reference: Booster.save_model, model_to_string and
    # dump_model of python-package/lightgbm/basic.py) -------------------------
    @read_locked
    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0,
                        importance_type: str = "split") -> str:
        """The model as LightGBM v4 text: the trees of ``num_iteration``
        iterations from ``start_iteration`` (default: to the best iteration
        of an early-stopped run, else all), numbered from 0, and the
        ``importance_type`` importances (``split`` or ``gain``) of the
        first ``num_iteration`` iterations, as LightGBM's
        SaveModelToString counts them whatever ``start_iteration`` is; a
        loaded model's whole text is the text it was read from."""
        if num_iteration is None and self.best_iteration > 0:
            num_iteration = self.best_iteration
        if num_iteration is not None and num_iteration <= 0:
            num_iteration = None
        pre = self._pre_model
        if pre is None:
            return booster_to_string(self, num_iteration, start_iteration,
                                     importance_type)
        # the loaded trees first (reference: models_ holds loaded, then new
        # trees, gbdt_model_text.cpp)
        (_, pre_start, pre_cut, own_start, own_cut, pre_empty,
         _) = self._global_tree_window(start_iteration, num_iteration)
        return merge_model_texts(
            pre, booster_to_string(self, own_cut, own_start),
            pre_num_iteration=0 if pre_empty else pre_cut,
            pre_start_iteration=pre_start, importance_type=importance_type,
            importance=self.feature_importance(importance_type,
                                               num_iteration))

    @read_locked
    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> "Booster":
        with open(filename, "w") as fh:
            fh.write(self.model_to_string(num_iteration, start_iteration,
                                          importance_type))
        return self

    @read_locked
    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0,
                   importance_type: str = "split") -> Dict[str, Any]:
        """The model as a JSON-ready dict (reference: GBDT::DumpModel), the
        trees of an iteration window. A continued booster dumps its merged
        model text, the loaded trees first, as the reference does
        (``lightgbm_tpu/basic.py:1323-1332``: the text round trip is exact
        for the loaded trees). ``importance_type`` is checked and, as in
        the JAX package's dict, not written."""
        check_importance_type(importance_type)
        if self._pre_model is not None:
            return loaded_dump(LoadedGBDT(self.model_to_string(
                num_iteration, start_iteration)))
        return booster_to_dict(self, num_iteration, start_iteration)


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
