"""User-facing ``Dataset`` and ``Booster``.

Counterpart of ``lightgbm_tpu/basic.py`` (reference:
python-package/lightgbm/basic.py): a lazily constructed ``Dataset`` and a
``Booster`` with ``update``, ``predict``, ``eval_train``/``eval_valid``,
``current_iteration`` and model text (``save_model``, ``model_to_string``,
``dump_model``; ``Booster(model_file=...)`` / ``Booster(model_str=...)``
loads text written by the port, the JAX package or stock LightGBM, and
predicts on the host, see ``model_io.py``). The device comes from the
``device_type`` parameter (default ``cuda``; ``cpu`` runs the plain PyTorch
versions of the kernels) and is never chosen silently: ``cuda`` without a
visible card raises.

Not here yet: ``cv``, refit, custom objectives and metrics, continued
training, sklearn and the CLI (ROADMAP A8, A16).
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np

from .config import Config, alias_table, resolve_device
from .io.dataset import BinnedDataset
from .metrics import create_metrics
from .model_io import booster_to_dict, booster_to_string, load_booster
from .objectives import create_objective

_DATASET_PARAM_KEYS = ("max_bin", "min_data_in_bin", "bin_construct_sample_cnt",
                       "use_missing", "zero_as_missing", "data_random_seed",
                       "max_bin_by_feature", "device_type", "enable_bundle",
                       "max_conflict_rate", "categorical_feature",
                       "forcedbins_filename", "tpu_bin_pack4")


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
        self._inner = BinnedDataset.construct(
            self.data,
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
        )
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
        from .boosting import create_boosting
        self._gbdt = create_boosting(
            self.config, train_set._inner,
            create_objective(self.config.objective, self.config),
            self.device)
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
        return self

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
               fobj=None) -> bool:
        """One boosting iteration; True if no further split was possible
        (reference: Booster.update, basic.py:4092)."""
        if train_set is not None or fobj is not None \
                or self.train_set is None:
            raise NotImplementedError(
                "update(train_set=..., fobj=...) and training a loaded model "
                "further are not in the PyTorch port yet (ROADMAP A8)")
        return self._gbdt.train_one_iter()

    def eval_train(self):
        return [(self._train_data_name, m, v, hb)
                for (_, m, v, hb) in self._gbdt.eval_train()]

    def eval_valid(self):
        return self._gbdt.eval_valid()

    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        """Predictions ``[N]``, or ``[N, K]`` for a model of K classes:
        the objective's output (probabilities for the classifiers), or raw
        scores with ``raw_score`` (reference: Booster.predict,
        basic.py:4701)."""
        if pred_leaf or pred_contrib or kwargs:
            raise NotImplementedError(
                "pred_leaf, pred_contrib and prediction early stopping are "
                "not in the PyTorch port yet (ROADMAP A10, A17)")
        if num_iteration is None and self.best_iteration > 0:
            num_iteration = self.best_iteration
        arr = np.asarray(_maybe_series(data))
        raw = self._gbdt.predict_raw_matrix(arr, num_iteration,
                                            start_iteration)
        raw = raw[0] if raw.shape[0] == 1 else raw.T
        objective = self._gbdt.objective
        if raw_score or objective is None:
            return raw
        return np.asarray(objective.convert_output(raw))

    def current_iteration(self) -> int:
        return self._gbdt.current_iteration()

    def num_trees(self) -> int:
        return len(self._gbdt.models)

    def num_feature(self) -> int:
        return self._gbdt.num_features()

    # -- model text (reference: Booster.save_model, model_to_string and
    # dump_model of python-package/lightgbm/basic.py) -------------------------
    def model_to_string(self, num_iteration: Optional[int] = None) -> str:
        """The model as LightGBM v4 text (all trees unless
        ``num_iteration``); a loaded model returns its text as read."""
        if num_iteration is None and self.best_iteration > 0:
            num_iteration = self.best_iteration
        return booster_to_string(self, num_iteration)

    def save_model(self, filename: str,
                   num_iteration: Optional[int] = None) -> "Booster":
        with open(filename, "w") as fh:
            fh.write(self.model_to_string(num_iteration))
        return self

    def dump_model(self, num_iteration: Optional[int] = None
                   ) -> Dict[str, Any]:
        """The model as a JSON-ready dict (reference: GBDT::DumpModel)."""
        return booster_to_dict(self, num_iteration)
