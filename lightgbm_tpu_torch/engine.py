"""Training entry point ``train()``.

Counterpart of ``train`` in ``lightgbm_tpu/engine.py`` (reference:
python-package/lightgbm/engine.py:109): build the Booster, continue a
loaded model (``init_model`` or the ``input_model`` parameter), attach the
validation sets, run ``num_boost_round`` updates with the callbacks before
and after each (early stopping from ``early_stopping_round``), evaluate
custom metrics (``feval``), and record ``best_iteration`` and
``best_score``. ``cv`` and checkpoints are ROADMAP A16.
"""
from __future__ import annotations

import collections
import copy
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from . import callback as callback_mod
from .basic import Booster, Dataset
from .config import Config, alias_table
from .model_io import LoadedGBDT
from .utils import log


def _setup_callbacks(params: Dict[str, Any],
                     callbacks: Optional[Sequence[Callable]]):
    """The run's callbacks, with early stopping added from
    ``early_stopping_round``, split into those before and after an
    iteration and sorted by ``order`` (reference: ``_setup_callbacks``,
    ``lightgbm_tpu/engine.py:22-43``)."""
    cbs = set(callbacks) if callbacks else set()
    cfg = Config(params)
    if int(cfg.early_stopping_round or 0) > 0:
        cbs.add(callback_mod.early_stopping(
            int(cfg.early_stopping_round), bool(cfg.first_metric_only),
            min_delta=float(cfg.early_stopping_min_delta)))

    def order(cb):
        return getattr(cb, "order", 0)
    before = sorted((cb for cb in cbs
                     if getattr(cb, "before_iteration", False)), key=order)
    after = sorted((cb for cb in cbs
                    if not getattr(cb, "before_iteration", False)), key=order)
    return before, after


def _load_init_model(init_model) -> Optional[LoadedGBDT]:
    """The model a run continues: a model file's path or a Booster."""
    if init_model is None:
        return None
    if isinstance(init_model, str):
        with open(init_model) as fh:
            return LoadedGBDT(fh.read())
    return LoadedGBDT(init_model.model_to_string())


def _raw_data(data: Dataset, what: str) -> np.ndarray:
    if data.data is None:
        raise ValueError(
            f"continued training needs the {what} Dataset's raw data to "
            "score the loaded model; construct it with free_raw_data=False")
    return np.asarray(data.data)


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[Sequence[Dataset]] = None,
          valid_names: Optional[Sequence[str]] = None,
          feval: Optional[Union[Callable, Sequence[Callable]]] = None,
          init_model: Optional[Union[str, Booster]] = None,
          keep_training_booster: bool = False,
          callbacks: Optional[Sequence[Callable]] = None) -> Booster:
    """Train a booster (reference: engine.py:109). ``feval(preds, data)``
    returns ``(name, value, higher_better)`` or a list of them, on raw
    scores. ``init_model``: a model file or Booster whose trees the new
    ones continue; its raw predictions (on the host, in float64) seed the
    train and validation scores, so those Datasets need their raw data."""
    params = copy.deepcopy(params) if params else {}
    at = alias_table()
    for key in list(params.keys()):
        if at.get(key) == "num_iterations" and params[key] is not None:
            num_boost_round = int(params.pop(key))
    params["num_iterations"] = num_boost_round
    if init_model is None:
        init_model = Config(params).input_model or None
    pre_model = _load_init_model(init_model)
    pre_train_raw = (pre_model.predict_raw_matrix(_raw_data(train_set,
                                                            "training"))
                     if pre_model is not None else None)

    booster = Booster(params=params, train_set=train_set)
    if pre_model is not None:
        booster._attach_pre_model(pre_model, pre_train_raw)
    is_valid_contain_train = False
    if valid_sets is not None:
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        for i, valid_data in enumerate(valid_sets):
            name = (valid_names[i] if valid_names is not None
                    and len(valid_names) > i else f"valid_{i}")
            if valid_data is train_set:
                is_valid_contain_train = True
                booster._train_data_name = name
                continue
            pre_raw = (pre_model.predict_raw_matrix(_raw_data(valid_data,
                                                              "validation"))
                       if pre_model is not None else None)
            booster.add_valid(valid_data, name)
            if pre_raw is not None:
                booster._seed_valid_scores(-1, pre_raw)

    cbs_before, cbs_after = _setup_callbacks(params, callbacks)
    evaluation_result_list: List = []
    for i in range(num_boost_round):
        for cb in cbs_before:
            cb(callback_mod.CallbackEnv(
                model=booster, params=params, iteration=i,
                begin_iteration=0, end_iteration=num_boost_round,
                evaluation_result_list=None))
        finished = booster.update()
        evaluation_result_list = []
        if (valid_sets is not None and (booster._valid_names
                                        or is_valid_contain_train)) \
                or feval is not None:
            if is_valid_contain_train:
                evaluation_result_list.extend(booster.eval_train(feval))
            evaluation_result_list.extend(booster.eval_valid(feval))
        try:
            for cb in cbs_after:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=evaluation_result_list))
        except callback_mod.EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            evaluation_result_list = e.best_score or []
            break
        if finished:
            log.info("Finished training (no further splits possible)")
            break
    if evaluation_result_list:
        best: Dict[str, Dict[str, float]] = collections.OrderedDict()
        for name, metric, value, _ in evaluation_result_list:
            best.setdefault(name, collections.OrderedDict())[metric] = value
        booster.best_score = best
    return booster
