"""Training entry point ``train()``.

Counterpart of ``train`` in ``lightgbm_tpu/engine.py`` (reference:
python-package/lightgbm/engine.py:109): build the Booster, attach the
validation sets, run ``num_boost_round`` updates and the callbacks after
each. ``cv``, ``feval``, ``init_model`` and checkpoints are ROADMAP A8/A16.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Sequence

from . import callback as callback_mod
from .basic import Booster, Dataset
from .config import alias_table
from .utils import log


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[Sequence[Dataset]] = None,
          valid_names: Optional[Sequence[str]] = None,
          feval=None, init_model=None, keep_training_booster: bool = False,
          callbacks: Optional[Sequence[Callable]] = None) -> Booster:
    """Train a booster (reference: engine.py:109)."""
    if feval is not None or init_model is not None:
        raise NotImplementedError(
            "feval and init_model are not in the PyTorch port yet "
            "(ROADMAP A8)")
    params = copy.deepcopy(params) if params else {}
    at = alias_table()
    for key in list(params.keys()):
        if at.get(key) == "num_iterations" and params[key] is not None:
            num_boost_round = int(params.pop(key))
    params["num_iterations"] = num_boost_round

    booster = Booster(params=params, train_set=train_set)
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
            booster.add_valid(valid_data, name)

    cbs = sorted(callbacks or [], key=lambda cb: getattr(cb, "order", 0))
    for i in range(num_boost_round):
        finished = booster.update()
        results = []
        if is_valid_contain_train:
            results.extend(booster.eval_train())
        results.extend(booster.eval_valid())
        for cb in cbs:
            cb(callback_mod.CallbackEnv(
                model=booster, params=params, iteration=i,
                begin_iteration=0, end_iteration=num_boost_round,
                evaluation_result_list=results))
        if finished:
            log.info("Finished training (no further splits possible)")
            break
    return booster
