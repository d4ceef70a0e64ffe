"""Training callbacks.

Copy of ``log_evaluation`` and ``record_evaluation`` from
``lightgbm_tpu/callback.py`` (reference: python-package/lightgbm/callback.py
— log_evaluation :75, record_evaluation :183, CallbackEnv :60). Evaluation
entries are ``(dataset_name, metric_name, value, is_higher_better)``.
Early stopping and ``reset_parameter`` are ROADMAP A8.
"""
from __future__ import annotations

import collections
from typing import Callable, Dict

from .utils import log

CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"],
)


def _fmt_eval(entry) -> str:
    name, metric, value, _ = entry
    return f"{name}'s {metric}: {value:g}"


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """(reference: callback.py:75)"""

    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list \
                and (env.iteration + 1) % period == 0:
            result = "\t".join(_fmt_eval(e) for e in env.evaluation_result_list)
            log.info(f"[{env.iteration + 1}]\t{result}")

    _callback.order = 10
    return _callback


def record_evaluation(eval_result: Dict) -> Callable:
    """(reference: callback.py:183)"""
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result should be a dictionary")

    def _init(env: CallbackEnv) -> None:
        eval_result.clear()
        for name, metric, _, _ in env.evaluation_result_list:
            eval_result.setdefault(name, collections.OrderedDict())
            eval_result[name].setdefault(metric, [])

    def _callback(env: CallbackEnv) -> None:
        if not eval_result:
            _init(env)
        for name, metric, value, _ in env.evaluation_result_list:
            eval_result.setdefault(name, collections.OrderedDict())
            eval_result[name].setdefault(metric, [])
            eval_result[name][metric].append(value)

    _callback.order = 20
    return _callback
