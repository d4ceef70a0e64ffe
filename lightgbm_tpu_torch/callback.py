"""Training callbacks.

Copy of ``lightgbm_tpu/callback.py`` (reference:
python-package/lightgbm/callback.py — log_evaluation :75, record_evaluation
:183, reset_parameter :237, early_stopping :454, CallbackEnv :60,
EarlyStopException :28). Evaluation entries are ``(dataset_name,
metric_name, value, is_higher_better)``. A callback with
``before_iteration`` set runs before the iteration's update, the others
after it, each group in ``order``. ``cv`` hands the callbacks its fold
means as ``("cv_agg", "<dataset> <metric>", mean, is_higher_better)``.
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


class EarlyStopException(Exception):
    """Raised by ``early_stopping`` to end training (reference:
    callback.py:28)."""

    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


def _fmt_eval(entry) -> str:
    name, metric, value, _ = entry
    return f"{name}'s {metric}: {value:g}"


def log_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """Log the evaluation entries every ``period`` iterations, ``cv``'s
    fold means as ``cv_agg's valid auc: ...`` (reference: callback.py:75,
    ``lightgbm_tpu/callback.py:40-49``)."""

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


def reset_parameter(**kwargs) -> Callable:
    """Set parameters before each iteration: each value is a list (one
    entry an iteration) or a function of the iteration (reference:
    callback.py:237)."""

    def _callback(env: CallbackEnv) -> None:
        new_params = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(f"Length of list {key!r} has to equal "
                                     "to 'num_boost_round'.")
                new_params[key] = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_params[key] = value(env.iteration - env.begin_iteration)
            else:
                raise ValueError("Only list and callable values are "
                                 "supported as a mapping from boosting "
                                 "round index to new parameter value.")
        if new_params:
            env.model.reset_parameter(new_params)

    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True, min_delta: float = 0.0) -> Callable:
    """Stop when no validation metric has improved by more than
    ``min_delta`` for ``stopping_rounds`` iterations (only the first metric
    with ``first_metric_only``); raises ``EarlyStopException`` with the
    best iteration (0-based) and its evaluation list (reference:
    callback.py:454, ``lightgbm_tpu/callback.py:102-193``). The training
    data's entries are never watched: ``training``, and ``cv``'s
    ``train``-prefixed fold means."""
    if stopping_rounds <= 0:
        raise ValueError("stopping_rounds should be greater than zero.")
    # the bests live in a plain dict (``_callback.state``) that checkpoints
    # carry under ``_ckpt_key``, so a resumed run stops where an
    # uninterrupted one does (reference: lightgbm_tpu/callback.py:106-110)
    state = {"enabled": True}

    def _init(env: CallbackEnv) -> None:
        state["enabled"] = bool(env.evaluation_result_list)
        if not state["enabled"]:
            log.warning("Early stopping is not available without "
                        "validation data")
            return
        entries = env.evaluation_result_list
        state["higher_better"] = [bool(e[3]) for e in entries]
        state["best_score"] = [float("-inf") if e[3] else float("inf")
                               for e in entries]
        state["best_iter"] = [0] * len(entries)
        state["best_list"] = [None] * len(entries)

    def _improved(value: float, best: float, higher_better: bool) -> bool:
        return (value > best + min_delta if higher_better
                else value < best - min_delta)

    def _watched(entry) -> bool:
        name, metric = entry[0], entry[1]
        return name != "training" and not (
            name == "cv_agg" and metric.split(" ")[0] == "train")

    def _report(what: str, i: int) -> None:
        if verbose:
            log.info(f"{what}\n[{state['best_iter'][i] + 1}]\t"
                     + "\t".join(_fmt_eval(e)
                                 for e in state["best_list"][i]))

    def _callback(env: CallbackEnv) -> None:
        # a callback reused across train() calls starts afresh; a resumed
        # run starts past begin_iteration and keeps a restored state
        if env.iteration == env.begin_iteration or "best_score" not in state:
            _init(env)
        if not state["enabled"]:
            return
        entries = env.evaluation_result_list
        first_metric_seen = False
        for i, (name, metric, value, _) in enumerate(entries):
            if not _watched(entries[i]):
                continue
            if first_metric_only and first_metric_seen \
                    and metric != entries[0][1]:
                continue
            first_metric_seen = True
            if _improved(value, state["best_score"][i],
                         state["higher_better"][i]):
                state["best_score"][i] = value
                state["best_iter"][i] = env.iteration
                state["best_list"][i] = list(entries)
            elif env.iteration - state["best_iter"][i] >= stopping_rounds:
                _report("Early stopping, best iteration is:", i)
                raise EarlyStopException(state["best_iter"][i],
                                         state["best_list"][i])
        if env.iteration == env.end_iteration - 1:
            for i, entry in enumerate(entries):
                if not _watched(entry):
                    continue
                if state["best_list"][i] is not None:
                    _report("Did not meet early stopping. Best iteration "
                            "is:", i)
                raise EarlyStopException(state["best_iter"][i],
                                         state["best_list"][i])

    _callback.order = 30
    _callback.state = state
    _callback._ckpt_key = "early_stopping"
    return _callback
