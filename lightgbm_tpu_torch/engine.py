"""Training entry points ``train()`` and ``cv()``.

Counterpart of ``lightgbm_tpu/engine.py`` (reference:
python-package/lightgbm/engine.py — train :109, cv :611, CVBooster :354).
``train`` builds the Booster, continues a loaded model (``init_model`` or
the ``input_model`` parameter), attaches the validation sets, runs
``num_boost_round`` updates with the callbacks before and after each
(early stopping from ``early_stopping_round``), evaluates custom metrics
(``feval``), writes a model snapshot every ``snapshot_freq`` iterations
(``{output_model}.snapshot_iter_{i}``) and records ``best_iteration`` and
``best_score``. ``cv`` bins each fold anew from its raw rows, as the JAX
package does, and advances all folds one update at a time: the callbacks
see the fold means, so early stopping acts on them.

Fault tolerance (reference: ``lightgbm_tpu/engine.py:229-282``,
``:326-400``): with ``tpu_checkpoint_dir`` a run resumes from the newest
valid snapshot there (an incompatible one is ignored with a warning) and
writes a full-state snapshot every ``tpu_checkpoint_freq`` iterations
(``io/checkpoint.py``, keep-last-``tpu_checkpoint_keep``); with
``tpu_collective_deadline_s`` each update runs under the step watchdog
(``parallel/multihost.py``), and a step that overruns writes a final
snapshot and raises ``TrainingInterrupted``. ``tpu_fault_spec`` arms
injected faults (``analysis/faultinject.py``: ``iteration``, ``step`` and
``snapshot`` fire here). The JAX package's multi-host agreement on the
resume point is ROADMAP A18, its flight recorder and metrics stream A19.
"""
from __future__ import annotations

import collections
import copy
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from . import callback as callback_mod
from .analysis.faultinject import active_plan
from .basic import Booster, Dataset
from .config import Config, alias_table
from .io import checkpoint as ckpt_mod
from .io.dataset import _to_2d_float
from .model_io import LoadedGBDT
from .parallel.multihost import TrainingInterrupted, run_with_deadline
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
    cfg = Config(params)
    snapshot_freq = int(cfg.snapshot_freq)

    # fault tolerance: full-state checkpoints and the step watchdog
    ckpt_dir = str(cfg.tpu_checkpoint_dir or "")
    ckpt_freq = int(cfg.tpu_checkpoint_freq or 0)
    ckpt_keep = int(cfg.tpu_checkpoint_keep)
    deadline = float(cfg.tpu_collective_deadline_s or 0.0)
    plan = active_plan(cfg)
    all_cbs = cbs_before + cbs_after

    def _callback_states():
        out = {}
        for cb in all_cbs:
            key = getattr(cb, "_ckpt_key", None)
            st = getattr(cb, "state", None)
            if key and isinstance(st, dict):
                out[key] = copy.deepcopy(st)
        return out

    def _write_checkpoint():
        booster.save_checkpoint(ckpt_dir, keep=ckpt_keep,
                                callback_states=_callback_states())

    start_iteration = 0
    if ckpt_dir:
        found = ckpt_mod.load_latest(ckpt_dir)
        if found is not None:
            try:
                booster._restore_checkpoint(found, callbacks=all_cbs)
                start_iteration = int(found["iteration"])
                log.info(f"Resuming from checkpoint at iteration "
                         f"{start_iteration} ({ckpt_dir})")
            except ValueError as err:
                log.warning(f"ignoring incompatible checkpoint in "
                            f"{ckpt_dir}: {err}")

    evaluation_result_list: List = []
    abandoned, began = threading.Event(), set()
    try:
        for i in range(start_iteration, num_boost_round):
            for cb in cbs_before:
                cb(callback_mod.CallbackEnv(
                    model=booster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=None))
            plan.fire("iteration", iteration=i)
            if deadline > 0:
                # the step watchdog: an overrunning step surfaces as
                # TrainingInterrupted, handled below with a final snapshot.
                # A step the watchdog gave up on before its update began
                # never begins it
                def _step(i=i):
                    plan.fire("step", iteration=i)
                    # the booster's write lock (update takes it again,
                    # re-entrant): the abandoned check and the update's
                    # start are one step for the final snapshot below
                    with booster._api_lock.write():
                        if abandoned.is_set():
                            return True
                        began.add(i)
                        return booster.update()
                finished = run_with_deadline(
                    _step, deadline, f"boosting iteration {i}")
            else:
                plan.fire("step", iteration=i)
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
            # model snapshots (reference: ``lightgbm_tpu/engine.py:364-
            # 367``; GBDT::Train, gbdt.cpp:250-254)
            if snapshot_freq > 0 and (i + 1) % snapshot_freq == 0:
                booster.save_model(
                    f"{cfg.output_model}.snapshot_iter_{i + 1}")
            # the checkpoint tick: the one planned device-to-host fetch
            # outside stop checks (atomic write, keep-last-k)
            if ckpt_dir and ckpt_freq > 0 and (i + 1) % ckpt_freq == 0:
                _write_checkpoint()
            if finished:
                log.info("Finished training (no further splits possible)")
                break
    except TrainingInterrupted as err:
        # a step overran its deadline: a best-effort final snapshot, then
        # the structured error. The abandoned step may still be inside its
        # update, so the snapshot takes the booster's write lock (waiting
        # one more deadline) and is written only if the update never
        # began: the state is then exactly that of iteration i's start.
        # Otherwise the last periodic snapshot stands. The write runs under
        # a deadline too (a hung step may still hold the device)
        abandoned.set()

        def _write_final():
            # the write side, waited for one deadline at most: a hung
            # update keeps it, and the snapshot is then skipped rather than
            # waited for (its read side nests in this write)
            if not booster._api_lock.acquire_write(timeout=deadline):
                raise TrainingInterrupted(
                    "the overrunning update still holds the booster",
                    deadline)
            try:
                if i in began:
                    raise TrainingInterrupted(
                        "the overrunning update finished after its "
                        "deadline")
                _write_checkpoint()
            finally:
                booster._api_lock.release_write()
        if ckpt_dir:
            try:
                run_with_deadline(_write_final, max(deadline, 30.0),
                                  "final interrupt snapshot")
                log.warning(f"training interrupted ({err}); final "
                            f"snapshot written to {ckpt_dir}")
            except BaseException as snap_err:  # noqa: BLE001 - best effort
                log.warning(f"training interrupted ({err}); final "
                            f"snapshot failed: {snap_err}")
        raise
    if evaluation_result_list:
        best: Dict[str, Dict[str, float]] = collections.OrderedDict()
        for name, metric, value, _ in evaluation_result_list:
            best.setdefault(name, collections.OrderedDict())[metric] = value
        booster.best_score = best
    return booster


class CVBooster:
    """The boosters of ``cv``'s folds (reference: engine.py:354,
    ``lightgbm_tpu/engine.py:429-444``): a method called on it is called on
    each fold's booster, its results in a list."""

    def __init__(self, boosters: Optional[List[Booster]] = None):
        self.boosters = boosters or []
        self.best_iteration = -1

    def append(self, booster: Booster) -> "CVBooster":
        self.boosters.append(booster)
        return self

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)

        def handler_function(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler_function


def _make_n_folds(num_data: int, nfold: int, seed: int, stratified: bool,
                  shuffle: bool, label: np.ndarray,
                  group: Optional[np.ndarray]) -> List[np.ndarray]:
    """Each fold's test rows, sorted (reference: ``_make_n_folds``,
    ``lightgbm_tpu/engine.py:447-479``): whole queries a fold for ranking
    data, each class's rows split over the folds when ``stratified``, else
    the rows; shuffled by ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    if group is not None:
        gidx = np.arange(len(group))
        if shuffle:
            rng.shuffle(gidx)
        bounds = np.concatenate([[0], np.cumsum(group)])
        return [np.sort(np.concatenate([np.arange(bounds[g], bounds[g + 1])
                                        for g in gf]))
                if len(gf) else np.zeros(0, np.int64)
                for gf in np.array_split(gidx, nfold)]
    if stratified:
        folds: List[List[np.ndarray]] = [[] for _ in range(nfold)]
        for cls in np.unique(label):
            idx = np.where(label == cls)[0]
            if shuffle:
                rng.shuffle(idx)
            for i, part in enumerate(np.array_split(idx, nfold)):
                folds[i].append(part)
        return [np.sort(np.concatenate(f)) for f in folds]
    idx = np.arange(num_data)
    if shuffle:
        rng.shuffle(idx)
    return [np.sort(f) for f in np.array_split(idx, nfold)]


def _query_sizes(group: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """The sizes of the queries that ``rows`` (sorted, whole queries)
    cover."""
    qid = np.searchsorted(np.concatenate([[0], np.cumsum(group)]), rows,
                          side="right") - 1
    return np.unique(qid, return_counts=True)[1]


def cv(params: Dict[str, Any], train_set: Dataset,
       num_boost_round: int = 100, folds=None, nfold: int = 5,
       stratified: bool = True, shuffle: bool = True,
       metrics: Optional[Union[str, Sequence[str]]] = None,
       feval: Optional[Union[Callable, Sequence[Callable]]] = None,
       init_model: Optional[Union[str, Booster]] = None, seed: int = 0,
       callbacks: Optional[Sequence[Callable]] = None,
       eval_train_metric: bool = False,
       return_cvbooster: bool = False) -> Dict[str, Any]:
    """K-fold cross-validation (reference: engine.py:611, ``cv``,
    ``lightgbm_tpu/engine.py:482-614``). ``folds``: ``(train, test)`` row
    index pairs, or an object whose ``split(X, y, groups)`` yields them;
    else ``nfold`` folds, stratified by class for the binary and
    multiclass objectives, whole queries a fold for ranking data. Each
    fold's training rows are binned anew from the raw rows (the Dataset
    needs them: ``free_raw_data=False``, or not yet constructed), its test
    rows with the fold's mappers. Returns ``{"<dataset> <metric>-mean":
    [...], "<dataset> <metric>-stdv": [...]}`` an iteration (``valid``, and
    ``train`` with ``eval_train_metric``), cut at the best iteration when
    early stopping acts on the fold means, and with ``return_cvbooster``
    the folds' boosters as ``"cvbooster"``. ``init_model`` and init scores
    on ``train_set`` raise (ROADMAP A16 (cv init): the JAX package's cv
    ignores both, so nothing holds them to a reference yet)."""
    if init_model is not None:
        raise NotImplementedError("cv(init_model=...) is not ported yet "
                                  "(ROADMAP A16 (cv init))")
    params = copy.deepcopy(params) if params else {}
    if metrics is not None:
        params["metric"] = metrics
    at = alias_table()
    for key in list(params.keys()):
        if at.get(key) == "num_iterations" and params[key] is not None:
            num_boost_round = int(params.pop(key))
    params["num_iterations"] = num_boost_round
    cfg = Config(params)
    if stratified and cfg.objective not in ("binary", "multiclass",
                                            "multiclassova"):
        stratified = False
    if train_set.data is None:
        raise ValueError("cv() needs the raw data; construct the Dataset "
                         "with free_raw_data=False or pass data directly")
    raw = _to_2d_float(train_set.data)
    label = np.asarray(train_set.get_label(), np.float64).reshape(-1)
    weight = train_set.get_weight()
    weight = None if weight is None else np.asarray(weight).reshape(-1)
    group = train_set.get_group()
    group = None if group is None else np.asarray(group, np.int64)
    if train_set.get_init_score() is not None:
        raise NotImplementedError("cv() of a Dataset with init scores is "
                                  "not ported yet (ROADMAP A16 (cv init))")
    num_data = len(raw)
    if folds is None:
        all_rows = np.arange(num_data)
        folds = [(np.setdiff1d(all_rows, te), te) for te in _make_n_folds(
            num_data, nfold, seed, stratified, shuffle, label, group)]
    elif hasattr(folds, "split"):
        qid = (None if group is None
               else np.repeat(np.arange(len(group)), group))
        folds = list(folds.split(raw, label, groups=qid))

    cvbooster = CVBooster()
    for tr, te in folds:
        tr, te = np.asarray(tr), np.asarray(te)
        dtr = Dataset(raw[tr], label=label[tr],
                      weight=None if weight is None else weight[tr],
                      group=None if group is None else _query_sizes(group,
                                                                    tr),
                      feature_name=train_set.feature_name,
                      categorical_feature=train_set.categorical_feature,
                      params=train_set.params)
        dtr._update_params(params)
        dte = dtr.create_valid(
            raw[te], label=label[te],
            weight=None if weight is None else weight[te],
            group=None if group is None else _query_sizes(group, te))
        bst = Booster(params=params, train_set=dtr)
        bst._train_data_name = "train"
        bst.add_valid(dte, "valid")
        cvbooster.append(bst)

    cbs_before, cbs_after = _setup_callbacks(params, callbacks)
    results: Dict[str, List[float]] = collections.OrderedDict()
    for i in range(num_boost_round):
        for cb in cbs_before:
            cb(callback_mod.CallbackEnv(
                model=cvbooster, params=params, iteration=i,
                begin_iteration=0, end_iteration=num_boost_round,
                evaluation_result_list=None))
        for bst in cvbooster.boosters:
            bst.update()
        merged: Dict = collections.OrderedDict()
        for bst in cvbooster.boosters:
            entries = bst.eval_train(feval) if eval_train_metric else []
            for name, metric, value, hib in entries + bst.eval_valid(feval):
                merged.setdefault((name, metric, hib), []).append(value)
        agg_list = []
        for (name, metric, hib), values in merged.items():
            key = f"{name} {metric}"
            mean = float(np.mean(values))
            results.setdefault(f"{key}-mean", []).append(mean)
            results.setdefault(f"{key}-stdv", []).append(
                float(np.std(values)))
            agg_list.append(("cv_agg", key, mean, hib))
        try:
            for cb in cbs_after:
                cb(callback_mod.CallbackEnv(
                    model=cvbooster, params=params, iteration=i,
                    begin_iteration=0, end_iteration=num_boost_round,
                    evaluation_result_list=agg_list))
        except callback_mod.EarlyStopException as e:
            cvbooster.best_iteration = e.best_iteration + 1
            for bst in cvbooster.boosters:
                bst.best_iteration = cvbooster.best_iteration
            for key in results:
                results[key] = results[key][:cvbooster.best_iteration]
            break
    out: Dict[str, Any] = dict(results)
    if return_cvbooster:
        out["cvbooster"] = cvbooster
    return out
