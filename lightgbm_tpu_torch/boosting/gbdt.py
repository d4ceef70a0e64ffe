"""Gradient Boosted Decision Trees over the compact grower.

Counterpart of ``lightgbm_tpu/boosting/gbdt.py`` for the serial, binary,
numerical path (reference: class GBDT, src/boosting/gbdt.cpp): the packed
row-record state of ``_setup_compact_state``, the compact training step
(gradients in the current row order -> record columns -> grow -> shrinkage
-> score update through ``segments_to_leaf_vectors``), boost-from-average,
validation-set score updates and ``HostTree``.

The compact grower permutes the rows of the record arrays every tree, so the
train scores live in that permuted order (written into the record's score
column before each tree) and a carried original-row-id column maps them back
for metrics. The tree grows with no device-to-host read; after it, its
arrays come to the host in ONE copy (the iteration's stop check and the
model list need them), and validation scores are routed on the device with
the device copy of the tree.

Multiclass, leaf renewal, quantized gradients, checkpoints, DART/RF and the
JAX package's compile ladder are ROADMAP A12-A16 (the ladder has no
counterpart in eager PyTorch).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.dataset import BinnedDataset
from ..metrics import Metric
from ..ops.compact import RowLayout, _f32_to_u8, _u8_to_f32, pack_rows
from ..ops.grower import GrowerParams, TreeArrays
from ..ops.grower_compact import grow_tree_compact
from ..ops.predict import StackedTrees, predict_leaf_batched, \
    predict_raw_batched
from ..utils import log

_INT_FIELDS = ("split_feature", "split_bin", "default_left", "left_child",
               "right_child", "leaf_parent", "leaf_depth")
_FLOAT_FIELDS = ("split_gain", "leaf_value", "leaf_weight", "leaf_count",
                 "internal_value", "internal_weight", "internal_count")


class HostTree:
    """Host-side copy of one grown tree (numpy struct-of-arrays), the
    fields of the JAX package's HostTree."""

    __slots__ = ("split_feature", "split_bin", "cat_bitset", "split_gain",
                 "default_left", "left_child", "right_child", "leaf_value",
                 "leaf_weight", "leaf_count", "leaf_parent", "leaf_depth",
                 "internal_value", "internal_weight", "internal_count",
                 "num_leaves", "num_nodes", "shrinkage")

    def __init__(self, fields: dict, shrinkage: float = 1.0):
        for name in self.__slots__:
            if name in fields:
                setattr(self, name, fields[name])
        self.num_leaves = int(fields["num_leaves"])
        self.num_nodes = int(fields["num_nodes"])
        if "cat_bitset" not in fields:
            self.cat_bitset = np.zeros((len(self.split_feature), 1),
                                       np.uint32)
        self.shrinkage = shrinkage

    @classmethod
    def from_device(cls, tree: TreeArrays, shrinkage: float) -> "HostTree":
        """The tree's arrays in one device-to-host copy."""
        ints = [getattr(tree, k).to(torch.int64).reshape(-1)
                for k in _INT_FIELDS]
        ints += [tree.num_leaves.reshape(1), tree.num_nodes.reshape(1)]
        floats = [getattr(tree, k).reshape(-1) for k in _FLOAT_FIELDS]
        sizes = [t.numel() for t in ints + floats]
        blob = torch.cat([t.to(torch.float64) for t in ints + floats]).cpu()
        parts = np.split(blob.numpy(), np.cumsum(sizes)[:-1])
        fields = {}
        for name, arr in zip(_INT_FIELDS + ("num_leaves", "num_nodes"),
                             parts):
            fields[name] = arr.astype(np.int32)
        fields["default_left"] = fields["default_left"].astype(bool)
        for name, arr in zip(_FLOAT_FIELDS, parts[len(_INT_FIELDS) + 2:]):
            fields[name] = arr.astype(np.float32)
        fields["num_leaves"] = int(fields["num_leaves"][0])
        fields["num_nodes"] = int(fields["num_nodes"][0])
        return cls(fields, shrinkage)

    @property
    def max_depth(self) -> int:
        return int(np.max(self.leaf_depth[:self.num_leaves], initial=0))


def stack_trees(models: Sequence[HostTree],
                device: torch.device) -> StackedTrees:
    """Stack host trees into padded device arrays for prediction."""
    t = len(models)
    max_leaves = max((len(m.leaf_value) for m in models), default=2)
    max_nodes = max(max_leaves - 1, 1)

    def pad(getter, fill, dtype, width):
        out = np.full((t, width), fill, dtype=dtype)
        for i, m in enumerate(models):
            a = getter(m)
            out[i, :len(a)] = a
        return torch.from_numpy(out).to(device)

    return StackedTrees(
        split_feature=pad(lambda m: m.split_feature, -1, np.int64, max_nodes),
        split_bin=pad(lambda m: m.split_bin, 0, np.int64, max_nodes),
        default_left=pad(lambda m: m.default_left, False, bool, max_nodes),
        left_child=pad(lambda m: m.left_child, -1, np.int64, max_nodes),
        right_child=pad(lambda m: m.right_child, -1, np.int64, max_nodes),
        leaf_value=pad(lambda m: m.leaf_value, 0.0, np.float32, max_leaves),
        num_nodes=torch.tensor([m.num_nodes for m in models],
                               dtype=torch.int64).to(device),
    )


class _ValidSet:
    """Cached raw scores of one validation set (reference: ScoreUpdater)."""

    def __init__(self, dataset: BinnedDataset, name: str,
                 device: torch.device):
        self.dataset = dataset
        self.name = name
        self.n_real = dataset.num_data
        self.binned = torch.from_numpy(np.ascontiguousarray(
            dataset.binned)).to(device)
        score0 = np.zeros((1, self.n_real), np.float32)
        md = dataset.metadata
        if md is not None and md.init_score is not None:
            score0[0] += np.asarray(md.init_score, np.float32)
        self.score = torch.from_numpy(score0).to(device)
        self.metrics: List[Metric] = []


class GBDT:
    """Gradient Boosted Decision Trees (reference: class GBDT, gbdt.h)."""

    def __init__(self, config, train_set: BinnedDataset, objective,
                 device: torch.device):
        self.config = config
        self.objective = objective
        self.train_set = train_set
        self.device = device
        self.models: List[HostTree] = []
        self.iter_ = 0
        self.shrinkage_rate = float(config.get("learning_rate", 0.1))
        self._init_scores = [0.0]
        self.valid_sets: List[_ValidSet] = []
        self.train_metrics: List[Metric] = []
        self.mappers = train_set.mappers
        self._setup_train(train_set)

    @classmethod
    def for_prediction(cls, config, models: Sequence[HostTree], mappers,
                       objective, device: torch.device) -> "GBDT":
        """A model that only predicts: trees, bin mappers, objective."""
        self = cls.__new__(cls)
        self.config = config
        self.objective = objective
        self.train_set = None
        self.device = device
        self.models = list(models)
        self.iter_ = len(self.models)
        self.mappers = list(mappers)
        self.valid_sets = []
        self.train_metrics = []
        self.nan_bin_arr = torch.tensor(
            [m.nan_bin if not m.is_trivial else 0 for m in self.mappers],
            dtype=torch.int64).to(device)
        return self

    # -- training setup ------------------------------------------------------
    def _setup_train(self, train_set: BinnedDataset) -> None:
        cfg = self.config
        dev = self.device
        n = train_set.num_data
        self.num_data = n
        self._n_real = n
        if n >= (1 << 24):
            # f32 raw-count histograms drive the partition offsets and the
            # f32 row ids drive the metric permutation; both are exact only
            # below 2^24 rows
            raise RuntimeError("the compact grower supports up to 2^24 rows")
        mappers = train_set.mappers
        self.num_bins_arr = torch.from_numpy(
            train_set.feature_num_bins().astype(np.int64)).to(dev)
        self.nan_bin_arr = torch.from_numpy(
            train_set.feature_nan_bins().astype(np.int64)).to(dev)
        self.has_nan_arr = torch.from_numpy(train_set.feature_has_nan()).to(
            dev)
        self.feat_mask = torch.from_numpy(np.array(
            [not m.is_trivial for m in mappers], bool)).to(dev)
        self.grower_params = GrowerParams(
            num_leaves=int(cfg.get("num_leaves", 31)),
            max_depth=int(cfg.get("max_depth", -1)),
            num_bins=int(train_set.max_num_bins),
            lambda_l1=float(cfg.get("lambda_l1", 0.0)),
            lambda_l2=float(cfg.get("lambda_l2", 0.0)),
            min_data_in_leaf=float(cfg.get("min_data_in_leaf", 20)),
            min_sum_hessian_in_leaf=float(
                cfg.get("min_sum_hessian_in_leaf", 1e-3)),
            min_gain_to_split=float(cfg.get("min_gain_to_split", 0.0)),
            max_delta_step=float(cfg.get("max_delta_step", 0.0)),
        )
        md = train_set.metadata
        self.objective.init(md, n)
        score0 = np.zeros(n, np.float32)
        self._has_init_score = md.init_score is not None
        if self._has_init_score:
            score0 += np.asarray(md.init_score, np.float32)
        self.train_score = torch.from_numpy(score0).to(dev)
        self._setup_compact_state(train_set)

    def _setup_compact_state(self, train_set: BinnedDataset) -> None:
        """The packed row records (ops/compact.py). Extras carried through
        every partition: [score, label, weight?, original row id]."""
        dev = self.device
        n = self.num_data
        md = train_set.metadata
        has_w = md.weight is not None
        e = 3 + (1 if has_w else 0)
        self.layout = RowLayout(num_features=int(train_set.binned.shape[1]),
                                num_extra=e)
        self._cx_score = 0
        self._cx_label = 1
        self._cx_weight = 2 if has_w else None
        self._cx_rowid = e - 1
        binned = torch.from_numpy(np.ascontiguousarray(
            train_set.binned)).to(dev)
        parts = [self.train_score,
                 torch.from_numpy(np.asarray(md.label, np.float32)).to(dev)]
        if has_w:
            parts.append(torch.from_numpy(
                np.asarray(md.weight, np.float32)).to(dev))
        parts.append(torch.arange(n, dtype=torch.float32, device=dev))
        zeros = torch.zeros(n, dtype=torch.float32, device=dev)
        self.work = pack_rows(binned, zeros, zeros, zeros + 1.0,
                              torch.stack(parts), self.layout)
        self.scratch = torch.zeros_like(self.work)
        del binned

    def _col(self, i: int) -> torch.Tensor:
        """Carried extra column ``i`` in the current row order."""
        off = self.layout.extra_off + 4 * i
        return _u8_to_f32(self.work[:, off:off + 4])

    # -- one boosting iteration ----------------------------------------------
    def _boost_from_average(self) -> None:
        """(reference: GBDT::BoostFromAverage, gbdt.cpp:319)"""
        if self.num_total_trees == 0 and not self._has_init_score \
                and bool(self.config.get("boost_from_average", True)):
            init = self.objective.boost_from_score(0)
            if abs(init) > 1e-10:
                self._init_scores[0] = init
                self.train_score += init
                for vs in self.valid_sets:
                    vs.score += init
                log.info(f"Start training from score {init:.6f}")

    def train_one_iter(self) -> bool:
        """One boosting iteration; True when no further split was possible
        (reference: GBDT::TrainOneIter, gbdt.cpp:375)."""
        self._boost_from_average()
        lay = self.layout
        label = self._col(self._cx_label)
        weight = (self._col(self._cx_weight)
                  if self._cx_weight is not None else None)
        g, h = self.objective.get_gradients(self.train_score, label, weight)
        # the in-bag column stays 1 from setup (no bagging in this slice):
        # write grad, hess and the score column only
        self.work[:, lay.grad_off:lay.grad_off + 8] = \
            torch.stack([g, h], dim=1).view(torch.uint8)
        off = lay.extra_off + 4 * self._cx_score
        self.work[:, off:off + 4] = _f32_to_u8(self.train_score)

        tree, row_leaf, self.work, self.scratch, leaf_start, leaf_nrows = \
            grow_tree_compact(self.work, self.scratch, self.num_bins_arr,
                              self.nan_bin_arr, self.has_nan_arr,
                              self.feat_mask, lay, self.grower_params,
                              self.num_data)
        shrink = self.shrinkage_rate
        lv = torch.where(tree.num_nodes > 0, tree.leaf_value,
                         torch.zeros_like(tree.leaf_value)) * shrink
        tree = tree._replace(leaf_value=lv,
                             internal_value=tree.internal_value * shrink)
        # the score column moved with the rows: add each row's leaf value
        self.train_score = self._col(self._cx_score) + lv[row_leaf]

        host = HostTree.from_device(tree, shrink)
        self._update_valid_scores(tree, host.max_depth)
        if self.num_total_trees == 0 and abs(self._init_scores[0]) > 1e-10:
            host.leaf_value = host.leaf_value + np.float32(
                self._init_scores[0])
        self.iter_ += 1
        self.models.append(host)
        if host.num_nodes == 0:
            # (reference: gbdt.cpp:440-450) a no-split iteration's tree is
            # popped unless it is the very first, which stays constant
            if len(self.models) > 1:
                self.models.pop()
            self.iter_ -= 1
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        return False

    def _update_valid_scores(self, tree: TreeArrays, depth: int) -> None:
        if not self.valid_sets:
            return
        one = StackedTrees(
            split_feature=tree.split_feature[None],
            split_bin=tree.split_bin[None],
            default_left=tree.default_left[None],
            left_child=tree.left_child[None],
            right_child=tree.right_child[None],
            leaf_value=tree.leaf_value[None],
            num_nodes=tree.num_nodes.reshape(1))
        for vs in self.valid_sets:
            leaf = predict_leaf_batched(vs.binned, one, self.nan_bin_arr,
                                        depth)[0]
            vs.score[0] += tree.leaf_value[leaf]

    @property
    def num_total_trees(self) -> int:
        return len(self.models)

    def current_iteration(self) -> int:
        return self.iter_

    # -- validation and metrics ----------------------------------------------
    def add_valid(self, valid_set: BinnedDataset, name: str,
                  metrics: Sequence[Metric]) -> None:
        if valid_set.mappers is not self.mappers:
            raise ValueError(f"validation set '{name}' must be binned with "
                             "the training set's mappers")
        vs = _ValidSet(valid_set, name, self.device)
        if self.models:
            vs.score[0] += torch.from_numpy(self.predict_raw_binned(
                valid_set.binned)[0]).to(self.device)
        for m in metrics:
            m.init(valid_set.metadata, valid_set.num_data)
        vs.metrics = list(metrics)
        self.valid_sets.append(vs)

    def set_train_metrics(self, metrics: Sequence[Metric]) -> None:
        for m in metrics:
            m.init(self.train_set.metadata, self._n_real)
        self.train_metrics = list(metrics)

    def train_score_original_order(self) -> np.ndarray:
        """Train raw scores [N] in the dataset's row order."""
        perm = self._col(self._cx_rowid).to(torch.int64)
        out = torch.empty_like(self.train_score)
        out[perm] = self.train_score
        return out.cpu().numpy()

    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        if not self.train_metrics:
            return []
        return self._eval("training", self.train_score_original_order(),
                          self.train_metrics)

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        out = []
        for vs in self.valid_sets:
            out.extend(self._eval(vs.name, vs.score[0].cpu().numpy(),
                                  vs.metrics))
        return out

    def _eval(self, name, raw, metrics):
        convert = self.objective.convert_output
        return [(name, m.name, m.eval(raw, convert), m.higher_better)
                for m in metrics]

    # -- prediction ----------------------------------------------------------
    def _model_window(self, num_iteration: Optional[int],
                      start_iteration: int) -> List[HostTree]:
        models = self.models[max(start_iteration, 0):]
        if num_iteration is not None and num_iteration > 0:
            models = models[:num_iteration]
        return models

    def bin_matrix(self, arr: np.ndarray) -> np.ndarray:
        """Bin raw feature rows with the training mappers (host side)."""
        from ..io.binning import bin_columns
        arr = np.asarray(arr)
        if arr.dtype != np.float32:
            arr = arr.astype(np.float64, copy=False)
        if arr.ndim == 1:
            arr = arr.reshape(1, -1)
        if arr.shape[1] != len(self.mappers):
            raise ValueError(f"input has {arr.shape[1]} features, model "
                             f"expects {len(self.mappers)}")
        return bin_columns(self.mappers, arr, np.uint8)

    def predict_raw_binned(self, binned: np.ndarray,
                           num_iteration: Optional[int] = None,
                           start_iteration: int = 0) -> np.ndarray:
        """Raw scores [1, N] for already-binned rows."""
        models = self._model_window(num_iteration, start_iteration)
        n = binned.shape[0]
        if not models:
            return np.zeros((1, n), np.float32)
        trees = stack_trees(models, self.device)
        depth = max(m.max_depth for m in models)
        b = torch.from_numpy(np.ascontiguousarray(binned)).to(self.device)
        raw = predict_raw_batched(b, trees, self.nan_bin_arr, depth)
        return raw.cpu().numpy()

    def predict_raw_matrix(self, arr: np.ndarray,
                           num_iteration: Optional[int] = None,
                           start_iteration: int = 0) -> np.ndarray:
        return self.predict_raw_binned(self.bin_matrix(arr), num_iteration,
                                       start_iteration)
