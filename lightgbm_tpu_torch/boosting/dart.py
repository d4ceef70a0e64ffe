"""DART boosting: trees dropped out each iteration.

Counterpart of ``lightgbm_tpu/boosting/dart.py`` (reference:
src/boosting/dart.hpp, the drop -> train -> normalize cycle of
TrainOneIter). The drop choice is host logic on a
``numpy.random.RandomState(drop_seed)`` drawn in the JAX package's order
(one draw for the skip, then one an earlier iteration), so both drop the
same trees. Each dropped tree is uploaded once a round and routed on the
device (``GBDT.apply_tree_to_scores`` over ``_routing_binned()``, rows in
the order of the train scores, which on the compact grower is the
records' current order): taken out of the train score before the
gradients, then put back at ``k/(k+1)`` of itself (``k/(k+lr)`` in
``xgboost_dart_mode``) in the model, the train score and the validation
scores. The new trees grow at the learning rate over ``1 + k``
(``lr + k``). The two routing passes are profiler ranges, ``dart_drop``
and ``dart_normalize``.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .gbdt import GBDT


class DART(GBDT):
    boosting_type = "dart"

    def __init__(self, config, train_set, objective, device):
        super().__init__(config, train_set, objective, device)
        self.drop_rate = float(config.get("drop_rate", 0.1))
        self.max_drop = int(config.get("max_drop", 50))
        self.skip_drop = float(config.get("skip_drop", 0.5))
        self.uniform_drop = bool(config.get("uniform_drop", False))
        self.xgboost_dart_mode = bool(config.get("xgboost_dart_mode", False))
        self._rng = np.random.RandomState(int(config.get("drop_seed", 4)))
        # per-iteration weights of the non-uniform drop
        self.tree_weight: List[float] = []
        self.sum_weight = 0.0
        # the iterations dropped in the last call of train_one_iter
        self.last_drop: List[int] = []

    def capture_training_state(self):
        """The drop state rides the snapshot (reference: ``lightgbm_tpu/
        boosting/dart.py:38-58``): the drop RandomState and the per-tree
        weights decide which trees later iterations drop."""
        state = super().capture_training_state()
        state["dart"] = {"rng": self._rng.get_state(),
                         "tree_weight": [float(w) for w in self.tree_weight],
                         "sum_weight": float(self.sum_weight)}
        return state

    def restore_training_state(self, state):
        super().restore_training_state(state)
        dart = state.get("dart")
        if dart is not None:
            self._rng.set_state(dart["rng"])
            self.tree_weight = list(dart["tree_weight"])
            self.sum_weight = float(dart["sum_weight"])

    def _select_drop(self) -> List[int]:
        """The iterations to drop (reference: ``DART._select_drop``,
        ``lightgbm_tpu/boosting/dart.py:59-84``; DroppingTrees)."""
        drop: List[int] = []
        if self._rng.rand() < self.skip_drop:
            return drop
        drop_rate = self.drop_rate
        if not self.uniform_drop:
            if self.sum_weight <= 0:
                return drop
            inv_avg = len(self.tree_weight) / self.sum_weight
            if self.max_drop > 0:
                drop_rate = min(drop_rate,
                                self.max_drop * inv_avg / self.sum_weight)
            for i in range(self.iter_):
                if self._rng.rand() < drop_rate * self.tree_weight[i] \
                        * inv_avg:
                    drop.append(i)
                    if len(drop) >= self.max_drop:
                        break
        else:
            if self.max_drop > 0 and self.iter_ > 0:
                drop_rate = min(drop_rate, self.max_drop / float(self.iter_))
            for i in range(self.iter_):
                if self._rng.rand() < drop_rate:
                    drop.append(i)
                    if len(drop) >= self.max_drop:
                        break
        return drop

    def _apply_dropped(self, drop: List[int], trees: Dict, factor: float,
                       train: bool = True, valid: bool = True) -> None:
        k_trees = self.num_class
        for i in drop:
            for c in range(k_trees):
                self.apply_tree_to_scores(self.models[i * k_trees + c], c,
                                          factor, train=train, valid=valid,
                                          tree=trees[i, c])

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """(reference: ``DART.train_one_iter``, ``lightgbm_tpu/boosting/
        dart.py:86-140``)"""
        drop = self._select_drop()
        self.last_drop = drop
        k = float(len(drop))
        k_trees = self.num_class
        # the gradients see the ensemble without the dropped trees; each
        # dropped tree's arrays go to the device once a round
        with torch.profiler.record_function("dart_drop"):
            trees = {(i, c): self.host_tree_arrays(
                self.models[i * k_trees + c])
                for i in drop for c in range(k_trees)}
            self._apply_dropped(drop, trees, -1.0, valid=False)
        if not self.xgboost_dart_mode:
            self.shrinkage_rate = self.learning_rate / (1.0 + k)
        else:
            self.shrinkage_rate = (self.learning_rate if not drop else
                                   self.learning_rate
                                   / (self.learning_rate + k))
        if super().train_one_iter(gradients, hessians):
            # a stopped round puts its dropped trees back
            self._apply_dropped(drop, trees, 1.0, valid=False)
            return True
        # normalize: each dropped tree ends at factor times itself
        denom = (k + 1.0) if not self.xgboost_dart_mode \
            else (k + self.learning_rate)
        factor = k / denom
        for i in drop:
            with torch.profiler.record_function("dart_normalize"):
                for c in range(k_trees):
                    host = self.models[i * k_trees + c]
                    # the validation scores still hold the whole tree, the
                    # train score none of it
                    self.apply_tree_to_scores(host, c, factor - 1.0,
                                              train=False, tree=trees[i, c])
                    self.apply_tree_to_scores(host, c, factor, valid=False,
                                              tree=trees[i, c])
                    host.scale(factor)
            if not self.uniform_drop:
                self.sum_weight -= self.tree_weight[i] * (1.0 / denom)
                self.tree_weight[i] *= factor
        if drop:
            # rescaled leaves: every device copy of the trees is stale
            self._invalidate_device_trees()
        if not self.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        return False
