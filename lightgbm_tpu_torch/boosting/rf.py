"""Random forest: bagged trees without shrinkage, averaged outputs.

Counterpart of ``lightgbm_tpu/boosting/rf.py`` (reference:
src/boosting/rf.hpp): the gradients are computed once, from the constant
init score; each iteration draws its bag and features, grows its trees on
the masked grower at shrinkage 1 with the init score folded into every
tree, and keeps the train and validation scores as the running average of
the trees (``score * n / (n + 1)`` around each update); the model predicts
the mean of its iterations (``average_output``). Renewed objectives (L1,
quantile, MAPE) renew against the constant init score.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.grower import grow_tree
from .gbdt import GBDT, HostTree


class RF(GBDT):
    boosting_type = "rf"
    average_output = True
    _supports_lazy_cegb = False
    _masked_only = True

    def __init__(self, config, train_set, objective, device):
        # (reference: rf.py:24-31)
        if config.get("bagging_freq", 0) <= 0 or \
                not 0.0 < config.get("bagging_fraction", 1.0) < 1.0:
            if not 0.0 < config.get("feature_fraction", 1.0) < 1.0:
                raise ValueError(
                    "Random forest needs bagging (bagging_freq > 0 and "
                    "0 < bagging_fraction < 1) and/or feature_fraction < 1")
        super().__init__(config, train_set, objective, device)
        self.shrinkage_rate = 1.0
        self._const_grad = None

    def _rf_gradients(self):
        """``[K, N]`` gradients and hessians at the constant init score,
        made once (reference: ``_rf_gradients``, rf.py:35-51)."""
        if self._const_grad is None:
            if self.objective is None:
                raise ValueError("RF mode does not support custom objectives")
            for c in range(self.num_class):
                self._init_scores[c] = (
                    self.objective.boost_from_score(c)
                    if bool(self.config.get("boost_from_average", True))
                    else 0.0)
            init = torch.tensor(np.asarray(self._init_scores, np.float32),
                                device=self.device)[:, None]
            const = torch.zeros_like(self.train_score) + init
            self._const_grad = self._gradients(const, self.label,
                                               self.grad_weight)
        return self._const_grad

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """(reference: ``RF.train_one_iter``, rf.py:53-122)"""
        if gradients is not None or hessians is not None:
            raise ValueError("RF mode does not support custom objectives")
        grad, hess = self._rf_gradients()
        strat = self.sample_strategy
        mask = strat.bag_mask(self.iter_, grad, hess)
        grad, hess = strat.scale_grad_hess(mask, grad, hess)
        if mask is None:
            mask = self.row_mask
        feat_mask = self._feature_mask()
        n_prev = float(self.iter_)
        for c in range(self.num_class):
            tree_index = len(self.models)
            tree, row_leaf = grow_tree(
                self.binned, grad[c] * mask, hess[c] * mask, mask,
                self.num_bins_arr, self.nan_bin_arr, self.has_nan_arr,
                feat_mask, self.grower_params, self.binned_t,
                self.is_cat_arr, self._bynode_uniforms(tree_index),
                self._tree_options(tree_index, int(self.feat_mask.shape[0])),
                self._forced)
            self._note_used_features(tree)
            init = self._init_scores[c]
            # the running average: score * n_prev, plus the tree, over
            # n_prev + 1 (reference: rf.hpp MultiplyScore around UpdateScore)
            self.train_score[c] *= n_prev
            for vs in self.valid_sets:
                vs.score[c] *= n_prev
            if int(tree.num_nodes) > 0:
                tree = self._renew_rf(tree, row_leaf, mask, c)
                # every tree folds in the init score (rf.hpp AddBias)
                if abs(init) > 1e-10:
                    tree = tree._replace(leaf_value=tree.leaf_value + init)
                host = HostTree.from_device(tree, 1.0)
                self.train_score[c] += tree.leaf_value[row_leaf]
                self._update_valid_scores(tree, host.max_depth, c)
            else:
                host = HostTree.from_device(tree, 1.0)
                const = init if len(self.models) < self.num_class else 0.0
                host.num_leaves = 1
                host.leaf_value = np.full_like(host.leaf_value, const)
                self.train_score[c] += const
                for vs in self.valid_sets:
                    vs.score[c] += const
            self.train_score[c] *= 1.0 / (n_prev + 1.0)
            for vs in self.valid_sets:
                vs.score[c] *= 1.0 / (n_prev + 1.0)
            self.models.append(host)
        self.iter_ += 1
        return False

    def _renew_rf(self, tree, row_leaf, mask, c: int):
        """Renewed objectives refit the leaves against the constant init
        score, not the running score (reference: ``_renew_tree_output``,
        rf.py:126-139)."""
        obj = self.objective
        if not obj.renew_leaves:
            return tree
        residual = obj._target(self.label) - self._init_scores[c]
        w = mask if self.weight is None else mask * self.weight
        return self._renew_quantile(tree, residual, w, row_leaf)
