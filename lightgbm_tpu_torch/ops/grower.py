"""Tree-growth parameters and the struct-of-arrays tree.

Counterpart of ``GrowerParams`` and ``TreeArrays`` of
``lightgbm_tpu/ops/grower.py``, with the fields the serial numerical
compact grower reads. The masked grower ``grow_tree`` and per-node feature
sampling are ROADMAP A11/A14. The JAX package's compile ladder (leaf rungs,
depth buckets) fixes XLA jit keys and has no counterpart in eager PyTorch:
trees grow at the exact ``num_leaves``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .split import SplitParams


class GrowerParams(NamedTuple):
    """Tree-growth hyper-parameters."""
    num_leaves: int = 31
    max_depth: int = -1
    num_bins: int = 256
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: float = 20.0
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0

    def split_params(self) -> SplitParams:
        return SplitParams(
            lambda_l1=self.lambda_l1,
            lambda_l2=self.lambda_l2,
            min_data_in_leaf=self.min_data_in_leaf,
            min_sum_hessian_in_leaf=self.min_sum_hessian_in_leaf,
            min_gain_to_split=self.min_gain_to_split,
            max_delta_step=self.max_delta_step,
        )

    @property
    def bitset_words(self) -> int:
        return -(-self.num_bins // 32)


class TreeArrays(NamedTuple):
    """Struct-of-arrays tree (reference: Tree, include/LightGBM/tree.h:26).

    Nodes are indexed 0..num_leaves-2 in creation order; a child pointer
    >= 0 is an internal node, a negative one ``-(leaf + 1)`` a leaf."""
    split_feature: torch.Tensor   # [L-1] int64 (-1 = unused node)
    split_bin: torch.Tensor       # [L-1] int64 threshold bin: left is bin <= t
    cat_bitset: torch.Tensor      # [L-1, W] int32 categorical bitsets
    split_gain: torch.Tensor      # [L-1] f32
    default_left: torch.Tensor    # [L-1] bool
    left_child: torch.Tensor      # [L-1] int64
    right_child: torch.Tensor     # [L-1] int64
    leaf_value: torch.Tensor      # [L] f32
    leaf_weight: torch.Tensor     # [L] f32 (sum of hessians)
    leaf_count: torch.Tensor      # [L] f32 (in-bag row count)
    leaf_parent: torch.Tensor     # [L] int64
    leaf_depth: torch.Tensor      # [L] int64
    internal_value: torch.Tensor  # [L-1] f32
    internal_weight: torch.Tensor  # [L-1] f32
    internal_count: torch.Tensor  # [L-1] f32
    num_leaves: torch.Tensor      # [] int64
    num_nodes: torch.Tensor       # [] int64
