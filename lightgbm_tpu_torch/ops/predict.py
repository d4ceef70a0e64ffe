"""Inference over struct-of-arrays trees, in plain PyTorch.

Counterpart of ``StackedTrees`` and ``predict_raw_batched`` of
``lightgbm_tpu/ops/predict.py`` (reference: Tree::Predict,
include/LightGBM/tree.h:134, GBDT::PredictRaw). Every row carries its
current node id and takes ``depth`` steps (the stacked model's deepest
leaf); a step gathers the node's split column, threshold, default direction
and children, reads the row's bin and moves to a child, and leaves
(negative ids) stay put. A categorical node sends a row left when its bin's
bit is set in the node's bitset (``_walk_chunk`` there; the predicate of
``ops/split.py`` ``go_left_pred``). Trees run ``tbatch`` at a time, and tree
``t`` adds to the scores of class ``t % K``. The leaf index each row lands
in is exactly the one the training partition gave it, so scores match the
JAX package's walk.

The serving engines of the JAX package (bucket ladders, the level-order
relayout, quantized leaves, SHAP) are ROADMAP A10/A17.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

#: rows x trees of one walk chunk (bounds the [Tb, N] index temporaries)
_CHUNK_ELEMS = 1 << 24


class StackedTrees(NamedTuple):
    """All trees of a model stacked along a leading T axis."""
    split_feature: torch.Tensor   # [T, L-1] int64
    split_bin: torch.Tensor       # [T, L-1] int64
    default_left: torch.Tensor    # [T, L-1] bool
    left_child: torch.Tensor      # [T, L-1] int64
    right_child: torch.Tensor     # [T, L-1] int64
    leaf_value: torch.Tensor      # [T, L] f32
    num_nodes: torch.Tensor       # [T] int64
    # categorical nodes and their bin bitsets; None: every node numerical
    is_cat: Optional[torch.Tensor] = None      # [T, L-1] bool
    cat_bitset: Optional[torch.Tensor] = None  # [T, L-1, W] int32

    @property
    def num_trees(self) -> int:
        return self.split_feature.shape[0]

    def slice(self, t0: int, t1: int) -> "StackedTrees":
        return StackedTrees(*(None if a is None else a[t0:t1] for a in self))


def predict_leaf_batched(binned: torch.Tensor, trees: StackedTrees,
                         nan_bin_arr: torch.Tensor, depth: int
                         ) -> torch.Tensor:
    """Leaf index ``[T, N]`` of every row in every tree (numerical splits:
    left is ``bin <= threshold``, NaN bins follow ``default_left``;
    categorical ones: left when the bin's bit is set)."""
    n, f = binned.shape
    t = trees.num_trees
    flat = binned.reshape(-1)
    rows = torch.arange(n, device=binned.device, dtype=torch.int64) * f
    safe_f = torch.clamp(trees.split_feature, min=0)
    nan_of = nan_bin_arr.to(torch.int64)[safe_f]                  # [T, L-1]
    start = torch.where(trees.num_nodes > 0, 0, -1)               # [T]
    cur = start[:, None].expand(t, n).clone()
    if trees.is_cat is not None:
        w = trees.cat_bitset.shape[2]
        words = trees.cat_bitset.reshape(t, -1).to(torch.int64)
    for _ in range(depth):
        node = torch.clamp(cur, min=0)
        col = safe_f.gather(1, node)
        fcol = flat[rows[None, :] + col].to(torch.int64)
        thr = trees.split_bin.gather(1, node)
        dl = trees.default_left.gather(1, node)
        go_left = (fcol <= thr) | (dl & (fcol == nan_of.gather(1, node)))
        if trees.is_cat is not None:
            wi = fcol >> 5
            word = words.gather(1, node * w + torch.clamp(wi, max=w - 1))
            in_set = (wi < w) & (((word >> (fcol & 31)) & 1) != 0)
            go_left = torch.where(trees.is_cat.gather(1, node), in_set,
                                  go_left)
        nxt = torch.where(go_left, trees.left_child.gather(1, node),
                          trees.right_child.gather(1, node))
        cur = torch.where(cur >= 0, nxt, cur)
    return -(cur + 1)


def predict_raw_batched(binned: torch.Tensor, trees: StackedTrees,
                        nan_bin_arr: torch.Tensor, depth: int,
                        tbatch: int = 16, num_class: int = 1
                        ) -> torch.Tensor:
    """Raw scores ``[K, N]`` f32 (K = ``num_class``): tree ``t``'s leaf
    values summed into class ``t % K``, trees added ``tbatch`` at a
    time."""
    n = binned.shape[0]
    dev = binned.device
    scores = torch.zeros((num_class, n), dtype=torch.float32, device=dev)
    t_total = trees.num_trees
    if t_total == 0 or n == 0:
        return scores
    cls = torch.arange(t_total, device=dev) % num_class
    row_chunk = max(1, _CHUNK_ELEMS // max(tbatch, 1))
    for r0 in range(0, n, row_chunk):
        part = binned[r0:r0 + row_chunk]
        acc = scores[:, r0:r0 + row_chunk]
        for t0 in range(0, t_total, tbatch):
            sub = trees.slice(t0, t0 + tbatch)
            leaf = predict_leaf_batched(part, sub, nan_bin_arr, depth)
            vals = sub.leaf_value.gather(1, leaf)
            if num_class == 1:
                acc += vals.sum(dim=0)[None, :]
            else:
                acc.index_add_(0, cls[t0:t0 + tbatch], vals)
    return scores
