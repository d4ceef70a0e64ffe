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

Prediction early stopping (reference: prediction_early_stop.cpp, the JAX
package's ``predict_raw_batched`` and ``early_stop_tbatch``): every ``freq``
iterations from the window's start, a row whose margin (``2|score|`` with
one class, top1 - top2 with K) exceeds ``margin`` stops adding trees.

The serving engines of the JAX package (bucket ladders, the level-order
relayout, quantized leaves) are ROADMAP A17.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .packed import gather_bin

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
                         nan_bin_arr: torch.Tensor, depth: int,
                         packed: bool = False) -> torch.Tensor:
    """Leaf index ``[T, N]`` of every row in every tree (numerical splits:
    left is ``bin <= threshold``, NaN bins follow ``default_left``;
    categorical ones: left when the bin's bit is set). ``packed``: the bins
    are nibble-packed (``[N, ceil(F/2)]``), a node's column read as byte
    ``col >> 1``, nibble ``col & 1`` (``ops/packed.py`` ``gather_bin``;
    reference: ``lightgbm_tpu/ops/predict.py:401``, ``:430-441``)."""
    n = binned.shape[0]
    t = trees.num_trees
    rows = torch.arange(n, device=binned.device, dtype=torch.int64)[None, :]
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
        fcol = gather_bin(binned, rows, col, packed)
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


def early_stop_tbatch(k: int, freq: int, tbatch: int) -> int:
    """The largest tree batch, ``k * d`` with ``d`` a divisor of ``freq``
    no larger than ``tbatch`` allows, whose boundaries land on every
    multiple of ``freq`` iterations (reference: ``early_stop_tbatch``,
    ``lightgbm_tpu/ops/predict.py:169-190``), so that the margin check runs
    exactly where the reference's does."""
    k = max(k, 1)
    freq = max(freq, 1)
    best = 1
    f = 1
    while f * f <= freq:
        if freq % f == 0:
            for d in (f, freq // f):
                if k * d <= max(tbatch, k) and d > best:
                    best = d
        f += 1
    return k * best


def _margin(scores: torch.Tensor) -> torch.Tensor:
    """The decided margin of ``[K, N]`` scores (reference: ``_margin_of``,
    ``lightgbm_tpu/ops/predict.py:343-351``): ``2|score|`` for one class,
    the top score minus the second for K."""
    if scores.shape[0] == 1:
        return 2.0 * scores[0].abs()
    top = torch.topk(scores, 2, dim=0).values
    return top[0] - top[1]


def predict_raw_batched(binned: torch.Tensor, trees: StackedTrees,
                        nan_bin_arr: torch.Tensor, depth: int,
                        tbatch: int = 16, num_class: int = 1,
                        early_stop_margin: float = 0.0,
                        early_stop_freq: int = 0,
                        packed: bool = False) -> torch.Tensor:
    """Raw scores ``[K, N]`` f32 (K = ``num_class``): tree ``t``'s leaf
    values added into class ``t % K`` one tree after another, trees walked
    ``tbatch`` at a time.
    With ``early_stop_freq > 0`` and ``early_stop_margin > 0`` a row stops
    adding trees once its margin exceeds ``early_stop_margin`` at a check
    after a multiple of ``early_stop_freq`` iterations; the batch is then
    ``early_stop_tbatch(num_class, early_stop_freq, tbatch)``. ``packed``:
    nibble-packed bins (``predict_leaf_batched``)."""
    n = binned.shape[0]
    dev = binned.device
    scores = torch.zeros((num_class, n), dtype=torch.float32, device=dev)
    t_total = trees.num_trees
    if t_total == 0 or n == 0:
        return scores
    use_stop = early_stop_freq > 0 and early_stop_margin > 0.0
    if use_stop:
        tbatch = early_stop_tbatch(num_class, early_stop_freq, tbatch)
    row_chunk = max(1, _CHUNK_ELEMS // max(tbatch, 1))
    for r0 in range(0, n, row_chunk):
        part = binned[r0:r0 + row_chunk]
        acc = scores[:, r0:r0 + row_chunk]
        done = (torch.zeros(part.shape[0], dtype=torch.bool, device=dev)
                if use_stop else None)
        for t0 in range(0, t_total, tbatch):
            sub = trees.slice(t0, t0 + tbatch)
            leaf = predict_leaf_batched(part, sub, nan_bin_arr, depth,
                                        packed)
            vals = sub.leaf_value.gather(1, leaf)
            if use_stop:
                vals = torch.where(done[None, :], 0.0, vals)
            # tree by tree, in order: the same f32 sums whatever the batch
            # (early stopping's batch too), and no atomics on the card
            for i in range(sub.num_trees):
                acc[(t0 + i) % num_class] += vals[i]
            t_end = t0 + sub.num_trees
            if use_stop and t_end % num_class == 0 \
                    and (t_end // num_class) % early_stop_freq == 0:
                done |= _margin(acc) > early_stop_margin
    return scores
