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

Serving (``lightgbm_tpu/ops/predict.py:84-169``, ``:528-805``) adds:

* bucket ladders: a serving request pads on the host to the smallest rung
  of ``tpu_predict_buckets`` that holds it (``parse_bucket_ladder``,
  ``bucket_rows``, ``warmup_rungs``), so no tensor of a request-dependent
  shape is made on the card (``tree_bucket`` is the JAX package's tree
  padding, kept for its ladder tests: eager PyTorch compiles nothing, so
  the port's tree cache holds its trees at their own count);
* the level-order engine: each tree renumbered breadth first into a
  complete binary heap (``build_level_layout``), so that step ``d`` reads
  the ``[Tb, 2^d]`` level ``d`` of the heap and a row moves ``p -> 2p +
  (1 - go_left)``; slots below a leaf hold a pass-through record (threshold
  ``_PASS_BIN`` sends every row left), and ``slot_leaf`` maps the final
  slot to the walk's leaf. Leaf ids equal the walk's, and the scores add
  the same leaf values in the same order, tree by tree, so they equal the
  walk's bit for bit (the JAX package sums each chunk's trees at once);
* quantized leaves (``quantize_leaves``): an ``int8`` slab with a
  symmetric scale a tree, or ``f16``, with the recorded bound on the score
  error; the walk and the level engine dequantize through ``leaf_scale``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence, Tuple

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


def _leaf_add(leaf_value: torch.Tensor, leaf: torch.Tensor,
              leaf_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """Leaf values ``[Tb, N]`` f32 of the rows' leaves from a slab that may
    be quantized (reference: ``_leaf_add``, ``lightgbm_tpu/ops/predict.py:
    666-676``): int8 times the tree's scale, f16 widened."""
    add = leaf_value.gather(1, leaf)
    if add.dtype == torch.int8:
        return add.to(torch.float32) * leaf_scale[:, None]
    return add.to(torch.float32)


def _raw_scores(binned: torch.Tensor, t_total: int,
                leaves_of: Callable[[torch.Tensor, int, int], torch.Tensor],
                leaf_value: torch.Tensor, leaf_scale: Optional[torch.Tensor],
                tbatch: int, num_class: int, early_stop_margin: float,
                early_stop_freq: int) -> torch.Tensor:
    """Raw scores ``[K, N]`` of ``t_total`` trees whose leaves
    ``leaves_of(rows, t0, t1)`` gives ``tbatch`` trees at a time: tree
    ``t``'s leaf values added into class ``t % K`` one tree after another,
    whatever router found the leaves."""
    n = binned.shape[0]
    dev = binned.device
    scores = torch.zeros((num_class, n), dtype=torch.float32, device=dev)
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
            t1 = min(t0 + tbatch, t_total)
            vals = _leaf_add(leaf_value[t0:t1], leaves_of(part, t0, t1),
                             None if leaf_scale is None
                             else leaf_scale[t0:t1])
            if use_stop:
                vals = torch.where(done[None, :], 0.0, vals)
            # tree by tree, in order: the same f32 sums whatever the batch
            # (early stopping's batch too), and no atomics on the card
            for i in range(t1 - t0):
                acc[(t0 + i) % num_class] += vals[i]
            if use_stop and t1 % num_class == 0 \
                    and (t1 // num_class) % early_stop_freq == 0:
                done |= _margin(acc) > early_stop_margin
    return scores


def predict_raw_batched(binned: torch.Tensor, trees: StackedTrees,
                        nan_bin_arr: torch.Tensor, depth: int,
                        tbatch: int = 16, num_class: int = 1,
                        early_stop_margin: float = 0.0,
                        early_stop_freq: int = 0,
                        packed: bool = False,
                        leaf_scale: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Raw scores ``[K, N]`` f32 (K = ``num_class``): tree ``t``'s leaf
    values added into class ``t % K`` one tree after another, trees walked
    ``tbatch`` at a time.
    With ``early_stop_freq > 0`` and ``early_stop_margin > 0`` a row stops
    adding trees once its margin exceeds ``early_stop_margin`` at a check
    after a multiple of ``early_stop_freq`` iterations; the batch is then
    ``early_stop_tbatch(num_class, early_stop_freq, tbatch)``. ``packed``:
    nibble-packed bins (``predict_leaf_batched``). ``leaf_scale [T]``: the
    trees' ``leaf_value`` is an int8 slab of ``quantize_leaves``."""
    return _raw_scores(
        binned, trees.num_trees,
        lambda part, t0, t1: predict_leaf_batched(
            part, trees.slice(t0, t1), nan_bin_arr, depth, packed),
        trees.leaf_value, leaf_scale, tbatch, num_class, early_stop_margin,
        early_stop_freq)


# -- bucket ladders (reference: ``lightgbm_tpu/ops/predict.py:84-166``) ------

#: the default row ladder: x2 from 1,024 to 2^20 rows (tpu_predict_buckets)
DEFAULT_MIN_BUCKET = 1024
DEFAULT_MAX_BUCKET = 1 << 20


def parse_bucket_ladder(spec) -> Tuple[int, ...]:
    """``tpu_predict_buckets`` as sorted rungs: ``"auto"`` (or empty) is the
    x2 ladder from ``DEFAULT_MIN_BUCKET`` to ``DEFAULT_MAX_BUCKET``; a comma
    string or a sequence of ints gives the rungs."""
    if spec is None or (isinstance(spec, str)
                        and spec.strip().lower() in ("", "auto")):
        out, b = [], DEFAULT_MIN_BUCKET
        while b <= DEFAULT_MAX_BUCKET:
            out.append(b)
            b *= 2
        return tuple(out)
    if isinstance(spec, str):
        rungs = [int(float(t)) for t in spec.split(",") if t.strip()]
    else:
        rungs = [int(t) for t in spec]
    rungs = sorted({r for r in rungs if r > 0})
    if not rungs:
        raise ValueError(f"tpu_predict_buckets={spec!r} has no positive "
                         "rungs")
    return tuple(rungs)


def bucket_rows(n: int, ladder: Sequence[int]) -> Optional[int]:
    """The smallest rung that holds ``n`` rows, or None above the ladder."""
    for rung in ladder:
        if n <= rung:
            return rung
    return None


def warmup_rungs(ladder: Sequence[int],
                 max_rows: Optional[int] = None) -> Tuple[int, ...]:
    """The rungs a serving warm-up runs, smallest first: those up to
    ``max_rows`` (None or <= 0: all), and at least the smallest."""
    rungs = tuple(r for r in ladder
                  if not max_rows or max_rows <= 0 or r <= max_rows)
    return rungs if rungs else (min(ladder),)


def tree_bucket(t: int, tbatch: int) -> int:
    """The smallest ``tbatch * 2^j`` that holds ``t`` trees (the JAX
    package's tree padding, which spares it recompiles)."""
    b = max(tbatch, 1)
    while b < t:
        b *= 2
    return b


def depth_bucket(d: int) -> int:
    """The smallest ``4 * 2^j`` that holds depth ``d``."""
    b = 4
    while b < d:
        b *= 2
    return b


# -- the level-order engine (reference: ``lightgbm_tpu/ops/predict.py:
# 528-769``) ------------------------------------------------------------------

#: the deepest tree the level engine takes: its heap holds 2^D - 1 nodes a
#: tree (tpu_level_depth_cap overrides)
DEFAULT_LEVEL_DEPTH_CAP = 10

#: a dead heap slot's threshold: every row goes left
_PASS_BIN = 2 ** 31 - 1


class LevelTrees(NamedTuple):
    """Trees renumbered breadth first into complete binary heaps: heap
    position ``2^d - 1 + p`` is position ``p`` of level ``d``. A node's
    split column, threshold, default direction, NaN bin and, with
    categorical features, its kind and bitset; ``slot_leaf`` maps a row's
    final position at depth ``D`` to the walk's leaf id."""
    col: torch.Tensor            # [T, 2^D - 1] int64
    thr: torch.Tensor            # [T, 2^D - 1] int64 (_PASS_BIN: dead)
    default_left: torch.Tensor   # [T, 2^D - 1] bool
    nan_bin: torch.Tensor        # [T, 2^D - 1] int64 (-1: dead)
    slot_leaf: torch.Tensor      # [T, 2^D] int64
    is_cat: Optional[torch.Tensor] = None      # [T, 2^D - 1] bool
    cat_bitset: Optional[torch.Tensor] = None  # [T, 2^D - 1, W] int32

    @property
    def depth(self) -> int:
        return int(self.slot_leaf.shape[1]).bit_length() - 1

    @property
    def num_trees(self) -> int:
        return self.col.shape[0]

    def slice(self, t0: int, t1: int) -> "LevelTrees":
        return LevelTrees(*(None if a is None else a[t0:t1] for a in self))


def build_level_layout(trees: StackedTrees, nan_bin_arr: torch.Tensor,
                       depth: int) -> LevelTrees:
    """The heap layout of a tree stack whose deepest leaf is at most
    ``depth`` (reference: ``build_level_layout``, ``lightgbm_tpu/ops/
    predict.py:563-628``), on the trees' device. Children carry larger
    ids than their parent (the growers' order), so one pass over the
    nodes in id order gives each its level and position: node ``k`` at
    ``(d, p)`` puts its left child at ``(d + 1, 2p)`` and its right one at
    ``(d + 1, 2p + 1)``; a leaf reached at ``(d, p)`` owns the final slot
    ``p << (D - d)``, which the dead slots below it reach by going left."""
    depth = max(int(depth), 1)
    sf = trees.split_feature
    t_count, m = sf.shape
    dev = sf.device
    heap_n = (1 << depth) - 1
    t_idx = torch.arange(t_count, device=dev)
    lvl = torch.full((t_count, m), -1, dtype=torch.int64, device=dev)
    lvl[:, 0] = torch.where(trees.num_nodes > 0, 0, -1)
    pos = torch.zeros((t_count, m), dtype=torch.int64, device=dev)
    slot_leaf = torch.zeros((t_count, 1 << depth), dtype=torch.int64,
                            device=dev)
    for k in range(m):
        plvl, ppos = lvl[:, k], pos[:, k]
        live = plvl >= 0
        clvl = plvl + 1
        for child, cpos in ((trees.left_child[:, k], 2 * ppos),
                            (trees.right_child[:, k], 2 * ppos + 1)):
            is_int = live & (child >= 0)
            safe_c = torch.clamp(child, 0, m - 1)
            lvl[t_idx, safe_c] = torch.where(is_int, clvl,
                                             lvl[t_idx, safe_c])
            pos[t_idx, safe_c] = torch.where(is_int, cpos,
                                             pos[t_idx, safe_c])
            is_leaf = live & (child < 0) & (clvl <= depth)
            fslot = torch.clamp(
                cpos << torch.clamp(depth - clvl, min=0), 0,
                (1 << depth) - 1)
            slot_leaf[t_idx, fslot] = torch.where(
                is_leaf, -(child + 1), slot_leaf[t_idx, fslot])
    # creation-order nodes into heap order, a dump column for the rest
    valid = (lvl >= 0) & (lvl < depth)
    hidx = torch.where(valid, (1 << torch.clamp(lvl, min=0)) - 1 + pos,
                       heap_n)
    safe_f = torch.clamp(sf, min=0)

    def heap(values, fill):
        out = torch.full((t_count, heap_n + 1), fill, dtype=values.dtype,
                         device=dev)
        out.scatter_(1, hidx, values)
        return out[:, :heap_n].contiguous()
    cat = {}
    if trees.is_cat is not None:
        w = trees.cat_bitset.shape[2]
        bits = torch.zeros((t_count, heap_n + 1, w),
                           dtype=trees.cat_bitset.dtype, device=dev)
        bits.scatter_(1, hidx[:, :, None].expand(t_count, m, w),
                      trees.cat_bitset)
        cat = dict(is_cat=heap(trees.is_cat, False),
                   cat_bitset=bits[:, :heap_n].contiguous())
    return LevelTrees(
        col=heap(safe_f, 0), thr=heap(trees.split_bin, _PASS_BIN),
        default_left=heap(trees.default_left, False),
        nan_bin=heap(nan_bin_arr.to(torch.int64)[safe_f], -1),
        slot_leaf=slot_leaf, **cat)


def level_leaves(binned: torch.Tensor, level: LevelTrees,
                 packed: bool = False) -> torch.Tensor:
    """Leaf ids ``[T, N]`` of every row in every tree of ``level`` (the
    router ``_level_chunk``, ``lightgbm_tpu/ops/predict.py:631-663``, with
    ``predict_leaf_batched``'s predicate): step ``d`` reads level ``d``."""
    n = binned.shape[0]
    t = level.num_trees
    rows = torch.arange(n, device=binned.device, dtype=torch.int64)[None, :]
    pos = torch.zeros((t, n), dtype=torch.int64, device=binned.device)
    if level.is_cat is not None:
        w = level.cat_bitset.shape[2]
        words = level.cat_bitset.reshape(t, -1).to(torch.int64)
    for d in range(level.depth):
        node = pos + ((1 << d) - 1)
        fcol = gather_bin(binned, rows, level.col.gather(1, node), packed)
        go_left = (fcol <= level.thr.gather(1, node)) | (
            level.default_left.gather(1, node)
            & (fcol == level.nan_bin.gather(1, node)))
        if level.is_cat is not None:
            wi = fcol >> 5
            word = words.gather(1, node * w + torch.clamp(wi, max=w - 1))
            in_set = (wi < w) & (((word >> (fcol & 31)) & 1) != 0)
            go_left = torch.where(level.is_cat.gather(1, node), in_set,
                                  go_left)
        pos = 2 * pos + (~go_left).to(torch.int64)
    return level.slot_leaf.gather(1, pos)


def predict_raw_level(binned: torch.Tensor, level: LevelTrees,
                      leaf_value: torch.Tensor, tbatch: int = 16,
                      num_class: int = 1, early_stop_margin: float = 0.0,
                      early_stop_freq: int = 0, packed: bool = False,
                      leaf_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Raw scores ``[K, N]`` through the level engine (reference:
    ``predict_raw_level``, ``lightgbm_tpu/ops/predict.py:682-742``): the
    walk's leaves, added in the walk's order, so equal to
    ``predict_raw_batched`` bit for bit; ``leaf_value [T, L]`` f32, or a
    quantized slab with ``leaf_scale``."""
    return _raw_scores(
        binned, level.num_trees,
        lambda part, t0, t1: level_leaves(part, level.slice(t0, t1),
                                          packed),
        leaf_value, leaf_scale, tbatch, num_class, early_stop_margin,
        early_stop_freq)


def predict_leaf_level(binned: torch.Tensor, level: LevelTrees,
                       tbatch: int = 16, packed: bool = False
                       ) -> torch.Tensor:
    """Leaf ids ``[T, N]`` through the level engine, equal to
    ``predict_leaf_batched``'s."""
    n = binned.shape[0]
    out = torch.empty((level.num_trees, n), dtype=torch.int64,
                      device=binned.device)
    row_chunk = max(1, _CHUNK_ELEMS // max(tbatch, 1))
    for r0 in range(0, n, row_chunk):
        part = binned[r0:r0 + row_chunk]
        for t0 in range(0, level.num_trees, tbatch):
            t1 = min(t0 + tbatch, level.num_trees)
            out[t0:t1, r0:r0 + row_chunk] = level_leaves(
                part, level.slice(t0, t1), packed)
    return out


# -- quantized serving leaves (reference: ``quantize_leaves``,
# ``lightgbm_tpu/ops/predict.py:776-805``) ------------------------------------

def quantize_leaves(leaf_value: torch.Tensor, class_ids: torch.Tensor,
                    mode: str, num_class: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """``(slab, scale [T], bound)`` of a ``[T, L]`` leaf slab: ``int8``
    with the symmetric scale ``max|v| / 127`` a tree, or ``f16`` (scale 1).
    ``bound`` is the recorded bound on ``|quantized score - f32 score|``
    for any row: each tree's largest dequantization error, summed by class
    (tree ``t`` is class ``class_ids[t]``), the largest class's sum."""
    v = leaf_value.to(torch.float32)
    t = v.shape[0]
    if mode == "f16":
        slab = v.to(torch.float16)
        scale = torch.ones((t,), dtype=torch.float32, device=v.device)
        err_t = (slab.to(torch.float32) - v).abs().amax(dim=1)
    elif mode == "int8":
        amax = v.abs().amax(dim=1)
        scale = torch.where(amax > 0, amax / 127.0, 1.0)
        q = torch.clamp(torch.round(v / scale[:, None]), -127, 127)
        slab = q.to(torch.int8)
        err_t = (q * scale[:, None] - v).abs().amax(dim=1)
    else:
        raise ValueError(f"tpu_leaf_quant={mode!r}: expected int8|f16")
    per_class = torch.zeros(max(num_class, 1), dtype=torch.float32,
                            device=v.device)
    per_class.index_add_(0, class_ids.to(torch.int64), err_t)
    return slab, scale, float(per_class.max())
