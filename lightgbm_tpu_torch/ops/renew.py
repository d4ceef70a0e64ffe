"""Leaf output renewal: each leaf's weighted quantile of its rows' residuals.

Counterpart of ``renew_leaf_quantile`` in ``lightgbm_tpu/ops/renew.py``
(reference: RegressionL1loss::RenewTreeOutput, src/objective/
regression_objective.hpp:197-232, PercentileFun :23-55), for
``regression_l1`` (alpha 0.5), ``quantile`` and ``mape``.

The JAX function sorts the residuals once and then maps over the leaves,
each with a masked cumulative sum over all N rows: L passes of N. Here the
rows are sorted once by (leaf, residual), with ties in residual kept in row
order by two stable sorts, as the JAX package's stable ``argsort`` keeps
them, and each leaf's segment is scanned by one cumulative sum: a fixed
number of launches a tree, whatever L is, and no host read. A leaf's
crossing is its first row (in residual order) of nonzero weight whose
cumulative weight reaches ``alpha * total``; the JAX function picks the
same row whenever the cumulative sums are exact (unit weights, or weights
on a 1/64 grid), since then the order of summation cannot move it. Empty
leaves, and leaves whose rows all weigh 0, get 0.

``hist_bits_in_leaf`` is the quantized pipeline's per-leaf choice between
the narrowed 16-bit and the 32-bit histogram engines.
"""
from __future__ import annotations

import torch

# the largest leaf (rows x quant_max) whose code sums fit the narrowed
# engine's 16-bit halves (reference: lightgbm_tpu/ops/renew.py:22-26)
_NARROW_LEAF_MAX = 1 << 15


def hist_bits_in_leaf(leaf_count, quant_max: int) -> torch.Tensor:
    """16 where a leaf's worst-case code sums fit the narrowed accumulation
    (``count * quant_max < 2^15``), else 32 (reference:
    ``hist_bits_in_leaf``, ``lightgbm_tpu/ops/renew.py:29-46``, after
    GradientDiscretizer::GetHistBitsInLeaf). ``leaf_count`` may be a
    tensor; the result is an int32 tensor. On the card the histogram kernel
    makes this choice itself, from the segment count it reads
    (``ops/pallas_histogram.py`` ``unfused_histogram``)."""
    cnt = torch.as_tensor(leaf_count).to(torch.float32)
    narrow = cnt * float(quant_max) < float(_NARROW_LEAF_MAX)
    return torch.where(narrow, 16, 32).to(torch.int32)


def renew_leaf_quantile(residual: torch.Tensor, weight: torch.Tensor,
                        row_leaf: torch.Tensor, num_leaves: int,
                        alpha: float) -> torch.Tensor:
    """``[L]`` f32 renewed leaf outputs from ``[N]`` f32 residuals (label
    minus the pre-tree score), ``[N]`` f32 weights (row weight times the
    in-bag mask; 0 leaves a row out) and ``[N]`` leaf ids."""
    n = residual.shape[0]
    dev = residual.device
    leaf = row_leaf.to(torch.int64)
    by_res = torch.argsort(residual, stable=True)
    order = by_res[torch.argsort(leaf[by_res], stable=True)]
    leaf_s = leaf[order]
    w_s = weight[order]
    # each leaf's rows form one segment of the sorted order
    count = torch.zeros(num_leaves, dtype=torch.int64, device=dev)
    count.index_add_(0, leaf_s, torch.ones_like(leaf_s))
    end = torch.cumsum(count, 0)
    start = end - count
    # cumulative weight within the segment (f64: exact wherever the f32
    # sums of the JAX function are)
    cw = torch.cumsum(w_s.to(torch.float64), 0)
    before = torch.cat([cw.new_zeros(1), cw])[start]
    cw_seg = cw - before[leaf_s]
    total = (torch.cat([cw.new_zeros(1), cw])[end] - before).to(
        torch.float32)
    # the target in f32, as the JAX function forms it (a Python float
    # scalar takes the tensor's dtype: f32(alpha) * total)
    target = (total * alpha).to(torch.float64)
    pos = torch.arange(n, device=dev)
    ok = (cw_seg >= target[leaf_s]) & (w_s > 0)
    first = torch.full((num_leaves,), n, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, leaf_s, torch.where(ok, pos, n), "amin")
    # a crossing always exists when total > 0; the segment's last row
    # stands in should f32 rounding of the target leave none
    first = torch.where(first < n, first, torch.clamp(end - 1, min=0))
    val = torch.cat([residual[order], residual.new_zeros(1)])[
        torch.clamp(first, max=n)]
    return torch.where(total > 0, val, torch.zeros_like(val))
