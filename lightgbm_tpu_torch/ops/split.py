"""Best-split search over histograms, in torch.

Counterpart of the numerical path of ``lightgbm_tpu/ops/split.py``
(``best_split`` :281-480; reference: FeatureHistogram::
FindBestThresholdSequentially, src/treelearner/feature_histogram.hpp:832).
The scan is a cumulative sum over the bin axis of the whole ``[F, B]``
histogram, a masked gain and one argmax, with both missing-value
directions: "missing right" is the plain left-cumulative scan, "missing
left" adds the NaN-bin mass to the left side for thresholds below it.

Unlike the JAX function, ``best_split`` takes any leading batch shape
(``[..., F, B, K]``): the grower scans both children of a split in one
call. Everything stays on the device; nothing here reads a value back to
the host. Categorical, monotone, CEGB, path-smoothing and extra-trees
scans are ROADMAP A12/A14.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

_NEG_INF = -1e30
_EPS = 1e-15


class SplitParams(NamedTuple):
    """Split hyper-parameters (subset of the reference Config)."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: float = 20.0
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0


class SplitResult(NamedTuple):
    """Best split per leaf (reference: SplitInfo, split_info.hpp); every
    field has the batch shape of the scanned histograms."""
    gain: torch.Tensor          # shifted gain; > 0 means a valid split
    feature: torch.Tensor       # int64
    bin: torch.Tensor           # int64 threshold bin: left is bin <= t
    default_left: torch.Tensor  # bool
    left_grad: torch.Tensor
    left_hess: torch.Tensor
    left_count: torch.Tensor    # in-bag row count
    left_rows: torch.Tensor     # raw row count (drives the partition)


def threshold_l1(s: torch.Tensor, l1: float) -> torch.Tensor:
    """Soft-threshold by the L1 regularization (ThresholdL1)."""
    return torch.sign(s) * torch.clamp(torch.abs(s) - l1, min=0.0)


def leaf_output(sum_grad, sum_hess, p: SplitParams,
                l2: Optional[float] = None):
    """Optimal leaf value -ThL1(G)/(H + l2), clipped by max_delta_step
    (CalculateSplittedLeafOutput)."""
    if l2 is None:
        l2 = p.lambda_l2
    out = -threshold_l1(sum_grad, p.lambda_l1) / (sum_hess + l2 + _EPS)
    if p.max_delta_step > 0.0:
        out = torch.clamp(out, -p.max_delta_step, p.max_delta_step)
    return out


def leaf_gain(sum_grad, sum_hess, p: SplitParams,
              l2: Optional[float] = None):
    """Gain contribution of a leaf: ThL1(G)^2 / (H + l2) (GetLeafGain)."""
    if l2 is None:
        l2 = p.lambda_l2
    if p.max_delta_step > 0.0:
        w = leaf_output(sum_grad, sum_hess, p, l2)
        return -(2.0 * sum_grad * w + (sum_hess + l2) * w * w) \
            - 2.0 * p.lambda_l1 * torch.abs(w)
    t = threshold_l1(sum_grad, p.lambda_l1)
    return (t * t) / (sum_hess + l2 + _EPS)


def child_output(sum_grad, sum_hess, p: SplitParams):
    """Child output at split time. Path smoothing and monotone clipping
    are ROADMAP A14, so this is the plain leaf output."""
    return leaf_output(sum_grad, sum_hess, p)


def depth_gate(gain: torch.Tensor, depth, max_depth: int) -> torch.Tensor:
    """Mask a split candidate's gain by the tree-depth limit."""
    if max_depth <= 0:
        return gain
    return torch.where(depth < max_depth, gain,
                       torch.full_like(gain, _NEG_INF))


def go_left_pred(col: torch.Tensor, bin_, default_left, nan_bin, is_cat,
                 cat_bitset: torch.Tensor) -> torch.Tensor:
    """The left-child routing predicate shared by the partition, the
    histograms' cumulative semantics and prediction (Tree::Decision /
    Tree::CategoricalDecision). ``cat_bitset`` holds int32 words.
    ``is_cat`` is a host value, or a bool tensor on ``col``'s device that
    selects between the two predicates with no read back to the host."""
    col = col.to(torch.int64)
    num = (col <= bin_) | (default_left & (col == nan_bin))
    on_host = not isinstance(is_cat, torch.Tensor)
    if on_host and not is_cat:
        return num
    words = cat_bitset.to(torch.int64) & 0xFFFFFFFF
    w = col >> 5
    word = torch.where(w < words.shape[0],
                       words[torch.clamp(w, max=words.shape[0] - 1)], 0)
    cat = ((word >> (col & 31)) & 1) != 0
    return cat if on_host else torch.where(is_cat, cat, num)


def left_rows_of_split(hist: torch.Tensor, feature, bin_, default_left,
                       nan_bin) -> torch.Tensor:
    """Raw rows a numerical split routes left, from the raw-count channel
    of the histogram (every row of a bin routes alike)."""
    raw = hist[feature, :, 3]
    bins = torch.arange(hist.shape[1], device=hist.device)
    gl = (bins <= bin_) | (default_left & (bins == nan_bin))
    return (raw * gl).sum().to(torch.int32)


def best_split(
    hist: torch.Tensor,          # [..., F, B, K>=3] (grad, hess, cnt[, raw])
    parent_grad: torch.Tensor,   # [...]
    parent_hess: torch.Tensor,
    parent_count: torch.Tensor,
    num_bins: torch.Tensor,      # [F] int
    nan_bin: torch.Tensor,       # [F] int
    has_nan_bin: torch.Tensor,   # [F] bool
    feat_mask: torch.Tensor,     # [F] bool
    p: SplitParams,
) -> SplitResult:
    """Best (feature, threshold, missing direction) for each leaf."""
    f, b, k = hist.shape[-3:]
    batch = hist.shape[:-3]
    g = hist[..., 0]
    h = hist[..., 1]
    c = hist[..., 2]
    r = hist[..., 3] if k > 3 else c
    cg = torch.cumsum(g, dim=-1)
    ch = torch.cumsum(h, dim=-1)
    cc = torch.cumsum(c, dim=-1)
    cr = torch.cumsum(r, dim=-1)

    dev = hist.device
    t_iota = torch.arange(b, device=dev)[None, :]                # [1, B]
    nb = num_bins.to(dev, torch.int64)[:, None]                  # [F, 1]
    nanb = nan_bin.to(dev, torch.int64)

    # direction 2 ("missing left"): the NaN bin's mass joins the left side
    # for thresholds strictly below the NaN bin
    nan_idx = nanb.view(*([1] * len(batch)), f, 1).expand(*batch, f, 1)
    below = t_iota < nanb[:, None]                               # [F, B]

    def with_nan(x, cx):
        return cx + torch.where(below, torch.gather(x, -1, nan_idx), 0.0)

    left2 = [with_nan(x, cx) for x, cx in ((g, cg), (h, ch), (c, cc),
                                           (r, cr))]
    left1 = [cg, ch, cc, cr]

    pg = parent_grad[..., None, None]
    ph = parent_hess[..., None, None]
    pc = parent_count[..., None, None]
    gain_shift = leaf_gain(parent_grad, parent_hess, p)[..., None, None] \
        + p.min_gain_to_split
    fmask = feat_mask.to(dev)[:, None]

    def dir_score(lg, lh, lc, extra_valid):
        rg, rh, rc = pg - lg, ph - lh, pc - lc
        valid = (extra_valid & fmask
                 & (lc >= p.min_data_in_leaf) & (rc >= p.min_data_in_leaf)
                 & (lh >= p.min_sum_hessian_in_leaf)
                 & (rh >= p.min_sum_hessian_in_leaf))
        gain = leaf_gain(lg, lh, p) + leaf_gain(rg, rh, p) - gain_shift
        return torch.where(valid, gain, torch.full_like(gain, _NEG_INF))

    # numerical thresholds leave the last bin on the right
    tmask = t_iota < nb - 1
    score1 = dir_score(left1[0], left1[1], left1[2], tmask)
    dir2_ok = has_nan_bin.to(dev)[:, None] & below & tmask
    score2 = dir_score(left2[0], left2[1], left2[2], dir2_ok)

    flat = torch.stack([score1, score2], dim=-1).reshape(*batch, f * b * 2)
    best = torch.argmax(flat, dim=-1)                            # [...]
    best_gain = torch.gather(flat, -1, best[..., None])[..., 0]
    best_fb = best // 2
    best_dir2 = (best % 2) == 1

    def pick(x1, x2):
        v1 = torch.gather(x1.reshape(*batch, f * b), -1, best_fb[..., None])
        v2 = torch.gather(x2.reshape(*batch, f * b), -1, best_fb[..., None])
        return torch.where(best_dir2, v2[..., 0], v1[..., 0])

    return SplitResult(
        gain=best_gain,
        feature=best_fb // b,
        bin=best_fb % b,
        default_left=best_dir2,
        left_grad=pick(left1[0], left2[0]),
        left_hess=pick(left1[1], left2[1]),
        left_count=pick(left1[2], left2[2]),
        left_rows=pick(left1[3], left2[3]),
    )
