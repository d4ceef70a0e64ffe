"""Best-split search over histograms, in torch.

Counterpart of ``lightgbm_tpu/ops/split.py`` (``best_split`` :281-480,
``_sorted_cat_split`` :482, ``pack_bin_bitset`` :166; reference:
FeatureHistogram::FindBestThresholdSequentially and
FindBestThresholdCategoricalInner, src/treelearner/feature_histogram.hpp:832
and feature_histogram.cpp:243-339). The numerical scan is a cumulative sum
over the bin axis of the whole ``[F, B]`` histogram, a masked gain and one
argmax, with both missing-value directions: "missing right" is the plain
left-cumulative scan, "missing left" adds the NaN-bin mass to the left side
for thresholds below it. A categorical feature with at most
``max_cat_to_onehot`` bins splits one bin from the rest; a larger one sorts
its bins by ``g / (h + cat_smooth)`` and scans prefixes from both ends (at
most ``max_cat_threshold`` bins, ``lambda_l2 + cat_l2``, the
``min_data_per_group`` gate). A categorical split's left set is a bitset of
bins, as int32 words.

Unlike the JAX function, ``best_split`` takes any leading batch shape
(``[..., F, B, K]``): the grower scans both children of a split in one
call. Everything stays on the device; nothing here reads a value back to
the host, and Python branches only on static shapes and parameters. The
sorted scan's ``min_data_per_group`` gate, a sequential ``lax.scan`` in the
JAX package, is here a handful of tensor ops (see ``_group_gate``) rather
than a loop of launches over the prefix positions.

The scan's other options (``lightgbm_tpu/ops/split.py:349-409``,
``:563-595``): with monotone constraints or path smoothing the gains are
taken at the realized child outputs (smoothed toward the parent's output,
clipped to the leaf's ``[cmin, cmax]``); a numerical or one-hot candidate on
a constrained feature whose outputs run against its direction is vetoed,
and its gain is scaled by the depth penalty; CEGB subtracts each feature's
remaining coupled (and lazy) cost and the split cost times the leaf's
count; ``feature_contri`` scales positive gains. Extra trees evaluate one
random threshold a feature (and one random prefix size in the sorted
categorical scan): the draw is two random 32-bit words a feature, turned
into an integer below the feature's span at scan time exactly as
``jax.random.randint`` turns its two words into one (``extra_threshold``),
so the tests can feed the JAX package's words and get its thresholds.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as tnf

from .histogram import dequantize_hist
from .packed import bin_values

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
    # categorical splits (reference: config.h:480-501)
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    min_data_per_group: float = 100.0
    # monotone constraints (reference: BasicLeafConstraints,
    # monotone_constraints.hpp:465) and their split-gain penalty (:357)
    use_monotone: bool = False
    monotone_penalty: float = 0.0
    # path smoothing (CalculateSplittedLeafOutput USE_SMOOTHING)
    path_smooth: float = 0.0
    # cost-effective gradient boosting: tradeoff * cegb_penalty_split
    # (cost_effective_gradient_boosting.hpp DeltaGain)
    use_cegb: bool = False
    cegb_split_pen: float = 0.0
    # one random threshold a feature (USE_RAND in
    # FindBestThresholdSequentially)
    extra_trees: bool = False


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
    cat_bitset: torch.Tensor    # [..., W] int32 left bins of a cat split
    is_cat_l2: torch.Tensor     # bool: sorted cat split, l2 += cat_l2


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


def gain_given_output(sum_grad, sum_hess, w, p: SplitParams, l2=None):
    """A leaf's gain at a fixed output ``w`` (GetLeafGainGivenOutput), for
    outputs that smoothing or clipping moved off the optimum."""
    if l2 is None:
        l2 = p.lambda_l2
    sg = threshold_l1(sum_grad, p.lambda_l1)
    return -(2.0 * sg * w + (sum_hess + l2) * w * w)


def child_output(sum_grad, sum_hess, cnt, p: SplitParams, l2=None,
                 parent_output=0.0, cmin=None, cmax=None):
    """A child's output at split time (CalculateSplittedLeafOutput): the
    leaf output, smoothed toward ``parent_output`` by ``cnt / path_smooth``,
    then clipped to the monotone bounds ``[cmin, cmax]``."""
    w = leaf_output(sum_grad, sum_hess, p, l2)
    if p.path_smooth > 0.0:
        ratio = cnt / p.path_smooth
        w = w * ratio / (ratio + 1.0) + parent_output / (ratio + 1.0)
    if p.use_monotone and cmin is not None:
        w = torch.minimum(torch.maximum(w, cmin), cmax)
    return w


def monotone_penalty_factor(depth: torch.Tensor, penalty: float
                            ) -> torch.Tensor:
    """The gain factor of a split on a constrained feature at ``depth``
    (ComputeMonotoneSplitGainPenalty, monotone_constraints.hpp:357)."""
    d = depth.to(torch.float32)
    if penalty <= 1.0:
        out = 1.0 - penalty / torch.exp2(d) + _EPS
    else:
        out = 1.0 - torch.exp2(penalty - 1.0 - d) + _EPS
    return torch.where(penalty >= d + 1.0, torch.full_like(out, _EPS), out)


def extra_threshold(words: torch.Tensor, span: torch.Tensor) -> torch.Tensor:
    """An integer in ``[0, max(span, 1))`` from two random 32-bit words
    ``words[..., 0]`` (high) and ``words[..., 1]`` (low), int64 tensors, by
    the arithmetic of ``jax.random.randint`` (two words, each reduced modulo
    the span, the high one times ``2^32 mod span``)."""
    span = torch.clamp(span.to(torch.int64), min=1)
    mult = torch.remainder(torch.full_like(span, 1 << 16), span)
    mult = torch.remainder(mult * mult, span)
    return torch.remainder(torch.remainder(words[..., 0], span) * mult
                           + torch.remainder(words[..., 1], span), span)


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
    col = bin_values(col)
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


def pack_bin_bitset(mask: torch.Tensor) -> torch.Tensor:
    """``[..., B]`` bool bin membership -> ``[..., ceil(B / 32)]`` int32
    words (the bit patterns of the JAX package's uint32 words)."""
    b = mask.shape[-1]
    w = -(-b // 32)
    m = tnf.pad(mask.to(torch.int64), (0, w * 32 - b)).reshape(
        *mask.shape[:-1], w, 32)
    words = (m << torch.arange(32, device=mask.device)).sum(-1)
    return torch.where(words >= (1 << 31), words - (1 << 32),
                       words).to(torch.int32)


def extend_hist_efb(hist: torch.Tensor, efb, n_virtual: int, bmax: int
                    ) -> torch.Tensor:
    """Append one virtual histogram row per EFB-bundled original feature
    (``extend_hist_efb`` of the JAX package, ``ops/split.py:220-245``).

    ``hist`` is ``[..., C, B, K]`` over the stored columns (passthrough
    features and bundle columns). A bundled feature's non-default bins lie
    at ``offset + 1 .. offset + nb`` of its bundle column; its default bin
    takes the leaf total minus that range (reference: FixHistogram,
    include/LightGBM/bin.h). The scan then treats the virtual rows as
    ordinary numerical features. ``efb`` is the ``io/efb.py`` ``EfbLayout``
    of ``boosting/gbdt.py`` ``_setup_efb``; everything stays on the device.
    An int32 (quantized) histogram stays int32, its sums exact."""
    c, b = hist.shape[-3], hist.shape[-2]
    bcol = efb.col_of[c:]                                       # [Fb]
    off, nb, dbin = efb.off[c:], efb.nb[c:], efb.dbin[c:]
    j = torch.arange(bmax, device=hist.device)[None, :]         # [1, Bmax]
    idx = torch.clamp(off[:, None] + 1 + j, max=b - 1)
    gathered = hist[..., bcol[:, None], idx, :]         # [.., Fb, Bmax, K]
    gathered = gathered * (j < nb[:, None])[..., None]
    # leaf totals [.., K]; the sums keep the histogram's dtype (torch sums
    # int32 into int64 by default)
    totals = hist[..., 0, :, :].sum(dim=-2, dtype=hist.dtype)
    default = totals[..., None, :] - gathered.sum(dim=-2, dtype=hist.dtype)
    at_dbin = (j == dbin[:, None])[..., None]                   # [Fb, Bmax, 1]
    virtual = gathered + at_dbin * default[..., None, :]
    virtual = tnf.pad(virtual, (0, 0, 0, b - bmax))
    return torch.cat([hist, virtual], dim=-3)


def apply_efb_bitset(sp: SplitResult, efb, n_cols: int, num_bins: int
                     ) -> SplitResult:
    """A winning split on a virtual (bundled) feature as a bitset on its
    bundle column (``apply_efb_bitset`` of the JAX package, ``ops/split.py:
    248-268``), so the partition routes it as a ready-made categorical-style
    split: left = {v in (off, off + 1 + t]} | {v outside the member's range,
    when the member's default bin <= t}. Splits on stored columns keep their
    bitset."""
    f = sp.feature
    o = efb.off[f][..., None]
    nb = efb.nb[f][..., None]
    d = efb.dbin[f][..., None]
    t = sp.bin[..., None]
    v = torch.arange(num_bins, device=f.device)
    in_r = (v > o) & (v <= o + nb)
    left = (in_r & (v <= o + 1 + t)) | (~in_r & (d <= t))
    bits = pack_bin_bitset(left)
    return sp._replace(cat_bitset=torch.where((f >= n_cols)[..., None], bits,
                                              sp.cat_bitset))


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
    feat_mask: torch.Tensor,     # [F] or [..., F] bool (a leaf's own)
    p: SplitParams,
    is_cat: Optional[torch.Tensor] = None,   # [F] bool; None: numerical
    quant_scales=None,           # (g_scale, h_scale) 0-d f32 tensors
    *,
    mono_types: Optional[torch.Tensor] = None,    # [F] int in {-1, 0, 1}
    cmin: Optional[torch.Tensor] = None,          # [...] output bounds
    cmax: Optional[torch.Tensor] = None,
    parent_output: Optional[torch.Tensor] = None,  # [...] (path_smooth)
    depth: Optional[torch.Tensor] = None,         # [...] (monotone_penalty)
    cegb_pen: Optional[torch.Tensor] = None,      # [..., F] feature costs
    extra_words: Optional[torch.Tensor] = None,   # [..., F, 2] (extra_trees)
    extra_words_cat: Optional[torch.Tensor] = None,  # [..., F, 2]
    feature_contri: Optional[torch.Tensor] = None,  # [F] gain factors
) -> SplitResult:
    """Best (feature, threshold, missing direction) for each leaf; with
    ``is_cat``, also the best categorical split (one-hot or sorted) of the
    categorical features. With ``quant_scales`` the histogram holds int32
    sums of quantized-gradient codes, dequantized here before any gain
    (reference: ``best_split(quant_scales=)``, ``lightgbm_tpu/ops/split.py:
    300-312``), so the constrained gains below take dequantized sums.

    The keyword arguments are the scan's other options (module docstring),
    each used when its ``SplitParams`` switch is on: ``mono_types``,
    ``cmin``/``cmax`` (``use_monotone``), ``parent_output``
    (``path_smooth``), ``depth`` (``monotone_penalty``), ``cegb_pen``
    (``use_cegb``; None counts as zero), ``extra_words`` and
    ``extra_words_cat`` (``extra_trees``: the numerical/one-hot threshold's
    and the sorted prefix size's words), ``feature_contri`` (None: off)."""
    if quant_scales is not None:
        hist = dequantize_hist(hist, *quant_scales)
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
    # numerical thresholds leave the last bin on the right
    tmask = t_iota < nb - 1
    dir2_ok = has_nan_bin.to(dev)[:, None] & below & tmask
    if is_cat is not None:
        # a one-hot categorical candidate's left side is the one bin t, and
        # any bin (the last too) may be it
        cat_b = is_cat.to(dev)[:, None]
        left1 = [torch.where(cat_b, x, cx) for x, cx in zip((g, h, c, r),
                                                             left1)]
        onehot_ok = cat_b & (nb <= p.max_cat_to_onehot)
        tmask = torch.where(cat_b, onehot_ok & (t_iota < nb), tmask)
        dir2_ok = dir2_ok & ~cat_b

    if p.extra_trees:
        # one random candidate threshold a feature: a numerical threshold
        # below num_bins - 1, a one-hot category any bin
        hi = nb[:, 0] - 1 if is_cat is None else torch.where(
            is_cat.to(dev), nb[:, 0], nb[:, 0] - 1)
        pick = t_iota == extra_threshold(extra_words, hi)[..., None]
        tmask = tmask & pick
        dir2_ok = dir2_ok & pick

    pg = parent_grad[..., None, None]
    ph = parent_hess[..., None, None]
    pc = parent_count[..., None, None]
    gain_shift0 = leaf_gain(parent_grad, parent_hess, p) + p.min_gain_to_split
    gain_shift = gain_shift0[..., None, None]
    fmask = feat_mask.to(dev)[..., None]
    constrained = p.use_monotone or p.path_smooth > 0.0
    if constrained:
        po = (parent_output if parent_output is not None
              else torch.zeros_like(parent_grad))[..., None, None]
        cmn = cmin[..., None, None] if p.use_monotone else None
        cmx = cmax[..., None, None] if p.use_monotone else None
    mt = (mono_types.to(dev)[:, None] if p.use_monotone
          and mono_types is not None else None)
    pen_f = (cegb_pen[..., None] if p.use_cegb and cegb_pen is not None
             else None)
    contri = (feature_contri.to(dev)[:, None] if feature_contri is not None
              else None)

    def dir_score(lg, lh, lc, extra_valid):
        rg, rh, rc = pg - lg, ph - lh, pc - lc
        valid = (extra_valid & fmask
                 & (lc >= p.min_data_in_leaf) & (rc >= p.min_data_in_leaf)
                 & (lh >= p.min_sum_hessian_in_leaf)
                 & (rh >= p.min_sum_hessian_in_leaf))
        if constrained:
            # gains at the realized (smoothed, clipped) outputs
            lw = child_output(lg, lh, lc, p, None, po, cmn, cmx)
            rw = child_output(rg, rh, rc, p, None, po, cmn, cmx)
            gain = gain_given_output(lg, lh, lw, p) \
                + gain_given_output(rg, rh, rw, p) - gain_shift
            if mt is not None:
                valid = valid & ~((mt > 0) & (lw > rw)) \
                    & ~((mt < 0) & (lw < rw))
                if p.monotone_penalty > 0.0:
                    pen = monotone_penalty_factor(
                        depth, p.monotone_penalty)[..., None, None]
                    gain = torch.where(mt != 0, gain * pen, gain)
        else:
            gain = leaf_gain(lg, lh, p) + leaf_gain(rg, rh, p) - gain_shift
        if p.use_cegb:
            if pen_f is not None:
                gain = gain - pen_f
            gain = gain - p.cegb_split_pen * pc
        if contri is not None:
            gain = torch.where(gain > 0, gain * contri, gain)
        return torch.where(valid, gain, torch.full_like(gain, _NEG_INF))

    score1 = dir_score(left1[0], left1[1], left1[2], tmask)
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

    out = SplitResult(
        gain=best_gain,
        feature=best_fb // b,
        bin=best_fb % b,
        default_left=best_dir2,
        left_grad=pick(left1[0], left2[0]),
        left_hess=pick(left1[1], left2[1]),
        left_count=pick(left1[2], left2[2]),
        left_rows=pick(left1[3], left2[3]),
        cat_bitset=torch.zeros((*batch, -(-b // 32)), dtype=torch.int32,
                               device=dev),
        is_cat_l2=torch.zeros(batch, dtype=torch.bool, device=dev),
    )
    if is_cat is None:
        return out
    # the one-hot winner's bitset: its single bin
    best_cat = is_cat.to(dev)[out.feature]
    onehot = (torch.arange(b, device=dev) == out.bin[..., None]) \
        & best_cat[..., None]
    out = out._replace(cat_bitset=pack_bin_bitset(onehot))
    srt = _sorted_cat_split(hist, is_cat.to(dev), num_bins.to(dev),
                            feat_mask.to(dev), parent_grad, parent_hess,
                            parent_count, gain_shift0, p,
                            po[..., 0, 0] if constrained else None,
                            cmin, cmax, cegb_pen, extra_words_cat,
                            feature_contri)
    if srt is None:
        return out
    use = srt.gain > out.gain
    return SplitResult(*(torch.where(
        use[(...,) + (None,) * (a.dim() - use.dim())], s_, a)
        for a, s_ in zip(out, srt)))


def _group_gate(lc_t, cond, min_data_per_group: float) -> torch.Tensor:
    """Which prefix sizes the sorted scan evaluates (reference:
    FindBestThresholdCategoricalInner's ``cnt_cur_group``). Walking t = 1..T,
    a size whose other conditions hold (``cond``) is evaluated when the rows
    added since the last evaluated size (or since the start) reach
    ``min_data_per_group``; the count then restarts. ``lc_t [..., T, 2]``
    holds the left child's count at each size, so the rows since size s are
    ``lc_t[t] - lc_t[s]``. Each size's next evaluated size is a masked
    argmax over the sizes after it, and the chain from the start follows by
    pointer doubling (log2 T steps), with no loop over T."""
    *lead, t_len, two = lc_t.shape
    dev = lc_t.device
    base = torch.cat([torch.zeros((*lead, 1, two), dtype=lc_t.dtype,
                                  device=dev), lc_t], dim=-2)   # [.., T+1, 2]
    ts = torch.arange(1, t_len + 1, device=dev)
    after = ts[None, :] > torch.arange(t_len + 1, device=dev)[:, None]
    ok = (after[:, :, None] & cond[..., None, :, :]
          & (lc_t[..., None, :, :] - base[..., :, None, :]
             >= min_data_per_group))                  # [.., T+1 (s), T, 2]
    first = torch.argmax(ok.to(torch.float32), dim=-2) + 1
    end = t_len + 1
    nxt = torch.where(ok.any(dim=-2), first, end)     # [.., T+1, 2]
    nxt = torch.cat([nxt, torch.full_like(nxt[..., :1, :], end)], dim=-2)
    reach = nxt[..., :1, :]                           # one step from start
    jump = nxt
    for _ in range((t_len - 1).bit_length()):
        reach = torch.cat([reach, torch.gather(jump, -2, reach)], dim=-2)
        jump = torch.gather(jump, -2, jump)
    return (reach[..., None, :, :] == ts[:, None, None]).any(dim=-2)


def _sorted_cat_split(hist, is_cat, num_bins, feat_mask, parent_grad,
                      parent_hess, parent_count, gain_shift,
                      p: SplitParams, parent_output=None, cmin=None,
                      cmax=None, cegb_pen=None, extra_words=None,
                      feature_contri=None) -> Optional[SplitResult]:
    """Best sorted-many-category split over all features of each leaf
    (``_sorted_cat_split`` of the JAX package); None when no prefix size can
    exist (static). ``hist``: ``[..., F, B, K]``; the channels are sorted,
    summed and read together. The options as in ``best_split``, with no
    monotone veto or penalty (the reference's categorical branch has
    none)."""
    *batch, f, b, k = hist.shape
    mct = int(min(p.max_cat_threshold, b))
    if mct <= 0 or b <= 1:
        return None
    dev = hist.device
    g, h, c = hist[..., 0], hist[..., 1], hist[..., 2]
    l2c = p.lambda_l2 + p.cat_l2
    sort_mode = is_cat & (num_bins > p.max_cat_to_onehot) & feat_mask  # [F]
    elig = sort_mode[..., None] & (c >= p.cat_smooth)                 # [.., F, B]
    used_bin = elig.sum(dim=-1)                                     # [.., F]
    ratio = torch.where(elig, g / (h + p.cat_smooth),
                        torch.full_like(g, float("inf")))
    order = torch.argsort(ratio, dim=-1, stable=True)
    srt = torch.gather(hist, -2, order[..., None].expand(*batch, f, b, k))
    csum = tnf.pad(torch.cumsum(srt, dim=-2), (0, 0, 1, 0))        # [.., F, B+1, K]

    # left sums of the first t sorted bins (forward) and of the last t
    # eligible ones (reverse), t = 1..T: csum[t] and csum[used] - csum[used-t]
    ts = torch.arange(1, mct + 1, device=dev)                       # [T]
    tot = used_bin[..., None]                                       # [.., F, 1]
    idx = torch.cat([tot, torch.clamp(ts, max=b).expand(*batch, f, mct),
                     torch.clamp(tot - ts, min=0)], dim=-1)
    at_idx = torch.gather(csum, -2, idx[..., None].expand(*batch, f,
                                                          2 * mct + 1, k))
    top = at_idx[..., :1, :]
    pre = torch.stack([at_idx[..., 1:mct + 1, :],
                       top - at_idx[..., mct + 1:, :]], dim=-2)   # [.., F, T, 2, K]
    lg, lh, lc = pre[..., 0], pre[..., 1], pre[..., 2]
    lr = pre[..., 3] if k > 3 else lc
    max_num_cat = torch.clamp((used_bin + 1) // 2, max=mct)
    in_range = ((ts <= used_bin[..., None]) & (ts <= max_num_cat[..., None])
                & sort_mode[..., None])[..., None]                    # [.., F, T, 1]

    def lead(x):
        return x[..., None, None, None]
    pg, ph, pc = lead(parent_grad), lead(parent_hess), lead(parent_count)
    rg, rh, rc = pg - lg, ph - lh, pc - lc
    left_ok = (lc >= p.min_data_in_leaf) & (lh >= p.min_sum_hessian_in_leaf)
    brk = ((rc < p.min_data_in_leaf) | (rc < p.min_data_per_group)
           | (rh < p.min_sum_hessian_in_leaf))
    # a size whose right side is too small ends the scan in that direction
    ended = torch.cummax((in_range & brk).to(torch.int32), dim=-2)[0] != 0
    dead = torch.cat([torch.zeros_like(ended[..., :1, :]),
                      ended[..., :-1, :]], dim=-2)
    cond = in_range & ~dead & left_ok & ~brk
    evald = _group_gate(lc, cond, p.min_data_per_group)
    if p.use_monotone or p.path_smooth > 0.0:
        po = lead(parent_output)
        cmn = lead(cmin) if p.use_monotone else None
        cmx = lead(cmax) if p.use_monotone else None
        lw = child_output(lg, lh, lc, p, l2c, po, cmn, cmx)
        rw = child_output(rg, rh, rc, p, l2c, po, cmn, cmx)
        gains = gain_given_output(lg, lh, lw, p, l2c) \
            + gain_given_output(rg, rh, rw, p, l2c) - lead(gain_shift)
    else:
        gains = leaf_gain(lg, lh, p, l2c) + leaf_gain(rg, rh, p, l2c) \
            - lead(gain_shift)
    if p.use_cegb:
        if cegb_pen is not None:
            gains = gains - cegb_pen[..., None, None]
        gains = gains - p.cegb_split_pen * pc
    if feature_contri is not None:
        gains = torch.where(gains > 0,
                            gains * feature_contri[:, None, None], gains)
    if p.extra_trees:
        # one random prefix size a feature
        rnd = extra_threshold(extra_words, max_num_cat)
        gains = torch.where(
            torch.arange(mct, device=dev)[:, None] == rnd[..., None, None],
            gains, torch.full_like(gains, _NEG_INF))
    gains = torch.where(evald, gains, torch.full_like(gains, _NEG_INF))

    flat = gains.reshape(*batch, f * mct * 2)
    cb = torch.argmax(flat, dim=-1)                                 # [...]
    cf = cb // (mct * 2)
    t_best = (cb // 2) % mct + 1
    rev = (cb % 2) == 1
    pos = torch.arange(b, device=dev)
    ub = torch.gather(used_bin, -1, cf[..., None])                  # [.., 1]
    tb = t_best[..., None]
    pos_mask = torch.where(rev[..., None], (pos >= ub - tb) & (pos < ub),
                           pos < tb)                                # [.., B]
    order_f = torch.gather(order, -2, cf[..., None, None].expand(
        *batch, 1, b))[..., 0, :]
    bin_mask = torch.zeros_like(pos_mask).scatter(-1, order_f, pos_mask)

    def at(x):
        return torch.gather(x.reshape(*batch, -1), -1, cb[..., None])[..., 0]
    zero = torch.zeros_like(cf)
    return SplitResult(
        gain=at(gains), feature=cf, bin=zero, default_left=zero != 0,
        left_grad=at(lg), left_hess=at(lh), left_count=at(lc),
        left_rows=at(lr), cat_bitset=pack_bin_bitset(bin_mask),
        is_cat_l2=zero == 0)
