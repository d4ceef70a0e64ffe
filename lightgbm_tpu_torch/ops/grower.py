"""Tree-growth parameters, the struct-of-arrays tree and the masked grower.

Counterpart of ``lightgbm_tpu/ops/grower.py``: ``GrowerParams`` and
``TreeArrays`` with the fields the serial numerical growers read, and
``grow_tree``, the masked leaf-wise grower (reference:
SerialTreeLearner::Train, serial_tree_learner.cpp:179). Rows never move:
a dense ``row_leaf [N]`` vector says which leaf holds each row, each split
builds the SMALLER child's histogram with one pass over all N rows whose
channels are zeroed outside that child, and the larger child is parent
minus smaller. The trainer picks it below 65,536 rows; above, the compact
grower (``ops/grower_compact.py``) moves rows into contiguous segments.

Like the JAX grower and the compact grower, the whole tree grows with no
device-to-host read: the loop runs ``num_leaves - 1`` times, and a split
that is not applied (no positive gain left) is unconditional work whose
results ``torch.where`` discards, where the JAX grower skips it with
``lax.cond``. Its histogram then has all-zero channels, which the kernels
skip row by row.

Categorical features (``is_cat_arr``): the scan also proposes one-hot and
sorted categorical splits, each leaf caches its best split's bin bitset
and whether it is a sorted one (whose children's outputs take ``lambda_l2 +
cat_l2``), and the partition routes by the bitset through the same
predicate as the numerical split (``go_left_pred`` selects on the device).
By-node feature sampling (``params.bynode_fraction`` < 1): each leaf scans
only its own sample of the tree's features, drawn from row ``j`` of a
``[2L-1, F]`` uniform tensor made before the tree (``node_feature_mask``):
row 0 for the root, rows ``2k+1`` and ``2k+2`` for the children of split
``k``, as the JAX grower folds ``j`` into its by-node key.

Constraints and the scan's other options (``TreeOptions``; reference:
``lightgbm_tpu/ops/grower.py:431-487``, ``:662-778``): interaction
constraints restrict a leaf's features to the union of the constraint sets
that hold every feature on its path (``leaf_used``), before the by-node
draw; each leaf carries its monotone bounds (``_CMIN``, ``_CMAX``), which a
numerical split on a constrained feature tightens at the midpoint of the
children's outputs (the basic method); the children's outputs are fixed at
split time, smoothed toward the parent's output (the leaf's own ``_LOUT``)
and clipped to the parent's bounds. CEGB's coupled costs are paid once a
model (``cegb_used``), its lazy costs once a (row, feature)
(``cegb_charged [F, N]``, charged for the parent's in-bag rows at each
split). Extra trees draw their thresholds from ``[2L-1, F, 2]`` random
words, rows numbered as the by-node draws. Forced splits (``forced``, the
host schedule of ``boosting/gbdt.py`` ``_forced_split_schedule``; reference:
``lightgbm_tpu/ops/grower.py:554-586``): split ``k`` of the schedule takes
its (leaf, feature, bin) whatever the gains, its left sums a cumulative read
of that feature's row of the leaf's histogram, default right and gain 0.
Voting and the data-parallel reduction are not here (ROADMAP A18). The JAX
package's compile ladder (leaf rungs, depth buckets) fixes XLA jit keys
and has no counterpart in eager PyTorch: trees grow at the exact
``num_leaves``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .determinism import cumsum as det_cumsum
from .histogram import histogram
from .split import (_NEG_INF, SplitParams, best_split, child_output,
                    depth_gate, go_left_pred, leaf_output)

# columns of the growers' per-leaf float table: sums, cached best split,
# output (fixed at split time; path smoothing's parent output for the
# leaf's children) and monotone output bounds
(_LG, _LH, _LC, _BG, _BLG, _BLH, _BLC, _LOUT, _CMIN, _CMAX) = range(10)
_LEAF_F = 10
# an unbounded leaf's monotone bounds (reference: +-3.4e38)
_BIG = 3.4e38
# columns of the per-node tables
(_SF, _SB, _SDL, _LEFT, _RIGHT) = range(5)
(_GAIN, _NG, _NH, _NC) = range(4)
# columns of the masked grower's per-leaf int table: tree links, cached
# best split (feature, bin, default left, left raw rows, sorted-cat flag)
(_PARENT, _PSIDE, _DEPTH, _BF, _BB, _BDL, _BLR, _BCL2) = range(8)


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
    # categorical splits (reference: config.h:480-501)
    max_cat_threshold: int = 32
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    max_cat_to_onehot: int = 4
    min_data_per_group: float = 100.0
    # the masked grower's histogram layout (config.resolve_hist_layout):
    # "lane" runs K1 on [N, F] bins, "sublane" K3 on [F, N] bins (B <= 64)
    hist_layout: str = "lane"
    # the compact grower's K2 variant: dual residency, or copy-back (every
    # segment in `work`, the JAX package's choice on EFB-bundled data)
    fused_dual: bool = True
    # the compact grower with the fused split kernel (tpu_fused auto|on), or
    # without it (off): K2's partition alone, then the smaller child's
    # histogram by K1 dense or K3 (copy-back residency)
    fused: bool = True
    # quantized codes: the narrowed 16-bit histogram engine, chosen a leaf
    # at a time (ops/renew.py hist_bits_in_leaf; tpu_quant_hist_bits=16,
    # without the fused kernel only), and its |code| bound
    # (num_grad_quant_bins + 1)
    quant_narrow: bool = False
    quant_max: int = 127
    # 4-bit packed bin columns in the records (tpu_bin_pack4; the operative
    # switch is RowLayout.packed4, this mirrors it)
    bin_pack4: bool = False
    # EFB (compact grower): virtual features scanned after the stored
    # columns, and the widest bundled feature's bin count
    efb_virtual: int = 0
    efb_bmax: int = 0
    # feature_fraction_bynode: the share of the tree's features a leaf scans
    bynode_fraction: float = 1.0
    # constraints and the scan's other options (ops/split.py SplitParams);
    # mono_intermediate: the intermediate monotone method (compact grower)
    use_monotone: bool = False
    monotone_penalty: float = 0.0
    mono_intermediate: bool = False
    path_smooth: float = 0.0
    use_interaction: bool = False
    use_cegb: bool = False
    cegb_split_pen: float = 0.0
    extra_trees: bool = False

    def split_params(self) -> SplitParams:
        return SplitParams(
            lambda_l1=self.lambda_l1,
            lambda_l2=self.lambda_l2,
            min_data_in_leaf=self.min_data_in_leaf,
            min_sum_hessian_in_leaf=self.min_sum_hessian_in_leaf,
            min_gain_to_split=self.min_gain_to_split,
            max_delta_step=self.max_delta_step,
            max_cat_threshold=self.max_cat_threshold,
            cat_l2=self.cat_l2,
            cat_smooth=self.cat_smooth,
            max_cat_to_onehot=self.max_cat_to_onehot,
            min_data_per_group=self.min_data_per_group,
            use_monotone=self.use_monotone,
            monotone_penalty=self.monotone_penalty,
            path_smooth=self.path_smooth,
            use_cegb=self.use_cegb,
            cegb_split_pen=self.cegb_split_pen,
            extra_trees=self.extra_trees,
        )

    @property
    def bitset_words(self) -> int:
        return -(-self.num_bins // 32)


class ExtraDraws(NamedTuple):
    """A tree's extra-trees draws: two random 32-bit words (int64) for each
    (row, feature), the row of a node numbered as ``bynode_u``'s (0 the
    root, ``2k+1`` and ``2k+2`` the children of split ``k``)."""
    node: torch.Tensor                      # [2L-1, F, 2] thresholds
    cat: torch.Tensor                       # [2L-1, F, 2] sorted prefixes
    # the intermediate method's rescans: [L-1, L, F, 2] each, row (k, i)
    # for leaf i after split k
    rescan: Optional[torch.Tensor] = None
    rescan_cat: Optional[torch.Tensor] = None


class TreeOptions(NamedTuple):
    """A tree's constraint and option inputs, each None when off (the
    switches are in ``GrowerParams``)."""
    mono_types: Optional[torch.Tensor] = None     # [F] int64 in {-1, 0, 1}
    inter_sets: Optional[torch.Tensor] = None     # [S, F] bool
    cegb_coupled: Optional[torch.Tensor] = None   # [F] f32 tradeoff * costs
    cegb_used: Optional[torch.Tensor] = None      # [F] bool, model-level
    cegb_lazy: Optional[torch.Tensor] = None      # [F] f32 (masked grower)
    cegb_charged: Optional[torch.Tensor] = None   # [F, N] bool, model-level
    feature_contri: Optional[torch.Tensor] = None  # [F] f32
    extra: Optional[ExtraDraws] = None


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


def _split_rows(sp) -> Tuple[torch.Tensor, torch.Tensor]:
    """[2, 4] f32 and [2, 5] int64 cached-best-split columns (gain, left
    sums; feature, bin, default_left, left raw rows, sorted-cat flag) for a
    batch of two scanned leaves."""
    fl = torch.stack([sp.gain, sp.left_grad, sp.left_hess, sp.left_count],
                     dim=1)
    it = torch.stack([sp.feature, sp.bin, sp.default_left.to(torch.int64),
                      sp.left_rows.to(torch.int64),
                      sp.is_cat_l2.to(torch.int64)], dim=1)
    return fl, it


def node_feature_mask(feat_mask: torch.Tensor,
                      uniforms: Optional[torch.Tensor], fraction: float,
                      used: Optional[torch.Tensor] = None,
                      inter_sets: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """The features a leaf scans (``[..., F]`` bool; reference:
    ``node_feature_mask``, ``lightgbm_tpu/ops/grower.py:323-341``). With
    ``inter_sets [S, F]``, ``feat_mask`` narrows to the union of the
    constraint sets that hold every feature of ``used [..., F]`` (the
    features on the leaf's path). Then, with ``fraction`` < 1, a feature
    stays where its uniform draw is below ``fraction``, or all stay when
    that keeps none (a Bernoulli sample where LightGBM's
    ColSampler::GetByNode draws an exact count)."""
    fm = feat_mask
    if inter_sets is not None:
        subset = ~(used[..., None, :] & ~inter_sets).any(dim=-1)   # [.., S]
        fm = fm & (subset[..., :, None] & inter_sets).any(dim=-2)
    if fraction >= 1.0:
        return fm
    keep = uniforms < fraction
    keep = keep | ~(keep & fm).any(dim=-1, keepdim=True)
    return fm & keep


def lazy_uncharged(charged: torch.Tensor, rows: torch.Tensor
                   ) -> torch.Tensor:
    """``[..., F]`` f32: for each row set of ``rows [..., N]`` (bool), its
    rows not yet charged for each feature (reference: the lazy CEGB
    matrix-vector product, ``lightgbm_tpu/ops/grower.py:759-768``),
    counted in int64 over feature chunks of ``charged [F, N]`` so that no
    ``[F, N]`` f32 copy is made."""
    f, n = charged.shape
    lead = rows.shape[:-1]
    rows = rows.reshape(-1, n)
    step = max(1, (1 << 26) // max(n * rows.shape[0], 1))
    parts = [(rows[None] & ~charged[j:j + step, None, :]).sum(dim=-1)
             for j in range(0, f, step)]
    return torch.cat(parts).T.reshape(*lead, f).to(torch.float32)


def bound_children(mt, act, lw, rw, cminp, cmaxp, intermediate: bool):
    """The children's monotone bounds after a split on a feature of
    direction ``mt`` (``act``: the split is applied and numerical): the
    basic method bounds both at the midpoint of their outputs
    (BasicLeafConstraints), the intermediate one each by its sibling's
    output (``lightgbm_tpu/ops/grower_compact.py:638-663``). Returns
    ``(cmin_l, cmax_l, cmin_r, cmax_r)``."""
    up, down = act & (mt > 0), act & (mt < 0)
    if intermediate:
        at_l, at_r = rw, lw
    else:
        at_l = at_r = 0.5 * (lw + rw)
    return (torch.where(down, torch.maximum(cminp, at_l), cminp),
            torch.where(up, torch.minimum(cmaxp, at_l), cmaxp),
            torch.where(up, torch.maximum(cminp, at_r), cminp),
            torch.where(down, torch.minimum(cmaxp, at_r), cmaxp))


def child_l2(params: GrowerParams, cat_l2_flag: torch.Tensor):
    """The L2 of a split's children: ``lambda_l2 + cat_l2`` below a sorted
    categorical split (reference: the categorical branch's l2)."""
    return params.lambda_l2 + params.cat_l2 * cat_l2_flag.to(torch.float32)


def tree_arrays(node_i: torch.Tensor, node_f: torch.Tensor,
                node_bits: torch.Tensor, leaf_f: torch.Tensor,
                leaf_i: torch.Tensor, depth_col: int, parent_col: int,
                num_nodes: torch.Tensor, spp: SplitParams) -> TreeArrays:
    """The grown tree from the growers' tables. The leaf values are the
    outputs fixed at split time; the internal values are the nodes' plain
    leaf outputs (as the reference writes them)."""
    L = leaf_f.shape[0]
    nn = num_nodes[0]
    return TreeArrays(
        split_feature=node_i[:L - 1, _SF],
        split_bin=node_i[:L - 1, _SB],
        cat_bitset=node_bits[:L - 1],
        split_gain=node_f[:L - 1, _GAIN],
        default_left=node_i[:L - 1, _SDL] != 0,
        left_child=node_i[:L - 1, _LEFT],
        right_child=node_i[:L - 1, _RIGHT],
        leaf_value=leaf_f[:, _LOUT].clone(),
        leaf_weight=leaf_f[:, _LH],
        leaf_count=leaf_f[:, _LC],
        leaf_parent=leaf_i[:, parent_col],
        leaf_depth=leaf_i[:, depth_col],
        internal_value=leaf_output(node_f[:L - 1, _NG], node_f[:L - 1, _NH],
                                   spp),
        internal_weight=node_f[:L - 1, _NH],
        internal_count=node_f[:L - 1, _NC],
        num_leaves=nn + 1,
        num_nodes=nn,
    )


def grow_tree(binned: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              cnt_weight: torch.Tensor, num_bins_arr: torch.Tensor,
              nan_bin_arr: torch.Tensor, has_nan_arr: torch.Tensor,
              feat_mask: torch.Tensor, params: GrowerParams,
              binned_t: Optional[torch.Tensor] = None,
              is_cat_arr: Optional[torch.Tensor] = None,
              bynode_u: Optional[torch.Tensor] = None,
              opts: Optional[TreeOptions] = None,
              forced: Optional[Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]] = None,
              det: Optional[torch.Tensor] = None
              ) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree over ``binned [N, F]`` (uint8, or the int16 view of
    16-bit bins, ``ops/packed.py``) with per-row ``grad``,
    ``hess`` (already multiplied by weights and bag mask) and
    ``cnt_weight`` (the bag mask); returns ``(TreeArrays, row_leaf [N])``
    (reference: ``grow_tree``, ``lightgbm_tpu/ops/grower.py:343``).
    ``binned_t`` is the same matrix feature-major (``[F, N]``), which the
    partition reads a feature row of and the sublane layout's K3 takes; a
    trainer makes it once, else it is made here. ``is_cat_arr [F]`` bool
    marks the categorical features (None: all numerical). ``bynode_u``
    ``[2L-1, F]``: the tree's by-node draws when ``params.bynode_fraction``
    < 1 (see ``node_feature_mask``). ``opts``: the constraint and option
    inputs (``TreeOptions``); ``opts.cegb_charged`` is updated in place.
    ``forced``: ``(leaf, feature, bin)`` int64 tensors of the splits that
    come first, whatever their gains. ``det``: the deterministic mode's
    ``[3]`` fixed-point scales of the (grad, hess, count) channels for this
    tree (``ops/determinism.py``), or None.
    The intermediate monotone method is the compact grower's: here
    ``params.mono_intermediate`` runs the basic method."""
    dev = binned.device
    n, f = binned.shape
    L = params.num_leaves
    B = params.num_bins
    W = params.bitset_words
    spp = params.split_params()
    i64 = torch.int64
    any_cat = is_cat_arr is not None
    o = opts if opts is not None else TreeOptions()
    mono = o.mono_types if params.use_monotone else None
    inter = o.inter_sets if params.use_interaction else None
    extra = o.extra if params.extra_trees else None
    lazy = o.cegb_lazy if params.use_cegb else None
    if binned_t is None:
        binned_t = binned.T.contiguous()
    grad = grad.to(torch.float32)
    hess = hess.to(torch.float32)
    cnt = cnt_weight.to(torch.float32)
    bag = cnt_weight != 0

    def hist3(mask):
        ch = torch.stack([grad * mask, hess * mask, cnt * mask], dim=1)
        return histogram(binned, ch, B, params.hist_layout, binned_t,
                         det=det)

    def leaf_mask(rows, used):
        return node_feature_mask(
            feat_mask, bynode_u[rows] if bynode_u is not None else None,
            params.bynode_fraction, used, inter)

    def scan(hist, pg, ph, pc, depth, fm, cmn, cmx, pout, pen, rows):
        sp = best_split(
            hist, pg, ph, pc, num_bins_arr, nan_bin_arr, has_nan_arr, fm,
            spp, is_cat_arr, mono_types=mono, cmin=cmn, cmax=cmx,
            parent_output=pout, depth=depth, cegb_pen=pen,
            extra_words=extra.node[rows] if extra is not None else None,
            extra_words_cat=extra.cat[rows] if extra is not None else None,
            feature_contri=o.feature_contri)
        return sp._replace(gain=depth_gate(sp.gain, depth, params.max_depth))

    # CEGB: coupled costs of the features no tree has split on yet, lazy
    # costs of the in-bag rows a feature has not been charged for
    cegb_used = None
    if params.use_cegb:
        cegb_used = (o.cegb_used.clone() if o.cegb_used is not None
                     else torch.zeros(f, dtype=torch.bool, device=dev))
    coupled = o.cegb_coupled if o.cegb_coupled is not None else \
        torch.zeros(f, dtype=torch.float32, device=dev)
    charged = o.cegb_charged

    def cegb_pens(rows):
        """``[R, F]`` costs of the leaves whose rows are ``rows [R, N]``
        (None without lazy costs: ``[1, F]``)."""
        base = (coupled * ~cegb_used)[None]
        if lazy is None:
            return base
        return base + lazy * lazy_uncharged(charged, rows)

    # ---- root ----
    root_g, root_h, root_c = grad.sum(), hess.sum(), cnt.sum()
    root_hist = hist3(torch.ones_like(cnt))
    root_out = leaf_output(root_g, root_h, spp)
    zero = torch.zeros(1, dtype=i64, device=dev)
    big = torch.full((1,), _BIG, device=dev)
    sp0 = scan(root_hist[None], root_g[None], root_h[None], root_c[None],
               zero, leaf_mask(slice(0, 1), torch.zeros(
                   (1, f), dtype=torch.bool, device=dev)),
               -big, big, root_out[None],
               cegb_pens(bag[None]) if params.use_cegb else None,
               slice(0, 1))
    fl0, it0 = _split_rows(sp0)
    leaf_f = torch.zeros((L, _LEAF_F), dtype=torch.float32, device=dev)
    leaf_f[:, _BG] = _NEG_INF
    leaf_f[:, _CMIN] = -_BIG
    leaf_f[:, _CMAX] = _BIG
    leaf_f[0, :_CMIN] = torch.cat([torch.stack([root_g, root_h, root_c]),
                                   fl0[0], root_out[None]])
    leaf_i = torch.zeros((L, 8), dtype=i64, device=dev)
    leaf_i[:, _PARENT] = -1
    leaf_i[0, _BF:] = it0[0]
    leaf_hist = torch.zeros((L, f, B, 3), dtype=torch.float32, device=dev)
    leaf_hist[0] = root_hist
    # the features on each leaf's path (interaction constraints)
    leaf_used = (torch.zeros((L, f), dtype=torch.bool, device=dev)
                 if inter is not None else None)
    node_i = torch.zeros((L - 1, 5), dtype=i64, device=dev)
    node_i[:, _SF] = -1
    node_i[:, _LEFT] = -1
    node_i[:, _RIGHT] = -1
    node_f = torch.zeros((L - 1, 4), dtype=torch.float32, device=dev)
    # categorical: each leaf's cached split bitset, each node's bitset
    leaf_bits = torch.zeros((L, W), dtype=torch.int32, device=dev)
    node_bits = torch.zeros((max(L - 1, 1), W), dtype=torch.int32,
                            device=dev)
    if any_cat:
        leaf_bits[0] = sp0.cat_bitset[0]
    row_leaf = torch.zeros(n, dtype=i64, device=dev)
    done = torch.zeros(1, dtype=torch.bool, device=dev)
    num_nodes = torch.zeros(1, dtype=i64, device=dev)
    f_iota = torch.arange(f, device=dev)

    for k in range(L - 1):
        # ---- FindBestFromAllSplits: leaves 0..k are alive; a forced split
        # takes its scheduled leaf ----
        is_forced = forced is not None and k < forced[0].shape[0]
        best = (forced[0][k:k + 1] if is_forced
                else torch.argmax(leaf_f[:k + 1, _BG]).reshape(1))
        rf = leaf_f.index_select(0, best)[0]
        ri = leaf_i.index_select(0, best)[0]
        gain = rf[_BG:_BG + 1]
        valid = gain > 0.0
        applied = valid & ~done
        done = done | ~valid
        new_leaf = k + 1
        if is_forced:
            applied = torch.ones_like(applied)
            done = torch.zeros_like(done)
            gain = torch.zeros_like(gain)
            f_ = forced[1][k:k + 1]
            b_ = forced[2][k:k + 1]
            dl = torch.zeros_like(f_)
        else:
            f_ = ri[_BF:_BF + 1]
            b_ = ri[_BB:_BB + 1]
            dl = ri[_BDL:_BDL + 1]

        if any_cat:
            bits = leaf_bits.index_select(0, best)[0]
            if is_forced:
                bits = torch.zeros_like(bits)
            f_cat = is_cat_arr.index_select(0, f_)
        else:
            bits, f_cat = None, False

        # ---- partition: the best leaf's right-going rows join new_leaf ----
        go_left = go_left_pred(binned_t.index_select(0, f_)[0], b_, dl != 0,
                               nan_bin_arr.index_select(0, f_), f_cat, bits)
        row_leaf = torch.where(applied & (row_leaf == best) & ~go_left,
                               new_leaf, row_leaf)

        # ---- the smaller child's histogram; the larger is parent - it ----
        pg, ph, pc = rf[_LG], rf[_LH], rf[_LC]
        if is_forced:
            # the forced bin's left sums: a cumulative read of the feature's
            # row of the leaf's histogram
            frow = leaf_hist.index_select(0, best)[0].index_select(0, f_)[0]
            lg, lh, lc = det_cumsum(frow, dim=0).index_select(0, b_)[0]
        else:
            lg, lh, lc = rf[_BLG], rf[_BLH], rf[_BLC]
        rg, rh, rc = pg - lg, ph - lh, pc - lc
        left_smaller = lc <= rc
        small = torch.where(left_smaller, best, new_leaf)
        hist_small = hist3(((row_leaf == small) & applied).to(torch.float32))
        hist_large = leaf_hist.index_select(0, best)[0] - hist_small
        hist_left = torch.where(left_smaller, hist_small, hist_large)
        hist_right = torch.where(left_smaller, hist_large, hist_small)

        # ---- the children's outputs (fixed now, under the parent's bounds
        # and smoothed toward its output) and monotone bounds ----
        l2 = (child_l2(params, ri[_BCL2] * (not is_forced)) if any_cat
              else None)
        cminp, cmaxp, poutp = rf[_CMIN], rf[_CMAX], rf[_LOUT]
        lw = child_output(lg, lh, lc, spp, l2, poutp, cminp, cmaxp)
        rw = child_output(rg, rh, rc, spp, l2, poutp, cminp, cmaxp)
        # [2, 2]: (cmin, cmax) of the left and the right child
        if mono is not None:
            act = applied & ~f_cat if any_cat else applied
            bounds = bound_children(mono.index_select(0, f_), act, lw, rw,
                                    cminp, cmaxp, False)
            bnd = torch.stack([x.reshape(()) for x in bounds]).reshape(2, 2)
        else:
            bnd = rf[_CMIN:_CMAX + 1].expand(2, 2)
        used_child = None
        if inter is not None:
            used_child = leaf_used.index_select(0, best)[0] | (f_iota == f_)
        if params.use_cegb:
            cegb_used = cegb_used | (applied & (f_iota == f_))
        rows2 = None
        if lazy is not None:
            rows2 = torch.stack([row_leaf == best,
                                 row_leaf == new_leaf]) & bag
            # the parent's in-bag rows are charged for the split feature
            charged.index_copy_(0, f_, charged.index_select(0, f_) | (
                applied & (rows2[0] | rows2[1]))[None])

        # ---- best splits of both children ----
        depth = ri[_DEPTH] + 1
        sp2 = scan(torch.stack([hist_left, hist_right]), torch.stack([lg, rg]),
                   torch.stack([lh, rh]), torch.stack([lc, rc]), depth,
                   leaf_mask(slice(2 * k + 1, 2 * k + 3), used_child),
                   bnd[:, 0], bnd[:, 1], torch.stack([lw, rw]),
                   cegb_pens(rows2) if params.use_cegb else None,
                   slice(2 * k + 1, 2 * k + 3))
        spf, spi = _split_rows(sp2)

        # ---- the two leaves' new rows, kept as they were when not applied
        idx = torch.cat([best, torch.full_like(best, new_leaf)])
        new_f = torch.cat([torch.stack([torch.stack([lg, lh, lc]),
                                        torch.stack([rg, rh, rc])]),
                           spf, torch.stack([lw, rw])[:, None], bnd], dim=1)
        nodev = torch.full_like(best, k)
        depth1 = depth.reshape(1)
        new_i = torch.stack([torch.cat([nodev, zero, depth1, spi[0]]),
                             torch.cat([nodev, zero + 1, depth1, spi[1]])])
        leaf_f.index_copy_(0, idx, torch.where(
            applied, new_f, leaf_f.index_select(0, idx)))
        leaf_i.index_copy_(0, idx, torch.where(
            applied, new_i, leaf_i.index_select(0, idx)))
        leaf_hist.index_copy_(0, idx, torch.where(
            applied.reshape(1, 1, 1, 1), torch.stack([hist_left, hist_right]),
            leaf_hist.index_select(0, idx)))
        if used_child is not None:
            leaf_used.index_copy_(0, idx, torch.where(
                applied, used_child, leaf_used.index_select(0, idx)))
        if any_cat:
            leaf_bits.index_copy_(0, idx, torch.where(
                applied, sp2.cat_bitset, leaf_bits.index_select(0, idx)))
            node_bits[k] = torch.where(applied, bits, node_bits[k])

        # ---- record the split; wire the parent's child pointer ----
        p = ri[_PARENT:_PARENT + 1]
        flat = node_i.view(-1)
        slot = torch.clamp(p, min=0) * 5 + _LEFT + ri[_PSIDE:_PSIDE + 1]
        flat.index_copy_(0, slot, torch.where(
            applied & (p >= 0), torch.full_like(p, k),
            flat.index_select(0, slot)))
        node_i[k] = torch.where(applied, torch.cat([
            f_, b_, dl, -(best + 1), torch.full_like(best, -(new_leaf + 1))]),
            node_i[k])
        node_f[k] = torch.where(applied, torch.stack([gain[0], pg, ph, pc]),
                                node_f[k])
        num_nodes = num_nodes + applied.to(i64)

    tree = tree_arrays(node_i, node_f, node_bits, leaf_f, leaf_i, _DEPTH,
                       _PARENT, num_nodes, spp)
    return tree, row_leaf
