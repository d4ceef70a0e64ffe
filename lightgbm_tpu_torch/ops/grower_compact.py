"""Leaf-wise tree growth over physically compacted row segments.

Counterpart of ``grow_tree_compact`` in ``lightgbm_tpu/ops/grower_compact.py``
(serial learner, numerical features; reference: SerialTreeLearner::Train,
serial_tree_learner.cpp:179, and CUDASingleGPUTreeLearner::Train,
cuda_single_gpu_tree_learner.cpp:158-345). Every leaf keeps its rows in a
contiguous segment of the packed record arrays (``ops/compact.py``):

* the root histogram is the fused split kernel in mode 1;
* each split picks the leaf with the best cached split, runs the fused split
  kernel in mode 0 (stable partition + the smaller child's histogram), takes
  the larger child's histogram as parent minus smaller, and scans both
  children for their best splits;
* at the end of the tree the two residency arrays merge back into ``work``
  (with K2's copy-back variant, ``params.fused_dual`` False, every segment
  is in ``work`` already and there is nothing to merge).

Like the JAX grower, the whole tree grows with zero device-to-host reads:
the loop runs ``num_leaves - 1`` times, every scalar stays a device tensor,
and a split that is not applied becomes a no-op through a zero row count
(``m_eff`` / ``n_left_eff``) and ``torch.where`` on every state update.
Per-leaf scalars live in two small ``[L, ...]`` tables (float and int) so a
split reads and writes its two leaves with one gather and one scatter each.

Categorical splits (``is_cat_arr``): each leaf caches its best split's bin
bitset (``leaf_bits``) and sorted-cat flag; a split hands its leaf's bitset
row and the feature's routing flag to K2, which routes by them.

EFB (``efb``, the ``io/efb.py`` ``EfbLayout`` of ``boosting/gbdt.py``
``_setup_efb``): the scan space is the ``F`` stored columns plus
``params.efb_virtual`` virtual features, one per bundled original, appended
to each scanned histogram (``extend_hist_efb``); a bundled winner becomes a bitset on its
bundle column (``apply_efb_bitset``). A split then translates its scan
index into (stored column, routing mode, original feature id) (reference:
``lightgbm_tpu/ops/grower_compact.py:283-306``, ``:558-566``). The scan's
categorical flags (``is_cat_arr``, scan space) and the routing flags
differ: virtual features scan as numerical and route as bitsets, so a run
with no categorical feature still routes by bitsets once anything is
bundled.

Quantized gradients (``quant_scales``, reference: ``grow_tree_compact``'s
``quant_scales``, ``lightgbm_tpu/ops/grower_compact.py:186-205``): the
records' grad and hess columns hold the discretizer's integer codes, K2
runs its ``quant`` mode, and every histogram -- the root, the smaller
child, the cached leaf histograms and parent minus smaller -- is exact
int32. The scan dequantizes with the round's scales (0-d device tensors);
the root sums are an int sum, then a cast to f32, then the multiply.

By-node feature sampling (``params.bynode_fraction`` < 1, ``bynode_u``):
as in the masked grower (``ops/grower.py`` ``node_feature_mask``), over the
scan space's features.

Constraints and the scan's other options (``opts``, an ``ops/grower.py``
``TreeOptions``; reference: ``lightgbm_tpu/ops/grower_compact.py:67-110``,
``:623-680``, ``:789-802``): as in the masked grower, without the lazy
CEGB costs (those take the masked grower). With
``params.mono_intermediate`` (the intermediate monotone method) a split
bounds each child by its sibling's output, then walks the tree
(``ops/monotone.py``: one launch of the walk kernel, no read back to the
host) to tighten the bounds of the leaves next to the new split, and
rescans the leaves whose bounds moved: one batched scan of every live
leaf's cached histogram, its cached split kept where no bound moved
(``torch.where``). A rescan reuses the leaf's scan-time feature mask
(``leaf_fmask``) and draws its extra-trees words from
``opts.extra.rescan[k]``. These options never meet EFB: the trainer
unbundles first.

Without the fused kernel (``params.fused`` False, ``tpu_fused=off``;
reference: ``lightgbm_tpu/ops/grower_compact.py:438-446``, ``:729-733``,
``:760-768``): the root's histogram is ``unfused_histogram`` over the whole
array, and each split runs K2's partition alone (copy-back residency, as
the JAX package's ``partition_segment``), then ``unfused_histogram`` over
the smaller child's segment, whose bounds stay on the device: K1 dense or
K3 (``params.hist_layout``), in f32, int32 codes, or with
``params.quant_narrow`` the narrowed 16-bit engine where the leaf fits it
(``seg_hist``, ``:309-345``). Still no read back to the host.

Not here yet: data-parallel reductions (A18).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..io.efb import EfbLayout
from .compact import RowLayout, segments_to_leaf_vectors
from .fused_split import fused_split
from .pallas_histogram import unfused_histogram
from .grower import (_BG, _BIG, _BLC, _BLG, _BLH, _CMAX, _CMIN, _LC,
                     _LEAF_F, _LEFT, _LG, _LH, _LOUT, _RIGHT, _SF,
                     GrowerParams, TreeOptions, _split_rows, bound_children,
                     child_l2, node_feature_mask, tree_arrays)
from .monotone import _NODE_I, _NPAR, monotone_walk
from .split import (_NEG_INF, apply_efb_bitset, best_split, child_output,
                    depth_gate, extend_hist_efb, leaf_output)

# columns of the compact grower's per-leaf int table: segment, tree links,
# cached best split, under a monotone split (the intermediate method)
(_START, _NROWS, _SIDE, _PARENT, _PSIDE, _DEPTH, _BF, _BB, _BDL,
 _BLR, _BCL2, _INMONO) = range(12)


class CompactState(NamedTuple):
    """The grower's device state between splits."""
    leaf_f: torch.Tensor      # [L, 10] f32 sums, cached split, output, bounds
    leaf_i: torch.Tensor      # [L, 12] int64 segment, tree links, best split
    leaf_hist: torch.Tensor   # [L, F, B, 4] per-leaf histograms (f32/int32)
    node_i: torch.Tensor      # [L-1, 7] int64 split, children, parent, cat
    node_f: torch.Tensor      # [L-1, 4] f32 gain and node sums
    leaf_bits: torch.Tensor   # [L, W] int32 cached categorical bitsets
    node_bits: torch.Tensor   # [L-1, W] int32 node categorical bitsets
    done: torch.Tensor        # [1] bool
    num_nodes: torch.Tensor   # [1] int64
    leaf_used: Optional[torch.Tensor]   # [L, F] bool path features
    leaf_fmask: Optional[torch.Tensor]  # [L, F] bool scan-time masks
    cegb_used: Optional[torch.Tensor]   # [F] bool


def grow_tree_compact(work: torch.Tensor, scratch: torch.Tensor,
                      num_bins_arr: torch.Tensor, nan_bin_arr: torch.Tensor,
                      has_nan_arr: torch.Tensor, feat_mask: torch.Tensor,
                      layout: RowLayout, params: GrowerParams, n_real: int,
                      is_cat_arr: Optional[torch.Tensor] = None,
                      efb: Optional[EfbLayout] = None, quant_scales=None,
                      bynode_u: Optional[torch.Tensor] = None,
                      opts: Optional[TreeOptions] = None,
                      stats: Optional[dict] = None):
    """Grow one tree. Returns ``(TreeArrays, row_leaf [N], work, scratch,
    leaf_start [L], leaf_nrows [L])``, the per-row outputs in the post-tree
    row order; ``work`` and ``scratch`` are updated in place. The
    per-feature arrays are in scan space (``F + params.efb_virtual``
    entries); ``is_cat_arr`` bool marks the categorical ones (None: the
    scan is numerical). ``efb``: the ``EfbLayout``, or None when nothing is
    bundled. ``quant_scales``: ``(g_scale, h_scale)`` 0-d f32 tensors when
    the records carry quantized codes (int32 histograms), else None.
    ``bynode_u`` ``[2L-1, F + params.efb_virtual]``: the tree's by-node
    draws when ``params.bynode_fraction`` < 1. ``opts``: the constraint and
    option inputs (``TreeOptions``, no lazy CEGB costs). ``stats``: a
    caller's dict that takes, with the intermediate method,
    ``"rescan_flagged"``: the tree's flagged (rescanned) leaves summed over
    its splits, a 0-d int64 device tensor; with the narrowed quantized
    histogram ``"narrowed_leaves"``: the histograms that took the 16-bit
    engine, a one-element int32 device tensor."""
    dev = work.device
    n = n_real
    L = params.num_leaves
    B = params.num_bins
    F = layout.num_features
    fs = int(num_bins_arr.shape[0])          # scan-space features
    W = params.bitset_words
    spp = params.split_params()
    i64 = torch.int64
    quant = quant_scales is not None
    o = opts if opts is not None else TreeOptions()
    inter = o.inter_sets if params.use_interaction else None
    extra = o.extra if params.extra_trees else None

    # routing: (stored column, bitset flag, original feature) of a scan index
    if efb is not None:
        route = (efb.col_of, efb.route_cat, efb.orig_of)
    elif is_cat_arr is not None:
        route = (None, is_cat_arr, None)
    else:
        route = None

    def leaf_mask(rows, used):
        """The features of the leaves whose by-node draws are ``rows`` and
        whose paths used ``used``."""
        return node_feature_mask(
            feat_mask, bynode_u[rows] if bynode_u is not None else None,
            params.bynode_fraction, used, inter)

    def scan(hist, pg, ph, pc, depth, fm, cmn, cmx, pout, pen, words):
        """The best splits of the leaves of ``hist``; ``words``: their
        extra-trees words (threshold, sorted prefix) or None."""
        if efb is not None:
            hist = extend_hist_efb(hist, efb, params.efb_virtual,
                                   params.efb_bmax)
        sp = best_split(
            hist, pg, ph, pc, num_bins_arr, nan_bin_arr, has_nan_arr, fm,
            spp, is_cat_arr, quant_scales,
            mono_types=o.mono_types if params.use_monotone else None,
            cmin=cmn, cmax=cmx, parent_output=pout, depth=depth,
            cegb_pen=pen, extra_words=words[0] if words else None,
            extra_words_cat=words[1] if words else None,
            feature_contri=o.feature_contri)
        if efb is not None:
            sp = apply_efb_bitset(sp, efb, F, B)
        return sp._replace(gain=depth_gate(sp.gain, depth, params.max_depth))

    cegb_used = None
    if params.use_cegb:
        cegb_used = (o.cegb_used.clone() if o.cegb_used is not None
                     else torch.zeros(fs, dtype=torch.bool, device=dev))
    coupled = o.cegb_coupled if o.cegb_coupled is not None else \
        torch.zeros(fs, dtype=torch.float32, device=dev)

    # ---- root: the fused kernel's histogram-only mode, or (unfused) the
    # whole array's histogram ----
    zero = torch.zeros(1, dtype=i64, device=dev)
    # the leaves whose histogram took the narrowed 16-bit engine
    narrowed = (torch.zeros(1, dtype=torch.int32, device=dev)
                if not params.fused and quant and params.quant_narrow
                else None)
    if params.fused:
        work, scratch, root_hist = fused_split(
            work, scratch, 1, zero, n, zero, zero, zero, zero, zero, zero,
            None, layout, B, side=zero, dual=params.fused_dual, quant=quant)
    else:
        # fill_ of a slice: a setitem would copy through the host
        seg0 = torch.zeros(3, dtype=torch.int32, device=dev)
        seg0[1:2].fill_(n)
        root_hist = seg_hist(work, scratch, seg0, layout, B, quant, params,
                             narrowed)
    # every feature's bins sum to the totals, so feature 0 gives the root;
    # quantized: the int sums cast to f32, then times the scales
    root_g, root_h, root_c = (root_hist[0, :, j].sum().to(torch.float32)
                              for j in range(3))
    if quant:
        root_g = root_g * quant_scales[0]
        root_h = root_h * quant_scales[1]
    root_out = leaf_output(root_g, root_h, spp)
    big = torch.full((1,), _BIG, device=dev)
    root_fm = leaf_mask(slice(0, 1), torch.zeros((1, fs), dtype=torch.bool,
                                                 device=dev))
    sp0 = scan(root_hist[None], root_g[None], root_h[None], root_c[None],
               zero, root_fm, -big, big, root_out[None],
               (coupled * ~cegb_used)[None] if params.use_cegb else None,
               None if extra is None else (extra.node[:1], extra.cat[:1]))
    fl0, it0 = _split_rows(sp0)

    leaf_f = torch.zeros((L, _LEAF_F), dtype=torch.float32, device=dev)
    leaf_f[:, _BG] = _NEG_INF
    leaf_f[:, _CMIN] = -_BIG
    leaf_f[:, _CMAX] = _BIG
    leaf_f[0, :_CMIN] = torch.cat([torch.stack([root_g, root_h, root_c]),
                                   fl0[0], root_out[None]])
    leaf_i = torch.zeros((L, 12), dtype=i64, device=dev)
    leaf_i[:, _PARENT] = -1
    # fill_ of a slice, not a scalar setitem: the latter copies through the
    # host and synchronizes
    leaf_i[0:1, _NROWS].fill_(n)
    leaf_i[0, _BF:_INMONO] = it0[0]
    leaf_hist = torch.zeros((L, F, B, 4), dtype=root_hist.dtype, device=dev)
    leaf_hist[0] = root_hist
    node_i = torch.zeros((max(L - 1, 1), _NODE_I), dtype=i64, device=dev)
    node_i[:, _SF] = -1
    node_i[:, _LEFT] = -1
    node_i[:, _RIGHT] = -1
    node_i[:, _NPAR] = -1
    node_f = torch.zeros((max(L - 1, 1), 4), dtype=torch.float32, device=dev)
    leaf_bits = torch.zeros((L, W), dtype=torch.int32, device=dev)
    if route is not None:
        leaf_bits[0] = sp0.cat_bitset[0]
    leaf_used = (torch.zeros((L, fs), dtype=torch.bool, device=dev)
                 if inter is not None else None)
    leaf_fmask = None
    if params.mono_intermediate:
        leaf_fmask = torch.zeros((L, fs), dtype=torch.bool, device=dev)
        leaf_fmask[0] = root_fm.reshape(-1, fs)[0]
    st = CompactState(leaf_f, leaf_i, leaf_hist, node_i, node_f, leaf_bits,
                      torch.zeros((max(L - 1, 1), W), dtype=torch.int32,
                                  device=dev),
                      torch.zeros(1, dtype=torch.bool, device=dev),
                      torch.zeros(1, dtype=i64, device=dev),
                      leaf_used, leaf_fmask, cegb_used)

    flagged = (torch.zeros((), dtype=i64, device=dev)
               if params.mono_intermediate else None)
    for k in range(L - 1):
        st = _split_step(st, k, work, scratch, layout, B, nan_bin_arr,
                         is_cat_arr, route, scan, leaf_mask, params, quant,
                         o, coupled, extra, flagged, narrowed)
    if flagged is not None and stats is not None:
        stats["rescan_flagged"] = flagged
    if narrowed is not None and stats is not None:
        stats["narrowed_leaves"] = narrowed

    leaf_i = st.leaf_i
    leaf_start = leaf_i[:, _START]
    leaf_nrows = leaf_i[:, _NROWS]
    if params.fused_dual:
        # dual residency: consolidate the scratch-resident segments into work
        _, row_side = segments_to_leaf_vectors(leaf_start, leaf_nrows,
                                               leaf_i[:, _SIDE], n)
        torch.where((row_side != 0)[:, None], scratch[:n], work[:n],
                    out=work[:n])
    tree = tree_arrays(st.node_i, st.node_f, st.node_bits, st.leaf_f,
                       leaf_i, _DEPTH, _PARENT, st.num_nodes, spp)
    row_leaf, _ = segments_to_leaf_vectors(leaf_start, leaf_nrows,
                                           tree.leaf_value, n)
    return tree, row_leaf, work, scratch, leaf_start, leaf_nrows


def _split_step(st: CompactState, k: int, work, scratch, layout, B,
                nan_bin_arr, is_cat_arr, route, scan, leaf_mask, params,
                quant: bool, o: TreeOptions, coupled, extra,
                flagged, narrowed) -> CompactState:
    """Split number ``k``: node ``k`` splits the best leaf into itself (left
    child) and leaf ``k + 1`` (right child). ``route``: (stored column,
    bitset flag, original feature) arrays over scan indices (the first or
    last None: the scan index itself), or None when every split is
    numerical. ``quant``: the histograms are int32 (quantized codes)."""
    i64 = torch.int64
    spp = params.split_params()
    (leaf_f, leaf_i, leaf_hist, node_i, node_f, leaf_bits, node_bits, done,
     num_nodes, leaf_used, leaf_fmask, cegb_used) = st
    node = k
    new_leaf = k + 1
    any_cat = is_cat_arr is not None
    mono = o.mono_types if params.use_monotone else None

    # ---- FindBestFromAllSplits: leaves 0..k are alive ----
    best = torch.argmax(leaf_f[:k + 1, _BG]).reshape(1)
    rf = leaf_f.index_select(0, best)[0]
    ri = leaf_i.index_select(0, best)[0]
    gain = rf[_BG:_BG + 1]
    valid = gain > 0.0
    applied = valid & ~done
    done = done | ~valid

    f_ = ri[_BF:_BF + 1]
    b_ = ri[_BB:_BB + 1]
    dl = ri[_BDL:_BDL + 1]
    n_left = ri[_BLR:_BLR + 1]
    s_ = ri[_START:_START + 1]
    m = ri[_NROWS:_NROWS + 1]
    side_p = ri[_SIDE:_SIDE + 1]
    pg, ph, pc = rf[_LG], rf[_LH], rf[_LC]
    lg, lh, lc = rf[_BLG], rf[_BLH], rf[_BLC]
    rg, rh, rc = pg - lg, ph - lh, pc - lc

    # ---- physical partition + the smaller child's histogram ----
    # a split that is not applied streams an empty segment
    zero = torch.zeros_like(m)
    m_eff = torch.where(applied, m, zero)
    n_left_eff = torch.where(applied, n_left, zero)
    left_smaller = n_left <= m - n_left
    f_col, f_orig = f_, f_
    if route is not None:
        # the leaf's bitset row as a contiguous int32 vector on the device
        # (no read back to the host)
        bits = leaf_bits.index_select(0, best)[0]
        col_of, route_cat, orig_of = route
        f_cat = route_cat.index_select(0, f_)
        if col_of is not None:
            f_col = col_of.index_select(0, f_)
            f_orig = orig_of.index_select(0, f_)
    else:
        bits, f_cat = None, zero
    # unfused: the partition alone, then the smaller child's segment
    work, scratch, hist_small = fused_split(
        work, scratch, 0, s_, m_eff, n_left_eff, f_col, b_, dl,
        nan_bin_arr.index_select(0, f_), f_cat, bits, layout, B,
        smaller_left=left_smaller, side=side_p, dual=params.fused_dual,
        quant=quant, hist=params.fused)
    if not params.fused:
        hist_small = seg_hist(work, scratch, hist_small, layout, B, quant,
                              params, narrowed)
    # exact in int32 when quantized
    parent_hist = leaf_hist.index_select(0, best)[0]
    hist_large = parent_hist - hist_small
    ls = left_smaller.reshape(1, 1, 1)
    hist_left = torch.where(ls, hist_small, hist_large)
    hist_right = torch.where(ls, hist_large, hist_small)

    # ---- the children's outputs (fixed now, under the parent's bounds and
    # smoothed toward its output) and monotone bounds ----
    l2 = child_l2(params, ri[_BCL2]) if any_cat else None
    cminp, cmaxp, poutp = rf[_CMIN], rf[_CMAX], rf[_LOUT]
    lw = child_output(lg, lh, lc, spp, l2, poutp, cminp, cmaxp)
    rw = child_output(rg, rh, rc, spp, l2, poutp, cminp, cmaxp)
    split_cat = is_cat_arr.index_select(0, f_) if any_cat else None
    # [2, 2]: (cmin, cmax) of the left and the right child
    if mono is not None:
        mt = mono.index_select(0, f_)
        bounds = bound_children(
            mt, applied & ~split_cat if any_cat else applied, lw, rw, cminp,
            cmaxp, params.mono_intermediate)
        bnd = torch.stack([x.reshape(()) for x in bounds]).reshape(2, 2)
    else:
        bnd = rf[_CMIN:_CMAX + 1].expand(2, 2)
    used_child = None
    if leaf_used is not None:
        f_iota = torch.arange(coupled.shape[0], device=f_.device)
        used_child = leaf_used.index_select(0, best)[0] | (f_iota == f_)
    if cegb_used is not None:
        f_iota = torch.arange(coupled.shape[0], device=f_.device)
        cegb_used = cegb_used | (applied & (f_iota == f_))

    # ---- best splits of both children ----
    depth = ri[_DEPTH] + 1
    rows = slice(2 * k + 1, 2 * k + 3)
    fm2 = leaf_mask(rows, used_child)
    sp = scan(torch.stack([hist_left, hist_right]), torch.stack([lg, rg]),
              torch.stack([lh, rh]), torch.stack([lc, rc]), depth, fm2,
              bnd[:, 0], bnd[:, 1], torch.stack([lw, rw]),
              (coupled * ~cegb_used)[None] if cegb_used is not None
              else None,
              None if extra is None else (extra.node[rows], extra.cat[rows]))
    spf, spi = _split_rows(sp)

    # ---- the two leaves' new rows, kept as they were when not applied ----
    idx = torch.cat([best, torch.full_like(best, new_leaf)])
    old_f = leaf_f.index_select(0, idx)
    old_i = leaf_i.index_select(0, idx)
    new_f = torch.cat([torch.stack([torch.stack([lg, lh, lc]),
                                    torch.stack([rg, rh, rc])]),
                       spf, torch.stack([lw, rw])[:, None], bnd], dim=1)
    depth1 = depth.reshape(1)
    nodev = torch.full_like(best, node)
    # the right child lies in the other array (copy-back: in work)
    side_r = 1 - side_p if params.fused_dual else side_p
    # under a monotone split: the new split's feature is constrained, or the
    # parent was under one already (the intermediate method's walk)
    in_mono = ri[_INMONO:_INMONO + 1]
    if mono is not None:
        in_mono = ((mt != 0) | (in_mono != 0)).to(i64)
    new_i = torch.stack([
        torch.cat([s_, n_left, side_p, nodev, zero, depth1, spi[0], in_mono]),
        torch.cat([s_ + n_left, m - n_left, side_r, nodev, zero + 1,
                   depth1, spi[1], in_mono])])
    leaf_f.index_copy_(0, idx, torch.where(applied, new_f, old_f))
    leaf_i.index_copy_(0, idx, torch.where(applied, new_i, old_i))
    old_h = leaf_hist.index_select(0, idx)
    new_h = torch.stack([hist_left, hist_right])
    leaf_hist.index_copy_(0, idx, torch.where(applied.reshape(1, 1, 1, 1),
                                              new_h, old_h))
    if route is not None:
        leaf_bits.index_copy_(0, idx, torch.where(
            applied, sp.cat_bitset, leaf_bits.index_select(0, idx)))
        node_bits[node] = torch.where(applied, bits, node_bits[node])
    if leaf_used is not None:
        leaf_used.index_copy_(0, idx, torch.where(
            applied, used_child, leaf_used.index_select(0, idx)))
    if leaf_fmask is not None:
        leaf_fmask.index_copy_(0, idx, torch.where(
            applied, fm2.expand(2, -1), leaf_fmask.index_select(0, idx)))

    # ---- record the split; wire the parent's child pointer ----
    p = ri[_PARENT:_PARENT + 1]
    pside = ri[_PSIDE:_PSIDE + 1]
    flat = node_i.view(-1)
    slot = torch.clamp(p, min=0) * _NODE_I + _LEFT + pside
    wire = applied & (p >= 0)
    flat.index_copy_(0, slot, torch.where(wire, torch.full_like(p, node),
                                          flat.index_select(0, slot)))
    node_i[node] = torch.where(applied, torch.cat([
        f_orig, b_, dl, -(best + 1), torch.full_like(best, -(new_leaf + 1)),
        p, split_cat.to(i64) if any_cat else zero]), node_i[node])
    node_f[node] = torch.where(applied, torch.stack([gain[0], pg, ph, pc]),
                               torch.zeros_like(node_f[node]))
    num_nodes = num_nodes + applied.to(i64)

    if params.mono_intermediate:
        _intermediate(k, node_i, leaf_f, leaf_i, leaf_hist, leaf_bits,
                      leaf_fmask, mono, applied & (in_mono[0] != 0), p, f_,
                      b_, lw, rw, scan, cegb_used, coupled, extra, route,
                      flagged)
    return CompactState(leaf_f, leaf_i, leaf_hist, node_i, node_f, leaf_bits,
                        node_bits, done, num_nodes, leaf_used, leaf_fmask,
                        cegb_used)


def _intermediate(k, node_i, leaf_f, leaf_i, leaf_hist, leaf_bits,
                  leaf_fmask, mono, eff, p, f_, b_, lw, rw, scan, cegb_used,
                  coupled, extra, route, flagged) -> None:
    """The intermediate method after split ``k`` (reference:
    ``lightgbm_tpu/ops/grower_compact.py:830-1041``): the walk tightens the
    bounds of the leaves next to the new split (``eff``: the split is
    applied and under a monotone split), then the live leaves are rescanned
    in one batch (a profiler range, ``monotone_rescan``) and each flagged
    leaf takes its new best split; ``flagged`` counts the flagged leaves."""
    flags = monotone_walk(node_i, leaf_f, mono, eff, p, f_, b_, lw, rw, k)
    flagged += flags.sum()
    with torch.profiler.record_function("monotone_rescan"):
        live = k + 2
        fl = flags[:live, None]
        lf, li = leaf_f[:live], leaf_i[:live]
        sp = scan(leaf_hist[:live], lf[:, _LG], lf[:, _LH], lf[:, _LC],
                  li[:, _DEPTH], leaf_fmask[:live], lf[:, _CMIN],
                  lf[:, _CMAX], lf[:, _LOUT],
                  (coupled * ~cegb_used)[None] if cegb_used is not None
                  else None,
                  None if extra is None else (extra.rescan[k, :live],
                                              extra.rescan_cat[k, :live]))
        spf, spi = _split_rows(sp)
        leaf_f[:live, _BG:_BLC + 1] = torch.where(fl, spf,
                                                  lf[:, _BG:_BLC + 1])
        leaf_i[:live, _BF:_BCL2 + 1] = torch.where(fl, spi,
                                                   li[:, _BF:_BCL2 + 1])
        if route is not None:
            leaf_bits[:live] = torch.where(fl, sp.cat_bitset,
                                           leaf_bits[:live])


def seg_hist(work: torch.Tensor, scratch: torch.Tensor, seg: torch.Tensor,
             layout: RowLayout, B: int, quant: bool, params: GrowerParams,
             narrowed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The histogram of the segment ``seg`` (device int32 start, count,
    which array) without the fused kernel (reference: ``seg_hist``,
    ``lightgbm_tpu/ops/grower_compact.py:309-345``): in the narrowed mode
    each leaf takes the 16-bit engine where its count fits it, else the
    32-bit one, the same int32 sums either way; ``narrowed`` counts the
    16-bit ones."""
    narrow = params.quant_max if quant and params.quant_narrow else 0
    return unfused_histogram(work, scratch, seg, layout, B, quant, narrow,
                             params.hist_layout, narrowed)
