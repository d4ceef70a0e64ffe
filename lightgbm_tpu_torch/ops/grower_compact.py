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
* at the end of the tree the two residency arrays merge back into ``work``.

Like the JAX grower, the whole tree grows with zero device-to-host reads:
the loop runs ``num_leaves - 1`` times, every scalar stays a device tensor,
and a split that is not applied becomes a no-op through a zero row count
(``m_eff`` / ``n_left_eff``) and ``torch.where`` on every state update.
Per-leaf scalars live in two small ``[L, ...]`` tables (float and int) so a
split reads and writes its two leaves with one gather and one scatter each.

Not here yet (ROADMAP A12-A18): categorical splits, monotone constraints
and their intermediate rescans, CEGB, by-node sampling, EFB, quantized
histograms, data-parallel reductions.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .compact import RowLayout, segments_to_leaf_vectors
from .fused_split import fused_split
from .grower import GrowerParams, TreeArrays
from .split import _NEG_INF, best_split, depth_gate, leaf_output

# columns of the per-leaf float table
(_LG, _LH, _LC, _BG, _BLG, _BLH, _BLC, _LOUT) = range(8)
# columns of the per-leaf int table
(_START, _NROWS, _SIDE, _PARENT, _PSIDE, _DEPTH, _BF, _BB, _BDL,
 _BLR) = range(10)
# columns of the per-node tables
(_SF, _SB, _SDL, _LEFT, _RIGHT) = range(5)
(_GAIN, _NG, _NH, _NC) = range(4)


class CompactState(NamedTuple):
    """The grower's device state between splits."""
    leaf_f: torch.Tensor      # [L, 8] f32 per-leaf sums, cached best split
    leaf_i: torch.Tensor      # [L, 10] int64 segment, tree links, best split
    leaf_hist: torch.Tensor   # [L, F, B, 4] f32 per-leaf histograms
    node_i: torch.Tensor      # [L-1, 5] int64 split feature/bin/dl, children
    node_f: torch.Tensor      # [L-1, 4] f32 gain and node sums
    done: torch.Tensor        # [1] bool
    num_nodes: torch.Tensor   # [1] int64


def _split_rows(sp):
    """[2, 4] f32 and [2, 4] int64 cached-best-split columns for a batch of
    two scanned leaves."""
    fl = torch.stack([sp.gain, sp.left_grad, sp.left_hess, sp.left_count],
                     dim=1)
    it = torch.stack([sp.feature, sp.bin, sp.default_left.to(torch.int64),
                      sp.left_rows.to(torch.int64)], dim=1)
    return fl, it


def grow_tree_compact(work: torch.Tensor, scratch: torch.Tensor,
                      num_bins_arr: torch.Tensor, nan_bin_arr: torch.Tensor,
                      has_nan_arr: torch.Tensor, feat_mask: torch.Tensor,
                      layout: RowLayout, params: GrowerParams, n_real: int):
    """Grow one tree. Returns ``(TreeArrays, row_leaf [N], work, scratch,
    leaf_start [L], leaf_nrows [L])``, the per-row outputs in the post-tree
    row order; ``work`` and ``scratch`` are updated in place."""
    dev = work.device
    n = n_real
    L = params.num_leaves
    B = params.num_bins
    F = layout.num_features
    W = params.bitset_words
    spp = params.split_params()
    i64 = torch.int64

    def scan(hist, pg, ph, pc, depth):
        sp = best_split(hist, pg, ph, pc, num_bins_arr, nan_bin_arr,
                        has_nan_arr, feat_mask, spp)
        return sp._replace(gain=depth_gate(sp.gain, depth, params.max_depth))

    # ---- root: the fused kernel's histogram-only mode ----
    zero = torch.zeros(1, dtype=i64, device=dev)
    work, scratch, root_hist = fused_split(
        work, scratch, 1, zero, n, zero, zero, zero, zero, zero, zero, None,
        layout, B, side=zero)
    # every feature's bins sum to the totals, so feature 0 gives the root
    root_g = root_hist[0, :, 0].sum()
    root_h = root_hist[0, :, 1].sum()
    root_c = root_hist[0, :, 2].sum()
    root_out = leaf_output(root_g, root_h, spp)
    sp0 = scan(root_hist[None], root_g[None], root_h[None], root_c[None],
               zero)
    fl0, it0 = _split_rows(sp0)

    leaf_f = torch.zeros((L, 8), dtype=torch.float32, device=dev)
    leaf_f[:, _BG] = _NEG_INF
    leaf_f[0] = torch.cat([torch.stack([root_g, root_h, root_c]), fl0[0],
                           root_out[None]])
    leaf_i = torch.zeros((L, 10), dtype=i64, device=dev)
    leaf_i[:, _PARENT] = -1
    # fill_ of a slice, not a scalar setitem: the latter copies through the
    # host and synchronizes
    leaf_i[0:1, _NROWS].fill_(n)
    leaf_i[0, _BF:] = it0[0]
    leaf_hist = torch.zeros((L, F, B, 4), dtype=torch.float32, device=dev)
    leaf_hist[0] = root_hist
    node_i = torch.zeros((max(L - 1, 1), 5), dtype=i64, device=dev)
    node_i[:, _SF] = -1
    node_i[:, _LEFT] = -1
    node_i[:, _RIGHT] = -1
    node_f = torch.zeros((max(L - 1, 1), 4), dtype=torch.float32, device=dev)
    st = CompactState(leaf_f, leaf_i, leaf_hist, node_i, node_f,
                      torch.zeros(1, dtype=torch.bool, device=dev),
                      torch.zeros(1, dtype=i64, device=dev))

    for k in range(L - 1):
        st = _split_step(st, k, work, scratch, layout, B, W, nan_bin_arr,
                         scan, spp)

    leaf_f, leaf_i, node_i, node_f = st.leaf_f, st.leaf_i, st.node_i, \
        st.node_f
    leaf_start = leaf_i[:, _START]
    leaf_nrows = leaf_i[:, _NROWS]
    # dual residency: consolidate the scratch-resident segments into work
    _, row_side = segments_to_leaf_vectors(leaf_start, leaf_nrows,
                                           leaf_i[:, _SIDE], n)
    torch.where((row_side != 0)[:, None], scratch[:n], work[:n],
                out=work[:n])
    nn = st.num_nodes[0]
    leaf_value = leaf_f[:, _LOUT].clone()
    tree = TreeArrays(
        split_feature=node_i[:L - 1, _SF],
        split_bin=node_i[:L - 1, _SB],
        cat_bitset=torch.zeros((L - 1, W), dtype=torch.int32, device=dev),
        split_gain=node_f[:L - 1, _GAIN],
        default_left=node_i[:L - 1, _SDL] != 0,
        left_child=node_i[:L - 1, _LEFT],
        right_child=node_i[:L - 1, _RIGHT],
        leaf_value=leaf_value,
        leaf_weight=leaf_f[:, _LH],
        leaf_count=leaf_f[:, _LC],
        leaf_parent=leaf_i[:, _PARENT],
        leaf_depth=leaf_i[:, _DEPTH],
        internal_value=leaf_output(node_f[:L - 1, _NG], node_f[:L - 1, _NH],
                                   spp),
        internal_weight=node_f[:L - 1, _NH],
        internal_count=node_f[:L - 1, _NC],
        num_leaves=nn + 1,
        num_nodes=nn,
    )
    row_leaf, _ = segments_to_leaf_vectors(leaf_start, leaf_nrows,
                                           leaf_value, n)
    return tree, row_leaf, work, scratch, leaf_start, leaf_nrows


def _split_step(st: CompactState, k: int, work, scratch, layout, B, W,
                nan_bin_arr, scan, spp) -> CompactState:
    """Split number ``k``: node ``k`` splits the best leaf into itself (left
    child) and leaf ``k + 1`` (right child)."""
    dev = work.device
    i64 = torch.int64
    leaf_f, leaf_i, leaf_hist, node_i, node_f, done, num_nodes = st
    node = k
    new_leaf = k + 1

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
    work, scratch, hist_small = fused_split(
        work, scratch, 0, s_, m_eff, n_left_eff, f_, b_, dl,
        nan_bin_arr.index_select(0, f_), zero, None, layout, B,
        smaller_left=left_smaller, side=side_p)
    parent_hist = leaf_hist.index_select(0, best)[0]
    hist_large = parent_hist - hist_small
    ls = left_smaller.reshape(1, 1, 1)
    hist_left = torch.where(ls, hist_small, hist_large)
    hist_right = torch.where(ls, hist_large, hist_small)

    # ---- best splits of both children ----
    depth = ri[_DEPTH] + 1
    sp = scan(torch.stack([hist_left, hist_right]), torch.stack([lg, rg]),
              torch.stack([lh, rh]), torch.stack([lc, rc]), depth)
    spf, spi = _split_rows(sp)
    lw = leaf_output(lg, lh, spp)
    rw = leaf_output(rg, rh, spp)

    # ---- the two leaves' new rows, kept as they were when not applied ----
    idx = torch.cat([best, torch.full_like(best, new_leaf)])
    old_f = leaf_f.index_select(0, idx)
    old_i = leaf_i.index_select(0, idx)
    new_f = torch.cat([torch.stack([torch.stack([lg, lh, lc]),
                                    torch.stack([rg, rh, rc])]),
                       spf, torch.stack([lw, rw])[:, None]], dim=1)
    depth1 = depth.reshape(1)
    nodev = torch.full_like(best, node)
    new_i = torch.stack([
        torch.cat([s_, n_left, side_p, nodev, zero, depth1, spi[0]]),
        torch.cat([s_ + n_left, m - n_left, 1 - side_p, nodev, zero + 1,
                   depth1, spi[1]])])
    leaf_f.index_copy_(0, idx, torch.where(applied, new_f, old_f))
    leaf_i.index_copy_(0, idx, torch.where(applied, new_i, old_i))
    old_h = leaf_hist.index_select(0, idx)
    new_h = torch.stack([hist_left, hist_right])
    leaf_hist.index_copy_(0, idx, torch.where(applied.reshape(1, 1, 1, 1),
                                              new_h, old_h))

    # ---- record the split; wire the parent's child pointer ----
    p = ri[_PARENT:_PARENT + 1]
    pside = ri[_PSIDE:_PSIDE + 1]
    flat = node_i.view(-1)
    slot = torch.clamp(p, min=0) * 5 + _LEFT + pside
    wire = applied & (p >= 0)
    flat.index_copy_(0, slot, torch.where(wire, torch.full_like(p, node),
                                          flat.index_select(0, slot)))
    node_i[node] = torch.where(applied, torch.cat([
        f_, b_, dl, -(best + 1), torch.full_like(best, -(new_leaf + 1))]),
        node_i[node])
    node_f[node] = torch.where(applied, torch.stack([gain[0], pg, ph, pc]),
                               torch.zeros_like(node_f[node]))
    num_nodes = num_nodes + applied.to(i64)
    return CompactState(leaf_f, leaf_i, leaf_hist, node_i, node_f, done,
                        num_nodes)
