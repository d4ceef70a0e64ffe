"""The intermediate monotone method's tree walk: the kernel's wrapper and
its plain version.

Counterpart of the walk in ``lightgbm_tpu/ops/grower_compact.py:830-991``
(reference: IntermediateLeafConstraints::Update, GoUpToFindLeavesToUpdate
and GoDownToFindLeavesToUpdate, src/treelearner/monotone_constraints.hpp:
560-858). After a split under a monotone split, the walk climbs from the
new node to the root and collects, at each monotone ancestor whose other
branch can still hold leaves next to the new split (the contiguity test
over the features and thresholds climbed so far), that branch. It then
descends each collected branch, pruned by the same test and by the new
split's own feature and threshold, and clamps each reached leaf's upper
(or lower) output bound against the new children's actual outputs: the
smaller one where both children border the leaf, else the one that does.
Leaves whose bound moved are flagged; the grower rescans them.

The JAX package runs the walk as ``lax.while_loop``s. Here it is one
single-thread CUDA kernel (``csrc/monotone_walk.cu``), launched once a split
with every input on the device, so the tree step reads nothing back to the
host; its stacks (at most 2L entries) and the climb's records live in
shared memory. The plain version below is a literal Python port of the
reference's loops on CPU tensors, which the CPU path runs.

Node table columns: the growers' ``_SF``, ``_SB``, ``_SDL``, ``_LEFT``,
``_RIGHT`` and, for the walk, ``_NPAR`` (the parent node, -1 at the root)
and ``_NCAT`` (1 for a categorical split).
"""
from __future__ import annotations

import torch

from .. import _kernels
from .grower import _BG, _CMAX, _CMIN, _LEFT, _RIGHT, _SB, _SF
from .split import _NEG_INF

(_NPAR, _NCAT) = (5, 6)
_NODE_I = 7
# shared memory a leaf: the stack (2L x (int + 2 flags)) and the climb's
# records (4 ints and 2 flags a level)
_SMEM_PER_LEAF = 30
_MAX_SMEM = 232448


def monotone_walk(node_i: torch.Tensor, leaf_f: torch.Tensor,
                  mono: torch.Tensor, eff: torch.Tensor, parent: torch.Tensor,
                  feature: torch.Tensor, threshold: torch.Tensor,
                  lw: torch.Tensor, rw: torch.Tensor, node: int
                  ) -> torch.Tensor:
    """Walk after split ``node`` and return the ``[L]`` bool flags of the
    leaves whose bounds moved; the bounds (``leaf_f[:, _CMIN]``,
    ``leaf_f[:, _CMAX]``) are tightened in place. ``node_i [L-1, 7]``
    int64: the node table; ``leaf_f [L, 10]`` f32: the leaf table (cached
    gains at ``_BG``: a leaf with no valid split keeps its bounds);
    ``mono [F]`` int64; ``eff`` (``[1]`` bool: the split is applied and
    under a monotone split; else nothing moves), ``parent``, ``feature``
    and ``threshold`` (``[1]`` int64: the split node's parent, feature and
    threshold bin), ``lw`` and ``rw`` (f32: the children's outputs) are
    device tensors. On CUDA tensors the kernel runs; on CPU tensors, the
    plain version."""
    if node_i.is_cuda:
        return _walk_cuda(node_i, leaf_f, mono, eff, parent, feature,
                          threshold, lw, rw, node)
    _kernels.PLAIN_CALLS["monotone_walk"] += 1
    return monotone_walk_plain(node_i, leaf_f, mono, eff, parent, feature,
                               threshold, lw, rw, node)


def _walk_cuda(node_i, leaf_f, mono, eff, parent, feature, threshold, lw,
               rw, node):
    L = leaf_f.shape[0]
    smem = _SMEM_PER_LEAF * max(L, 1)
    if smem > _MAX_SMEM:
        raise ValueError(
            f"monotone_constraints_method=intermediate on the card supports "
            f"up to {_MAX_SMEM // _SMEM_PER_LEAF} leaves (num_leaves={L})")
    for t, dt in ((node_i, torch.int64), (leaf_f, torch.float32),
                  (mono, torch.int64), (eff, torch.bool),
                  (parent, torch.int64), (feature, torch.int64),
                  (threshold, torch.int64), (lw, torch.float32),
                  (rw, torch.float32)):
        if t.dtype != dt or t.device != leaf_f.device:
            raise ValueError(f"monotone_walk: expected {dt} on "
                             f"{leaf_f.device}, got {t.dtype} on {t.device}")
    if leaf_f.stride(1) != 1 or node_i.stride(1) != 1 \
            or node_i.shape[1] < _NODE_I:
        raise ValueError("monotone_walk: the node and leaf tables must be "
                         "row-major, the node table 7 columns wide")
    flags = torch.empty(L, dtype=torch.uint8, device=leaf_f.device)
    _kernels.launch(
        "monotone_walk", "lgbt_monotone_walk", leaf_f.device,
        node_i.data_ptr(), node_i.stride(0), node, mono.data_ptr(),
        leaf_f.data_ptr(), leaf_f.stride(0), _BG, _CMIN, _CMAX,
        eff.data_ptr(), parent.data_ptr(), feature.data_ptr(),
        threshold.data_ptr(), lw.data_ptr(), rw.data_ptr(),
        flags.data_ptr(), L, smem)
    return flags.view(torch.bool)


def monotone_walk_plain(node_i, leaf_f, mono, eff, parent, feature,
                        threshold, lw, rw, node: int) -> torch.Tensor:
    """The plain version of the walk: the reference's up- and down-walk
    (``lightgbm_tpu/ops/grower_compact.py:859-991``) as Python loops over
    the tables' values, with the reference's f32 comparisons."""
    L = leaf_f.shape[0]
    flags = [False] * L
    if not bool(eff.reshape(-1)[0]):
        return torch.zeros(L, dtype=torch.bool, device=leaf_f.device)
    nt = node_i.tolist()
    mt = mono.tolist()
    gain = leaf_f[:, _BG].tolist()
    cmin = leaf_f[:, _CMIN].clone()
    cmax = leaf_f[:, _CMAX].clone()
    f_split = int(feature.reshape(-1)[0])
    thr_split = int(threshold.reshape(-1)[0])
    lw_, rw_ = lw.reshape(()), rw.reshape(())
    lo_out, hi_out = torch.minimum(lw_, rw_), torch.maximum(lw_, rw_)

    # ---- up: the pending monotone branches and the climbed splits ----
    feats_u, thrs_u, wasr_u = [], [], []
    pending = []                        # (branch root, update max?, depth)
    cur, par = node, int(parent.reshape(-1)[0])
    while par >= 0:
        pf, pt = nt[par][_SF], nt[par][_SB]
        p_num = nt[par][_NCAT] == 0
        mt_p = mt[pf]
        is_right = nt[par][_RIGHT] == cur
        clash = any(feats_u[j] == pf and wasr_u[j] == is_right
                    for j in range(len(feats_u)))
        if p_num and not clash:
            left_is_cur = nt[par][_LEFT] == cur
            if mt_p != 0:
                opp = nt[par][_RIGHT] if left_is_cur else nt[par][_LEFT]
                umax = left_is_cur if mt_p < 0 else not left_is_cur
                pending.append((opp, umax, len(feats_u)))
            feats_u.append(pf)
            thrs_u.append(pt)
            wasr_u.append(is_right)
        cur, par = par, nt[par][_NPAR]

    # ---- down: clamp the contiguous leaves of each pending branch ----
    for root, umax, dj in pending:
        stack = [(root, True, True)]
        while stack:
            nd, ul, ur = stack.pop()
            if nd < 0:
                leaf = -(nd + 1)
                both = ul and ur
                near = rw_ if ur else lw_
                if gain[leaf] > _NEG_INF / 2:
                    if umax:
                        new = torch.minimum(cmax[leaf],
                                            lo_out if both else near)
                        flags[leaf] |= bool(new < cmax[leaf])
                        cmax[leaf] = new
                    else:
                        new = torch.maximum(cmin[leaf],
                                            hi_out if both else near)
                        flags[leaf] |= bool(new > cmin[leaf])
                        cmin[leaf] = new
                continue
            nf, nthr = nt[nd][_SF], nt[nd][_SB]
            n_num = nt[nd][_NCAT] == 0
            same = [j for j in range(dj) if feats_u[j] == nf]
            keep_r = not n_num or not any(
                nthr >= thrs_u[j] and not wasr_u[j] for j in same)
            keep_l = not n_num or not any(
                nthr <= thrs_u[j] and wasr_u[j] for j in same)
            ul4r = not (n_num and nf == f_split and nthr >= thr_split)
            ur4l = not (n_num and nf == f_split and nthr <= thr_split)
            # the reference pushes left, then right, and pops right first
            if keep_l:
                stack.append((nt[nd][_LEFT], ul, ur and ur4l))
            if keep_r:
                stack.append((nt[nd][_RIGHT], ul and ul4r, ur))
    leaf_f[:, _CMIN] = cmin
    leaf_f[:, _CMAX] = cmax
    return torch.tensor(flags, dtype=torch.bool, device=leaf_f.device)
