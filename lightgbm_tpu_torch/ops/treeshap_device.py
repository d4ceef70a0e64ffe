"""TreeSHAP on the device: the window's paths, the plain version and the
kernel's wrapper.

Counterpart of ``lightgbm_tpu/ops/treeshap_device.py`` (``build_shap_paths``
``:70-135``, ``_path_agreement``, ``_extend_unwind``, ``_leaf_phi``
``:142-246``), which unrolls the reference's recursive TreeSHAP (Lundberg et
al.; reference: Tree::TreeSHAP, src/io/tree.cpp) per leaf. No Pallas kernel
is replaced: the JAX package runs this as an XLA program, and the port runs
it as a hand-written CUDA kernel (``csrc/treeshap.cu``) on the card.

``build_shap_paths`` runs once a prediction window, on the host: for each
leaf, the internal nodes on its path and the direction the path takes; the
slot of each step, a feature repeated on the path sharing one slot (the
reference's UNWIND merge); each slot's merged cover fraction in float64
(the JAX package rounds them to f32; the port does not) and feature; the
unique length ``ulen``; and each tree's expected value. A row's ``one``
fraction of a slot is 1 when the row agrees with every step of that slot
(the predicate of ``ops/predict.py``: numerical ``bin <= threshold``, the
NaN bin following ``default_left``, a categorical node's bin bitset). Then,
for each leaf, EXTEND over slots ``1..u`` and the UNWIND sum of every slot
give the slot feature ``w * (one - zero) * leaf_value``; the tree's
expected value goes to the bias column. Extension order does not change
the result in exact arithmetic: the reference's host recursion, which
re-extends a repeated feature at the end, parts from this by rounding only.

``tree_shap`` returns ``[N, K, F+1]`` float64, tree ``t`` adding to class
``t % K``. On CUDA tensors it launches the kernel (or raises); on CPU
tensors it runs ``tree_shap_plain``: PyTorch in float64, vectorised over a
tree's leaves and rows, with Python loops only over the path's slots.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .. import _kernels
from .packed import bin_values
from .treeshap import tree_expected_value

# elements of one [rows, leaves, slots] temporary of the plain version: 32
# MB on the host, 512 MB on a card
_PLAIN_CHUNK_ELEMS = {"cpu": 1 << 22, "cuda": 1 << 26}
# kernel scratch a row: ``pweight`` (8 bytes) and ``one`` (1 byte) a slot
# and 4 bytes a word of node decisions; rows are launched in chunks whose
# scratch stays under this
_SCRATCH_BYTES = 1 << 30


class ShapPaths(NamedTuple):
    """A window's trees as TreeSHAP tables, on the device. ``M`` is the most
    internal nodes of a tree, ``W`` the bitset words of a node, ``L`` the
    most leaves, ``D`` the most steps of a path and ``U`` the most slots of
    a path plus one (slot 0 is the root's placeholder, ``(one, zero) =
    (1, 1)``, weight 0). Padded steps point at node -1 and slot 0; padded
    slots keep ``zfrac`` 1 and feature 0."""

    split_feature: torch.Tensor   # [T, M] int32
    split_bin: torch.Tensor       # [T, M] int32
    nan_bin: torch.Tensor         # [T, M] int32: the node feature's NaN bin
    node_flags: torch.Tensor      # [T, M] int32: 1 default left, 2 categorical
    cat_bitset: torch.Tensor      # [T, M, W] int32 (uint32 bit patterns)
    num_nodes: torch.Tensor       # [T] int32
    num_leaves: torch.Tensor      # [T] int32
    path_len: torch.Tensor        # [T, L] int32
    step_node: torch.Tensor       # [T, L, D] int32
    step_left: torch.Tensor       # [T, L, D] int32: 1 where the path goes left
    step_slot: torch.Tensor       # [T, L, D] int32 (1-based)
    zfrac: torch.Tensor           # [T, L, U] float64
    feat: torch.Tensor            # [T, L, U] int32
    ulen: torch.Tensor            # [T, L] int32
    leaf_value: torch.Tensor      # [T, L] float64
    ev: torch.Tensor              # [T] float64
    # per tree, on the host: internal nodes, leaves, longest unique path,
    # longest path (the plain version's loop bounds)
    host_shape: Tuple[Tuple[int, int, int, int], ...]


def build_shap_paths(models: Sequence, nan_bin: np.ndarray,
                     is_cat_feature: np.ndarray, device) -> ShapPaths:
    """The TreeSHAP tables of host trees (``boosting/gbdt.py`` ``HostTree``:
    bin thresholds, leaf and internal counts), routed per original feature
    with ``nan_bin [F]`` and ``is_cat_feature [F]``."""
    t_count = len(models)
    m_max = max([m.num_nodes for m in models] + [1])
    l_max = max([m.num_leaves for m in models] + [1])
    w = max([m.cat_bitset.shape[1] for m in models] + [1])
    paths = []
    d_max, u_max = 1, 0
    for m in models:
        leaves = _tree_paths(m)
        paths.append(leaves)
        for steps, slots in leaves.values():
            d_max = max(d_max, len(steps))
            u_max = max(u_max, len(slots))
    u1 = u_max + 1
    sf = np.zeros((t_count, m_max), np.int32)
    sb = np.zeros((t_count, m_max), np.int32)
    nb = np.zeros((t_count, m_max), np.int32)
    fl = np.zeros((t_count, m_max), np.int32)
    bits = np.zeros((t_count, m_max, w), np.uint32)
    path_len = np.zeros((t_count, l_max), np.int32)
    node = np.full((t_count, l_max, d_max), -1, np.int32)
    left = np.zeros((t_count, l_max, d_max), np.int32)
    slot = np.zeros((t_count, l_max, d_max), np.int32)
    zfrac = np.ones((t_count, l_max, u1), np.float64)
    feat = np.zeros((t_count, l_max, u1), np.int32)
    ulen = np.zeros((t_count, l_max), np.int32)
    lv = np.zeros((t_count, l_max), np.float64)
    ev = np.zeros(t_count, np.float64)
    host_shape = []
    for ti, (m, leaves) in enumerate(zip(models, paths)):
        nn = m.num_nodes
        ev[ti] = tree_expected_value(m.left_child, m.right_child,
                                     m.leaf_value, m.internal_count,
                                     m.leaf_count, nn)
        lv[ti, :m.num_leaves] = m.leaf_value[:m.num_leaves]
        if nn:
            f = m.split_feature[:nn].astype(np.int64)
            sf[ti, :nn] = f
            sb[ti, :nn] = m.split_bin[:nn]
            nb[ti, :nn] = nan_bin[f]
            fl[ti, :nn] = (np.asarray(m.default_left[:nn], np.int32)
                           | (np.asarray(is_cat_feature, np.int32)[f] << 1))
            cb = np.asarray(m.cat_bitset, np.uint32)[:nn]
            bits[ti, :nn, :cb.shape[1]] = cb
        for leaf, (steps, slots) in leaves.items():
            path_len[ti, leaf] = len(steps)
            for s, (inode, went_left, j) in enumerate(steps):
                node[ti, leaf, s] = inode
                left[ti, leaf, s] = went_left
                slot[ti, leaf, s] = j
            for j, (fj, z) in enumerate(slots, start=1):
                feat[ti, leaf, j] = fj
                zfrac[ti, leaf, j] = z
            ulen[ti, leaf] = len(slots)
        host_shape.append((nn, m.num_leaves if nn else 0,
                           int(ulen[ti].max(initial=0)),
                           int(path_len[ti].max(initial=0))))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return ShapPaths(
        dev(sf), dev(sb), dev(nb), dev(fl), dev(bits.view(np.int32)),
        dev(np.array([m.num_nodes for m in models], np.int32)),
        dev(np.array([m.num_leaves for m in models], np.int32)),
        dev(path_len), dev(node), dev(left), dev(slot), dev(zfrac),
        dev(feat), dev(ulen), dev(lv), dev(ev), tuple(host_shape))


def _tree_paths(m) -> dict:
    """``{leaf: (steps, slots)}`` of one tree: ``steps`` the ``(node, went
    left, slot)`` of each internal node on the leaf's path, root first;
    ``slots`` the ``(feature, merged cover fraction)`` of each distinct
    feature in order of first appearance. Cover fractions multiply in
    float64 (reference: covers clipped at 1e-12)."""
    if m.num_nodes == 0:
        return {}

    def cover(nd: int) -> float:
        if nd < 0:
            return max(float(m.leaf_count[-(nd + 1)]), 1e-12)
        return max(float(m.internal_count[nd]), 1e-12)

    out = {}
    stack = [(0, ())]
    while stack:
        nd, path = stack.pop()
        if nd < 0:
            slot_of, slots, steps = {}, [], []
            for inode, went_left, child in path:
                f = int(m.split_feature[inode])
                if f not in slot_of:
                    slot_of[f] = len(slots)
                    slots.append([f, 1.0])
                j = slot_of[f]
                slots[j][1] *= cover(child) / cover(inode)
                steps.append((inode, went_left, j + 1))
            out[-(nd + 1)] = (steps, [tuple(s) for s in slots])
            continue
        lc, rc = int(m.left_child[nd]), int(m.right_child[nd])
        stack.append((lc, path + ((nd, 1, lc),)))
        stack.append((rc, path + ((nd, 0, rc),)))
    return out


def tree_shap(binned: torch.Tensor, paths: ShapPaths, num_class: int
              ) -> torch.Tensor:
    """TreeSHAP contributions ``[N, K, F+1]`` float64 of ``binned [N, F]``
    rows (bias last): uint8, or the int16 view of 16-bit bins
    (``ops/packed.py``), which the kernel reads as uint16. On CUDA tensors
    the kernel runs; on CPU tensors, the plain version."""
    if binned.is_cuda:
        return _tree_shap_cuda(binned, paths, num_class)
    _kernels.PLAIN_CALLS["treeshap"] += 1
    return tree_shap_plain(binned, paths, num_class)


def _tree_shap_cuda(binned, paths, num_class):
    dev = binned.device
    for name, t in paths._asdict().items():
        if not isinstance(t, torch.Tensor):
            continue
        want = (torch.float64 if name in ("zfrac", "leaf_value", "ev")
                else torch.int32)
        if t.device != dev or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"tree_shap: table {name} must be contiguous "
                             f"{want} on {dev}")
    if binned.dtype not in (torch.uint8, torch.int16) \
            or binned.dim() != 2 or binned.stride(1) != 1:
        raise ValueError("tree_shap: binned must be [N, F] uint8 (or the "
                         "int16 view of 16-bit bins) with unit feature "
                         "stride")
    wide = binned.dtype == torch.int16
    n, f = binned.shape
    if int(paths.split_feature.max()) >= f:
        raise ValueError(f"tree_shap: a split on a feature past the rows' "
                         f"{f}")
    t_count, m_max = paths.split_feature.shape
    l_max, d_max = paths.step_node.shape[1:]
    u1 = paths.zfrac.shape[2]
    words = -(-m_max // 32)
    out = torch.zeros((n, num_class, f + 1), dtype=torch.float64,
                      device=dev)
    if n == 0 or t_count == 0:
        return out
    chunk = max(1, min(n, _SCRATCH_BYTES // (9 * u1 + 4 * words)))
    pw = torch.empty(u1 * chunk, dtype=torch.float64, device=dev)
    one = torch.empty(u1 * chunk, dtype=torch.uint8, device=dev)
    dec = torch.empty(words * chunk, dtype=torch.int32, device=dev)
    for r0 in range(0, n, chunk):
        rows = min(chunk, n - r0)
        part = binned[r0:r0 + rows]
        _kernels.launch(
            "treeshap", "lgbt_treeshap_u16" if wide else "lgbt_treeshap",
            dev,
            part.data_ptr(), rows, part.stride(0), f, t_count, m_max,
            paths.cat_bitset.shape[2], l_max, d_max, u1, num_class,
            paths.split_feature.data_ptr(), paths.split_bin.data_ptr(),
            paths.nan_bin.data_ptr(), paths.node_flags.data_ptr(),
            paths.cat_bitset.data_ptr(), paths.num_nodes.data_ptr(),
            paths.num_leaves.data_ptr(), paths.path_len.data_ptr(),
            paths.step_node.data_ptr(), paths.step_left.data_ptr(),
            paths.step_slot.data_ptr(), paths.zfrac.data_ptr(),
            paths.feat.data_ptr(), paths.ulen.data_ptr(),
            paths.leaf_value.data_ptr(), paths.ev.data_ptr(),
            out[r0:r0 + rows].data_ptr(), pw.data_ptr(), one.data_ptr(),
            dec.data_ptr(), mode="u16" if wide else None)
    return out


def _node_decisions(binned: torch.Tensor, paths: ShapPaths, t: int,
                    nn: int) -> torch.Tensor:
    """``[N, nn]`` bool: each internal node's go-left decision for each
    row (the predicate of ``ops/predict.py`` ``predict_leaf_batched``)."""
    sf = paths.split_feature[t, :nn].to(torch.int64)
    fcol = bin_values(binned[:, sf])                              # [N, nn]
    flags = paths.node_flags[t, :nn]
    go_left = (fcol <= paths.split_bin[t, :nn].to(torch.int64)) | (
        ((flags & 1) != 0) & (fcol == paths.nan_bin[t, :nn].to(torch.int64)))
    is_cat = (flags & 2) != 0
    if bool(is_cat.any()):
        w = paths.cat_bitset.shape[2]
        words = paths.cat_bitset[t, :nn].to(torch.int64).reshape(-1)
        wi = fcol >> 5
        base = torch.arange(nn, device=binned.device) * w
        word = words[base[None, :] + torch.clamp(wi, max=w - 1)]
        in_set = (wi < w) & (((word >> (fcol & 31)) & 1) != 0)
        go_left = torch.where(is_cat[None, :], in_set, go_left)
    return go_left


def tree_shap_plain(binned: torch.Tensor, paths: ShapPaths, num_class: int
                    ) -> torch.Tensor:
    """The plain version of ``tree_shap``: the JAX package's
    ``_path_agreement``, ``_extend_unwind`` and ``_leaf_phi`` in float64,
    one tree at a time over ``[rows, leaves, slots]``, with the reference's
    operations in the reference's order. A tree's leaves are taken longest
    unique path first, so that step ``j`` of a recurrence works on the
    leaves that have one (a prefix) and, in EXTEND, on slots ``0..j``
    only; the leaves' sums go back to leaf order before they add up."""
    n, f = binned.shape
    dev = binned.device
    f64 = torch.float64
    out = torch.zeros((n, num_class, f + 1), dtype=f64, device=dev)
    for t, (nn, nl, u_max, d_max) in enumerate(paths.host_shape):
        cls = t % num_class
        out[:, cls, f] += paths.ev[t]
        if nn == 0:
            continue
        u1 = u_max + 1
        ulen = paths.ulen[t, :nl].to(torch.int64)
        order = torch.argsort(-ulen, stable=True)
        inverse = torch.argsort(order)
        # leaves with at least j slots: the first live[j] after the sort
        live = np.bincount(ulen.cpu().numpy(), minlength=u1)[::-1] \
            .cumsum()[::-1].tolist()
        ulen = ulen[order]
        node = paths.step_node[t, :nl, :d_max].to(torch.int64)[order]
        went = paths.step_left[t, :nl, :d_max][order] != 0
        slot = paths.step_slot[t, :nl, :d_max].to(torch.int64)[order]
        zero = paths.zfrac[t, :nl, :u1][order]                    # [L, U]
        feat = paths.feat[t, :nl, :u1].to(torch.int64).reshape(-1)
        lv = paths.leaf_value[t, :nl][order]
        uf = ulen.to(f64)[None, :, None]
        rows = max(1, _PLAIN_CHUNK_ELEMS[dev.type] // (nl * max(u1, d_max)))
        for r0 in range(0, n, rows):
            part = binned[r0:r0 + rows]
            b = part.shape[0]
            dec = _node_decisions(part, paths, t, nn)              # [B, nn]
            agree = (dec[:, node.clamp(min=0)] == went) | (node < 0)
            miss = torch.zeros((b, nl, u1), dtype=f64, device=dev)
            miss.scatter_add_(2, slot.expand(b, nl, d_max),
                              (~agree).to(f64))
            one = (miss == 0).to(f64)                              # [B, L, U]
            # EXTEND over slots 1..u: p[k] = z p[k] (j-k)/(j+1)
            #                                + o p[k-1] k/(j+1)
            p = torch.zeros((b, nl, u1), dtype=f64, device=dev)
            p[..., 0] = 1.0
            for j in range(1, u_max + 1):
                c = live[j]
                kk = torch.arange(j + 1, dtype=f64, device=dev)
                pj = p[:, :c, :j + 1]
                z = zero[:c, j][None, :, None]
                o = one[:, :c, j][..., None]
                shifted = torch.nn.functional.pad(pj, (1, 0))[..., :-1]
                p[:, :c, :j + 1] = (z * pj * (j - kk) / (j + 1)
                                    + o * shifted * kk / (j + 1))
            # UNWIND sums of every slot, i = u-1 .. 0
            nxt = p.gather(2, ulen[None, :, None].expand(b, nl, 1)) \
                .expand(b, nl, u1).clone()
            total = torch.zeros_like(p)
            nz = one != 0
            safe_one = torch.where(nz, one, 1.0)
            for s in range(u_max):
                c = live[s + 1]
                i = ulen[:c] - 1 - s
                i_f = i.to(f64)[None, :, None]
                u_c = uf[:, :c]
                z = zero[None, :c]
                pi = p[:, :c].gather(2, i[None, :, None].expand(b, c, 1))
                tmp = nxt[:, :c] * (u_c + 1) / ((i_f + 1) * safe_one[:, :c])
                add = torch.where(nz[:, :c], tmp,
                                  pi / (z * (u_c - i_f) / (u_c + 1)))
                nxt[:, :c] = torch.where(
                    nz[:, :c], pi - tmp * z * (u_c - i_f) / (u_c + 1),
                    nxt[:, :c])
                total[:, :c] += add
            # slot 0 and the padded slots carry (one, zero) = (1, 1): 0
            phi = (total * (one - zero) * lv[None, :, None])[:, inverse]
            out[r0:r0 + b, cls].index_add_(1, feat, phi.reshape(b, -1))
    return out


def shap_ops(paths: ShapPaths, rows: int) -> float:
    """Float64 operations ``tree_shap`` needs for ``rows`` rows, counting
    only the work that depends on the row (an FMA is 2): the factors
    ``(k+1)/(j+1)``, ``z_j (j-k)/(j+1)`` and ``z_i (u-k)/(u+1)`` come from
    the leaf's tables alone and ``one`` is 0 or 1, so an EXTEND (slot, step)
    pair needs a conditional FMA and a product (3), an UNWIND step on its
    cheaper branch (``one = 0``) an FMA (2) and a slot's contribution an
    FMA (2): ``1.5 u(u+1) + 2 u^2 + 2u`` for every leaf of ``u > 0`` slots
    (the bound of ``chip_smoke.py``)."""
    u = paths.ulen.to(torch.float64)
    per_row = (1.5 * u * (u + 1) + 2.0 * u * u + 2.0 * u).sum()
    return float(per_row) * rows
