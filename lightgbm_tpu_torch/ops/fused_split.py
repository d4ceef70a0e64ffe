"""Fused per-split kernel K2 for Hopper: stable partition of the parent's
segment plus the smaller child's histogram, with its wrapper and plain
version.

Counterpart of ``lightgbm_tpu/ops/fused_split.py``: the TPU kernel
``_fused_kernel`` (wrapper ``fused_split``) streams the parent's segment once
through VMEM, partitions it with a one-hot permutation matmul and
accumulates the smaller child's histogram on the MXU. On Hopper the same
function is a short chain of launches (``csrc/fused_split.cu``: routing
counts, block offsets, a stable scatter of whole 128-byte records, the
copy-back of the left child) followed by the histogram kernel K1 in record
mode over the smaller child's contiguous range
(``ops/pallas_histogram.py`` ``record_histogram``). Mode 1 skips the
partition and histograms the whole segment (the root). The source note of
``csrc/fused_split.cu`` says what bounds the chain on the H100 and how dual
residency is kept race-free.

The contract is the TPU's (dual residency): the parent's segment
``[start, start+count)`` lives in ``work`` (side 0) or ``scratch``
(side 1); afterwards the left child is at ``[start, start+n_left)`` of the
parent's array and the right child at ``[start+n_left, start+count)`` of
the other array, both in their original row order; rows outside the
segment are untouched. The wrapper updates both arrays in place and
returns them with the ``[F, B, 4]`` histogram (grad, hess, in-bag count,
raw count) of the smaller child, or of the child ``smaller_left`` names.

Not here yet: the quantized (``quant``) and nibble-packed (``packed4``)
records and the copy-back variant ``dual=False`` (ROADMAP A15, A13).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _kernels
from .compact import RowLayout, segment_histogram
from .pallas_histogram import _check_records, record_histogram
from .split import go_left_pred

_SMS: dict = {}


def _n_blocks(dev: torch.device) -> int:
    """Fixed grid of the partition kernels: two blocks per SM."""
    if dev not in _SMS:
        _SMS[dev] = 2 * torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _SMS[dev]


def fused_split_plain(work, scratch, mode, start, count, n_left, feature,
                      bin_, default_left, nan_bin, is_cat, cat_bitset,
                      layout: RowLayout, num_bins: int, smaller_left=None,
                      side=None) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain PyTorch version of K2: masks and ``torch.cat`` in stable
    order, the same writes as the kernel chain (both children into the
    other array, the left child copied back)."""
    _kernels.PLAIN_CALLS["fused_split"] += 1
    n_rows = work.shape[0]
    s = min(max(int(start), 0), n_rows)
    c = min(max(int(count), 0), n_rows - s)
    nl = min(max(int(n_left), 0), c)
    sd = int(side) != 0 if side is not None else False
    src, dst = (scratch, work) if sd else (work, scratch)
    if mode == 1:
        return work, scratch, segment_histogram(src, s, c, layout, num_bins)
    f = min(max(int(feature), 0), layout.num_features - 1)
    bits = (cat_bitset if cat_bitset is not None
            else torch.zeros(1, dtype=torch.int32, device=work.device))
    seg = src[s:s + c]
    gl = go_left_pred(seg[:, f], int(bin_), bool(int(default_left)),
                      int(nan_bin), bool(int(is_cat)), bits)
    left, right = seg[gl], seg[~gl]
    dst[s:s + left.shape[0]] = left
    right = right[:c - nl]
    dst[s + nl:s + nl + right.shape[0]] = right
    src[s:s + nl] = dst[s:s + nl]
    if smaller_left is None:
        sl = nl <= c - nl
    else:
        sl = int(smaller_left) != 0
    hs, hc = (s, nl) if sl else (s + nl, c - nl)
    return work, scratch, segment_histogram(dst, hs, hc, layout, num_bins)


def fused_split(work: torch.Tensor, scratch: torch.Tensor, mode: int,
                start, count, n_left, feature, bin_, default_left, nan_bin,
                is_cat, cat_bitset: Optional[torch.Tensor],
                layout: RowLayout, num_bins: int, smaller_left=None,
                side=None) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """One split (mode 0) or one segment histogram (mode 1).

    ``work``/``scratch``: ``[N, C]`` uint8 record arrays, updated in place.
    ``mode`` is a Python int; every other scalar may be a Python int or a
    one-element tensor on the arrays' device (the grower passes device
    tensors, so nothing is read back to the host). ``cat_bitset``: int32
    words of the categorical bitset (bit patterns), or None.
    Returns ``(work, scratch, hist [F, B, 4])``."""
    if mode not in (0, 1):
        raise ValueError(f"mode must be 0 or 1, got {mode!r}")
    if work.device.type == "cpu":
        return fused_split_plain(work, scratch, mode, start, count, n_left,
                                 feature, bin_, default_left, nan_bin, is_cat,
                                 cat_bitset, layout, num_bins, smaller_left,
                                 side)
    _check_records(work, scratch, layout)
    dev = work.device
    if work.shape[0] >= (1 << 31):
        raise ValueError("the partition kernels index rows in int32")

    def one(x):
        if torch.is_tensor(x):
            if x.numel() != 1 or x.device != dev:
                raise ValueError("split scalars must be one-element tensors "
                                 f"on {dev}")
            return x.reshape(1)
        return torch.full((1,), int(x), dtype=torch.int32, device=dev)

    # one cat (promoting to the widest dtype) and one cast: the grower
    # passes device tensors, and each launch here is one per split
    sp = torch.cat([one(v) for v in (
        start, count, n_left, feature, bin_, default_left, nan_bin, is_cat,
        -1 if smaller_left is None else smaller_left,
        0 if side is None else side)]).to(torch.int32)
    if cat_bitset is None:
        bits = torch.zeros(1, dtype=torch.int32, device=dev)
    else:
        bits = cat_bitset
        if bits.device != dev or bits.dtype != torch.int32 \
                or bits.dim() != 1 or not bits.is_contiguous():
            raise ValueError("cat_bitset must be a contiguous int32 vector "
                             f"on {dev}")
    g = _n_blocks(dev)
    block_left = torch.empty(g, dtype=torch.int32, device=dev)
    ws = torch.empty(16, dtype=torch.int32, device=dev)
    _kernels.launch("fused_split", "lgbt_fused_split", dev, mode,
                    work.data_ptr(), scratch.data_ptr(), work.shape[0],
                    work.shape[1], layout.num_features, sp.data_ptr(),
                    bits.data_ptr(), bits.numel(), block_left.data_ptr(), g,
                    ws.data_ptr())
    # ws[3:6] = (start, count, which array) of the histogram's segment
    hist = record_histogram(work, scratch, ws[3:6], layout, num_bins)
    return work, scratch, hist
