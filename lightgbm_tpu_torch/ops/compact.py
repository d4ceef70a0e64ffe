"""Compacted (physically partitioned) row storage for the serial tree learner.

Counterpart of ``lightgbm_tpu/ops/compact.py`` (reference: LightGBM's
DataPartition, src/treelearner/data_partition.hpp, and its CUDA variant
cuda_data_partition.cu). Every leaf owns a contiguous segment of a packed
row-record array, so a split streams only the parent's rows and a leaf's
histogram streams only its own rows.

Row records pack into one ``uint8`` matrix ``[N, C]``, byte for byte the
JAX package's layout:

    [0, F)          binned features (uint8; with ``packed4`` ceil(F/2)
                    bytes, two features a byte)
    [F, F+4)        grad   (f32 bytes, already times the sample weight)
    [F+4, F+8)      hess   (f32 bytes, already times the sample weight)
    [F+8, F+12)     sample weight (f32 bytes; 0 = out of bag)
    [F+12, ..+4E)   E extra f32 columns carried through every partition
                    (score, label, weight, original row id)

C is rounded up to 128 bytes, so a record is one 128-byte line on the GPU.
A partition moves only its first ``moved_cols`` bytes (the real columns in
whole 16-byte vectors); the padding after them is zero and stays zero.

``partition_segment`` and ``segment_histogram`` here are plain PyTorch: they
are the oracles the kernels of ``ops/fused_split.py`` and
``ops/pallas_histogram.py`` are held against, and the CPU path. Unlike the
JAX package, the arrays carry no padding rows: the Hopper kernels never
write past a segment's end.

``RowLayout.packed4`` (``tpu_bin_pack4``): the bin columns hold two
features a byte, feature ``2j`` in the low nibble of byte ``j`` (the
``io/dataset.py`` ``pack4_matrix`` layout); every reader takes feature
``f`` from byte ``f >> 1``, shift ``4 * (f & 1)``, so the full-width
matrix never lies on the device (reference: ``lightgbm_tpu/ops/
compact.py:54-75``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .histogram import _xla_histogram, _xla_histogram_narrow
from .packed import unpack4
from .split import go_left_pred


class RowLayout(NamedTuple):
    """Static description of the packed row record. ``num_features`` is
    the logical feature count; ``feat_cols`` the stored bin bytes."""
    num_features: int
    num_extra: int          # number of carried f32 columns
    packed4: bool = False   # bin columns nibble-packed, two features a byte

    @property
    def feat_cols(self) -> int:
        if self.packed4:
            return (self.num_features + 1) // 2
        return self.num_features

    @property
    def grad_off(self) -> int:
        return self.feat_cols

    @property
    def hess_off(self) -> int:
        return self.feat_cols + 4

    @property
    def cnt_off(self) -> int:
        return self.feat_cols + 8

    @property
    def extra_off(self) -> int:
        return self.feat_cols + 12

    @property
    def num_real_cols(self) -> int:
        return self.feat_cols + 12 + 4 * self.num_extra

    @property
    def num_cols(self) -> int:
        return -(-self.num_real_cols // 128) * 128

    @property
    def moved_cols(self) -> int:
        """Bytes of a record that a partition moves: the real columns
        rounded up to whole 16-byte vectors (the rest is zero padding)."""
        return -(-self.num_real_cols // 16) * 16


def _f32_to_u8(x: torch.Tensor) -> torch.Tensor:
    """[N] f32 -> [N, 4] u8 (exact bit copy)."""
    return x.to(torch.float32).contiguous().view(torch.uint8).reshape(-1, 4)


def _u8_to_f32(x: torch.Tensor) -> torch.Tensor:
    """[..., 4] u8 -> [...] f32 (exact bit copy)."""
    if x.numel() == 0:
        # an empty slice keeps its storage offset, which may not be 4-aligned
        return x.new_empty(x.shape[:-1], dtype=torch.float32)
    return x.contiguous().view(torch.float32)[..., 0]


def pack_rows(binned: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              cnt: torch.Tensor, extras: torch.Tensor,
              layout: RowLayout) -> torch.Tensor:
    """Pack per-row arrays into the ``[N, C]`` record matrix; with
    ``layout.packed4`` a full-width ``[N, F]`` bin matrix nibble-packs here
    (an already packed ``[N, ceil(F/2)]`` one passes through)."""
    n = binned.shape[0]
    work = torch.zeros((n, layout.num_cols), dtype=torch.uint8,
                       device=binned.device)
    binned = binned.to(torch.uint8)
    if layout.packed4 and binned.shape[1] == layout.num_features:
        if layout.num_features % 2:
            binned = torch.nn.functional.pad(binned, (0, 1))
        binned = binned[:, 0::2] | (binned[:, 1::2] << 4)
    f = layout.feat_cols
    work[:, :f] = binned
    cols = [grad, hess, cnt.to(torch.float32)]
    cols += [extras[i] for i in range(layout.num_extra)]
    packed = torch.stack([c.to(torch.float32) for c in cols], dim=1)
    work[:, f:f + 4 * len(cols)] = packed.contiguous().view(
        torch.uint8).reshape(n, 4 * len(cols))
    return work


def unpack_rows(work: torch.Tensor, n: int, layout: RowLayout):
    """Inverse of ``pack_rows`` on the first ``n`` rows (packed bins
    unpacked to the full ``[n, F]`` width)."""
    binned = work[:n, :layout.feat_cols]
    if layout.packed4:
        binned = unpack4(binned, layout.num_features)
    grad = _u8_to_f32(work[:n, layout.grad_off:layout.grad_off + 4])
    hess = _u8_to_f32(work[:n, layout.hess_off:layout.hess_off + 4])
    cnt = _u8_to_f32(work[:n, layout.cnt_off:layout.cnt_off + 4])
    e = work[:n, layout.extra_off:layout.extra_off + 4 * layout.num_extra]
    extras = _u8_to_f32(e.reshape(n, layout.num_extra, 4)).T
    return binned, grad, hess, cnt, extras


def record_channels(rows: torch.Tensor, layout: RowLayout,
                    quant: bool = False) -> torch.Tensor:
    """[M, C] u8 records -> [M, 4] histogram channels (grad, hess, in-bag
    indicator, raw count 1): f32, or int32 with ``quant``, where the grad
    and hess columns hold the discretizer's integer codes (exact in f32)."""
    g = _u8_to_f32(rows[:, layout.grad_off:layout.grad_off + 4])
    h = _u8_to_f32(rows[:, layout.hess_off:layout.hess_off + 4])
    c = _u8_to_f32(rows[:, layout.cnt_off:layout.cnt_off + 4])
    dt = torch.int32 if quant else torch.float32
    ones = torch.ones_like(g, dtype=dt)
    return torch.stack([g.to(dt), h.to(dt), (c != 0.0).to(dt), ones], dim=1)


def record_bins(rows: torch.Tensor, layout: RowLayout) -> torch.Tensor:
    """``[M, C]`` records -> their ``[M, F]`` u8 bins (nibbles unpacked)."""
    bins = rows[:, :layout.feat_cols]
    if layout.packed4:
        bins = unpack4(bins, layout.num_features)
    return bins


def record_column(rows: torch.Tensor, feature: int,
                  layout: RowLayout) -> torch.Tensor:
    """Feature ``feature``'s bins of ``[M, C]`` records (its nibble under
    ``packed4``: byte ``feature >> 1``, shift ``4 * (feature & 1)``)."""
    if layout.packed4:
        return (rows[:, feature >> 1] >> (4 * (feature & 1))) & 0x0F
    return rows[:, feature]


def segment_histogram(work: torch.Tensor, start: int, count: int,
                      layout: RowLayout, num_bins: int,
                      quant: bool = False, acc_bits: int = 32,
                      quant_max: int = 127,
                      hist_layout: str = "lane") -> torch.Tensor:
    """Histogram ``[F, B, 4]`` of the contiguous segment
    ``work[start:start+count]`` (channels: grad, hess, in-bag count, raw
    count). Counts accumulate in f32, exact below 2^24 rows; with ``quant``
    every channel is an exact int32 sum of integer codes (reference:
    ``segment_histogram(quantized=True)``, ``lightgbm_tpu/ops/compact.py:
    323-413``), and ``acc_bits=16`` takes the narrowed engine (the same
    int32 sums; ``quant_max`` bounds |code|). Packed bins unpack here.
    Plain PyTorch on any device: ``hist_layout`` only names the kernel
    whose plain call this is (``PLAIN_CALLS``)."""
    rows = work[start:start + count]
    bins = record_bins(rows, layout)
    ch = record_channels(rows, layout, quant)
    kernel = "histogram_sublane" if hist_layout == "sublane" else "histogram"
    if quant and acc_bits == 16:
        return _xla_histogram_narrow(bins, ch, num_bins, quant_max, kernel)
    return _xla_histogram(bins, ch, num_bins, kernel)


def partition_segment(work: torch.Tensor, start: int, count: int,
                      feature: int, bin_: int, default_left, nan_bin: int,
                      is_cat, cat_bitset: torch.Tensor,
                      layout: Optional[RowLayout] = None
                      ) -> Tuple[torch.Tensor, int]:
    """Stably partition ``work[start:start+count]`` in place: left-child
    rows first, then right-child rows, each in their original order
    (``layout.packed4``: the feature's nibble routes). Returns ``(work,
    n_left)``."""
    seg = work[start:start + count]
    col = (seg[:, feature] if layout is None
           else record_column(seg, feature, layout))
    gl = go_left_pred(col, bin_, default_left, nan_bin, is_cat,
                      cat_bitset)
    left, right = seg[gl], seg[~gl]
    work[start:start + count] = torch.cat([left, right])
    return work, int(left.shape[0])


def segments_to_leaf_vectors(leaf_start: torch.Tensor,
                             leaf_rows: torch.Tensor,
                             leaf_value: torch.Tensor, n: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expand per-leaf segments into per-row (leaf_id, leaf_value).

    Final leaf segments tile ``[0, n)``, so a sparse delta (+leaf id at the
    segment start, -leaf id at its end) followed by a prefix sum gives every
    row its leaf, exactly; zero-row leaves cancel at one index."""
    ll = leaf_start.to(torch.int64)
    ends = ll + leaf_rows.to(torch.int64)
    lid = torch.arange(leaf_start.shape[0], device=leaf_start.device)
    delta = torch.zeros(n + 1, dtype=torch.int64, device=leaf_start.device)
    delta.index_add_(0, torch.cat([ll, ends]), torch.cat([lid, -lid]))
    row_leaf = torch.cumsum(delta, 0)[:n]
    return row_leaf, leaf_value[row_leaf]
