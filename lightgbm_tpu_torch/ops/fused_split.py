"""Fused per-split kernel K2 for Hopper: stable partition of the parent's
segment plus the smaller child's histogram, with its wrapper and plain
version.

Counterpart of ``lightgbm_tpu/ops/fused_split.py``: the TPU kernel
``_fused_kernel`` (wrapper ``fused_split``) streams the parent's segment once
through VMEM, partitions it with a one-hot permutation matmul and
accumulates the smaller child's histogram on the MXU. On Hopper the
partition is one pass with decoupled look-back (``csrc/fused_split.cu``: a
one-thread ``prep`` of the scalars, then tiles taken in ticket order, left
rows written in place, right rows into the other array), followed by the
histogram kernel K1 in record mode over the smaller child's contiguous range
(``ops/pallas_histogram.py`` ``record_histogram``). Mode 1 skips the
partition and histograms the whole segment (the root). The source note of
``csrc/fused_split.cu`` says what bounds the pass on the H100 and why the
in-place writes are race-free.

The contract is the TPU's. With dual residency (``dual=True``, the
default) the parent's segment ``[start, start+count)`` lives in ``work``
(side 0) or ``scratch`` (side 1); afterwards the left child is at
``[start, start+n_left)`` of the parent's array and the right child at
``[start+n_left, start+count)`` of the other array, both in their original
row order; the other array's left range is dead; rows outside the segment
are untouched. The copy-back variant (``dual=False``, the TPU kernel's
``dual=False``, which the JAX package runs on EFB-bundled data) keeps every
segment in ``work``: ``side`` is taken as 0, the right rows stage through
``scratch`` at the same offsets and a third launch copies them back into
``work`` over exactly ``[start+n_left, start+count)``; ``scratch`` is then
dead everywhere. Only the first ``layout.moved_cols`` bytes of a row move
(the padding after them is zero in both arrays). The wrapper updates both
arrays in place and returns them with the ``[F, B, 4]`` histogram (grad,
hess, in-bag count, raw count) of the smaller child, or of the child
``smaller_left`` names.

``quant=True`` is the TPU kernel's quantized mode (``quant``,
``lightgbm_tpu/ops/fused_split.py:337-360``, ``:401-404``): the grad and
hess columns hold the gradient discretizer's integer codes and the
histogram is an exact int32 sum, from K1's integer variant. The partition
moves the same bytes in either mode.

The look-back state (an epoch counter, a tile ticket and one flag a tile)
lives on the device across splits, one set per (device, stream): splits on
one stream run one after another on the device, and a lock keeps each
split's two launches together when several threads issue splits.

``layout.packed4`` is the TPU kernel's ``packed4`` (``lightgbm_tpu/ops/
fused_split.py:217-228``, ``:662``): the bin columns hold two features a
byte, the partition routes by feature ``f``'s nibble (byte ``f >> 1``,
shift ``4 * (f & 1)``) and moves the narrower records, and K1's record
loader unpacks the nibbles; both residencies take it.

``det`` is the deterministic mode (``ops/determinism.py``): the
smaller child's histogram from K1's deterministic record mode
(``MODE_LAUNCHES["fused_split/det"]``). The partition is stable and its
placement fixed, so it is unchanged: its one atomic hands out look-back
tickets, not sums.

``hist=False`` is K2's partition alone (``prep`` and the partition, and in
copy-back the copy), its histogram launch skipped: the compact grower
without the fused kernel (``tpu_fused=off``) partitions with it, as the
JAX package's ``partition_segment`` (XLA there) does, and then histograms
the smaller child itself. The wrapper then returns, in place of the
histogram, the device int32 ``(start, count, which array)`` of the segment
the histogram would have read.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from .. import _kernels
from .compact import RowLayout, record_column, segment_histogram
from .pallas_histogram import _check_records, _modes, record_histogram
from .split import go_left_pred

# the partition kernel's rows a tile: the largest of these whose staged
# vectors (16 B each) and destinations (4 B a row) fit about 72 KB, so three
# blocks share an SM
_TILES = (1024, 512, 256)
_TILE_SMEM = 72 * 1024
_MAX_SMEM = 232448            # the H100's per-block shared-memory limit


def _tile_rows(layout: RowLayout) -> int:
    vec = layout.moved_cols // 16
    for t in _TILES:
        if t * (16 * vec + 4) <= _TILE_SMEM:
            return t
    if 256 * (16 * vec + 4) > _MAX_SMEM:
        raise ValueError(f"records with {layout.num_real_cols} real bytes "
                         "are too wide for the partition kernel")
    return 256


# the partition kernel's look-back state for each (device, stream): ctl
# (epoch, ticket) and one flag a tile, zeroed once and grown with the arrays;
# the lock keeps one split's `prep` and partition together when several
# threads issue splits on one stream
_LOOKBACK: dict = {}
_LOOKBACK_LOCK = threading.Lock()


def _lookback_state(dev: torch.device, n_tiles: int):
    key = (dev, torch.cuda.current_stream(dev).cuda_stream)
    st = _LOOKBACK.get(key)
    if st is None or st[1].numel() < n_tiles:
        st = (torch.zeros(2, dtype=torch.int32, device=dev),
              torch.zeros(max(n_tiles, 1), dtype=torch.int64, device=dev))
        _LOOKBACK[key] = st
    return st


def fused_split_plain(work, scratch, mode, start, count, n_left, feature,
                      bin_, default_left, nan_bin, is_cat, cat_bitset,
                      layout: RowLayout, num_bins: int, smaller_left=None,
                      side=None, dual: bool = True, quant: bool = False,
                      hist: bool = True, det=None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: masks in stable order, the same writes
    as the kernel (left rows in place, right rows into the other array, the
    first ``layout.moved_cols`` bytes of a row; with ``dual=False`` the
    right range then copied back from ``scratch`` into ``work``); an int32
    histogram with ``quant``; with ``hist=False`` the histogram's segment
    (start, count, which) as an int32 tensor in its place."""
    _kernels.PLAIN_CALLS["fused_split"] += 1
    n_rows = work.shape[0]
    s = min(max(int(start), 0), n_rows)
    c = min(max(int(count), 0), n_rows - s)
    nl = min(max(int(n_left), 0), c)
    sd = dual and side is not None and int(side) != 0
    src, dst = (scratch, work) if sd else (work, scratch)
    dev = work.device

    def out(start_, count_, which):
        if not hist:
            return work, scratch, torch.tensor(
                [start_, count_, int(which)], dtype=torch.int32, device=dev)
        return work, scratch, segment_histogram(
            scratch if which else work, start_, count_, layout, num_bins,
            quant, det=det)

    if mode == 1:
        return out(s, c, sd)
    f = min(max(int(feature), 0), layout.num_features - 1)
    bits = (cat_bitset if cat_bitset is not None
            else torch.zeros(1, dtype=torch.int32, device=work.device))
    mv = layout.moved_cols
    seg = src[s:s + c, :mv]
    gl = go_left_pred(record_column(seg, f, layout), int(bin_),
                      bool(int(default_left)),
                      int(nan_bin), bool(int(is_cat)), bits)
    left, right = seg[gl], seg[~gl]
    src[s:s + left.shape[0], :mv] = left
    # right rows past the segment's end (an n_left below the routing's
    # count) are dropped, as the kernel drops them
    right = right[:c - nl]
    dst[s + nl:s + nl + right.shape[0], :mv] = right
    if not dual:
        work[s + nl:s + c, :mv] = scratch[s + nl:s + c, :mv]
        dst = work
    if smaller_left is None:
        sl = nl <= c - nl
    else:
        sl = int(smaller_left) != 0
    if sl:
        return out(s, nl, sd)
    return out(s + nl, c - nl, sd if not dual else not sd)


def fused_split(work: torch.Tensor, scratch: torch.Tensor, mode: int,
                start, count, n_left, feature, bin_, default_left, nan_bin,
                is_cat, cat_bitset: Optional[torch.Tensor],
                layout: RowLayout, num_bins: int, smaller_left=None,
                side=None, dual: bool = True, quant: bool = False,
                hist: bool = True, det: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One split (mode 0) or one segment histogram (mode 1); ``dual``
    chooses dual residency or the copy-back variant, ``quant`` the int32
    histogram of integer codes, ``hist=False`` the partition alone, which
    returns the histogram's segment instead (module docstring).

    ``work``/``scratch``: ``[N, C]`` uint8 record arrays, updated in place.
    ``mode`` is a Python int; every other scalar may be a Python int or a
    one-element tensor on the arrays' device (the grower passes device
    tensors, so nothing is read back to the host). ``cat_bitset``: int32
    words of the categorical bitset (bit patterns), or None.
    Returns ``(work, scratch, hist [F, B, 4])``, f32 or (``quant``)
    int32. ``det``: the deterministic mode's ``[4]`` scales (f32 only)."""
    if mode not in (0, 1):
        raise ValueError(f"mode must be 0 or 1, got {mode!r}")
    if work.device.type == "cpu":
        return fused_split_plain(work, scratch, mode, start, count, n_left,
                                 feature, bin_, default_left, nan_bin, is_cat,
                                 cat_bitset, layout, num_bins, smaller_left,
                                 side, dual, quant, hist, det)
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
    vec = layout.moved_cols // 16
    tile = _tile_rows(layout)
    n_tiles = -(-work.shape[0] // tile)
    ws = torch.empty(16, dtype=torch.int32, device=dev)
    with _LOOKBACK_LOCK:
        ctl, flags = _lookback_state(dev, n_tiles)
        _kernels.launch("fused_split", "lgbt_fused_split", dev, mode,
                        1 if dual else 0,
                        work.data_ptr(), scratch.data_ptr(), work.shape[0],
                        work.shape[1], vec, tile, layout.num_features,
                        int(layout.packed4), sp.data_ptr(), bits.data_ptr(),
                        bits.numel(), ws.data_ptr(), flags.data_ptr(),
                        ctl.data_ptr(),
                        mode=_modes(quant and "quant",
                                    layout.packed4 and "packed4",
                                    not hist and "partition",
                                    hist and not quant and det is not None
                                    and "det"))
    # ws[3:6] = (start, count, which array) of the histogram's segment
    if not hist:
        return work, scratch, ws[3:6]
    return work, scratch, record_histogram(work, scratch, ws[3:6], layout,
                                           num_bins, quant, det)
