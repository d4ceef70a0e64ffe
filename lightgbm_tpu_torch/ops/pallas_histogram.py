"""Histogram kernels K1 and K3 for Hopper, with their wrappers and plain
versions.

Counterpart of ``lightgbm_tpu/ops/pallas_histogram.py``:

* the TPU kernel ``_hist_kernel`` (wrapper ``pallas_histogram``, bins along
  lanes) becomes K1, ``csrc/histogram.cu`` — a scatter-add into a
  shared-memory privatised histogram per block, in the pattern of
  LightGBM's CUDAConstructHistogramDenseKernel;
* the TPU kernel ``_hist_kernel_sublane`` (``pallas_histogram(...,
  hist_layout="sublane")``, B <= 64, bins feature-major) becomes K3,
  ``csrc/histogram_sublane.cu`` — the same sum over feature-major bins,
  staged a warp tile at a time through shared memory, features rotated
  across the lanes of a warp, into a private histogram copy a warp; rows
  with all-zero channels skipped, sparse tiles compacted; small inputs
  take a lighter path with one shared histogram a block. Its launch
  geometry is computed here (``sublane_geometry``);
  ``tests/test_torch_histogram_sublane.py`` replays the kernel's mapping of
  (block, warp, lane, step) to (row, feature) in numpy.

What bounds each on the H100 and what its design does about it is in the
source's header note.

The wrappers:

* ``pallas_histogram`` — dense ``[N, F]`` bins against ``[N, K]`` f32
  channels (the standalone entry); ``hist_layout="sublane"`` transposes the
  bins, as the JAX wrapper does, and runs K3; ``pallas_histogram_narrow``,
  the narrowed mode of its integer variant. 16-bit bins (more than 256:
  ``max_bin`` > 255, the masked grower's data), which lie on the device as
  an int16 view of the uint16 matrix (``ops/packed.py``), run K1's
  wide-bin kernel (``lgbt_hist_dense_u16``, B up to 65,536, f32 modes;
  ``MODE_LAUNCHES["histogram/u16"]``): the TPU kernel sums bins of any
  integer type at any B (``lightgbm_tpu/ops/pallas_histogram.py:97``);
* ``pallas_histogram_sublane`` — K3 on bins already feature-major
  (``[F, N]``), the masked grower's entry: it makes that copy once per
  training instead of once a split;
* ``record_histogram`` — K1 on a segment of the packed row records of
  ``ops/compact.py``, read in place through the record stride, with the
  segment (start, count, which array) in a device int32 vector. The fused
  split (``ops/fused_split.py``) runs it for the smaller child. With
  ``quant=True`` the grad and hess columns hold the quantized-gradient
  codes and K1's integer variant sums them into an exact int32 histogram
  (the TPU kernels' int8 x int8 -> int32 contraction); ``layout.packed4``
  records are unpacked as they load;
* ``segment_gather`` and ``unfused_histogram`` — the compact grower's
  histogram without the fused kernel (below).

Modes of the dense and sublane entries: ``split`` and ``f32`` both
accumulate in f32, at least as accurate as the TPU's hi/lo-bf16 split;
``bf16`` rounds the channels to bf16 first, the same function as on the
TPU; ``int8`` takes integer channels (the quantized-gradient codes, int8 or
int32) and returns an exact int32 histogram, with integer shared-memory
atomics (K1's dense integer variant ``lgbt_hist_dense_int``, K3's int32
accumulator). ``pallas_histogram_narrow`` is K1 narrowed, the JAX
package's 16-bit quantized engine (``_xla_histogram_narrow``, XLA there):
(grad, hess) codes and (in-bag, raw) counts packed as two 32-bit words,
one shared-memory atomic a pair, flushed before a 16-bit half can carry;
the same int32 result. The TPU tiling arguments of the JAX wrapper
(``row_block``, ``f_chunk``, ``mbatch``, ``interpret``) change nothing in
its result and have no counterpart here.

``unfused_histogram`` is the compact grower's histogram without the fused
kernel (``tpu_fused=off``): the segment of the records that K2's partition
left in a device int32 vector, with no read back to the host. One launch
of ``csrc/segment_gather.cu`` (``segment_gather``) copies the segment's
channels out of the records (``record_channels``, a plain elementwise pass
in the JAX package) and, for K3, its bins feature-major; then K1 dense
reads the bins in place through the record stride (nibbles unpacked at the
load), or K3 reads the copy, each bounded by the count on the device. In
the narrowed mode K1 picks the 16-bit or the 32-bit engine from that count
(``ops/renew.py`` ``hist_bits_in_leaf``) and adds one to a caller's device
tally when it takes the 16-bit one.

The deterministic mode (``det``: float64 fixed-point scales ``[K]`` on the
tensors' device, one a channel, ``ops/determinism.py``) of every f32 entry
here: K1's record mode (``lgbt_hist_records_det``), dense mode
(``lgbt_hist_dense_det``) and wide-bin kernel (``lgbt_hist_dense_u16_det``)
and K3 on both paths (``lgbt_hist_sublane_det``) add in int64 fixed point,
a result fixed by the inputs (``MODE_LAUNCHES["*/det"]``); the plain
version is ``fixed_point_histogram``. The integer modes are exact already
and ignore ``det``.

Each wrapper takes the plain PyTorch version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _kernels
from .compact import (RowLayout, record_bins, record_channels,
                      segment_histogram)
from .histogram import (_xla_histogram, _xla_histogram_narrow,
                        fixed_point_histogram)
from .renew import hist_bits_in_leaf

_MODES = ("split", "f32", "bf16", "int8")
# the sublane layout's bin limit (reference: pallas_histogram.py:157)
SUBLANE_MAX_BINS = 64


def _check_mode(mode: str, k: int) -> None:
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    limit = 4 if mode == "split" else 8
    if not 1 <= k <= limit:
        raise ValueError(f"mode={mode!r} takes 1..{limit} channels, got {k}")


def _mode_channels(channels: torch.Tensor, mode: str) -> torch.Tensor:
    if mode == "int8":
        # the JAX wrapper's check and cast (pallas_histogram.py:277-281)
        if channels.is_floating_point():
            raise ValueError("mode='int8' needs integer channels (grad/hess "
                             "codes from the gradient discretizer), got "
                             f"{channels.dtype}")
        return channels.to(torch.int8).to(torch.int32)
    ch = channels.to(torch.float32)
    if mode == "bf16":
        ch = ch.to(torch.bfloat16).to(torch.float32)
    return ch


def _check_det(det: Optional[torch.Tensor], k: int,
               dev: torch.device) -> None:
    if det is None:
        return
    if det.dtype != torch.float64 or det.dim() != 1 or det.numel() < k \
            or det.device != dev or not det.is_contiguous():
        raise ValueError(f"det must be a contiguous float64 vector of at "
                         f"least {k} fixed-point scales on {dev}")


def pallas_histogram_plain(binned: torch.Tensor, channels: torch.Tensor,
                           num_bins: int, mode: str = "split",
                           det: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of K1's dense mode (``int8``: the exact int32
    histogram of integer channels; ``det``: the fixed-point sum)."""
    _check_mode(mode, channels.shape[1])
    ch = _mode_channels(channels, mode)
    if det is not None and mode != "int8":
        return fixed_point_histogram(binned, ch, num_bins,
                                     det[:ch.shape[1]])
    return _xla_histogram(binned, ch, num_bins)


def _check_sublane_bins(num_bins: int) -> None:
    if not 1 <= num_bins <= SUBLANE_MAX_BINS:
        raise ValueError(
            f"hist_layout=sublane supports num_bins <= {SUBLANE_MAX_BINS} "
            f"(got {num_bins})")


def pallas_histogram_sublane_plain(binned_t: torch.Tensor,
                                   channels: torch.Tensor, num_bins: int,
                                   mode: str = "split",
                                   det: Optional[torch.Tensor] = None
                                   ) -> torch.Tensor:
    """Plain PyTorch version of K3: the plain histogram of ``binned_t.T``
    (``int8``: exact int32; ``det``: the fixed-point sum)."""
    _check_mode(mode, channels.shape[1])
    _check_sublane_bins(num_bins)
    ch = _mode_channels(channels, mode)
    if det is not None and mode != "int8":
        return fixed_point_histogram(binned_t.T, ch, num_bins,
                                     det[:ch.shape[1]],
                                     kernel="histogram_sublane")
    return _xla_histogram(binned_t.T, ch, num_bins,
                          kernel="histogram_sublane")


# K3's launch geometry on the H100 (NVIDIA's figures: 228 KB of shared
# memory an SM, 227 KB a block, 1 KB of it reserved a block, 2,048 threads)
SUBLANE_COLUMNS = 32          # histogram columns a copy: one per bank
SUBLANE_ROWS_PER_LANE = 4     # a lane's bins of a feature: one 32-bit word
SUBLANE_STAGE_ROW = 128       # bytes of a feature in a warp's stage
SUBLANE_MAX_WARPS = 8
# at most this many rows take the small-data path, whose fixed costs a
# launch are lower (chip_smoke.py's K3_PATHS line, PERF.md)
SUBLANE_SMALL_ROWS = 262_144
SUBLANE_SMALL_TILE = 256      # small path: 8 rows a lane, 8 warps a block
SUBLANE_SMALL_BUDGET = 96 * 1024
SMEM_PER_SM = 233472          # 228 KB
SMEM_PER_BLOCK = 232448       # 227 KB, the most one block may take
SMEM_RESERVED_PER_BLOCK = 1024
THREADS_PER_SM = 2048


class SublaneGeometry(NamedTuple):
    """K3's launch, computed here and passed to the kernel: ``fc``
    features a chunk (grid.y = ``chunks``), ``warps`` warps a block, work
    items of ``group`` rotation steps (small path: features), ``grid_x``
    blocks a chunk, ``blocks_per_sm`` blocks that fit an SM. ``smem`` bytes
    of shared memory a block: on the tile path ``warps`` private histogram
    copies, then ``warps`` areas of ``warp_bytes`` (a warp's stage, pending
    tile and pending rows' channels); on the small-data path (``small``,
    8 warps) one histogram a block, and ``warp_bytes`` is 0."""
    fc: int
    chunks: int
    warps: int
    group: int
    grid_x: int
    smem: int
    warp_bytes: int
    blocks_per_sm: int
    small: bool


def sublane_active_lanes(fcc: int) -> int:
    """Active lanes of a warp on a chunk of ``fcc`` features: whole
    replicas of the chunk (32 // fcc of them), rounded down to a multiple
    of 4; a lane owns 4 rows of a tile."""
    return min(SUBLANE_COLUMNS // fcc * fcc, 32) & ~3


@functools.lru_cache(maxsize=256)
def sublane_geometry(n: int, num_features: int, num_bins: int, k: int,
                     num_sms: int, det: bool = False) -> SublaneGeometry:
    """K3's launch geometry for ``n`` rows, ``num_features`` features,
    ``num_bins`` (<= 64) bins and ``k`` channels on a card of ``num_sms``
    SMs: the small-data path up to SUBLANE_SMALL_ROWS rows, the tile path
    above. ``det``: the deterministic mode, whose small-path cells are
    8 bytes."""
    _check_sublane_bins(num_bins)
    if not 1 <= k <= 8:
        raise ValueError(f"K3 takes 1..8 channels, got {k}")
    if n <= SUBLANE_SMALL_ROWS:
        return sublane_small_geometry(n, num_features, num_bins, k, num_sms,
                                      8 if det else 4)
    return sublane_tile_geometry(n, num_features, num_bins, k, num_sms)


def sublane_tile_geometry(n: int, num_features: int, num_bins: int, k: int,
                          num_sms: int) -> SublaneGeometry:
    """The tile path: chunks of at most 32 features, a private histogram
    copy ([B][K][32] f32) a warp, and as many warps a block as fit its
    shared memory (7 at B = 64, K = 3, F <= 32)."""
    nf = -(-num_features // SUBLANE_COLUMNS)
    fc = -(-num_features // nf)
    widths = [min(fc, num_features - y * fc) for y in range(nf)]
    # a warp's stage and pending tile ([fc][128 B] each), and 4 rows of K
    # f32 channels for each of the most active lanes over the chunks
    warp_bytes = (2 * fc * SUBLANE_STAGE_ROW
                  + 16 * k * max(sublane_active_lanes(x) for x in widths))
    per_warp = num_bins * k * SUBLANE_COLUMNS * 4 + warp_bytes
    w = max(1, min(SUBLANE_MAX_WARPS, SMEM_PER_BLOCK // per_warp))
    smem = w * per_warp
    per_sm = max(1, min(SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK),
                        THREADS_PER_SM // (32 * w)))
    # the narrowest active lane count over the chunks gives the most tiles
    lanes = min(sublane_active_lanes(x) for x in widths)
    tiles = -(-max(n, 1) // (SUBLANE_ROWS_PER_LANE * lanes))
    blocks = max(1, num_sms * per_sm // nf)
    # fewer rotation steps an item when the tiles alone leave warp slots
    # of the card idle
    group = min(fc, max(1, -(-tiles * fc // (blocks * w))))
    items = tiles * -(-fc // group)
    grid_x = max(1, min(-(-items // w), blocks))
    return SublaneGeometry(fc, nf, w, group, grid_x, smem, warp_bytes,
                           per_sm, False)


def sublane_small_geometry(n: int, num_features: int, num_bins: int,
                           k: int, num_sms: int,
                           cell_bytes: int = 4) -> SublaneGeometry:
    """The small-data path: a block's histogram is [fc][B][K | 1] cells
    (f32 or int32; int64 in the deterministic mode: ``cell_bytes`` 8) in at
    most 96 KB, so that several blocks share an SM; an item covers fewer
    features when the tiles alone leave warp slots idle."""
    feature_bytes = num_bins * (k | 1) * cell_bytes
    fc = min(num_features, SUBLANE_SMALL_BUDGET // feature_bytes)
    chunks = -(-num_features // fc)
    smem = fc * feature_bytes
    per_sm = max(1, min(THREADS_PER_SM // 256,
                        SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK)))
    tiles = -(-max(n, 1) // SUBLANE_SMALL_TILE)
    group = min(fc, max(1, -(-tiles * fc // (num_sms * per_sm * 8))))
    items = tiles * -(-fc // group)
    grid_x = max(1, min(num_sms * per_sm // chunks, -(-items // 8)))
    return SublaneGeometry(fc, chunks, 8, group, grid_x, smem, 0, per_sm,
                           True)


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_sublane(binned_t: torch.Tensor, channels: torch.Tensor,
                    num_bins: int, mode: str, geom: SublaneGeometry,
                    count: Optional[torch.Tensor] = None,
                    det: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One K3 launch: f32, or (``mode="int8"``, int32 channels) int32.
    ``count``: a device int32 whose value (clamped to ``[0, N]``) bounds
    the rows read, the geometry being that of all N. ``det`` (f32 only):
    the deterministic mode's scales, the geometry made with ``det=True``."""
    f, n = binned_t.shape
    k = channels.shape[1]
    quant = mode == "int8"
    out = torch.zeros((f, num_bins, k),
                      dtype=torch.int32 if quant else torch.float32,
                      device=binned_t.device)
    if det is not None and not quant:
        _check_det(det, k, binned_t.device)
        acc = torch.zeros((f, num_bins, k), dtype=torch.int64,
                          device=binned_t.device)
        _kernels.launch("histogram_sublane", "lgbt_hist_sublane_det",
                        binned_t.device, binned_t.data_ptr(),
                        binned_t.stride(0), channels.data_ptr(), k, n, f,
                        num_bins, 1 if mode == "bf16" else 0, out.data_ptr(),
                        int(geom.small), geom.fc, geom.warps, geom.group,
                        geom.grid_x, geom.smem, geom.warp_bytes,
                        0 if count is None else count.data_ptr(),
                        det.data_ptr(), acc.data_ptr(), mode="det")
        return out
    _kernels.launch("histogram_sublane", "lgbt_hist_sublane",
                    binned_t.device, binned_t.data_ptr(), binned_t.stride(0),
                    channels.data_ptr(), k, n, f, num_bins,
                    1 if mode == "bf16" else 0, out.data_ptr(),
                    int(geom.small), geom.fc, geom.warps, geom.group,
                    geom.grid_x, geom.smem, geom.warp_bytes, int(quant),
                    0 if count is None else count.data_ptr(),
                    mode="int8" if quant else None)
    return out


def pallas_histogram_sublane(binned_t: torch.Tensor, channels: torch.Tensor,
                             num_bins: int, mode: str = "split",
                             det: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """``[F, B, K]`` f32 histogram of feature-major ``binned_t [F, N]``
    (uint8, unit stride along rows) against ``channels [N, K]`` (f32; K <= 4
    in ``split`` mode, <= 8 otherwise), B <= 64; bins >= B are dropped.
    ``int8``: integer channels (int8 or int32 codes), an exact int32
    histogram. ``det``: the deterministic mode's scales (module
    docstring)."""
    _check_mode(mode, channels.shape[1])
    _check_sublane_bins(num_bins)
    if binned_t.dim() != 2 or channels.dim() != 2 \
            or binned_t.shape[1] != channels.shape[0]:
        raise ValueError(f"binned_t [F, N] and channels [N, K] must share N: "
                         f"{tuple(binned_t.shape)} vs "
                         f"{tuple(channels.shape)}")
    if binned_t.device != channels.device:
        raise ValueError("binned_t and channels must lie on one device")
    if binned_t.device.type == "cpu":
        return pallas_histogram_sublane_plain(binned_t, channels, num_bins,
                                              mode, det)
    if binned_t.device.type != "cuda":
        raise ValueError(f"no histogram kernel for {binned_t.device}")
    if mode == "int8":
        channels = _mode_channels(channels, mode).contiguous()
    if binned_t.dtype != torch.uint8 or channels.dtype not in (
            torch.float32, torch.int32):
        raise TypeError("the sublane histogram kernel takes uint8 bins and "
                        f"float32 channels, got {binned_t.dtype} / "
                        f"{channels.dtype}")
    if binned_t.stride(1) != 1 or not channels.is_contiguous():
        raise ValueError("the sublane histogram kernel needs unit row stride "
                         "bins and contiguous channels")
    f, n = binned_t.shape
    index = binned_t.device.index
    det = None if mode == "int8" else det
    geom = sublane_geometry(n, f, num_bins, channels.shape[1], _num_sms(
        torch.cuda.current_device() if index is None else index),
        det is not None)
    return _launch_sublane(binned_t, channels, num_bins, mode, geom,
                           det=det)


def pallas_histogram(binned: torch.Tensor, channels: torch.Tensor,
                     num_bins: int, mode: str = "split",
                     hist_layout: str = "lane",
                     det: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[F, B, K]`` histogram of ``binned [N, F]`` (uint8, or the int16
    view of 16-bit bins, ``ops/packed.py``) against ``channels [N, K]``
    (f32; K <= 4 in ``split`` mode, <= 8 otherwise): f32, or with
    ``mode="int8"`` (int8 or int32 channels, uint8 bins) exact int32.
    16-bit bins (B up to 65,536) run K1's wide-bin kernel
    (``lgbt_hist_dense_u16``). ``hist_layout="sublane"`` (B <= 64) runs
    K3 on ``binned.T``. ``det``: the deterministic mode's scales (module
    docstring)."""
    if hist_layout == "sublane":
        _check_sublane_bins(num_bins)
        return pallas_histogram_sublane(binned.T.contiguous(), channels,
                                        num_bins, mode, det)
    if hist_layout != "lane":
        raise ValueError(f"hist_layout must be 'lane' or 'sublane', got "
                         f"{hist_layout!r}")
    _check_mode(mode, channels.shape[1])
    if binned.dim() != 2 or channels.dim() != 2 \
            or binned.shape[0] != channels.shape[0]:
        raise ValueError(f"binned [N, F] and channels [N, K] must share N: "
                         f"{tuple(binned.shape)} vs {tuple(channels.shape)}")
    if binned.device != channels.device:
        raise ValueError("binned and channels must lie on one device")
    if binned.device.type == "cpu":
        return pallas_histogram_plain(binned, channels, num_bins, mode, det)
    if binned.device.type != "cuda":
        raise ValueError(f"no histogram kernel for {binned.device}")
    if binned.dtype not in (torch.uint8, torch.int16):
        raise TypeError(f"the histogram kernel takes uint8 bins or the "
                        f"int16 view of 16-bit bins, got {binned.dtype}")
    if binned.stride(1) != 1 or not channels.is_contiguous():
        raise ValueError("the histogram kernel needs unit feature stride "
                         "bins and contiguous channels")
    n, f = binned.shape
    if binned.dtype == torch.int16:
        if mode == "int8" or channels.dtype != torch.float32:
            raise TypeError(f"16-bit bins take float32 channels in f32, "
                            f"split or bf16 mode, got mode={mode!r} and "
                            f"{channels.dtype}")
        return _dense_u16(binned, channels, num_bins, mode == "bf16", det)
    if mode == "int8":
        _mode_channels(channels[:0], mode)
        return _dense_int(binned, None, n, binned.stride(0), None, False,
                          channels.to(torch.int8), f, num_bins, 0, 0)
    if channels.dtype != torch.float32:
        raise TypeError(f"mode={mode!r} takes float32 channels, got "
                        f"{channels.dtype}")
    return _dense_f32(binned, None, n, binned.stride(0), None, False,
                      channels, f, num_bins, mode == "bf16", det)


def _dense_u16(bins: torch.Tensor, channels: torch.Tensor, num_bins: int,
               bf16: bool, det: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """One launch of K1's wide-bin kernel: ``bins [N, F]`` int16 (the view
    of uint16 bins) against f32 ``channels [N, K]``, B up to 65,536
    (``det``: its deterministic mode)."""
    if not 1 <= num_bins <= 65536:
        raise ValueError(f"num_bins must be in 1..65536, got {num_bins}")
    n, f = bins.shape
    k = channels.shape[1]
    out = torch.zeros((f, num_bins, k), dtype=torch.float32,
                      device=bins.device)
    if det is not None:
        _check_det(det, k, bins.device)
        acc = torch.zeros((f, num_bins, k), dtype=torch.int64,
                          device=bins.device)
        _kernels.launch("histogram", "lgbt_hist_dense_u16_det", bins.device,
                        bins.data_ptr(), n, bins.stride(0),
                        channels.data_ptr(), k, f, num_bins, int(bf16),
                        det.data_ptr(), acc.data_ptr(), out.data_ptr(),
                        mode=("u16", "det"))
        return out
    _kernels.launch("histogram", "lgbt_hist_dense_u16", bins.device,
                    bins.data_ptr(), n, bins.stride(0), channels.data_ptr(),
                    k, f, num_bins, int(bf16), out.data_ptr(), mode="u16")
    return out


def _check_bins(num_bins: int) -> None:
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins must be in 1..256, got {num_bins}")


def _dense_f32(bins, bins_b, n_rows, stride, seg, packed4, channels, f,
               num_bins, bf16, det=None) -> torch.Tensor:
    """One launch of K1 dense (f32): rows ``[0, n_rows)`` of ``bins``, or
    the segment ``seg`` (device int32 start, count, which array) of
    ``bins``/``bins_b`` with the channels' row r for the segment's row r
    (``det``: its deterministic mode)."""
    _check_bins(num_bins)
    k = channels.shape[1]
    out = torch.zeros((f, num_bins, k), dtype=torch.float32,
                      device=bins.device)
    if det is not None:
        _check_det(det, k, bins.device)
        acc = torch.zeros((f, num_bins, k), dtype=torch.int64,
                          device=bins.device)
        _kernels.launch("histogram", "lgbt_hist_dense_det", bins.device,
                        bins.data_ptr(),
                        0 if bins_b is None else bins_b.data_ptr(), n_rows,
                        stride, 0 if seg is None else seg.data_ptr(),
                        int(packed4), channels.data_ptr(), k, f, num_bins,
                        int(bf16), det.data_ptr(), acc.data_ptr(),
                        out.data_ptr(),
                        mode=_modes("det", packed4 and "packed4"))
        return out
    _kernels.launch("histogram", "lgbt_hist_dense", bins.device,
                    bins.data_ptr(),
                    0 if bins_b is None else bins_b.data_ptr(), n_rows,
                    stride, 0 if seg is None else seg.data_ptr(),
                    int(packed4), channels.data_ptr(), k, f, num_bins,
                    int(bf16), out.data_ptr())
    return out


def _dense_int(bins, bins_b, n_rows, stride, seg, packed4, channels, f,
               num_bins, quant_max, narrow, tally=None) -> torch.Tensor:
    """One launch of K1's dense integer variant: int8 or int32 codes into
    an exact int32 histogram; ``narrow`` 0 (32-bit cells), 1 (the narrowed
    16-bit engine) or 2 (narrowed where the segment's count x
    ``quant_max`` < 2^15, decided on the device, which adds one to
    ``tally`` when it narrows)."""
    _check_bins(num_bins)
    if channels.dtype not in (torch.int8, torch.int32):
        channels = channels.to(torch.int32)
    k = channels.shape[1]
    if narrow and (k != 4 or not 1 <= quant_max <= _NARROW_MAX):
        raise ValueError("the narrowed histogram takes the (grad, hess, "
                         "in-bag, raw) quad and 1 <= quant_max <= "
                         f"{_NARROW_MAX}, got K={k}, quant_max={quant_max}")
    out = torch.zeros((f, num_bins, k), dtype=torch.int32,
                      device=bins.device)
    modes = ("int8", "narrow") if narrow else ("int8",)
    _kernels.launch("histogram", "lgbt_hist_dense_int", bins.device,
                    bins.data_ptr(),
                    0 if bins_b is None else bins_b.data_ptr(), n_rows,
                    stride, 0 if seg is None else seg.data_ptr(),
                    int(packed4), channels.data_ptr(),
                    int(channels.dtype == torch.int8), k, f, num_bins,
                    quant_max, narrow, out.data_ptr(),
                    0 if tally is None else tally.data_ptr(), mode=modes)
    return out


# the narrowed K1's bound on |code|: a flush every 32,767 / quant_max rows
# of a block must leave at least one row a thread (1,024)
_NARROW_MAX = 31


def pallas_histogram_narrow_plain(binned: torch.Tensor,
                                  channels: torch.Tensor, num_bins: int,
                                  quant_max: int) -> torch.Tensor:
    """Plain PyTorch version of K1 narrowed: ``_xla_histogram_narrow``."""
    return _xla_histogram_narrow(binned, channels, num_bins, quant_max)


def pallas_histogram_narrow(binned: torch.Tensor, channels: torch.Tensor,
                            num_bins: int, quant_max: int) -> torch.Tensor:
    """The narrowed 16-bit quantized histogram ``[F, B, 4]`` int32 of
    ``binned [N, F]`` against the integer channel quad (grad, hess codes
    with ``|code| <= quant_max``, hess codes >= 0, in-bag, raw count):
    equal bit for bit to ``pallas_histogram(..., mode="int8")``."""
    if binned.device.type == "cpu":
        return pallas_histogram_narrow_plain(binned, channels, num_bins,
                                             quant_max)
    if binned.device.type != "cuda" or channels.device != binned.device:
        raise ValueError(f"no histogram kernel for {binned.device} / "
                         f"{channels.device}")
    if binned.dtype != torch.uint8 or binned.stride(1) != 1 \
            or not channels.is_contiguous():
        raise ValueError("the narrowed histogram kernel needs uint8 bins of "
                         "unit feature stride and contiguous channels")
    n, f = binned.shape
    return _dense_int(binned, None, n, binned.stride(0), None, False,
                      channels, f, num_bins, quant_max, 1)


def record_histogram_plain(work: torch.Tensor, scratch: torch.Tensor,
                           seg: torch.Tensor, layout: RowLayout,
                           num_bins: int, quant: bool = False,
                           det: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of K1's record mode (int32 with ``quant``;
    ``det``: the fixed-point sum), with the kernel's clamps of the
    segment."""
    start, count, which = (int(v) for v in seg.tolist()[:3])
    n_rows = work.shape[0]
    start = min(max(start, 0), n_rows)
    count = min(max(count, 0), n_rows - start)
    return segment_histogram(scratch if which else work, start, count,
                             layout, num_bins, quant, det=det)


def record_histogram(work: torch.Tensor, scratch: torch.Tensor,
                     seg: torch.Tensor, layout: RowLayout,
                     num_bins: int, quant: bool = False,
                     det: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[F, B, 4]`` histogram (grad, hess, in-bag, raw count) of rows
    ``[start, start+count)`` of ``work`` (which == 0) or ``scratch``, where
    ``seg`` = int32 ``(start, count, which)`` on the arrays' device. The
    segment is clamped to the arrays' rows (start in ``[0, N]``, count in
    ``[0, N - start]``), so a bad scalar never reads outside them. f32; with
    ``quant`` the grad and hess columns hold integer codes (|code| < 2^24)
    and every channel is an exact int32 sum (K1's integer variant): the
    caller keeps ``rows x max |code|`` below 2^31. ``layout.packed4``: the
    kernel unpacks two features a byte as it loads a record. ``det``
    (f32 only): the deterministic mode's ``[4]`` scales (grad and hess at 0 and 1; module
    docstring)."""
    if quant:
        det = None
    if work.device.type == "cpu":
        return record_histogram_plain(work, scratch, seg, layout, num_bins,
                                      quant, det)
    _check_records(work, scratch, layout)
    if seg.device != work.device or seg.dtype != torch.int32 \
            or seg.numel() < 3 or not seg.is_contiguous():
        raise ValueError("seg must be a contiguous int32 (start, count, "
                         "which) vector on the arrays' device")
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins must be in 1..256, got {num_bins}")
    f = layout.num_features
    out = torch.zeros((f, num_bins, 4),
                      dtype=torch.int32 if quant else torch.float32,
                      device=work.device)
    if det is not None:
        _check_det(det, 2, work.device)
        acc = torch.zeros((f, num_bins, 2), dtype=torch.int64,
                          device=work.device)
        _kernels.launch("histogram", "lgbt_hist_records_det", work.device,
                        work.data_ptr(), scratch.data_ptr(), work.shape[0],
                        work.stride(0), seg.data_ptr(), f, num_bins,
                        int(layout.packed4), layout.grad_off,
                        layout.hess_off, layout.cnt_off, det.data_ptr(),
                        acc.data_ptr(), out.data_ptr(),
                        mode=_modes("det", layout.packed4 and "packed4"))
        return out
    _kernels.launch("histogram",
                    "lgbt_hist_records_int" if quant else "lgbt_hist_records",
                    work.device, work.data_ptr(), scratch.data_ptr(),
                    work.shape[0], work.stride(0), seg.data_ptr(), f,
                    num_bins, int(layout.packed4), layout.grad_off,
                    layout.hess_off, layout.cnt_off, out.data_ptr(),
                    mode=_modes(quant and "quant", layout.packed4
                                and "packed4"))
    return out


def _modes(*names) -> Tuple[str, ...]:
    return tuple(m for m in names if m)


def _check_records(work: torch.Tensor, scratch: torch.Tensor,
                   layout: RowLayout) -> None:
    """The record kernels' input contract (shared with ops/fused_split.py)."""
    if work.device.type != "cuda":
        raise ValueError(f"no record kernel for {work.device}")
    if scratch.device != work.device:
        raise ValueError("work and scratch must lie on one device")
    for name, t in (("work", work), ("scratch", scratch)):
        if t.dtype != torch.uint8 or t.dim() != 2 or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous [N, C] uint8 "
                            "record matrix")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if work.shape != scratch.shape:
        raise ValueError("work and scratch must have one shape")
    if work.shape[1] != layout.num_cols or layout.num_cols % 128:
        raise ValueError(f"records are {work.shape[1]} bytes wide, the "
                         f"layout says {layout.num_cols} (a multiple of 128)")


# channel types of the segment gather (csrc/segment_gather.cu)
_GATHER_TYPES = {torch.float32: 0, torch.int8: 1, torch.int32: 2}


def segment_gather_plain(work: torch.Tensor, scratch: torch.Tensor,
                         seg: torch.Tensor, layout: RowLayout,
                         ch_dtype: torch.dtype, transposed: bool
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the segment gather: the segment's channels
    ``[N, 4]`` (rows ``[0, count)`` written, the rest zero; the quantized
    codes as ``ch_dtype`` integers) and, with ``transposed``, its bins
    feature-major ``[F, N]`` (nibbles unpacked), with the kernel's clamps
    of the segment."""
    _kernels.PLAIN_CALLS["segment_gather"] += 1
    start, count, which = (int(v) for v in seg.tolist()[:3])
    n = work.shape[0]
    start = min(max(start, 0), n)
    count = min(max(count, 0), n - start)
    rows = (scratch if which else work)[start:start + count]
    ch = torch.zeros((n, 4), dtype=ch_dtype, device=work.device)
    ch[:count] = record_channels(rows, layout,
                                 ch_dtype != torch.float32).to(ch_dtype)
    bins_t = None
    if transposed:
        bins_t = torch.zeros((layout.num_features, n), dtype=torch.uint8,
                             device=work.device)
        bins_t[:, :count] = record_bins(rows, layout).T
    return ch, bins_t


def segment_gather(work: torch.Tensor, scratch: torch.Tensor,
                   seg: torch.Tensor, layout: RowLayout,
                   ch_dtype: torch.dtype, transposed: bool
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The channels (grad, hess, in-bag indicator, 1; f32, or the codes as
    int8/int32) of the records' segment ``seg`` (device int32 start, count,
    which array) into rows ``[0, count)`` of an ``[N, 4]`` array, and with
    ``transposed`` its bins feature-major into columns ``[0, count)`` of an
    ``[F, N]`` array (rows 16-byte aligned): one launch of
    ``csrc/segment_gather.cu``, bounded by the count on the device. The rows
    past the count are not written on the card."""
    if work.device.type == "cpu":
        return segment_gather_plain(work, scratch, seg, layout, ch_dtype,
                                    transposed)
    _check_records(work, scratch, layout)
    n = work.shape[0]
    dev = work.device
    ch = torch.empty((n, 4), dtype=ch_dtype, device=dev)
    bins_t = None
    ld = 0
    if transposed:
        ld = -(-n // 16) * 16
        bins_t = torch.empty((layout.num_features, ld), dtype=torch.uint8,
                             device=dev)[:, :n]
    _kernels.launch("segment_gather", "lgbt_segment_gather", dev,
                    work.data_ptr(), scratch.data_ptr(), n, work.stride(0),
                    seg.data_ptr(), layout.num_features, int(layout.packed4),
                    layout.grad_off, layout.hess_off, layout.cnt_off,
                    _GATHER_TYPES[ch_dtype], ch.data_ptr(),
                    0 if bins_t is None else bins_t.data_ptr(), ld)
    return ch, bins_t


def unfused_histogram(work: torch.Tensor, scratch: torch.Tensor,
                      seg: torch.Tensor, layout: RowLayout, num_bins: int,
                      quant: bool = False, narrow_max: int = 0,
                      hist_layout: str = "lane",
                      tally: Optional[torch.Tensor] = None,
                      det: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[F, B, 4]`` histogram (grad, hess, in-bag, raw count) of the
    records' segment ``seg`` (device int32 start, count, which array), as
    the JAX package's compact grower builds it without the fused kernel
    (``segment_histogram``, ``lightgbm_tpu/ops/grower_compact.py:
    309-345``): f32, or int32 of the quantized codes (``quant``), and with
    ``narrow_max`` (the codes' bound, quant only) the per-leaf choice of
    the narrowed 16-bit engine (``hist_bits_in_leaf``). ``hist_layout``:
    K1 dense (``lane``) or K3 (``sublane``). ``tally``: a one-element int32
    tensor on the arrays' device that gains one when the 16-bit engine is
    taken. ``det`` (f32 only): the deterministic mode's ``[4]`` scales.
    The plain version reads the segment on the host; the card reads it on
    the device only."""
    if quant:
        det = None
    if work.device.type == "cpu":
        start, count, which = (int(v) for v in seg.tolist()[:3])
        bits = 32
        if quant and narrow_max:
            bits = int(hist_bits_in_leaf(count, narrow_max))
            if bits == 16 and tally is not None:
                tally += 1
        return segment_histogram(scratch if which else work, start, count,
                                 layout, num_bins, quant, bits, narrow_max,
                                 hist_layout, det)
    f = layout.num_features
    if hist_layout == "sublane":
        ch, bins_t = segment_gather(
            work, scratch, seg, layout,
            torch.int32 if quant else torch.float32, True)
        _check_sublane_bins(num_bins)
        index = work.device.index
        geom = sublane_geometry(bins_t.shape[1], f, num_bins, 4, _num_sms(
            torch.cuda.current_device() if index is None else index),
            det is not None)
        return _launch_sublane(bins_t, ch, num_bins,
                               "int8" if quant else "f32", geom,
                               count=seg[1:2], det=det)
    if hist_layout != "lane":
        raise ValueError(f"hist_layout must be 'lane' or 'sublane', got "
                         f"{hist_layout!r}")
    ch, _ = segment_gather(work, scratch, seg, layout,
                           torch.int8 if quant else torch.float32, False)
    n, stride = work.shape[0], work.stride(0)
    if quant:
        return _dense_int(work, scratch, n, stride, seg, layout.packed4, ch,
                          f, num_bins, narrow_max, 2 if narrow_max else 0,
                          tally)
    return _dense_f32(work, scratch, n, stride, seg, layout.packed4, ch, f,
                      num_bins, False, det)
