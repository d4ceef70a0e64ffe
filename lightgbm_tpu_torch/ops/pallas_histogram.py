"""Histogram kernel K1 for Hopper, with its wrappers and plain version.

Counterpart of ``lightgbm_tpu/ops/pallas_histogram.py``: the TPU kernel
``_hist_kernel`` (wrapper ``pallas_histogram``) becomes the CUDA kernel of
``csrc/histogram.cu`` — a scatter-add into a shared-memory privatised
histogram per block, in the pattern of LightGBM's
CUDAConstructHistogramDenseKernel. What bounds it on the H100 (bytes of bins
and channels, or shared-memory atomics) and what the design does about it is
in the source's header note.

Two wrappers launch the same kernel body:

* ``pallas_histogram`` — dense ``[N, F]`` bins against ``[N, K]`` f32
  channels (the standalone entry);
* ``record_histogram`` — a segment of the packed row records of
  ``ops/compact.py``, read in place through the record stride, with the
  segment (start, count, which array) in a device int32 vector. The fused
  split (``ops/fused_split.py``) runs it for the smaller child.

Modes: ``split`` and ``f32`` both accumulate in f32, at least as accurate as
the TPU's hi/lo-bf16 split; ``bf16`` rounds the channels to bf16 first, the
same function as on the TPU; ``int8`` (quantized gradients) is ROADMAP A15.
The TPU tiling arguments of the JAX wrapper (``row_block``, ``f_chunk``,
``mbatch``, ``interpret``) change nothing in its result and have no
counterpart here; the bins-on-sublanes layout is ROADMAP B3.

Each wrapper takes the plain PyTorch version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from .. import _kernels
from .compact import RowLayout, segment_histogram
from .histogram import _xla_histogram

_MODES = ("split", "f32", "bf16")


def _check_mode(mode: str, k: int) -> None:
    if mode == "int8":
        raise NotImplementedError(
            "pallas_histogram mode='int8' (quantized gradients) is not in "
            "the PyTorch port yet (ROADMAP A15)")
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    limit = 4 if mode == "split" else 8
    if not 1 <= k <= limit:
        raise ValueError(f"mode={mode!r} takes 1..{limit} channels, got {k}")


def pallas_histogram_plain(binned: torch.Tensor, channels: torch.Tensor,
                           num_bins: int, mode: str = "split"
                           ) -> torch.Tensor:
    """Plain PyTorch version of K1's dense mode."""
    _check_mode(mode, channels.shape[1])
    ch = channels.to(torch.float32)
    if mode == "bf16":
        ch = ch.to(torch.bfloat16).to(torch.float32)
    return _xla_histogram(binned, ch, num_bins)


def pallas_histogram(binned: torch.Tensor, channels: torch.Tensor,
                     num_bins: int, mode: str = "split") -> torch.Tensor:
    """``[F, B, K]`` f32 histogram of ``binned [N, F]`` (uint8) against
    ``channels [N, K]`` (f32; K <= 4 in ``split`` mode, <= 8 otherwise)."""
    _check_mode(mode, channels.shape[1])
    if binned.dim() != 2 or channels.dim() != 2 \
            or binned.shape[0] != channels.shape[0]:
        raise ValueError(f"binned [N, F] and channels [N, K] must share N: "
                         f"{tuple(binned.shape)} vs {tuple(channels.shape)}")
    if binned.device != channels.device:
        raise ValueError("binned and channels must lie on one device")
    if binned.device.type == "cpu":
        return pallas_histogram_plain(binned, channels, num_bins, mode)
    if binned.device.type != "cuda":
        raise ValueError(f"no histogram kernel for {binned.device}")
    if binned.dtype != torch.uint8 or channels.dtype != torch.float32:
        raise TypeError("the histogram kernel takes uint8 bins and float32 "
                        f"channels, got {binned.dtype} / {channels.dtype}")
    if binned.stride(1) != 1 or not channels.is_contiguous():
        raise ValueError("the histogram kernel needs unit feature stride "
                         "bins and contiguous channels")
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins must be in 1..256, got {num_bins}")
    n, f = binned.shape
    k = channels.shape[1]
    out = torch.zeros((f, num_bins, k), dtype=torch.float32,
                      device=binned.device)
    _kernels.launch("histogram", "lgbt_hist_dense", binned.device,
                    binned.data_ptr(), binned.stride(0), channels.data_ptr(),
                    k, n, f, num_bins, 1 if mode == "bf16" else 0,
                    out.data_ptr())
    return out


def record_histogram_plain(work: torch.Tensor, scratch: torch.Tensor,
                           seg: torch.Tensor, layout: RowLayout,
                           num_bins: int) -> torch.Tensor:
    """Plain PyTorch version of K1's record mode, with the kernel's clamps
    of the segment."""
    start, count, which = (int(v) for v in seg.tolist()[:3])
    n_rows = work.shape[0]
    start = min(max(start, 0), n_rows)
    count = min(max(count, 0), n_rows - start)
    return segment_histogram(scratch if which else work, start, count,
                             layout, num_bins)


def record_histogram(work: torch.Tensor, scratch: torch.Tensor,
                     seg: torch.Tensor, layout: RowLayout,
                     num_bins: int) -> torch.Tensor:
    """``[F, B, 4]`` f32 histogram (grad, hess, in-bag, raw count) of rows
    ``[start, start+count)`` of ``work`` (which == 0) or ``scratch``, where
    ``seg`` = int32 ``(start, count, which)`` on the arrays' device. The
    segment is clamped to the arrays' rows (start in ``[0, N]``, count in
    ``[0, N - start]``), so a bad scalar never reads outside them."""
    if work.device.type == "cpu":
        return record_histogram_plain(work, scratch, seg, layout, num_bins)
    _check_records(work, scratch, layout)
    if seg.device != work.device or seg.dtype != torch.int32 \
            or seg.numel() < 3 or not seg.is_contiguous():
        raise ValueError("seg must be a contiguous int32 (start, count, "
                         "which) vector on the arrays' device")
    if not 1 <= num_bins <= 256:
        raise ValueError(f"num_bins must be in 1..256, got {num_bins}")
    f = layout.num_features
    out = torch.zeros((f, num_bins, 4), dtype=torch.float32,
                      device=work.device)
    _kernels.launch("histogram", "lgbt_hist_records", work.device,
                    work.data_ptr(), scratch.data_ptr(), work.shape[0],
                    work.stride(0), seg.data_ptr(), f, num_bins, layout.grad_off,
                    layout.hess_off, layout.cnt_off, out.data_ptr())
    return out


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
