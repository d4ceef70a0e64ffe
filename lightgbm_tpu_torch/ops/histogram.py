"""Histogram construction.

Counterpart of ``lightgbm_tpu/ops/histogram.py`` (reference: LightGBM's
``Dataset::ConstructHistograms``, include/LightGBM/dataset.h:727, and the
CUDA kernels of cuda_histogram_constructor.cu):

    hist[f, b, k] = sum_r [binned[r, f] == b] * channels[r, k]

``_xla_histogram`` is the plain PyTorch version (an ``index_add_`` per
feature, f32 accumulation); it is the CPU path and the version the Hopper
histogram kernel of ``ops/pallas_histogram.py`` is held against.
``histogram_block`` dispatches on where the tensors lie: the kernel for CUDA
tensors, the plain version for CPU tensors. The narrowed and quantized
histograms and feature-group overlap are ROADMAP A15/A18.
"""
from __future__ import annotations

import torch

from .. import _kernels


def _xla_histogram(binned: torch.Tensor, channels: torch.Tensor,
                   num_bins: int) -> torch.Tensor:
    """Plain histogram ``[F, B, K]`` f32 of ``binned [N, F]`` against
    ``channels [N, K]``; bins >= ``num_bins`` are dropped."""
    _kernels.PLAIN_CALLS["histogram"] += 1
    n, f = binned.shape
    k = channels.shape[1]
    b = num_bins
    out = torch.zeros((f, b + 1, k), dtype=torch.float32,
                      device=channels.device)
    ch = channels.to(torch.float32)
    for j in range(f):
        idx = torch.clamp(binned[:, j].to(torch.int64), max=b)
        out[j].index_add_(0, idx, ch)
    return out[:, :b].contiguous()


def histogram_block(binned: torch.Tensor, channels: torch.Tensor,
                    num_bins: int) -> torch.Tensor:
    """Histogram of one row block: the Hopper kernel for CUDA tensors
    (f32 accumulation), the plain version for CPU tensors."""
    if binned.device.type == "cpu":
        return _xla_histogram(binned, channels, num_bins)
    from .pallas_histogram import pallas_histogram
    return pallas_histogram(binned, channels, num_bins, mode="f32")
