"""Histogram construction.

Counterpart of ``lightgbm_tpu/ops/histogram.py`` (reference: LightGBM's
``Dataset::ConstructHistograms``, include/LightGBM/dataset.h:727, and the
CUDA kernels of cuda_histogram_constructor.cu):

    hist[f, b, k] = sum_r [binned[r, f] == b] * channels[r, k]

``_xla_histogram`` is the plain PyTorch version (one ``scatter_add_`` over
all features, f32 accumulation in row order; int32 for integer channels,
the quantized-gradient codes); it is the CPU path and the version the
Hopper histogram kernels of ``ops/pallas_histogram.py`` are held against.
``dequantize_hist`` is the one int32 -> f32 boundary of a quantized
histogram.
``histogram_block`` dispatches on the layout and on where the tensors lie:
``lane`` is K1 (bins ``[N, F]``), ``sublane`` is K3 (bins feature-major
``[F, N]``, B <= 64), each the plain version for CPU tensors. The narrowed
(16-bit) quantized histogram, the data-parallel reduction and feature-group
overlap are ROADMAP A15/A18.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels


def _xla_histogram(binned: torch.Tensor, channels: torch.Tensor,
                   num_bins: int, kernel: str = "histogram") -> torch.Tensor:
    """Plain histogram ``[F, B, K]`` of ``binned [N, F]`` against
    ``channels [N, K]``: f32, or exact int32 for integer channels
    (reference: ``_xla_histogram``, ``lightgbm_tpu/ops/histogram.py:49``);
    bins >= ``num_bins`` are dropped. ``kernel`` names the kernel this call
    stands in for (its ``PLAIN_CALLS`` count)."""
    _kernels.PLAIN_CALLS[kernel] += 1
    n, f = binned.shape
    k = channels.shape[1]
    b = num_bins
    dev = channels.device
    # one scatter over every feature into cells f * (B + 1) + bin (bins >= B
    # land in a column that is dropped); the positions run feature-major, so
    # each cell still adds its rows in row order
    idx = (torch.clamp(binned.to(torch.int64), max=b)
           + torch.arange(f, device=dev) * (b + 1)).T.reshape(-1)
    dt = torch.float32 if channels.is_floating_point() else torch.int32
    out = torch.zeros((k, f * (b + 1)), dtype=dt, device=dev)
    out.scatter_add_(1, idx.expand(k, -1), channels.to(dt).T.repeat(1, f))
    return out.view(k, f, b + 1).permute(1, 2, 0)[:, :b].contiguous()


def dequantize_hist(hist: torch.Tensor, g_scale, h_scale) -> torch.Tensor:
    """int32 quantized histogram ``[..., 4]`` -> f32 (reference:
    ``dequantize_hist``, ``lightgbm_tpu/ops/histogram.py:201-215``): the
    grad and hess code sums times the round's scales (0-d tensors), the
    count channels cast exactly."""
    h = hist.to(torch.float32)
    return torch.cat([h[..., 0:1] * g_scale, h[..., 1:2] * h_scale,
                      h[..., 2:]], dim=-1)


def histogram_block(binned: torch.Tensor, channels: torch.Tensor,
                    num_bins: int, layout: str = "lane",
                    binned_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Histogram of one row block (reference: ``histogram_block``,
    ``lightgbm_tpu/ops/histogram.py:239``), f32 accumulation: ``lane`` runs
    K1 on ``binned [N, F]``, ``sublane`` runs K3 (B <= 64) on the same bins
    feature-major, ``binned_t [F, N]`` when the caller keeps that copy (the
    masked grower makes it once per training), else ``binned.T`` made here.
    CPU tensors take the plain versions."""
    from .pallas_histogram import pallas_histogram, pallas_histogram_sublane
    if layout == "sublane":
        bt = binned.T.contiguous() if binned_t is None else binned_t
        return pallas_histogram_sublane(bt, channels, num_bins, mode="f32")
    if layout != "lane":
        raise ValueError(f"layout must be 'lane' or 'sublane', got "
                         f"{layout!r}")
    if binned.device.type == "cpu":
        return _xla_histogram(binned, channels, num_bins)
    return pallas_histogram(binned, channels, num_bins, mode="f32")


def histogram(binned: torch.Tensor, channels: torch.Tensor, num_bins: int,
              layout: str = "lane",
              binned_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[F, B, K]`` per-(feature, bin) sums of the ``channels`` columns
    (reference: ``histogram``, ``lightgbm_tpu/ops/histogram.py:330``), for
    the serial learner: one block over all rows. The reference's
    ``axis_name`` reduction and ``overlap`` groups are ROADMAP A18."""
    return histogram_block(binned, channels, num_bins, layout, binned_t)
