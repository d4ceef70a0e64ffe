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
histogram. ``fixed_point_histogram`` is the plain version of the kernels'
deterministic mode (``ops/determinism.py``): each addend rounded to an
int64 at the channel's power-of-two scale, summed exactly, converted back.
The histogram entries take that mode with ``det``, the scales.
``histogram_block`` dispatches on the layout, the channels' type and on
where the tensors lie: ``lane`` is K1 (bins ``[N, F]``; 16-bit bins, their
int16 view, take K1's wide-bin kernel), ``sublane`` is K3
(bins feature-major ``[F, N]``, B <= 64), in f32 or, for integer channels
(the quantized codes), their ``int8`` mode with an exact int32 result;
``acc_bits=16`` is the narrowed 16-bit quantized histogram (K1 narrowed;
``_xla_histogram_narrow`` its plain version, the JAX package's packing in
torch). Each is the plain version for CPU tensors. The data-parallel
reduction and feature-group overlap are ROADMAP A18.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _kernels
from .determinism import from_fixed, to_fixed
from .packed import bin_values


def _xla_histogram(binned: torch.Tensor, channels: torch.Tensor,
                   num_bins: int, kernel: str = "histogram") -> torch.Tensor:
    """Plain histogram ``[F, B, K]`` of ``binned [N, F]`` against
    ``channels [N, K]``: f32, or exact int32 for integer channels
    (reference: ``_xla_histogram``, ``lightgbm_tpu/ops/histogram.py:49``);
    bins >= ``num_bins`` are dropped. ``binned``: uint8, or the int16 view
    of 16-bit bins (``ops/packed.py``). ``kernel`` names the kernel this call
    stands in for (its ``PLAIN_CALLS`` count)."""
    _kernels.PLAIN_CALLS[kernel] += 1
    n, f = binned.shape
    k = channels.shape[1]
    b = num_bins
    dev = channels.device
    # one scatter over every feature into cells f * (B + 1) + bin (bins >= B
    # land in a column that is dropped); the positions run feature-major, so
    # each cell still adds its rows in row order
    idx = (torch.clamp(bin_values(binned), max=b)
           + torch.arange(f, device=dev) * (b + 1)).T.reshape(-1)
    dt = (torch.float32 if channels.is_floating_point()
          else torch.int64 if channels.dtype == torch.int64 else torch.int32)
    out = torch.zeros((k, f * (b + 1)), dtype=dt, device=dev)
    out.scatter_add_(1, idx.expand(k, -1), channels.to(dt).T.repeat(1, f))
    return out.view(k, f, b + 1).permute(1, 2, 0)[:, :b].contiguous()


def fixed_point_histogram(binned: torch.Tensor, channels: torch.Tensor,
                          num_bins: int, scale: torch.Tensor,
                          kernel: str = "histogram") -> torch.Tensor:
    """Plain version of the kernels' deterministic mode: the f32 histogram
    of ``channels [N, K]`` summed in int64 fixed point at the power-of-two
    ``scale [K]`` (float64), then converted to f32 (``ops/determinism.py``);
    exact in its integer sums, so the same in any order."""
    q = to_fixed(channels.to(torch.float32), scale.to(channels.device))
    return from_fixed(_xla_histogram(binned, q, num_bins, kernel),
                      scale.to(channels.device))


# the narrowed (16-bit) quantized accumulation's packing radix (reference:
# lightgbm_tpu/ops/histogram.py:110-127): two code sums share one f32
# channel exactly while a chunk's sums stay below the radix; R = 4096 and
# chunk sums <= 4095 keep the packed sum <= 2^24 - 1, exact in f32
_NARROW_RADIX = 4096
_NARROW_SHIFT = 12


def narrow_chunk_rows(quant_max: int) -> int:
    """The largest row chunk (a multiple of 128) whose packed-pair sums stay
    exact: ``chunk * quant_max <= 4095``; 0 when even 128 rows do not fit
    (the caller keeps 32 bits then)."""
    c = ((_NARROW_RADIX - 1) // max(1, quant_max)) // 128 * 128
    return c if c >= 128 else 0


def _xla_histogram_narrow(binned: torch.Tensor, channels: torch.Tensor,
                          num_bins: int, quant_max: int,
                          kernel: str = "histogram") -> torch.Tensor:
    """Plain version of the narrowed 16-bit quantized histogram (reference:
    ``_xla_histogram_narrow``, ``lightgbm_tpu/ops/histogram.py:129-197``):
    the (grad, hess) codes pack as ``qg * 4096 + qh`` and the (in-bag, raw)
    counts as ``inbag * 4096 + raw``, two f32 channels; each chunk of
    ``narrow_chunk_rows(quant_max)`` rows sums them exactly, unpacks with an
    arithmetic shift and a mask (exact for negative grad sums too) and adds
    into int32. Equal bit for bit to the 32-bit engine on codes with
    ``|code| <= quant_max`` and hess codes >= 0."""
    _kernels.PLAIN_CALLS[kernel] += 1
    n, f = binned.shape
    b = num_bins
    if channels.shape[1] != 4:
        raise ValueError(
            f"acc_bits=16 packs the (qgrad, qhess, inbag, raw) channel quad; "
            f"got {channels.shape[1]} channels")
    chunk = narrow_chunk_rows(quant_max)
    if not chunk:
        raise ValueError(
            f"acc_bits=16 needs quant_max <= {(_NARROW_RADIX - 1) // 128} "
            f"(got {quant_max}): a 128-row chunk's code sums must stay "
            "below the packing radix")
    dev = channels.device
    ch = channels.to(torch.float32)
    packed = torch.stack([ch[:, 0] * _NARROW_RADIX + ch[:, 1],
                          ch[:, 2] * _NARROW_RADIX + ch[:, 3]], dim=1)
    out = torch.zeros((f, b, 4), dtype=torch.int32, device=dev)
    cells = f * (b + 1)
    # whole chunks a scatter, at most 2^24 cells of partial sums
    group = max(1, (1 << 24) // cells) * chunk
    fidx = torch.arange(f, device=dev) * (b + 1)
    for r0 in range(0, n, group):
        rows = slice(r0, min(n, r0 + group))
        nr = rows.stop - r0
        cid = torch.arange(nr, device=dev) // chunk
        idx = (cid[:, None] * cells + fidx
               + torch.clamp(bin_values(binned[rows]), max=b))
        nc = -(-nr // chunk)
        part = torch.zeros((2, nc * cells), dtype=torch.float32, device=dev)
        part.scatter_add_(1, idx.reshape(1, -1).expand(2, -1),
                          packed[rows].T.repeat_interleave(f, dim=1))
        pi = part.view(2, nc, f, b + 1)[..., :b].to(torch.int32)
        hi = (pi >> _NARROW_SHIFT).sum(1, dtype=torch.int32)
        lo = (pi & (_NARROW_RADIX - 1)).sum(1, dtype=torch.int32)
        out += torch.stack([hi[0], lo[0], hi[1], lo[1]], dim=-1)
    return out


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
                    binned_t: Optional[torch.Tensor] = None,
                    acc_bits: int = 32, quant_max: int = 127,
                    det: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Histogram of one row block (reference: ``histogram_block``,
    ``lightgbm_tpu/ops/histogram.py:239-311``): f32 channels accumulate in
    f32, integer channels (quantized codes) in exact int32 (the kernels'
    ``int8`` mode), and with ``acc_bits=16`` in the narrowed engine (K1
    narrowed, ``|code| <= quant_max``). ``lane`` runs K1 on ``binned [N,
    F]``, ``sublane`` runs K3 (B <= 64) on the same bins feature-major,
    ``binned_t [F, N]`` when the caller keeps that copy (the masked grower
    makes it once per training), else ``binned.T`` made here. ``det``: the
    deterministic mode's fixed-point scales ``[K]`` (f32 channels only).
    CPU tensors take the plain versions."""
    from .pallas_histogram import (pallas_histogram, pallas_histogram_narrow,
                                   pallas_histogram_sublane)
    quantized = not channels.is_floating_point()
    mode = "int8" if quantized else "f32"
    if quantized and acc_bits == 16:
        return pallas_histogram_narrow(binned, channels, num_bins, quant_max)
    if quantized:
        det = None
    if layout == "sublane":
        bt = binned.T.contiguous() if binned_t is None else binned_t
        return pallas_histogram_sublane(bt, channels, num_bins, mode=mode,
                                        det=det)
    if layout != "lane":
        raise ValueError(f"layout must be 'lane' or 'sublane', got "
                         f"{layout!r}")
    if binned.device.type == "cpu" and det is None:
        return _xla_histogram(binned, channels, num_bins)
    return pallas_histogram(binned, channels, num_bins, mode=mode, det=det)


def histogram(binned: torch.Tensor, channels: torch.Tensor, num_bins: int,
              layout: str = "lane",
              binned_t: Optional[torch.Tensor] = None,
              det: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``[F, B, K]`` per-(feature, bin) sums of the ``channels`` columns
    (reference: ``histogram``, ``lightgbm_tpu/ops/histogram.py:330``), for
    the serial learner: one block over all rows. The reference's
    ``axis_name`` reduction and ``overlap`` groups are ROADMAP A18.
    ``det``: the deterministic mode's scales."""
    return histogram_block(binned, channels, num_bins, layout, binned_t,
                           det=det)
