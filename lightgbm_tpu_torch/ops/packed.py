"""Helpers for the bin matrix's device forms: 4-bit packed and 16-bit.

Counterpart of ``lightgbm_tpu/ops/packed.py``. Features with at most 16
bins store two bins a byte (``io/dataset.py`` ``pack4_matrix``): column
``2j`` in the low nibble of packed column ``j``, ``2j+1`` in the high one
(reference: LightGBM's 4-bit dense bin store, src/io/dense_bin.hpp
``DenseBin<true>``, the same nibble order). Consumers unpack at their read
site, so the full-width matrix never lies on the device.

A bin matrix of more than 256 bins is ``uint16`` on the host, equal to the
JAX package's. PyTorch's ``uint16`` lacks arithmetic and ``gather``, so on
the device it is a ``torch.int16`` view of the same bytes
(``bins_to_device``): the kernels read ``uint16_t``, and PyTorch code
widens it with ``bin_values`` (``& 0xFFFF``: bins from 32,768 up are
negative as int16).
"""
from __future__ import annotations

import numpy as np
import torch


def bins_to_device(binned: np.ndarray, device) -> torch.Tensor:
    """A host bin matrix on ``device``: uint8 as it is, uint16 as an int16
    view of the same bytes."""
    binned = np.ascontiguousarray(binned)
    if binned.dtype == np.uint16:
        binned = binned.view(np.int16)
    elif binned.dtype != np.uint8:
        raise TypeError(f"bin matrices are uint8 or uint16, got "
                        f"{binned.dtype}")
    return torch.from_numpy(binned).to(device)


def bin_values(bins: torch.Tensor) -> torch.Tensor:
    """Bins as int64 values (an int16 view of uint16 bins widened with
    ``& 0xFFFF``)."""
    out = bins.to(torch.int64)
    return out & 0xFFFF if bins.dtype == torch.int16 else out


def unpack4(packed: torch.Tensor, num_features: int) -> torch.Tensor:
    """``[..., ceil(F/2)]`` u8 nibble-packed -> ``[..., F]`` u8."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    full = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1],
                                                  2 * packed.shape[-1])
    return full[..., :num_features]


def gather_bin(binned: torch.Tensor, rows: torch.Tensor, col: torch.Tensor,
               packed: bool) -> torch.Tensor:
    """``binned[rows, col]`` as int64 (16-bit bins widened); with
    ``packed`` the byte at column ``col >> 1`` and its nibble ``col & 1``:
    one gather either way."""
    if packed:
        byte = binned[rows, col >> 1].to(torch.int64)
        return (byte >> ((col & 1) * 4)) & 0xF
    return bin_values(binned[rows, col])
