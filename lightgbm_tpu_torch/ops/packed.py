"""Helpers for the 4-bit packed bin matrix.

Counterpart of ``lightgbm_tpu/ops/packed.py``. Features with at most 16
bins store two bins a byte (``io/dataset.py`` ``pack4_matrix``): column
``2j`` in the low nibble of packed column ``j``, ``2j+1`` in the high one
(reference: LightGBM's 4-bit dense bin store, src/io/dense_bin.hpp
``DenseBin<true>``, the same nibble order). Consumers unpack at their read
site, so the full-width matrix never lies on the device.
"""
from __future__ import annotations

import torch


def unpack4(packed: torch.Tensor, num_features: int) -> torch.Tensor:
    """``[..., ceil(F/2)]`` u8 nibble-packed -> ``[..., F]`` u8."""
    lo = packed & 0x0F
    hi = (packed >> 4) & 0x0F
    full = torch.stack([lo, hi], dim=-1).reshape(*packed.shape[:-1],
                                                  2 * packed.shape[-1])
    return full[..., :num_features]


def gather_bin(binned: torch.Tensor, rows: torch.Tensor, col: torch.Tensor,
               packed: bool) -> torch.Tensor:
    """``binned[rows, col]`` as int64; with ``packed`` the byte at column
    ``col >> 1`` and its nibble ``col & 1``: one gather either way."""
    if packed:
        byte = binned[rows, col >> 1].to(torch.int64)
        return (byte >> ((col & 1) * 4)) & 0xF
    return binned[rows, col].to(torch.int64)
