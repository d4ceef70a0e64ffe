"""Binning on the device: raw float32 request rows to bins.

Counterpart of ``lightgbm_tpu/ops/device_bin.py`` (an XLA program there;
plain PyTorch tensor code here, on whatever device the state lives). A
serving request is one host-to-device copy of raw float32 rows, padded on
the host to its ladder rung, then binned here with the mappers' state,
stacked once when a model is deployed (``io/binning.py``
``export_featurize_state``; reference: LightGBM's single-row fast path,
``SingleRowPredictor``, src/c_api.cpp:117):

* numerical features: ``sum(value > bounds)``, the broadcast
  compare-and-sum that equals ``np.searchsorted(bounds, value, 'left')``,
  against round-down float32 thresholds, so float32 rows get exactly the
  bins of the host's ``bin_columns`` (``GBDT.bin_matrix``);
* NaN takes the feature's NaN bin (for MissingType Zero, the zero bin);
* categorical features: equality against the sorted code table; values not
  finite or outside int32 match nothing and take bin 0;
* rows past ``n_valid`` (the rung's padding) get bin 0 everywhere, as the
  host path's padding after binning does;
* ``packed``: nibble packing for a model that predicts on 4-bit bins
  (``pack4_device``, the layout of ``io/dataset.py`` ``pack4_matrix``).

Bins come out uint8, or for more than 256 bins as the int16 view of the
uint16 bins (``ops/packed.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

#: float32 values of at least 2^31 in magnitude cannot be categorical codes
_CAT_RANGE = 2.0 ** 31
#: elements of one [rows, features, bounds] compare of the numerical bins
_COMPARE_ELEMS = 1 << 25


class DeviceBinState(NamedTuple):
    """``io/binning.py`` ``FeaturizeState`` on a device."""
    bounds32: torch.Tensor   # [F, Kb] f32 round-down thresholds, +inf pad
    nan_bins: torch.Tensor   # [F] int64
    is_cat: torch.Tensor     # [F] bool
    cat_keys: torch.Tensor   # [F, Kc] int32, CAT_PAD padded
    cat_vals: torch.Tensor   # [F, Kc] int64, 0 padded


def device_bin_state(state, device) -> DeviceBinState:
    """Upload a host ``FeaturizeState`` once, when a model is deployed."""
    if state.reason is not None:
        raise ValueError(f"model is not device-featurizable: {state.reason}")

    def put(a, dtype=None):
        t = torch.from_numpy(a).to(device)
        return t if dtype is None else t.to(dtype)
    return DeviceBinState(put(state.bounds32), put(state.nan_bins,
                                                   torch.int64),
                          put(state.is_cat), put(state.cat_keys),
                          put(state.cat_vals, torch.int64))


def pack4_device(bins: torch.Tensor) -> torch.Tensor:
    """``[N, F]`` u8 bins below 16 -> ``[N, ceil(F/2)]`` u8: column ``2j``
    in the low nibble of byte ``j``, ``2j+1`` in the high one."""
    if bins.shape[1] % 2:
        bins = torch.nn.functional.pad(bins, (0, 1))
    return bins[:, 0::2] | (bins[:, 1::2] << 4)


def bin_rows_device(raw: torch.Tensor, state: DeviceBinState, n_valid: int,
                    wide: bool = False, packed: bool = False
                    ) -> torch.Tensor:
    """Bins of rung-padded raw rows ``[N, F]`` f32: ``[N, F]`` uint8 (the
    int16 view of uint16 bins with ``wide``; ``[N, ceil(F/2)]`` uint8 with
    ``packed``), equal to ``bin_columns(mappers, raw)`` on the host for
    float32 rows, the rows from ``n_valid`` on all 0."""
    n, f = raw.shape
    bins = torch.empty((n, f), dtype=torch.int64, device=raw.device)
    kb = state.bounds32.shape[1]
    kc = state.cat_keys.shape[1]
    step = max(1, _COMPARE_ELEMS // max(f * max(kb, kc), 1))
    for r0 in range(0, n, step):
        x = raw[r0:r0 + step]
        num = (x[:, :, None] > state.bounds32[None]).sum(dim=2)
        num = torch.where(torch.isnan(x), state.nan_bins[None, :], num)
        in_range = torch.isfinite(x) & (x.abs() < _CAT_RANGE)
        iv = torch.where(in_range, x, 0.0).to(torch.int32)
        hit = (state.cat_keys[None] == iv[:, :, None]) & in_range[:, :, None]
        cat = torch.where(hit, state.cat_vals[None], 0).sum(dim=2)
        bins[r0:r0 + step] = torch.where(state.is_cat[None, :], cat, num)
    live = torch.arange(n, device=raw.device) < n_valid
    bins = torch.where(live[:, None], bins, 0)
    if wide:
        return torch.where(bins >= 32768, bins - 65536, bins).to(torch.int16)
    bins = bins.to(torch.uint8)
    return pack4_device(bins) if packed else bins
