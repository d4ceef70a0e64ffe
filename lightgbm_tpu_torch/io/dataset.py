"""Binned dataset construction for lightgbm_tpu_torch.

Counterpart of ``lightgbm_tpu/io/dataset.py`` for dense numerical matrices:
``Metadata`` (label, weight, init score) and ``BinnedDataset.construct``,
with the same row sampling, per-feature mapper fit and bin-matrix layout, so
the bin matrix is equal to the JAX package's (reference: LightGBM's
``Dataset`` / ``Metadata``, include/LightGBM/dataset.h:48,487).

Binning is numpy on the host. The matrix stays a host ``uint8`` array here;
the trainer copies it to the device once, into the packed row records of
``ops/compact.py``. Not here yet: EFB bundling (ROADMAP A13), nibble packing
(A15), sequence input and binary save/load (A16).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from ..utils import log
from .binning import BinMapper, bin_columns, find_bin_numerical


def _to_2d_float(data: Any) -> np.ndarray:
    """Input features as a 2-D float32/float64 numpy array (float32 stays
    float32: every bound comparison upcasts exactly)."""
    if hasattr(data, "tocsr") and hasattr(data, "toarray"):  # scipy.sparse
        arr = data.toarray()
    elif hasattr(data, "values") and hasattr(data, "columns"):  # pandas
        arr = data.values
    else:
        arr = data
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr.reshape(-1, 1)
    if arr.ndim != 2:
        raise ValueError(f"features must be 2-D, got shape {arr.shape}")
    if arr.dtype == np.float32:
        return arr
    return arr.astype(np.float64, copy=False)


class Metadata:
    """Label / weight / init-score container (reference: Metadata,
    include/LightGBM/dataset.h:48)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None

    def set_label(self, label: Any) -> None:
        arr = np.asarray(label, dtype=np.float32).reshape(-1)
        if len(arr) != self.num_data:
            raise ValueError(f"label length {len(arr)} != num_data {self.num_data}")
        self.label = arr

    def set_weight(self, weight: Any) -> None:
        if weight is None:
            self.weight = None
            return
        arr = np.asarray(weight, dtype=np.float32).reshape(-1)
        if len(arr) != self.num_data:
            raise ValueError(f"weight length {len(arr)} != num_data {self.num_data}")
        self.weight = arr

    def set_init_score(self, init_score: Any) -> None:
        if init_score is None:
            self.init_score = None
            return
        arr = np.asarray(init_score, dtype=np.float64).reshape(-1)
        if len(arr) != self.num_data:
            raise ValueError(f"init_score length {len(arr)} != num_data "
                             f"{self.num_data}")
        self.init_score = arr


class BinnedDataset:
    """The constructed (binned) dataset: dense ``[N, F]`` uint8 bin matrix,
    per-feature ``BinMapper``s and ``Metadata``."""

    def __init__(self):
        self.binned: Optional[np.ndarray] = None
        self.mappers: List[BinMapper] = []
        self.feature_names: List[str] = []
        self.metadata: Optional[Metadata] = None
        self.max_num_bins: int = 1                 # B: common padded bin count
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.used_features: List[int] = []         # non-trivial feature indices

    @staticmethod
    def construct(
        data: Any,
        *,
        max_bin: int = 255,
        min_data_in_bin: int = 3,
        bin_construct_sample_cnt: int = 200000,
        use_missing: bool = True,
        zero_as_missing: bool = False,
        feature_names: Optional[Sequence[str]] = None,
        data_random_seed: int = 1,
        reference: Optional["BinnedDataset"] = None,
        max_bin_by_feature: Optional[Sequence[int]] = None,
    ) -> "BinnedDataset":
        arr = _to_2d_float(data)
        n, f = arr.shape
        ds = BinnedDataset()
        ds.num_data = n
        ds.num_total_features = f
        if feature_names is not None:
            ds.feature_names = list(feature_names)
        elif hasattr(data, "columns"):
            ds.feature_names = [str(c) for c in data.columns]
        else:
            ds.feature_names = [f"Column_{i}" for i in range(f)]
        if len(ds.feature_names) != f:
            raise ValueError("feature_names length mismatch")
        if reference is not None:
            # valid set: the reference's bin mappers (Dataset::CreateValid)
            if f != reference.num_total_features:
                raise ValueError(
                    f"validation data has {f} features, training data had "
                    f"{reference.num_total_features}")
            ds.mappers = reference.mappers
            ds.max_num_bins = reference.max_num_bins
            ds.used_features = reference.used_features
        else:
            # row sample for bin construction (reference: bin_construct_sample_cnt)
            if n > bin_construct_sample_cnt:
                rng = np.random.RandomState(data_random_seed)
                idx = rng.choice(n, size=bin_construct_sample_cnt, replace=False)
                sample = arr[np.sort(idx)]
            else:
                sample = arr
            _fit_mappers(ds, sample, f, max_bin, min_data_in_bin, use_missing,
                         zero_as_missing, max_bin_by_feature)
        ds.binned = bin_columns(ds.mappers, arr, np.uint8)
        ds.metadata = Metadata(n)
        return ds

    @property
    def num_features(self) -> int:
        return self.num_total_features

    def feature_num_bins(self) -> np.ndarray:
        return np.array([m.num_bins for m in self.mappers], dtype=np.int32)

    def feature_nan_bins(self) -> np.ndarray:
        """Per feature: the bin NaN maps to (default-direction handling)."""
        return np.array([m.nan_bin if not m.is_trivial else 0
                         for m in self.mappers], dtype=np.int32)

    def feature_has_nan(self) -> np.ndarray:
        return np.array([m.missing_type == 2 for m in self.mappers], bool)


def _fit_mappers(ds, sample, f, max_bin, min_data_in_bin, use_missing,
                 zero_as_missing, max_bin_by_feature):
    """Fit per-feature BinMappers from a row sample."""
    total_sample_cnt = len(sample)
    if max_bin_by_feature is not None and len(max_bin_by_feature) != f:
        raise ValueError("max_bin_by_feature needs one entry per feature")
    ds.mappers = [
        find_bin_numerical(
            sample[:, j], total_sample_cnt,
            int(max_bin_by_feature[j]) if max_bin_by_feature is not None
            else max_bin,
            min_data_in_bin, use_missing=use_missing,
            zero_as_missing=zero_as_missing)
        for j in range(f)]
    ds.used_features = [j for j, m in enumerate(ds.mappers)
                        if not m.is_trivial]
    if not ds.used_features:
        log.warning("all features are constant; no informative splits "
                    "possible")
    # shape-stable bin axis: max_bin + 1 (the JAX package pads the same way)
    ds.max_num_bins = max(max_bin + 1, 2)
