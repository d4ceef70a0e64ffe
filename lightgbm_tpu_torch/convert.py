"""Carry a JAX-package model or dataset into the port, as numpy arrays.

The functions here take plain numpy arrays — the fields of the JAX
package's ``HostTree`` (``lightgbm_tpu/boosting/gbdt.py``; categorical
bitsets included), its bin mappers' bounds, NaN bins, missing types, bin
counts and categorical bin-to-category tables, and the init scores — never
JAX objects, so the port keeps importing nothing of the JAX package. The
caller extracts the arrays (the tests do it from a trained JAX booster). A
model of K classes comes as its tree list in the JAX package's order: K
trees an iteration, class by class.

* ``booster_from_arrays`` builds a port ``Booster`` that predicts what the
  JAX model predicts;
* ``dataset_from_arrays`` builds a port ``BinnedDataset`` from a bin matrix
  and the same mapper arrays (and, for an EFB-bundled matrix, the JAX
  package's bundle layout ``col_of``, ``offset_of``, ``num_column_bins``),
  so grower and kernel tests start from identical inputs.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .basic import Booster
from .boosting.gbdt import GBDT, HostTree
from .config import Config, resolve_device
from .io.binning import MISSING_NAN, BinMapper
from .io.dataset import BinnedDataset, Metadata, bin_dtype
from .io.efb import BundleInfo
from .objectives import create_objective

_TREE_FIELDS = ("split_feature", "split_bin", "default_left", "left_child",
                "right_child", "leaf_value", "leaf_depth")
# bin-to-category tables of the features, None for a numerical feature
CatTables = Optional[Sequence[Optional[np.ndarray]]]
# carried when given (model text and dump_model print them), else zeros
_STAT_FIELDS = ("split_gain", "leaf_weight", "leaf_count", "internal_value",
                "internal_weight", "internal_count")


def mappers_from_arrays(bin_upper_bounds: Sequence[np.ndarray],
                        nan_bins: Sequence[int],
                        missing_types: Sequence[int],
                        num_bins: Sequence[int],
                        value_ranges: Optional[Sequence[Sequence[float]]]
                        = None, bin_to_cats: CatTables = None
                        ) -> List[BinMapper]:
    """``BinMapper``s from their bounds, NaN bins, missing types and bin
    counts, and optionally each feature's ``(min, max)`` value (model text's
    ``feature_infos``) and, for a categorical feature, its bin-to-category
    table (``bin_to_cats[j]``; bin 0 is the missing bin). A numerical
    mapper's zero bin is recomputed from the bounds, as
    ``find_bin_numerical`` sets it, and each NaN bin must agree with it."""
    out = []
    if value_ranges is None:
        value_ranges = [(0.0, 0.0)] * len(num_bins)
    if bin_to_cats is None:
        bin_to_cats = [None] * len(num_bins)
    for j, (ub, nb, mt, k, (lo, hi), cats) in enumerate(zip(
            bin_upper_bounds, nan_bins, missing_types, num_bins,
            value_ranges, bin_to_cats)):
        ub = np.asarray(ub, np.float64)
        k, mt = int(k), int(mt)
        if cats is not None:
            cats = np.asarray(cats, np.int64)
            if len(cats) != max(k, 1) and k > 1:
                raise ValueError(f"feature {j}: {len(cats)} categories for "
                                 f"{k} bins")
            out.append(BinMapper(
                num_bins=k, is_categorical=True,
                missing_type=MISSING_NAN if k > 1 else 0,
                cat_to_bin={int(c): i for i, c in enumerate(cats) if i},
                bin_to_cat=cats))
            continue
        if k <= 1:
            out.append(BinMapper(num_bins=1))
            continue
        m = BinMapper(num_bins=k, missing_type=mt, bin_upper_bounds=ub,
                      default_bin=int(np.searchsorted(ub[:-1], 0.0,
                                                      side="left")),
                      min_value=float(lo), max_value=float(hi))
        if m.nan_bin != int(nb):
            raise ValueError(f"feature {j}: NaN bin {int(nb)} does not match "
                             f"its bounds and missing type {mt} "
                             f"(expected {m.nan_bin})")
        out.append(m)
    return out


def dataset_from_arrays(binned: np.ndarray,
                        bin_upper_bounds: Sequence[np.ndarray],
                        nan_bins: Sequence[int], missing_types: Sequence[int],
                        num_bins: Sequence[int], label: np.ndarray,
                        weight: Optional[np.ndarray] = None,
                        max_bin: int = 255,
                        bin_to_cats: CatTables = None,
                        col_of: Optional[np.ndarray] = None,
                        offset_of: Optional[np.ndarray] = None,
                        num_column_bins: Optional[np.ndarray] = None
                        ) -> BinnedDataset:
    """A port ``BinnedDataset`` around an existing bin matrix and its
    mappers' arrays: ``[N, F]``, or with an EFB layout (``col_of`` and
    ``offset_of`` a feature, ``num_column_bins`` a stored column, the JAX
    package's ``BundleInfo`` fields) the bundled ``[N, C]`` matrix; uint8,
    or uint16 past 256 bins (``max_bin`` > 255)."""
    binned = np.ascontiguousarray(binned, bin_dtype(max(max_bin + 1, 2)))
    ds = BinnedDataset()
    ds.binned = binned
    ds.num_data = binned.shape[0]
    ds.num_total_features = len(num_bins)
    if col_of is not None:
        offset_of = np.asarray(offset_of, np.int32)
        ds.bundle_info = BundleInfo(
            col_of=np.asarray(col_of, np.int32), offset_of=offset_of,
            num_column_bins=np.asarray(num_column_bins, np.int32),
            n_columns=len(num_column_bins),
            n_bundled=int((offset_of >= 0).sum()))
        if binned.shape[1] != ds.bundle_info.n_columns:
            raise ValueError(f"the bundled matrix has {binned.shape[1]} "
                             f"columns, the layout {len(num_column_bins)}")
    elif binned.shape[1] != ds.num_total_features:
        raise ValueError(f"the bin matrix has {binned.shape[1]} columns for "
                         f"{ds.num_total_features} features")
    ds.feature_names = [f"Column_{i}" for i in range(ds.num_total_features)]
    ds.mappers = mappers_from_arrays(bin_upper_bounds, nan_bins,
                                     missing_types, num_bins,
                                     bin_to_cats=bin_to_cats)
    ds.categorical_features = [j for j, m in enumerate(ds.mappers)
                               if m.is_categorical]
    ds.used_features = [j for j, m in enumerate(ds.mappers)
                        if not m.is_trivial]
    ds.max_num_bins = max(max_bin + 1, 2)
    ds.metadata = Metadata(ds.num_data)
    ds.metadata.set_label(label)
    ds.metadata.set_weight(weight)
    return ds


def booster_from_arrays(trees: Sequence[Dict[str, Any]],
                        bin_upper_bounds: Sequence[np.ndarray],
                        nan_bins: Sequence[int], missing_types: Sequence[int],
                        num_bins: Sequence[int], init_score=0.0,
                        params: Optional[Dict[str, Any]] = None,
                        value_ranges: Optional[Sequence[Sequence[float]]]
                        = None,
                        feature_names: Optional[Sequence[str]] = None,
                        bin_to_cats: CatTables = None) -> Booster:
    """A prediction-only port ``Booster`` from trees given as dicts of the
    HostTree fields (``split_feature``, ``split_bin``, ``default_left``,
    ``left_child``, ``right_child``, ``leaf_value``, ``leaf_depth``,
    ``num_leaves``, ``num_nodes``, optional ``shrinkage``, ``cat_bitset``
    (``[L-1, W]`` uint32 bin bitsets) and the node and leaf statistics
    ``split_gain``, ``leaf_weight``, ``leaf_count``, ``internal_value``,
    ``internal_weight``, ``internal_count``). ``init_score`` (one value, or
    one a class) is added to the first iteration's leaves, as
    boost-from-average does. ``value_ranges`` and ``feature_names`` are
    what model text prints of the features."""
    params = dict(params or {})
    params.setdefault("objective", "binary")
    cfg = Config(params)
    cfg.check_supported()
    device = resolve_device(cfg)
    objective = create_objective(cfg.objective, cfg)
    k_total = objective.num_model_per_iteration
    inits = np.broadcast_to(np.asarray(init_score, np.float64), (k_total,))
    models = []
    for i, t in enumerate(trees):
        fields = {k: np.asarray(t[k]) for k in _TREE_FIELDS}
        fields["leaf_value"] = fields["leaf_value"].astype(np.float32)
        fields["default_left"] = fields["default_left"].astype(bool)
        for k in _STAT_FIELDS:
            size = len(fields["leaf_value" if k.startswith("leaf")
                              else "split_feature"])
            fields[k] = np.asarray(t.get(k, np.zeros(size)), np.float32)
        if "cat_bitset" in t:
            fields["cat_bitset"] = np.asarray(t["cat_bitset"], np.uint32)
        if i < k_total and inits[i]:
            fields["leaf_value"] = fields["leaf_value"] + np.float32(
                inits[i])
        fields["num_leaves"] = int(t["num_leaves"])
        fields["num_nodes"] = int(t["num_nodes"])
        models.append(HostTree(fields, float(t.get("shrinkage", 1.0))))
    mappers = mappers_from_arrays(bin_upper_bounds, nan_bins, missing_types,
                                  num_bins, value_ranges, bin_to_cats)
    gbdt = GBDT.for_prediction(cfg, models, mappers, objective, device,
                               feature_names)
    return Booster._from_gbdt(gbdt, params)
