"""Carry a JAX-package model or dataset into the port, as numpy arrays.

The functions here take plain numpy arrays — the fields of the JAX
package's ``HostTree`` (``lightgbm_tpu/boosting/gbdt.py``), its bin mappers'
bounds, NaN bins, missing types and bin counts, and the init score — never
JAX objects, so the port keeps importing nothing of the JAX package. The
caller extracts the arrays (the tests do it from a trained JAX booster).

* ``booster_from_arrays`` builds a port ``Booster`` that predicts what the
  JAX model predicts;
* ``dataset_from_arrays`` builds a port ``BinnedDataset`` from a bin matrix
  and the same mapper arrays, so grower and kernel tests start from
  identical inputs.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .basic import Booster
from .boosting.gbdt import GBDT, HostTree
from .config import Config, resolve_device
from .io.binning import BinMapper
from .io.dataset import BinnedDataset, Metadata
from .objectives import create_objective

_TREE_FIELDS = ("split_feature", "split_bin", "default_left", "left_child",
                "right_child", "leaf_value", "leaf_depth")


def mappers_from_arrays(bin_upper_bounds: Sequence[np.ndarray],
                        nan_bins: Sequence[int],
                        missing_types: Sequence[int],
                        num_bins: Sequence[int]) -> List[BinMapper]:
    """Numerical ``BinMapper``s from their bounds, NaN bins, missing types
    and bin counts. The zero bin is recomputed from the bounds, as
    ``find_bin_numerical`` sets it, and each NaN bin must agree with it."""
    out = []
    for j, (ub, nb, mt, k) in enumerate(zip(bin_upper_bounds, nan_bins,
                                            missing_types, num_bins)):
        ub = np.asarray(ub, np.float64)
        k, mt = int(k), int(mt)
        if k <= 1:
            out.append(BinMapper(num_bins=1))
            continue
        m = BinMapper(num_bins=k, missing_type=mt, bin_upper_bounds=ub,
                      default_bin=int(np.searchsorted(ub[:-1], 0.0,
                                                      side="left")))
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
                        max_bin: int = 255) -> BinnedDataset:
    """A port ``BinnedDataset`` around an existing ``[N, F]`` uint8 bin
    matrix and its mappers' arrays."""
    binned = np.ascontiguousarray(binned, np.uint8)
    ds = BinnedDataset()
    ds.binned = binned
    ds.num_data, ds.num_total_features = binned.shape
    ds.feature_names = [f"Column_{i}" for i in range(binned.shape[1])]
    ds.mappers = mappers_from_arrays(bin_upper_bounds, nan_bins,
                                     missing_types, num_bins)
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
                        num_bins: Sequence[int], init_score: float = 0.0,
                        params: Optional[Dict[str, Any]] = None) -> Booster:
    """A prediction-only port ``Booster`` from trees given as dicts of the
    HostTree fields (``split_feature``, ``split_bin``, ``default_left``,
    ``left_child``, ``right_child``, ``leaf_value``, ``leaf_depth``,
    ``num_leaves``, ``num_nodes``, optional ``shrinkage``). ``init_score``
    is added to the first tree's leaves, as boost-from-average does."""
    params = dict(params or {})
    params.setdefault("objective", "binary")
    cfg = Config(params)
    cfg.check_supported()
    device = resolve_device(cfg)
    models = []
    for i, t in enumerate(trees):
        fields = {k: np.asarray(t[k]) for k in _TREE_FIELDS}
        fields["leaf_value"] = fields["leaf_value"].astype(np.float32)
        fields["default_left"] = fields["default_left"].astype(bool)
        if i == 0 and init_score:
            fields["leaf_value"] = fields["leaf_value"] + np.float32(
                init_score)
        fields["num_leaves"] = int(t["num_leaves"])
        fields["num_nodes"] = int(t["num_nodes"])
        models.append(HostTree(fields, float(t.get("shrinkage", 1.0))))
    mappers = mappers_from_arrays(bin_upper_bounds, nan_bins, missing_types,
                                  num_bins)
    gbdt = GBDT.for_prediction(cfg, models, mappers,
                               create_objective(cfg.objective, cfg), device)
    return Booster._from_gbdt(gbdt, params)
