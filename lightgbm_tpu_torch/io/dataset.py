"""Binned dataset construction for lightgbm_tpu_torch.

Counterpart of ``lightgbm_tpu/io/dataset.py`` for dense matrices:
``Metadata`` (label, weight, init score, query groups and positions) and ``BinnedDataset.construct``,
with the same row sampling, per-feature mapper fit (categorical features
named by index or by name) and bin-matrix layout, so the bin matrix is
equal to the JAX package's (reference: LightGBM's
``Dataset`` / ``Metadata``, include/LightGBM/dataset.h:48,487).

Binning is numpy on the host. The matrix stays a host array here: ``uint8``,
or ``uint16`` where the bin axis (``max_num_bins``) passes 256 (``bin_dtype``;
such data is never bundled); the trainer copies it to the device once.
With ``enable_bundle`` (the default, as in LightGBM),
Exclusive Feature Bundling (``io/efb.py``) is planned on the first 50,000
binned rows and applied to the whole matrix, which then holds
``bundle_info.n_columns`` stored columns (reference: ``io/dataset.py:
330-350`` of the JAX package); a validation set built with ``reference=``
takes the training set's bundle layout. Every per-feature array
(``feature_num_bins`` and the others) stays per original feature.
``pack4_matrix`` and its eligibility checks are the 4-bit bin store of
``tpu_bin_pack4`` (two bins a byte). ``construct_from_sequences`` builds
the same dataset from ``Sequence`` objects (random row reads for the bin
sample, then batched range reads) without the raw matrix.
``forcedbins_filename`` (a JSON list of ``{"feature": i,
"bin_upper_bound": [...]}``) forces bin bounds. ``save_binary`` and
``load_binary`` write and read the JAX package's binary dataset file (an
``.npz`` of the bins, the EFB layout, the metadata and the mappers as
JSON), so a file written by either package loads in the other.
"""
from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from ..utils import log
from .binning import (MISSING_NAN, BinMapper, bin_columns,
                      find_bin_categorical, find_bin_numerical)
from .efb import (BundleInfo, build_bundle_info, bundle_chunk, bundle_matrix,
                  conflict_allowance, plan_bundles)


def bin_dtype(max_num_bins: int):
    """The bin matrix's type: ``uint8`` up to 256 bins, else ``uint16``
    (reference: ``lightgbm_tpu/io/dataset.py:331``, ``:455``)."""
    return np.uint8 if max_num_bins <= 256 else np.uint16


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
    """Label / weight / init-score / query-group container (reference:
    Metadata, include/LightGBM/dataset.h:48)."""

    def __init__(self, num_data: int):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None
        self.group: Optional[np.ndarray] = None          # query sizes
        # cumulative query sizes with a leading 0: [num_queries + 1]
        self.query_boundaries: Optional[np.ndarray] = None
        self.position: Optional[np.ndarray] = None

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
        """One score a row, or K a row for K classes (class-major, as
        LightGBM stores them)."""
        if init_score is None:
            self.init_score = None
            return
        arr = np.asarray(init_score, dtype=np.float64)
        if arr.ndim == 2:
            arr = arr.T          # [N, K] -> class-major
        arr = arr.reshape(-1)
        if len(arr) == 0 or len(arr) % max(self.num_data, 1):
            raise ValueError(f"init_score length {len(arr)} is not a "
                             f"multiple of num_data {self.num_data}")
        self.init_score = arr

    def set_group(self, group: Any) -> None:
        """Query sizes, in row order; they must sum to ``num_data``."""
        if group is None:
            self.group = None
            self.query_boundaries = None
            return
        arr = np.asarray(group, dtype=np.int64).reshape(-1)
        if arr.sum() != self.num_data:
            raise ValueError(f"sum of group sizes ({arr.sum()}) != num_data "
                             f"({self.num_data})")
        self.group = arr
        self.query_boundaries = np.concatenate(
            [[0], np.cumsum(arr)]).astype(np.int64)

    def set_position(self, position: Any) -> None:
        """Each row's display position (lambdarank's position bias)."""
        if position is None:
            self.position = None
            return
        self.position = np.asarray(position, dtype=np.int64).reshape(-1)

    @property
    def num_queries(self) -> int:
        return 0 if self.group is None else len(self.group)


class BinnedDataset:
    """The constructed (binned) dataset: dense ``[N, F]`` bin matrix (uint8,
    or uint16 above 256 bins), per-feature ``BinMapper``s and
    ``Metadata``."""

    def __init__(self):
        self.binned: Optional[np.ndarray] = None
        self.mappers: List[BinMapper] = []
        self.feature_names: List[str] = []
        self.metadata: Optional[Metadata] = None
        self.max_num_bins: int = 1                 # B: common padded bin count
        self.num_data: int = 0
        self.num_total_features: int = 0
        self.used_features: List[int] = []         # non-trivial feature indices
        self.categorical_features: List[int] = []
        # EFB layout of the stored columns (None: one column a feature)
        self.bundle_info: Optional[BundleInfo] = None
        # the raw rows in float64, in the original order, kept for linear
        # leaves (construct's keep_raw)
        self.raw_data: Optional[np.ndarray] = None

    # -- the binary dataset file (reference: ``save_binary``/``load_binary``,
    # ``lightgbm_tpu/io/dataset.py:156-262``; LightGBM's
    # Dataset::SaveBinaryFile and DatasetLoader::LoadFromBinFile) ----------
    def save_binary(self, path: str) -> None:
        """Write the constructed dataset (bins, mappers, EFB layout and
        metadata) to ``path`` as it is named (no ``.npz`` appended). The
        mappers go as JSON, never a pickle: loading a dataset file must
        not run code. Non-finite numbers are written as strings, so the
        JSON stays strict."""
        def num(x):
            return float(x) if np.isfinite(x) else str(float(x))
        mappers = [{
            "num_bins": int(m.num_bins),
            "is_categorical": bool(m.is_categorical),
            "missing_type": int(m.missing_type),
            "bin_upper_bounds": [num(x) for x in m.bin_upper_bounds],
            "cat_to_bin": {str(k): int(v) for k, v in m.cat_to_bin.items()},
            "bin_to_cat": [int(x) for x in m.bin_to_cat],
            "default_bin": int(m.default_bin),
            "min_value": num(m.min_value), "max_value": num(m.max_value),
        } for m in self.mappers]
        md, info = self.metadata, self.bundle_info

        def opt(arr, dtype=np.float64):
            return arr if arr is not None else np.zeros(0, dtype)

        def layout(field):
            return (np.asarray(getattr(info, field), np.int64)
                    if info is not None else np.zeros(0, np.int64))
        with open(path, "wb") as fh:
            np.savez_compressed(
                fh, magic=np.frombuffer(b"lgbtpu.bin.v2\x00\x00\x00",
                                        np.uint8),
                binned=self.binned,
                feature_names=np.asarray(self.feature_names),
                max_num_bins=self.max_num_bins, num_data=self.num_data,
                num_total_features=self.num_total_features,
                used_features=np.asarray(self.used_features, np.int64),
                categorical_features=np.asarray(self.categorical_features,
                                                np.int64),
                bundle_col_of=layout("col_of"),
                bundle_offset_of=layout("offset_of"),
                bundle_col_bins=layout("num_column_bins"),
                mappers=np.frombuffer(json.dumps(
                    mappers, allow_nan=False).encode(), np.uint8),
                label=opt(md.label), weight=opt(md.weight),
                init_score=opt(md.init_score),
                group=opt(md.group, np.int64), position=opt(md.position))

    @staticmethod
    def load_binary(path: str) -> "BinnedDataset":
        """A dataset written by ``save_binary`` (or by the JAX package's)."""
        z = np.load(path, allow_pickle=False)
        if bytes(z["magic"].tobytes())[:13] != b"lgbtpu.bin.v2":
            raise ValueError(f"{path} is not a lightgbm_tpu binary dataset "
                             "(v2); write it again with save_binary()")
        ds = BinnedDataset()
        ds.binned = z["binned"]
        ds.feature_names = [str(x) for x in z["feature_names"]]
        ds.max_num_bins = int(z["max_num_bins"])
        ds.num_data = int(z["num_data"])
        ds.num_total_features = int(z["num_total_features"])
        ds.used_features = [int(i) for i in z["used_features"]]
        ds.categorical_features = [int(i)
                                   for i in z["categorical_features"]]
        if z["bundle_col_of"].size:
            off_of = z["bundle_offset_of"].astype(np.int32)
            ds.bundle_info = BundleInfo(
                col_of=z["bundle_col_of"].astype(np.int32), offset_of=off_of,
                num_column_bins=z["bundle_col_bins"].astype(np.int32),
                n_columns=int(z["bundle_col_bins"].size),
                n_bundled=int((off_of >= 0).sum()))
        for blob in json.loads(z["mappers"].tobytes().decode()):
            blob["bin_upper_bounds"] = np.asarray(
                [float(v) for v in blob["bin_upper_bounds"]], np.float64)
            blob["cat_to_bin"] = {int(k): int(v)
                                  for k, v in blob["cat_to_bin"].items()}
            blob["bin_to_cat"] = np.asarray(blob["bin_to_cat"], np.int64)
            blob["min_value"] = float(blob["min_value"])
            blob["max_value"] = float(blob["max_value"])
            ds.mappers.append(BinMapper(**blob))
        md = Metadata(ds.num_data)
        for name in ("label", "weight", "position"):
            if z[name].size:
                setattr(md, name, z[name])
        if z["init_score"].size:
            md.set_init_score(z["init_score"])
        if z["group"].size:
            md.set_group(z["group"])
        ds.metadata = md
        return ds

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
        categorical_feature: Optional[Sequence[Union[int, str]]] = None,
        enable_bundle: bool = True,
        max_conflict_rate: float = 1e-4,
        keep_raw: bool = False,
        forcedbins_filename: str = "",
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
            ds.categorical_features = reference.categorical_features
        else:
            cat_idx = _resolve_categorical(categorical_feature,
                                           ds.feature_names)
            ds.categorical_features = sorted(cat_idx)
            # row sample for bin construction (reference: bin_construct_sample_cnt)
            if n > bin_construct_sample_cnt:
                rng = np.random.RandomState(data_random_seed)
                idx = rng.choice(n, size=bin_construct_sample_cnt, replace=False)
                sample = arr[np.sort(idx)]
            else:
                sample = arr
            _fit_mappers(ds, sample, f, cat_idx, max_bin, min_data_in_bin,
                         use_missing, zero_as_missing, max_bin_by_feature,
                         forcedbins_filename)
        binned = bin_columns(ds.mappers, arr, bin_dtype(ds.max_num_bins))
        # Exclusive Feature Bundling (reference: FeatureGroup /
        # Dataset::Construct FindGroups, include/LightGBM/feature_group.h)
        if reference is not None:
            if reference.bundle_info is not None:
                binned = _apply_bundles(binned, reference.bundle_info, ds,
                                        max_conflict_rate)
        elif enable_bundle and ds.max_num_bins <= 256:
            info = _plan_efb(ds, binned[:min(n, 50_000)], max_bin,
                             max_conflict_rate)
            if info is not None:
                binned = _apply_bundles(binned, info, ds, max_conflict_rate)
                if ds.bundle_info is not None:
                    log.info(f"EFB: bundled {info.n_bundled} of {f} features "
                             f"into {info.n_columns} stored columns")
        ds.binned = binned
        ds.metadata = Metadata(n)
        if keep_raw:
            ds.raw_data = arr.astype(np.float64, copy=False)
        return ds

    @staticmethod
    def construct_from_sequences(
        seqs: List[Any],
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
        categorical_feature: Optional[Sequence[Union[int, str]]] = None,
        enable_bundle: bool = True,
        max_conflict_rate: float = 1e-4,
        forcedbins_filename: str = "",
    ) -> "BinnedDataset":
        """The dataset of the rows of ``seqs`` (objects with ``__len__``,
        ``__getitem__`` of a row index and of a row range, and an optional
        ``batch_size``), in order, without the raw ``[N, F]`` matrix: the
        bin sample is read row by row (or in batches where it takes a
        third of a sequence's rows), then every batch is binned (and
        bundled) into the matrix (reference: ``construct_from_sequences``,
        ``lightgbm_tpu/io/dataset.py:360-510``; LightGBM's ``Sequence``
        and ``Dataset::PushOneRow``). The same rows, sample and mappers as
        ``construct`` on the stacked matrix."""
        lens = [len(s) for s in seqs]
        n = int(sum(lens))
        if n == 0:
            raise ValueError("empty Sequence data")
        probe = next(s for s, m in zip(seqs, lens) if m > 0)
        f = np.asarray(probe[0], np.float64).reshape(-1).shape[0]
        ds = BinnedDataset()
        ds.num_data = n
        ds.num_total_features = f
        ds.feature_names = (list(feature_names) if feature_names is not None
                            else [f"Column_{j}" for j in range(f)])
        if len(ds.feature_names) != f:
            raise ValueError("feature_names length mismatch")
        offsets = np.cumsum([0] + lens)
        info = None
        if reference is not None:
            if f != reference.num_total_features:
                raise ValueError(
                    f"validation data has {f} features, training data had "
                    f"{reference.num_total_features}")
            ds.mappers = reference.mappers
            ds.max_num_bins = reference.max_num_bins
            ds.used_features = reference.used_features
            ds.categorical_features = reference.categorical_features
            info = reference.bundle_info
        else:
            cat_idx = _resolve_categorical(categorical_feature,
                                           ds.feature_names)
            ds.categorical_features = sorted(cat_idx)
            s_cnt = min(n, bin_construct_sample_cnt)
            rng = np.random.RandomState(data_random_seed)
            idx = (np.sort(rng.choice(n, size=s_cnt, replace=False))
                   if s_cnt < n else np.arange(n))
            sample = _read_sample(seqs, offsets, idx, f)
            _fit_mappers(ds, sample, f, cat_idx, max_bin, min_data_in_bin,
                         use_missing, zero_as_missing, max_bin_by_feature,
                         forcedbins_filename)
            if enable_bundle and ds.max_num_bins <= 256:
                # the in-memory path's planning cap on the sample
                info = _plan_efb(ds, bin_columns(ds.mappers, sample[:50_000],
                                                 np.uint8),
                                 max_bin, max_conflict_rate)
        dtype = bin_dtype(ds.max_num_bins)
        dbins = np.array([m.default_bin for m in ds.mappers], np.int32)

        def stream(binfo):
            out = np.zeros((n, binfo.n_columns if binfo is not None else f),
                           dtype)
            conflicts = 0
            pos = 0
            for sq in seqs:
                bs = int(getattr(sq, "batch_size", 4096) or 4096)
                m = len(sq)
                for a in range(0, m, bs):
                    rows = min(a + bs, m) - a
                    raw = np.asarray(sq[a:a + rows], np.float64)
                    if raw.ndim == 1:
                        raw = raw.reshape(1, -1)
                    if raw.shape[1] != f:
                        raise ValueError(
                            f"Sequence batch has {raw.shape[1]} features, "
                            f"expected {f}")
                    if raw.shape[0] != rows:
                        raise ValueError(
                            f"Sequence slice returned {raw.shape[0]} rows "
                            f"for a {rows}-row range")
                    chunk = bin_columns(ds.mappers, raw, dtype)
                    if binfo is not None:
                        chunk, cf = bundle_chunk(chunk, binfo, dbins)
                        conflicts += cf
                    out[pos:pos + rows] = chunk
                    pos += rows
            if pos != n:
                raise ValueError(
                    f"Sequences yielded {pos} rows, __len__ promised {n}")
            return out, conflicts

        out, conflicts = stream(info)
        if info is not None and reference is None:
            if conflicts > conflict_allowance(info, n, max_conflict_rate):
                log.warning("EFB: feature conflict outside the planning "
                            "sample; keeping the dense matrix")
                info = None
                out, _ = stream(None)
            else:
                log.info(f"EFB: bundled {info.n_bundled} of {f} features "
                         f"into {info.n_columns} stored columns (streaming)")
        ds.bundle_info = info
        ds.binned = out
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
        """Per feature: a numerical feature with a NaN bin (the scan's
        "missing left" direction)."""
        return np.array([m.missing_type == MISSING_NAN
                         and not m.is_categorical for m in self.mappers],
                        bool)

    def feature_is_categorical(self) -> np.ndarray:
        return np.array([m.is_categorical for m in self.mappers], bool)

    def reference_bin_distribution(self) -> Tuple[np.ndarray, np.ndarray]:
        """The drift monitor's reference (reference:
        ``reference_bin_distribution``, ``lightgbm_tpu/io/dataset.py:
        512-538``): each original feature's normalized bin occupancy of
        these rows, ``(probs [F, B] float32, num_bins [F] int32)``, read
        through EFB bundles where the matrix is bundled, and cached."""
        cached = getattr(self, "_ref_dist", None)
        if cached is not None:
            return cached
        if self.binned is None:
            raise ValueError("dataset is not constructed")
        from .binning import bin_occupancy
        counts, nb = bin_occupancy(self.binned, self.mappers,
                                   self.bundle_info)
        probs = (counts / np.maximum(counts.sum(axis=1, keepdims=True), 1)
                 ).astype(np.float32)
        self._ref_dist = (probs, nb)
        return self._ref_dist


# -- 4-bit dense bin packing (reference: the 4-bit mode of the dense bin
# store, src/io/dense_bin.hpp DenseBin<true>, and lightgbm_tpu/io/
# dataset.py:635-680) ------------------------------------------------------
def pack4_eligible(mappers) -> bool:
    """True when every original feature has at most 16 bins, so prediction
    inputs (binned per original feature) pack two columns a byte."""
    return bool(mappers) and all(m.num_bins <= 16 for m in mappers)


def pack4_train_eligible(stored_num_bins, hist_bins: int) -> bool:
    """Training's pack4 eligibility: every STORED column (under EFB the
    bundle columns, which may be wider than their members) has at most 16
    bins, and so has the histogram width (``max_bin + 1``), since the
    routing and the histograms read nibble values 0..15."""
    nb = np.asarray(stored_num_bins)
    return bool(nb.size) and int(nb.max()) <= 16 and int(hist_bins) <= 16


def pack4_matrix(binned: np.ndarray) -> np.ndarray:
    """``[N, F]`` u8 (every value < 16) -> ``[N, ceil(F/2)]`` u8: column
    ``2j`` in the low nibble of packed column ``j``, ``2j+1`` in the high
    one (an odd F pads a zero high nibble)."""
    if binned.dtype != np.uint8:
        raise ValueError("pack4_matrix needs a uint8 bin matrix")
    if binned.shape[1] % 2:
        binned = np.pad(binned, ((0, 0), (0, 1)))
    return (binned[:, 0::2] | (binned[:, 1::2] << 4)).astype(np.uint8)


def unpack4_matrix(packed: np.ndarray, num_features: int) -> np.ndarray:
    """Host inverse of ``pack4_matrix``."""
    out = np.empty((packed.shape[0], packed.shape[1] * 2), np.uint8)
    out[:, 0::2] = packed & 0x0F
    out[:, 1::2] = (packed >> 4) & 0x0F
    return out[:, :num_features]


def _plan_efb(ds, sample_binned, max_bin, max_conflict_rate
              ) -> Optional[BundleInfo]:
    """EFB plan from a binned row sample, or None (reference:
    ``_plan_efb``, ``io/dataset.py:556-569`` of the JAX package)."""
    dbins = np.array([m.default_bin for m in ds.mappers], np.int32)
    nbins = np.array([m.num_bins for m in ds.mappers], np.int32)
    ok = np.array([not m.is_categorical and m.missing_type != MISSING_NAN
                   and not m.is_trivial for m in ds.mappers], bool)
    bundles = plan_bundles(sample_binned, nbins, dbins, ok, max_bin=max_bin,
                           max_conflict_rate=max_conflict_rate)
    if not bundles:
        return None
    return build_bundle_info(bundles, nbins, ds.num_total_features)


def _apply_bundles(binned, info: BundleInfo, ds,
                   max_conflict_rate: float = 1e-4) -> np.ndarray:
    """The bundled matrix, with ``ds.bundle_info`` set; the dense matrix,
    with ``ds.bundle_info`` None, when more conflicts appear than the plan
    allows (reference: ``_apply_bundles``, ``io/dataset.py:624-633``)."""
    dbins = np.array([m.default_bin for m in ds.mappers], np.int32)
    out = bundle_matrix(binned, info, dbins, max_conflict_rate)
    if out is None:
        log.warning("EFB: feature conflict outside the planning sample; "
                    "keeping the dense matrix")
        ds.bundle_info = None
        return binned
    ds.bundle_info = info
    return out


def _resolve_categorical(categorical_feature, feature_names: List[str]
                         ) -> Set[int]:
    """Categorical feature indices from indices, names (``"name:"``
    prefixed or not) or a comma-separated string of either."""
    out: Set[int] = set()
    if categorical_feature is None or categorical_feature in ("auto", ""):
        return out
    if isinstance(categorical_feature, str):
        categorical_feature = [c.strip() for c in
                               categorical_feature.split(",") if c.strip()]
    for c in categorical_feature:
        if isinstance(c, (int, np.integer)):
            out.add(int(c))
            continue
        c = str(c)
        if c.startswith("name:"):
            c = c[5:]
        if c in feature_names:
            out.add(feature_names.index(c))
        else:
            try:
                out.add(int(c))
            except ValueError:
                log.warning(f"Unknown categorical feature: {c}")
    return out


def _read_sample(seqs, offsets, idx, f) -> np.ndarray:
    """Rows ``idx`` (sorted) of the stacked sequences as ``[len(idx), F]``
    float64: a sequence that gives a third of its rows or more is read in
    its batches, the others a row at a time (reference:
    ``lightgbm_tpu/io/dataset.py:419-443``)."""
    sample = np.empty((len(idx), f), np.float64)
    si = np.searchsorted(offsets, idx, side="right") - 1
    pos = 0
    for sq_i, sq in enumerate(seqs):
        local = (idx[si == sq_i] - offsets[sq_i]).astype(np.int64)
        if not len(local):
            continue
        m = len(sq)
        if len(local) * 3 >= m:
            bs = int(getattr(sq, "batch_size", 4096) or 4096)
            for a in range(0, m, bs):
                sel = local[(local >= a) & (local < a + bs)]
                if not len(sel):
                    continue
                batch = np.asarray(sq[a:min(a + bs, m)],
                                   np.float64).reshape(-1, f)
                sample[pos:pos + len(sel)] = batch[sel - a]
                pos += len(sel)
        else:
            for i in local:
                sample[pos] = np.asarray(sq[int(i)], np.float64).reshape(-1)
                pos += 1
    return sample


def read_forced_bins(path: str) -> Dict[int, np.ndarray]:
    """``forcedbins_filename``'s bounds by feature: a JSON list of
    ``{"feature": i, "bin_upper_bound": [...]}`` (reference:
    DatasetLoader::GetForcedBins, dataset_loader.cpp:1493)."""
    if not path:
        return {}
    with open(path) as fh:
        return {int(e["feature"]): np.asarray(e["bin_upper_bound"],
                                              np.float64)
                for e in json.load(fh)}


def _fit_mappers(ds, sample, f, cat_idx, max_bin, min_data_in_bin,
                 use_missing, zero_as_missing, max_bin_by_feature,
                 forcedbins_filename=""):
    """Fit per-feature BinMappers from a row sample."""
    total_sample_cnt = len(sample)
    if max_bin_by_feature is not None and len(max_bin_by_feature) != f:
        raise ValueError("max_bin_by_feature needs one entry per feature")
    forced = read_forced_bins(forcedbins_filename)

    def fit(j):
        mb = (int(max_bin_by_feature[j]) if max_bin_by_feature is not None
              else max_bin)
        if j in cat_idx:
            return find_bin_categorical(sample[:, j], mb, min_data_in_bin)
        return find_bin_numerical(sample[:, j], total_sample_cnt, mb,
                                  min_data_in_bin, use_missing=use_missing,
                                  zero_as_missing=zero_as_missing,
                                  forced_bounds=forced.get(j))
    ds.mappers = [fit(j) for j in range(f)]
    ds.used_features = [j for j, m in enumerate(ds.mappers)
                        if not m.is_trivial]
    if not ds.used_features:
        log.warning("all features are constant; no informative splits "
                    "possible")
    # shape-stable bin axis: max_bin + 1 (the JAX package pads the same
    # way); a max_bin_by_feature entry above max_bin widens it (the JAX
    # package keeps max_bin + 1 there, and its uint8 matrix overflows on
    # such a feature's bins: ROADMAP C notes)
    widest = max([max_bin] + [int(v) for v in max_bin_by_feature or ()])
    ds.max_num_bins = max(widest + 1, 2)
