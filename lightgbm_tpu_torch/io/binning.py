"""Feature discretization (binning) for lightgbm_tpu_torch.

Copy of ``lightgbm_tpu/io/binning.py`` (the port imports nothing of the JAX
package): ``BinMapper`` (numerical and categorical), ``_greedy_find_bin``,
``find_bin_numerical`` (with user-forced bounds, ``_find_bin_with_forced``),
``find_bin_categorical`` and ``bin_columns`` (the JAX package's
``bin_columns`` and ``_bin_columns`` in one), same algorithms, so bin
bounds, category tables and bin matrices (uint8, or uint16 above 256 bins)
are equal to the JAX package's. The
reference is the ``BinMapper`` of LightGBM (include/LightGBM/bin.h:85,
src/io/bin.cpp — ``FindBin`` bin.cpp:311, ``GreedyFindBin`` bin.cpp:78,
``FindBinWithZeroAsOneBin`` bin.cpp:242, the categorical branch bin.cpp:
335-395), and ``bin_to_threshold``, the raw-value threshold that model text
stores.

A categorical feature's bin 0 holds missing values (NaN, negative values)
and the categories that did not get a bin of their own; categories take
bins 1.. by descending count. Binning runs in numpy on the host; the bin
matrix then goes to the device in one copy.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils import log

K_ZERO_THRESHOLD = 1e-35

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2


def _greedy_find_bin(
    distinct_values: np.ndarray,
    counts: np.ndarray,
    max_bin: int,
    total_sample_cnt: int,
    min_data_in_bin: int,
) -> List[float]:
    """Count-balanced greedy binning over sorted distinct values.

    Returns the list of bin upper bounds (last is +inf). Mirrors the behavior of
    the reference's GreedyFindBin (src/io/bin.cpp:78) without copying it: when the
    number of distinct values fits in ``max_bin``, each value gets its own bin
    (merging neighbors until ``min_data_in_bin`` is met); otherwise bins are grown
    greedily to ~equal counts, with values heavier than the mean bin size given
    dedicated bins.
    """
    n = len(distinct_values)
    if n == 0:
        return [float("inf")]
    # Python lists: the loops below read one element at a time, which costs
    # a numpy scalar each from the arrays (the greedy loop ran 0.16 s a
    # 200,000-value feature that way); the values are float64, so the
    # midpoints are the same
    dv = np.asarray(distinct_values).tolist()
    cnt = np.asarray(counts).tolist()
    upper: List[float] = []
    if n <= max_bin:
        cnt_in_bin = 0
        for i in range(n - 1):
            cnt_in_bin += cnt[i]
            if cnt_in_bin >= min_data_in_bin:
                upper.append((dv[i] + dv[i + 1]) / 2.0)
                cnt_in_bin = 0
        upper.append(float("inf"))
        return upper
    # too many distinct values: greedy count balancing
    eff_max_bin = max_bin
    if min_data_in_bin > 0:
        eff_max_bin = min(max_bin, max(1, total_sample_cnt // min_data_in_bin))
    mean_size = total_sample_cnt / eff_max_bin
    is_big = counts >= mean_size
    rest_cnt = total_sample_cnt - int(counts[is_big].sum())
    rest_bins = eff_max_bin - int(is_big.sum())
    if rest_bins > 0:
        mean_rest = rest_cnt / rest_bins
    else:
        mean_rest = float("inf")
    # big_from[i]: the heavy values at i and after
    big_from = np.concatenate([np.cumsum(is_big[::-1])[::-1], [0]]).tolist()
    big = is_big.tolist()
    cur_cnt = 0
    bins_remaining = eff_max_bin
    for i in range(n - 1):
        if not big[i]:
            rest_cnt -= cnt[i]
        cur_cnt += cnt[i]
        # close the current bin if: value is heavy, bin is full, or next value is heavy
        if big[i] or cur_cnt >= mean_rest or (big[i + 1] and cur_cnt >= max(1.0, mean_rest * 0.5)):
            upper.append((dv[i] + dv[i + 1]) / 2.0)
            cur_cnt = 0
            bins_remaining -= 1
            if bins_remaining <= 1:
                break
            if not big[i] and rest_bins > big_from[i + 1]:
                rb = bins_remaining - big_from[i + 1]
                if rb > 0:
                    mean_rest = rest_cnt / rb
    upper.append(float("inf"))
    # dedupe (midpoints can collide for adjacent near-equal values)
    out: List[float] = []
    for u in upper:
        if not out or u > out[-1]:
            out.append(u)
    return out


@dataclass
class BinMapper:
    """Per-feature value -> bin mapping (reference: BinMapper, bin.h:85)."""

    num_bins: int = 1
    is_categorical: bool = False
    missing_type: int = MISSING_NONE
    # numerical
    bin_upper_bounds: np.ndarray = field(default_factory=lambda: np.array([np.inf]))
    # categorical: category value -> bin, and bin -> category (bin 0: -1)
    cat_to_bin: Dict[int, int] = field(default_factory=dict)
    bin_to_cat: np.ndarray = field(
        default_factory=lambda: np.array([], dtype=np.int64))
    default_bin: int = 0       # bin of value 0.0 (categorical: missing bin)
    min_value: float = 0.0
    max_value: float = 0.0

    @property
    def is_trivial(self) -> bool:
        return self.num_bins <= 1

    @property
    def nan_bin(self) -> int:
        """Bin that NaN values map to."""
        if self.is_categorical:
            return 0
        if self.missing_type == MISSING_NAN:
            return self.num_bins - 1
        return self.default_bin

    def _cat_lookup(self) -> Tuple[np.ndarray, np.ndarray]:
        """Sorted (category, bin) arrays for a vectorized lookup."""
        keys = np.fromiter(self.cat_to_bin.keys(), np.int64,
                           len(self.cat_to_bin))
        vals = np.fromiter(self.cat_to_bin.values(), np.int32,
                           len(self.cat_to_bin))
        order = np.argsort(keys)
        return keys[order], vals[order]

    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Bins of one column's raw values. Categorical: a value's integer
        part looked up in the category table; NaN, infinite, negative and
        unknown values go to bin 0. Numerical: the first interior bound >=
        the value, NaN to ``nan_bin`` (``bin_columns`` does the same for a
        whole matrix)."""
        values = np.asarray(values)
        if values.dtype not in (np.float32, np.float64):
            values = values.astype(np.float64)
        if not self.is_categorical:
            nan = np.isnan(values)
            bins = np.searchsorted(_interior_bounds(self),
                                   np.where(nan, 0.0, values),
                                   side="left").astype(np.int32)
            bins[nan] = self.nan_bin
            return bins
        out = np.zeros(values.shape, dtype=np.int32)
        finite = np.isfinite(values)
        iv = values[finite].astype(np.int64)
        if len(self.cat_to_bin) and len(iv):
            keys, vals = self._cat_lookup()
            pos = np.minimum(np.searchsorted(keys, iv), len(keys) - 1)
            out[finite] = np.where(keys[pos] == iv, vals[pos], 0)
        return out

    def bin_to_threshold(self, bin_idx: int) -> float:
        """Raw-value threshold of the split ``bin <= bin_idx`` (model text).
        Splitting at the last numeric bin separates NaN rows only; its +inf
        bound is clamped as the reference's Common::AvoidInf does."""
        if self.is_categorical:
            raise ValueError("categorical bins have no scalar threshold")
        return min(float(self.bin_upper_bounds[bin_idx]), 1e308)


def find_bin_numerical(
    sample_values: np.ndarray,
    total_sample_cnt: int,
    max_bin: int,
    min_data_in_bin: int = 3,
    use_missing: bool = True,
    zero_as_missing: bool = False,
    forced_bounds: Optional[np.ndarray] = None,
) -> BinMapper:
    """Construct a numerical BinMapper from sampled values.

    ``sample_values`` may contain NaN. ``total_sample_cnt`` includes rows whose
    value was zero and therefore may exceed ``len(sample_values)`` in sparse
    ingestion paths (reference semantics: zeros counted implicitly).
    ``forced_bounds``: user bin upper bounds (``forcedbins_filename``), which
    take priority over the greedy ones.
    """
    if forced_bounds is not None and len(forced_bounds):
        m = _find_bin_with_forced(sample_values, total_sample_cnt, max_bin,
                                  min_data_in_bin, use_missing,
                                  zero_as_missing,
                                  np.asarray(forced_bounds, np.float64))
        if m is not None:
            return m
    values = np.asarray(sample_values, dtype=np.float64)
    nan_cnt = int(np.isnan(values).sum())
    values = values[~np.isnan(values)]

    if zero_as_missing:
        missing_type = MISSING_ZERO
        zero_is_missing = True
    elif nan_cnt > 0 and use_missing:
        missing_type = MISSING_NAN
        zero_is_missing = False
    else:
        missing_type = MISSING_NONE
        zero_is_missing = False

    # zero-as-one-bin: bin negative and positive parts separately, keep a
    # dedicated zero bin between them (reference: FindBinWithZeroAsOneBin).
    zero_cnt = int((np.abs(values) <= K_ZERO_THRESHOLD).sum())
    # implicit zeros (sparse ingestion): rows not materialized in the sample
    zero_cnt += max(0, total_sample_cnt - len(values) - nan_cnt)
    neg = values[values < -K_ZERO_THRESHOLD]
    pos = values[values > K_ZERO_THRESHOLD]
    n_nonzero = len(neg) + len(pos)

    n_avail_bins = max_bin - (1 if missing_type == MISSING_NAN else 0)
    # reserve one bin for zero
    n_nonzero_bins = max(1, n_avail_bins - 1)

    uppers: List[float] = []
    if n_nonzero > 0:
        if len(neg) > 0 and len(pos) > 0:
            neg_bins = max(1, int(round(n_nonzero_bins * len(neg) / n_nonzero)))
            pos_bins = max(1, n_nonzero_bins - neg_bins)
        elif len(neg) > 0:
            neg_bins, pos_bins = n_nonzero_bins, 0
        else:
            neg_bins, pos_bins = 0, n_nonzero_bins
        if len(neg) > 0:
            dv, cnts = np.unique(neg, return_counts=True)
            u = _greedy_find_bin(dv, cnts, neg_bins, len(neg), min_data_in_bin)
            uppers.extend(u[:-1])  # drop the +inf terminator
            uppers.append(-K_ZERO_THRESHOLD)
        else:
            uppers.append(-K_ZERO_THRESHOLD)
        if len(pos) > 0:
            uppers.append(K_ZERO_THRESHOLD)
            dv, cnts = np.unique(pos, return_counts=True)
            u = _greedy_find_bin(dv, cnts, pos_bins, len(pos), min_data_in_bin)
            uppers.extend(u)
        else:
            uppers.append(np.inf)
    else:
        uppers = [np.inf]

    # dedupe & sort
    uppers = sorted(set(float(u) for u in uppers))
    upper_arr = np.array(uppers, dtype=np.float64)
    num_numeric_bins = len(upper_arr)
    # drop the zero-side bin if there were no zeros at all and it is redundant
    num_bins = num_numeric_bins + (1 if missing_type == MISSING_NAN else 0)

    if num_bins <= 1 or (num_numeric_bins <= 1 and missing_type != MISSING_NAN):
        # trivial feature
        if not (missing_type == MISSING_NAN and num_numeric_bins >= 1 and nan_cnt > 0 and n_nonzero + zero_cnt > 0):
            mapper = BinMapper(num_bins=1, missing_type=MISSING_NONE)
            return mapper

    mapper = BinMapper(
        num_bins=num_bins,
        missing_type=missing_type,
        bin_upper_bounds=upper_arr,
    )
    if len(values) > 0:
        mapper.min_value = float(values.min()) if len(values) else 0.0
        mapper.max_value = float(values.max()) if len(values) else 0.0
    # default bin = bin of 0.0
    mapper.default_bin = int(np.searchsorted(upper_arr[:-1], 0.0, side="left"))
    return mapper


def _find_bin_with_forced(values, total_sample_cnt, max_bin, min_data_in_bin,
                          use_missing, zero_as_missing,
                          forced) -> Optional[BinMapper]:
    """Greedy binning that keeps the user's bounds (reference:
    ``_find_bin_with_forced``, ``lightgbm_tpu/io/binning.py:306-353``;
    LightGBM's forced_bin_bounds in bin.cpp FindBin): the greedy fit runs
    with the budget left after the forced bounds, and its bounds outside
    them are thinned at evenly spaced positions to fit ``max_bin - 1``."""
    forced = np.unique(forced)
    if len(forced) == 0:
        return None
    base = find_bin_numerical(values, total_sample_cnt,
                              max(max_bin - len(forced), 2),
                              min_data_in_bin, use_missing, zero_as_missing)
    finite = base.bin_upper_bounds[np.isfinite(base.bin_upper_bounds)]
    forced = forced[: max_bin - 1]
    budget = max_bin - 1 - len(forced)
    leftover = np.setdiff1d(finite, forced)
    if budget <= 0:
        greedy = leftover[:0]
    elif len(leftover) > budget:
        # spacing > 1: the rounded positions are distinct, so exactly
        # `budget` bounds remain
        pick = np.linspace(0, len(leftover) - 1, budget).round().astype(int)
        greedy = leftover[np.unique(pick)]
    else:
        greedy = leftover
    bounds = np.sort(np.concatenate([forced, greedy]))
    m = BinMapper(
        num_bins=len(bounds) + 1 + (1 if base.missing_type == MISSING_NAN
                                    else 0),
        missing_type=base.missing_type,
        bin_upper_bounds=np.concatenate([bounds, [np.inf]]),
        min_value=base.min_value,
        max_value=base.max_value,
    )
    m.default_bin = int(m.value_to_bin(np.array([0.0]))[0])
    return m


# row-chunk x column-chunk x bounds budget for the batched compare
# (bool intermediates, ~4MB a piece — cache-resident)
_BATCH_ELEMS = 1 << 22
# columns whose interior-bound count fits this go through the batched
# broadcast compare (one vector op per bound for a whole column chunk);
# wider mappers keep per-column np.searchsorted over the same row chunk
_SMALL_BOUNDS = 16


def _interior_bounds(m: BinMapper) -> np.ndarray:
    """The finite upper bounds a value is searched among (excludes the
    trailing +inf terminator and, for MissingType NaN, the missing bin):
    its bin is the first bound >= the value."""
    n_numeric = m.num_bins - (1 if m.missing_type == MISSING_NAN else 0)
    return m.bin_upper_bounds[: n_numeric - 1]


def bin_columns(mappers: Sequence[BinMapper], arr: np.ndarray,
                dtype=np.uint8, row_chunk: int = 1 << 18,
                workers: Optional[int] = None) -> np.ndarray:
    """Bin a raw ``[N, F]`` float matrix with fitted mappers, batched.

    The dataset-construction hot path (reference: the per-group
    ``Dataset::PushOneRow`` loops, src/io/dataset.cpp). The scalar form —
    one pass per column over all N rows — pays the NaN
    mask, the missing fill, and the dtype promotion once per column over
    the full column length; at Allstate shape (F=4228) those per-column
    passes dominate construct time. Here the work is blocked the other
    way:

      * rows stream in cache-resident chunks, with ONE ``isnan`` pass per
        chunk shared by every column;
      * columns with few interior bounds (one-hot blocks: 1-2 bounds)
        batch into a single broadcast compare-and-sum per column chunk —
        ``sum(bounds < v)`` is exactly ``np.searchsorted(bounds, v,
        'left')``, with +inf padding rows contributing nothing;
      * columns with many bounds keep per-column ``np.searchsorted`` on
        the row chunk (a 255-bound binary search beats 255 compares);
      * NaN rows overwrite with the per-column nan bin afterwards;
      * row chunks fan out over a thread pool — numpy's searchsorted and
        comparison ufuncs release the GIL, and each chunk writes a
        disjoint slice of the output, so the host-side construct scales
        with cores instead of running one column at a time.

    float32 input is never promoted to a float64 matrix (each comparison
    upcasts exactly), so results are bit-identical to the scalar path.
    """
    arr = np.asarray(arr)
    if arr.dtype not in (np.float32, np.float64):
        arr = arr.astype(np.float64)
    n, f = arr.shape
    out = np.zeros((n, f), dtype)
    live = [j for j in range(f) if not mappers[j].is_trivial]
    num_cols = [j for j in live if not mappers[j].is_categorical]
    for j in live:
        if mappers[j].is_categorical:
            out[:, j] = mappers[j].value_to_bin(arr[:, j]).astype(dtype)
    if not num_cols:
        return out
    bounds = {j: _interior_bounds(mappers[j]) for j in num_cols}
    nan_bins = np.array([mappers[j].nan_bin if not mappers[j].is_trivial
                         else 0 for j in range(f)], dtype)
    small = sorted((j for j in num_cols if len(bounds[j]) <= _SMALL_BOUNDS),
                   key=lambda j: len(bounds[j]))
    big = [j for j in num_cols if len(bounds[j]) > _SMALL_BOUNDS]

    def _do_chunk(r0: int, r1: int) -> None:
        chunk = arr[r0:r1]
        nan_mask = np.isnan(chunk)
        any_nan = bool(nan_mask.any())
        for j in big:
            v = chunk[:, j]
            if any_nan:
                v = np.where(nan_mask[:, j], 0.0, v)
            b = np.searchsorted(bounds[j], v, side="left").astype(dtype)
            if any_nan:
                b[nan_mask[:, j]] = nan_bins[j]
            out[r0:r1, j] = b
        if not small:
            return
        rows = r1 - r0
        cc = max(1, _BATCH_ELEMS // max(rows * (_SMALL_BOUNDS + 1), 1))
        for c0 in range(0, len(small), cc):
            cols = small[c0:c0 + cc]
            kmax = max(1, max(len(bounds[j]) for j in cols))
            ub = np.full((len(cols), kmax), np.inf)
            for i, j in enumerate(cols):
                ub[i, : len(bounds[j])] = bounds[j]
            v = chunk[:, cols]
            if any_nan:
                v = np.where(nan_mask[:, cols], 0.0, v)
            # sum(bounds < v) == searchsorted(bounds, v, 'left'); the +inf
            # padding never counts, so ragged bound lists batch exactly
            b = (v[:, :, None] > ub[None, :, :]).sum(axis=2).astype(dtype)
            if any_nan:
                b = np.where(nan_mask[:, cols], nan_bins[cols], b)
            out[r0:r1, cols] = b

    map_row_chunks(_do_chunk, n, n * len(live), row_chunk, workers)
    return out


def map_row_chunks(fn, n: int, work: int, row_chunk: int = 1 << 18,
                   workers: Optional[int] = None) -> list:
    """``fn(r0, r1)`` over ``n`` rows in blocks of at most ``row_chunk``,
    its results in row order. With ``work`` (the elements the call
    touches) of 2^21 or more, the blocks run on a thread pool of
    ``workers`` threads (default ``min(16, cpu count)``; numpy releases
    the GIL in its kernels), shrunk until every thread has a few of at
    least 4,096 rows; below it the pool's overhead beats the gain."""
    if workers is None:
        workers = min(16, os.cpu_count() or 1)
    if work < (1 << 21):
        workers = 1
    if workers > 1:
        row_chunk = max(4096, min(row_chunk, -(-n // (2 * workers))))
    starts = range(0, max(n, 1), row_chunk)
    if workers > 1 and len(starts) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(
                lambda r0: fn(r0, min(n, r0 + row_chunk)), starts))
    return [fn(r0, min(n, r0 + row_chunk)) for r0 in starts]


def find_bin_categorical(sample_values: np.ndarray, max_bin: int,
                         min_data_in_bin: int = 3) -> BinMapper:
    """A categorical BinMapper (reference: BinMapper::FindBin, categorical
    branch, src/io/bin.cpp:335-395): categories sorted by descending count
    (ties by value), at most ``max_bin - 1`` of them; when there are more,
    those below ``min_data_in_bin`` rows are dropped too. NaN and negative
    values are missing, and missing and dropped categories fall into bin
    0."""
    values = np.asarray(sample_values, dtype=np.float64)
    iv = values[np.isfinite(values)].astype(np.int64)
    if (iv < 0).any():
        log.warning("negative categorical value found; treated as missing")
        iv = iv[iv >= 0]
    if len(iv) == 0:
        return BinMapper(num_bins=1, is_categorical=True)
    cats, counts = np.unique(iv, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    cats, counts = cats[order], counts[order]
    keep = min(len(cats), max_bin - 1)
    if keep < len(cats):
        ok = counts[:keep] >= max(1, min_data_in_bin)
        keep = int(ok.sum()) if ok.any() else 1
    cats = cats[:keep]
    return BinMapper(
        num_bins=keep + 1, is_categorical=True, missing_type=MISSING_NAN,
        cat_to_bin={int(c): i + 1 for i, c in enumerate(cats)},
        bin_to_cat=np.concatenate([[-1], cats]).astype(np.int64),
        default_bin=0)


# -- the serving featurizer's state (``ops/device_bin.py``; reference:
# ``lightgbm_tpu/io/binning.py:346-456``) --------------------------------------

#: an int32 key no served categorical code can equal (the device lookup pads
#: its key table with it)
CAT_PAD = np.int32(np.iinfo(np.int32).min)


def round_down_f32(bounds: np.ndarray) -> np.ndarray:
    """The largest float32 at most each float64 bound. For a float32 value
    ``v`` and a float64 bound ``b``, ``v > b`` holds exactly when ``v > t``
    for this ``t``, so float32 rows binned against these thresholds get the
    bins ``bin_columns`` gives them in float64."""
    b = np.asarray(bounds, np.float64)
    t = b.astype(np.float32)
    over = t.astype(np.float64) > b
    if over.any():
        t = t.copy()
        t[over] = np.nextafter(t[over], np.float32(-np.inf))
    return t


@dataclass
class FeaturizeState:
    """The mappers stacked into dense host arrays for the device featurizer
    (reference: ``FeaturizeState``; LightGBM caches the same state in its
    single-row predictor, src/c_api.cpp:117). ``reason`` says why a model
    cannot take the device featurizer (None: it can)."""
    bounds32: np.ndarray        # [F, Kb] f32 round-down thresholds, +inf pad
    nan_bins: np.ndarray        # [F] int32 (0 for trivial features)
    is_cat: np.ndarray          # [F] bool
    cat_keys: np.ndarray        # [F, Kc] int32 sorted, CAT_PAD padded
    cat_vals: np.ndarray        # [F, Kc] int32, 0 padded
    reason: Optional[str] = None


def export_featurize_state(mappers: Sequence[BinMapper]) -> FeaturizeState:
    """Stack fitted mappers for ``ops/device_bin.py`` (reference:
    ``export_featurize_state``): each numerical feature's interior bounds
    (those ``bin_columns`` searches) as round-down float32 thresholds
    padded with +inf, which no value exceeds; each categorical feature's
    sorted (code, bin) table padded with ``CAT_PAD``. Codes outside int32
    leave the model to the host binner (``reason``)."""
    f = len(mappers)
    num_bounds = [_interior_bounds(m) if not (m.is_trivial
                                              or m.is_categorical)
                  else np.empty(0) for m in mappers]
    kb = max((len(b) for b in num_bounds), default=0)
    bounds32 = np.full((f, max(kb, 1)), np.inf, np.float32)
    for j, b in enumerate(num_bounds):
        if len(b):
            bounds32[j, :len(b)] = round_down_f32(b)
    nan_bins = np.array([0 if m.is_trivial else m.nan_bin for m in mappers],
                        np.int32)
    is_cat = np.array([m.is_categorical and not m.is_trivial
                       for m in mappers], bool)
    tables, reason = [], None
    for j, m in enumerate(mappers):
        if is_cat[j] and len(m.cat_to_bin):
            keys, vals = m._cat_lookup()
            if keys.size and (keys.max() > np.iinfo(np.int32).max
                              or keys.min() < np.iinfo(np.int32).min + 1):
                reason = (f"categorical feature {j} has codes outside "
                          "int32; device featurization cannot represent "
                          "its lookup keys")
            tables.append((j, keys, vals))
    kc = max((len(k) for _, k, _ in tables), default=0)
    cat_keys = np.full((f, max(kc, 1)), CAT_PAD, np.int32)
    cat_vals = np.zeros((f, max(kc, 1)), np.int32)
    if reason is None:
        for j, keys, vals in tables:
            cat_keys[j, :len(keys)] = keys.astype(np.int32)
            cat_vals[j, :len(vals)] = vals.astype(np.int32)
    return FeaturizeState(bounds32, nan_bins, is_cat, cat_keys, cat_vals,
                          reason)


def bin_occupancy(binned: np.ndarray, mappers: Sequence[BinMapper],
                  bundle_info=None) -> Tuple[np.ndarray, np.ndarray]:
    """Bin counts of each original feature in a bin matrix: ``(counts [F,
    B] float64, num_bins [F] int32)``, ``B`` the widest feature's bins
    (reference: ``bin_occupancy``, ``lightgbm_tpu/io/binning.py:459-488``).
    An EFB bundle column holds ``offset + 1 + b`` for a member's bin ``b``
    other than its default and 0 otherwise (``io/efb.py``), so a member's
    default bin counts the rest of the rows."""
    n, f = binned.shape[0], len(mappers)
    nb = np.array([m.num_bins for m in mappers], np.int32)
    width = int(nb.max(initial=1))
    counts = np.zeros((f, width), np.float64)
    colhist = [np.bincount(binned[:, c].astype(np.int64, copy=False))
               for c in range(binned.shape[1])]
    for j, m in enumerate(mappers):
        w = int(nb[j])
        if bundle_info is None:
            c, off = j, -1
        else:
            c, off = int(bundle_info.col_of[j]), int(bundle_info.offset_of[j])
        h = colhist[c]
        seg = h[:w] if off < 0 else h[off + 1:off + 1 + w]
        counts[j, :len(seg)] = seg
        if off >= 0:
            d = int(m.default_bin)
            counts[j, d] = max(n - counts[j].sum(), 0.0)
    return counts, nb
