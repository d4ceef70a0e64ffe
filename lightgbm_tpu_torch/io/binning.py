"""Feature discretization (binning) for lightgbm_tpu_torch.

Copy of the numerical part of ``lightgbm_tpu/io/binning.py`` (the port
imports nothing of the JAX package): ``BinMapper``, ``_greedy_find_bin``,
``find_bin_numerical`` and ``bin_columns`` (the JAX package's
``bin_columns`` and ``_bin_columns`` in one), same algorithms, so
bin bounds and uint8 bin matrices are equal to the JAX package's. The
reference is the ``BinMapper`` of LightGBM (include/LightGBM/bin.h:85,
src/io/bin.cpp — ``FindBin`` bin.cpp:311, ``GreedyFindBin`` bin.cpp:78,
``FindBinWithZeroAsOneBin`` bin.cpp:242).

Categorical binning, forced bin bounds and the raw-value thresholds of
model text are not here yet (ROADMAP A3, A9, A12); the configuration
raises before reaching them. Binning runs in numpy
on the host; the bin matrix then goes to the device in one copy.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

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
    upper: List[float] = []
    if n <= max_bin:
        cnt_in_bin = 0
        for i in range(n - 1):
            cnt_in_bin += int(counts[i])
            if cnt_in_bin >= min_data_in_bin:
                upper.append(float(distinct_values[i] + distinct_values[i + 1]) / 2.0)
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
    cur_cnt = 0
    bins_remaining = eff_max_bin
    for i in range(n - 1):
        if not is_big[i]:
            rest_cnt -= int(counts[i])
        cur_cnt += int(counts[i])
        # close the current bin if: value is heavy, bin is full, or next value is heavy
        if is_big[i] or cur_cnt >= mean_rest or (is_big[i + 1] and cur_cnt >= max(1.0, mean_rest * 0.5)):
            upper.append(float(distinct_values[i] + distinct_values[i + 1]) / 2.0)
            cur_cnt = 0
            bins_remaining -= 1
            if bins_remaining <= 1:
                break
            if not is_big[i] and rest_bins > int(is_big[i + 1 :].sum()):
                rb = bins_remaining - int(is_big[i + 1 :].sum())
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
    """Per-feature value -> bin mapping of a numerical feature (reference:
    BinMapper, bin.h:85)."""

    num_bins: int = 1
    missing_type: int = MISSING_NONE
    bin_upper_bounds: np.ndarray = field(default_factory=lambda: np.array([np.inf]))
    default_bin: int = 0       # bin of value 0.0
    min_value: float = 0.0
    max_value: float = 0.0

    @property
    def is_trivial(self) -> bool:
        return self.num_bins <= 1

    @property
    def nan_bin(self) -> int:
        """Bin that NaN values map to."""
        if self.missing_type == MISSING_NAN:
            return self.num_bins - 1
        return self.default_bin


def find_bin_numerical(
    sample_values: np.ndarray,
    total_sample_cnt: int,
    max_bin: int,
    min_data_in_bin: int = 3,
    use_missing: bool = True,
    zero_as_missing: bool = False,
) -> BinMapper:
    """Construct a numerical BinMapper from sampled values.

    ``sample_values`` may contain NaN. ``total_sample_cnt`` includes rows whose
    value was zero and therefore may exceed ``len(sample_values)`` in sparse
    ingestion paths (reference semantics: zeros counted implicitly).
    """
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
    num_cols = [j for j in range(f) if not mappers[j].is_trivial]
    if not num_cols:
        return out
    bounds = {j: _interior_bounds(mappers[j]) for j in num_cols}
    nan_bins = np.array([mappers[j].nan_bin if not mappers[j].is_trivial
                         else 0 for j in range(f)], dtype)
    small = sorted((j for j in num_cols if len(bounds[j]) <= _SMALL_BOUNDS),
                   key=lambda j: len(bounds[j]))
    big = [j for j in num_cols if len(bounds[j]) > _SMALL_BOUNDS]

    if workers is None:
        workers = min(16, os.cpu_count() or 1)
    if n * len(num_cols) < (1 << 21):
        workers = 1          # pool overhead beats tiny inputs
    if workers > 1:
        # shrink chunks until every worker has a few to keep busy
        row_chunk = max(4096, min(row_chunk, -(-n // (2 * workers))))

    def _do_chunk(r0: int) -> None:
        r1 = min(n, r0 + row_chunk)
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

    starts = list(range(0, n, row_chunk))
    if workers > 1 and len(starts) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(_do_chunk, starts))
    else:
        for r0 in starts:
            _do_chunk(r0)
    return out
