"""Exclusive Feature Bundling (EFB), host numpy.

The port's own copy of ``lightgbm_tpu/io/efb.py`` (the port imports nothing
of the JAX package; reference: FeatureGroup / multi-value bins,
include/LightGBM/feature_group.h, and Dataset::Construct's greedy
conflict-graph packing, src/io/dataset.cpp ``FindGroups`` /
``FastFeatureBundling``), with the same algorithms, so bundle plans and
bundled matrices are equal to the JAX package's. Wide sparse datasets
(one-hot blocks like Allstate's F = 4228) have mutually exclusive features;
bundling packs them into shared ``uint8`` columns, so the compact grower's
row records and histograms scale with the number of stored columns, not of
raw features.

Encoding (per bundle column): value 0 = every member feature at its default
bin; member feature j with bin b != default stores ``offset_j + 1 + b``.
Offsets reserve each member's full bin range, so the bundle-space routing
predicate of a split on member j at threshold t is two range checks:

    in_range = offset_j < v <= offset_j + num_bins_j
    go_left  = (in_range and v - offset_j - 1 <= t) or
               (not in_range and default_bin_j <= t)

The compact grower scans the stored columns plus one virtual feature per
bundled original (``ops/split.py`` ``extend_hist_efb``) and routes a bundled
winner by a bitset on its column (``apply_efb_bitset``); the model's trees
carry original feature ids and thresholds, so model text and prediction on
raw rows never see bundles.

Bundled features are restricted to numerical, no-NaN (missing none/zero)
mappers; everything else passes through as its own column. Packing allows a
bounded conflict count per bundle (reference: total_sample_cnt/10000,
src/io/dataset.cpp:115): conflicting rows keep the first-placed member's
value; ``max_conflict_rate=0`` recovers exact conflict-free bundling. The
conflict counts against all open bundles are one BLAS matvec a feature over
a feature-major sample, which keeps planning fast at F = 4228.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from ..utils import log
from .binning import map_row_chunks


class BundleInfo(NamedTuple):
    """Static bundle layout (host-side; device arrays built by the GBDT)."""
    # per ORIGINAL feature
    col_of: np.ndarray        # [F] i32: column in the stored matrix
    offset_of: np.ndarray     # [F] i32: bin offset within the column
    #                           (-1 = passthrough, column stores raw bins)
    # per stored column
    num_column_bins: np.ndarray   # [C] i32 total bins of each stored column
    n_columns: int
    n_bundled: int            # original features living in shared columns

    @property
    def any_bundled(self) -> bool:
        return self.n_bundled > 0


class EfbLayout(NamedTuple):
    """The device arrays of a bundled dataset in scan space: the C stored
    columns, then one virtual feature per bundled original (built by
    ``boosting/gbdt.py`` ``_setup_efb``; read by ``ops/split.py``
    ``extend_hist_efb``/``apply_efb_bitset`` and the compact grower)."""
    col_of: object       # [C + Fb] stored column of each scan feature
    route_cat: object    # [C + Fb] bool: routed by a bitset
    off: object          # [C + Fb] bin offset in the column (-1 stored)
    nb: object           # [C + Fb] a bundled feature's own bin count
    dbin: object         # [C + Fb] a bundled feature's default bin
    orig_of: object      # [C + Fb] original feature id (-1 bundle column)


def plan_bundles(
    sample_binned: np.ndarray,      # [S, F] sample rows, already binned
    num_bins: np.ndarray,           # [F] per-feature bin counts
    default_bins: np.ndarray,       # [F] per-feature default (zero) bin
    bundleable: np.ndarray,         # [F] bool: numerical, no-NaN, non-cat
    max_bin: int = 255,
    max_conflict_rate: float = 1e-4,
    min_features: int = 256,
) -> Optional[List[List[int]]]:
    """Greedy bounded-conflict packing of sparse features into bundles.

    Reference: Dataset::Construct FindGroups — greedy graph coloring over
    the feature conflict graph with a per-group conflict budget of
    ``total_sample_cnt / 10000`` and a per-feature cap of half its nonzeros
    (src/io/dataset.cpp:115,163). max_conflict_rate = 0 recovers the exact
    (lossless) conflict-free packing.

    Returns bundles as lists of original feature ids (only multi-member
    bundles), or None when bundling is not worthwhile.
    """
    s, f = sample_binned.shape
    if f < min_features or s == 0:
        return None
    nonzero = sample_binned != default_bins[None, :]      # [S, F]
    counts = nonzero.sum(axis=0)
    density = counts / max(s, 1)
    # candidates: sparse enough that exclusivity is plausible
    cand = np.nonzero(bundleable & (density <= 0.5))[0]
    if len(cand) < min_features:
        return None
    # greedy first-fit by descending nonzero count (reference sorts the same
    # way); conflicts checked against the bundle's combined occupancy
    order = cand[np.argsort(-counts[cand], kind="stable")]
    budget = max_bin  # u8 storage: one column holds at most max_bin+1 values
    conflict_budget = int(s * max_conflict_rate)
    # feature-major f32 copy: the conflict counts against ALL open bundles
    # batch into one BLAS matvec per feature (the bundle-by-bundle bool-AND
    # loop was O(F^2 * S) python-side and dominated wide-data construct)
    nzT = np.ascontiguousarray(nonzero.T[order])               # [J, S] bool
    bundles: List[List[int]] = []
    nb_alloc = 256
    # stop OPENING bundles once the occupancy matrix would pass ~512MB
    # (features past the cap stay unbundled; already-planned bundles keep
    # accepting members)
    nb_cap = max(64, (512 << 20) // (4 * s))
    occ = np.zeros((nb_alloc, s), np.float32)       # [NB, S] occupancy
    used_bins = np.zeros(nb_alloc, np.int64)
    conflicts_used = np.zeros(nb_alloc, np.int64)
    for ji, j in enumerate(order):
        nb = int(num_bins[j])
        nz_j = int(counts[j])
        nbundles = len(bundles)
        placed = False
        if nbundles:
            conflict = occ[:nbundles] @ nzT[ji].astype(np.float32)  # [NB]
            ok = (used_bins[:nbundles] + nb <= budget) & (
                conflict <= np.minimum(
                    conflict_budget - conflicts_used[:nbundles], nz_j // 2))
            hits = np.nonzero(ok)[0]
            if len(hits):
                # first-fit, like the reference's FindGroups scan order
                bi = int(hits[0])
                bundles[bi].append(int(j))
                np.maximum(occ[bi], nzT[ji], out=occ[bi])
                used_bins[bi] += nb
                conflicts_used[bi] += int(conflict[bi])
                placed = True
        if not placed:
            if nbundles >= nb_cap:
                continue
            if nbundles == nb_alloc:
                nb_alloc *= 2
                occ = np.concatenate(
                    [occ, np.zeros((nb_alloc - nbundles, s), np.float32)])
                used_bins = np.concatenate(
                    [used_bins, np.zeros(nbundles, np.int64)])
                conflicts_used = np.concatenate(
                    [conflicts_used, np.zeros(nbundles, np.int64)])
            bundles.append([int(j)])
            occ[nbundles] = nzT[ji]
            used_bins[nbundles] = nb
    bundles = [b for b in bundles if len(b) > 1]
    n_bundled = sum(len(b) for b in bundles)
    if n_bundled < min_features:
        return None
    return bundles


def build_bundle_info(bundles: List[List[int]], num_bins: np.ndarray,
                      f: int) -> BundleInfo:
    """Column layout: passthrough features keep their own columns (in
    original order), bundles follow."""
    in_bundle = np.zeros(f, bool)
    for b in bundles:
        for j in b:
            in_bundle[j] = True
    col_of = np.full(f, -1, np.int32)
    offset_of = np.full(f, -1, np.int32)
    col_bins: List[int] = []
    c = 0
    for j in range(f):
        if not in_bundle[j]:
            col_of[j] = c
            col_bins.append(int(num_bins[j]))
            c += 1
    for b in bundles:
        off = 0
        for j in b:
            col_of[j] = c
            offset_of[j] = off
            off += int(num_bins[j])
        col_bins.append(off + 1)          # +1: the all-default value 0
        c += 1
    return BundleInfo(
        col_of=col_of, offset_of=offset_of,
        num_column_bins=np.asarray(col_bins, np.int32),
        n_columns=c, n_bundled=int(in_bundle.sum()))


def unbundle(bundled: np.ndarray, info: BundleInfo, default_bins: np.ndarray,
             num_bins: np.ndarray) -> np.ndarray:
    """Inverse of bundle_matrix: reconstruct the dense [N, F] binned
    matrix. The graceful fallback when a bundled dataset meets a learner
    configuration the bundle-space growers don't support. Exact for
    conflict-free plans; under bounded-conflict bundling, rows that lost a
    member's bin to a conflict come back at that member's default bin (the
    same information loss the reference accepts)."""
    n = bundled.shape[0]
    f = len(info.col_of)
    out = np.zeros((n, f), bundled.dtype)
    for j in range(f):
        c = info.col_of[j]
        o = int(info.offset_of[j])
        if o < 0:
            out[:, j] = bundled[:, c]
        else:
            v = bundled[:, c].astype(np.int64)
            col = np.full(n, default_bins[j], np.int64)
            in_r = (v > o) & (v <= o + int(num_bins[j]))
            col[in_r] = v[in_r] - o - 1
            out[:, j] = col.astype(bundled.dtype)
    return out


def bundle_chunk(binned: np.ndarray, info: BundleInfo,
                 default_bins: np.ndarray):
    """Re-encode one [K, F] binned chunk into ([K, n_columns] u8,
    conflict count). Row-local, so streaming construction applies it
    chunk by chunk (reference: PushOneRow per-group push,
    include/LightGBM/feature_group.h).

    Features encode in PLACEMENT order (ascending offset within each
    column) so a conflicting row keeps the FIRST-PLACED member's value,
    matching the planner's conflict accounting and the reference's drop
    order. The whole encode is batched (the construct hot path — the
    scalar loop paid ~6 full-column passes per member feature, which at
    Allstate shape is thousands of passes): passthrough columns move in
    one gather, and bundled members resolve first-writer-wins with a
    segmented ``np.minimum.reduceat`` over the placement-ordered member
    axis — the winner per (row, bundle) is the lowest-ranked member whose
    bin is off-default, exactly the scalar loop's first write."""
    n = binned.shape[0]
    out = np.zeros((n, info.n_columns), np.uint8)
    col_of = np.asarray(info.col_of)
    off_of = np.asarray(info.offset_of)
    pass_j = np.nonzero(off_of < 0)[0]
    if len(pass_j):
        out[:, col_of[pass_j]] = binned[:, pass_j]
    order = np.lexsort((off_of, col_of))
    bund = order[off_of[order] >= 0]          # placement-ordered members
    j_cnt = len(bund)
    if not j_cnt:
        return out, 0
    dflt = default_bins[bund].astype(np.int16)
    offs = off_of[bund].astype(np.int16)
    # contiguous member segments per bundle column (lexsort groups them)
    bcols = col_of[bund]
    seg_starts = np.flatnonzero(np.r_[True, bcols[1:] != bcols[:-1]])
    seg_cols = bcols[seg_starts]
    rank = np.arange(j_cnt, dtype=np.int32)
    conflicts = 0
    # row chunks bound the [R, J] intermediates (~32MB a piece)
    chunk = max(1024, (1 << 25) // j_cnt)
    for r0 in range(0, n, chunk):
        r1 = min(n, r0 + chunk)
        b = binned[r0:r1][:, bund].astype(np.int16)    # [R, J] gather
        enc = offs[None, :] + 1 + b
        emax = int(enc.max(initial=0))
        if emax > 255:
            raise ValueError("bundle exceeded u8 bin budget")
        nz = b != dflt[None, :]
        key = np.where(nz, rank[None, :], j_cnt)
        win = np.minimum.reduceat(key, seg_starts, axis=1)  # [R, n_bcols]
        has = win < j_cnt
        val = np.take_along_axis(enc, np.where(has, win, 0), axis=1)
        out[r0:r1, seg_cols] = np.where(has, val, 0).astype(np.uint8)
        conflicts += int(nz.sum()) - int(has.sum())
    return out, conflicts


def conflict_allowance(info: BundleInfo, n: int,
                       max_conflict_rate: float) -> int:
    """Full-data conflict budget: the planner allowed max_conflict_rate *
    sample rows PER bundle, so grant the same rate over n rows (x4 slack
    for sampling noise). Rate 0 is the lossless contract — ANY conflict
    must fall back to dense."""
    if max_conflict_rate <= 0:
        return 0
    n_bundle_cols = len(
        {int(c) for c, o in zip(info.col_of, info.offset_of) if o >= 0})
    return max(int(4 * max_conflict_rate * n * max(n_bundle_cols, 1)), 16)


def bundle_matrix(binned: np.ndarray, info: BundleInfo,
                  default_bins: np.ndarray,
                  max_conflict_rate: float = 1e-4) -> Optional[np.ndarray]:
    """Re-encode the dense [N, F] binned matrix into [N, n_columns], or None
    when far more conflicts appear than planned (caller keeps dense).

    Conflicting rows (two members nonzero) keep the FIRST-placed member's
    value — the planning order, matching the reference's bounded-conflict
    semantics (a conflicting row simply loses the later feature's bin,
    src/io/dataset.cpp FindGroups). With a conflict-free plan this is exact.

    (When constructing from raw columns the caller can stream feature by
    feature instead of materializing [N, F] first; this dense variant serves
    the in-memory path.)"""
    n = binned.shape[0]
    # row blocks on a thread pool, as bin_columns bins its rows
    parts = map_row_chunks(
        lambda r0, r1: bundle_chunk(binned[r0:r1], info, default_bins),
        n, binned.size)
    out = parts[0][0] if len(parts) == 1 else np.concatenate(
        [p[0] for p in parts])
    conflicts = sum(p[1] for p in parts)
    allowed = conflict_allowance(info, n, max_conflict_rate)
    if conflicts > allowed:
        return None
    if conflicts:
        log.info(f"EFB: {conflicts} conflicting rows on the full data "
                 f"(allowed {allowed})")
    return out
