#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lightgbm_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py [--rows N] [--rounds R]

Phases, each of which raises on a failed check (the script then exits
non-zero):

1. the card's name and power limit, and the build of every kernel from the
   sources in lightgbm_tpu_torch/csrc (one nvcc per source, all started
   together in the background: K1's and K2's phases wait for their own
   libraries only, then the card against the CPU on the compact path
   (8.) and A14C_CHECKS (20.) run, and K3's phase waits for the whole
   build);
2. K1, the histogram kernel, against its plain PyTorch version at the Higgs
   root shape (dense channels and packed row records) and at F=100 (feature
   chunking), with its time, the plain version's and index_add_'s; then two
   skewed record cases at the same shape, timed and bit-equal on integer
   channels: 90% of the rows in bin 0, and every row of a feature in one
   bin (each block's packed 16-bit counts flush past 65,535 rows);
3. K2, the fused split, against its plain version on a 1M-row record array
   (modes 0 and 1, aligned and unaligned starts, counts 0/1/255/to the end,
   both residency sides, NaN default-left, forced smaller child, a
   categorical bitset), then the Higgs root split (mode 0 over the whole
   array at the main path's row count), each held to the split's contract
   (the merged children equal the plain version's, rows outside the segment
   and the padding unchanged, the dead range not compared), and its time
   beside that of the smaller child's histogram alone;
4. K3, the small-bin histogram, against its plain version at the masked
   path's shape (20k x 28, B = 64, K = 3; its device time from the
   profiler) and at edge cases (N not a multiple of 16, a padded row
   stride, unaligned channels, B = 2 and 17, F = 1, 31, 32, 33, 65 and 100
   around the rotation period and the feature chunks, 1-8 channels, bf16,
   bins >= B, rows with zero channels), each on both of its paths (the
   small-data path these sizes take, and the tile path); then at 10.5M x
   28, B = 64, K = 3 on dyadic channels (bit-equal); both paths on each
   side of the row count where the host switches between them (all rows
   and an eighth live; at the switch each path's device time, the K3_PATHS
   line); then two skewed cases (90% of the rows in bin 0; every row of a
   feature in one bin) on integer channels and two sparse ones (a random
   1/8 and 1/64 of the rows live), bit-equal and timed; with its time
   beside K1's on the same data in row-major form, the plain version's and
   index_add_'s, and its byte bound;
5. the compact path: lightgbm_tpu_torch.train on Higgs-shaped data
   (make_higgs_like, 10.5M x 28 with a 10% validation split, 255 leaves,
   255 bins) for one warm-up round and R timed rounds, with the launch
   counts of its kernels K1 and K2 (> 0), the plain versions' call counts
   (0), the host syncs in each later tree (0), and a torch.profiler trace of
   one more tree (device time, idle share, launches, and K1's and K2's
   device ms in that tree beside their byte bounds from its node counts);
   then PREDICT_API on that booster: pred_contrib on 131,072 validation
   rows through the TreeSHAP kernel (wall s, device ms, launches equal in
   the trace and the wrapper, contributions summing to the raw score
   within 1e-4, the deepest path and longest unique path), the kernel
   against its plain version on 4,096 rows (1e-12 of a cell's |value| plus
   its bound on |addends|) and on all 131,072 (pred_contrib's output),
   timed beside it, with its bound (the row-dependent float64 operations
   or bytes), the card against the CPU on 1,024 rows;
   pred_leaf on the 1.05M validation rows (the CPU's on a sample; leaf
   values summed equal the raw score within 1e-5); plain prediction's
   tree-by-tree adds timed against the batched sum on MAIN's trees tiled
   to 210; pred_early_stop at
   margins 1.5 and 0.25, freq 2 (each row's score that of the window it
   stopped at, the share stopped, the CPU's on a sample, margin 1e9 the
   plain prediction); refit with decay 0.9 on the validation rows against
   the CPU's refit (leaf values within 1e-6);
6. quantized-gradient training on the same constructed datasets
   (QUANT): use_quantized_grad=True with LightGBM's defaults (4 bins,
   stochastic rounding), 1 warm-up and 2 timed rounds and a profiled tree:
   iterations/s, AUC (> 0.7) beside the f32 run's at the same round, every
   K1 and K2 launch in its quant mode, host syncs in a tree step (0), K1's
   integer variant's and K2's device ms a tree beside their byte bounds;
   then QUANT_CHECKS: K2 quant against its plain version at the root
   (mode 1 and the last tree's root split) and a grown split on the run's
   records (children byte-equal, int32 histograms exactly equal), timed
   beside K2 f32; K1's integer variant alone at the root, exactly equal,
   timed beside K1 f32, its plain version and index_add_ of int32
   channels; the reloaded model (1e-6); the card against the CPU with
   deterministic rounding (compact at 100k x 28, the masked grower's shim
   at 20k, 31 leaves, 3 rounds; 1e-4, differing splits counted);
   then UNFUSED (right after QUANT, on MAIN's datasets): the compact
   grower without the fused kernel (tpu_fused=off), 1 warm-up and 2
   timed rounds and a profiled tree in four runs: f32 at 255 bins (K1
   dense on the records' bin columns), use_quantized_grad at 255 bins (K1
   dense int8), use_quantized_grad at max_bin=63 with the sublane layout
   (K3 int8 on a feature-major copy of each segment) and
   tpu_quant_hist_bits=16 (K1 narrowed where a leaf fits it): each split
   K2's partition alone, the segment gather and the histogram, with
   iterations/s, launches and host syncs a split (0), every launch in its
   mode, the leaves that took the 16-bit engine; at each run's root the
   gather and the histogram against their plain versions (int32 exact;
   f32 bit-equal on 1/64-grid gradients, and on the run's own each within
   f32's summation bound of float64 sums; the narrowed kernel also against
   the 32-bit one),
   timed beside index_add_ and their byte bounds (UNFUSED_ROOT);
   the card against the CPU for the four runs at 100k x 28 (quantized: 0
   differing splits; f32 1e-4); then PACK4: the same rows at max_bin=15
   with tpu_bin_pack4=true, 1 warm-up and 2 timed rounds in f32 and
   quantized beside the u8 run on the same binning (quantized: equal
   trees; f32 1e-4, differing splits counted), every K2 and K1 launch on
   packed records, packed and u8 prediction equal on the validation rows,
   a profiled packed f32 tree; K2 packed4 at the root split against its
   plain version (bit-equal on 1/16-grid gradients in f32), timed beside
   K2 on the u8 records, each with its byte bound, argsort + index_select
   and the bytes it moves a row (PACK4_ROOT_SPLIT); the card against the
   CPU at 100k x 28 (PACK4_CPU_VS_CARD);
7. the masked grower at the main path's row count: the same Higgs-shaped
   rows binned at max_bin=63 (the datasets UNFUSED made) with
   tpu_grower=masked and the sublane layout
   (K3 only), 63 leaves, 1 warm-up and 2 timed rounds: iterations/s, AUC
   (> 0.7), K3's launches (> 0) and K1's and K2's (0), plain calls (0),
   host syncs in each later tree (0), and a profiled tree with K3's device ms
   beside its byte bound for that tree;
8. the card against the CPU on the compact path: the same training at
   100k x 28, 31 leaves, 3 rounds, with device_type="cuda" and "cpu";
   predictions agree within 1e-4;
9. the masked path: the training stage of the repo's serving bench
   (bench.py:769-776: make_higgs_like 20k x 28, 63 leaves, max_bin=63,
   learning rate 0.1, min_data_in_leaf 20) with 2k more rows for
   validation, tpu_hist_layout="sublane", 20 rounds: iterations/s, AUC
   (> 0.7), K3's launches (> 0) and K1's and K2's (0), the plain versions'
   calls (0), the host syncs in each later tree (0), a one-tree profile; then
   the same training on the CPU and on the card with the lane layout (K1),
   predictions within 1e-4, and save_model -> Booster(model_file=...) ->
   predict within 1e-6, and a profiled tree with K3's device ms beside its
   byte bound;
10. the masked grower with multiclass and categorical splits: the same 20k
   rows with the multiclass label and categorical columns, max_bin=63, 63
   leaves, sublane, 4 rounds: iterations/s, K3's launches (> 0) and K1's
   and K2's (0), host syncs in each later tree (0); save_model ->
   Booster(model_file=...) -> predict (1e-6); the card against the CPU
   held within 1e-4 at 3 rounds on weighted rows, beside a CPU control
   that nudges the row weights by 1e-6 and agrees there; one
   objective=regression run with the categorical
   columns on the card against the CPU (1e-4);
11. the multiclass compact path at the main path's row count: the same
   Higgs-shaped rows with a 5-class label cut from the generator's logits
   and five categorical columns (four of 32 codes for the sorted scan, one
   of 3 for the one-hot scan; make_higgs_multiclass_like),
   objective=multiclass, 255 leaves, 255 bins, 1 warm-up and 1 timed
   round (5 trees a round): iterations/s and trees/s, validation
   multi_logloss (below ln 5) and multi_error, K1's and K2's launches (> 0),
   K3's (0), plain calls (0), host syncs in each later tree (0), one-hot and
   sorted categorical splits (each > 0), the record's width; K2 on a
   sorted categorical split of the grown trees (its 8-word bitset) over the
   whole wider record array against its plain version, timed; a profiled
   tree with K1's and K2's device ms beside their byte bounds; and the
   card against the CPU at 70k rows, 31 leaves, 1 round, on weighted rows
   (tie_free_weights: every class probability within 1e-4);
12. Exclusive Feature Bundling on the compact grower at the Allstate shape
   of the repo's sparse benchmark (make_allstate_like, 500k x 4228 one-hot
   columns in blocks of 8, a 10% validation split; the parameters of
   bench.py:1185-1200 with BENCH_SPARSE=1: 255 leaves, 255 bins,
   min_data_in_leaf 100, bin_construct_sample_cnt 20,000, default
   enable_bundle), 1 warm-up and 2 timed rounds (EFB line: construct s and
   its planning part, bundled features and stored columns, record bytes,
   iterations/s, AUC above chance, K1's and K2's launches (> 0), K3's (0),
   plain calls (0), host syncs in each later tree (0), and a profiled tree
   with K1's and K2's device ms beside their byte bounds); then
   (EFB_CHECKS) K2's copy-back variant against its plain version and
   against its dual variant on the bundled records at the first tree's
   root split and at its first grown split (integer grad and hess: arrays
   byte-equal, histograms bit-equal), both variants timed at the root
   beside the root's smaller-child histogram alone (the rest of each is its
   partition); K1 on the wide records against its plain version
   (bit-equal), timed beside index_add_; the saved and reloaded model within 1e-6; and the card against the CPU on
   a narrower one-hot shape (50k x 320 plus 4 dense columns, 31 leaves, 2
   rounds) within 1e-4; and K2's quant mode in copy-back at the bundled
   root split against its plain version (byte-equal, int32 exact), timed
   (EFB_CHECKS' quant_copy_back, the bundled part of QUANT_CHECKS);
13. leaf renewal (RENEW, run right after QUANT, on MAIN's datasets
   with the generator's logits as the label): objective=quantile, alpha
   0.9, 255 leaves, 1 warm-up and 2 timed rounds and a profiled tree:
   iterations/s, the validation quantile loss (it falls), K1's and K2's
   launches (> 0), plain calls (0), host syncs in a tree step (0), the
   renewal's device ms and launches a tree; then RENEW_CHECKS: the card
   against the CPU for regression_l1, quantile and mape on the compact
   grower (100k x 28) and the masked grower (20k x 28), 31 leaves, 2
   rounds (1e-4, differing splits counted);
14. learning to rank (RANK, run right after RENEW) at the repo's MS-LTR
   configuration (make_msltr_like, 2.27M x 137, 120 documents a query,
   graded labels 0-4, 10% of the queries held out whole; bench.py:1005-1017:
   lambdarank, ndcg@10, 255 leaves, 255 bins, learning rate 0.1,
   min_data_in_leaf 50), 1 warm-up and 2 timed rounds and a profiled tree:
   construct s, record bytes, iterations/s, validation ndcg@10 before the
   first tree and after the last round (it rises), the compact grower, K1's
   and K2's launches (> 0), K3's (0), plain calls (0), host syncs in a
   tree step (0), the lambdarank gradient's device ms and launches in an
   iteration, K1's and K2's device ms a tree beside their byte bounds; then
   RANK_CHECKS: K2 (mode 1 and the first tree's root split) and K1 at the
   root on the run's 256-byte records against their plain versions (on the
   run's gradients within hist_close, on dyadic channels bit-equal),
   timed beside stable argsort + index_select and index_add_; the
   reloaded model (1e-6); the card against the CPU for lambdarank on the
   compact grower (tpu_grower=compact, 35k rows, 292 queries), rank_xendcg
   (the same draws on both) and lambdarank with positions on the masked
   grower (10k rows), 31 leaves, 2 rounds, one binned Dataset a case
   (1e-4, differing splits counted);
15. the tuned training loop (TUNED, run right after RENEW on MAIN's
   datasets with their binary labels): the compact path's parameters with
   LightGBM's examples/binary_classification/train.conf sampling
   (feature_fraction 0.8, bagging_fraction 0.8, bagging_freq 5),
   feature_fraction_bynode 0.8, early_stopping_round 50 and a
   reset_parameter learning-rate schedule, 1 warm-up and 5 timed rounds
   (reused bags, then a fresh draw) and a profiled tree: iterations/s, AUC
   (> 0.7), the compact grower, K1's and K2's launches (> 0), K3's (0),
   plain calls (0), host syncs in the tree step (the gradients and bag,
   the by-node draws and the grower: 0), the bag draw's and the by-node
   draws' ms, the in-bag share, K1's and K2's device ms a tree beside their byte bounds
   (raw rows); then TUNED_CHECKS: K2 (mode 1 and a reused-bag tree's root
   split) and K1 at the root on the run's bagged records against their
   plain versions (records byte-equal, in-bag and raw counts exact, in-bag
   below raw; grad and hess bit-equal on dyadic records and, for K1, within
   f32's summation error on the run's own gradients), timed beside
   argsort + index_select and index_add_; GOSS's
   selection at the run's row count on the card against the CPU, row for
   row, timed; the card against the CPU with the same draws for uniform,
   balanced (lane and, K3 on a bagged mask, sublane) and by-query bagging,
   GOSS, feature_fraction with
   feature_fraction_bynode on both growers and bagged quantized renewal
   (100k x 28 compact, 20k x 28 masked, 31 leaves, 2-3 rounds, GOSS 4;
   1e-4, differing splits counted); early stopping at the same best iteration on both; a custom
   objective (hand-written logloss) against the built-in binary without
   boost-from-average (1e-4); init_model, card against CPU (1e-4), its
   5-tree text reloaded (1e-6); a rollback's validation scores against
   the 2-round model (1e-5);
16. monotone and interaction constraints (CONSTRAINED, run right after
   TUNED on MAIN's datasets with their binary labels): MAIN's parameters
   with monotone_constraints (the sign of the generator's w1 on the 8
   features with the largest |w1|), monotone_constraints_method
   intermediate and four interaction groups of 7 features, 1 warm-up and
   3 timed rounds and a profiled tree: iterations/s beside MAIN's,
   launches a split, the walk kernel's launches (one a split) and device
   ms a tree, the batched rescans' device ms and launches a tree (their
   profiler ranges), the flagged leaves a tree (> 0), K1's and
   K2's launches (> 0), plain calls (0), host syncs in the tree step (0);
   the walk kernel against its plain version on every split's state of
   one more tree (flags and bounds equal), timed; a sweep of each
   constrained feature over its bin bounds on 1,000 validation rows (no
   prediction moves against the direction); then CONSTRAINED_CHECKS: the
   card against the CPU on weighted rows for basic monotone on both
   growers, intermediate, monotone_penalty, interaction constraints on
   both growers, path_smooth, extra trees (numpy's words on both),
   feature_contri, CEGB split and coupled on the compact grower, and lazy
   CEGB on the masked grower with the sublane layout (K3); 100k x 28
   compact, 20k x 28 masked, 15 leaves, 2 rounds (1e-4, 0 differing
   splits);
17. DART (run right after CONSTRAINED on MAIN's datasets): MAIN's
   parameters with boosting=dart and LightGBM's DART defaults but
   skip_drop=0 (drop_rate 0.1, max_drop 50, drop_seed 4), 1 warm-up and 5
   timed rounds: iterations/s beside MAIN's, the trees dropped in each
   round (some round drops), the compact grower, K1's and K2's launches
   (> 0), K3's (0), plain calls (0), host syncs in the tree step (0) and in
   the drop routing and its uploads (reported); a profiled round with
   the drop and normalise routing's device ms and launches (the profiler
   ranges dart_drop and dart_normalize) and K1's and K2's device ms
   beside their byte bounds; the reloaded model (1e-6);
18. random forest (RF): the same datasets, boosting=rf with
   bagging_fraction 0.632, bagging_freq 1, feature_fraction 0.8, 255
   leaves, 1 warm-up and 3 timed rounds on the masked grower (K1 dense,
   the lane layout of tpu_hist_layout=auto at 255 bins; one launch a
   leaf): iterations/s, validation AUC (> 0.7), K2's and K3's launches
   (0), plain calls (0), host syncs in the grower (0), a profiled tree
   with K1's device ms beside its byte bound, average_output in the saved
   text and the reloaded model (1e-6);
19. max_bin above 255 (WIDE_BINS, right after RF): the same rows binned
   at max_bin=1023 (uint16 bins on the host, an int16 view on the card, no
   EFB), MAIN's other parameters, 1 warm-up and 2 timed rounds on the
   masked grower with the lane layout (K1's wide-bin kernel, once for the
   root and once a split, no other kernel): iterations/s beside MAIN's,
   AUC (> 0.7), plain calls (0), host syncs in the grower (0), a profiled
   tree (K1's device ms beside its byte bound, the profiler's launches
   equal to the wrapper's); K1 16-bit at the root (9.45M rows, B = 1,024)
   against its plain version (bit-equal on 1/64-grid gradients; on the
   run's own within (m - 1) 2^-24 of float64 sums), timed beside
   index_add_ and its byte bound, and on synthetic bins at B = 1,024, 4,096
   and 40,000 (bins from 32,768 up; bit-equal); pred_leaf against the
   CPU's; pred_contrib on 4,096 validation rows through the 16-bit
   TreeSHAP kernel against its plain version (1e-12 of a cell's scale),
   timed beside its operations bound; the reloaded model (1e-6) and its
   dump_model equal to the booster's in the fields a loaded model holds;
   the card against the CPU at 100k x 28, 31 leaves, 3 rounds, on
   weighted rows (0 differing splits, 1e-4);
20. A14C_CHECKS: the card against the CPU on weighted rows
   (tie_free_weights), 15 leaves, 3 rounds: DART on the compact grower
   (70k x 28, drop_rate 0.5, the same drops on both), DART, RF (numpy's
   bags on both), forced splits (their first splits checked) and linear
   leaves (a regression on 20k rows, a tenth of two columns NaN,
   gradients on a 1/64 grid; the fit's host seconds a tree) on the masked
   grower (1e-4, 0 differing splits);
21. TRACE_CHECK (last): the profiler's raw events, which every profiled
   number above reads, against torch's public prof.events() on a small
   trace (the same kernels, calls and launches).

Each profiled tree must hold as many launches of each kernel as its wrapper
counted in that round; a short trace is repeated. The line before the last
is the card's name and power limit, the one before it a JSON object with
every kernel's launches, error, times and bound; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
RECORD_ROW_BYTES = 64          # bins + channels: two 32-byte sectors a row


def make_higgs_like(n, f, seed=7, with_logits=False, with_w1=False):
    """Dense float features + nonlinear binary target (Higgs-shaped); with
    ``with_logits`` also the logits the target is cut from, with
    ``with_w1`` also the linear part's weights (last)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    w1 = rng.randn(f) / np.sqrt(f)
    w2 = rng.randn(f) / np.sqrt(f)
    logits = X @ w1 + 0.7 * np.abs(X @ w2) - 0.4 + 0.5 * rng.randn(n)
    y = (logits > 0).astype(np.float64)
    out = (X, y, logits) if with_logits else (X, y)
    return out + (w1,) if with_w1 else out


# the multiclass case's categorical columns: four cut into 32 quantile codes
# (the sorted scan) and one into 3 (the one-hot scan: 3 categories and the
# missing bin make 4 bins, max_cat_to_onehot's default)
MC_SORTED_COLS = (0, 1, 2, 3)
MC_ONEHOT_COL = 4
MC_CATS = list(MC_SORTED_COLS) + [MC_ONEHOT_COL]
MC_CLASSES = 5
MC_PARAMS = {"objective": "multiclass", "num_class": MC_CLASSES,
             "metric": "multi_logloss,multi_error", "num_leaves": 255,
             "max_bin": 255, "learning_rate": 0.1, "min_data_in_leaf": 100,
             "verbosity": -1}


def make_allstate_like(n, f, card=8, seed=7):
    """Sparse one-hot blocks of ``card`` columns (the Allstate F = 4228
    shape of the repo's sparse benchmark, copied from bench.py:265-282,
    which imports JAX): every row has one hot column a block, the label a
    thresholded sum of per-column weights. Made block by block, with no
    dense float64 intermediate."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, f), np.float32)
    logits = 0.5 * rng.randn(n)
    off = 0
    while off < f:
        w = min(card, f - off)           # the remainder is a smaller block
        cats = rng.randint(0, w, size=n)
        X[np.arange(n), off + cats] = 1.0
        wg = rng.randn(w) * 0.3
        logits += wg[cats]
        off += w
    y = (logits > 0).astype(np.float64)
    return X, y


def make_higgs_multiclass_like(X, logits, seed=7):
    """The repo's own multiclass-and-categorical case
    (scripts/gen_interop_goldens.py:52-66) on Higgs-shaped rows: a 5-class
    label cut from the generator's logits at their 20/40/60/80% quantiles;
    columns 0-3 become 32 quantile codes and column 4 three, each mapped
    through a fixed permutation from the seed so that code order does not
    follow the target. Rewrites ``X`` in place; returns ``(X, y)``."""
    rng = np.random.RandomState(seed + 1)
    y = np.digitize(logits, np.quantile(logits, [0.2, 0.4, 0.6, 0.8]))
    for j, k in [(c, 32) for c in MC_SORTED_COLS] + [(MC_ONEHOT_COL, 3)]:
        edges = np.quantile(X[:, j], np.linspace(0, 1, k + 1)[1:-1])
        X[:, j] = rng.permutation(k)[np.searchsorted(edges, X[:, j])]
    return X, y.astype(np.float64)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def time_ms(fn, reps=10, warm=2):
    """Mean milliseconds of fn() on the card (CUDA events around reps)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def hist_close(kern, plain, abs_hist, what, rel=1e-5):
    """Counts (channels 2, 3) exact; grad/hess within rel * sum|addends| per
    bin (f32 atomics add in another order; rel = 0 asks for equality).
    Returns the max abs error."""
    err = (kern - plain).abs()
    check(torch.equal(kern[..., 2:], plain[..., 2:]),
          f"{what}: count channels differ")
    if rel == 0:
        check(torch.equal(kern, plain), f"{what}: grad/hess differ")
    else:
        tol = rel * abs_hist[..., :2] + 1e-30
        worst = float((err[..., :2] / tol).max())
        check(worst <= 1.0, f"{what}: grad/hess error {worst:.3g}x "
              "tolerance")
    return float(err.max())


def close_rel(kern, plain, abs_hist, what, rel):
    """Every cell within rel * sum|addends| (rel = 0: bit-equal). Returns
    the max abs error."""
    if rel == 0:
        check(torch.equal(kern, plain), f"{what}: differs from the plain "
              "version")
    else:
        err = (kern - plain).abs()
        worst = float((err / (rel * abs_hist + 1e-30)).max())
        check(worst <= 1.0, f"{what}: error {worst:.3g}x tolerance")
    return float((kern - plain).abs().max())


# a compact tree step: the iteration's gradients, bag and quantized codes,
# then the tree
COMPACT_STEP = ["_begin_compact_iter", "_grow_compact"]


@contextlib.contextmanager
def count_syncs(owner, names, out):
    """Count the host syncs (torch's sync debug mode) inside every call of
    the functions ``names`` of ``owner`` after each one's first call: per
    name into ``out[name]``, all together into ``out["in_tree"]``, and the
    calls made into ``out["calls"]``."""
    orig = {name: getattr(owner, name) for name in names}
    calls = {name: 0 for name in names}

    def counted(name):
        fn = orig[name]

        def run(*a, **kw):
            calls[name] += 1
            if calls[name] == 1:
                return fn(*a, **kw)
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    res = fn(*a, **kw)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            n = sum("called a synchronizing" in str(w.message)
                    for w in caught)
            out[name] = out.get(name, 0) + n
            out["in_tree"] = out.get("in_tree", 0) + n
            return res
        return run
    for name in names:
        setattr(owner, name, counted(name))
    try:
        yield
    finally:
        for name in names:
            setattr(owner, name, orig[name])
    out["calls"] = calls


def shared_datasets(lgt):
    """One binned Dataset per (rows, max_bin, query groups) for the card
    and the CPU runs of a check's cases: binning is host work that no
    option of these cases changes."""
    cache = {}

    def get(X, y, max_bin=255, group=None, **kw):
        key = (len(X), max_bin, group is not None)
        if key not in cache:
            cache[key] = lgt.Dataset(X, y, group=group,
                                     params={"max_bin": max_bin}, **kw)
        return cache[key]
    return get


def compare_boosters(a, b, X):
    """(max |prediction difference|, splits that differ) of two boosters
    with the same trees."""
    differ = 0
    for ta, tb in zip(a._gbdt.models, b._gbdt.models):
        differ += int(((ta.split_feature != tb.split_feature)
                       | (ta.split_bin != tb.split_bin)
                       | (ta.default_left != tb.default_left)).sum())
    return float(np.abs(a.predict(X) - b.predict(X)).max()), differ


def phase_kernels_k1(n, results):
    """K1 against its plain version. At the Higgs root shape (n rows, 40k a
    bin) the channels are dyadic (multiples of 1/64, |value| <= 2): every
    partial sum of a bin is exact in f32, so kernel and plain version must
    agree bit for bit whatever the order of their atomics. At 1M rows the
    channels are random floats and grad/hess agree within 1e-5 * sum
    |addends| (about sqrt(4k) roundings of 2^-24 a bin)."""
    from lightgbm_tpu_torch.ops.compact import (RowLayout, pack_rows,
                                                record_channels)
    from lightgbm_tpu_torch.ops.pallas_histogram import (
        pallas_histogram, pallas_histogram_plain, record_histogram,
        record_histogram_plain)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1)
    B, K = 256, 4
    worst = [0.0]

    def channels(rows, dyadic):
        if dyadic == "int":
            # integers: every partial sum of a bin that holds all the rows
            # stays below 2^24 and is exact in f32
            gr = torch.randint(-1, 2, (rows,), generator=g,
                               device=dev).float()
            he = torch.randint(0, 2, (rows,), generator=g, device=dev).float()
        elif dyadic:
            gr = torch.randint(-128, 129, (rows,), generator=g,
                               device=dev) / 64.0
            he = torch.randint(0, 129, (rows,), generator=g,
                               device=dev) / 64.0
        else:
            gr = torch.randn(rows, generator=g, device=dev)
            he = torch.rand(rows, generator=g, device=dev)
        cnt = (torch.rand(rows, generator=g, device=dev) > 0.1).float()
        return gr, he, cnt

    def dense_case(rows, F, mode, dyadic, timed=False):
        bins = torch.randint(0, B, (rows, F), generator=g, device=dev,
                             dtype=torch.uint8)
        gr, he, cnt = channels(rows, dyadic)
        ch = torch.stack([gr, he, cnt, torch.ones_like(gr)], 1).contiguous()
        kern = pallas_histogram(bins, ch, B, mode=mode)
        plain = pallas_histogram_plain(bins, ch, B, mode=mode)
        absh = pallas_histogram_plain(bins, ch.abs(), B, mode=mode)
        err = hist_close(kern, plain, absh, f"K1 dense F={F} {mode}",
                         0 if dyadic else 1e-5)
        worst[0] = max(worst[0], err)
        line = {"rows": rows, "F": F, "mode": mode, "dyadic": dyadic,
                "max_abs_err": err}
        if timed:
            flat = (bins.to(torch.int64)
                    + torch.arange(F, device=dev) * B).reshape(-1)
            src = ch[:, None, :].expand(rows, F, K).reshape(-1, K)
            lib_out = torch.zeros(F * B, K, device=dev)

            def lib():
                lib_out.zero_()
                lib_out.index_add_(0, flat, src)
            line["kernel_ms"] = time_ms(
                lambda: pallas_histogram(bins, ch, B, mode=mode))
            line["plain_ms"] = time_ms(
                lambda: pallas_histogram_plain(bins, ch, B, mode=mode), 3, 1)
            line["library_ms"] = time_ms(lib, 3, 1)
            # the same rows with one channel instead of four: a time that
            # falls with the channel count is bound by the shared-memory
            # atomics (one per channel), not by the bins read
            ch1 = ch[:, :1].contiguous()
            line["one_channel_ms"] = time_ms(
                lambda: pallas_histogram(bins, ch1, B, mode="f32"))
            line["bound_ms"] = 1e3 * (rows * (F + 4 * K) + F * B * K * 4) \
                / HBM_BYTES_PER_S
            del flat, src, lib_out
        print("K1", json.dumps(line), flush=True)
        return line

    def record_case(rows, F, dyadic, timed=False, skew=None):
        """Record mode: the rows the fused split streams, read in place.
        skew "bin0_90": 90% of the rows in bin 0; "one_bin": every row of a
        feature in one bin (a block's count cells pass 65,535 rows)."""
        layout = RowLayout(num_features=F, num_extra=4)
        bins = torch.randint(0, B, (rows, F), generator=g, device=dev,
                             dtype=torch.uint8)
        if skew == "bin0_90":
            bins[torch.rand(rows, F, generator=g, device=dev) < 0.9] = 0
        elif skew == "one_bin":
            bins[:] = (torch.arange(F, device=dev) * 37 % B).to(torch.uint8)
        gr, he, cnt = channels(rows, dyadic)
        extras = torch.randn(4, rows, generator=g, device=dev)
        work = pack_rows(bins, gr, he, cnt, extras, layout)
        scratch = torch.zeros_like(work)
        wabs = pack_rows(bins, gr.abs(), he, cnt, extras, layout)
        del bins, extras
        seg = torch.tensor([0, rows, 0], dtype=torch.int32, device=dev)
        kern = record_histogram(work, scratch, seg, layout, B)
        plain = record_histogram_plain(work, scratch, seg, layout, B)
        absh = record_histogram_plain(wabs, scratch, seg, layout, B)
        del wabs
        err = hist_close(kern, plain, absh, f"K1 records F={F} {skew}",
                         0 if dyadic else 1e-5)
        worst[0] = max(worst[0], err)
        line = {"rows": rows, "F": F, "mode": "records", "dyadic": dyadic,
                "max_abs_err": err}
        if skew:
            line["skew"] = skew
            line["kernel_ms"] = time_ms(lambda: record_histogram(
                work, scratch, seg, layout, B))
        elif timed:
            line["kernel_ms"] = time_ms(lambda: record_histogram(
                work, scratch, seg, layout, B))
            line["plain_ms"] = time_ms(lambda: record_histogram_plain(
                work, scratch, seg, layout, B), 3, 1)
            line["bound_ms"] = 1e3 * (rows * RECORD_ROW_BYTES
                                      + F * B * 16) / HBM_BYTES_PER_S
            # index_add_ of the same rows' channels on a flat index
            # precomputed from the records, as for the dense mode
            flat = (work[:, :F].to(torch.int64)
                    + torch.arange(F, device=dev) * B).reshape(-1)
            src = record_channels(work, layout)[:, None, :].expand(
                rows, F, 4).reshape(-1, 4)
            lib_out = torch.zeros(F * B, 4, device=dev)

            def lib():
                lib_out.zero_()
                lib_out.index_add_(0, flat, src)
            line["library_ms"] = time_ms(lib, 3, 1)
            del flat, src, lib_out
        print("K1", json.dumps(line), flush=True)
        return line

    dense = dense_case(n, 28, "split", True, timed=True)
    dense_case(1 << 20, 28, "split", False)
    dense_case(1 << 20, 28, "bf16", False)
    dense_case(1 << 20, 100, "f32", False)
    record_case(1 << 20, 29, False)      # grad_off = 29: unaligned floats
    rec = record_case(n, 28, True, timed=True)
    skewed = [record_case(n, 28, "int", skew=k)
              for k in ("bin0_90", "one_bin")]
    results["histogram"] = dict(rec, max_abs_err=worst[0], dense=dense,
                                skewed_ms=[c["kernel_ms"] for c in skewed])


def check_split(kern, plain, before, start, count, n_left, side, layout,
                what):
    """K2's contract, held against its plain version: the merged children
    (left in the parent's array at [start, start + n_left), right in the
    other array at [start + n_left, start + count)) equal; rows outside the
    segment untouched in both arrays; the padding past the moved vectors
    unchanged. The other array's left range is dead and not compared.
    Each of kern, plain, before is (work, scratch)."""
    def parts(arrays):
        par, oth = (arrays[1], arrays[0]) if side else arrays
        return par, oth
    (kp, ko), (pp, po), (bp, bo) = (parts(a) for a in (kern, plain, before))
    s, c, nl = start, count, n_left
    check(torch.equal(kp[s:s + nl], pp[s:s + nl])
          and torch.equal(ko[s + nl:s + c], po[s + nl:s + c]),
          f"{what}: children differ from the plain version")
    for k, b in ((kp, bp), (ko, bo)):
        check(torch.equal(k[:s], b[:s]) and torch.equal(k[s + c:], b[s + c:]),
              f"{what}: rows outside the segment changed")
        check(torch.equal(k[:, layout.moved_cols:],
                          b[:, layout.moved_cols:]),
              f"{what}: padding bytes changed")


def abs_grad(arr, layout):
    """A copy of a record array with |grad| in the grad column: its
    histograms give each cell's sum of |addends|."""
    out = arr.clone()
    gcol = out[:, layout.grad_off:layout.grad_off + 4].contiguous()
    out[:, layout.grad_off:layout.grad_off + 4] = gcol.view(
        torch.float32).abs().view(torch.uint8)
    return out


def phase_kernels_k2(n_big, results):
    from lightgbm_tpu_torch.ops.compact import RowLayout, pack_rows
    from lightgbm_tpu_torch.ops.fused_split import (fused_split,
                                                    fused_split_plain)
    from lightgbm_tpu_torch.ops.pallas_histogram import record_histogram
    from lightgbm_tpu_torch.ops.split import go_left_pred
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    B, F = 256, 28
    layout = RowLayout(num_features=F, num_extra=4)

    def records(n, dyadic=False):
        bins = torch.randint(0, B, (n, F), generator=g, device=dev,
                             dtype=torch.uint8)
        if dyadic:
            gr = torch.randint(-128, 129, (n,), generator=g,
                               device=dev) / 64.0
            he = torch.randint(0, 129, (n,), generator=g, device=dev) / 64.0
        else:
            gr = torch.randn(n, generator=g, device=dev)
            he = torch.rand(n, generator=g, device=dev)
        cnt = (torch.rand(n, generator=g, device=dev) > 0.1).float()
        extras = torch.randn(4, n, generator=g, device=dev)
        return pack_rows(bins, gr, he, cnt, extras, layout)

    n = 1 << 20
    base = records(n)
    garbage = torch.randint(0, 256, base.shape, generator=g, device=dev,
                            dtype=torch.uint8)
    bits = torch.zeros(8, dtype=torch.int32, device=dev)
    for cat in (3, 17, 100, 255):
        bits[cat // 32] |= 1 << (cat % 32)
    cases = [
        dict(mode=1, start=37, count=n - 100),
        dict(mode=0, start=0, count=n, feat=2, bin_=100),
        dict(mode=0, start=12345, count=n - 12345, feat=5, bin_=40),
        dict(mode=0, start=4096, count=0, feat=1, bin_=10),
        dict(mode=0, start=777, count=1, feat=1, bin_=200),
        dict(mode=0, start=1001, count=255, feat=3, bin_=128, side=1),
        dict(mode=0, start=500, count=300000, feat=7, bin_=90, side=1),
        dict(mode=0, start=64, count=200000, feat=4, bin_=20, dl=1,
             nan_bin=255),
        dict(mode=0, start=99, count=150000, feat=6, bin_=60, smaller=1),
        dict(mode=0, start=99, count=150000, feat=6, bin_=200, smaller=0),
        dict(mode=0, start=333, count=400000, feat=9, bin_=0, is_cat=1),
    ]
    worst = 0.0
    for c in cases:
        side = c.get("side", 0)
        w0 = garbage.clone() if side else base.clone()
        s0 = base.clone() if side else garbage.clone()
        src = s0 if side else w0
        s, cnt = c["start"], c["count"]
        col = src[s:s + cnt, c.get("feat", 0)]
        gl = go_left_pred(col, c.get("bin_", 0), bool(c.get("dl", 0)),
                          c.get("nan_bin", 0), bool(c.get("is_cat", 0)),
                          bits)
        n_left = int(gl.sum())
        args = (c["mode"], s, cnt, n_left, c.get("feat", 0), c.get("bin_", 0),
                c.get("dl", 0), c.get("nan_bin", 0), c.get("is_cat", 0),
                bits, layout, B)
        kw = dict(smaller_left=c.get("smaller"), side=side)
        wk, sk = w0.clone(), s0.clone()
        _, _, hk = fused_split(wk, sk, *args, **kw)
        wp, spl = w0.clone(), s0.clone()
        _, _, hp = fused_split_plain(wp, spl, *args, **kw)
        check_split((wk, sk), (wp, spl), (w0, s0), s, cnt,
                    n_left if c["mode"] == 0 else cnt, side, layout,
                    f"K2 {c}")
        # the same split of the same rows with |grad| gives sum|addends|
        _, _, habs = fused_split_plain(abs_grad(w0, layout),
                                       abs_grad(s0, layout), *args, **kw)
        worst = max(worst, hist_close(hk, hp, habs, f"K2 {c}"))
        print("K2 ok", json.dumps(c), "n_left", n_left, flush=True)
    del base, garbage

    # the Higgs root split at the main path's size: mode 0 over the whole
    # array against the plain version. The channels are dyadic (multiples
    # of 1/64, |value| <= 2), so every partial sum of a bin is exact in f32
    # and the histograms must agree bit for bit
    work = records(n_big, dyadic=True)
    scratch = torch.zeros_like(work)
    gl = work[:, 0] <= 127
    n_left = int(gl.sum())
    n_small = min(n_left, n_big - n_left)
    args = (0, 0, n_big, n_left, 0, 127, 0, 0, 0, None, layout, B)
    wk, sk = work.clone(), scratch.clone()
    _, _, hk = fused_split(wk, sk, *args, side=0)
    wp, spl = work.clone(), scratch.clone()
    _, _, hp = fused_split_plain(wp, spl, *args, side=0)
    check_split((wk, sk), (wp, spl), (work, scratch), 0, n_big, n_left, 0,
                layout, f"K2 root split of {n_big} rows")
    worst = max(worst, hist_close(hk, hp, hp, f"K2 root split {n_big}", 0))
    print("K2 ok root split", n_big, "rows, n_left", n_left, flush=True)
    del wk, sk, wp, spl, hk, hp

    # timing at the same split. The calls alternate sides, so each one
    # partitions what the one before left in the other array: as many rows,
    # moved the same way (the contents no longer match n_left; the kernel
    # drops the surplus right rows, as its defence does)
    calls = [0]

    def alternating(fn):
        def run():
            fn(work, scratch, *args, side=calls[0] % 2)
            calls[0] += 1
        return run

    def library():
        perm = torch.argsort(gl.to(torch.uint8), stable=True)
        torch.index_select(work, 0, perm, out=scratch)

    # the smaller child's histogram alone (K1 in record mode), the part
    # of the fused split that is not the partition
    hs = 0 if n_left <= n_big - n_left else n_left
    seg = torch.tensor([hs, n_small, 0], dtype=torch.int32, device=dev)
    results["fused_split"] = {
        "rows": n_big, "n_left": n_left, "max_abs_err": worst,
        "kernel_ms": time_ms(alternating(fused_split)),
        "plain_ms": time_ms(alternating(fused_split_plain), 4, 2),
        "library_ms": time_ms(library, 4, 2),
        "child_hist_ms": time_ms(lambda: record_histogram(
            work, scratch, seg, layout, B)),
        # the bytes the work needs: each parent row's real columns read and
        # written once, the smaller child's bins and channels read once
        "bound_ms": 1e3 * (2 * n_big * layout.num_real_cols
                           + n_small * RECORD_ROW_BYTES) / HBM_BYTES_PER_S,
        # the same with whole 128-byte records, as the bound was stated
        # before the partition moved only the real columns
        "whole_record_bound_ms": 1e3 * (2 * n_big * layout.num_cols
                                        + n_small * RECORD_ROW_BYTES)
        / HBM_BYTES_PER_S}
    f = results["fused_split"]
    f["partition_ms"] = f["kernel_ms"] - f["child_hist_ms"]
    print("K2", json.dumps(f), flush=True)
    del work, scratch


def phase_kernels_k3(n_big, results):
    """K3 against its plain version. Random channels agree within 1e-5 *
    sum|addends| a cell; at 10.5M rows the channels are dyadic (multiples of
    1/64; grad in [-2, 2], hess in [0, 1]): every partial sum of a bin stays
    below 2^18 and is exact in f32, so kernel and plain version must agree
    bit for bit whatever the order of their atomics."""
    from lightgbm_tpu_torch.ops.pallas_histogram import (
        _launch_sublane, pallas_histogram, pallas_histogram_sublane,
        pallas_histogram_sublane_plain, sublane_tile_geometry)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0

    def channels(n, k, dyadic=False):
        if dyadic == "int":
            # integers: a bin that holds every row still sums exactly
            gr = torch.randint(-1, 2, (n,), generator=g, device=dev).float()
            he = torch.randint(0, 2, (n,), generator=g, device=dev).float()
        elif dyadic:
            gr = torch.randint(-128, 129, (n,), generator=g, device=dev) / 64.
            he = torch.randint(0, 65, (n,), generator=g, device=dev) / 64.
        else:
            gr = torch.randn(n, generator=g, device=dev)
            he = torch.rand(n, generator=g, device=dev)
        cnt = (torch.rand(n, generator=g, device=dev) > 0.1).float()
        cols = [gr, he, cnt, torch.ones_like(gr)]
        cols += [torch.randn(n, generator=g, device=dev)
                 for _ in range(k - 4)]
        return torch.stack(cols[:k], 1).contiguous()

    # (rows, F, B, K, mode, row-stride pad, bins past B): the masked path's
    # shape, then the edges
    cases = [(20_000, 28, 64, 3, "f32", 0, 0), (20_000, 28, 64, 3, "f32", 0, 3),
             (5_000, 5, 17, 1, "f32", 0, 2), (4_999, 1, 2, 4, "split", 8, 2),
             (20_000, 28, 63, 4, "bf16", 0, 1), (777, 100, 64, 8, "f32", 5, 0),
             (33, 28, 64, 3, "f32", 0, 0),
             # around the rotation period (32 columns) and the feature
             # chunks (at most 32 features a chunk)
             (20_000, 31, 64, 3, "f32", 0, 1),
             (20_000, 32, 64, 3, "f32", 0, 0),
             (20_001, 33, 64, 3, "f32", 0, 0),
             (20_000, 65, 64, 5, "f32", 16, 1)]
    path = None
    for n, F, B, K, mode, pad, over in cases:
        bins = torch.randint(0, B + over, (F, n + pad), generator=g,
                             device=dev, dtype=torch.uint8)[:, :n]
        # past the path's own case, the channels start one row into their
        # allocation: unaligned for 16-byte loads unless 4 divides K
        ch = channels(n + 1, K)[0 if path is None else 1:][:n]
        ch[::3] = 0.0          # rows outside the leaf: skipped
        kern = pallas_histogram_sublane(bins, ch, B, mode)
        plain = pallas_histogram_sublane_plain(bins, ch, B, mode)
        absh = pallas_histogram_sublane_plain(bins, ch.abs(), B, mode)
        err = close_rel(kern, plain, absh, f"K3 {n}x{F} B={B} K={K} {mode}",
                        1e-5)
        # these sizes take the small-data path; the tile path on the same
        # inputs
        tile = _launch_sublane(bins, ch, B, mode, sublane_tile_geometry(
            n, F, B, K, sms))
        err = max(err, close_rel(tile, plain, absh, f"K3 tile path "
                                 f"{n}x{F} B={B} K={K} {mode}", 1e-5))
        worst = max(worst, err)
        line = {"rows": n, "F": F, "B": B, "K": K, "mode": mode,
                "row_pad": pad, "bins_past_B": over, "max_abs_err": err}
        if path is None:
            # the masked path's own shape: launch latency binds it
            line["kernel_ms"] = time_ms(
                lambda: pallas_histogram_sublane(bins, ch, B, mode), 50, 5)
            line["device_us"] = device_us(
                lambda: pallas_histogram_sublane(bins, ch, B, mode),
                "hist_sublane")
            line["bound_ms"] = 1e3 * (n * F + 4 * n * K + F * B * K * 4) \
                / HBM_BYTES_PER_S
            path = line
        print("K3", json.dumps(line), flush=True)

    # the kernel probe: 10.5M x 28, B = 64, K = 3
    n, F, B, K = n_big, 28, 64, 3
    bins_t = torch.randint(0, B, (F, n), generator=g, device=dev,
                           dtype=torch.uint8)
    ch = channels(n, K, dyadic=True)
    plain = pallas_histogram_sublane_plain(bins_t, ch, B, "f32")
    kern = pallas_histogram_sublane(bins_t, ch, B, "f32")
    worst = max(worst, close_rel(kern, plain, None, f"K3 {n}x{F} dyadic", 0))
    del plain
    paths = check_k3_paths(g)
    # skewed bins at the probe's size, bit-equal to the plain version on
    # integer channels (a bin may hold every row, and its sums stay exact):
    # 90% of the rows in bin 0; every row of a feature in one bin
    skewed = {}
    chi = channels(n, K, dyadic="int")
    for skew in ("bin0_90", "one_bin"):
        if skew == "bin0_90":
            sk = bins_t.clone()
            sk[torch.rand(F, n, generator=g, device=dev) < 0.9] = 0
        else:
            sk = (torch.arange(F, device=dev) * 37 % B).to(torch.uint8)[
                :, None].expand(F, n).contiguous()
        worst = max(worst, close_rel(
            pallas_histogram_sublane(sk, chi, B, "f32"),
            pallas_histogram_sublane_plain(sk, chi, B, "f32"), None,
            f"K3 {n}x{F} {skew} integer channels", 0))
        skewed[skew] = time_ms(
            lambda: pallas_histogram_sublane(sk, chi, B, "f32"))
        del sk
    # sparse channels, as the masked grower's deeper splits give them: a
    # random share of the rows live (bins of 16-row pieces without a live
    # row are not read, the live rows go through pending tiles)
    sparse_ms = {}
    for frac in (8, 64):
        live = torch.rand(n, generator=g, device=dev) < 1.0 / frac
        sp = ch * live[:, None]
        worst = max(worst, close_rel(
            pallas_histogram_sublane(bins_t, sp, B, "f32"),
            pallas_histogram_sublane_plain(bins_t, sp, B, "f32"), None,
            f"K3 {n}x{F} random 1/{frac} live", 0))
        sparse_ms[f"random_1_in_{frac}"] = time_ms(
            lambda: pallas_histogram_sublane(bins_t, sp, B, "f32"))
        del sp, live
    del chi
    print("K3 skewed", json.dumps(skewed), flush=True)
    bins = bins_t.T.contiguous()         # the same bins row-major, for K1
    line = {"rows": n, "F": F, "B": B, "K": K, "dyadic": True,
            "kernel_ms": time_ms(
                lambda: pallas_histogram_sublane(bins_t, ch, B, "f32")),
            "k1_dense_ms": time_ms(
                lambda: pallas_histogram(bins, ch, B, mode="f32")),
            "plain_ms": time_ms(lambda: pallas_histogram_sublane_plain(
                bins_t, ch, B, "f32"), 3, 1)}
    # a deep split's smaller child: one row in eight carries channels
    sparse = ch * (torch.arange(n, device=dev) % 8 == 0)[:, None]
    line["one_in_eight_rows_ms"] = time_ms(
        lambda: pallas_histogram_sublane(bins_t, sparse, B, "f32"))
    del sparse
    flat = (bins.to(torch.int64) + torch.arange(F, device=dev) * B).reshape(-1)
    src = ch[:, None, :].expand(n, F, K).reshape(-1, K)
    lib_out = torch.zeros(F * B, K, device=dev)

    def lib():
        lib_out.zero_()
        lib_out.index_add_(0, flat, src)
    line["library_ms"] = time_ms(lib, 3, 1)
    line["bound_ms"] = 1e3 * (n * F + 4 * n * K + F * B * K * 4) \
        / HBM_BYTES_PER_S
    # one row in eight live: the channels are read whole, the bins of the
    # live rows only
    line["one_in_eight_rows_bound_ms"] = 1e3 * (
        -(-n // 8) * F + 4 * n * K + F * B * K * 4) / HBM_BYTES_PER_S
    line["skewed_ms"] = skewed
    line["sparse_ms"] = sparse_ms
    print("K3", json.dumps(line), flush=True)
    del flat, src, lib_out, bins, bins_t, ch
    results["histogram_sublane"] = dict(line, max_abs_err=worst, path=path,
                                        paths=paths)


def device_us(fn, name, reps=30):
    """Mean device microseconds of the kernels whose name holds `name` in
    reps calls of fn (torch.profiler; events around short back-to-back
    launches would time the host's issue rate instead)."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a profile now and then records no device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if name in e.name]
        if len(us) == reps:
            return sum(us) / reps
    raise AssertionError(f"profiled {len(us)} launches of {name}, not "
                         f"{reps}")


def check_k3_paths(g):
    """K3's two paths on each side of the row count where the host switches
    from the small-data path to the tile path (SUBLANE_SMALL_ROWS), every
    row live and an eighth live, each within 1e-5 of the plain version's
    addends; at the switch, each path's device microseconds a launch."""
    from lightgbm_tpu_torch.ops.pallas_histogram import (
        SUBLANE_SMALL_ROWS, _launch_sublane, pallas_histogram_sublane_plain,
        sublane_small_geometry, sublane_tile_geometry)
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    B, K, F = 64, 3, 28             # the masked path's shape
    top = SUBLANE_SMALL_ROWS + 1
    bins_all = torch.randint(0, B, (F, top), generator=g, device=dev,
                             dtype=torch.uint8)
    ch_all = torch.randn(top, K, generator=g, device=dev)
    live = torch.rand(top, generator=g, device=dev) < 0.125
    line = {"rows": SUBLANE_SMALL_ROWS}
    for n in (SUBLANE_SMALL_ROWS, top):
        bins = bins_all[:, :n]
        ch = ch_all[:n]
        sparse = (ch * live[:n, None]).contiguous()
        for path in (sublane_small_geometry, sublane_tile_geometry):
            geom = path(n, F, B, K, sms)
            for c in (ch, sparse):
                plain = pallas_histogram_sublane_plain(bins, c, B, "f32")
                close_rel(_launch_sublane(bins, c, B, "f32", geom), plain,
                          pallas_histogram_sublane_plain(bins, c.abs(), B,
                                                         "f32"),
                          f"K3 {n} rows, geometry {geom}", 1e-5)
            if n == SUBLANE_SMALL_ROWS:
                name = "small" if geom.small else "tile"
                line[f"{name}_dense_us"] = device_us(
                    lambda: _launch_sublane(bins, ch, B, "f32", geom),
                    "hist_sublane")
                line[f"{name}_eighth_live_us"] = device_us(
                    lambda: _launch_sublane(bins, sparse, B, "f32", geom),
                    "hist_sublane")
    print("K3_PATHS", json.dumps(line), flush=True)
    return line


def phase_main_path(lgt, rows, rounds, results):
    from lightgbm_tpu_torch import _kernels
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    t0 = time.perf_counter()
    X, y, logits, w1 = make_higgs_like(rows, 28, with_logits=True,
                                       with_w1=True)
    n_val = rows // 10
    Xt, yt, Xv, yv = X[:-n_val], y[:-n_val], X[-n_val:], y[-n_val:]
    gen_s = time.perf_counter() - t0
    params = {"objective": "binary", "metric": "auc", "num_leaves": 255,
              "max_bin": 255, "learning_rate": 0.1, "min_data_in_leaf": 100,
              "verbosity": -1, "device_type": "cuda"}

    syncs = {}
    ends = []

    def timer(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    timer.order = 5

    _kernels.reset_counts()
    with count_syncs(gbdt_mod, ["grow_tree_compact"], syncs):
        t1 = time.perf_counter()
        ds = lgt.Dataset(Xt, yt)
        dv = ds.create_valid(Xv, yv)
        ds.construct()
        dv.construct()
        construct_s = time.perf_counter() - t1
        evals = {}
        t_start = time.perf_counter()
        bst = lgt.train(params, ds, 1 + rounds, valid_sets=[dv],
                        callbacks=[timer, lgt.record_evaluation(evals)])
    launches = dict(_kernels.LAUNCHES)
    plain_calls = dict(_kernels.PLAIN_CALLS)
    check(len(ends) == 1 + rounds, f"trained {len(ends)} rounds")
    it_s = rounds / (ends[-1] - ends[0])
    auc = evals["valid_0"]["auc"][-1]
    # QUANT trains on the same constructed datasets and compares its AUC
    # with this run's at the same round
    results["main_datasets"] = (ds, dv)
    out = {"rows": rows, "train_rows": rows - n_val, "valid_rows": n_val,
           "valid_auc_by_round": evals["valid_0"]["auc"],
           # each timed round's wall s; the first holds the tree whose host
           # syncs are counted (torch's sync debug mode on)
           "round_s": np.diff(ends).tolist(),
           "rounds_timed": rounds, "iterations_per_s": it_s,
           "first_round_s": ends[0] - t_start, "construct_s": construct_s,
           "data_gen_s": gen_s, "valid_auc": auc, "launches": launches,
           "plain_calls": plain_calls, "host_syncs_in_tree":
           syncs.get("in_tree"), "num_trees": bst.num_trees()}
    if rows < 10_500_000:
        out["note"] = "rows lowered by --rows"
    print("MAIN", json.dumps(out), flush=True)
    # the compact path's kernels: K1 (record mode) and K2
    for k in ("histogram", "fused_split"):
        check(launches[k] > 0, f"kernel {k} was not launched on the compact "
              "path")
    for k, v in plain_calls.items():
        check(v == 0, f"plain version of {k} ran {v} times on the card")
    check(np.isfinite(auc) and auc > 0.7, f"validation AUC {auc}")
    check(syncs.get("in_tree") == 0, "host syncs inside the split loop")
    out["profile"] = profile_tree(bst, 1.0 / it_s)
    results["main"] = out
    # the large-N masked and the multiclass phases train on the same rows
    results["higgs"] = (X, y, logits, n_val)
    # PREDICT_API explains, routes and refits this booster
    results["main_booster"] = bst
    # CONSTRAINED's monotone directions
    results["higgs_w1"] = w1


PREDICT_ROWS = 131_072         # pred_contrib's validation rows
PREDICT_PLAIN_ROWS = 4_096     # the TreeSHAP kernel against its plain version
PREDICT_CPU_ROWS = 1_024       # the card against the CPU
PREDICT_SAMPLE = 16_384        # leaves and early stopping against the CPU
PREDICT_TILE = 30              # MAIN's trees tiled: a many-tree model
FP64_OPS_PER_S = 34e12         # H100 SXM float64, NVIDIA data sheet


def cpu_twin(bst):
    """A prediction-only CPU Booster with ``bst``'s trees and bin mappers:
    the card against the CPU on one model."""
    from lightgbm_tpu_torch.basic import Booster
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.config import Config
    g = bst._gbdt
    params = dict(bst.params, device_type="cpu")
    return Booster._from_gbdt(GBDT.for_prediction(
        Config(params), g.models, g.mappers, g.objective,
        torch.device("cpu"), g.feature_names), params)


def profile_contrib(bst, X):
    """(device ms, traced launches, counted launches) of the TreeSHAP kernel
    in one ``pred_contrib`` call under torch.profiler, after the warm-up
    ``profile_tree`` uses; a short trace is retried, three times at
    most."""
    from torch.profiler import ProfilerActivity, profile

    from lightgbm_tpu_torch import _kernels
    for _ in range(3):
        before = _kernels.LAUNCHES["treeshap"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            warm = torch.zeros(4, device="cuda")
            for _ in range(256):
                warm.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(0.05)
            bst.predict(X, pred_contrib=True)
            torch.cuda.synchronize()
        counted = _kernels.LAUNCHES["treeshap"] - before
        hits = [end - start for name, cuda, start, end in trace_events(prof)
                if cuda and _named(name, KERNEL_FUNCTIONS["treeshap"])]
        if len(hits) == counted:
            return sum(hits) * 1e-3, len(hits), counted
        print(f"PREDICT_API profile retry: {len(hits)} traced, {counted} "
              "counted", flush=True)
    raise AssertionError("three pred_contrib traces each held fewer TreeSHAP "
                         "launches than the wrapper counted")


def time_tree_adds(g, Xv):
    """Plain prediction's tree-by-tree adds against the batched sum of
    each walked batch they replaced (``index_add_`` for K > 1 is left
    out: ``MAIN`` is binary), on ``MAIN``'s trees tiled to
    ``PREDICT_TILE`` times as many, over the validation rows: ms of
    ``predict_raw_batched`` and of the same walk summed a batch at a time,
    in the order batched, adds, adds, batched."""
    from lightgbm_tpu_torch.boosting.gbdt import stack_trees
    from lightgbm_tpu_torch.ops import predict as pr
    models = list(g.models) * PREDICT_TILE
    trees = stack_trees(models, g.device, g.feature_is_categorical())
    depth = max(m.max_depth for m in models)
    b = torch.from_numpy(g.bin_matrix(Xv)).to(g.device)
    nan = g._pred_nan_arr

    def batched(tbatch=16):
        scores = torch.zeros((1, len(b)), dtype=torch.float32,
                             device=g.device)
        rows = pr._CHUNK_ELEMS // tbatch
        for r0 in range(0, len(b), rows):
            part, acc = b[r0:r0 + rows], scores[:, r0:r0 + rows]
            for t0 in range(0, trees.num_trees, tbatch):
                sub = trees.slice(t0, t0 + tbatch)
                leaf = pr.predict_leaf_batched(part, sub, nan, depth)
                acc += sub.leaf_value.gather(1, leaf).sum(dim=0)[None, :]
        return scores

    def adds():
        return pr.predict_raw_batched(b, trees, nan, depth)
    out = {"trees": len(models), "rows": len(b), "batched_ms": [],
           "adds_ms": []}
    for name, fn in (("batched", batched), ("adds", adds), ("adds", adds),
                     ("batched", batched)):
        out[f"{name}_ms"].append(time_ms(fn, reps=3, warm=1))
    out["max_abs_diff"] = float((adds() - batched()).abs().max())
    check(out["max_abs_diff"] <= 1e-5 * len(models), "tree-by-tree adds "
          "against the batched sum")
    return out


def phase_predict_api(lgt, results):
    """PREDICT_API on MAIN's booster (10.5M x 28 rows, 255 leaves, 1 + 5
    rounds and the profiled one): pred_contrib on 131,072 validation rows
    through the TreeSHAP kernel (wall s, device ms and launches, profiled
    launches equal to the wrapper's count, contributions summing to the raw
    score), the kernel
    against its plain version (4,096 rows, 1e-12 of each cell's |value| plus
    its bound on |addends|; and pred_contrib's output against the plain
    version timed at 131,072 rows), the card against the CPU (1,024 rows);
    pred_leaf on every validation row (leaf values summed equal the raw
    score; equal to the CPU's on a sample); ``time_tree_adds``;
    pred_early_stop at margins 1.5 and 0.25, freq 2 (the share
    of rows stopped, each row's score equal to the window it stopped at,
    equal to the CPU's; margin 1e9 equal to the plain prediction); refit
    on the 131,072 rows with decay 0.9 against the CPU's refit (leaf
    values within 1e-6)."""
    from lightgbm_tpu_torch import _kernels
    from lightgbm_tpu_torch.ops import treeshap_device as ts
    bst = results.pop("main_booster")
    X, y, _, n_val = results["higgs"]
    Xv, yv = X[-n_val:], y[-n_val:]
    Xp = Xv[:PREDICT_ROWS]
    g = bst._gbdt
    k, f = g.num_class, Xp.shape[1]
    cpu = cpu_twin(bst)
    out = {"trees": bst.num_trees(), "rows": len(Xp)}
    raw = bst.predict(Xp, raw_score=True)

    # pred_contrib through the kernel: the phase's main path
    _kernels.reset_counts()
    t0 = time.perf_counter()
    phi = bst.predict(Xp, pred_contrib=True)
    out["contrib_wall_s"] = time.perf_counter() - t0
    out["launches"] = _kernels.LAUNCHES["treeshap"]
    check(out["launches"] > 0, "pred_contrib did not launch the TreeSHAP "
          "kernel")
    check(_kernels.PLAIN_CALLS["treeshap"] == 0,
          "pred_contrib ran the plain TreeSHAP on the card")
    check(phi.shape == (len(Xp), k * (f + 1)) and np.isfinite(phi).all(),
          f"pred_contrib gave {phi.shape}")
    out["sum_max_abs_err"] = float(np.abs(phi.sum(1) - raw).max())
    check(out["sum_max_abs_err"] <= 1e-4, "contributions do not sum to the "
          f"raw score: {out['sum_max_abs_err']}")

    # the kernel on the window's tables: timed, profiled, against its plain
    # version and the CPU
    paths = ts.build_shap_paths(g.models, g._pred_nan_arr.cpu().numpy(),
                                g.feature_is_categorical(), g.device)
    out["deepest_path"] = int(paths.path_len.max())
    out["longest_ulen"] = int(paths.ulen.max())
    b = torch.from_numpy(g.bin_matrix(Xp)).to(g.device)
    out["kernel_ms"] = time_ms(lambda: ts.tree_shap(b, paths, k), reps=5,
                               warm=1)
    dev_ms, traced, counted = profile_contrib(bst, Xp)
    out.update(profiled_device_ms=dev_ms, profiled_launches=traced,
               counted_launches=counted)
    bs = b[:PREDICT_PLAIN_ROWS]
    scale = float(paths.leaf_value.abs().sum() + paths.ev.abs().sum())
    kern = ts.tree_shap(bs, paths, k)
    plain = ts.tree_shap_plain(bs, paths, k)
    err = (kern - plain).abs()
    out["max_abs_err"] = float(err.max())
    out["max_rel_err"] = float((err / (plain.abs() + scale)).max())
    check(out["max_rel_err"] <= 1e-12, "TreeSHAP kernel against its plain "
          f"version: {out['max_rel_err']}")
    out["kernel_4096_ms"] = time_ms(lambda: ts.tree_shap(bs, paths, k),
                                    reps=5, warm=1)
    out["plain_4096_ms"] = time_ms(lambda: ts.tree_shap_plain(bs, paths, k),
                                   reps=1, warm=0)
    # the plain version on all the main path's rows, held against what
    # pred_contrib returned
    runs = []
    out["plain_ms"] = time_ms(
        lambda: runs.append(ts.tree_shap_plain(b, paths, k)), reps=1, warm=0)
    plain_full = runs[0].reshape(len(Xp), -1).cpu().numpy()
    ferr = np.abs(phi - plain_full)
    out["full_max_abs_err"] = float(ferr.max())
    out["full_max_rel_err"] = float(
        (ferr / (np.abs(plain_full) + scale)).max())
    check(out["full_max_rel_err"] <= 1e-12, "pred_contrib against the plain "
          f"TreeSHAP at {len(Xp)} rows: {out['full_max_rel_err']}")
    t0 = time.perf_counter()
    cpu_phi = cpu.predict(Xp[:PREDICT_CPU_ROWS], pred_contrib=True)
    out["cpu_contrib_s"] = time.perf_counter() - t0
    cerr = np.abs(phi[:PREDICT_CPU_ROWS] - cpu_phi)
    out["cpu_max_abs_err"] = float(cerr.max())
    out["cpu_max_rel_err"] = float((cerr / (np.abs(cpu_phi) + scale)).max())
    check(out["cpu_max_rel_err"] <= 1e-12, "pred_contrib card against CPU: "
          f"{out['cpu_max_rel_err']}")
    nbytes = (b.numel() + len(Xp) * k * (f + 1) * 8
              + sum(t.numel() * t.element_size() for t in paths
                    if torch.is_tensor(t)))
    ops = ts.shap_ops(paths, len(Xp))
    out.update(bytes=nbytes, fp64_ops=ops,
               bytes_ms=1e3 * nbytes / HBM_BYTES_PER_S,
               ops_ms=1e3 * ops / FP64_OPS_PER_S)
    out["bound_ms"] = max(out["bytes_ms"], out["ops_ms"])
    out["bound_by"] = ("operations" if out["ops_ms"] >= out["bytes_ms"]
                       else "bytes")

    # pred_leaf on every validation row
    t0 = time.perf_counter()
    leaves = bst.predict(Xv, pred_leaf=True)
    out["leaf_wall_s"] = time.perf_counter() - t0
    check(leaves.shape == (n_val, bst.num_trees())
          and leaves.dtype == np.int32, f"pred_leaf gave {leaves.shape}")
    check(np.array_equal(leaves[:PREDICT_SAMPLE],
                         cpu.predict(Xv[:PREDICT_SAMPLE], pred_leaf=True)),
          "pred_leaf card against CPU")
    full = bst.predict(Xv, raw_score=True)
    by_leaf = np.zeros(n_val)
    for i, m in enumerate(g.models):
        by_leaf += np.asarray(m.leaf_value, np.float64)[leaves[:, i]]
    out["leaf_sum_max_abs_err"] = float(np.abs(by_leaf - full).max())
    check(out["leaf_sum_max_abs_err"] <= 1e-5, "leaf values summed against "
          f"raw_score: {out['leaf_sum_max_abs_err']}")
    out["adds"] = time_tree_adds(g, Xv)

    # early stopping with freq 2: a check after every second iteration
    # (one after the last changes nothing); margin 1.5 (few rows are that
    # sure after a few trees at learning rate 0.1) and 0.25. Each row's
    # score is that of the window it stopped at, bit for bit
    checks = list(range(2, bst.current_iteration(), 2))
    windows = [bst.predict(Xv, raw_score=True, num_iteration=c)
               for c in checks]
    for margin in (1.5, 0.25):
        stop = dict(pred_early_stop=True, pred_early_stop_margin=margin,
                    pred_early_stop_freq=2)
        t0 = time.perf_counter()
        early = bst.predict(Xv, raw_score=True, **stop)
        wall = time.perf_counter() - t0
        want, going = full.copy(), np.ones(n_val, bool)
        for at in windows:
            hit = going & (2 * np.abs(at) > margin)
            want[hit] = at[hit]
            going &= ~hit
        bad = np.nonzero(early != want)[0]
        out[f"early_stop_{margin}"] = {
            "wall_s": wall, "share_stopped": float(1.0 - going.mean()),
            "rows_differing": int(len(bad)),
            "max_abs_diff": float(np.abs(early - want).max())}
        check(len(bad) == 0, "early-stopped scores against the windows they "
              f"stopped at (margin {margin}): rows {bad[:4].tolist()}")
    check(out["early_stop_0.25"]["share_stopped"] > 0,
          "no row stopped at margin 0.25")
    stop = dict(pred_early_stop=True, pred_early_stop_margin=1.5,
                pred_early_stop_freq=2)
    cpu_early = cpu.predict(Xv[:PREDICT_SAMPLE], raw_score=True, **stop)
    out["early_stop_cpu_max_abs_err"] = float(np.abs(bst.predict(
        Xv[:PREDICT_SAMPLE], raw_score=True, **stop) - cpu_early).max())
    check(out["early_stop_cpu_max_abs_err"] <= 1e-6, "early stopping card "
          "against CPU")
    check(np.array_equal(bst.predict(
        Xv, raw_score=True, **dict(stop, pred_early_stop_margin=1e9)), full),
        "margin 1e9 against the plain prediction")

    # refit on pred_contrib's rows, not every validation row: the card's
    # and the CPU's host routing of 1.05M rows took 30 s of the smoke
    t0 = time.perf_counter()
    refit = bst.refit(Xp, yv[:len(Xp)], decay_rate=0.9)
    out["refit_wall_s"] = time.perf_counter() - t0
    out["refit_rows"] = len(Xp)
    cpu_refit = cpu.refit(Xp, yv[:len(Xp)], decay_rate=0.9)
    # the gradients are f32 on each device (their exp and sigmoid part by
    # ulps), and a leaf's sum of them cancels: held absolute, the leaves
    # moving by about 1e-2
    diff = [np.abs(a.leaf_value - c.leaf_value) for a, c in
            zip(refit._gbdt.models, cpu_refit._gbdt.models)]
    out["refit_max_abs_diff"] = max(float(d.max()) for d in diff)
    out["refit_max_rel_diff"] = max(
        float((d / np.maximum(np.abs(c.leaf_value), 1e-12)).max())
        for d, c in zip(diff, cpu_refit._gbdt.models))
    check(out["refit_max_abs_diff"] <= 1e-6, "refit card against CPU: "
          f"{out['refit_max_abs_diff']}")
    moved = max(float(np.abs(a.leaf_value - np.asarray(m.leaf_value)).max())
                for a, m in zip(refit._gbdt.models, g.models))
    out["refit_max_leaf_move"] = moved
    check(moved > 0, "refit moved no leaf")
    print("PREDICT_API", json.dumps(out), flush=True)
    results["predict_api"] = out


QUANT_ROUNDS = 2                 # timed rounds after one warm-up round


def phase_quant(lgt, results):
    """Quantized-gradient training on the main path: MAIN's constructed
    datasets (the same 10.5M Higgs-shaped rows, 10% validation) and
    parameters with use_quantized_grad=True and LightGBM's defaults
    (num_grad_quant_bins=4, stochastic_rounding=True,
    quant_train_renew_leaf=False), 1 warm-up and QUANT_ROUNDS timed rounds
    and a profiled tree: the compact grower's int path (K2's quant mode,
    K1's integer variant). Then QUANT_CHECKS (check_quant_kernels,
    quant_cpu_vs_card, the reloaded model)."""
    from lightgbm_tpu_torch import _kernels
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    ds, dv = results["main_datasets"]
    rounds = QUANT_ROUNDS
    params = {"objective": "binary", "metric": "auc", "num_leaves": 255,
              "max_bin": 255, "learning_rate": 0.1, "min_data_in_leaf": 100,
              "verbosity": -1, "device_type": "cuda",
              "use_quantized_grad": True}
    syncs = {}
    ends = []

    def timer(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    timer.order = 5

    evals = {}
    _kernels.reset_counts()
    # the host syncs of the whole tree step: the iteration's gradients and
    # the discretizer (_begin_compact_iter), then the tree
    with count_syncs(gbdt_mod.GBDT, COMPACT_STEP, syncs):
        t_start = time.perf_counter()
        bst = lgt.train(params, ds, 1 + rounds, valid_sets=[dv],
                        callbacks=[timer, lgt.record_evaluation(evals)])
    launches = dict(_kernels.LAUNCHES)
    modes = dict(_kernels.MODE_LAUNCHES)
    plain_calls = dict(_kernels.PLAIN_CALLS)
    gbdt = bst._gbdt
    check(len(ends) == 1 + rounds, f"trained {len(ends)} rounds")
    it_s = rounds / (ends[-1] - ends[0])
    auc = evals["valid_0"]["auc"][-1]
    main_aucs = results["main"]["valid_auc_by_round"]
    out = {"train_rows": gbdt.num_data, "valid_rows": dv.num_data(),
           "rounds_timed": rounds, "iterations_per_s": it_s,
           "round_s": np.diff(ends).tolist(),
           "first_round_s": ends[0] - t_start, "construct_s": "reused",
           "valid_auc": auc,
           "main_f32_valid_auc_same_round": main_aucs[rounds],
           "launches": launches, "mode_launches": modes,
           "plain_calls": plain_calls,
           "host_syncs_in_tree": syncs.get("in_tree"),
           "num_trees": bst.num_trees(), "quant_int": gbdt._quant_int}
    check(gbdt.use_compact and gbdt._quant_int, "quantized training did not "
          "take the compact grower's int path")
    for k in ("histogram", "fused_split"):
        check(launches[k] > 0, f"kernel {k} was not launched on the QUANT "
              "path")
        check(modes[f"{k}/quant"] == launches[k], f"{k}: "
              f"{launches[k] - modes[k + '/quant']} launches outside its "
              "quant mode on the QUANT path")
    for k, v in plain_calls.items():
        check(v == 0, f"plain version of {k} ran {v} times on the card")
    check(np.isfinite(auc) and auc > 0.7, f"QUANT validation AUC {auc}")
    check(syncs.get("in_tree") == 0, "host syncs inside the quantized tree "
          "step")
    prof = profile_tree(bst, 1.0 / it_s)
    pm = prof["modes"]
    check(pm["histogram/quant"]["launches"] == pm["histogram/quant"][
        "counted"] == prof["kernels"]["histogram"]["launches"],
          "the profiled QUANT tree ran K1 outside its integer variant")
    # profile_tree held each kernel's traced launches to its wrapper's
    # count; on the compact path each K2 launch runs one K1
    check(pm["fused_split/quant"]["counted"]
          == pm["histogram/quant"]["counted"] > 0,
          "the profiled QUANT tree's K2 launches are not all quant")
    out.update({"tree_kernel_launches": prof["kernel_launches"],
                "tree_device_s": prof["device_s"],
                "tree_wall_s": 1.0 / it_s,
                "tree_device_idle_share": prof["device_idle_share"],
                "tree_kernels": {k: {"device_ms": v["device_ms"],
                                     "launches": v["launches"],
                                     "bound_ms": v.get("bound_ms")}
                                 for k, v in prof["kernels"].items()
                                 if k != "histogram_sublane"}})
    print("QUANT", json.dumps(out), flush=True)
    out["profile"] = prof
    checks = {"kernels": check_quant_kernels(bst)}
    X, _, _, n_val = results["higgs"]
    Xv = X[-n_val:][:20_000]
    p_card = bst.predict(Xv)
    check(np.all(np.isfinite(p_card)) and p_card.shape == (len(Xv),),
          "QUANT card predictions")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "quant.txt")
        bst.save_model(path)
        reload_diff = float(np.abs(lgt.Booster(model_file=path).predict(Xv)
                                   - p_card).max())
    check(reload_diff <= 1e-6, f"reloaded quantized model differs by "
          f"{reload_diff}")
    checks["reload_max_abs_diff"] = reload_diff
    checks["cpu_vs_card"] = quant_cpu_vs_card(lgt)
    print("QUANT_CHECKS", json.dumps(checks), flush=True)
    out["checks"] = checks
    results["quant"] = out
    del bst, ds, dv, gbdt


def check_quant_kernels(bst):
    """K2's quant mode against its plain version on the QUANT run's records
    (all training rows, carrying the last tree's integer codes): at the
    root (mode 1, the whole segment; and mode 0, the last tree's root
    split) and at one grown split (the root's child on its segment of the
    root split's result): children byte-equal, rows outside the segment
    and the padding unchanged, int32 histograms exactly equal. Then times:
    K2 quant against K2 f32 at the root split, and K1's integer variant
    alone at the root against K1 f32, the plain version and index_add_ of
    int32 channels on a precomputed flat index."""
    from lightgbm_tpu_torch.ops.compact import record_channels
    from lightgbm_tpu_torch.ops.fused_split import (fused_split,
                                                    fused_split_plain)
    from lightgbm_tpu_torch.ops.pallas_histogram import (
        record_histogram, record_histogram_plain)
    from lightgbm_tpu_torch.ops.split import go_left_pred
    gbdt = bst._gbdt
    layout = gbdt.layout
    B = gbdt.grower_params.num_bins
    F = layout.num_features
    dev = gbdt.device
    n = gbdt.num_data
    work = gbdt.work.clone()
    scratch = torch.zeros_like(work)
    codes = work[:, layout.grad_off:layout.grad_off + 8].contiguous().view(
        torch.float32)
    check(torch.equal(codes, codes.trunc()), "the QUANT records do not hold "
          "integer codes")
    tree = gbdt.models[-1]
    check(tree.num_nodes > 1, "the last QUANT tree has no grown split")
    none = torch.zeros(8, dtype=torch.int32, device=dev)

    def split_args(node, start, count, arr):
        f, b = int(tree.split_feature[node]), int(tree.split_bin[node])
        dl, nan = int(tree.default_left[node]), int(gbdt.nan_bin_arr[f])
        gl = go_left_pred(arr[start:start + count, f], b, bool(dl), nan,
                          False, none)
        return (0, start, count, int(gl.sum()), f, b, dl, nan, 0, None,
                layout, B), gl

    line = {"rows": n}
    worst = 0
    # mode 1: the root histogram
    seg_args = (1, 0, n, 0, 0, 0, 0, 0, 0, None, layout, B)
    _, _, hk = fused_split(work, scratch, *seg_args, quant=True)
    _, _, hp = fused_split_plain(work, scratch, *seg_args, quant=True)
    check(hk.dtype == torch.int32 and torch.equal(hk, hp),
          "K2 quant mode 1 at the root: histograms differ")
    check(int(hk[0, :, 3].sum()) == n, "K2 quant mode 1: row count")
    worst = max(worst, int((hk - hp).abs().max()))
    root_args, gl = split_args(0, 0, n, work)
    child = int(tree.left_child[0])
    side_left = child >= 0
    if not side_left:
        child = int(tree.right_child[0])
    check(child >= 0, "the root has no internal child")
    after_root = None
    for what, node in (("root", 0), ("grown", child)):
        if what == "root":
            base, args, side = work, root_args, 0
        else:
            nl0 = root_args[3]
            start, count = (0, nl0) if side_left else (nl0, n - nl0)
            # the left child stays in work, the right one lies in scratch
            base = after_root
            side = 0 if side_left else 1
            arr = base[0] if side == 0 else base[1]
            args, _ = split_args(node, start, count, arr)
        start, count, n_left = args[1], args[2], args[3]
        if what == "root":
            before = (base.clone(), scratch.clone())
        else:
            before = (base[0].clone(), base[1].clone())
        wk, sk = before[0].clone(), before[1].clone()
        _, _, hk = fused_split(wk, sk, *args, side=side, quant=True)
        wp, spl = before[0].clone(), before[1].clone()
        _, _, hp = fused_split_plain(wp, spl, *args, side=side, quant=True)
        torch.cuda.synchronize()
        check_split((wk, sk), (wp, spl), before, start, count, n_left, side,
                    layout, f"K2 quant at the {what} split")
        check(hk.dtype == torch.int32 and torch.equal(hk, hp),
              f"K2 quant at the {what} split: histograms differ")
        worst = max(worst, int((hk - hp).abs().max()))
        line[what] = {"start": start, "count": count, "n_left": n_left,
                      "feature": args[4], "side": side}
        if what == "root":
            after_root = (wk, sk)
        del wp, spl, hk, hp, before
    del after_root, wk, sk
    line["max_abs_err"] = worst
    n_left = root_args[3]
    n_small = min(n_left, n - n_left)
    calls = [0]

    def alternating(quant):
        def run():
            fused_split(work, scratch, *root_args, side=calls[0] % 2,
                        quant=quant)
            calls[0] += 1
        return run

    def library():
        perm = torch.argsort(gl.to(torch.uint8), stable=True)
        torch.index_select(work, 0, perm, out=scratch)
    row_bytes = record_row_bytes(layout)
    line["k2"] = {
        "ms": time_ms(alternating(True)),
        "f32_ms": time_ms(alternating(False)),
        "plain_ms": time_ms(lambda: fused_split_plain(
            work, scratch, *root_args, quant=True), 4, 2),
        "library_ms": time_ms(library, 4, 2),
        "bound_ms": 1e3 * (2 * n * layout.num_real_cols
                           + n_small * row_bytes) / HBM_BYTES_PER_S}
    # the timing calls partitioned the arrays again and again: K1 alone
    # runs on what they left, the whole array of records with codes
    seg = torch.tensor([0, n, 0], dtype=torch.int32, device=dev)
    hk = record_histogram(work, scratch, seg, layout, B, quant=True)
    hp = record_histogram_plain(work, scratch, seg, layout, B, quant=True)
    check(torch.equal(hk, hp), "K1's integer variant at the root differs "
          "from its plain version")
    flat = (work[:, :F].to(torch.int64)
            + torch.arange(F, device=dev) * B).reshape(-1)
    src = record_channels(work, layout, quant=True)[:, None, :].expand(
        n, F, 4).reshape(-1, 4)
    lib_out = torch.zeros(F * B, 4, dtype=torch.int32, device=dev)

    def lib():
        lib_out.zero_()
        lib_out.index_add_(0, flat, src)
    lib()
    check(torch.equal(lib_out.view(F, B, 4), hk), "index_add_ of the int32 "
          "channels differs from K1's integer variant")
    line["k1"] = {
        "rows": n, "max_abs_err": int((hk - hp).abs().max()),
        "ms": time_ms(lambda: record_histogram(work, scratch, seg, layout,
                                               B, quant=True)),
        "f32_ms": time_ms(lambda: record_histogram(work, scratch, seg,
                                                   layout, B)),
        "plain_ms": time_ms(lambda: record_histogram_plain(
            work, scratch, seg, layout, B, quant=True), 3, 1),
        "library_ms": time_ms(lib, 3, 1),
        "bound_ms": 1e3 * (n * row_bytes + F * B * 16) / HBM_BYTES_PER_S}
    del work, scratch, flat, src, lib_out, hk, hp
    return line


def quant_cpu_vs_card(lgt):
    """The card against the CPU with deterministic rounding: the compact
    int path at 100k x 28 and the masked grower's shim at 20k x 28, 31
    leaves, 3 rounds, num_grad_quant_bins=4."""
    out = {}
    for grower, rows in (("compact", 100_000), ("masked", 20_000)):
        X, y = make_higgs_like(rows, 28, seed=17)
        params = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
                  "use_quantized_grad": True, "num_grad_quant_bins": 4,
                  "stochastic_rounding": False, "tpu_grower": grower}
        boosters = {dev: lgt.train(dict(params, device_type=dev),
                                   lgt.Dataset(X, y), 3)
                    for dev in ("cuda", "cpu")}
        check(boosters["cuda"]._gbdt._quant_int == (grower == "compact"),
              f"quantized {grower} run took the wrong histogram path")
        diff, differ = compare_boosters(boosters["cuda"], boosters["cpu"], X)
        check(diff <= 1e-4, f"quantized {grower}: card vs CPU predictions "
              f"differ by {diff}")
        out[grower] = {"rows": rows, "max_abs_pred_diff": diff,
                       "differing_splits": differ}
    return out


UNFUSED_ROUNDS = 2               # timed rounds after one warm-up round
# UNFUSED's runs: name -> (parameters over MAIN's, the histogram kernel, the
# mode that every launch of it must be in)
UNFUSED_RUNS = {
    "f32": ({}, "histogram", None),
    "quant": ({"use_quantized_grad": True}, "histogram", "histogram/int8"),
    "sublane_quant": ({"use_quantized_grad": True, "max_bin": 63,
                       "tpu_hist_layout": "sublane"}, "histogram_sublane",
                      "histogram_sublane/int8"),
    "narrow": ({"use_quantized_grad": True, "tpu_quant_hist_bits": 16},
               "histogram", "histogram/narrow"),
}
MAIN_PARAMS = {"objective": "binary", "metric": "auc", "num_leaves": 255,
               "max_bin": 255, "learning_rate": 0.1,
               "min_data_in_leaf": 100, "verbosity": -1,
               "device_type": "cuda"}


def bin63_datasets(lgt, results):
    """MAIN's rows binned at max_bin=63 (train, valid, construct s), made
    once for UNFUSED's sublane run and MASKED_LARGE."""
    if "bin63_datasets" not in results:
        X, y, _, n_val = results["higgs"]
        t1 = time.perf_counter()
        ds = lgt.Dataset(X[:-n_val], y[:-n_val], params={"max_bin": 63})
        dv = ds.create_valid(X[-n_val:], y[-n_val:])
        ds.construct()
        dv.construct()
        results["bin63_datasets"] = (ds, dv, time.perf_counter() - t1)
    return results["bin63_datasets"]


def timed_run(lgt, params, ds, dv, rounds):
    """One warm-up and ``rounds`` timed rounds on constructed datasets:
    the booster and a line with iterations/s, the validation AUC, the
    kernels' and modes' launches, the plain versions' calls and the host
    syncs in every compact tree step after the first (COMPACT_STEP)."""
    from lightgbm_tpu_torch import _kernels
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    syncs, ends, evals = {}, [], {}

    def timer(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    timer.order = 5
    _kernels.reset_counts()
    with count_syncs(gbdt_mod.GBDT, COMPACT_STEP, syncs):
        t_start = time.perf_counter()
        bst = lgt.train(params, ds, 1 + rounds, valid_sets=[dv],
                        callbacks=[timer, lgt.record_evaluation(evals)])
    check(len(ends) == 1 + rounds, f"trained {len(ends)} rounds")
    auc = evals["valid_0"]["auc"][-1]
    check(np.isfinite(auc) and auc > 0.7, f"validation AUC {auc}")
    return bst, {
        "rounds_timed": rounds,
        "iterations_per_s": rounds / (ends[-1] - ends[0]),
        "round_s": np.diff(ends).tolist(),
        "first_round_s": ends[0] - t_start, "valid_auc": auc,
        "launches": dict(_kernels.LAUNCHES),
        "mode_launches": dict(_kernels.MODE_LAUNCHES),
        "plain_calls": dict(_kernels.PLAIN_CALLS),
        "host_syncs_in_tree_step": syncs.get("in_tree"),
        "num_trees": bst.num_trees()}


def tree_line(prof, splits):
    """A profiled tree's numbers: device s, idle share, launches a split,
    each kernel's device ms and launches beside its byte bound."""
    return {"tree_device_s": prof["device_s"],
            "tree_device_idle_share": prof["device_idle_share"],
            "tree_kernel_launches": prof["kernel_launches"],
            "launches_a_split": prof["kernel_launches"] / splits,
            "tree_kernels": {k: {"device_ms": v["device_ms"],
                                 "launches": v["launches"],
                                 "bound_ms": v.get("bound_ms")}
                             for k, v in prof["kernels"].items()
                             if v["launches"]}}


def sector_bytes(lo, hi):
    """Bytes of the 32-byte sectors that hold record bytes [lo, hi)."""
    return 32 * ((hi - 1) // 32 - lo // 32 + 1)


def unfused_root_checks(bst, name, quant, hist_kernel):
    """The unfused path's kernels on the run's records at the root (all
    training rows, the last tree's codes; ``seg`` on the device): the
    segment gather, then K1 dense (f32 or int8) or K3 (int8 on the
    gather's feature-major copy) against their plain versions (int32
    exactly equal; f32 bit-equal on 1/64-grid gradients, and on the run's
    own each within f32's summation bound of float64 sums), the narrowed
    K1 (forced, its
    flushes on the way) against its plain version and the 32-bit kernel,
    bit for bit; each timed beside its plain version, index_add_ of the
    same channels and its byte bound; the narrowed kernel also on a
    6,000-row segment, where the grower's own choice takes it."""
    from lightgbm_tpu_torch.ops.compact import (record_channels,
                                                segment_histogram)
    from lightgbm_tpu_torch.ops.histogram import _xla_histogram_narrow
    from lightgbm_tpu_torch.ops.pallas_histogram import (
        _dense_f32, _dense_int, _launch_sublane, _num_sms,
        segment_gather, segment_gather_plain, sublane_geometry)
    gbdt = bst._gbdt
    layout = gbdt.layout
    B = gbdt.grower_params.num_bins
    F = layout.num_features
    dev = gbdt.device
    n = gbdt.num_data
    work, scratch = gbdt.work, gbdt.scratch
    stride = work.stride(0)
    seg = torch.tensor([0, n, 0], dtype=torch.int32, device=dev)
    sublane = hist_kernel == "histogram_sublane"
    ch_dtype = (torch.int32 if sublane else torch.int8) if quant \
        else torch.float32
    ch_bytes = 4 * ch_dtype.itemsize
    line = {"run": name, "rows": n, "bins": B}
    # the gather against its plain version
    ch, bt = segment_gather(work, scratch, seg, layout, ch_dtype, sublane)
    pch, pbt = segment_gather_plain(work, scratch, seg, layout, ch_dtype,
                                    sublane)
    check(torch.equal(ch, pch) and (bt is None or torch.equal(bt, pbt)),
          f"UNFUSED {name}: the segment gather differs from its plain "
          "version")
    del pch, pbt
    gather_bytes = n * (sector_bytes(layout.grad_off, layout.cnt_off + 4)
                        + ch_bytes + (2 * F if sublane else 0))
    line["segment_gather"] = {
        "ms": time_ms(lambda: segment_gather(work, scratch, seg, layout,
                                             ch_dtype, sublane)),
        "plain_ms": time_ms(lambda: segment_gather_plain(
            work, scratch, seg, layout, ch_dtype, sublane), 3, 1),
        "bound_ms": 1e3 * gather_bytes / HBM_BYTES_PER_S,
        "library_ms": None, "max_abs_err": 0,
        "transposed": sublane}
    if sublane:
        geom = sublane_geometry(n, F, B, 4, _num_sms(dev.index or 0))

        def kern():
            return _launch_sublane(bt, ch, B, "int8", geom)
        hist_bytes = n * (F + ch_bytes)
    elif quant:
        def kern():
            return _dense_int(work, scratch, n, stride, seg, False, ch, F, B,
                              0, 0)
        hist_bytes = n * (sector_bytes(0, layout.feat_cols) + ch_bytes)
    else:
        def kern():
            return _dense_f32(work, scratch, n, stride, seg, False, ch, F, B,
                              False)
        hist_bytes = n * (sector_bytes(0, layout.feat_cols) + ch_bytes)
    hist_bytes += F * B * 16
    hk = kern()
    hp = segment_histogram(work, 0, n, layout, B, quant,
                           hist_layout="sublane" if sublane else "lane")
    if quant:
        check(hk.dtype == torch.int32 and torch.equal(hk, hp),
              f"UNFUSED {name}: {hist_kernel} int8 at the root differs from "
              "its plain version")
        err = int((hk - hp).abs().max())
    else:
        # on 1/64-grid gradients every partial sum is exact: bit-equal
        dwork = dyadic_records(work, layout)
        dch, _ = segment_gather(dwork, scratch, seg, layout, ch_dtype, False)
        hist_close(_dense_f32(dwork, scratch, n, stride, seg, False, dch, F,
                              B, False),
                   segment_histogram(dwork, 0, n, layout, B), None,
                   f"UNFUSED {name}: K1 dense at the root, 1/64 grid", rel=0)
        del dwork, dch
    bins = (bt.T if sublane else work[:, :F]).to(torch.int64)
    flat = (bins + torch.arange(F, device=dev) * B).reshape(-1)
    del bins
    src = record_channels(work, layout, quant)[:, None, :].expand(
        n, F, 4).reshape(-1, 4)
    lib_out = torch.zeros(F * B, 4, dtype=src.dtype, device=dev)
    if not quant:
        # the run's own gradients: the rows of a leaf share one gradient,
        # and f32 sums of many equal addends round with a bias, so the
        # error grows with the rows, up to (m - 1) 2^-24 of a cell's sum
        # of |addends| in any order (m its rows; the random-walk
        # tolerance of check_tuned_kernels was passed by 1.15x here). The
        # kernel and its plain version are each held to that bound
        # against float64 sums
        exact = torch.zeros(F * B, 4, dtype=torch.float64, device=dev)
        absh = torch.zeros(F * B, 4, dtype=torch.float64, device=dev)
        src64 = src.double()
        exact.index_add_(0, flat, src64)
        absh.index_add_(0, flat, src64.abs_())
        del src64
        exact, absh = exact.view(F, B, 4), absh.view(F, B, 4)
        bound = (exact[..., 3:] - 1).clamp(min=0) * 2.0 ** -24 \
            * absh[..., :2]
        for what, h in (("kernel", hk), ("plain version", hp)):
            herr = (h[..., :2].double() - exact[..., :2]).abs()
            check(bool((herr <= bound + 1e-30).all()), f"UNFUSED {name}: "
                  f"the {what}'s f32 sums at the root off the float64 "
                  "sums by more than (m - 1) 2^-24 of their |addends|")
            line[f"run_gradients_{what.split()[0]}_max_rel_err"] = float(
                (herr / (absh[..., :2] + 1e-30)).max())
        check(torch.equal(hk[..., 2:], hp[..., 2:]), f"UNFUSED {name}: "
              "count channels differ")
        err = float((hk - hp).abs().max())
        del exact, absh, bound

    def lib():
        lib_out.zero_()
        lib_out.index_add_(0, flat, src)
    lib()
    if quant:
        check(torch.equal(lib_out.view(F, B, 4), hk), f"UNFUSED {name}: "
              "index_add_ of the int32 channels differs from the kernel")
    line[hist_kernel] = {
        "mode": "int8" if quant else "f32", "max_abs_err": err,
        "ms": time_ms(kern),
        "plain_ms": time_ms(lambda: segment_histogram(work, 0, n, layout, B,
                                                      quant), 3, 1),
        "library_ms": time_ms(lib, 3, 1),
        "bound_ms": 1e3 * hist_bytes / HBM_BYTES_PER_S}
    del flat, src, lib_out
    if name == "narrow":
        qmax = gbdt.grower_params.quant_max
        nk = _dense_int(work, scratch, n, stride, seg, False, ch, F, B, qmax,
                        1)
        np_ = _xla_histogram_narrow(work[:, :F], ch, B, qmax)
        check(torch.equal(nk, np_) and torch.equal(nk, hk),
              "UNFUSED narrow: K1 narrowed at the root differs from its "
              "plain version or from the 32-bit kernel")
        small = 6_000
        sseg = torch.tensor([0, small, 0], dtype=torch.int32, device=dev)
        sch, _ = segment_gather(work, scratch, sseg, layout, ch_dtype, False)
        tally = torch.zeros(1, dtype=torch.int32, device=dev)
        auto = _dense_int(work, scratch, n, stride, sseg, False, sch, F, B,
                          qmax, 2, tally)
        check(int(tally) == 1 and torch.equal(
            auto, segment_histogram(work, 0, small, layout, B, True)),
              "UNFUSED narrow: the 16-bit engine on a 6,000-row leaf")
        line["histogram_narrow"] = {
            "quant_max": qmax, "max_abs_err": int((nk - np_).abs().max()),
            "ms": time_ms(lambda: _dense_int(work, scratch, n, stride, seg,
                                             False, ch, F, B, qmax, 1)),
            "int32_ms": line["histogram"]["ms"],
            "plain_ms": time_ms(lambda: _xla_histogram_narrow(
                work[:, :F], ch, B, qmax), 3, 1),
            "library_ms": line["histogram"]["library_ms"],
            "bound_ms": line["histogram"]["bound_ms"],
            "leaf_6000_ms": time_ms(lambda: _dense_int(
                work, scratch, n, stride, sseg, False, sch, F, B, qmax, 2)),
            "leaf_6000_int32_ms": time_ms(lambda: _dense_int(
                work, scratch, n, stride, sseg, False, sch, F, B, 0, 0))}
        del nk, np_, auto
    return line


def unfused_cpu_vs_card(lgt):
    """UNFUSED's four runs on 100k x 28 rows, 31 leaves, 3 rounds,
    deterministic rounding: the card against the CPU (quantized runs: 0
    differing splits; f32 within 1e-4, differing splits counted); the
    narrowed run's last tree's leaves that took the 16-bit engine (> 0,
    the CPU's count)."""
    X, y = make_higgs_like(100_000, 28, seed=21)
    get = shared_datasets(lgt)
    out = {}
    for name, (extra, _, _) in UNFUSED_RUNS.items():
        params = dict({"objective": "binary", "num_leaves": 31,
                       "verbosity": -1, "tpu_grower": "compact",
                       "tpu_fused": "off", "stochastic_rounding": False},
                      **extra)
        ds = get(X, y, extra.get("max_bin", 255))
        boosters = {dev: lgt.train(dict(params, device_type=dev), ds, 3)
                    for dev in ("cuda", "cpu")}
        diff, differ = compare_boosters(boosters["cuda"], boosters["cpu"], X)
        if "use_quantized_grad" in extra:
            check(differ == 0, f"UNFUSED {name}: {differ} splits differ "
                  "between the card and the CPU")
        check(diff <= 1e-4, f"UNFUSED {name}: card vs CPU predictions "
              f"differ by {diff}")
        out[name] = {"max_abs_pred_diff": diff, "differing_splits": differ}
        if name == "narrow":
            # the last tree's 31 histograms: the kernel's own per-leaf
            # choice takes the 16-bit engine for the CPU's leaves
            narrowed = {dev: int(b._gbdt.tree_stats["narrowed_leaves"])
                        for dev, b in boosters.items()}
            check(0 < narrowed["cuda"] == narrowed["cpu"] < 31,
                  f"UNFUSED narrow at 100k rows: {narrowed} of 31 "
                  "histograms took the 16-bit engine")
            out[name]["narrowed_leaves"] = narrowed["cuda"]
    return out


def phase_unfused(lgt, results):
    """The compact grower without the fused kernel (UNFUSED): MAIN's
    datasets and parameters with tpu_fused=off, 1 warm-up and
    UNFUSED_ROUNDS timed rounds and a profiled tree in four runs (f32 at
    255 bins: K1 dense on the records' bin columns; quantized at 255 bins:
    K1 dense int8; quantized at max_bin=63 with the sublane layout: K3
    int8; quantized with tpu_quant_hist_bits=16: K1 narrowed where a leaf
    fits it), each split K2's partition alone, the segment gather and the
    histogram; then each run's kernels at the root (unfused_root_checks)
    and the card against the CPU (unfused_cpu_vs_card)."""
    ds, dv = results["main_datasets"]
    out = {}
    for name, (extra, hist_kernel, mode) in UNFUSED_RUNS.items():
        d_t, d_v = ds, dv
        if extra.get("max_bin") == 63:
            d_t, d_v, construct_s = bin63_datasets(lgt, results)
        params = dict(MAIN_PARAMS, tpu_fused="off", **extra)
        bst, run = timed_run(lgt, params, d_t, d_v, UNFUSED_ROUNDS)
        gbdt = bst._gbdt
        gp = gbdt.grower_params
        quant = "use_quantized_grad" in extra
        launches, modes = run["launches"], run["mode_launches"]
        trees = bst.num_trees()
        run["run"] = name
        check(gbdt.use_compact and not gp.fused and not gp.fused_dual,
              f"UNFUSED {name}: not the compact grower without the fused "
              "kernel")
        check(gp.hist_layout == ("sublane" if hist_kernel
                                 == "histogram_sublane" else "lane"),
              f"UNFUSED {name}: layout {gp.hist_layout}")
        check(gbdt._quant_int == quant and gp.quant_narrow == (
            name == "narrow"), f"UNFUSED {name}: quantized path")
        splits = trees * (gp.num_leaves - 1)
        check(launches["fused_split"] == modes["fused_split/partition"]
              == splits, f"UNFUSED {name}: K2 launched "
              f"{launches['fused_split']} times, "
              f"{modes['fused_split/partition']} of them its partition "
              f"alone, for {splits} splits")
        check(launches["segment_gather"] == launches[hist_kernel]
              == trees * gp.num_leaves, f"UNFUSED {name}: the gather and "
              f"{hist_kernel} launched {launches['segment_gather']} and "
              f"{launches[hist_kernel]} times for {trees} trees")
        other = ("histogram" if hist_kernel == "histogram_sublane"
                 else "histogram_sublane")
        check(launches[other] == 0, f"UNFUSED {name}: {other} launched")
        if mode is not None:
            check(modes[mode] == launches[hist_kernel], f"UNFUSED {name}: "
                  f"{launches[hist_kernel] - modes[mode]} launches of "
                  f"{hist_kernel} outside its {mode} mode")
        for k, v in run["plain_calls"].items():
            check(v == 0, f"plain version of {k} ran {v} times on the card")
        check(run["host_syncs_in_tree_step"] == 0, f"UNFUSED {name}: host "
              "syncs inside the tree step")
        if name == "narrow":
            # the leaves that took the 16-bit engine by the kernel's own
            # choice (count x quant_max < 2^15, the reference's rule): at
            # 9.45M rows and 255 leaves few or no smaller child is that
            # small (the last tree's count); unfused_cpu_vs_card's
            # 100k-row run must take some
            run["narrowed_leaves"] = int(gbdt.tree_stats["narrowed_leaves"])
        prof = profile_tree(bst, 1.0 / run["iterations_per_s"])
        if mode is not None:
            pm = prof["modes"]
            check(pm[mode]["counted"] == prof["kernels"][hist_kernel][
                "launches"], f"UNFUSED {name}: the profiled tree ran "
                  f"{hist_kernel} outside its {mode} mode")
        run.update(tree_line(prof, gp.num_leaves - 1))
        print("UNFUSED", json.dumps(run), flush=True)
        run["root"] = unfused_root_checks(bst, name, quant, hist_kernel)
        print("UNFUSED_ROOT", json.dumps(run["root"]), flush=True)
        run["profile"] = prof
        out[name] = run
        del bst, gbdt
    out["cpu_vs_card"] = unfused_cpu_vs_card(lgt)
    print("UNFUSED_CPU_VS_CARD", json.dumps(out["cpu_vs_card"]), flush=True)
    results["unfused"] = out


PACK4_ROUNDS = 2                 # timed rounds after one warm-up round


def pack4_root_split(p4, u8, quant):
    """K2 at the root split of the last packed tree, on the packed run's
    records (nibbles) against its plain version (the children byte-equal,
    rows outside and the padding unchanged; the histogram int32-exact, or
    in f32 bit-equal on the records' gradients rounded to 1/16: a bin of
    max_bin=15 holds up to 590k rows, its sums stay below 2^20), timed
    beside K2 on the u8 run's records at the same split, each with its byte
    bound, its partition alone, K1 alone over all the rows, and stable
    argsort + index_select of its records; the bytes a partition moves a
    row, packed and u8."""
    from lightgbm_tpu_torch.ops.compact import record_column
    from lightgbm_tpu_torch.ops.fused_split import (fused_split,
                                                    fused_split_plain)
    from lightgbm_tpu_torch.ops.pallas_histogram import record_histogram
    from lightgbm_tpu_torch.ops.split import go_left_pred
    g4, g8 = p4._gbdt, u8._gbdt
    B = g4.grower_params.num_bins
    dev = g4.device
    n = g4.num_data
    tree = g4.models[-1]
    f, b = int(tree.split_feature[0]), int(tree.split_bin[0])
    dl, nan = int(tree.default_left[0]), int(g4.nan_bin_arr[f])
    none = torch.zeros(8, dtype=torch.int32, device=dev)
    line = {"rows": n, "feature": f, "bin": b}
    for what, g in (("packed4", g4), ("u8", g8)):
        layout = g.layout
        work = g.work.clone() if quant else dyadic_records(g.work, layout,
                                                           16)
        scratch = torch.zeros_like(work)
        gl = go_left_pred(record_column(work, f, layout), b, bool(dl), nan,
                          False, none)
        n_left = int(gl.sum())
        args = (0, 0, n, n_left, f, b, dl, nan, 0, None, layout, B)
        if what == "packed4":
            before = (work.clone(), scratch.clone())
            wk, sk = before[0].clone(), before[1].clone()
            _, _, hk = fused_split(wk, sk, *args, quant=quant)
            wp, spl = before[0].clone(), before[1].clone()
            _, _, hp = fused_split_plain(wp, spl, *args, quant=quant)
            torch.cuda.synchronize()
            check_split((wk, sk), (wp, spl), before, 0, n, n_left, 0, layout,
                        "K2 packed4 at the root split")
            check(torch.equal(hk, hp), "K2 packed4 at the root split: "
                  "histograms differ")
            line["max_abs_err"] = float((hk - hp).abs().max())
            del before, wk, sk, wp, spl, hk, hp
        calls = [0]

        def alternating():
            fused_split(work, scratch, *args, side=calls[0] % 2, quant=quant)
            calls[0] += 1

        def partition():
            fused_split(work, scratch, *args, side=calls[0] % 2, quant=quant,
                        hist=False)
            calls[0] += 1

        def library():
            perm = torch.argsort(gl.to(torch.uint8), stable=True)
            torch.index_select(work, 0, perm, out=scratch)
        n_small = min(n_left, n - n_left)
        root = torch.tensor([0, n, 0], dtype=torch.int32, device=dev)
        line[what] = {
            "ms": time_ms(alternating),
            # its two halves apart: the partition alone, and K1 in record
            # mode over all the rows
            "partition_ms": time_ms(partition),
            "k1_root_ms": time_ms(lambda: record_histogram(
                work, scratch, root, layout, B, quant)),
            "plain_ms": time_ms(lambda: fused_split_plain(
                work, scratch, *args, quant=quant), 3, 1),
            "library_ms": time_ms(library, 3, 1),
            "bound_ms": 1e3 * (2 * n * layout.num_real_cols + n_small
                               * record_row_bytes(layout)) / HBM_BYTES_PER_S,
            "moved_bytes_a_row": layout.moved_cols,
            "real_bytes_a_row": layout.num_real_cols}
        del work, scratch, gl
    return line


def pack4_cpu_vs_card(lgt):
    """Packed runs on 100k x 28 rows at max_bin=15, 31 leaves, 3 rounds,
    deterministic rounding: the card against the CPU (quantized: 0
    differing splits; f32 within 1e-4, differing splits counted)."""
    X, y = make_higgs_like(100_000, 28, seed=23)
    ds = lgt.Dataset(X, y, params={"max_bin": 15})
    out = {}
    for name, extra in (("f32", {}), ("quant", {"use_quantized_grad": True})):
        params = dict({"objective": "binary", "num_leaves": 31,
                       "max_bin": 15, "verbosity": -1,
                       "tpu_grower": "compact", "tpu_bin_pack4": True,
                       "stochastic_rounding": False}, **extra)
        boosters = {dev: lgt.train(dict(params, device_type=dev), ds, 3)
                    for dev in ("cuda", "cpu")}
        check(boosters["cuda"]._gbdt.layout.packed4, "PACK4 check: not packed")
        diff, differ = compare_boosters(boosters["cuda"], boosters["cpu"], X)
        if extra:
            check(differ == 0, f"PACK4 {name}: {differ} splits differ "
                  "between the card and the CPU")
        check(diff <= 1e-4, f"PACK4 {name}: card vs CPU predictions differ "
              f"by {diff}")
        out[name] = {"max_abs_pred_diff": diff, "differing_splits": differ}
    return out


def phase_pack4(lgt, results):
    """4-bit packed bins (PACK4): MAIN's rows binned at max_bin=15, MAIN's
    parameters with tpu_bin_pack4=true, 1 warm-up and PACK4_ROUNDS timed
    rounds, in f32 and quantized, each beside the u8 run on the same
    binning (quantized: equal trees; f32 within 1e-4, differing splits
    counted) and a profiled packed f32 tree: every K2 and K1 launch on
    nibble-packed records, packed and u8 prediction of the packed booster
    equal on the validation rows; then K2 packed4 at the root split
    (pack4_root_split) and the card against the CPU (pack4_cpu_vs_card)."""
    X, y, _, n_val = results["higgs"]
    t1 = time.perf_counter()
    ds = lgt.Dataset(X[:-n_val], y[:-n_val], params={"max_bin": 15})
    dv = ds.create_valid(X[-n_val:], y[-n_val:])
    ds.construct()
    dv.construct()
    out = {"construct_s": time.perf_counter() - t1}
    Xv = X[-n_val:]
    for name, extra in (("f32", {}), ("quant", {"use_quantized_grad": True})):
        params = dict(MAIN_PARAMS, max_bin=15, **extra)
        u8, ru8 = timed_run(lgt, params, ds, dv, PACK4_ROUNDS)
        p4, run = timed_run(lgt, dict(params, tpu_bin_pack4=True), ds, dv,
                            PACK4_ROUNDS)
        g4 = p4._gbdt
        gp = g4.grower_params
        launches, modes = run["launches"], run["mode_launches"]
        trees = p4.num_trees()
        check(not u8._gbdt.layout.packed4, "PACK4: the u8 run is packed")
        check(g4.use_compact and g4.layout.packed4 and gp.bin_pack4
              and g4._pred_pack4 and gp.fused, f"PACK4 {name}: not the "
              "packed compact path")
        check(launches["fused_split"] == modes["fused_split/packed4"]
              == trees * gp.num_leaves, f"PACK4 {name}: K2 launched "
              f"{launches['fused_split']} times, "
              f"{modes['fused_split/packed4']} on packed records")
        check(launches["histogram"] == modes["histogram/packed4"]
              == launches["fused_split"], f"PACK4 {name}: K1's record "
              "launches are not all on packed records")
        for k, v in run["plain_calls"].items():
            check(v == 0, f"plain version of {k} ran {v} times on the card")
        check(run["host_syncs_in_tree_step"] == 0, f"PACK4 {name}: host "
              "syncs inside the tree step")
        p_packed = p4.predict(Xv)
        g4._pred_pack4 = False
        p_plain = p4.predict(Xv)
        g4._pred_pack4 = True
        check(np.array_equal(p_packed, p_plain), f"PACK4 {name}: packed and "
              "u8 prediction differ on the validation rows")
        diff, differ = compare_boosters(p4, u8, Xv[:200_000])
        if extra:
            check(differ == 0 and diff <= 1e-6, f"PACK4 {name}: packed and "
                  f"u8 runs differ ({differ} splits, {diff})")
        else:
            check(diff <= 1e-4, f"PACK4 {name}: packed and u8 predictions "
                  f"differ by {diff}")
        run.update({"run": name, "u8_iterations_per_s":
                    ru8["iterations_per_s"], "u8_valid_auc": ru8["valid_auc"],
                    "vs_u8_max_abs_pred_diff": diff,
                    "vs_u8_differing_splits": differ,
                    "record_bytes": g4.layout.num_cols,
                    "moved_bytes_a_row": g4.layout.moved_cols,
                    "u8_moved_bytes_a_row": u8._gbdt.layout.moved_cols})
        if name == "f32":
            prof = profile_tree(p4, 1.0 / run["iterations_per_s"])
            run.update(tree_line(prof, gp.num_leaves - 1))
            run["profile"] = prof
        print("PACK4", json.dumps({k: v for k, v in run.items()
                                   if k != "profile"}), flush=True)
        run["root_split"] = pack4_root_split(p4, u8, bool(extra))
        print("PACK4_ROOT_SPLIT", json.dumps(run["root_split"]), flush=True)
        out[name] = run
        del u8, p4, g4
    del ds, dv
    out["cpu_vs_card"] = pack4_cpu_vs_card(lgt)
    print("PACK4_CPU_VS_CARD", json.dumps(out["cpu_vs_card"]), flush=True)
    results["pack4"] = out


def phase_masked_large(lgt, rows, results):
    """The masked grower at the main path's row count: the Higgs-shaped
    rows of the main path (no second generation) binned at max_bin=63 with
    tpu_grower=masked and the sublane layout (K3 only), 63 leaves, learning
    rate 0.1, min_data_in_leaf 100; 1 warm-up and 2 timed rounds, then one
    profiled tree with K3's device ms beside its byte bound a tree."""
    from lightgbm_tpu_torch import _kernels
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    X, y, _, n_val = results["higgs"]
    Xt, yt, Xv, yv = X[:-n_val], y[:-n_val], X[-n_val:], y[-n_val:]
    rounds = 2
    params = {"objective": "binary", "metric": "auc", "num_leaves": 63,
              "max_bin": 63, "learning_rate": 0.1, "min_data_in_leaf": 100,
              "verbosity": -1, "device_type": "cuda", "tpu_grower": "masked",
              "tpu_hist_layout": "sublane"}
    syncs = {}
    ends = []

    def timer(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    timer.order = 5

    # the max_bin=63 datasets UNFUSED's sublane run made, then released
    ds, dv, construct_s = bin63_datasets(lgt, results)
    results.pop("bin63_datasets")
    evals = {}
    _kernels.reset_counts()
    with count_syncs(gbdt_mod, ["grow_tree"], syncs):
        bst = lgt.train(params, ds, 1 + rounds, valid_sets=[dv],
                        callbacks=[timer, lgt.record_evaluation(evals)])
    launches = dict(_kernels.LAUNCHES)
    plain_calls = dict(_kernels.PLAIN_CALLS)
    check(len(ends) == 1 + rounds, f"trained {len(ends)} rounds")
    it_s = rounds / (ends[-1] - ends[0])
    auc = evals["valid_0"]["auc"][-1]
    out = {"train_rows": len(yt), "valid_rows": len(yv), "rounds_timed":
           rounds, "iterations_per_s": it_s, "construct_s": construct_s,
           "valid_auc": auc, "launches": launches, "plain_calls":
           plain_calls, "host_syncs_in_tree": syncs.get("in_tree"),
           "num_trees": bst.num_trees(),
           "hist_layout": bst._gbdt.grower_params.hist_layout}
    if rows < 10_500_000:
        out["note"] = "rows lowered by --rows"
    print("MASKED_LARGE", json.dumps(out), flush=True)
    check(not bst._gbdt.use_compact, "tpu_grower=masked took the compact "
          "grower")
    check(out["hist_layout"] == "sublane", "the large-N masked path did not "
          "take the sublane layout")
    check(launches["histogram_sublane"] > 0, "K3 was not launched on the "
          "large-N masked path")
    check(launches["histogram"] == 0 and launches["fused_split"] == 0,
          f"K1/K2 launched on the masked sublane path: {launches}")
    for k, v in plain_calls.items():
        check(v == 0, f"plain version of {k} ran {v} times on the card")
    check(np.isfinite(auc) and auc > 0.7, f"validation AUC {auc}")
    check(syncs.get("in_tree") == 0, "host syncs inside the split loop")
    out["profile"] = profile_tree(bst, 1.0 / it_s)
    results["masked_large"] = out


def phase_masked(lgt, results):
    """The masked path: the training stage of bench.py's serving bench
    (bench.py:769-776) with the sublane layout, then the CPU, the lane
    layout and a saved and reloaded model on the same data."""
    from lightgbm_tpu_torch import _kernels
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    rounds = 20
    X, y = make_higgs_like(22_000, 28)
    Xt, yt, Xv, yv = X[:20_000], y[:20_000], X[20_000:], y[20_000:]
    params = {"objective": "binary", "metric": "auc", "num_leaves": 63,
              "max_bin": 63, "learning_rate": 0.1, "min_data_in_leaf": 20,
              "verbosity": -1, "tpu_hist_layout": "sublane"}
    syncs = {}
    ends = []

    def timer(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    timer.order = 5

    evals = {}
    _kernels.reset_counts()
    with count_syncs(gbdt_mod, ["grow_tree"], syncs):
        t_start = time.perf_counter()
        ds = lgt.Dataset(Xt, yt)
        bst = lgt.train(dict(params, device_type="cuda"), ds, rounds,
                        valid_sets=[ds.create_valid(Xv, yv)],
                        callbacks=[timer, lgt.record_evaluation(evals)])
    launches = dict(_kernels.LAUNCHES)
    plain_calls = dict(_kernels.PLAIN_CALLS)
    check(len(ends) == rounds, f"trained {len(ends)} rounds")
    it_s = (rounds - 1) / (ends[-1] - ends[0])
    auc = evals["valid_0"]["auc"][-1]
    out = {"train_rows": 20_000, "valid_rows": 2_000, "rounds": rounds,
           "iterations_per_s": it_s, "first_round_s": ends[0] - t_start,
           "valid_auc": auc, "launches": launches, "plain_calls": plain_calls,
           "host_syncs_in_tree": syncs.get("in_tree"),
           "num_trees": bst.num_trees(),
           "hist_layout": bst._gbdt.grower_params.hist_layout}
    print("MASKED", json.dumps(out), flush=True)
    check(not bst._gbdt.use_compact, "20k rows did not take the masked "
          "grower")
    check(launches["histogram_sublane"] > 0, "K3 was not launched on the "
          "masked path")
    check(launches["histogram"] == 0 and launches["fused_split"] == 0,
          f"K1/K2 launched on the masked sublane path: {launches}")
    for k, v in plain_calls.items():
        check(v == 0, f"plain version of {k} ran {v} times on the card")
    check(np.isfinite(auc) and auc > 0.7, f"validation AUC {auc}")
    check(syncs.get("in_tree") == 0, "host syncs inside the split loop")

    pred = bst.predict(X)
    check(np.all(np.isfinite(pred)) and pred.shape == (22_000,),
          "masked-path predictions")
    cpu = lgt.train(dict(params, device_type="cpu"), lgt.Dataset(Xt, yt),
                    rounds)
    _kernels.reset_counts()
    lane = lgt.train(dict(params, device_type="cuda", tpu_hist_layout="lane"),
                     lgt.Dataset(Xt, yt), rounds)
    lane_launches = dict(_kernels.LAUNCHES)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.txt")
        bst.save_model(path)
        back = lgt.Booster(model_file=path)
        reload_diff = float(np.abs(back.predict(X) - pred).max())
    cpu_diff, differ = compare_boosters(bst, cpu, X)
    cmp = {"cpu_max_abs_pred_diff": cpu_diff,
           "cpu_differing_splits": differ,
           "lane_max_abs_pred_diff":
               float(np.abs(lane.predict(X) - pred).max()),
           "lane_launches": lane_launches,
           "reload_max_abs_pred_diff": reload_diff}
    print("MASKED_CHECKS", json.dumps(cmp), flush=True)
    check(cmp["cpu_max_abs_pred_diff"] <= 1e-4, "masked path: card vs CPU")
    check(cmp["lane_max_abs_pred_diff"] <= 1e-4, "masked path: sublane vs "
          "lane")
    check(lane_launches["histogram"] > 0
          and lane_launches["histogram_sublane"] == 0,
          f"the lane layout did not run K1: {lane_launches}")
    check(reload_diff <= 1e-6, f"reloaded model differs by {reload_diff}")
    out.update(cmp)
    out["profile"] = profile_tree(bst, 1.0 / it_s)
    results["masked"] = out


def categorical_split_counts(bst):
    """(one-hot, sorted) categorical splits in a booster's trees: a
    categorical feature of at most max_cat_to_onehot bins splits one-hot."""
    gbdt = bst._gbdt
    onehot_max = int(gbdt.config.get("max_cat_to_onehot", 4))
    counts = [0, 0]
    for t in gbdt.models:
        for f in t.split_feature[:t.num_nodes]:
            m = gbdt.mappers[int(f)]
            if m.is_categorical:
                counts[m.num_bins > onehot_max] += 1
    return tuple(counts)


def check_k2_grown_split(bst):
    """K2 against its plain version on the multiclass record array (all
    training rows, the wider record) with a sorted categorical split the
    grower chose: its feature and its 8-word bin bitset, as the root split
    of the whole array, on integer grad and hess (bit-equal histograms);
    then its time there and its byte bound."""
    from lightgbm_tpu_torch.ops.fused_split import (fused_split,
                                                    fused_split_plain)
    from lightgbm_tpu_torch.ops.split import go_left_pred
    gbdt = bst._gbdt
    layout = gbdt.layout
    B = gbdt.grower_params.num_bins
    onehot_max = int(gbdt.config.get("max_cat_to_onehot", 4))
    node = None
    for t in reversed(gbdt.models):
        for i in range(t.num_nodes):
            m = gbdt.mappers[int(t.split_feature[i])]
            if m.is_categorical and m.num_bins > onehot_max:
                node = (int(t.split_feature[i]), t.cat_bitset[i])
                break
        if node is not None:
            break
    check(node is not None, "no sorted categorical split in the trees")
    feat, words = node
    dev = gbdt.work.device
    bits = torch.from_numpy(np.ascontiguousarray(words).view(
        np.int32)).to(dev)
    check(bits.numel() == -(-B // 32), f"bitset of {bits.numel()} words")
    n = gbdt.num_data
    work, scratch = gbdt.work.clone(), torch.zeros_like(gbdt.work)
    # integer grad and hess: a categorical bin may hold millions of rows,
    # and integer partial sums below 2^24 are exact in f32 whatever the
    # order, so kernel and plain version must agree bit for bit
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    ints = torch.stack([torch.randint(-1, 2, (n,), generator=g, device=dev),
                        torch.randint(0, 2, (n,), generator=g, device=dev)],
                       dim=1).float()
    work[:, layout.grad_off:layout.grad_off + 8] = ints.view(torch.uint8)
    del ints
    n_left = int(go_left_pred(work[:n, feat], 0, False, 0, True,
                              bits).sum())
    args = (0, 0, n, n_left, feat, 0, 0, 0, 1, bits, layout, B)
    wk, sk = work.clone(), scratch.clone()
    _, _, hk = fused_split(wk, sk, *args, side=0)
    wp, spl = work.clone(), scratch.clone()
    _, _, hp = fused_split_plain(wp, spl, *args, side=0)
    check_split((wk, sk), (wp, spl), (work, scratch), 0, n, n_left, 0,
                layout, "K2 grown categorical split")
    err = hist_close(hk, hp, hp, "K2 grown categorical split", 0)
    del wk, sk, wp, spl, hk, hp
    calls = [0]

    def alternating():
        fused_split(work, scratch, *args, side=calls[0] % 2)
        calls[0] += 1
    n_small = min(n_left, n - n_left)
    line = {"rows": n, "feature": feat, "bitset_words": bits.numel(),
            "bins_left": int(sum(bin(int(w)).count("1")
                                 for w in np.asarray(words))),
            "n_left": n_left, "max_abs_err": err,
            "record_real_bytes": layout.num_real_cols,
            "moved_bytes": layout.moved_cols,
            "kernel_ms": time_ms(alternating),
            "bound_ms": 1e3 * (2 * n * layout.num_real_cols
                               + n_small * RECORD_ROW_BYTES)
            / HBM_BYTES_PER_S}
    print("K2_CATEGORICAL", json.dumps(line), flush=True)
    del work, scratch
    return line


def phase_multiclass(lgt, rows, results):
    """The compact path with multiclass and categorical splits at the main
    path's row count: the main path's Higgs-shaped rows (no second
    generation) with a 5-class label and five categorical columns
    (make_higgs_multiclass_like), objective=multiclass, 255 leaves, 255
    bins, 10% validation, 1 warm-up and 1 timed round (5 trees a round;
    one round keeps the smoke within its time); then K2 on a grown
    categorical split, a profiled round, and the card against the CPU at
    70k rows."""
    from lightgbm_tpu_torch import _kernels
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    X, _, logits, n_val = results.pop("higgs")
    t0 = time.perf_counter()
    X, y = make_higgs_multiclass_like(X, logits)
    label_s = time.perf_counter() - t0
    Xt, yt, Xv, yv = X[:-n_val], y[:-n_val], X[-n_val:], y[-n_val:]
    rounds = 1
    syncs = {}
    ends = []

    def timer(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    timer.order = 5

    t1 = time.perf_counter()
    ds = lgt.Dataset(Xt, yt, categorical_feature=MC_CATS)
    dv = ds.create_valid(Xv, yv)
    ds.construct()
    dv.construct()
    construct_s = time.perf_counter() - t1
    evals = {}
    _kernels.reset_counts()
    with count_syncs(gbdt_mod, ["grow_tree_compact"], syncs):
        bst = lgt.train(dict(MC_PARAMS, device_type="cuda"), ds, 1 + rounds,
                        valid_sets=[dv],
                        callbacks=[timer, lgt.record_evaluation(evals)])
    launches = dict(_kernels.LAUNCHES)
    plain_calls = dict(_kernels.PLAIN_CALLS)
    check(len(ends) == 1 + rounds, f"trained {len(ends)} rounds")
    it_s = rounds / (ends[-1] - ends[0])
    logloss = evals["valid_0"]["multi_logloss"][-1]
    error = evals["valid_0"]["multi_error"][-1]
    onehot, sorted_ = categorical_split_counts(bst)
    lay = bst._gbdt.layout
    out = {"train_rows": len(yt), "valid_rows": len(yv), "classes":
           MC_CLASSES, "rounds_timed": rounds, "iterations_per_s": it_s,
           "trees_per_s": it_s * MC_CLASSES, "construct_s": construct_s,
           "label_and_codes_s": label_s, "valid_multi_logloss": logloss,
           "valid_multi_error": error, "class_prior_logloss":
           float(np.log(MC_CLASSES)), "launches": launches,
           "launches_per_round": {k: v / (1 + rounds)
                                  for k, v in launches.items()},
           "plain_calls": plain_calls,
           "host_syncs_in_tree": syncs.get("in_tree"),
           "num_trees": bst.num_trees(), "onehot_splits": onehot,
           "sorted_cat_splits": sorted_, "record_bytes": lay.num_cols,
           "record_real_bytes": lay.num_real_cols,
           "moved_bytes": lay.moved_cols}
    if rows < 10_500_000:
        out["note"] = "rows lowered by --rows"
    print("MULTICLASS", json.dumps(out), flush=True)
    check(bst._gbdt.use_compact, "the multiclass phase did not take the "
          "compact grower")
    check(launches["histogram"] > 0 and launches["fused_split"] > 0,
          f"K1/K2 not launched on the multiclass compact path: {launches}")
    check(launches["histogram_sublane"] == 0, "K3 launched on the compact "
          "path")
    for k, v in plain_calls.items():
        check(v == 0, f"plain version of {k} ran {v} times on the card")
    check(syncs.get("in_tree") == 0, "host syncs inside the split loop")
    check(onehot > 0 and sorted_ > 0, f"categorical splits: {onehot} "
          f"one-hot, {sorted_} sorted")
    check(np.isfinite(logloss) and logloss < np.log(MC_CLASSES),
          f"validation multi_logloss {logloss} not below the class prior's")
    out["k2_categorical"] = check_k2_grown_split(bst)
    out["profile"] = profile_tree(bst, 1.0 / (it_s * MC_CLASSES),
                                  (gbdt_mod, "grow_tree_compact"))
    del bst, ds, dv, X, Xt, Xv
    out["cpu_vs_card"] = multiclass_cpu_vs_card(lgt)
    results["multiclass"] = out


def tie_free_weights(n, seed=13):
    """Row weights for the multiclass card-against-CPU comparisons. In the
    first round the softmax gradients take two values (1/K - y), so two
    categories with the same class counts have equal sums and tie exactly in
    the sorted scan: f32 summation order (the card's atomics, the CPU's row
    order) then picks one of two different category sets, and the models
    part. Continuous weights leave no such exact tie (a deep model can
    still part at a near tie: phase_multiclass_masked's control)."""
    return np.random.RandomState(seed).uniform(0.5, 1.5, n)


def multiclass_cpu_vs_card(lgt):
    """The multiclass phase's configuration at 70k rows (the compact
    grower still takes it), 31 leaves and 1 round of 5 trees (sized for the
    smoke's time), on weighted rows (tie_free_weights), on the card and on the
    CPU: every class probability within 1e-4, differing splits counted."""
    X, _, logits = make_higgs_like(70_000, 28, seed=11, with_logits=True)
    X, y = make_higgs_multiclass_like(X, logits)
    w = tie_free_weights(len(y))
    params = dict(MC_PARAMS, num_leaves=31)
    boosters = {dev: lgt.train(dict(params, device_type=dev),
                               lgt.Dataset(X, y, weight=w,
                                           categorical_feature=MC_CATS),
                               1) for dev in ("cuda", "cpu")}
    check(boosters["cuda"]._gbdt.use_compact, "70k rows did not take the "
          "compact grower")
    diff, differ = compare_boosters(boosters["cuda"], boosters["cpu"], X)
    out = {"rows": 70_000, "rounds": 1, "weighted": True,
           "max_abs_prob_diff": diff,
           "differing_splits": differ,
           "categorical_splits": categorical_split_counts(boosters["cuda"])}
    print("MULTICLASS_CPU_VS_CARD", json.dumps(out), flush=True)
    check(diff <= 1e-4, f"multiclass card vs CPU probabilities differ by "
          f"{diff}")
    return out


# the multiclass masked path's rounds: cut from 20 (173-192 s of the
# smoke on the H100) to keep the whole smoke within its time limit
MC_MASKED_ROUNDS = 4


def phase_multiclass_masked(lgt, results):
    """The masked grower with multiclass and categorical splits: the
    serving bench's 20k x 28 rows (bench.py:769-776) with the multiclass
    case's label and categorical columns, max_bin=63, 63 leaves, the
    sublane layout (K3), MC_MASKED_ROUNDS rounds; the saved and reloaded
    model; the card against the CPU, checked at 3 rounds on weighted rows
    (tie_free_weights) beside a CPU control (the CPU against itself with
    the rows weighted 1 + 1e-6 x noise), which agrees there (no comparison
    at the run's rounds: a model this deep is bistable, PERF.md section
    6); and one
    objective=regression run with the categorical columns on the card
    against the CPU."""
    from lightgbm_tpu_torch import _kernels
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    rounds = MC_MASKED_ROUNDS
    X, _, logits = make_higgs_like(22_000, 28, with_logits=True)
    X, y = make_higgs_multiclass_like(X, logits)
    Xt, yt, Xv, yv = X[:20_000], y[:20_000], X[20_000:], y[20_000:]
    params = dict(MC_PARAMS, num_leaves=63, max_bin=63, min_data_in_leaf=20,
                  tpu_hist_layout="sublane")
    syncs = {}
    ends = []

    def timer(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    timer.order = 5

    def dataset(X_, y_, w=None):
        return lgt.Dataset(X_, y_, weight=w, categorical_feature=MC_CATS)

    evals = {}
    _kernels.reset_counts()
    with count_syncs(gbdt_mod, ["grow_tree"], syncs):
        ds = dataset(Xt, yt)
        bst = lgt.train(dict(params, device_type="cuda"), ds, rounds,
                        valid_sets=[ds.create_valid(Xv, yv)],
                        callbacks=[timer, lgt.record_evaluation(evals)])
    launches = dict(_kernels.LAUNCHES)
    plain_calls = dict(_kernels.PLAIN_CALLS)
    check(len(ends) == rounds, f"trained {len(ends)} rounds")
    it_s = (rounds - 1) / (ends[-1] - ends[0])
    onehot, sorted_ = categorical_split_counts(bst)
    out = {"train_rows": 20_000, "valid_rows": 2_000, "rounds": rounds,
           "iterations_per_s": it_s, "trees_per_s": it_s * MC_CLASSES,
           "valid_multi_logloss": evals["valid_0"]["multi_logloss"][-1],
           "valid_multi_error": evals["valid_0"]["multi_error"][-1],
           "launches": launches, "plain_calls": plain_calls,
           "host_syncs_in_tree": syncs.get("in_tree"),
           "num_trees": bst.num_trees(), "onehot_splits": onehot,
           "sorted_cat_splits": sorted_,
           "hist_layout": bst._gbdt.grower_params.hist_layout}
    print("MULTICLASS_MASKED", json.dumps(out), flush=True)
    check(not bst._gbdt.use_compact, "20k rows did not take the masked "
          "grower")
    check(launches["histogram_sublane"] > 0, "K3 was not launched on the "
          "masked multiclass path")
    check(launches["histogram"] == 0 and launches["fused_split"] == 0,
          f"K1/K2 launched on the masked sublane path: {launches}")
    for k, v in plain_calls.items():
        check(v == 0, f"plain version of {k} ran {v} times on the card")
    check(syncs.get("in_tree") == 0, "host syncs inside the split loop")
    check(onehot > 0 and sorted_ > 0, f"categorical splits: {onehot} "
          f"one-hot, {sorted_} sorted")

    pred = bst.predict(X)
    check(np.all(np.isfinite(pred)) and pred.shape == (22_000, MC_CLASSES),
          "masked multiclass predictions")
    def train(dev, w, n_rounds):
        return lgt.train(dict(params, device_type=dev), dataset(Xt, yt, w),
                         n_rounds)
    w = tie_free_weights(len(yt))
    nudged = 1.0 + 1e-6 * np.random.RandomState(17).randn(len(yt))
    # checked: 3 rounds on weighted rows (tie_free_weights), as the compact
    # phase compares, where the same CPU control shows the comparison is
    # well posed
    shallow = 3
    cpu_w = train("cpu", w, shallow)
    control = compare_boosters(train("cpu", w * nudged, shallow), cpu_w, X)
    cpu_diff, cpu_differ = compare_boosters(train("cuda", w, shallow), cpu_w,
                                            X)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.txt")
        bst.save_model(path)
        back = lgt.Booster(model_file=path)
        reload_diff = float(np.abs(back.predict(X) - pred).max())
    # a pointwise objective on the card: regression on the logits
    reg = {"objective": "regression", "num_leaves": 63, "max_bin": 63,
           "min_data_in_leaf": 20, "tpu_hist_layout": "sublane",
           "verbosity": -1}
    _kernels.reset_counts()
    reg_card = lgt.train(dict(reg, device_type="cuda"),
                         dataset(Xt, logits[:20_000]), 5)
    reg_launches = dict(_kernels.LAUNCHES)
    reg_cpu = lgt.train(dict(reg, device_type="cpu"),
                        dataset(Xt, logits[:20_000]), 5)
    reg_diff, _ = compare_boosters(reg_card, reg_cpu, X)
    cmp = {"rounds_3_weighted": {"card_vs_cpu": [cpu_diff, cpu_differ],
                                 "cpu_vs_nudged_cpu": control},
           "reload_max_abs_prob_diff": reload_diff,
           "regression_cpu_max_abs_pred_diff": reg_diff,
           "regression_launches": reg_launches,
           "regression_categorical_splits":
               categorical_split_counts(reg_card)}
    print("MULTICLASS_MASKED_CHECKS", json.dumps(cmp), flush=True)
    check(control[0] <= 1e-4, f"masked multiclass: the 3-round CPU control "
          f"parts by {control[0]}; the card comparison is not well posed")
    check(cpu_diff <= 1e-4, f"masked multiclass: card vs CPU on weighted "
          f"rows {cpu_diff}")
    check(reload_diff <= 1e-6, f"reloaded model differs by {reload_diff}")
    check(reg_launches["histogram_sublane"] > 0, "K3 not launched by the "
          "regression run")
    check(reg_diff <= 1e-4, f"regression: card vs CPU {reg_diff}")
    out.update(cmp)
    results["multiclass_masked"] = out


# the device functions of each kernel of the port, as the profiler names them
KERNEL_FUNCTIONS = {"histogram": ("hist_kernel", "hist_wide_kernel"),
                    "fused_split": ("prep_kernel", "partition_kernel",
                                    "copyback_kernel"),
                    "histogram_sublane": ("hist_sublane_kernel",
                                          "hist_sublane_small_kernel"),
                    "monotone_walk": ("monotone_walk_kernel",),
                    "treeshap": ("treeshap_kernel",),
                    "segment_gather": ("gather_kernel",)}
# of those, the ones of which exactly one runs for each launch a wrapper
# counts (K2's partition does not run for the root's histogram, mode 1)
ENTRY_FUNCTIONS = {"histogram": ("hist_kernel", "hist_wide_kernel"),
                   "fused_split": ("prep_kernel",),
                   "histogram_sublane": ("hist_sublane_kernel",
                                         "hist_sublane_small_kernel"),
                   "monotone_walk": ("monotone_walk_kernel",),
                   "treeshap": ("treeshap_kernel",),
                   "segment_gather": ("gather_kernel",)}


# the device functions of a kernel mode that has its own instantiations (a
# pattern of the profiler's demangled name, spaces removed): K1's integer
# variants in record and in dense mode (the narrowed mode is a branch of
# the dense one), K3's int32 accumulator, K1's wide-bin kernel and
# TreeSHAP on uint16 rows. K2's quant and packed4 modes run the same
# partition functions as its f32 mode, K1's packed4 the same record
# functions
MODE_FUNCTIONS = {
    "histogram/quant": r"hist_kernel<true,true>",
    "histogram/int8": r"hist_kernel<false,true>",
    "histogram/u16": r"hist_wide_kernel\(",
    "treeshap/u16": r"treeshap_kernel<(unsignedshort|ushort|uint16_t)>",
    "histogram_sublane/int8": r"hist_sublane(_small)?_kernel<(true|false),"
                              r"\d,int>"}


# the port's profiler ranges (ops/grower_compact.py, boosting/dart.py)
PROFILER_RANGES = ("monotone_rescan", "dart_drop", "dart_normalize")


def trace_events(prof):
    """A finished trace's events as ``(name, on the device, start us, end
    us)``, read from the profiler's raw results: torch's ``prof.events()``
    builds a tree of Python objects first, tens of seconds of host time for
    the 200k events of a traced tree (its filter of hidden events kept)."""
    from torch.autograd import DeviceType
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    check(raw is not None and hasattr(raw, "events")
          and hasattr(raw, "trace_start_ns"),
          f"torch {torch.__version__}'s profiler has no kineto_results: "
          "trace_events cannot read the raw events")
    # times from the trace's start, in exact integer ns first: an epoch
    # time in ns is past 2^53, and a float64 of it steps by 256 ns
    t0 = raw.trace_start_ns()
    return [(e.name(), e.device_type() == DeviceType.CUDA,
             (e.start_ns() - t0) * 1e-3, (e.end_ns() - t0) * 1e-3)
            for e in raw.events()
            if not getattr(e, "is_hidden_event", lambda: False)()]


def event_totals(events):
    """Per device kernel's name its (calls, device us), and the
    ``cudaLaunchKernel`` calls, of ``(name, on the device, start, end)``
    events, as ``profile_tree`` counts them."""
    by_name, launches = {}, 0
    for name, cuda, start, end in events:
        if cuda and name not in PROFILER_RANGES:
            n, us = by_name.get(name, (0, 0.0))
            by_name[name] = (n + 1, us + end - start)
        elif name == "cudaLaunchKernel":
            launches += 1
    return by_name, launches


def phase_trace_check(results):
    """TRACE_CHECK: ``trace_events`` (the profiler's raw events, a private
    attribute of torch's profiler) against torch's public ``prof.events()``
    on a small trace with a profiler range: the same kernels, calls and
    launches, and device us within 0.01 us an event. Every profiled number
    of the run comes from ``trace_events``, so a torch that counts its raw
    events otherwise fails the run here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.zeros(1 << 16, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # a trace late in a process loses its first device activities (on
        # an H100, 40 of 64 adds at the end of this script): warm up first,
        # as profile_tree does
        for _ in range(256):
            x.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(64):
            x.add_(1.0)
        with torch.profiler.record_function(PROFILER_RANGES[-1]):
            x.mul_(0.5)
            torch.cumsum(x, 0)
        torch.cuda.synchronize()
    raw, raw_launches = event_totals(trace_events(prof))
    public, public_launches = event_totals(
        (e.name, e.device_type == DeviceType.CUDA, e.time_range.start,
         e.time_range.end) for e in prof.events())
    # the host's launches are all there; the device's kernels at least
    # those after the warm-up
    check(sum(n for n, _ in raw.values()) >= 67 and raw_launches >= 323,
          f"the trace check's trace is short: {raw}, {raw_launches}")
    check({k: n for k, (n, _) in raw.items()}
          == {k: n for k, (n, _) in public.items()}
          and raw_launches == public_launches,
          f"raw trace events {raw} ({raw_launches} launches) against "
          f"prof.events() {public} ({public_launches})")
    worst = max(abs(raw[k][1] - public[k][1]) / raw[k][0] for k in raw)
    check(worst <= 0.01, f"raw trace events' device us differ from "
          f"prof.events()' by {worst} us an event")
    out = {"kernels": len(raw), "calls": sum(n for n, _ in raw.values()),
           "launches": raw_launches, "worst_us_an_event": worst}
    print("TRACE_CHECK", json.dumps(out), flush=True)
    results["trace_check"] = out


def in_spans(spans, t):
    """Whether time ``t`` lies in one of the sorted, disjoint ``spans``."""
    import bisect
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and t <= spans[i][1]


def _named(name, fns):
    return any(fn + "<" in name or fn + "(" in name for fn in fns)


def _mode_named(name, mode):
    import re
    return re.search(MODE_FUNCTIONS[mode], name.replace(" ", "")) is not None


def smaller_child_rows(tree):
    """(root rows, sum over the tree's splits of the smaller child's
    rows) from its node counts."""
    cnt = np.asarray(tree.internal_count, np.float64)[:tree.num_nodes]
    leaf = np.asarray(tree.leaf_count, np.float64)

    def rows(child):
        return cnt[child] if child >= 0 else leaf[-child - 1]
    smaller = sum(min(rows(int(tree.left_child[i])),
                      rows(int(tree.right_child[i])))
                  for i in range(tree.num_nodes))
    n = float(cnt[0]) if tree.num_nodes else float(leaf[0])
    return n, smaller


def record_row_bytes(layout):
    """Bytes K1 must read of a record: the 32-byte sectors that hold its
    bins and its grad, hess and weight columns (64 B, two sectors, at
    F = 28; 544 B, 17 sectors, for 529 bundle columns)."""
    return 32 * -(-(layout.cnt_off + 4) // 32)


def tree_byte_bounds(tree, layout):
    """Byte bounds of one compact tree from its node counts: K1 reads the
    bins and channels of every root row and of every smaller-child row
    (``record_row_bytes``); K2 reads and writes each split parent's real
    columns once (in either variant: copy-back's round trip through
    scratch is the implementation's, not the function's)."""
    n, smaller = smaller_child_rows(tree)
    cnt = np.asarray(tree.internal_count, np.float64)[:tree.num_nodes]
    return {"histogram": (n + smaller) * record_row_bytes(layout),
            "fused_split": float(2 * cnt.sum() * layout.num_real_cols)}


def unfused_tree_byte_bounds(tree, gbdt):
    """Byte bounds of one compact tree without the fused kernel from its
    node counts, for the root's rows and every smaller child's: the gather
    reads the sectors of a row's grad, hess and weight and writes its
    channels (for K3 also reads its bin sectors and writes its F bins
    feature-major); the histogram reads a row's bins (K1: the record's bin
    sectors; K3: the copy) and its channels; K2 reads and writes each split
    parent's real columns once."""
    layout = gbdt.layout
    n, smaller = smaller_child_rows(tree)
    rows = n + smaller
    sub = gbdt.grower_params.hist_layout == "sublane"
    ch = 4 if gbdt._quant_int and not sub else 16
    bins = sector_bytes(0, layout.feat_cols)
    f = layout.num_features
    cnt = np.asarray(tree.internal_count, np.float64)[:tree.num_nodes]
    return {"segment_gather": rows * (sector_bytes(layout.grad_off,
                                                   layout.cnt_off + 4)
                                      + ch + (bins + f if sub else 0)),
            "histogram_sublane" if sub else "histogram":
                rows * ((f if sub else bins) + ch),
            "fused_split": float(2 * cnt.sum() * layout.num_real_cols)}


def masked_tree_hist_bytes(tree, gbdt, k=3):
    """The histogram kernel's byte bound for one masked tree (K3 with the
    sublane layout, K1 dense with the lane one): the grower launches it
    once for the root and once a split (num_leaves launches, the unapplied
    splits included), each over all N rows. The channels are ``grad *
    mask``, ``hess * mask`` and ``mask`` (``ops/grower.py``), so a row
    outside the leaf has g = h = 0: a launch must read the 4-byte mask
    channel of every row (it tells the launch which rows are live), the
    other K - 1 channels and the F bins of its live rows only (all N at the
    root, the smaller child's rows at a split; 2F bytes of 16-bit bins) and
    write the F x B x K f32 output:
    bytes = L (4 N + 4 F B K) + (4 (K - 1) + F) (N + smaller-child rows)."""
    n = gbdt.num_data
    f = gbdt.binned_t.shape[0]
    row_bins = f * gbdt.binned_t.element_size()
    b = gbdt.grower_params.num_bins
    launches = gbdt.grower_params.num_leaves
    _, smaller = smaller_child_rows(tree)
    return float(launches * (4 * n + 4 * f * b * k)
                 + (4 * (k - 1) + row_bins) * (n + smaller))


def profile_tree(bst, tree_s, grower=None):
    """One more boosting round with torch.profiler on: device time by
    kernel and the launches of a tree, and each of the port's kernels'
    device ms in that tree beside its byte bound from the tree's node
    counts (compact, and K3 on the masked path). With ``grower`` (module,
    name) the round grows K > 1 trees and only the first tree's grower call
    is traced (a round's trace of K trees is K times as long to take and
    read); else the whole round, one tree. The idle share compares the
    device time with ``tree_s``, the unprofiled mean wall time a tree (the
    profiler slows the host). A trace that holds fewer launches of a kernel
    than its wrapper counted in it (the profiler now and then drops device
    events) is thrown away and the round repeated, three rounds at most;
    the masked path launches K3 once a leaf."""
    from torch.profiler import ProfilerActivity, profile

    from lightgbm_tpu_torch import _kernels
    gbdt = bst._gbdt
    for _ in range(3):
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        box = {}

        def traced_call(fn, *a, **kw):
            before = dict(_kernels.LAUNCHES)
            modes_before = dict(_kernels.MODE_LAUNCHES)
            torch.cuda.synchronize()
            prof.start()
            # a trace taken late in a process can miss the first device
            # activities after it starts (the more traces before it, the
            # more): let tiny kernels take their place (about 0.5 ms of
            # device time in the report)
            warm = torch.zeros(4, device=gbdt.device)
            for _ in range(256):
                warm.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(0.05)
            t0 = time.perf_counter()
            try:
                res = fn(*a, **kw)
                torch.cuda.synchronize()
            finally:
                prof.stop()
            box["wall"] = time.perf_counter() - t0
            box["counted"] = {k: v - before[k]
                              for k, v in _kernels.LAUNCHES.items()}
            box["modes"] = {k: v - modes_before[k]
                            for k, v in _kernels.MODE_LAUNCHES.items()}
            return res
        if grower is None:
            traced_call(bst.update)
        else:
            module, name = grower
            grow = getattr(module, name)

            def first(*a, **kw):
                if box:
                    return grow(*a, **kw)
                return traced_call(grow, *a, **kw)
            setattr(module, name, first)
            try:
                bst.update()
            finally:
                setattr(module, name, grow)
        wall, counted, counted_modes = (box["wall"], box["counted"],
                                        box["modes"])
        events = trace_events(prof)
        # a profiler range (ops/grower_compact.py's monotone_rescan) has a
        # device-side span too: its kernels are counted by name
        totals, launches = event_totals(events)
        by_name = {name: (us, n) for name, (n, us) in totals.items()}
        traced = {k: sum(n for name, (_, n) in by_name.items()
                         if _named(name, fns))
                  for k, fns in ENTRY_FUNCTIONS.items()}
        traced_modes = {m: sum(n for name, (_, n) in by_name.items()
                               if _mode_named(name, m))
                        for m in MODE_FUNCTIONS}
        if traced == counted and all(
                traced_modes[m] == counted_modes[m] for m in MODE_FUNCTIONS):
            break
        print(f"PROFILE retry: the trace holds {traced} launches "
              f"({traced_modes}), the wrappers counted {counted} "
              f"({counted_modes})", flush=True)
    else:
        raise AssertionError("three profiled trees each held fewer launches "
                             "of a kernel than its wrapper counted")
    # the traced tree: the round's only tree, or its first (class 0)
    tree = gbdt.models[-gbdt.num_class]
    if not gbdt.use_compact and gbdt.grower_params.hist_layout == "sublane":
        check(counted["histogram_sublane"] == gbdt.grower_params.num_leaves,
              f"K3 launched {counted['histogram_sublane']} times in a masked "
              f"tree of {gbdt.grower_params.num_leaves} leaves")
    device_s = sum(us for us, _ in by_name.values()) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    line = {"traced": "first tree of the round" if grower else "round",
            "profiled_wall_s": wall, "device_s": device_s,
            "unprofiled_tree_s": tree_s,
            "device_idle_share": 1.0 - device_s / tree_s,
            "kernel_launches": launches,
            "top_device_ops": [{"name": k[:60], "ms": us * 1e-3, "calls": n}
                               for k, (us, n) in top]}
    if gbdt.use_compact and not gbdt.grower_params.fused:
        bounds = unfused_tree_byte_bounds(tree, gbdt)
    elif gbdt.use_compact:
        bounds = tree_byte_bounds(tree, gbdt.layout)
    elif gbdt.grower_params.hist_layout == "sublane":
        bounds = {"histogram_sublane": masked_tree_hist_bytes(tree, gbdt)}
    else:
        bounds = {"histogram": masked_tree_hist_bytes(tree, gbdt)}
    for kern, fns in KERNEL_FUNCTIONS.items():
        hits = [(us, n) for name, (us, n) in by_name.items()
                if _named(name, fns)]
        entry = {"device_ms": sum(us for us, _ in hits) * 1e-3,
                 "launches": sum(n for _, n in hits)}
        if kern in bounds:
            entry["bytes"] = bounds[kern]
            entry["bound_ms"] = 1e3 * bounds[kern] / HBM_BYTES_PER_S
        line.setdefault("kernels", {})[kern] = entry
    # the port's profiler ranges: the device ms of the kernels inside each
    # range's device-side spans (one stream: a span holds only its own
    # kernels), the launches inside its host-side ranges
    for rng in PROFILER_RANGES:
        spans = {dev: sorted((start, end) for name, cuda, start, end
                             in events if name == rng and cuda == dev)
                 for dev in (True, False)}
        if not spans[False]:
            continue
        line.setdefault("ranges", {})[rng] = {
            "count": len(spans[False]),
            "device_ms": 1e-3 * sum(
                end - start for name, cuda, start, end in events
                if cuda and name not in PROFILER_RANGES
                and in_spans(spans[True], start)),
            "launches": sum(1 for name, cuda, start, _ in events
                            if name == "cudaLaunchKernel"
                            and in_spans(spans[False], start))}
    # a mode's launches in the trace against its wrappers' count
    line["modes"] = {m: {"counted": n} for m, n in counted_modes.items()}
    for m in MODE_FUNCTIONS:
        hits = [(us, n) for name, (us, n) in by_name.items()
                if _mode_named(name, m)]
        line["modes"][m].update(
            device_ms=sum(us for us, _ in hits) * 1e-3,
            launches=sum(n for _, n in hits))
    print("PROFILE", json.dumps(line), flush=True)
    return line


def phase_cpu_vs_card(lgt, results):
    X, y = make_higgs_like(100_000, 28, seed=11)
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
    boosters = {}
    for dev in ("cuda", "cpu"):
        boosters[dev] = lgt.train(dict(params, device_type=dev),
                                  lgt.Dataset(X, y), 3)
    pg = boosters["cuda"].predict(X)
    diff, differ = compare_boosters(boosters["cuda"], boosters["cpu"], X)
    out = {"rows": 100_000, "max_abs_pred_diff": diff,
           "differing_splits": differ}
    print("CPU_VS_CARD", json.dumps(out), flush=True)
    check(np.all(np.isfinite(pg)) and pg.shape == (100_000,),
          "card predictions")
    check(diff <= 1e-4, f"card vs CPU predictions differ by {diff}")
    results["cpu_vs_card"] = out


EFB_ROWS = 500_000
EFB_FEATURES = 4228
EFB_ROUNDS = 2                 # timed rounds after one warm-up round


def efb_node_route(gbdt, tree, node):
    """(stored column, bin, default_left, NaN bin, bitset flag, int32
    bitset) of a node of a bundled model, as the grower routes it: a
    bundled feature by its node's bitset on its bundle column."""
    orig = int(tree.split_feature[node])
    col = int(gbdt._route_col[orig])
    bits = torch.from_numpy(np.ascontiguousarray(
        tree.cat_bitset[node]).view(np.int32)).to(gbdt.device)
    return (col, int(tree.split_bin[node]), int(tree.default_left[node]),
            int(gbdt._route_nan[col]), int(bool(gbdt._route_cat[orig])),
            bits)


def check_efb_kernels(bst):
    """K2's copy-back variant against its plain version and against K2's
    dual variant on the bundled record array (all training rows, 640-byte
    records) at the first tree's root split and at its first grown split
    (the root's child, on its segment of the root split's result), on
    integer grad and hess: record arrays byte-equal, histograms bit-equal;
    both variants timed at the root, with the root's smaller-child
    histogram alone (the rest is the partition). Then K1 in record mode on
    the same wide records against its plain version (bit-equal), timed
    beside index_add_."""
    from lightgbm_tpu_torch.ops.compact import record_channels
    from lightgbm_tpu_torch.ops.fused_split import (fused_split,
                                                    fused_split_plain)
    from lightgbm_tpu_torch.ops.pallas_histogram import (
        record_histogram, record_histogram_plain)
    from lightgbm_tpu_torch.ops.split import go_left_pred
    gbdt = bst._gbdt
    layout = gbdt.layout
    B = gbdt.grower_params.num_bins
    dev = gbdt.device
    n = gbdt.num_data
    work = gbdt.work.clone()
    scratch = torch.zeros_like(work)
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    ints = torch.stack([torch.randint(-1, 2, (n,), generator=g, device=dev),
                        torch.randint(0, 2, (n,), generator=g, device=dev)],
                       dim=1).float()
    work[:, layout.grad_off:layout.grad_off + 8] = ints.view(torch.uint8)
    del ints
    tree = gbdt.models[0]
    check(tree.num_nodes > 1, "the first EFB tree has no grown split")

    def split_args(node, start, count, arr):
        col, b, dl, nan, cat, bits = efb_node_route(gbdt, tree, node)
        gl = go_left_pred(arr[start:start + count, col], b, bool(dl), nan,
                          bool(cat), bits)
        return (0, start, count, int(gl.sum()), col, b, dl, nan, cat, bits,
                layout, B), gl

    line = {"rows": n, "record_bytes": layout.num_cols,
            "record_real_bytes": layout.num_real_cols,
            "moved_bytes": layout.moved_cols}
    root_args, gl = split_args(0, 0, n, work)
    child = int(tree.left_child[0])
    side_left = child >= 0
    if not side_left:
        child = int(tree.right_child[0])
    check(child >= 0, "the root has no internal child")
    after_root = None
    for what, node in (("root", 0), ("grown", child)):
        if what == "root":
            base, args = work, root_args
        else:
            nl0 = root_args[3]
            start, count = (0, nl0) if side_left else (nl0, n - nl0)
            base = after_root
            args, _ = split_args(node, start, count, base)
        start, count, n_left = args[1], args[2], args[3]
        wk, sk = base.clone(), scratch.clone()
        _, _, hk = fused_split(wk, sk, *args, dual=False)
        wp, spl = base.clone(), scratch.clone()
        _, _, hp = fused_split_plain(wp, spl, *args, dual=False)
        wd, sd = base.clone(), scratch.clone()
        _, _, hd = fused_split(wd, sd, *args, side=0)
        torch.cuda.synchronize()
        check(torch.equal(wk, wp) and torch.equal(sk, spl),
              f"K2 copy-back at the {what} split: records differ from the "
              "plain version")
        merged = wd
        merged[start + n_left:start + count] = sd[start + n_left:
                                                  start + count]
        check(torch.equal(wk, merged), f"K2 copy-back at the {what} split: "
              "work differs from dual residency's merged children")
        err = hist_close(hk, hp, hp, f"K2 copy-back {what} split", 0)
        hist_close(hk, hd, hd, f"K2 copy-back vs dual {what} split", 0)
        line[what] = {"start": start, "count": count, "n_left": n_left,
                      "column": args[4], "bitset": bool(args[8]),
                      "max_abs_err": err}
        if what == "root":
            after_root = wk
        del wp, spl, wd, sd, hk, hp, hd, merged
        if what != "root":
            del wk, sk
    del after_root
    # K2's quant mode in copy-back at the root split: the grad and hess
    # written above are integers, so the records double as quantized codes
    wk, sk = work.clone(), scratch.clone()
    _, _, hk = fused_split(wk, sk, *root_args, dual=False, quant=True)
    wp, spl = work.clone(), scratch.clone()
    _, _, hp = fused_split_plain(wp, spl, *root_args, dual=False, quant=True)
    torch.cuda.synchronize()
    check(torch.equal(wk, wp) and torch.equal(sk, spl), "K2 quant copy-back "
          "at the root split: records differ from the plain version")
    check(hk.dtype == torch.int32 and torch.equal(hk, hp), "K2 quant "
          "copy-back at the root split: histograms differ")
    line["quant_copy_back"] = {"max_abs_err": int((hk - hp).abs().max())}
    del wk, sk, wp, spl, hk, hp
    n_left = root_args[3]
    n_small = min(n_left, n - n_left)
    calls = [0]

    def dual_alternating():
        fused_split(work, scratch, *root_args, side=calls[0] % 2)
        calls[0] += 1

    def library():
        perm = torch.argsort(gl.to(torch.uint8), stable=True)
        torch.index_select(work, 0, perm, out=scratch)
    row_bytes = record_row_bytes(layout)
    # the smaller child's histogram alone (K1 on its rows), the part of
    # either variant that is not the partition, as the main path's K2 line
    hs = 0 if n_left <= n - n_left else n_left
    child_seg = torch.tensor([hs, n_small, 0], dtype=torch.int32,
                             device=dev)
    line.update({
        "copy_back_ms": time_ms(lambda: fused_split(
            work, scratch, *root_args, dual=False)),
        "dual_ms": time_ms(dual_alternating),
        "copy_back_plain_ms": time_ms(lambda: fused_split_plain(
            work, scratch, *root_args, dual=False), 4, 2),
        "library_ms": time_ms(library, 4, 2),
        "child_hist_ms": time_ms(lambda: record_histogram(
            work, scratch, child_seg, layout, B)),
        "bound_ms": 1e3 * (2 * n * layout.num_real_cols
                           + n_small * row_bytes) / HBM_BYTES_PER_S})
    line["quant_copy_back"].update({
        "ms": time_ms(lambda: fused_split(work, scratch, *root_args,
                                          dual=False, quant=True)),
        "plain_ms": time_ms(lambda: fused_split_plain(
            work, scratch, *root_args, dual=False, quant=True), 4, 2)})
    line["copy_back_partition_ms"] = (line["copy_back_ms"]
                                      - line["child_hist_ms"])
    line["dual_partition_ms"] = line["dual_ms"] - line["child_hist_ms"]
    seg = torch.tensor([0, n, 0], dtype=torch.int32, device=dev)
    hk = record_histogram(work, scratch, seg, layout, B)
    hp = record_histogram_plain(work, scratch, seg, layout, B)
    line["k1"] = {
        "rows": n, "features": layout.num_features,
        "row_bytes_read": row_bytes,
        "max_abs_err": hist_close(hk, hp, hp, "K1 on the EFB records", 0),
        "kernel_ms": time_ms(lambda: record_histogram(work, scratch, seg,
                                                      layout, B)),
        "plain_ms": time_ms(lambda: record_histogram_plain(
            work, scratch, seg, layout, B), 2, 1),
        "bound_ms": 1e3 * n * row_bytes / HBM_BYTES_PER_S}
    del hk, hp
    # index_add_ of the same rows' channels on a flat index precomputed
    # from the records, as for K1's main-path line
    F = layout.num_features
    flat = (work[:, :F].to(torch.int64)
            + torch.arange(F, device=dev) * B).reshape(-1)
    src = record_channels(work, layout)[:, None, :].expand(
        n, F, 4).reshape(-1, 4)
    lib_out = torch.zeros(F * B, 4, device=dev)

    def lib():
        lib_out.zero_()
        lib_out.index_add_(0, flat, src)
    line["k1"]["library_ms"] = time_ms(lib, 3, 1)
    del work, scratch, flat, src, lib_out
    return line


def efb_cpu_vs_card(lgt):
    """A narrower one-hot shape (50,000 x 320 one-hot in blocks of 8, plus
    4 dense columns; sized for the smoke's time), 31 leaves, 2 rounds, default parameters: bundled on both, the card within
    1e-4 of the CPU, differing splits counted."""
    rng = np.random.RandomState(21)
    n, groups = 50_000, 40
    cats = rng.randint(0, 8, (n, groups))
    X = np.zeros((n, groups * 8), np.float32)
    for gi in range(groups):
        X[np.arange(n), gi * 8 + cats[:, gi]] = 1.0
    X = np.concatenate([X, rng.randn(n, 4).astype(np.float32)], axis=1)
    y = (X @ (rng.randn(X.shape[1]) * 0.5) + 0.4 * rng.randn(n) > 0
         ).astype(float)
    params = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
    ds = lgt.Dataset(X, y)
    boosters = {dev: lgt.train(dict(params, device_type=dev), ds, 2)
                for dev in ("cuda", "cpu")}
    for b in boosters.values():
        check(b._gbdt._efb is not None, "the one-hot check did not bundle")
    diff, differ = compare_boosters(boosters["cuda"], boosters["cpu"], X)
    check(diff <= 1e-4, f"EFB card vs CPU predictions differ by {diff}")
    return {"rows": n, "features": X.shape[1],
            "stored_columns": boosters["cpu"]._gbdt.layout.num_features,
            "max_abs_pred_diff": diff, "differing_splits": differ}


def phase_efb(lgt, results):
    """Exclusive Feature Bundling on the compact grower at the Allstate
    shape (make_allstate_like, 4228 one-hot columns in blocks of 8, 10%
    validation split; the parameters of bench.py:1185-1200 with
    BENCH_SPARSE=1): default enable_bundle, 255 leaves, 255 bins,
    min_data_in_leaf 100, bin_construct_sample_cnt 20,000, 1 warm-up and
    EFB_ROUNDS timed rounds, then a profiled tree; the raw matrix is freed
    after construction (the validation rows kept)."""
    from lightgbm_tpu_torch import _kernels
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    from lightgbm_tpu_torch.io import dataset as dataset_mod
    rows, rounds = EFB_ROWS, EFB_ROUNDS
    t0 = time.perf_counter()
    X, y = make_allstate_like(rows, EFB_FEATURES)
    n_val = rows // 10
    Xv, yv = X[-n_val:].copy(), y[-n_val:]
    gen_s = time.perf_counter() - t0
    params = {"objective": "binary", "metric": "auc", "num_leaves": 255,
              "max_bin": 255, "learning_rate": 0.1, "min_data_in_leaf": 100,
              "bin_construct_sample_cnt": 20_000, "verbosity": -1,
              "device_type": "cuda"}
    plan_s = [0.0]
    plan = dataset_mod._plan_efb

    def timed_plan(*a, **kw):
        t = time.perf_counter()
        try:
            return plan(*a, **kw)
        finally:
            plan_s[0] += time.perf_counter() - t
    syncs = {}
    ends = []

    def timer(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    timer.order = 5

    _kernels.reset_counts()
    dataset_mod._plan_efb = timed_plan
    try:
        with count_syncs(gbdt_mod, ["grow_tree_compact"], syncs):
            t1 = time.perf_counter()
            ds = lgt.Dataset(X[:-n_val], y[:-n_val], params=params)
            dv = ds.create_valid(Xv, yv)
            ds.construct()
            dv.construct()
            construct_s = time.perf_counter() - t1
            del X
            evals = {}
            t_start = time.perf_counter()
            bst = lgt.train(params, ds, 1 + rounds, valid_sets=[dv],
                            callbacks=[timer, lgt.record_evaluation(evals)])
    finally:
        dataset_mod._plan_efb = plan
    launches = dict(_kernels.LAUNCHES)
    plain_calls = dict(_kernels.PLAIN_CALLS)
    gbdt = bst._gbdt
    info = ds._inner.bundle_info
    check(info is not None and info.n_bundled > 0, "no bundle formed")
    check(gbdt.use_compact and gbdt._efb is not None
          and not gbdt.grower_params.fused_dual,
          "the bundled run did not take the compact grower's copy-back path")
    check(len(ends) == 1 + rounds, f"trained {len(ends)} rounds")
    it_s = rounds / (ends[-1] - ends[0])
    auc = evals["valid_0"]["auc"][-1]
    for k in ("histogram", "fused_split"):
        check(launches[k] > 0, f"kernel {k} was not launched on the EFB "
              "path")
    for k, v in plain_calls.items():
        check(v == 0, f"plain version of {k} ran {v} times on the card")
    check(launches["histogram_sublane"] == 0, "K3 ran on the EFB path")
    # a sanity gate above chance (about 0.003 of AUC for 50,000 rows): three
    # trees of 255 leaves see few of the 529 blocks the label sums over
    check(np.isfinite(auc) and auc > 0.55, f"EFB validation AUC {auc}")
    check(syncs.get("in_tree") == 0, "host syncs inside the EFB split loop")
    bundled_splits = sum(int((info.offset_of[t.split_feature[:t.num_nodes]]
                              >= 0).sum()) for t in gbdt.models)
    check(bundled_splits > 0, "no split on a bundled feature")
    prof = profile_tree(bst, 1.0 / it_s)
    out = {"rows": rows, "features": EFB_FEATURES,
           "train_rows": rows - n_val, "valid_rows": n_val,
           "rounds_timed": rounds, "iterations_per_s": it_s,
           "first_round_s": ends[0] - t_start, "construct_s": construct_s,
           "plan_s": plan_s[0], "data_gen_s": gen_s,
           "bundled_features": int(info.n_bundled),
           "stored_columns": int(info.n_columns),
           "record_bytes": gbdt.layout.num_cols,
           "record_real_bytes": gbdt.layout.num_real_cols,
           "scan_features": int(gbdt.num_bins_arr.numel()),
           "valid_auc": auc, "launches": launches,
           "plain_calls": plain_calls, "host_syncs_in_tree":
           syncs.get("in_tree"), "bundled_splits": bundled_splits,
           "num_trees": bst.num_trees(),
           "tree_kernel_launches": prof["kernel_launches"],
           "tree_device_s": prof["device_s"],
           "tree_device_idle_share": prof["device_idle_share"],
           "tree_kernels": {k: {"device_ms": v["device_ms"],
                                "bound_ms": v.get("bound_ms")}
                            for k, v in prof["kernels"].items()
                            if k != "histogram_sublane"}}
    print("EFB", json.dumps(out), flush=True)
    checks = {"kernels": check_efb_kernels(bst)}
    # the saved bundled model routes raw values per original feature
    p_card = bst.predict(Xv[:20_000])
    check(np.all(np.isfinite(p_card)), "EFB card predictions")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "efb.txt")
        bst.save_model(path)
        loaded = lgt.Booster(model_file=path)
        reload_diff = float(np.abs(loaded.predict(Xv[:20_000])
                                   - p_card).max())
    check(reload_diff <= 1e-6, f"reloaded EFB model differs by "
          f"{reload_diff}")
    checks["reload_max_abs_diff"] = reload_diff
    checks["cpu_vs_card"] = efb_cpu_vs_card(lgt)
    print("EFB_CHECKS", json.dumps(checks), flush=True)
    out["profile"] = prof
    out["checks"] = checks
    results["efb"] = out
    del bst, ds, dv, gbdt


RANK_ROWS = 2_270_000
RANK_FEATURES = 137
RANK_ROUNDS = 2                # timed rounds after one warm-up round
# the repo's MS-LTR configuration (bench.py:1005-1017)
RANK_PARAMS = {"objective": "lambdarank", "metric": "ndcg", "eval_at": [10],
               "num_leaves": 255, "max_bin": 255, "learning_rate": 0.1,
               "min_data_in_leaf": 50, "verbosity": -1}


def make_msltr_like(n, f, docs_per_query=120, seed=7):
    """MS-LTR-shaped ranking data (copied from bench.py:284-300, which
    imports JAX): graded labels 0-4 from global quantiles of a noisy linear
    relevance, queries of ``docs_per_query`` documents (the last one takes
    the rest); LightGBM's docs/Experiments.rst: 2.27M documents x 137
    features."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f) / np.sqrt(f)
    rel = X @ w + 0.8 * rng.randn(n)
    qs = np.quantile(rel, [0.55, 0.75, 0.9, 0.97])
    y = np.digitize(rel, qs).astype(np.float64)
    n_q = n // docs_per_query
    group = np.full(n_q, docs_per_query, np.int64)
    rest = n - n_q * docs_per_query
    if rest:
        group = np.concatenate([group, [rest]])
    return X, y, group


def split_queries(X, y, group, frac=0.1):
    """``((X, y, group) train, (X, y, group) validation)``: the last
    ``frac`` of the queries, whole, held out."""
    nq_val = max(int(len(group) * frac), 1)
    n_tr = int(group[:-nq_val].sum())
    return ((X[:n_tr], y[:n_tr], group[:-nq_val]),
            (X[n_tr:], y[n_tr:], group[-nq_val:]))


def device_profile(fn, reps=3):
    """(device ms, kernel launches) of one call of fn: a torch.profiler
    trace of ``reps`` calls after one untraced call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = trace_events(prof)
    dev_us = sum(end - start for _, cuda, start, end in events if cuda)
    launches = sum(1 for name, *_ in events if name == "cudaLaunchKernel")
    return dev_us * 1e-3 / reps, launches / reps


def check_rank_kernels(bst):
    """K2 (dual) and K1 (record mode) on the RANK run's records (all
    training rows, F = 137, carrying the last tree's lambdarank gradients)
    against their plain versions: K2 in mode 1 (the root histogram) and at
    the first tree's root split, children byte-equal and histograms within
    hist_close; then with dyadic grad and hess written into the records
    (multiples of 1/64: every partial sum exact) K2's root split and K1 at
    the root bit-equal. Times: K2 at the root split beside its plain
    version and stable argsort + index_select, K1 at the root beside its
    plain version and index_add_ on a precomputed flat index."""
    from lightgbm_tpu_torch.ops.compact import record_channels
    from lightgbm_tpu_torch.ops.fused_split import (fused_split,
                                                    fused_split_plain)
    from lightgbm_tpu_torch.ops.pallas_histogram import (
        record_histogram, record_histogram_plain)
    from lightgbm_tpu_torch.ops.split import go_left_pred
    gbdt = bst._gbdt
    layout = gbdt.layout
    B = gbdt.grower_params.num_bins
    F = layout.num_features
    dev = gbdt.device
    n = gbdt.num_data
    work = gbdt.work.clone()
    scratch = torch.zeros_like(work)
    tree = gbdt.models[0]
    check(tree.num_nodes > 1, "the first RANK tree has no grown split")
    none = torch.zeros(8, dtype=torch.int32, device=dev)
    f0, b0 = int(tree.split_feature[0]), int(tree.split_bin[0])
    dl0, nan0 = int(tree.default_left[0]), int(gbdt.nan_bin_arr[f0])
    gl = go_left_pred(work[:, f0], b0, bool(dl0), nan0, False, none)
    root_args = (0, 0, n, int(gl.sum()), f0, b0, dl0, nan0, 0, None,
                 layout, B)
    seg_args = (1, 0, n, 0, 0, 0, 0, 0, 0, None, layout, B)
    line = {"rows": n, "features": F, "record_bytes": layout.num_cols,
            "record_real_bytes": layout.num_real_cols,
            "row_bytes_read": record_row_bytes(layout)}
    errs = []
    for dyadic in (False, True):
        if dyadic:
            g = torch.Generator(device=dev)
            g.manual_seed(11)
            ch = torch.stack(
                [torch.randint(-64, 65, (n,), generator=g, device=dev),
                 torch.randint(1, 65, (n,), generator=g, device=dev)],
                dim=1).float() / 64.0
            work[:, layout.grad_off:layout.grad_off + 8] = ch.view(
                torch.uint8)
            del ch
        rel = 0 if dyadic else 1e-5
        tag = "dyadic" if dyadic else "run's gradients"
        absw = abs_grad(work, layout)
        _, _, hk = fused_split(work, scratch, *seg_args)
        _, _, hp = fused_split_plain(work, scratch, *seg_args)
        _, _, ha = fused_split_plain(absw, scratch, *seg_args)
        errs.append(hist_close(hk, hp, ha, f"K2 mode 1 at the RANK root "
                               f"({tag})", rel))
        before = (work.clone(), scratch.clone())
        wk, sk = work.clone(), scratch.clone()
        _, _, hk = fused_split(wk, sk, *root_args, side=0)
        wp, spl = work.clone(), scratch.clone()
        _, _, hp = fused_split_plain(wp, spl, *root_args, side=0)
        wa, sa = absw.clone(), scratch.clone()
        _, _, ha = fused_split_plain(wa, sa, *root_args, side=0)
        torch.cuda.synchronize()
        check_split((wk, sk), (wp, spl), before, 0, n, root_args[3], 0,
                    layout, f"K2 at the RANK root split ({tag})")
        errs.append(hist_close(hk, hp, ha, f"K2 at the RANK root split "
                               f"({tag})", rel))
        del before, wk, sk, wp, spl, wa, sa
        seg = torch.tensor([0, n, 0], dtype=torch.int32, device=dev)
        hk = record_histogram(work, scratch, seg, layout, B)
        hp = record_histogram_plain(work, scratch, seg, layout, B)
        ha = record_histogram_plain(absw, scratch, seg, layout, B)
        errs.append(hist_close(hk, hp, ha, f"K1 at the RANK root ({tag})",
                               rel))
        del absw, hk, hp, ha
    line["max_abs_err"] = max(errs)
    n_left = root_args[3]
    n_small = min(n_left, n - n_left)
    row_bytes = record_row_bytes(layout)
    calls = [0]

    def dual_alternating():
        fused_split(work, scratch, *root_args, side=calls[0] % 2)
        calls[0] += 1

    def library():
        perm = torch.argsort(gl.to(torch.uint8), stable=True)
        torch.index_select(work, 0, perm, out=scratch)
    line["k2"] = {
        "root_split": {"n_left": n_left, "feature": f0},
        "ms": time_ms(dual_alternating),
        "plain_ms": time_ms(lambda: fused_split_plain(
            work, scratch, *root_args, side=0), 4, 2),
        "library_ms": time_ms(library, 4, 2),
        "bound_ms": 1e3 * (2 * n * layout.num_real_cols
                           + n_small * row_bytes) / HBM_BYTES_PER_S}
    # K1 on what the timing calls left: the whole array of records
    seg = torch.tensor([0, n, 0], dtype=torch.int32, device=dev)
    flat = (work[:, :F].to(torch.int64)
            + torch.arange(F, device=dev) * B).reshape(-1)
    src = record_channels(work, layout)[:, None, :].expand(
        n, F, 4).reshape(-1, 4)
    lib_out = torch.zeros(F * B, 4, device=dev)

    def lib():
        lib_out.zero_()
        lib_out.index_add_(0, flat, src)
    line["k1"] = {
        "ms": time_ms(lambda: record_histogram(work, scratch, seg, layout,
                                               B)),
        "plain_ms": time_ms(lambda: record_histogram_plain(
            work, scratch, seg, layout, B), 2, 1),
        "library_ms": time_ms(lib, 2, 1),
        "bound_ms": 1e3 * n * row_bytes / HBM_BYTES_PER_S}
    del work, scratch, flat, src, lib_out
    return line


@contextlib.contextmanager
def same_xendcg_draws():
    """rank_xendcg draws its exponentials from one CPU generator seeded as
    the objective seeds its own, moved to the scores' device: the card and
    the CPU runs see the same draws."""
    from lightgbm_tpu_torch.objectives import RankXENDCG
    own = RankXENDCG._draws

    def draws(self, shape, device):
        g = torch.Generator()
        g.manual_seed((self.seed * 1_000_003 + self._calls) & 0xFFFF_FFFF)
        return torch.empty(shape).exponential_(generator=g).to(device)
    RankXENDCG._draws = draws
    try:
        yield
    finally:
        RankXENDCG._draws = own


def rank_cpu_vs_card(lgt):
    """The card against the CPU: lambdarank on the compact grower
    (tpu_grower=compact) at 35k MS-LTR-shaped rows (292 queries),
    rank_xendcg (the same draws on both) and lambdarank with positions on
    the masked grower at 10k rows; 31 leaves, 2 rounds, one binned Dataset
    a case for both; predictions within 1e-4, differing splits counted.
    (The CPU half of this check takes most of its time: rows and rounds
    are sized for the smoke's limit.)"""
    out = {}
    cases = (("lambdarank_compact", 35_000, {"tpu_grower": "compact"}),
             ("rank_xendcg_masked", 10_000, {"objective": "rank_xendcg"}),
             ("lambdarank_position_masked", 10_000, {}))
    for name, rows, extra in cases:
        X, y, group = make_msltr_like(rows, RANK_FEATURES, seed=23)
        params = dict(RANK_PARAMS, num_leaves=31, **extra)
        kw = {}
        if "position" in name:
            kw["position"] = np.concatenate([np.arange(s) for s in group])
        ds = lgt.Dataset(X, y, group=group, **kw)
        boosters = {}
        with same_xendcg_draws():
            for dev in ("cuda", "cpu"):
                boosters[dev] = lgt.train(dict(params, device_type=dev), ds,
                                          2)
        check(boosters["cuda"]._gbdt.use_compact == ("compact" in name),
              f"{name}: the wrong grower")
        diff, differ = compare_boosters(boosters["cuda"], boosters["cpu"], X)
        check(diff <= 1e-4, f"{name}: card vs CPU predictions differ by "
              f"{diff}")
        out[name] = {"rows": rows, "queries": len(group),
                     "max_abs_pred_diff": diff, "differing_splits": differ}
    return out


def phase_rank(lgt, results):
    """Learning to rank on the compact grower at the repo's MS-LTR
    configuration (make_msltr_like, 2.27M x 137, 10% of the queries, whole,
    held out; the parameters of bench.py:1005-1017): lambdarank, ndcg@10,
    255 leaves, 255 bins, 1 warm-up and RANK_ROUNDS timed rounds and a
    profiled tree. The gradients are computed on the card in the dataset's
    row order each round and gathered into the records' order; K1 (record
    mode) and K2 (dual) grow the tree on about 256-byte records. Then
    RANK_CHECKS (check_rank_kernels, the reloaded model,
    rank_cpu_vs_card)."""
    from lightgbm_tpu_torch import _kernels
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.metrics import create_metrics
    rounds = RANK_ROUNDS
    t0 = time.perf_counter()
    X, y, group = make_msltr_like(RANK_ROWS, RANK_FEATURES)
    (Xt, yt, gt), (Xv, yv, gv) = split_queries(X, y, group)
    gen_s = time.perf_counter() - t0
    params = dict(RANK_PARAMS, device_type="cuda")
    syncs = {}
    ends = []

    def timer(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    timer.order = 5

    _kernels.reset_counts()
    # the host syncs of the whole tree step: the lambdarank gradients
    # (_begin_compact_iter), then the tree
    with count_syncs(gbdt_mod.GBDT, COMPACT_STEP, syncs):
        t1 = time.perf_counter()
        ds = lgt.Dataset(Xt, yt, group=gt)
        dv = ds.create_valid(Xv, yv, group=gv)
        ds.construct()
        dv.construct()
        construct_s = time.perf_counter() - t1
        evals = {}
        t_start = time.perf_counter()
        bst = lgt.train(params, ds, 1 + rounds, valid_sets=[dv],
                        callbacks=[timer, lgt.record_evaluation(evals)])
    launches = dict(_kernels.LAUNCHES)
    plain_calls = dict(_kernels.PLAIN_CALLS)
    gbdt = bst._gbdt
    check(len(ends) == 1 + rounds, f"trained {len(ends)} rounds")
    it_s = rounds / (ends[-1] - ends[0])
    # validation ndcg@10 before the first tree (every score 0: the
    # documents' own order) and after each round
    metric = create_metrics(["ndcg"], Config(params))[0]
    metric.init(dv._inner.metadata, dv.num_data())
    ndcg0 = metric.eval_all(np.zeros(dv.num_data()))[0]
    ndcg = evals["valid_0"]["ndcg@10"]
    check(gbdt.use_compact and gbdt._ext_grads, "lambdarank did not take "
          "the compact grower's external-gradient route")
    for k in ("histogram", "fused_split"):
        check(launches[k] > 0, f"kernel {k} was not launched on the RANK "
              "path")
    check(launches["histogram_sublane"] == 0, "K3 ran on the RANK path")
    for k, v in plain_calls.items():
        check(v == 0, f"plain version of {k} ran {v} times on the card")
    check(syncs.get("in_tree") == 0, "host syncs inside the RANK tree step")
    check(np.isfinite(ndcg[-1]) and ndcg[-1] > ndcg0,
          f"validation ndcg@10 did not rise: {ndcg0} -> {ndcg}")
    # the gradient layer: one iteration's lambdarank gradients, scores in
    # the dataset's row order
    s_orig = torch.from_numpy(gbdt.train_score_original_order()[0]).to(
        gbdt.device)
    grad_dev_ms, grad_launches = device_profile(
        lambda: gbdt.objective.get_gradients(s_orig))
    del s_orig
    prof = profile_tree(bst, 1.0 / it_s)
    out = {"rows": RANK_ROWS, "features": RANK_FEATURES,
           "queries": len(group), "train_rows": gbdt.num_data,
           "valid_rows": dv.num_data(), "valid_queries": len(gv),
           "reduced": "10% of the queries, whole, held out for validation",
           "rounds_timed": rounds, "iterations_per_s": it_s,
           "round_s": np.diff(ends).tolist(),
           "first_round_s": ends[0] - t_start, "construct_s": construct_s,
           "data_gen_s": gen_s, "record_bytes": gbdt.layout.num_cols,
           "record_real_bytes": gbdt.layout.num_real_cols,
           "grower": "compact" if gbdt.use_compact else "masked",
           "valid_ndcg10_round0": ndcg0, "valid_ndcg10_by_round": ndcg,
           "launches": launches, "plain_calls": plain_calls,
           "host_syncs_in_tree": syncs.get("in_tree"),
           "num_trees": bst.num_trees(),
           "gradient_device_ms": grad_dev_ms,
           "gradient_launches": grad_launches,
           "tree_kernel_launches": prof["kernel_launches"],
           "tree_device_s": prof["device_s"],
           "tree_wall_s": 1.0 / it_s,
           "tree_device_idle_share": prof["device_idle_share"],
           "tree_kernels": {k: {"device_ms": v["device_ms"],
                                "launches": v["launches"],
                                "bound_ms": v.get("bound_ms")}
                            for k, v in prof["kernels"].items()
                            if k != "histogram_sublane"}}
    print("RANK", json.dumps(out), flush=True)
    out["profile"] = prof
    checks = {"kernels": check_rank_kernels(bst)}
    Xp = Xv[:20_000]
    p_card = bst.predict(Xp)
    check(np.all(np.isfinite(p_card)) and p_card.shape == (len(Xp),),
          "RANK card predictions")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank.txt")
        bst.save_model(path)
        reload_diff = float(np.abs(lgt.Booster(model_file=path).predict(
            Xp) - p_card).max())
    check(reload_diff <= 1e-6, f"reloaded ranking model differs by "
          f"{reload_diff}")
    checks["reload_max_abs_diff"] = reload_diff
    checks["cpu_vs_card"] = rank_cpu_vs_card(lgt)
    print("RANK_CHECKS", json.dumps(checks), flush=True)
    out["checks"] = checks
    results["rank"] = out
    del bst, ds, dv, gbdt, X, Xt, Xv


RENEW_ROUNDS = 2               # timed rounds after one warm-up round


def renew_cpu_vs_card(lgt):
    """The card against the CPU for regression_l1, quantile (alpha 0.9)
    and mape on the compact grower (100k x 28) and the masked grower (20k x
    28), the generator's logits as the label, 31 leaves, 2 rounds (sized
    for the smoke's time); predictions within 1e-4, differing splits
    counted."""
    out = {}
    for grower, rows in (("compact", 100_000), ("masked", 20_000)):
        X, _, logits = make_higgs_like(rows, 28, seed=19, with_logits=True)
        ds = lgt.Dataset(X, logits)
        for objective in ("regression_l1", "quantile", "mape"):
            params = {"objective": objective, "alpha": 0.9,
                      "num_leaves": 31, "verbosity": -1,
                      "tpu_grower": grower}
            boosters = {dev: lgt.train(dict(params, device_type=dev), ds, 2)
                        for dev in ("cuda", "cpu")}
            check(boosters["cuda"]._gbdt.use_compact
                  == (grower == "compact"), f"{objective}: wrong grower")
            diff, differ = compare_boosters(boosters["cuda"],
                                            boosters["cpu"], X)
            check(diff <= 1e-4, f"{objective} {grower}: card vs CPU "
                  f"predictions differ by {diff}")
            out[f"{objective}_{grower}"] = {
                "rows": rows, "max_abs_pred_diff": diff,
                "differing_splits": differ}
    return out


def phase_renew(lgt, results):
    """Leaf renewal on the compact grower: MAIN's constructed datasets
    (the 10.5M Higgs-shaped rows) with the generator's logits as the label
    (make_higgs_like(..., with_logits=True); the repo's own data, not a
    published configuration), objective=quantile with alpha 0.9, 255
    leaves, 255 bins, 1 warm-up and RENEW_ROUNDS timed rounds and a
    profiled tree, with the renewal's device ms and launches a tree; then
    RENEW_CHECKS (renew_cpu_vs_card)."""
    from lightgbm_tpu_torch import _kernels
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    ds, dv = results["main_datasets"]
    _, _, logits, n_val = results["higgs"]
    ds._inner.metadata.set_label(logits[:-n_val])
    dv._inner.metadata.set_label(logits[-n_val:])
    rounds = RENEW_ROUNDS
    params = {"objective": "quantile", "alpha": 0.9, "metric": "quantile",
              "num_leaves": 255, "max_bin": 255, "learning_rate": 0.1,
              "min_data_in_leaf": 100, "verbosity": -1,
              "device_type": "cuda"}
    syncs = {}
    ends = []
    last_renew = {}
    renew = gbdt_mod.renew_leaf_quantile

    def recorded_renew(*a):
        last_renew["args"] = a
        return renew(*a)

    def timer(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    timer.order = 5

    evals = {}
    _kernels.reset_counts()
    gbdt_mod.renew_leaf_quantile = recorded_renew
    try:
        # the iteration's gradients, then the tree
        with count_syncs(gbdt_mod.GBDT, COMPACT_STEP, syncs):
            t_start = time.perf_counter()
            bst = lgt.train(params, ds, 1 + rounds, valid_sets=[dv],
                            callbacks=[timer, lgt.record_evaluation(evals)])
    finally:
        gbdt_mod.renew_leaf_quantile = renew
    launches = dict(_kernels.LAUNCHES)
    plain_calls = dict(_kernels.PLAIN_CALLS)
    gbdt = bst._gbdt
    check(len(ends) == 1 + rounds, f"trained {len(ends)} rounds")
    it_s = rounds / (ends[-1] - ends[0])
    loss = evals["valid_0"]["quantile"]
    check(gbdt.use_compact and gbdt.objective.renew_leaves,
          "the quantile run did not renew on the compact grower")
    for k in ("histogram", "fused_split"):
        check(launches[k] > 0, f"kernel {k} was not launched on the RENEW "
              "path")
    for k, v in plain_calls.items():
        check(v == 0, f"plain version of {k} ran {v} times on the card")
    check(syncs.get("in_tree") == 0, "host syncs inside the RENEW tree step")
    check(np.all(np.isfinite(loss)) and loss[-1] < loss[0],
          f"validation quantile loss did not fall: {loss}")
    # the renewal layer: the last tree's call on its own inputs
    args = last_renew.pop("args")
    renew_dev_ms, renew_launches = device_profile(lambda: renew(*args))
    del args
    prof = profile_tree(bst, 1.0 / it_s)
    out = {"train_rows": gbdt.num_data, "valid_rows": dv.num_data(),
           "objective": "quantile", "alpha": 0.9, "rounds_timed": rounds,
           "iterations_per_s": it_s, "round_s": np.diff(ends).tolist(),
           "first_round_s": ends[0] - t_start, "construct_s": "reused",
           "valid_quantile_by_round": loss, "launches": launches,
           "plain_calls": plain_calls,
           "host_syncs_in_tree": syncs.get("in_tree"),
           "num_trees": bst.num_trees(),
           "renew_device_ms": renew_dev_ms,
           "renew_launches": renew_launches,
           "tree_kernel_launches": prof["kernel_launches"],
           "tree_device_s": prof["device_s"], "tree_wall_s": 1.0 / it_s,
           "tree_device_idle_share": prof["device_idle_share"],
           "tree_kernels": {k: {"device_ms": v["device_ms"],
                                "launches": v["launches"],
                                "bound_ms": v.get("bound_ms")}
                            for k, v in prof["kernels"].items()
                            if k != "histogram_sublane"}}
    print("RENEW", json.dumps(out), flush=True)
    out["profile"] = prof
    del bst, gbdt
    checks = {"cpu_vs_card": renew_cpu_vs_card(lgt)}
    print("RENEW_CHECKS", json.dumps(checks), flush=True)
    out["checks"] = checks
    results["renew"] = out


TUNED_ROUNDS = 5               # timed rounds after one warm-up round
TUNED_PARAMS = {"objective": "binary", "metric": "auc", "num_leaves": 255,
                "max_bin": 255, "learning_rate": 0.1,
                "min_data_in_leaf": 100, "verbosity": -1,
                # LightGBM's examples/binary_classification/train.conf
                "feature_fraction": 0.8, "bagging_fraction": 0.8,
                "bagging_freq": 5,
                "feature_fraction_bynode": 0.8, "early_stopping_round": 50}


@contextlib.contextmanager
def seamed_draws():
    """Every GBDT made inside takes its row, by-node and extra-trees draws
    from numpy (the seams of boosting/sample_strategy.py,
    GBDT.bynode_draws and GBDT.extra_draws), so that the card and the CPU
    sample the same rows, features and thresholds."""
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    init = gbdt_mod.GBDT.__init__

    def rows(seed, size):
        return torch.from_numpy(np.random.RandomState(seed).rand(size)
                                .astype(np.float32))

    def nodes(t, n_rows, feats):
        return torch.from_numpy(np.random.RandomState(10_000 + t).rand(
            n_rows, feats).astype(np.float32))

    def extra(t, leaves, feats, intermediate):
        rs = np.random.RandomState(20_000 + t)
        shapes = [(2 * leaves - 1,)] * 2
        if intermediate:
            shapes += [(leaves - 1, leaves)] * 2
        return tuple(torch.from_numpy(rs.randint(
            0, 1 << 32, size=(*sh, feats, 2), dtype=np.int64))
            for sh in shapes)

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        self.sample_strategy.draws = rows
        self.bynode_draws = nodes
        self.extra_draws = extra
    gbdt_mod.GBDT.__init__ = patched
    try:
        yield
    finally:
        gbdt_mod.GBDT.__init__ = init


def raw_count_tree(gbdt, host):
    """A view of a compact host tree whose leaf and internal counts are its
    raw rows (the training records routed through it), not its in-bag
    rows: the rows K1 and K2 move. Its byte bounds count what the kernels
    must move under bagging."""
    import copy as copy_mod
    leaf = gbdt._routed_leaves(gbdt.host_tree_arrays(host),
                               gbdt._routing_binned(), host.max_depth)
    leaf_n = np.bincount(leaf.cpu().numpy(), minlength=host.num_leaves
                         ).astype(np.float64)
    internal = np.zeros(max(host.num_nodes, 1), np.float64)

    def rows(child):
        if child < 0:
            return leaf_n[-child - 1]
        internal[child] = rows(int(host.left_child[child])) \
            + rows(int(host.right_child[child]))
        return internal[child]
    if host.num_nodes:
        rows(0)
    out = copy_mod.copy(host)
    out.leaf_count, out.internal_count = leaf_n, internal
    return out


def dyadic_records(work, layout, grid=64):
    """A copy of a record array with its grad and hess columns rounded to
    multiples of 1/grid: every partial sum of a bin below 2^24 / grid is
    then exact in f32 (the in-bag column, and so the bag, unchanged)."""
    out = work.clone()
    o = layout.grad_off
    gh = out[:, o:o + 8].contiguous().view(torch.float32)
    out[:, o:o + 8] = (torch.round(gh * grid) / grid).view(torch.uint8)
    return out


def check_tuned_kernels(bst):
    """K2 (mode 1, and the last tree's root split: a reused-bag tree) and
    K1 at the root on the TUNED run's bagged records against their plain
    versions: records byte-equal, the in-bag and raw count channels
    exactly equal with in-bag below raw, and grad and hess bit-equal
    (hist_close at rel 0) on the records with their gradients rounded to
    multiples of 1/64 (dyadic_records: a 9.45M-row root sums tens of
    thousands of rows a bin, where two f32 summation orders part by more
    than 1e-5 relative); K1 at the root on the run's own gradients within
    a tolerance derived from f32 summation, its largest relative error
    reported beside it. Each kernel timed beside its plain version and
    library call."""
    from lightgbm_tpu_torch.ops.compact import record_channels
    from lightgbm_tpu_torch.ops.fused_split import (fused_split,
                                                    fused_split_plain)
    from lightgbm_tpu_torch.ops.pallas_histogram import (
        record_histogram, record_histogram_plain)
    from lightgbm_tpu_torch.ops.split import go_left_pred
    gbdt = bst._gbdt
    layout = gbdt.layout
    B = gbdt.grower_params.num_bins
    F = layout.num_features
    dev = gbdt.device
    n = gbdt.num_data
    run_work = gbdt.work
    work = dyadic_records(run_work, layout)
    scratch = torch.zeros_like(work)
    bag = gbdt._bag_col()
    in_bag = int((bag != 0).sum())
    check(0 < in_bag < n and set(torch.unique(bag).tolist()) == {0.0, 1.0},
          "the TUNED records hold no 0/1 bag")
    tree = gbdt.models[-1]
    absw = abs_grad(work, layout)
    seg_args = (1, 0, n, 0, 0, 0, 0, 0, 0, None, layout, B)
    line = {"rows": n, "in_bag_rows": in_bag}
    _, _, hk = fused_split(work, scratch, *seg_args)
    _, _, hp = fused_split_plain(work, scratch, *seg_args)
    _, _, habs = fused_split_plain(absw, scratch, *seg_args)
    worst = hist_close(hk, hp, habs, "K2 mode 1 on the bagged records",
                       rel=0)
    check(int(hk[0, :, 2].sum()) == in_bag and int(hk[0, :, 3].sum()) == n,
          "K2 mode 1: the in-bag or raw count channel is off")
    check(bool((hk[..., 2] <= hk[..., 3]).all())
          and bool((hk[..., 2] < hk[..., 3]).any()),
          "K2 mode 1: the in-bag counts are not below the raw counts")
    f, b = int(tree.split_feature[0]), int(tree.split_bin[0])
    dl, nan = int(tree.default_left[0]), int(gbdt.nan_bin_arr[f])
    gl = go_left_pred(work[:, f], b, bool(dl), nan, False,
                      torch.zeros(8, dtype=torch.int32, device=dev))
    n_left = int(gl.sum())
    root_args = (0, 0, n, n_left, f, b, dl, nan, 0, None, layout, B)
    before = (work.clone(), scratch.clone())
    wk, sk = before[0].clone(), before[1].clone()
    _, _, hk = fused_split(wk, sk, *root_args)
    wp, spl = before[0].clone(), before[1].clone()
    _, _, hp = fused_split_plain(wp, spl, *root_args)
    torch.cuda.synchronize()
    check_split((wk, sk), (wp, spl), before, 0, n, n_left, 0, layout,
                "K2 at the reused-bag tree's root split")
    # the smaller child's |grad| histogram, for the tolerance
    _, _, habs = fused_split_plain(abs_grad(before[0], layout),
                                   before[1].clone(), *root_args)
    worst = max(worst, hist_close(hk, hp, habs, "K2 at the root split",
                                  rel=0))
    check(bool((hk[..., 2] < hk[..., 3]).any()), "K2 at the root split: "
          "the smaller child's in-bag counts equal its raw counts")
    line["root_split"] = {"feature": f, "n_left": n_left,
                          "smaller_in_bag": int(hk[0, :, 2].sum()),
                          "smaller_rows": int(hk[0, :, 3].sum())}
    del wk, sk, wp, spl, before, habs
    n_small = min(n_left, n - n_left)
    calls = [0]

    def alternating():
        fused_split(work, scratch, *root_args, side=calls[0] % 2)
        calls[0] += 1

    def library():
        perm = torch.argsort(gl.to(torch.uint8), stable=True)
        torch.index_select(work, 0, perm, out=scratch)
    row_bytes = record_row_bytes(layout)
    line["k2"] = {
        "ms": time_ms(alternating),
        "plain_ms": time_ms(lambda: fused_split_plain(
            work, scratch, *root_args), 3, 1),
        "library_ms": time_ms(library, 4, 2),
        "bound_ms": 1e3 * (2 * n * layout.num_real_cols
                           + n_small * row_bytes) / HBM_BYTES_PER_S}
    # K1 alone at the root of what the timing calls left: all the records
    seg = torch.tensor([0, n, 0], dtype=torch.int32, device=dev)
    hk = record_histogram(work, scratch, seg, layout, B)
    hp = record_histogram_plain(work, scratch, seg, layout, B)
    habs = record_histogram_plain(abs_grad(work, layout), scratch, seg,
                                  layout, B)
    worst = max(worst, hist_close(hk, hp, habs, "K1 at the bagged root",
                                  rel=0))
    check(int(hk[0, :, 2].sum()) == in_bag and int(hk[0, :, 3].sum()) == n,
          "K1: the in-bag or raw count channel is off")
    # the run's own gradients: counts exact, the sums within f32's
    # summation error. Summing m addends in f32 rounds each partial sum, at
    # most u = 2^-24 of sum|addends|; as a random walk that is sqrt(m) u,
    # and two orders part by sqrt(2m) u. Five of those bound the largest of
    # the F x B x 2 cells, m the fullest bin's row count
    rk = record_histogram(run_work, scratch, seg, layout, B)
    rp = record_histogram_plain(run_work, scratch, seg, layout, B)
    rabs = record_histogram_plain(abs_grad(run_work, layout), scratch, seg,
                                  layout, B)
    run_rel = 5 * math.sqrt(2 * float(rp[..., 3].max())) * 2.0 ** -24
    hist_close(rk, rp, rabs, "K1 on the run's bagged records", rel=run_rel)
    line["run_gradients_max_rel_err"] = float(
        ((rk - rp)[..., :2].abs() / (rabs[..., :2] + 1e-30)).max())
    line["run_gradients_rel_tolerance"] = run_rel
    del rk, rp, rabs
    flat = (work[:, :F].to(torch.int64)
            + torch.arange(F, device=dev) * B).reshape(-1)
    src = record_channels(work, layout)[:, None, :].expand(
        n, F, 4).reshape(-1, 4)
    lib_out = torch.zeros(F * B, 4, dtype=torch.float32, device=dev)

    def lib():
        lib_out.zero_()
        lib_out.index_add_(0, flat, src)
    line["k1"] = {
        "ms": time_ms(lambda: record_histogram(work, scratch, seg, layout,
                                               B)),
        "plain_ms": time_ms(lambda: record_histogram_plain(
            work, scratch, seg, layout, B), 3, 1),
        "library_ms": time_ms(lib, 3, 1),
        "bound_ms": 1e3 * (n * row_bytes + F * B * 16) / HBM_BYTES_PER_S}
    line["max_abs_err"] = worst
    del work, run_work, scratch, flat, src, lib_out, hk, hp, habs, absw
    return line


def check_goss_selection(bst):
    """GOSS's selection on the card at the TUNED run's row count, on its
    gradients (the records' order): timed, and equal row for row to the
    plain selection (the same function on the CPU) on the same magnitudes
    and draws."""
    from lightgbm_tpu_torch.boosting.sample_strategy import GOSSStrategy
    from lightgbm_tpu_torch.config import Config
    gbdt = bst._gbdt
    n = gbdt.num_data
    g, h = gbdt._gradients(gbdt.train_score, gbdt._col(gbdt._cx_label),
                           None)
    cfg = Config({"data_sample_strategy": "goss", "learning_rate": 0.1})
    u = torch.from_numpy(np.random.RandomState(5).rand(n)
                         .astype(np.float32))
    draws = {"cuda": u.to(g.device), "cpu": u}
    masks = {}
    for dev, gg, hh in (("cuda", g, h), ("cpu", g.cpu(), h.cpu())):
        strat = GOSSStrategy(cfg, n, None, torch.device(dev))
        strat.draws = lambda seed, size, u_=draws[dev]: u_
        masks[dev] = (strat.bag_mask(10, gg, hh), strat.amplify)
        if dev == "cuda":
            syncs = {}
            with count_syncs(GOSSStrategy, ["bag_mask"], syncs):
                for _ in range(2):
                    strat.bag_mask(10, gg, hh)
            dev_ms, launches = device_profile(
                lambda: strat.bag_mask(10, gg, hh))
            ms = time_ms(lambda: strat.bag_mask(10, gg, hh), 5, 1)
    (mc, ac), (mp, ap) = masks["cuda"], masks["cpu"]
    check(torch.equal(mc.cpu(), mp) and torch.equal(ac.cpu(), ap),
          "GOSS on the card selects other rows than on the CPU")
    kept = float(mp.mean())
    check(0.2 < kept < 0.35, f"GOSS kept {kept} of the rows")
    check(syncs.get("bag_mask") == 0, "host syncs in GOSS's selection")
    return {"rows": n, "kept_share": kept, "ms": ms, "device_ms": dev_ms,
            "launches": launches, "host_syncs": syncs.get("bag_mask")}


def tuned_cpu_vs_card(lgt):
    """The card against the CPU with the same draws (seamed_draws): 100k x
    28 on the compact grower, 20k x 28 on the masked one, 31 leaves, 2-3
    rounds (GOSS 4 at learning rate 0.5, two past its warm-up; each case
    still holds a reused bag or a fresh draw); predictions
    within 1e-4, differing splits counted. The sublane case runs K3 on a
    bagged mask channel."""
    from lightgbm_tpu_torch import _kernels
    out = {}
    X, y = make_higgs_like(100_000, 28, seed=21)
    Xm, ym = X[:20_000], y[:20_000]
    base = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
    cases = [
        ("bagging_compact", X, y, 3, {"bagging_fraction": 0.7,
                                      "bagging_freq": 2}, None),
        ("balanced_masked", Xm, ym, 2, {"bagging_fraction": 0.8,
                                        "bagging_freq": 1,
                                        "pos_bagging_fraction": 0.5,
                                        "neg_bagging_fraction": 0.9}, None),
        # K3 on a bagged mask channel
        ("balanced_sublane_masked", Xm, ym, 2, {
            "bagging_fraction": 0.8, "bagging_freq": 1,
            "pos_bagging_fraction": 0.5, "neg_bagging_fraction": 0.9,
            "max_bin": 63, "tpu_hist_layout": "sublane"}, None),
        ("by_query_masked", Xm, ym, 2, {"bagging_fraction": 0.6,
                                        "bagging_freq": 1,
                                        "bagging_by_query": True},
         np.full(200, 100)),
        ("goss_compact", X, y, 4, {"data_sample_strategy": "goss",
                                   "learning_rate": 0.5}, None),
        ("feature_fraction_compact", X, y, 2, {
            "feature_fraction": 0.7, "feature_fraction_bynode": 0.6,
            "tpu_grower": "compact"}, None),
        ("feature_fraction_masked", Xm, ym, 2, {
            "feature_fraction": 0.7, "feature_fraction_bynode": 0.6,
            "tpu_grower": "masked"}, None),
        ("bagging_quant_renew_compact", X, y, 2, {
            "bagging_fraction": 0.7, "bagging_freq": 1,
            "use_quantized_grad": True, "stochastic_rounding": False,
            "quant_train_renew_leaf": True}, None)]
    with seamed_draws():
        dataset = shared_datasets(lgt)
        for name, Xc, yc, rounds, extra, group in cases:
            ds = dataset(Xc, yc, extra.get("max_bin", 255), group)
            _kernels.reset_counts()
            boosters = {"cuda": lgt.train(dict(base, device_type="cuda",
                                               **extra),
                                          ds,
                                          rounds)}
            launches = dict(_kernels.LAUNCHES)
            check(sum(_kernels.PLAIN_CALLS.values()) == 0,
                  f"{name}: a plain version ran on the card")
            if "sublane" in name:
                check(launches["histogram_sublane"] > 0
                      and launches["histogram"] == 0,
                      f"{name}: not on K3 alone: {launches}")
            boosters["cpu"] = lgt.train(dict(base, device_type="cpu",
                                             **extra),
                                        ds,
                                        rounds)
            want_compact = "masked" not in name
            check(boosters["cuda"]._gbdt.use_compact == want_compact,
                  f"{name}: wrong grower")
            diff, differ = compare_boosters(boosters["cuda"],
                                            boosters["cpu"], Xc)
            check(diff <= 1e-4, f"{name}: card vs CPU predictions differ "
                  f"by {diff}")
            out[name] = {"rows": len(Xc), "rounds": rounds,
                         "max_abs_pred_diff": diff,
                         "differing_splits": differ,
                         "launches": {k: v for k, v in launches.items()
                                      if v}}
    return out


def tuned_api_checks(lgt):
    """Early stopping, a custom objective, continued training and a
    rollback on the card (100k x 28 rows, 20k more for validation, 31
    leaves), each against the CPU or its definition."""
    out = {}
    X, y = make_higgs_like(120_000, 28, seed=23)
    Xt, yt, Xv, yv = X[:100_000], y[:100_000], X[100_000:], y[100_000:]
    base = {"objective": "binary", "num_leaves": 31, "verbosity": -1}

    def data(free=True):
        ds = lgt.Dataset(Xt, yt, free_raw_data=free)
        dv = ds.create_valid(Xv, yv)
        dv.free_raw_data = free
        return ds, dv
    # a run built to stop: a large learning rate and small leaves overfit
    # 20k rows in a few rounds
    stop = {}
    for dev in ("cuda", "cpu"):
        ds = lgt.Dataset(Xt[:20_000], yt[:20_000])
        stop[dev] = lgt.train(dict(base, device_type=dev, learning_rate=0.9,
                                   num_leaves=63, min_data_in_leaf=5,
                                   tpu_grower="compact",
                                   metric="binary_logloss",
                                   early_stopping_round=3),
                              ds, 40, valid_sets=[ds.create_valid(Xv, yv)])
    best = {dev: b.best_iteration for dev, b in stop.items()}
    check(0 < best["cuda"] == best["cpu"] < 40, f"early stopping: {best}")
    out["early_stopping"] = {"best_iteration": best,
                             "best_score": stop["cuda"].best_score[
                                 "valid_0"]["binary_logloss"]}

    def logloss(preds, data):
        p = 1.0 / (1.0 + np.exp(-preds))
        return p - data.get_label(), p * (1.0 - p)
    fb = lgt.Booster(dict(base, device_type="cuda"), lgt.Dataset(Xt, yt))
    for _ in range(3):
        fb.update(fobj=logloss)
    ref = lgt.train(dict(base, device_type="cuda", tpu_grower="masked",
                         boost_from_average=False), lgt.Dataset(Xt, yt), 3)
    fobj_diff = float(np.abs(fb.predict(Xv) - ref.predict(Xv)).max())
    check(not fb._gbdt.use_compact, "fobj did not move the run to the "
          "masked grower")
    check(fobj_diff <= 1e-4, f"fobj vs built-in binary: {fobj_diff}")
    out["fobj"] = {"grower": "masked", "max_abs_pred_diff": fobj_diff}

    cont = {}
    for dev in ("cuda", "cpu"):
        ds, dv = data(free=False)
        first = lgt.train(dict(base, device_type=dev), ds, 3)
        ds2, dv2 = data(free=False)
        cont[dev] = lgt.train(dict(base, device_type=dev), ds2, 2,
                              init_model=first, valid_sets=[dv2])
    cdiff = float(np.abs(cont["cuda"].predict(Xv)
                         - cont["cpu"].predict(Xv)).max())
    text = cont["cuda"].model_to_string()
    back = lgt.Booster(model_str=text)
    reload_diff = float(np.abs(back.predict(Xv)
                               - cont["cuda"].predict(Xv)).max())
    check(cont["cuda"]._gbdt.use_compact, "continued run not compact")
    check(cdiff <= 1e-4, f"init_model: card vs CPU {cdiff}")
    check(back.num_trees() == 5 and text.count("\nTree=") == 5,
          "the continued model's text does not hold 5 trees")
    check(reload_diff <= 1e-6, f"continued model reload {reload_diff}")
    out["init_model"] = {"max_abs_pred_diff": cdiff, "trees": 5,
                         "reload_max_abs_diff": reload_diff}

    ds, dv = data()
    rb = lgt.Booster(dict(base, device_type="cuda"), ds)
    rb.add_valid(dv, "v")
    for _ in range(3):
        rb.update()
    rb.rollback_one_iter()
    vs = rb._gbdt.valid_sets[0].score[0].cpu().numpy()
    two = lgt.train(dict(base, device_type="cuda"), lgt.Dataset(Xt, yt), 2)
    rb_diff = float(np.abs(vs - two.predict(Xv, raw_score=True)).max())
    check(rb.current_iteration() == 2 and rb_diff <= 1e-5,
          f"rollback: validation scores off the 2-round model by {rb_diff}")
    out["rollback"] = {"max_abs_raw_diff": rb_diff}
    return out


def phase_tuned(lgt, results):
    """The tuned training loop on the compact path: MAIN's constructed
    datasets (binary labels again after RENEW) and parameters with
    LightGBM's examples/binary_classification/train.conf sampling
    (feature_fraction 0.8, bagging_fraction 0.8, bagging_freq 5),
    feature_fraction_bynode 0.8, early_stopping_round 50 on the validation
    set and a learning-rate schedule (reset_parameter), 1 warm-up and
    TUNED_ROUNDS timed rounds (reused bags, then one fresh draw) and a
    profiled tree (its bounds from the raw rows). Then TUNED_CHECKS:
    check_tuned_kernels, check_goss_selection, tuned_cpu_vs_card and
    tuned_api_checks. CONSTRAINED takes the datasets next."""
    from lightgbm_tpu_torch import _kernels
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    ds, dv = results["main_datasets"]
    _, y, _, n_val = results["higgs"]
    ds._inner.metadata.set_label(y[:-n_val])
    dv._inner.metadata.set_label(y[-n_val:])
    rounds = TUNED_ROUNDS
    syncs = {}
    ends = []

    def timer(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    timer.order = 5

    evals = {}
    _kernels.reset_counts()
    steps = COMPACT_STEP + ["_bynode_uniforms"]
    with count_syncs(gbdt_mod.GBDT, steps, syncs):
        t_start = time.perf_counter()
        bst = lgt.train(dict(TUNED_PARAMS, device_type="cuda"), ds,
                        1 + rounds, valid_sets=[dv],
                        callbacks=[timer, lgt.record_evaluation(evals),
                                   lgt.reset_parameter(
                                       learning_rate=lambda i:
                                       0.1 * 0.99 ** i)])
    launches = dict(_kernels.LAUNCHES)
    plain_calls = dict(_kernels.PLAIN_CALLS)
    gbdt = bst._gbdt
    check(len(ends) == 1 + rounds, f"trained {len(ends)} rounds")
    it_s = rounds / (ends[-1] - ends[0])
    auc = evals["valid_0"]["auc"][-1]
    strat = gbdt.sample_strategy
    in_bag = float((gbdt._bag_col() != 0).float().mean())
    check(gbdt.use_compact and strat.enabled,
          "the tuned run did not bag on the compact grower")
    for k in ("histogram", "fused_split"):
        check(launches[k] > 0, f"kernel {k} was not launched on the TUNED "
              "path")
    check(launches["histogram_sublane"] == 0, "K3 ran on the TUNED path")
    for k, v in plain_calls.items():
        check(v == 0, f"plain version of {k} ran {v} times on the card")
    check(np.isfinite(auc) and auc > 0.7, f"TUNED validation AUC {auc}")
    tree_syncs = syncs.get("in_tree")
    check(tree_syncs == 0, f"host syncs in the tuned tree step: {syncs}")
    check(0.75 < in_bag < 0.85, f"in-bag share {in_bag}")
    shrink = [m.shrinkage for m in gbdt.models]
    check(np.allclose(shrink, [0.1 * 0.99 ** i for i in range(len(shrink))],
                      rtol=1e-6), f"learning-rate schedule {shrink}")
    # the bag draw at a fresh round and one tree's by-node draws: ms on
    # the device from CUDA events (a trace this short can lose its few
    # device events), launches from the profiler
    def bag_draw():
        strat.bag_mask(5 * strat.freq, None, None)

    def node_draw():
        gbdt._bynode_uniforms(gbdt.num_total_trees)
    bag_launches = device_profile(bag_draw)[1]
    node_launches = device_profile(node_draw)[1]
    bag_ms, node_ms = time_ms(bag_draw), time_ms(node_draw)
    tree_s = 1.0 / it_s
    prof = profile_tree(bst, tree_s)
    raw_tree = raw_count_tree(gbdt, gbdt.models[-1])
    raw_bounds = tree_byte_bounds(raw_tree, gbdt.layout)
    for k, v in raw_bounds.items():
        prof["kernels"][k]["bytes"] = v
        prof["kernels"][k]["bound_ms"] = 1e3 * v / HBM_BYTES_PER_S
    out = {"train_rows": gbdt.num_data, "valid_rows": dv.num_data(),
           "rounds_timed": rounds, "iterations_per_s": it_s,
           "round_s": np.diff(ends).tolist(),
           "first_round_s": ends[0] - t_start, "construct_s": "reused",
           "valid_auc": auc, "valid_auc_by_round": evals["valid_0"]["auc"],
           "grower": "compact", "launches": launches,
           "plain_calls": plain_calls, "host_syncs_in_tree": tree_syncs,
           "host_syncs_by_step": syncs, "num_trees": bst.num_trees(),
           "in_bag_share": in_bag, "shrinkage": shrink,
           "bag_draw_ms": bag_ms, "bag_draw_launches": bag_launches,
           "bynode_draw_ms": node_ms,
           "bynode_draw_launches": node_launches,
           # the profiled tree's root: in-bag rows over raw rows
           "root_in_bag_share": float(gbdt.models[-1].internal_count[0]
                                      / raw_tree.internal_count[0]),
           "tree_kernel_launches": prof["kernel_launches"],
           "tree_device_s": prof["device_s"], "tree_wall_s": tree_s,
           "tree_device_idle_share": prof["device_idle_share"],
           "tree_kernels": {k: {"device_ms": v["device_ms"],
                                "launches": v["launches"],
                                "bound_ms": v.get("bound_ms")}
                            for k, v in prof["kernels"].items()
                            if k != "histogram_sublane"}}
    print("TUNED", json.dumps(out), flush=True)
    out["profile"] = prof
    checks = {"kernels": check_tuned_kernels(bst),
              "goss": check_goss_selection(bst)}
    del bst, gbdt, ds, dv
    checks["cpu_vs_card"] = tuned_cpu_vs_card(lgt)
    checks["api"] = tuned_api_checks(lgt)
    print("TUNED_CHECKS", json.dumps(checks), flush=True)
    out["checks"] = checks
    results["tuned"] = out


CONSTRAINED_ROUNDS = 3         # timed rounds after one warm-up round
# the four interaction groups of the Higgs-shaped features
INTERACTION_GROUPS = [list(range(0, 7)), list(range(7, 14)),
                      list(range(14, 21)), list(range(21, 28))]


def constrained_params(w1):
    """MAIN's parameters with monotone constraints (the sign of the
    generator's w1 on the 8 features with the largest |w1|, 0 elsewhere),
    the intermediate method and the four interaction groups."""
    top = np.argsort(-np.abs(w1))[:8]
    mono = np.zeros(len(w1), np.int64)
    mono[top] = np.sign(w1[top]).astype(np.int64)
    return {"objective": "binary", "metric": "auc", "num_leaves": 255,
            "max_bin": 255, "learning_rate": 0.1, "min_data_in_leaf": 100,
            "verbosity": -1, "monotone_constraints": mono.tolist(),
            "monotone_constraints_method": "intermediate",
            "interaction_constraints": INTERACTION_GROUPS}


def monotone_sweep(bst, X, mono):
    """Each constrained feature swept over its bin upper bounds on the rows
    ``X``: the largest step of any row's raw prediction against the
    feature's direction (0 when every prediction moves only with it)."""
    worst = 0.0
    for j in np.nonzero(mono)[0]:
        bounds = bst._gbdt.mappers[j].bin_upper_bounds
        values = bounds[np.isfinite(bounds)]
        Xs = np.repeat(X[None], len(values), axis=0)      # [V, R, F]
        Xs[:, :, j] = values[:, None]
        preds = bst.predict(Xs.reshape(-1, X.shape[1]), raw_score=True)
        steps = np.diff(preds.reshape(len(values), -1), axis=0) * mono[j]
        worst = max(worst, float(-steps.min(initial=0.0)))
    return worst


def check_walk_kernel(bst):
    """The walk kernel against its plain version on the states of one more
    CONSTRAINED tree: every split's walk inputs are recorded (device
    copies), then the kernel runs on a card copy and the plain version on a
    CPU copy of each: flags and tightened bounds equal. The kernel's and
    the plain version's ms on the split that flagged the most leaves."""
    from lightgbm_tpu_torch.ops import grower_compact as gc_mod
    from lightgbm_tpu_torch.ops import monotone as mono_mod
    walk = gc_mod.monotone_walk
    states = []

    def recording(node_i, leaf_f, *a):
        states.append((node_i.clone(), leaf_f.clone(),
                       *[x.clone() if torch.is_tensor(x) else x for x in a]))
        return walk(node_i, leaf_f, *a)
    gc_mod.monotone_walk = recording
    try:
        bst.update()
    finally:
        gc_mod.monotone_walk = walk
    torch.cuda.synchronize()
    flagged, worst, best = [], 0.0, None
    for st in states:
        node_i, leaf_f = st[0], st[1]
        lk, lp = leaf_f.clone(), leaf_f.cpu()
        fk = mono_mod.monotone_walk(node_i, lk, *st[2:])
        fp = mono_mod.monotone_walk_plain(
            node_i.cpu(), lp, *[x.cpu() if torch.is_tensor(x) else x
                                for x in st[2:]])
        check(torch.equal(fk.cpu(), fp), "walk kernel flags differ from its "
              "plain version")
        check(torch.equal(lk.cpu(), lp), "walk kernel bounds differ from "
              "its plain version")
        n = int(fp.sum())
        flagged.append(n)
        if best is None or n > flagged[best]:
            best = len(flagged) - 1
    st = states[best]
    node_i, leaf_f = st[0], st[1]
    cpu_args = [x.cpu() if torch.is_tensor(x) else x for x in st[2:]]
    lt = leaf_f.clone()
    kernel_ms = time_ms(lambda: mono_mod.monotone_walk(node_i, lt, *st[2:]),
                        reps=50)
    t0 = time.perf_counter()
    for _ in range(5):
        mono_mod.monotone_walk_plain(node_i.cpu(), leaf_f.cpu(), *cpu_args)
    plain_ms = (time.perf_counter() - t0) * 200
    L = leaf_f.shape[0]
    # the bytes the walk must move: the node and leaf tables and the
    # directions read once, the bounds and flags written once
    nbytes = (node_i.numel() * 8 + leaf_f.numel() * 4
              + st[2].numel() * 8 + L * 8 + L)
    return {"states": len(states), "flagged_a_split_max": flagged[best],
            "flagged_a_tree": int(sum(flagged)), "max_abs_err": 0.0,
            "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bytes": nbytes,
            "leaves": L}


def constrained_cpu_vs_card(lgt):
    """The card against the CPU, one case each: 100k x 28 on the compact
    grower, 20k x 28 on the masked one, 15 leaves, 2 rounds, on
    continuously weighted rows (tie_free_weights); the extra-trees case
    with numpy's words on both (seamed_draws). Predictions within 1e-4
    and 0 differing splits; each case's wall seconds."""
    from lightgbm_tpu_torch import _kernels
    X, y = make_higgs_like(100_000, 28, seed=31)
    w = tie_free_weights(len(y), seed=17)
    mono = [1, -1, 0, 1, 0, 0, -1, 0] + [0] * 20
    base = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
    cases = [
        ("monotone_basic_compact", {"monotone_constraints": mono}),
        ("monotone_basic_masked", {"monotone_constraints": mono,
                                   "tpu_grower": "masked"}),
        ("monotone_intermediate_compact", {
            "monotone_constraints": mono,
            "monotone_constraints_method": "intermediate"}),
        ("monotone_penalty_compact", {"monotone_constraints": mono,
                                      "monotone_penalty": 1.5}),
        ("interaction_compact", {
            "interaction_constraints": INTERACTION_GROUPS}),
        ("interaction_masked", {"interaction_constraints":
                                INTERACTION_GROUPS, "tpu_grower": "masked"}),
        ("path_smooth_compact", {"path_smooth": 2.0}),
        ("extra_trees_compact", {"extra_trees": True}),
        ("feature_contri_compact", {"feature_contri": [1.0, 0.5] * 14}),
        ("cegb_compact", {"cegb_penalty_split": 1e-4,
                          "cegb_penalty_feature_coupled": [0.5] * 28}),
        # K3 (sublane) with lazy costs: the masked grower
        ("cegb_lazy_sublane_masked", {"cegb_penalty_feature_lazy":
                                      [0.01] * 28, "max_bin": 63,
                                      "tpu_hist_layout": "sublane"})]
    out = {}
    dataset = shared_datasets(lgt)
    with seamed_draws():
        for name, extra in cases:
            t0 = time.perf_counter()
            n = 20_000 if "masked" in name else len(y)
            Xc, yc, wc = X[:n], y[:n], w[:n]
            ds = dataset(Xc, yc, extra.get("max_bin", 255), weight=wc)
            _kernels.reset_counts()
            params = dict(base, **extra)
            boosters = {"cuda": lgt.train(
                dict(params, device_type="cuda"), ds, 2)}
            launches = dict(_kernels.LAUNCHES)
            check(sum(_kernels.PLAIN_CALLS.values()) == 0,
                  f"{name}: a plain version ran on the card")
            if "sublane" in name:
                check(launches["histogram_sublane"] > 0
                      and launches["histogram"] == 0,
                      f"{name}: not on K3 alone: {launches}")
            if "intermediate" in name:
                check(launches["monotone_walk"]
                      == 2 * (params["num_leaves"] - 1),
                      f"{name}: {launches['monotone_walk']} walks")
            boosters["cpu"] = lgt.train(
                dict(params, device_type="cpu"), ds, 2)
            check(boosters["cuda"]._gbdt.use_compact == ("masked" not in name),
                  f"{name}: the wrong grower")
            diff, differ = compare_boosters(boosters["cuda"], boosters["cpu"],
                                            Xc)
            check(diff <= 1e-4 and differ == 0,
                  f"{name}: card vs CPU predictions differ by {diff}, "
                  f"{differ} differing splits")
            out[name] = {"rows": n, "max_abs_pred_diff": diff,
                         "differing_splits": differ,
                         "launches": {k: v for k, v in launches.items()
                                      if v},
                         "s": time.perf_counter() - t0}
    return out


def phase_constrained(lgt, results):
    """Monotone and interaction constraints on the compact path: MAIN's
    constructed datasets (binary labels, as TUNED left them) and
    parameters with the monotone directions of constrained_params, the
    intermediate method and the four interaction groups; 1 warm-up and
    CONSTRAINED_ROUNDS timed rounds, a profiled tree (the walk kernel's
    device ms, and the rescans' from their profiler ranges), one more tree
    whose walk states check the walk kernel, and the monotone sweep. Then
    CONSTRAINED_CHECKS: constrained_cpu_vs_card."""
    from lightgbm_tpu_torch import _kernels
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    ds, dv = results["main_datasets"]
    X, _, _, n_val = results["higgs"]
    params = constrained_params(results["higgs_w1"])
    mono = np.asarray(params["monotone_constraints"])
    rounds = CONSTRAINED_ROUNDS
    syncs = {}
    ends = []
    flagged = []

    def timer(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        flagged.append(int(env.model._gbdt.tree_stats["rescan_flagged"]))
    timer.order = 5

    evals = {}
    _kernels.reset_counts()
    with count_syncs(gbdt_mod.GBDT, COMPACT_STEP, syncs):
        t_start = time.perf_counter()
        bst = lgt.train(dict(params, device_type="cuda"), ds, 1 + rounds,
                        valid_sets=[dv],
                        callbacks=[timer, lgt.record_evaluation(evals)])
    launches = dict(_kernels.LAUNCHES)
    plain_calls = dict(_kernels.PLAIN_CALLS)
    gbdt = bst._gbdt
    L = gbdt.grower_params.num_leaves
    check(len(ends) == 1 + rounds, f"trained {len(ends)} rounds")
    it_s = rounds / (ends[-1] - ends[0])
    auc = evals["valid_0"]["auc"][-1]
    check(gbdt.use_compact and gbdt.grower_params.mono_intermediate,
          "CONSTRAINED did not run the intermediate method on the compact "
          "grower")
    for k in ("histogram", "fused_split", "monotone_walk"):
        check(launches[k] > 0, f"kernel {k} was not launched on the "
              "CONSTRAINED path")
    check(launches["monotone_walk"] == (1 + rounds) * (L - 1),
          f"the walk launched {launches['monotone_walk']} times in "
          f"{1 + rounds} trees of {L - 1} splits")
    check(launches["histogram_sublane"] == 0, "K3 ran on CONSTRAINED")
    for k, v in plain_calls.items():
        check(v == 0, f"plain version of {k} ran {v} times on the card")
    check(np.isfinite(auc) and auc > 0.6, f"CONSTRAINED validation AUC {auc}")
    check(syncs.get("in_tree") == 0,
          f"host syncs in the constrained tree step: {syncs}")
    check(min(flagged) > 0, f"flagged leaves a tree {flagged}")
    tree_s = 1.0 / it_s
    prof = profile_tree(bst, tree_s)
    rescan = prof["ranges"]["monotone_rescan"]
    walk = check_walk_kernel(bst)
    Xs = X[-n_val:][:1000]
    worst = monotone_sweep(bst, Xs, mono)
    check(worst == 0.0, f"a constrained feature moved a prediction against "
          f"its direction by {worst}")
    main = results["main"]
    out = {"train_rows": gbdt.num_data, "valid_rows": dv.num_data(),
           "rounds_timed": rounds, "iterations_per_s": it_s,
           "main_iterations_per_s": main["iterations_per_s"],
           "vs_main": it_s / main["iterations_per_s"],
           "round_s": np.diff(ends).tolist(),
           "first_round_s": ends[0] - t_start, "construct_s": "reused",
           "valid_auc": auc, "valid_auc_by_round": evals["valid_0"]["auc"],
           "main_valid_auc_by_round": main["valid_auc_by_round"],
           "monotone_constraints": mono.tolist(),
           "launches": launches, "plain_calls": plain_calls,
           "host_syncs_in_tree": syncs.get("in_tree"),
           "host_syncs_by_step": syncs, "num_trees": bst.num_trees(),
           "flagged_leaves_by_tree": flagged,
           "walk_launches_a_tree": launches["monotone_walk"] / (1 + rounds),
           "walk_device_ms_a_tree":
               prof["kernels"]["monotone_walk"]["device_ms"],
           "rescan_device_ms_a_tree": rescan["device_ms"],
           "rescan_launches_a_tree": rescan["launches"],
           "rescan_launches_a_split": rescan["launches"] / rescan["count"],
           "tree_kernel_launches": prof["kernel_launches"],
           "launches_a_split": prof["kernel_launches"] / (L - 1),
           "main_launches_a_split": main["profile"]["kernel_launches"]
           / (L - 1),
           "tree_device_s": prof["device_s"], "tree_wall_s": tree_s,
           "tree_device_idle_share": prof["device_idle_share"],
           "tree_kernels": {k: {"device_ms": v["device_ms"],
                                "launches": v["launches"],
                                "bound_ms": v.get("bound_ms")}
                            for k, v in prof["kernels"].items()
                            if k != "histogram_sublane"},
           "walk_kernel": walk, "monotone_sweep_rows": len(Xs),
           "monotone_sweep_worst_step": worst}
    print("CONSTRAINED", json.dumps(out), flush=True)
    out["profile"] = prof
    del bst, gbdt, ds, dv
    checks = {"cpu_vs_card": constrained_cpu_vs_card(lgt)}
    print("CONSTRAINED_CHECKS", json.dumps(checks), flush=True)
    out["checks"] = checks
    results["constrained"] = out


# ---- A14c: DART, random forest, forced splits, linear leaves ------------

A14C_PARAMS = {"objective": "binary", "metric": "auc", "num_leaves": 255,
               "max_bin": 255, "learning_rate": 0.1, "min_data_in_leaf": 100,
               "verbosity": -1}
DART_ROUNDS = 5                # timed rounds after one warm-up round
# LightGBM's DART defaults (drop_rate 0.1, max_drop 50, drop_seed 4) but
# skip_drop 0: every round after the first draws its drops
DART_PARAMS = dict(A14C_PARAMS, boosting="dart", skip_drop=0.0)
RF_ROUNDS = 3                  # timed rounds after one warm-up round
# 0.632: the share of distinct rows in a bootstrap sample
RF_PARAMS = dict(A14C_PARAMS, boosting="rf", bagging_fraction=0.632,
                 bagging_freq=1, feature_fraction=0.8)


def reload_diff(lgt, bst, X):
    """Max |difference| between the booster's predictions of ``X`` and
    those of its saved and reloaded model text, and the text."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.txt")
        bst.save_model(path)
        text = open(path).read()
        loaded = lgt.Booster(model_file=path)
    return float(np.abs(loaded.predict(X) - bst.predict(X)).max()), text


def phase_dart(lgt, results):
    """DART on the compact path: MAIN's constructed datasets (binary labels)
    and parameters with boosting=dart (DART_PARAMS), 1 warm-up and
    DART_ROUNDS timed rounds: iterations/s beside MAIN's, the trees dropped
    in each round (some round drops), K1's and K2's launches (> 0), K3's
    (0), plain calls (0), host syncs in the tree step (0) and in the drop
    routing; then a profiled round with the drop and normalise routing's
    device ms and launches (its profiler ranges) and K1's and K2's device
    ms beside their byte bounds; the reloaded model (1e-6)."""
    from lightgbm_tpu_torch import _kernels
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    ds, dv = results["main_datasets"]
    X, _, _, n_val = results["higgs"]
    rounds = DART_ROUNDS
    syncs, route_syncs = {}, {}
    ends, dropped = [], []

    def timer(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
        dropped.append(list(env.model._gbdt.last_drop))
    timer.order = 5

    evals = {}
    _kernels.reset_counts()
    with count_syncs(gbdt_mod.GBDT, COMPACT_STEP, syncs), \
            count_syncs(gbdt_mod.GBDT, ["host_tree_arrays",
                                        "apply_tree_to_scores"],
                        route_syncs):
        t_start = time.perf_counter()
        bst = lgt.train(dict(DART_PARAMS, device_type="cuda"), ds,
                        1 + rounds, valid_sets=[dv],
                        callbacks=[timer, lgt.record_evaluation(evals)])
    launches = dict(_kernels.LAUNCHES)
    plain_calls = dict(_kernels.PLAIN_CALLS)
    gbdt = bst._gbdt
    check(len(ends) == 1 + rounds, f"trained {len(ends)} rounds")
    it_s = rounds / (ends[-1] - ends[0])
    auc = evals["valid_0"]["auc"][-1]
    check(gbdt.use_compact, "DART did not take the compact grower")
    for k in ("histogram", "fused_split"):
        check(launches[k] > 0, f"kernel {k} was not launched on the DART "
              "path")
    check(launches["histogram_sublane"] == 0, "K3 ran on the DART path")
    for k, v in plain_calls.items():
        check(v == 0, f"plain version of {k} ran {v} times on the card")
    check(syncs.get("in_tree") == 0,
          f"host syncs in the DART tree step: {syncs}")
    check(sum(map(len, dropped)) > 0, f"no round dropped a tree: {dropped}")
    check(np.isfinite(auc) and auc > 0.7, f"DART validation AUC {auc}")
    prof = profile_tree(bst, 1.0 / it_s)
    routing = {rng: prof.get("ranges", {}).get(
        rng, {"count": 0, "device_ms": 0.0, "launches": 0})
        for rng in ("dart_drop", "dart_normalize")}
    profiled_drop = list(gbdt.last_drop)
    Xp = X[-n_val:][:20_000]
    diff, _ = reload_diff(lgt, bst, Xp)
    check(diff <= 1e-6, f"reloaded DART model differs by {diff}")
    main = results["main"]
    out = {"train_rows": gbdt.num_data, "valid_rows": dv.num_data(),
           "rounds_timed": rounds, "iterations_per_s": it_s,
           "main_iterations_per_s": main["iterations_per_s"],
           "vs_main": it_s / main["iterations_per_s"],
           "round_s": np.diff(ends).tolist(),
           "first_round_s": ends[0] - t_start, "construct_s": "reused",
           "dropped_by_round": dropped,
           "profiled_round_dropped": profiled_drop,
           "routing_device_ms": {k: v["device_ms"]
                                 for k, v in routing.items()},
           "routing_launches": {k: v["launches"]
                                for k, v in routing.items()},
           "routing_host_syncs": route_syncs.get("in_tree"),
           "routing_host_syncs_by_step": route_syncs,
           "valid_auc": auc, "valid_auc_by_round": evals["valid_0"]["auc"],
           "main_valid_auc_by_round": main["valid_auc_by_round"],
           "launches": launches, "plain_calls": plain_calls,
           "host_syncs_in_tree": syncs.get("in_tree"),
           "host_syncs_by_step": syncs, "num_trees": bst.num_trees(),
           "shrinkage_by_tree": [m.shrinkage for m in gbdt.models],
           "tree_kernel_launches": prof["kernel_launches"],
           "tree_device_s": prof["device_s"], "tree_wall_s": 1.0 / it_s,
           "tree_device_idle_share": prof["device_idle_share"],
           "tree_kernels": {k: {"device_ms": v["device_ms"],
                                "launches": v["launches"],
                                "bound_ms": v.get("bound_ms")}
                            for k, v in prof["kernels"].items()
                            if k != "histogram_sublane"},
           "reload_max_abs_diff": diff}
    print("DART", json.dumps(out), flush=True)
    out["profile"] = prof
    results["dart"] = out


def phase_rf(lgt, results):
    """Random forest on the masked grower: MAIN's constructed datasets and
    parameters with boosting=rf (RF_PARAMS: bagging 0.632 every round,
    feature_fraction 0.8), 1 warm-up and RF_ROUNDS timed rounds:
    iterations/s, K1 (dense: the lane layout of tpu_hist_layout=auto at
    255 bins) launches (> 0), K2's and K3's (0), plain calls (0), host
    syncs in the tree step; a profiled tree with K1's device ms beside its
    byte bound; average_output in the reloaded text, predictions within
    1e-6. The datasets are released after it."""
    from lightgbm_tpu_torch import _kernels
    from lightgbm_tpu_torch.boosting import rf as rf_mod
    ds, dv = results.pop("main_datasets")
    X, _, _, n_val = results["higgs"]
    rounds = RF_ROUNDS
    syncs = {}
    ends = []

    def timer(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    timer.order = 5

    evals = {}
    _kernels.reset_counts()
    with count_syncs(rf_mod, ["grow_tree"], syncs):
        t_start = time.perf_counter()
        bst = lgt.train(dict(RF_PARAMS, device_type="cuda"), ds, 1 + rounds,
                        valid_sets=[dv],
                        callbacks=[timer, lgt.record_evaluation(evals)])
    launches = dict(_kernels.LAUNCHES)
    plain_calls = dict(_kernels.PLAIN_CALLS)
    gbdt = bst._gbdt
    L = gbdt.grower_params.num_leaves
    check(len(ends) == 1 + rounds, f"trained {len(ends)} rounds")
    it_s = rounds / (ends[-1] - ends[0])
    auc = evals["valid_0"]["auc"][-1]
    check(not gbdt.use_compact and gbdt.grower_params.hist_layout == "lane",
          "RF did not take the masked grower with the lane layout")
    check(launches["histogram"] == (1 + rounds) * L,
          f"K1 launched {launches['histogram']} times in {1 + rounds} "
          f"masked trees of {L} leaves")
    check(launches["fused_split"] == 0 and launches["histogram_sublane"] == 0,
          f"K2 or K3 ran on the RF path: {launches}")
    for k, v in plain_calls.items():
        check(v == 0, f"plain version of {k} ran {v} times on the card")
    check(syncs.get("in_tree") == 0, f"host syncs in the RF grower: {syncs}")
    check(np.isfinite(auc) and auc > 0.7, f"RF validation AUC {auc}")
    prof = profile_tree(bst, 1.0 / it_s)
    Xp = X[-n_val:][:20_000]
    diff, text = reload_diff(lgt, bst, Xp)
    head = text.split("Tree=0")[0].splitlines()
    check("average_output" in head, "no average_output in the RF text")
    check(diff <= 1e-6, f"reloaded RF model differs by {diff}")
    k1 = prof["kernels"]["histogram"]
    out = {"train_rows": gbdt.num_data, "valid_rows": dv.num_data(),
           "rounds_timed": rounds, "iterations_per_s": it_s,
           "main_iterations_per_s": results["main"]["iterations_per_s"],
           "round_s": np.diff(ends).tolist(),
           "first_round_s": ends[0] - t_start, "construct_s": "reused",
           "valid_auc": auc, "valid_auc_by_round": evals["valid_0"]["auc"],
           "launches": launches, "plain_calls": plain_calls,
           "host_syncs_in_grower": syncs.get("in_tree"),
           "num_trees": bst.num_trees(),
           "average_output_in_text": True, "reload_max_abs_diff": diff,
           "tree_kernel_launches": prof["kernel_launches"],
           "tree_device_s": prof["device_s"], "tree_wall_s": 1.0 / it_s,
           "tree_device_idle_share": prof["device_idle_share"],
           "k1_tree_device_ms": k1["device_ms"],
           "k1_tree_launches": k1["launches"],
           "k1_tree_bound_ms": k1.get("bound_ms")}
    print("RF", json.dumps(out), flush=True)
    out["profile"] = prof
    results["rf"] = out
    del bst, gbdt, ds, dv


WIDE_ROUNDS = 2                # timed rounds after one warm-up round
WIDE_PARAMS = dict(MAIN_PARAMS, max_bin=1023)
# K1's wide-bin kernel on synthetic bins: (rows, features, bins, channels)
WIDE_SYNTHETIC = ((2_000_000, 28, 1024, 3), (1_000_000, 8, 4096, 3),
                  (500_000, 3, 40_000, 3))


def dump_agrees(loaded, trained):
    """Whether a reloaded model's ``dump_model`` equals the trained
    booster's in every field it holds (a model read from text, as the JAX
    package's ``loaded_dump``, dumps no internal weights or counts and no
    feature infos)."""
    if isinstance(loaded, dict):
        return isinstance(trained, dict) and all(
            key in trained and dump_agrees(v, trained[key])
            for key, v in loaded.items())
    if isinstance(loaded, list):
        return isinstance(trained, list) and len(loaded) == len(trained) \
            and all(map(dump_agrees, loaded, trained))
    return loaded == trained


def wide_bins_root_check(bst):
    """K1's wide-bin kernel at the WIDE_BINS run's root (every training
    row, B = 1,024) against its plain version: bit-equal on the run's
    gradients rounded to a 1/64 grid; on the run's own gradients each
    within (m - 1) 2^-24 of a cell's |addends| of float64 sums (a leaf's
    rows share one gradient: unfused_root_checks); timed beside its plain
    version, index_add_ of the same channels and its byte bound, N (2F +
    4K) read and F B K 4 written."""
    from lightgbm_tpu_torch.ops.histogram import _xla_histogram
    from lightgbm_tpu_torch.ops.packed import bin_values
    from lightgbm_tpu_torch.ops.pallas_histogram import pallas_histogram
    gbdt = bst._gbdt
    bins = gbdt.binned
    n, f = bins.shape
    b = gbdt.grower_params.num_bins
    g, h = gbdt.objective.get_gradients(gbdt.train_score[0], gbdt.label,
                                        gbdt.grad_weight)
    ch = torch.stack([g, h, torch.ones_like(g)], dim=1).float().contiguous()
    k = ch.shape[1]
    dch = torch.round(ch * 64) / 64

    def kern(c=ch):
        return pallas_histogram(bins, c, b, mode="f32")
    hist_close(kern(dch), _xla_histogram(bins, dch, b), None,
               "WIDE_BINS: K1 16-bit at the root, 1/64 grid", rel=0)
    del dch
    hk, hp = kern(), _xla_histogram(bins, ch, b)
    flat = (bin_values(bins) + torch.arange(f, device=bins.device) * b
            ).reshape(-1)
    src = ch[:, None, :].expand(n, f, k).reshape(-1, k)
    exact = torch.zeros(f * b, k, dtype=torch.float64, device=bins.device)
    absh = torch.zeros_like(exact)
    src64 = src.double()
    exact.index_add_(0, flat, src64)
    absh.index_add_(0, flat, src64.abs_())
    del src64
    exact, absh = exact.view(f, b, k), absh.view(f, b, k)
    bound = (exact[..., 2:] - 1).clamp(min=0) * 2.0 ** -24 * absh[..., :2]
    line = {"rows": n, "features": f, "bins": b, "channels": k}
    for what, hist in (("kernel", hk), ("plain", hp)):
        herr = (hist[..., :2].double() - exact[..., :2]).abs()
        check(bool((herr <= bound + 1e-30).all()), f"WIDE_BINS: the "
              f"{what}'s f32 sums at the root off the float64 sums by more "
              "than (m - 1) 2^-24 of their |addends|")
        line[f"run_gradients_{what}_max_rel_err"] = float(
            (herr / (absh[..., :2] + 1e-30)).max())
    check(torch.equal(hk[..., 2:], hp[..., 2:]), "WIDE_BINS: K1 16-bit's "
          "count channel differs from its plain version's")
    line["max_abs_err"] = float((hk - hp).abs().max())
    del exact, absh, bound, hk, hp
    lib_out = torch.zeros(f * b, k, device=bins.device)

    def lib():
        lib_out.zero_()
        lib_out.index_add_(0, flat, src)
    line.update(
        ms=time_ms(kern),
        plain_ms=time_ms(lambda: _xla_histogram(bins, ch, b), 3, 1),
        library_ms=time_ms(lib, 3, 1),
        bound_ms=1e3 * (n * (2 * f + 4 * k) + 4 * f * b * k)
        / HBM_BYTES_PER_S)
    return line


def wide_bins_synthetic():
    """K1's wide-bin kernel at B = 1,024, 4,096 and 40,000 on synthetic
    uint16 bins (a tenth of the rows in one bin of feature 0, bins from
    32,768 up where B passes it) and 1/64-grid channels, a third of the
    rows zero: bit-equal to its plain version, timed beside it and its
    byte bound."""
    from lightgbm_tpu_torch.ops.packed import bins_to_device
    from lightgbm_tpu_torch.ops.pallas_histogram import (
        pallas_histogram, pallas_histogram_plain)
    out = []
    for n, f, b, k in WIDE_SYNTHETIC:
        rng = np.random.RandomState(b)
        bins = rng.randint(0, b, (n, f)).astype(np.uint16)
        bins[:n // 10, 0] = min(b - 1, 40_000)
        ch = np.round(rng.randn(n, k) * 64) / 64
        ch[rng.rand(n) < 0.3] = 0.0
        tb = bins_to_device(bins, "cuda")
        tc = torch.from_numpy(ch.astype(np.float32)).cuda()
        kern = pallas_histogram(tb, tc, b, mode="f32")
        plain = pallas_histogram_plain(tb, tc, b, "f32")
        check(torch.equal(kern, plain), f"WIDE_BINS: K1 16-bit at B = {b} "
              "differs from its plain version")
        out.append({"rows": n, "features": f, "bins": b, "channels": k,
                    "max_bin_value": int(bins.max()), "max_abs_err": 0.0,
                    "ms": time_ms(lambda: pallas_histogram(tb, tc, b,
                                                           mode="f32")),
                    "plain_ms": time_ms(lambda: pallas_histogram_plain(
                        tb, tc, b, "f32"), 3, 1),
                    "bound_ms": 1e3 * (n * (2 * f + 4 * k) + 4 * f * b * k)
                    / HBM_BYTES_PER_S})
        del tb, tc, kern, plain
    return out


def wide_bins_cpu_vs_card(lgt):
    """WIDE_BINS' configuration at 100k x 28, 31 leaves, 3 rounds, on
    weighted rows (tie_free_weights: no exact tie for f32 order to break)
    on the card and on the CPU: 0 differing splits, predictions within
    1e-4."""
    X, y = make_higgs_like(100_000, 28, seed=11)
    w = tie_free_weights(len(X))
    p = dict(WIDE_PARAMS, num_leaves=31)
    ds = lgt.Dataset(X, y, weight=w, params={"max_bin": 1023})
    boosters = [lgt.train(dict(p, device_type=d), ds, 3)
                for d in ("cuda", "cpu")]
    diff, splits = compare_boosters(*boosters, X[:20_000])
    check(splits == 0 and diff <= 1e-4, f"WIDE_BINS card vs CPU: {splits} "
          f"differing splits, predictions {diff} apart")
    return {"rows": len(X), "max_abs_diff": diff, "differing_splits": splits}


def phase_wide_bins(lgt, results):
    """WIDE_BINS: MAIN's rows binned at max_bin=1023 (16-bit bins, no EFB)
    with MAIN's other parameters, 1 warm-up and WIDE_ROUNDS timed rounds:
    the masked grower with the lane layout, K1's wide-bin kernel once for
    the root and once a split and no other kernel, plain calls (0), host
    syncs in the grower (0), iterations/s beside MAIN's, validation AUC (>
    0.7), a profiled tree (K1's device ms beside its byte bound, the
    profiler's launches equal the wrapper's); K1 16-bit at the root against
    its plain version, timed beside index_add_ (wide_bins_root_check) and
    on synthetic bins up to B = 40,000; pred_leaf equal to the CPU's on a
    sample; pred_contrib on 4,096 validation rows through the 16-bit
    TreeSHAP kernel against its plain version (1e-12 of a cell's scale),
    timed; the reloaded model (1e-6) and its dump_model equal to the
    booster's; the card against the CPU at 100k rows."""
    from lightgbm_tpu_torch import _kernels
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    from lightgbm_tpu_torch.ops import treeshap_device as ts
    from lightgbm_tpu_torch.ops.packed import bins_to_device
    X, y, _, n_val = results["higgs"]
    t0 = time.perf_counter()
    ds = lgt.Dataset(X[:-n_val], y[:-n_val], params={"max_bin": 1023})
    dv = ds.create_valid(X[-n_val:], y[-n_val:])
    ds.construct()
    dv.construct()
    construct_s = time.perf_counter() - t0
    inner = ds._inner
    check(inner.binned.dtype == np.uint16 and inner.bundle_info is None
          and inner.max_num_bins == 1024,
          f"WIDE_BINS: {inner.binned.dtype} bins, bundles "
          f"{inner.bundle_info}, {inner.max_num_bins} bins")
    rounds = WIDE_ROUNDS
    syncs, ends, evals = {}, [], {}

    def timer(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    timer.order = 5

    _kernels.reset_counts()
    with count_syncs(gbdt_mod, ["grow_tree"], syncs):
        t_start = time.perf_counter()
        bst = lgt.train(dict(WIDE_PARAMS, device_type="cuda"), ds,
                        1 + rounds, valid_sets=[dv],
                        callbacks=[timer, lgt.record_evaluation(evals)])
    launches = dict(_kernels.LAUNCHES)
    modes = dict(_kernels.MODE_LAUNCHES)
    plain_calls = dict(_kernels.PLAIN_CALLS)
    gbdt = bst._gbdt
    L = gbdt.grower_params.num_leaves
    check(len(ends) == 1 + rounds, f"trained {len(ends)} rounds")
    it_s = rounds / (ends[-1] - ends[0])
    auc = evals["valid_0"]["auc"][-1]
    check(not gbdt.use_compact and gbdt.grower_params.hist_layout == "lane"
          and gbdt.binned.dtype == torch.int16,
          "WIDE_BINS did not take the masked grower, the lane layout and "
          "16-bit bins")
    check(launches["histogram"] == modes["histogram/u16"]
          == (1 + rounds) * L, f"K1 16-bit launched {modes['histogram/u16']}"
          f" times ({launches['histogram']} K1 launches) in {1 + rounds} "
          f"masked trees of {L} leaves")
    check(sum(launches.values()) == launches["histogram"],
          f"another kernel ran on the WIDE_BINS path: {launches}")
    for k, v in plain_calls.items():
        check(v == 0, f"plain version of {k} ran {v} times on the card")
    check(syncs.get("in_tree") == 0, f"host syncs in the grower: {syncs}")
    check(np.isfinite(auc) and auc > 0.7, f"WIDE_BINS validation AUC {auc}")
    prof = profile_tree(bst, 1.0 / it_s)
    k1 = prof["kernels"]["histogram"]
    check(prof["modes"]["histogram/u16"]["launches"]
          == prof["modes"]["histogram/u16"]["counted"] == L,
          f"the profiled tree's K1 16-bit launches: {prof['modes']}")
    root = wide_bins_root_check(bst)
    synthetic = wide_bins_synthetic()

    # prediction on 16-bit rows: leaf indices, contributions, model text
    Xv = X[-n_val:]
    cpu = cpu_twin(bst)
    leaves = bst.predict(Xv[:PREDICT_SAMPLE], pred_leaf=True)
    check(np.array_equal(leaves, cpu.predict(Xv[:PREDICT_SAMPLE],
                                             pred_leaf=True)),
          "WIDE_BINS: pred_leaf card against CPU")
    Xp = Xv[:PREDICT_PLAIN_ROWS]
    before = dict(_kernels.MODE_LAUNCHES)
    phi = bst.predict(Xp, pred_contrib=True)
    contrib_launches = (_kernels.MODE_LAUNCHES["treeshap/u16"]
                        - before["treeshap/u16"])
    check(contrib_launches > 0, "pred_contrib did not launch the 16-bit "
          "TreeSHAP kernel")
    paths = ts.build_shap_paths(gbdt.models,
                                gbdt._pred_nan_arr.cpu().numpy(),
                                gbdt.feature_is_categorical(), gbdt.device)
    b = bins_to_device(gbdt.bin_matrix(Xp), gbdt.device)
    kern = ts.tree_shap(b, paths, 1)
    plain = ts.tree_shap_plain(b, paths, 1)
    scale = float(paths.leaf_value.abs().sum() + paths.ev.abs().sum())
    err = (kern - plain).abs()
    shap = {"rows": len(Xp), "launches": contrib_launches,
            "max_abs_err": float(err.max()),
            "max_rel_err": float((err / (plain.abs() + scale)).max()),
            "contrib_max_abs_err": float(np.abs(
                phi - plain.reshape(len(Xp), -1).cpu().numpy()).max())}
    check(shap["max_rel_err"] <= 1e-12 and shap["contrib_max_abs_err"]
          <= 1e-12 * (float(plain.abs().max()) + scale),
          f"WIDE_BINS: the 16-bit TreeSHAP kernel against its plain "
          f"version: {shap}")
    nbytes = (b.numel() * b.element_size() + len(Xp) * (Xp.shape[1] + 1) * 8
              + sum(t.numel() * t.element_size() for t in paths
                    if torch.is_tensor(t)))
    ops = ts.shap_ops(paths, len(Xp))
    shap.update(ms=time_ms(lambda: ts.tree_shap(b, paths, 1), reps=5,
                           warm=1),
                plain_ms=time_ms(lambda: ts.tree_shap_plain(b, paths, 1),
                                 reps=1, warm=0),
                bytes_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                ops_ms=1e3 * ops / FP64_OPS_PER_S)
    shap["bound_ms"] = max(shap["bytes_ms"], shap["ops_ms"])
    shap["bound_by"] = ("operations" if shap["ops_ms"] >= shap["bytes_ms"]
                        else "bytes")
    del b, kern, plain
    diff, text = reload_diff(lgt, bst, Xv[:20_000])
    check(diff <= 1e-6, f"reloaded WIDE_BINS model differs by {diff}")
    check(dump_agrees(lgt.Booster(model_str=text).dump_model(),
                      bst.dump_model()),
          "WIDE_BINS: the reloaded model's dump_model differs from the "
          "booster's")
    cmp = wide_bins_cpu_vs_card(lgt)
    main = results["main"]
    out = {"train_rows": gbdt.num_data, "valid_rows": dv.num_data(),
           "max_bin": 1023, "bins": gbdt.grower_params.num_bins,
           "host_bin_dtype": str(inner.binned.dtype),
           "device_bin_dtype": str(gbdt.binned.dtype),
           "bin_mb": inner.binned.nbytes / 2 ** 20,
           "construct_s": construct_s, "rounds_timed": rounds,
           "iterations_per_s": it_s,
           "main_iterations_per_s": main["iterations_per_s"],
           "vs_main": it_s / main["iterations_per_s"],
           "round_s": np.diff(ends).tolist(),
           "first_round_s": ends[0] - t_start, "valid_auc": auc,
           "valid_auc_by_round": evals["valid_0"]["auc"],
           "launches": launches, "mode_launches": modes,
           "plain_calls": plain_calls,
           "host_syncs_in_grower": syncs.get("in_tree"),
           "tree_kernel_launches": prof["kernel_launches"],
           "tree_device_s": prof["device_s"], "tree_wall_s": 1.0 / it_s,
           "tree_device_idle_share": prof["device_idle_share"],
           "k1_tree_device_ms": k1["device_ms"],
           "k1_tree_launches": k1["launches"],
           "k1_tree_bound_ms": k1.get("bound_ms"),
           "root": root, "synthetic": synthetic, "treeshap": shap,
           "reload_max_abs_diff": diff, "cpu_vs_card": cmp}
    print("WIDE_BINS", json.dumps(out), flush=True)
    out["profile"] = prof
    results["wide_bins"] = out
    del bst, gbdt, ds, dv, inner


@contextlib.contextmanager
def dyadic_regression():
    """The L2 regression objective's weighted gradients and hessians
    rounded to a 1/64 grid (a hessian at least 1/64) on every device: every
    histogram sum of every round is then exact in f32 whatever the order
    of the card's atomics, and the card and the CPU see the same values
    (the linear fit takes them too)."""
    from lightgbm_tpu_torch.objectives import RegressionL2
    own = RegressionL2.get_gradients

    def rounded(self, score, label, weight=None):
        g, h = own(self, score, label, weight)
        return (torch.round(g * 64) / 64,
                torch.clamp(torch.round(h * 64), min=1) / 64)
    RegressionL2.get_gradients = rounded
    try:
        yield
    finally:
        RegressionL2.get_gradients = own


def first_differing_split(a, b):
    """The first node, in tree order, where two boosters' splits differ,
    with each one's split and recorded gain (None where none differs)."""
    for t, (ta, tb) in enumerate(zip(a._gbdt.models, b._gbdt.models)):
        for i in range(min(ta.num_nodes, tb.num_nodes)):
            sa = (int(ta.split_feature[i]), int(ta.split_bin[i]),
                  bool(ta.default_left[i]))
            sb = (int(tb.split_feature[i]), int(tb.split_bin[i]),
                  bool(tb.default_left[i]))
            if sa != sb:
                return {"tree": t, "node": i, "a": sa, "b": sb,
                        "a_gain": float(ta.split_gain[i]),
                        "b_gain": float(tb.split_gain[i])}
    return None


def a14c_cpu_vs_card(lgt):
    """The card against the CPU on one shared dataset, one case each, on
    weighted rows (tie_free_weights), 15 leaves: DART on the compact grower
    (70k x 28, 3 rounds, drop_rate 0.5: the same drops on both), DART,
    RF (numpy's bags on both, seamed_draws), forced splits on the masked
    grower (20k x 28, 3 rounds), and linear leaves on a regression (20k
    rows with a tenth of two columns NaN, a label linear in those two
    columns plus a step and noise, gradients on a 1/64 grid
    (dyadic_regression), 3 rounds; the fit's host seconds a tree).
    Predictions within 1e-4 and 0 differing splits (a failure names the
    first differing node and both devices' gains there); each case's
    wall s."""
    from lightgbm_tpu_torch import _kernels
    X, y = make_higgs_like(70_000, 28, seed=41)
    w = tie_free_weights(len(y), seed=19)
    Xn = X[:20_000].astype(np.float64)
    rng = np.random.RandomState(43)
    y_lin = np.clip(1.5 * Xn[:, 0] - Xn[:, 2] + np.where(Xn[:, 5] > 0, 0.75,
                                                         -0.75)
                    + 0.3 * rng.randn(len(Xn)), -6.0, 6.0)
    for j in (0, 2):
        Xn[rng.rand(len(Xn)) < 0.1, j] = np.nan
    base = {"objective": "binary", "num_leaves": 15, "verbosity": -1}
    dart = {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0}
    forced = {"feature": 0, "threshold": 0.0,
              "left": {"feature": 2, "threshold": -0.5},
              "right": {"feature": 5, "threshold": 0.25}}
    out = {}
    with tempfile.TemporaryDirectory() as tmp, seamed_draws():
        fpath = os.path.join(tmp, "forced.json")
        with open(fpath, "w") as fh:
            json.dump(forced, fh)
        cases = [("dart_compact", len(y), dart),
                 ("dart_masked", 20_000, dict(dart, tpu_grower="masked")),
                 ("rf_masked", 20_000, {"boosting": "rf",
                                        "bagging_fraction": 0.632,
                                        "bagging_freq": 1,
                                        "feature_fraction": 0.8}),
                 ("forced_masked", 20_000,
                  {"forcedsplits_filename": fpath}),
                 ("linear_masked", 20_000, {"objective": "regression",
                                            "linear_tree": True,
                                            "linear_lambda": 0.1})]
        datasets = {}
        for name, n, extra in cases:
            t0 = time.perf_counter()
            linear = "linear" in name
            Xc = Xn if linear else X[:n]
            key = (n, linear)
            if key not in datasets:
                datasets[key] = lgt.Dataset(Xc, y_lin if linear else y[:n],
                                            weight=w[:n],
                                            params={"linear_tree": linear})
            ds = datasets[key]
            params = dict(base, **extra)
            boosters = {}
            _kernels.reset_counts()
            with (dyadic_regression() if linear
                  else contextlib.nullcontext()):
                for dev in ("cuda", "cpu"):
                    boosters[dev] = lgt.train(dict(params, device_type=dev),
                                              ds, 3)
                    if dev == "cuda":
                        launches = dict(_kernels.LAUNCHES)
                        check(sum(_kernels.PLAIN_CALLS.values()) == 0,
                              f"{name}: a plain version ran on the card")
            card = boosters["cuda"]._gbdt
            check(card.use_compact == ("compact" in name),
                  f"{name}: the wrong grower")
            diff, differ = compare_boosters(boosters["cuda"], boosters["cpu"],
                                            Xc)
            check(diff <= 1e-4 and differ == 0,
                  f"{name}: card vs CPU predictions differ by {diff}, "
                  f"{differ} differing splits; the first (a: the card, b: "
                  f"the CPU): {first_differing_split(*boosters.values())}")
            entry = {"rows": n, "max_abs_pred_diff": diff,
                     "differing_splits": differ,
                     "launches": {k: v for k, v in launches.items() if v},
                     "s": time.perf_counter() - t0}
            if "dart" in name:
                drops = [boosters[d]._gbdt.tree_weight for d in boosters]
                check(drops[0] == drops[1], f"{name}: the drops differ")
                check(any(m.shrinkage < 0.1 for m in card.models),
                      f"{name}: no round dropped a tree")
            if "forced" in name:
                check(all((m.split_feature[:3] == [0, 2, 5]).all()
                          and (m.split_gain[:3] == 0).all()
                          for m in card.models), f"{name}: the forced "
                      "splits did not come first")
            if linear:
                check(any(m.is_linear and any(m.leaf_features)
                          for m in card.models),
                      f"{name}: no leaf fitted a linear model")
                entry["fit_host_s_a_tree"] = (card.linear_fit_s
                                              / len(card.models))
                entry["nan_rows"] = int(np.isnan(Xc).any(axis=1).sum())
            out[name] = entry
    return out


def phase_a14c_checks(lgt, results):
    """A14C_CHECKS: a14c_cpu_vs_card."""
    checks = {"cpu_vs_card": a14c_cpu_vs_card(lgt)}
    print("A14C_CHECKS", json.dumps(checks), flush=True)
    results["a14c_checks"] = checks


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=10_500_000,
                    help="rows of the Higgs-shaped main path")
    ap.add_argument("--rounds", type=int, default=5,
                    help="timed boosting rounds after one warm-up round")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import lightgbm_tpu_torch as lgt
        from lightgbm_tpu_torch import _kernels
    except ImportError as err:
        print(f"chip_smoke: the lightgbm_tpu_torch package is not beside "
              f"this script ({err})", file=sys.stderr)
        return 3
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    # every kernel builds at once in the background (K3's 32 instantiations
    # take about a minute of nvcc), while the first phases, which need K1
    # and K2 only and time on the card alone, run
    build = {}

    def run_build():
        t0 = time.perf_counter()
        try:
            build["seconds"] = _kernels.build()
        except Exception as err:      # raised again in the main thread
            build["error"] = err
        build["wall_s"] = time.perf_counter() - t0
    build_thread = threading.Thread(target=run_build)
    build_thread.start()

    def built(names=None):
        """Wait for the named kernels' libraries (default: the whole
        build), raising if the build failed."""
        while build_thread.is_alive() and (names is None or not all(
                _kernels._lib_path(n).is_file() for n in names)):
            time.sleep(0.1)
        if "error" in build:
            build_thread.join()
            raise build["error"]
        if names is None:
            build_thread.join()
            print(f"build: {json.dumps(build['seconds'])} wall_s "
                  f"{build['wall_s']:.2f}", flush=True)

    results = {}
    phases = [("k1", lambda: (built(["histogram"]),
                              phase_kernels_k1(args.rows, results))),
              ("k2", lambda: (built(["fused_split"]),
                              phase_kernels_k2(args.rows, results))),
              ("cpu_vs_card", lambda: phase_cpu_vs_card(lgt, results)),
              ("a14c_checks", lambda: phase_a14c_checks(lgt, results)),
              ("k3", lambda: (built(), phase_kernels_k3(args.rows,
                                                         results))),
              ("main", lambda: phase_main_path(lgt, args.rows, args.rounds,
                                               results)),
              ("predict_api", lambda: phase_predict_api(lgt, results)),
              ("quant", lambda: phase_quant(lgt, results)),
              ("unfused", lambda: phase_unfused(lgt, results)),
              ("pack4", lambda: phase_pack4(lgt, results)),
              ("renew", lambda: phase_renew(lgt, results)),
              ("tuned", lambda: phase_tuned(lgt, results)),
              ("constrained", lambda: phase_constrained(lgt, results)),
              ("dart", lambda: phase_dart(lgt, results)),
              ("rf", lambda: phase_rf(lgt, results)),
              ("wide_bins", lambda: phase_wide_bins(lgt, results)),
              ("rank", lambda: phase_rank(lgt, results)),
              ("masked_large", lambda: phase_masked_large(lgt, args.rows,
                                                          results)),
              ("masked", lambda: phase_masked(lgt, results)),
              ("multiclass_masked", lambda: phase_multiclass_masked(
                  lgt, results)),
              ("multiclass", lambda: phase_multiclass(lgt, args.rows,
                                                      results)),
              ("efb", lambda: phase_efb(lgt, results)),
              ("trace_check", lambda: phase_trace_check(results))]
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        print(f"phase {name} wall_s {time.perf_counter() - t0:.1f}",
              flush=True)
    launches = results["main"]["launches"]
    masked_launches = results["masked"]["launches"]

    h, f = results["histogram"], results["fused_split"]
    h3 = results["histogram_sublane"]
    per_tree = results["main"]["profile"]["kernels"]
    k3_large = results["masked_large"]["profile"]["kernels"][
        "histogram_sublane"]
    k3_small = results["masked"]["profile"]["kernels"]["histogram_sublane"]
    mc = results["multiclass"]
    mc_tree = mc["profile"]["kernels"]
    mc_masked = results["multiclass_masked"]
    efb = results["efb"]
    efb_tree = efb["profile"]["kernels"]
    efb_k = efb["checks"]["kernels"]
    qt = results["quant"]
    qt_tree = qt["profile"]["kernels"]
    qk = qt["checks"]["kernels"]
    rk = results["rank"]
    rk_tree = rk["profile"]["kernels"]
    rkk = rk["checks"]["kernels"]
    rn = results["renew"]
    rn_tree = rn["profile"]["kernels"]
    tn = results["tuned"]
    tn_tree = tn["profile"]["kernels"]
    tnk = tn["checks"]["kernels"]
    cn = results["constrained"]
    cn_tree = cn["profile"]["kernels"]
    dt = results["dart"]
    dt_tree = dt["profile"]["kernels"]
    rf = results["rf"]
    rf_tree = rf["profile"]["kernels"]
    a14c = results["a14c_checks"]["cpu_vs_card"]
    pa = results["predict_api"]
    uf = results["unfused"]
    p4 = results["pack4"]
    wb = results["wide_bins"]

    def unfused_path(run, kern, mode, root_key=None):
        """A kernel mode on an UNFUSED run: its launches there (counted in
        its mode), its times at the run's root against its plain version,
        bound and index_add_, and one tree's device ms and launches beside
        its byte bound."""
        r = uf[run]
        root = r["root"][root_key or kern]
        tree = r["tree_kernels"].get(kern, {})
        return {"launches": r["mode_launches"][mode] if mode
                else r["launches"][kern],
                "max_abs_err": root["max_abs_err"], "ms": root["ms"],
                "plain_ms": root["plain_ms"], "bound_ms": root["bound_ms"],
                "bound_by": "bytes", "library_ms": root["library_ms"],
                "tree_device_ms": tree.get("device_ms"),
                "tree_launches": tree.get("launches"),
                "tree_bound_ms": tree.get("bound_ms"),
                "iterations_per_s": r["iterations_per_s"],
                "launches_a_split": r["launches_a_split"],
                "host_syncs_in_tree_step": r["host_syncs_in_tree_step"]}

    def a14c_path(kern):
        """A kernel on the DART (compact) and RF (masked) paths: its
        launches there and one tree's device ms beside its byte bound; its
        launches in the A14C_CHECKS card runs."""
        out = {}
        for name, run, tree in (("dart", dt, dt_tree), ("rf", rf, rf_tree)):
            out[name] = {"launches": run["launches"][kern],
                         "tree_device_ms": tree[kern]["device_ms"],
                         "tree_bound_ms": tree[kern].get("bound_ms")}
        out["checks_launches"] = {case: v["launches"].get(kern, 0)
                                  for case, v in a14c.items()}
        return out

    def constrained_path(kern):
        """A kernel on the CONSTRAINED path: its launches there and one
        tree's device ms beside its byte bound."""
        return {"launches": cn["launches"][kern],
                "tree_device_ms": cn_tree[kern]["device_ms"],
                "tree_bound_ms": cn_tree[kern].get("bound_ms")}

    def ranking_path(kern):
        """A kernel on the RANK path (F = 137): its launches there, its
        times at the run's root (K1) or root split (K2) against its plain
        version, bound and library call, and one tree's device ms and
        byte bound."""
        key = "k1" if kern == "histogram" else "k2"
        return {"launches": rk["launches"][kern],
                "record_bytes": rkk["record_bytes"],
                "max_abs_err": rkk["max_abs_err"], **rkk[key],
                "bound_by": "bytes",
                "tree_device_ms": rk_tree[kern]["device_ms"],
                "tree_bound_ms": rk_tree[kern]["bound_ms"]}

    def renew_path(kern):
        return {"launches": rn["launches"][kern],
                "tree_device_ms": rn_tree[kern]["device_ms"],
                "tree_bound_ms": rn_tree[kern]["bound_ms"]}

    def tuned_path(kern):
        """A kernel on the TUNED path (bagged records): its launches there,
        its times at the bagged root (K1) or a reused-bag tree's root split
        (K2) against its plain version, bound and library call, and one
        tree's device ms beside its byte bound (raw rows)."""
        key = "k1" if kern == "histogram" else "k2"
        return {"launches": tn["launches"][kern],
                "max_abs_err": tnk["max_abs_err"], **tnk[key],
                "bound_by": "bytes",
                "tree_device_ms": tn_tree[kern]["device_ms"],
                "tree_bound_ms": tn_tree[kern]["bound_ms"]}

    def multiclass_path(kern, tree_kernels, launches, rounds, extra=None):
        """A kernel's numbers on a multiclass path: launches a round (K
        trees) over the run's rounds, and device ms and byte bound of one
        profiled tree where the path has one."""
        entry = {"launches_per_round": launches[kern] / rounds}
        if tree_kernels:
            entry["tree_device_ms"] = tree_kernels[kern]["device_ms"]
            entry["tree_bound_ms"] = tree_kernels[kern]["bound_ms"]
        entry.update(extra or {})
        return entry
    kernels = [
        {"name": "histogram", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/histogram.cu",
         "replaces": "lightgbm_tpu/ops/pallas_histogram.py:67",
         "launches": launches["histogram"], "max_abs_err": h["max_abs_err"],
         "ms": h["kernel_ms"], "plain_ms": h["plain_ms"],
         "bound_ms": h["bound_ms"], "bound_by": "bytes",
         "library_ms": h["library_ms"],
         # what the card shows: a time far above the byte bound that falls
         # with the channel count (one shared-memory atomic a channel) is
         # bound by the atomics
         "limited_by": ("shared-memory atomics"
                        if h["kernel_ms"] > 2 * h["bound_ms"]
                        and h["dense"]["kernel_ms"]
                        > 1.2 * h["dense"]["one_channel_ms"] else "bytes"),
         "one_channel_ms": h["dense"]["one_channel_ms"],
         "dense_ms": h["dense"]["kernel_ms"], "skewed_ms": h["skewed_ms"],
         "tree_device_ms": per_tree["histogram"]["device_ms"],
         "tree_bound_ms": per_tree["histogram"]["bound_ms"],
         "multiclass": multiclass_path("histogram", mc_tree,
                                       mc["launches"],
                                       1 + mc["rounds_timed"]),
         # the EFB path: 640-byte records of 529 bundle columns
         "efb": {"launches": efb["launches"]["histogram"],
                 "ms": efb_k["k1"]["kernel_ms"],
                 "plain_ms": efb_k["k1"]["plain_ms"],
                 "bound_ms": efb_k["k1"]["bound_ms"],
                 "library_ms": efb_k["k1"]["library_ms"],
                 "max_abs_err": efb_k["k1"]["max_abs_err"],
                 "features": efb_k["k1"]["features"],
                 "tree_device_ms": efb_tree["histogram"]["device_ms"],
                 "tree_bound_ms": efb_tree["histogram"]["bound_ms"]},
         # the integer variant (quantized codes, exact int32) on QUANT's
         # records at the root, beside K1 f32 on the same records
         "quant": {"launches": qt["mode_launches"]["histogram/quant"],
                   "ms": qk["k1"]["ms"], "f32_ms": qk["k1"]["f32_ms"],
                   "plain_ms": qk["k1"]["plain_ms"],
                   "bound_ms": qk["k1"]["bound_ms"], "bound_by": "bytes",
                   "library_ms": qk["k1"]["library_ms"],
                   "max_abs_err": qk["k1"]["max_abs_err"],
                   "tree_device_ms": qt_tree["histogram"]["device_ms"],
                   "tree_bound_ms": qt_tree["histogram"]["bound_ms"]},
         "ranking": ranking_path("histogram"),
         "renew": renew_path("histogram"),
         "tuned": tuned_path("histogram"),
         "constrained": constrained_path("histogram"),
         **a14c_path("histogram")},
        {"name": "fused_split", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/fused_split.cu",
         "replaces": "lightgbm_tpu/ops/fused_split.py:198",
         "launches": launches["fused_split"], "max_abs_err": f["max_abs_err"],
         "ms": f["kernel_ms"], "plain_ms": f["plain_ms"],
         "bound_ms": f["bound_ms"], "bound_by": "bytes",
         "library_ms": f["library_ms"], "partition_ms": f["partition_ms"],
         "whole_record_bound_ms": f["whole_record_bound_ms"],
         "tree_device_ms": per_tree["fused_split"]["device_ms"],
         "tree_bound_ms": per_tree["fused_split"]["bound_ms"],
         "multiclass": multiclass_path(
             "fused_split", mc_tree, mc["launches"], 1 + mc["rounds_timed"],
             {"categorical_split_ms": mc["k2_categorical"]["kernel_ms"],
              "categorical_split_bound_ms":
                  mc["k2_categorical"]["bound_ms"],
              "categorical_split_max_abs_err":
                  mc["k2_categorical"]["max_abs_err"],
              "record_real_bytes": mc["record_real_bytes"]}),
         # K2's two variants: dual residency (the paths above) and
         # copy-back (the EFB path, at its root split)
         "modes": {
             "dual": {"launches": launches["fused_split"],
                      "ms": f["kernel_ms"], "bound_ms": f["bound_ms"],
                      "efb_root_split_ms": efb_k["dual_ms"],
                      "efb_root_partition_ms": efb_k["dual_partition_ms"]},
             "copy_back": {
                 "launches": efb["launches"]["fused_split"],
                 "ms": efb_k["copy_back_ms"],
                 "plain_ms": efb_k["copy_back_plain_ms"],
                 "bound_ms": efb_k["bound_ms"], "bound_by": "bytes",
                 "library_ms": efb_k["library_ms"],
                 "partition_ms": efb_k["copy_back_partition_ms"],
                 "child_hist_ms": efb_k["child_hist_ms"],
                 "max_abs_err": max(efb_k["root"]["max_abs_err"],
                                    efb_k["grown"]["max_abs_err"]),
                 "record_bytes": efb_k["record_bytes"],
                 "tree_device_ms": efb_tree["fused_split"]["device_ms"],
                 "tree_bound_ms": efb_tree["fused_split"]["bound_ms"]}},
         # quant mode: the same partition, K1's integer variant; at QUANT's
         # root split beside K2 f32 on the same records
         "quant": {"launches": qt["mode_launches"]["fused_split/quant"],
                   "ms": qk["k2"]["ms"], "f32_ms": qk["k2"]["f32_ms"],
                   "plain_ms": qk["k2"]["plain_ms"],
                   "bound_ms": qk["k2"]["bound_ms"], "bound_by": "bytes",
                   "library_ms": qk["k2"]["library_ms"],
                   "max_abs_err": max(qk["max_abs_err"],
                                      efb_k["quant_copy_back"]["max_abs_err"]),
                   "tree_device_ms": qt_tree["fused_split"]["device_ms"],
                   "tree_bound_ms": qt_tree["fused_split"]["bound_ms"],
                   "efb_copy_back": efb_k["quant_copy_back"]},
         "ranking": ranking_path("fused_split"),
         "renew": renew_path("fused_split"),
         "tuned": tuned_path("fused_split"),
         "constrained": constrained_path("fused_split"),
         **a14c_path("fused_split")},
        {"name": "histogram_sublane", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/histogram_sublane.cu",
         "replaces": "lightgbm_tpu/ops/pallas_histogram.py:170",
         "launches": masked_launches["histogram_sublane"],
         "max_abs_err": h3["max_abs_err"], "ms": h3["kernel_ms"],
         "plain_ms": h3["plain_ms"], "bound_ms": h3["bound_ms"],
         "bound_by": "bytes", "library_ms": h3["library_ms"],
         "path_ms": h3["path"]["kernel_ms"],
         "path_device_us": h3["path"]["device_us"],
         "path_bound_ms": h3["path"]["bound_ms"],
         "k1_dense_ms": h3["k1_dense_ms"],
         "one_in_eight_rows_ms": h3["one_in_eight_rows_ms"],
         "skewed_ms": h3["skewed_ms"], "sparse_ms": h3["sparse_ms"],
         "tree_device_ms": k3_small["device_ms"],
         "tree_bound_ms": k3_small["bound_ms"],
         "large_tree_device_ms": k3_large["device_ms"],
         "large_tree_bound_ms": k3_large["bound_ms"],
         "large_tree_launches": k3_large["launches"],
         "multiclass_masked": multiclass_path(
             "histogram_sublane", None, mc_masked["launches"],
             mc_masked["rounds"]),
         "tuned_launches": tn["launches"]["histogram_sublane"],
         "constrained_checks_launches": cn["checks"]["cpu_vs_card"][
             "cegb_lazy_sublane_masked"]["launches"]["histogram_sublane"],
         "dart_launches": dt["launches"]["histogram_sublane"],
         "rf_launches": rf["launches"]["histogram_sublane"]},
        # the intermediate monotone method's walk: no Pallas kernel, the
        # JAX package's XLA while-loops (grower_compact.py:859-991)
        {"name": "monotone_walk", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/monotone_walk.cu",
         "replaces": "lightgbm_tpu/ops/grower_compact.py:859",
         "launches": cn["launches"]["monotone_walk"],
         "max_abs_err": cn["walk_kernel"]["max_abs_err"],
         "ms": cn["walk_kernel"]["ms"],
         "plain_ms": cn["walk_kernel"]["plain_ms"],
         "bound_ms": cn["walk_kernel"]["bound_ms"], "bound_by": "bytes",
         "library_ms": None,
         "states_checked": cn["walk_kernel"]["states"],
         "launches_a_tree": cn["walk_launches_a_tree"],
         "tree_device_ms": cn["walk_device_ms_a_tree"],
         "rescan_device_ms_a_tree": cn["rescan_device_ms_a_tree"]},
        # pred_contrib's exact TreeSHAP: no Pallas kernel, the JAX
        # package's XLA program (and its host recursion, ops/treeshap.py)
        {"name": "treeshap", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/treeshap.cu",
         "replaces": "lightgbm_tpu/ops/treeshap_device.py:248",
         "launches": pa["launches"], "max_abs_err": pa["max_abs_err"],
         "ms": pa["kernel_ms"], "plain_ms": pa["plain_ms"],
         "bound_ms": pa["bound_ms"], "bound_by": pa["bound_by"],
         "library_ms": None, "rows": pa["rows"],
         "max_rel_err": pa["max_rel_err"],
         "full_max_abs_err": pa["full_max_abs_err"],
         "profiled_device_ms": pa["profiled_device_ms"],
         "kernel_4096_ms": pa["kernel_4096_ms"],
         "plain_4096_ms": pa["plain_4096_ms"],
         "deepest_path": pa["deepest_path"],
         "longest_ulen": pa["longest_ulen"]},
        # the last modes of the three Pallas kernels, on the compact grower
        # without the fused kernel (UNFUSED) and on 4-bit packed records
        # (PACK4)
        {"name": "histogram_int8", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/histogram.cu",
         "replaces": "lightgbm_tpu/ops/pallas_histogram.py:67",
         **unfused_path("quant", "histogram", "histogram/int8")},
        {"name": "histogram_sublane_int8", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/histogram_sublane.cu",
         "replaces": "lightgbm_tpu/ops/pallas_histogram.py:170",
         **unfused_path("sublane_quant", "histogram_sublane",
                        "histogram_sublane/int8"),
         # the feature-major copy of a segment that K3 reads
         "transposed_copy_ms": uf["sublane_quant"]["root"][
             "segment_gather"]["ms"]},
        # the JAX package's 16-bit quantized engine: XLA there, no Pallas
        {"name": "histogram_narrow", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/histogram.cu",
         "replaces": "lightgbm_tpu/ops/histogram.py:129",
         **unfused_path("narrow", "histogram", "histogram/narrow",
                        "histogram_narrow"),
         "narrowed_leaves": uf["narrow"]["narrowed_leaves"],
         "narrowed_leaves_100k_rows": uf["cpu_vs_card"]["narrow"][
             "narrowed_leaves"],
         "int32_ms": uf["narrow"]["root"]["histogram_narrow"]["int32_ms"],
         "leaf_6000_ms": uf["narrow"]["root"]["histogram_narrow"][
             "leaf_6000_ms"],
         "leaf_6000_int32_ms": uf["narrow"]["root"]["histogram_narrow"][
             "leaf_6000_int32_ms"]},
        {"name": "fused_split_packed4", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/fused_split.cu",
         "replaces": "lightgbm_tpu/ops/fused_split.py:198",
         "launches": sum(p4[v]["mode_launches"]["fused_split/packed4"]
                         for v in ("f32", "quant")),
         "max_abs_err": max(p4[v]["root_split"]["max_abs_err"]
                            for v in ("f32", "quant")),
         "ms": p4["f32"]["root_split"]["packed4"]["ms"],
         "plain_ms": p4["f32"]["root_split"]["packed4"]["plain_ms"],
         "bound_ms": p4["f32"]["root_split"]["packed4"]["bound_ms"],
         "bound_by": "bytes",
         "library_ms": p4["f32"]["root_split"]["packed4"]["library_ms"],
         "u8": p4["f32"]["root_split"]["u8"],
         "quant": p4["quant"]["root_split"],
         "moved_bytes_a_row": p4["f32"]["moved_bytes_a_row"],
         "u8_moved_bytes_a_row": p4["f32"]["u8_moved_bytes_a_row"],
         "tree_device_ms": p4["f32"]["tree_kernels"]["fused_split"][
             "device_ms"],
         "tree_bound_ms": p4["f32"]["tree_kernels"]["fused_split"][
             "bound_ms"],
         "histogram_tree_device_ms": p4["f32"]["tree_kernels"]["histogram"][
             "device_ms"]},
        # max_bin > 255: K1's wide-bin kernel on 16-bit bins (the masked
        # grower's histogram, WIDE_BINS), at the run's root
        {"name": "histogram_u16", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/histogram.cu",
         "replaces": "lightgbm_tpu/ops/pallas_histogram.py:67",
         "launches": wb["mode_launches"]["histogram/u16"],
         "max_abs_err": wb["root"]["max_abs_err"], "ms": wb["root"]["ms"],
         "plain_ms": wb["root"]["plain_ms"],
         "bound_ms": wb["root"]["bound_ms"], "bound_by": "bytes",
         "library_ms": wb["root"]["library_ms"],
         "bins": wb["bins"],
         "tree_device_ms": wb["k1_tree_device_ms"],
         "tree_launches": wb["k1_tree_launches"],
         "tree_bound_ms": wb["k1_tree_bound_ms"],
         "iterations_per_s": wb["iterations_per_s"],
         "main_iterations_per_s": wb["main_iterations_per_s"],
         "synthetic": wb["synthetic"]},
        # pred_contrib on 16-bit rows (WIDE_BINS): the TreeSHAP kernel's
        # uint16 instantiation
        {"name": "treeshap_u16", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/treeshap.cu",
         "replaces": "lightgbm_tpu/ops/treeshap_device.py:248",
         **{key: wb["treeshap"][key] for key in (
             "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
             "bound_by", "rows", "max_rel_err")},
         "library_ms": None},
        # the unfused path's channels of a segment: no Pallas kernel, the
        # JAX package's XLA channel stack (ops/compact.py:386-399)
        {"name": "segment_gather", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/segment_gather.cu",
         "replaces": "lightgbm_tpu/ops/compact.py:386",
         **unfused_path("f32", "segment_gather", None),
         "by_run": {run: {"launches": uf[run]["launches"][
             "segment_gather"],
                          **uf[run]["root"]["segment_gather"]}
                    for run in UNFUSED_RUNS}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
