#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lightgbm_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA Hopper card:

    python3 chip_smoke.py [--rows N] [--rounds R]

Phases, each of which raises on a failed check (the script then exits
non-zero):

1. the card's name and power limit, and the build of every kernel from the
   sources in lightgbm_tpu_torch/csrc (one nvcc per source, in parallel);
2. K1, the histogram kernel, against its plain PyTorch version at the Higgs
   root shape (dense channels and packed row records) and at F=100 (feature
   chunking), with its time, the plain version's and index_add_'s;
3. K2, the fused split, against its plain version on a 1M-row record array
   (modes 0 and 1, aligned and unaligned starts, counts 0/1/255/to the end,
   both residency sides, NaN default-left, forced smaller child, a
   categorical bitset), then the Higgs root split (mode 0 over the whole
   array at the main path's row count) against its plain version, and its
   time beside that of the smaller child's histogram alone;
4. the main path: lightgbm_tpu_torch.train on Higgs-shaped data
   (make_higgs_like, 10.5M x 28 with a 10% validation split, 255 leaves,
   255 bins) for one warm-up round and R timed rounds, with the kernels'
   launch counts (> 0), the plain versions' call counts (0), the host
   syncs inside one tree (0), and a torch.profiler trace of one more tree
   (device time, idle share, launches);
5. the card against the CPU: the same training at 100k x 28, 31 leaves,
   3 rounds, with device_type="cuda" and "cpu"; predictions agree within
   1e-4.

The line before the last is a JSON object with every kernel's launches,
error, times and bound; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the package beside it, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
RECORD_ROW_BYTES = 64          # bins + channels: two 32-byte sectors a row


def make_higgs_like(n, f, seed=7):
    """Dense float features + nonlinear binary target (Higgs-shaped)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    w1 = rng.randn(f) / np.sqrt(f)
    w2 = rng.randn(f) / np.sqrt(f)
    logits = X @ w1 + 0.7 * np.abs(X @ w2) - 0.4 + 0.5 * rng.randn(n)
    y = (logits > 0).astype(np.float64)
    return X, y


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
        if dyadic:
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

    def record_case(rows, F, dyadic, timed=False):
        """Record mode: the rows the fused split streams, read in place."""
        layout = RowLayout(num_features=F, num_extra=4)
        bins = torch.randint(0, B, (rows, F), generator=g, device=dev,
                             dtype=torch.uint8)
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
        err = hist_close(kern, plain, absh, f"K1 records F={F}",
                         0 if dyadic else 1e-5)
        worst[0] = max(worst[0], err)
        line = {"rows": rows, "F": F, "mode": "records", "dyadic": dyadic,
                "max_abs_err": err}
        if timed:
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
    results["histogram"] = dict(rec, max_abs_err=worst[0], dense=dense)


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
        check(torch.equal(wk, wp) and torch.equal(sk, spl),
              f"K2 {c}: record arrays differ from the plain version")
        # the same split of the same rows with |grad| gives sum|addends|
        absw, abss = w0.clone(), s0.clone()
        for arr in (absw, abss):
            gcol = arr[:, layout.grad_off:layout.grad_off + 4].contiguous()
            arr[:, layout.grad_off:layout.grad_off + 4] = gcol.view(
                torch.float32).abs().view(torch.uint8)
        _, _, habs = fused_split_plain(absw, abss, *args, **kw)
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
    check(torch.equal(wk, wp) and torch.equal(sk, spl),
          f"K2 root split of {n_big} rows: record arrays differ from the "
          "plain version")
    worst = max(worst, hist_close(hk, hp, hp, f"K2 root split {n_big}", 0))
    print("K2 ok root split", n_big, "rows, n_left", n_left, flush=True)
    del wk, sk, wp, spl, hk, hp

    # timing at the same split. After a split both arrays hold the
    # partitioned segment, so splitting it again from the other side moves
    # the same rows: the calls alternate sides
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
        "bound_ms": 1e3 * (2 * n_big * layout.num_cols
                           + n_small * RECORD_ROW_BYTES) / HBM_BYTES_PER_S}
    print("K2", json.dumps(results["fused_split"]), flush=True)
    del work, scratch


def phase_main_path(lgt, rows, rounds, results):
    from lightgbm_tpu_torch import _kernels
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    t0 = time.perf_counter()
    X, y = make_higgs_like(rows, 28)
    n_val = rows // 10
    Xt, yt, Xv, yv = X[:-n_val], y[:-n_val], X[-n_val:], y[-n_val:]
    gen_s = time.perf_counter() - t0
    params = {"objective": "binary", "metric": "auc", "num_leaves": 255,
              "max_bin": 255, "learning_rate": 0.1, "min_data_in_leaf": 100,
              "verbosity": -1, "device_type": "cuda"}

    # host syncs inside one tree (the second), counted by torch's sync
    # debug mode around the grower call
    grow = gbdt_mod.grow_tree_compact
    syncs = {}

    def counted_grow(*a, **kw):
        if len(syncs) or counted_grow.calls != 1:
            counted_grow.calls += 1
            return grow(*a, **kw)
        counted_grow.calls += 1
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = grow(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs["in_tree"] = sum("called a synchronizing" in str(w.message)
                               for w in caught)
        return out
    counted_grow.calls = 0
    gbdt_mod.grow_tree_compact = counted_grow

    ends = []

    def timer(env):
        torch.cuda.synchronize()
        ends.append(time.perf_counter())
    timer.order = 5

    _kernels.reset_counts()
    try:
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
    finally:
        gbdt_mod.grow_tree_compact = grow
    launches = dict(_kernels.LAUNCHES)
    plain_calls = dict(_kernels.PLAIN_CALLS)
    check(len(ends) == 1 + rounds, f"trained {len(ends)} rounds")
    it_s = rounds / (ends[-1] - ends[0])
    auc = evals["valid_0"]["auc"][-1]
    out = {"rows": rows, "train_rows": rows - n_val, "valid_rows": n_val,
           "rounds_timed": rounds, "iterations_per_s": it_s,
           "first_round_s": ends[0] - t_start, "construct_s": construct_s,
           "data_gen_s": gen_s, "valid_auc": auc, "launches": launches,
           "plain_calls": plain_calls, "host_syncs_in_tree":
           syncs.get("in_tree"), "num_trees": bst.num_trees()}
    if rows < 10_500_000:
        out["note"] = "rows lowered by --rows"
    print("MAIN", json.dumps(out), flush=True)
    for k, v in launches.items():
        check(v > 0, f"kernel {k} was not launched on the main path")
    for k, v in plain_calls.items():
        check(v == 0, f"plain version of {k} ran {v} times on the card")
    check(np.isfinite(auc) and auc > 0.7, f"validation AUC {auc}")
    check(syncs.get("in_tree") == 0, "host syncs inside the split loop")
    out["profile"] = profile_tree(bst, 1.0 / it_s)
    results["main"] = out


def profile_tree(bst, tree_s):
    """One more boosting round under torch.profiler: device time by kernel
    and the launches of a tree. The idle share compares the device time
    with the unprofiled rounds' mean wall time per tree (the profiler slows
    the host)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    by_name = {}
    launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        elif e.name == "cudaLaunchKernel":
            launches += 1
    device_s = sum(us for us, _ in by_name.values()) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    line = {"profiled_wall_s": wall, "device_s": device_s,
            "unprofiled_tree_s": tree_s,
            "device_idle_share": 1.0 - device_s / tree_s,
            "kernel_launches": launches,
            "top_device_ops": [{"name": k[:60], "ms": us * 1e-3, "calls": n}
                               for k, (us, n) in top]}
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
    pc = boosters["cpu"].predict(X)
    diff = float(np.abs(pg - pc).max())
    differ = 0
    for a, b in zip(boosters["cuda"]._gbdt.models,
                    boosters["cpu"]._gbdt.models):
        differ += int(((a.split_feature != b.split_feature)
                       | (a.split_bin != b.split_bin)
                       | (a.default_left != b.default_left)).sum())
    out = {"rows": 100_000, "max_abs_pred_diff": diff,
           "differing_splits": differ}
    print("CPU_VS_CARD", json.dumps(out), flush=True)
    check(np.all(np.isfinite(pg)) and pg.shape == (100_000,),
          "card predictions")
    check(diff <= 1e-4, f"card vs CPU predictions differ by {diff}")
    results["cpu_vs_card"] = out


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
    t0 = time.perf_counter()
    built = _kernels.build()
    print(f"build: {json.dumps(built)} wall_s {time.perf_counter() - t0:.2f}",
          flush=True)

    results = {}
    phases = [("k1", lambda: phase_kernels_k1(args.rows, results)),
              ("k2", lambda: phase_kernels_k2(args.rows, results)),
              ("main", lambda: phase_main_path(lgt, args.rows, args.rounds,
                                               results)),
              ("cpu_vs_card", lambda: phase_cpu_vs_card(lgt, results))]
    for name, run in phases:
        t0 = time.perf_counter()
        run()
        print(f"phase {name} wall_s {time.perf_counter() - t0:.1f}",
              flush=True)
    launches = results["main"]["launches"]

    h, f = results["histogram"], results["fused_split"]
    kernels = [
        {"name": "histogram", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/histogram.cu",
         "replaces": "lightgbm_tpu/ops/pallas_histogram.py:67",
         "launches": launches["histogram"], "max_abs_err": h["max_abs_err"],
         "ms": h["kernel_ms"], "plain_ms": h["plain_ms"],
         "bound_ms": h["bound_ms"], "bound_by": "bytes",
         "library_ms": h["library_ms"],
         # what the card shows: a time that falls with the channel count
         # (one shared-memory atomic a channel) is bound by the atomics
         "limited_by": ("shared-memory atomics"
                        if h["dense"]["kernel_ms"]
                        > 2 * h["dense"]["one_channel_ms"] else "bytes")},
        {"name": "fused_split", "route": "cuda",
         "source": "lightgbm_tpu_torch/csrc/fused_split.cu",
         "replaces": "lightgbm_tpu/ops/fused_split.py:198",
         "launches": launches["fused_split"], "max_abs_err": f["max_abs_err"],
         "ms": f["kernel_ms"], "plain_ms": f["plain_ms"],
         "bound_ms": f["bound_ms"], "bound_by": "bytes",
         "library_ms": f["library_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
