"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a CUDA device every test skips. On a machine with
one (which need not have JAX), run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Kernel and plain version get the same inputs on the card. The record arrays
must be byte-equal; histogram counts are exact and grad/hess agree within
1e-5 * sum |addends| per cell (f32 atomics add in another order), and bit
for bit on dyadic channels (multiples of 1/64, every partial sum exact).
"""
import sys
import threading

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.ops.compact import RowLayout, pack_rows
from lightgbm_tpu_torch.ops.fused_split import fused_split, fused_split_plain
from lightgbm_tpu_torch.ops.pallas_histogram import (
    SUBLANE_SMALL_ROWS, _launch_sublane, pallas_histogram,
    pallas_histogram_plain, pallas_histogram_sublane,
    pallas_histogram_sublane_plain, record_histogram, record_histogram_plain,
    sublane_small_geometry, sublane_tile_geometry)
from lightgbm_tpu_torch.ops.split import go_left_pred
from lightgbm_tpu_torch.ops.treeshap_device import (build_shap_paths,
                                                    tree_shap,
                                                    tree_shap_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _close(kern, plain, scale):
    assert torch.equal(kern[..., 2:], plain[..., 2:])
    err = (kern[..., :2] - plain[..., :2]).abs()
    assert bool((err <= 1e-5 * scale[..., :2] + 1e-30).all())


def _records(n, f, b, dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    layout = RowLayout(num_features=f, num_extra=2)
    work = pack_rows(
        torch.randint(0, b, (n, f), generator=g, device=dev,
                      dtype=torch.uint8),
        torch.randn(n, generator=g, device=dev),
        torch.rand(n, generator=g, device=dev),
        (torch.rand(n, generator=g, device=dev) > 0.2).float(),
        torch.randn(2, n, generator=g, device=dev), layout)
    return layout, work


def _abs_grad(work, layout):
    out = work.clone()
    o = layout.grad_off
    out[:, o:o + 4] = out[:, o:o + 4].contiguous().view(
        torch.float32).abs().view(torch.uint8)
    return out


@pytest.mark.parametrize("f,b,mode", [(5, 64, "split"), (28, 256, "bf16"),
                                      (60, 256, "f32")])
def test_dense_histogram(dev, f, b, mode):
    n = 20_000
    bins = torch.randint(0, b, (n, f), device=dev, dtype=torch.uint8)
    ch = torch.randn(n, 4, device=dev)
    ch[:, 2] = (ch[:, 2] > 0).float()
    ch[:, 3] = 1.0
    _kernels.reset_counts()
    kern = pallas_histogram(bins, ch, b, mode=mode)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["histogram"] == 1
    _close(kern, pallas_histogram_plain(bins, ch, b, mode=mode),
           pallas_histogram_plain(bins, ch.abs(), b, mode=mode))


@pytest.mark.parametrize("f", [5, 28, 29])
def test_record_histogram(dev, f):
    layout, work = _records(30_000, f, 256, dev, seed=f)
    scratch = torch.zeros_like(work)
    seg = torch.tensor([123, 25_000, 0], dtype=torch.int32, device=dev)
    kern = record_histogram(work, scratch, seg, layout, 256)
    _close(kern, record_histogram_plain(work, scratch, seg, layout, 256),
           record_histogram_plain(_abs_grad(work, layout), scratch, seg,
                                  layout, 256))


@pytest.mark.parametrize("skew", ["bin0_90", "one_bin"])
def test_record_histogram_skewed_bins_is_exact(dev, skew):
    """Skewed features: 90% of the rows in bin 0, or every row of a feature
    in one bin. 9M rows put more than 65,535 rows of one bin into every
    block, so the packed 16-bit counts must flush on the way; with integer
    channels every partial sum is exact and kernel and plain version agree
    bit for bit."""
    g = torch.Generator(device=dev)
    g.manual_seed(5)
    n, f, b = 9_000_000, 3, 8
    layout = RowLayout(num_features=f, num_extra=0)
    bins = torch.randint(0, b, (n, f), generator=g, device=dev,
                         dtype=torch.uint8)
    if skew == "bin0_90":
        bins[torch.rand(n, f, generator=g, device=dev) < 0.9] = 0
    else:
        bins[:] = torch.tensor([1, 7, 0], dtype=torch.uint8, device=dev)
    work = pack_rows(
        bins, torch.randint(-1, 2, (n,), generator=g, device=dev).float(),
        torch.randint(0, 2, (n,), generator=g, device=dev).float(),
        (torch.rand(n, generator=g, device=dev) > 0.2).float(),
        torch.zeros(0, n, device=dev), layout)
    del bins
    seg = torch.tensor([0, n, 0], dtype=torch.int32, device=dev)
    kern = record_histogram(work, work, seg, layout, b)
    assert torch.equal(kern, record_histogram_plain(work, work, seg, layout,
                                                    b))
    assert float(kern[0, :, 3].sum()) == n


@pytest.mark.parametrize("seg,clamped", [
    ((29_900, 5_000, 0), (29_900, 100)), ((-40, 300, 1), (0, 300)),
    ((40_000, 10, 0), (30_000, 0)), ((7, -1, 1), (7, 0))])
def test_record_histogram_clamps_the_segment(dev, seg, clamped):
    """A segment outside the arrays: the kernel reads only the rows inside
    them (no fault), as its plain version does."""
    layout, work = _records(30_000, 5, 256, dev, seed=9)
    scratch = work.flip(0).contiguous()
    kern = record_histogram(work, scratch, torch.tensor(
        seg, dtype=torch.int32, device=dev), layout, 256)
    ref_seg = torch.tensor([clamped[0], clamped[1], seg[2]],
                           dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    _close(kern, record_histogram_plain(work, scratch, ref_seg, layout, 256),
           record_histogram_plain(_abs_grad(work, layout),
                                  _abs_grad(scratch, layout), ref_seg,
                                  layout, 256))
    assert float(kern[..., 3].sum()) == clamped[1] * 5


@pytest.mark.parametrize("mode,start,count,side,smaller,f,skew_left", [
    (0, 0, 30_000, 0, None, 5, 0), (0, 37, 22_190, 1, None, 5, 0),
    (0, 96, 128, 0, 1, 5, 0), (0, 500, 1, 1, None, 5, 0),
    (0, 200, 0, 0, None, 5, 0), (0, 11, 20_000, 0, 0, 5, 0),
    (1, 41, 23_000, 1, None, 5, 0), (0, 1001, 255, 1, None, 29, 0),
    (0, 3, 1, 0, None, 29, 0), (0, 7, 0, 1, None, 29, 0),
    (0, 13, 29_000, 1, None, 29, 0), (0, 13, 29_000, 0, None, 28, 7),
    (0, 5, 27_000, 1, 1, 28, -7)])
def test_fused_split(dev, mode, start, count, side, smaller, f, skew_left):
    """Counts 0, 1, 128, 255 and most of the array, unaligned starts, both
    residency sides, F = 29 (unaligned floats), a forced smaller child, and
    an n_left off the routing's count by +-7 (the segment may scramble, but
    no write leaves it; kernel and plain version write the same bytes)."""
    layout, parent = _records(30_000, f, 256, dev, seed=start)
    _, other = _records(30_000, f, 256, dev, seed=start + 1)
    feat, bin_ = 2, 100
    col = parent[start:start + count, feat].to(torch.int64)
    n_left = min(max(int((col <= bin_).sum()) + skew_left, 0), count)
    args = (mode, start, count, n_left, feat, bin_, 0, 0, 0, None, layout,
            256)
    kw = {"smaller_left": smaller, "side": side}
    arrays = (other, parent) if side else (parent, other)
    wk, sk, hk = fused_split(*(a.clone() for a in arrays), *args, **kw)
    wp, sp, hp = fused_split_plain(*(a.clone() for a in arrays), *args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(wk, wp) and torch.equal(sk, sp)
    _, _, habs = fused_split_plain(
        *(_abs_grad(a, layout) for a in arrays), *args, **kw)
    _close(hk, hp, habs)


def test_fused_split_categorical_and_nan(dev):
    """A categorical bitset and a NaN bin sent left, then the two splits in a
    row on one pair of arrays (the look-back state of the first must not
    leak into the second)."""
    layout, parent = _records(30_000, 28, 256, dev, seed=21)
    other = torch.zeros_like(parent)
    bits = torch.zeros(8, dtype=torch.int32, device=dev)
    for cat in (3, 17, 100, 255):
        bits[cat // 32] |= 1 << (cat % 32)
    arrays_k = (parent.clone(), other.clone())
    arrays_p = (parent.clone(), other.clone())
    start, count = 17, 29_000
    for feat, bin_, dl, nan_bin, is_cat in ((4, 0, 0, 0, 1),
                                           (6, 60, 1, 255, 0)):
        col = arrays_p[0][start:start + count, feat]
        n_left = int(go_left_pred(col, bin_, bool(dl), nan_bin, bool(is_cat),
                                  bits).sum())
        args = (0, start, count, n_left, feat, bin_, dl, nan_bin, is_cat,
                bits, layout, 256)
        _, _, hk = fused_split(*arrays_k, *args, side=0)
        _, _, hp = fused_split_plain(*arrays_p, *args, side=0)
        torch.cuda.synchronize()
        assert torch.equal(arrays_k[0], arrays_p[0])
        assert torch.equal(arrays_k[1], arrays_p[1])
        assert torch.equal(hk[..., 2:], hp[..., 2:])
        # the left child stays in place: split it again from the same side
        count = n_left


@pytest.mark.parametrize("start,count,smaller,f,skew_left", [
    (0, 30_000, None, 5, 0), (37, 22_190, None, 5, 0), (96, 128, 1, 5, 0),
    (500, 1, None, 5, 0), (200, 0, None, 5, 0), (11, 20_000, 0, 5, 0),
    (1001, 255, None, 29, 0), (13, 29_000, None, 28, 7),
    (5, 27_000, 1, 28, -7), (17, 28_000, None, 529, 0)])
def test_fused_split_copy_back(dev, start, count, smaller, f, skew_left):
    """K2's copy-back variant (dual=False, the EFB path) against its plain
    version: both arrays byte-equal (the rights copied back into work over
    exactly their range, every other row untouched), the histogram's counts
    exact; the side argument is ignored (every segment lives in work).
    F = 529: a 560-byte moved record (the Allstate shape's bundle
    columns)."""
    layout, work = _records(30_000, f, 256, dev, seed=start + f)
    _, scratch = _records(30_000, f, 256, dev, seed=start + 1)
    feat, bin_ = 2, 100
    col = work[start:start + count, feat].to(torch.int64)
    n_left = min(max(int((col <= bin_).sum()) + skew_left, 0), count)
    args = (0, start, count, n_left, feat, bin_, 0, 0, 0, None, layout, 256)
    kw = {"smaller_left": smaller, "side": 1, "dual": False}
    wk, sk, hk = fused_split(work.clone(), scratch.clone(), *args, **kw)
    wp, sp, hp = fused_split_plain(work.clone(), scratch.clone(), *args,
                                   **kw)
    torch.cuda.synchronize()
    assert torch.equal(wk, wp) and torch.equal(sk, sp)
    outside = torch.ones(30_000, dtype=torch.bool, device=dev)
    outside[start:start + count] = False
    assert torch.equal(wk[outside], work[outside])
    _, _, habs = fused_split_plain(_abs_grad(work, layout),
                                   _abs_grad(scratch, layout), *args, **kw)
    _close(hk, hp, habs)


def test_wide_records_dual_and_copy_back_agree(dev):
    """At a record wider than 128 bytes (529 bundle columns and 3 carried
    columns, as on the Allstate shape) K1 matches its plain version, and
    K2's two variants leave the same rows in work once dual residency is
    merged, with equal histograms."""
    layout, work = _records(40_000, 529, 18, dev, seed=5)
    assert layout.num_cols == 640 and layout.moved_cols == 560
    scratch = torch.zeros_like(work)
    seg = torch.tensor([7, 39_000, 0], dtype=torch.int32, device=dev)
    kern = record_histogram(work, scratch, seg, layout, 256)
    _close(kern, record_histogram_plain(work, scratch, seg, layout, 256),
           record_histogram_plain(_abs_grad(work, layout), scratch, seg,
                                  layout, 256))
    start, count, feat = 7, 39_000, 300
    n_left = int((work[start:start + count, feat] <= 8).sum())
    args = (0, start, count, n_left, feat, 8, 0, 0, 0, None, layout, 256)
    dw, ds_, dh = fused_split(work.clone(), scratch.clone(), *args, side=0)
    cw, _, ch = fused_split(work.clone(), scratch.clone(), *args,
                            dual=False)
    torch.cuda.synchronize()
    merged = dw.clone()
    merged[start + n_left:start + count] = ds_[start + n_left:start + count]
    assert torch.equal(cw, merged)
    assert torch.equal(ch[..., 2:], dh[..., 2:])
    _close(ch, dh, record_histogram_plain(
        _abs_grad(merged, layout), scratch, torch.tensor(
            [start, n_left, 0] if n_left <= count - n_left
            else [start + n_left, count - n_left, 0]), layout, 256))


@pytest.mark.parametrize("streams", [False, True])
def test_fused_split_from_threads(dev, streams):
    """Splits issued from four threads at once, on one stream or on one
    stream a thread: the look-back state (kept across splits) must never
    mix two splits."""
    layout, parent = _records(30_000, 28, 256, dev, seed=31)
    col = parent[:, 3].to(torch.int64)
    jobs = []
    for i in range(4):
        start, count = 100 * i, 29_000 - 500 * i
        n_left = int((col[start:start + count] <= 90 + i).sum())
        args = (0, start, count, n_left, 3, 90 + i, 0, 0, 0, None, layout,
                256)
        want = fused_split_plain(parent.clone(), torch.zeros_like(parent),
                                 *args)
        jobs.append((args, want))
    torch.cuda.synchronize()
    errors = []

    def worker(i):
        try:
            args, (ww, ws, wh) = jobs[i]
            ctx = (torch.cuda.stream(torch.cuda.Stream(dev)) if streams
                   else torch.cuda.stream(torch.cuda.current_stream(dev)))
            with ctx:
                for _ in range(20):
                    w, s, h = fused_split(parent.clone(),
                                          torch.zeros_like(parent), *args)
                    torch.cuda.current_stream(dev).synchronize()
                    if not (torch.equal(w, ww) and torch.equal(s, ws)
                            and torch.equal(h[..., 2:], wh[..., 2:])):
                        errors.append(i)
        except Exception as err:  # reported by the assertion below
            errors.append(repr(err))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def test_train_on_card_matches_cpu(dev):
    rng = np.random.RandomState(0)
    X = rng.randn(20_000, 6).astype(np.float32)
    X[rng.rand(*X.shape) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) - 0.5 * np.nan_to_num(X[:, 3])
         + 0.3 * rng.randn(20_000) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
         "tpu_grower": "compact"}
    _kernels.reset_counts()
    bg = lgt.train(dict(p, device_type="cuda"), lgt.Dataset(X, y), 3)
    launches = dict(_kernels.LAUNCHES)
    plain = dict(_kernels.PLAIN_CALLS)
    bc = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y), 3)
    assert launches["fused_split"] == 3 * 31
    assert launches["histogram"] == 3 * 31
    assert sum(plain.values()) == 0
    np.testing.assert_allclose(bg.predict(X), bc.predict(X), atol=1e-4)


def test_efb_train_on_card_matches_cpu(dev):
    """One-hot blocks bundle with default parameters; the card (K1 on the
    bundled records, K2 copy-back) predicts what the CPU predicts."""
    rng = np.random.RandomState(3)
    n, groups = 20_000, 40
    cats = rng.randint(0, 8, (n, groups))
    X = np.zeros((n, groups * 8), np.float32)
    for g in range(groups):
        X[np.arange(n), g * 8 + cats[:, g]] = 1.0
    X = np.concatenate([X, rng.randn(n, 4).astype(np.float32)], axis=1)
    y = (X @ (rng.randn(X.shape[1]) * 0.5) + 0.4 * rng.randn(n) > 0
         ).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
    _kernels.reset_counts()
    bg = lgt.train(dict(p, device_type="cuda"), lgt.Dataset(X, y), 3)
    launches = dict(_kernels.LAUNCHES)
    plain = dict(_kernels.PLAIN_CALLS)
    bc = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y), 3)
    assert bg._gbdt._efb is not None and not bg._gbdt.grower_params.fused_dual
    assert launches["fused_split"] == 3 * 31
    assert launches["histogram"] == 3 * 31
    assert sum(plain.values()) == 0
    np.testing.assert_allclose(bg.predict(X), bc.predict(X), atol=1e-4)


@pytest.mark.parametrize("n,f,b,k,mode,pad", [
    (20_000, 28, 64, 3, "f32", 0), (5_000, 5, 17, 1, "f32", 0),
    (4_999, 1, 2, 4, "split", 8), (20_000, 28, 63, 4, "bf16", 0),
    (777, 100, 64, 8, "f32", 5), (33, 28, 64, 3, "f32", 0),
    (20_000, 31, 64, 3, "f32", 0), (20_000, 32, 64, 3, "f32", 0),
    (20_001, 33, 64, 3, "f32", 0), (20_000, 65, 64, 5, "f32", 16)])
def test_sublane_histogram(dev, n, f, b, k, mode, pad):
    """K3 at the masked path's shape and at edges: N not a multiple of 16
    (byte loads), a bins view with a padded row stride, channels one row
    into their allocation (unaligned unless 4 divides K), B = 2 and 17, one
    feature, F = 31, 32, 33, 65 and 100 (around the 32 histogram columns
    and the feature chunks), 1-8 channels, bf16 rounding; bins up to B + 2
    (the ones >= B dropped); a third of the rows with zero channels
    (skipped)."""
    g = torch.Generator(device=dev)
    g.manual_seed(n + f)
    bins = torch.randint(0, b + 2, (f, n + pad), generator=g, device=dev,
                         dtype=torch.uint8)[:, :n]
    ch = torch.randn(n + 1, k, generator=g, device=dev)[1:]
    ch[::3] = 0.0
    _kernels.reset_counts()
    kern = pallas_histogram_sublane(bins, ch, b, mode)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["histogram_sublane"] == 1
    plain = pallas_histogram_sublane_plain(bins, ch, b, mode)
    scale = pallas_histogram_sublane_plain(bins, ch.abs(), b, mode)
    # these sizes take the small-data path; the tile path as well
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tile = _launch_sublane(bins, ch, b, mode, sublane_tile_geometry(
        n, f, b, k, sms))
    for got in (kern, tile):
        err = (got - plain).abs()
        assert bool((err <= 1e-5 * scale + 1e-30).all())


def test_sublane_histogram_dyadic_is_exact(dev):
    g = torch.Generator(device=dev)
    g.manual_seed(3)
    n, f = 1 << 20, 28
    bins = torch.randint(0, 64, (f, n), generator=g, device=dev,
                         dtype=torch.uint8)
    ch = torch.stack([
        torch.randint(-128, 129, (n,), generator=g, device=dev) / 64.0,
        torch.randint(0, 65, (n,), generator=g, device=dev) / 64.0,
        (torch.rand(n, generator=g, device=dev) > 0.1).float()], 1)
    kern = pallas_histogram_sublane(bins, ch.contiguous(), 64, "f32")
    assert torch.equal(kern, pallas_histogram_sublane_plain(bins, ch, 64,
                                                            "f32"))


def _dyadic(n, g, dev, integer=False):
    if integer:
        # a bin may hold every row: integer sums stay exact below 2^24
        gr = torch.randint(-1, 2, (n,), generator=g, device=dev).float()
        he = torch.randint(0, 2, (n,), generator=g, device=dev).float()
    else:
        gr = torch.randint(-128, 129, (n,), generator=g, device=dev) / 64.0
        he = torch.randint(0, 65, (n,), generator=g, device=dev) / 64.0
    cnt = (torch.rand(n, generator=g, device=dev) > 0.1).float()
    return torch.stack([gr, he, cnt], 1).contiguous()


@pytest.mark.parametrize("skew", ["bin0_90", "one_bin"])
def test_sublane_histogram_skewed_bins_is_exact(dev, skew):
    """Skewed features: 90% of the rows in bin 0, or every row of a
    feature in one bin. Integer channels keep every partial sum exact, so
    kernel and plain version agree bit for bit."""
    g = torch.Generator(device=dev)
    g.manual_seed(6)
    n, f = 2_000_000, 28
    bins = torch.randint(0, 64, (f, n), generator=g, device=dev,
                         dtype=torch.uint8)
    if skew == "bin0_90":
        bins[torch.rand(f, n, generator=g, device=dev) < 0.9] = 0
    else:
        bins[:] = (torch.arange(f, device=dev) * 37 % 64).to(
            torch.uint8)[:, None]
    ch = _dyadic(n, g, dev, integer=True)
    assert torch.equal(pallas_histogram_sublane(bins, ch, 64, "f32"),
                       pallas_histogram_sublane_plain(bins, ch, 64, "f32"))


@pytest.mark.parametrize("live", ["random_8", "random_64", "runs", "none"])
def test_sublane_histogram_sparse_is_exact(dev, live):
    """The masked grower's deeper splits: few live rows (non-zero
    channels), spread out or in runs. Dead 16-row pieces are not read and
    sparse tiles go through the warp's pending tile; dyadic channels make
    the result exact."""
    g = torch.Generator(device=dev)
    g.manual_seed(7)
    n, f = 1_000_003, 28
    bins = torch.randint(0, 64, (f, n), generator=g, device=dev,
                         dtype=torch.uint8)
    rows = torch.arange(n, device=dev)
    mask = {"random_8": torch.rand(n, generator=g, device=dev) < 1 / 8,
            "random_64": torch.rand(n, generator=g, device=dev) < 1 / 64,
            "runs": (rows // 3000) % 2 == 0,
            "none": torch.zeros(n, dtype=torch.bool, device=dev)}[live]
    ch = (_dyadic(n, g, dev) * mask[:, None]).contiguous()
    kern = pallas_histogram_sublane(bins, ch, 64, "f32")
    assert torch.equal(kern, pallas_histogram_sublane_plain(bins, ch, 64,
                                                            "f32"))
    assert float(kern[0, :, 2].sum()) == float(ch[:, 2].sum())


@pytest.mark.parametrize("small,k,warps", [(False, 3, 7), (False, 2, 8),
                                           (False, 6, 3), (True, 3, 8)])
def test_sublane_histogram_geometries_agree(dev, small, k, warps):
    """Both paths just past the row count where the host switches between
    them, at block sizes that the channel count leaves on the tile path
    (7, 8 and 3 warps), give the plain result on dyadic channels."""
    g = torch.Generator(device=dev)
    g.manual_seed(8)
    n, f = SUBLANE_SMALL_ROWS + 1, 28
    bins = torch.randint(0, 64, (f, n), generator=g, device=dev,
                         dtype=torch.uint8)
    ch = torch.cat([_dyadic(n, g, dev)] * 3, 1)[:, :k].contiguous()
    ch[::5] = 0.0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    path = sublane_small_geometry if small else sublane_tile_geometry
    geom = path(n, f, 64, k, sms)
    assert (geom.warps, geom.small) == (warps, small)
    assert torch.equal(_launch_sublane(bins, ch, 64, "f32", geom),
                       pallas_histogram_sublane_plain(bins, ch, 64, "f32"))


def test_sublane_histogram_rejects_bad_inputs(dev):
    bins = torch.zeros((4, 1000), dtype=torch.uint8, device=dev)
    ch = torch.zeros((1000, 3), device=dev)
    with pytest.raises(ValueError, match="64"):
        pallas_histogram_sublane(bins, ch, 65)
    with pytest.raises(TypeError):
        pallas_histogram_sublane(bins.to(torch.int32), ch, 64)
    with pytest.raises(TypeError):
        pallas_histogram_sublane(bins, ch.double(), 64)
    with pytest.raises(ValueError):
        pallas_histogram_sublane(bins, torch.zeros((3, 1000),
                                                   device=dev).T, 64)
    with pytest.raises(ValueError):
        pallas_histogram_sublane(bins.T.contiguous().T, ch, 64)


def test_masked_train_on_card_matches_cpu(dev):
    """Small data (auto -> the masked grower) with the sublane layout: K3
    launches once for the root and once a split, K1 and K2 not at all."""
    rng = np.random.RandomState(1)
    X = rng.randn(5_000, 8).astype(np.float32)
    X[rng.rand(*X.shape) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 2])
         + 0.3 * rng.randn(5_000) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "tpu_hist_layout": "sublane", "verbosity": -1}
    _kernels.reset_counts()
    bg = lgt.train(dict(p, device_type="cuda"), lgt.Dataset(X, y), 3)
    launches = dict(_kernels.LAUNCHES)
    plain = dict(_kernels.PLAIN_CALLS)
    bc = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y), 3)
    assert launches == {"histogram": 0, "fused_split": 0,
                        "histogram_sublane": 3 * 31, "monotone_walk": 0,
                        "treeshap": 0, "segment_gather": 0}
    assert sum(plain.values()) == 0
    np.testing.assert_allclose(bg.predict(X), bc.predict(X), atol=1e-4)


def test_masked_grower_past_the_compact_bound(dev):
    """Just over 2^24 rows (the compact grower's bound, where f32 counts
    stop being exact): tpu_grower=auto trains one round on the masked
    grower, and the sublane layout (K3) grows the same splits as the lane
    layout (K1's dense mode) on the same Higgs-shaped rows. The label's
    x7 * x9 term is symmetric, so two leaves can tie within f32 summation
    order and be split in the other order (ROADMAP C, notes): the splits
    are compared as a set, the models by their predictions."""
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    n = gbdt_mod._COMPACT_MAX_ROWS + 4096
    rng = np.random.RandomState(5)
    X = rng.randn(n, 28).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 3] + 0.3 * X[:, 7] * X[:, 9]
         + 0.5 * rng.randn(n).astype(np.float32) > 0).astype(np.float32)
    p = {"objective": "binary", "num_leaves": 63, "max_bin": 63,
         "verbosity": -1, "device_type": "cuda"}
    ds = lgt.Dataset(X, y, params=p)
    boosters, launches = {}, {}
    for layout in ("sublane", "lane"):
        _kernels.reset_counts()
        boosters[layout] = lgt.train(dict(p, tpu_hist_layout=layout), ds, 1)
        launches[layout] = dict(_kernels.LAUNCHES)
        assert sum(_kernels.PLAIN_CALLS.values()) == 0
        assert not boosters[layout]._gbdt.use_compact
    assert launches["sublane"] == {"histogram": 0, "fused_split": 0,
                                   "histogram_sublane": 63,
                                   "monotone_walk": 0, "treeshap": 0,
                                   "segment_gather": 0}
    assert launches["lane"]["histogram"] == 63
    assert launches["lane"]["fused_split"] == 0
    ts, tl = (b._gbdt.models[0] for b in boosters.values())
    assert ts.num_nodes == tl.num_nodes == 62

    def splits(t):
        return sorted(zip(t.split_feature[:62].tolist(),
                          t.split_bin[:62].tolist()))
    assert splits(ts) == splits(tl)
    # leaf counts summed in f32 past 2^24 (inexact in either layout)
    assert abs(int(ts.internal_count[0]) - n) <= 64
    rows = X[:200_000]
    np.testing.assert_allclose(boosters["sublane"].predict(rows),
                               boosters["lane"].predict(rows), atol=1e-4)


def _cat_data(n, seed):
    """Four numerical features and two categorical ones (20 categories,
    sorted scan; 3 categories, one-hot) with a 3-class label and a
    continuous target."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    X[:, 1] = rng.randint(0, 20, n)
    X[:, 4] = rng.randint(0, 3, n)
    X[rng.rand(n) < 0.05, 2] = np.nan
    s = (np.nan_to_num(X[:, 0]) + np.isin(X[:, 1], [2, 3, 11, 17])
         - 0.7 * (X[:, 4] == 1) + 0.3 * rng.randn(n))
    return X, np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(float), s


@pytest.mark.parametrize("objective", ["multiclass", "regression"])
@pytest.mark.parametrize("grower", ["compact", "masked"])
def test_categorical_train_on_card_matches_cpu(dev, grower, objective):
    """Multiclass (3 trees a round) and regression with categorical
    features on each grower: the card's kernels launch where the CPU runs
    their plain versions, and the predictions (class probabilities) agree
    within 1e-4. The rows are weighted: unweighted first-round softmax
    gradients take two values, so categories with equal class counts tie
    exactly in the sorted scan and the f32 summation order picks a set."""
    X, y3, s = _cat_data(20_000, seed=4)
    w = np.random.RandomState(6).uniform(0.5, 1.5, len(s))
    y = y3 if objective == "multiclass" else s
    k = 3 if objective == "multiclass" else 1
    p = {"objective": objective, "num_leaves": 31, "max_bin": 63,
         "tpu_grower": grower, "tpu_hist_layout": "sublane",
         "verbosity": -1, "min_data_per_group": 20, "cat_smooth": 2.0}
    if k > 1:
        p["num_class"] = k

    def train(device):
        return lgt.train(dict(p, device_type=device),
                         lgt.Dataset(X, y, weight=w,
                                     categorical_feature=[1, 4]), 3)
    _kernels.reset_counts()
    bg = train("cuda")
    launches = dict(_kernels.LAUNCHES)
    plain = dict(_kernels.PLAIN_CALLS)
    bc = train("cpu")
    per_run = 3 * k * 31
    if grower == "compact":
        assert launches == {"histogram": per_run, "fused_split": per_run,
                            "histogram_sublane": 0, "monotone_walk": 0,
                            "treeshap": 0, "segment_gather": 0}
    else:
        assert launches == {"histogram": 0, "fused_split": 0,
                            "histogram_sublane": per_run, "monotone_walk": 0,
                            "treeshap": 0, "segment_gather": 0}
    assert sum(plain.values()) == 0
    assert any(t.cat_bitset[:t.num_nodes].any() for t in bg._gbdt.models)
    np.testing.assert_allclose(bg.predict(X), bc.predict(X), atol=1e-4)


def test_fused_split_with_a_grown_categorical_split(dev):
    """K2 against its plain version on a multiclass record array (3 score
    and 6 class-gradient columns beside the label and the row id) with the
    bitset of a sorted categorical split the grower chose, at 255 bins (8
    words); integer grad and hess, so the histograms are bit-equal."""
    X, y3, _ = _cat_data(70_000, seed=5)
    bst = lgt.train({"objective": "multiclass", "num_class": 3,
                     "num_leaves": 15, "verbosity": -1, "device_type": "cuda",
                     "min_data_per_group": 20, "cat_smooth": 2.0},
                    lgt.Dataset(X, y3, categorical_feature=[1, 4]), 1)
    gbdt = bst._gbdt
    assert gbdt.use_compact and gbdt.layout.num_extra == 3 + 6 + 2
    node = next((int(t.split_feature[i]), t.cat_bitset[i])
                for t in gbdt.models for i in range(t.num_nodes)
                if int(t.split_feature[i]) == 1)
    feat, words = node
    bits = torch.from_numpy(np.ascontiguousarray(words).view(np.int32)).to(
        dev)
    assert bits.numel() == 8
    n = gbdt.num_data
    parent = gbdt.work.clone()
    # integer grad and hess: a one-hot category holds a third of the rows,
    # and integer sums are exact in f32 whatever the order
    ints = torch.stack([torch.randint(-1, 2, (n,), device=dev),
                        torch.randint(0, 2, (n,), device=dev)], 1).float()
    o = gbdt.layout.grad_off
    parent[:, o:o + 8] = ints.view(torch.uint8)
    n_left = int(go_left_pred(parent[:n, feat], 0, False, 0, True,
                              bits).sum())
    assert 0 < n_left < n
    args = (0, 7, n - 7, n_left - int(go_left_pred(
        parent[:7, feat], 0, False, 0, True, bits).sum()), feat, 0, 0, 0, 1,
        bits, gbdt.layout, gbdt.grower_params.num_bins)
    arrays_k = (parent.clone(), torch.zeros_like(parent))
    arrays_p = (parent.clone(), torch.zeros_like(parent))
    _, _, hk = fused_split(*arrays_k, *args, side=0)
    _, _, hp = fused_split_plain(*arrays_p, *args, side=0)
    torch.cuda.synchronize()
    assert torch.equal(arrays_k[0], arrays_p[0])
    nl = args[3]
    assert torch.equal(arrays_k[1][7 + nl:], arrays_p[1][7 + nl:])
    assert torch.equal(hk, hp)


def _int_records(n, f, b, dev, seed, skew=None):
    """Records whose grad and hess columns hold quantized codes (|qg| <= 63,
    0 <= qh <= 127: the widest int8 code range), as the int path writes
    them. skew "bin0_90": 90% of the rows in bin 0; "one_bin": every row of
    a feature in one bin."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    layout = RowLayout(num_features=f, num_extra=2)
    bins = torch.randint(0, b, (n, f), generator=g, device=dev,
                         dtype=torch.uint8)
    if skew == "bin0_90":
        bins[torch.rand(n, f, generator=g, device=dev) < 0.9] = 0
    elif skew == "one_bin":
        bins[:] = (torch.arange(f, device=dev) * 37 % b).to(torch.uint8)
    work = pack_rows(
        bins, torch.randint(-63, 64, (n,), generator=g, device=dev).float(),
        torch.randint(0, 128, (n,), generator=g, device=dev).float(),
        (torch.rand(n, generator=g, device=dev) > 0.2).float(),
        torch.randn(2, n, generator=g, device=dev), layout)
    return layout, work


@pytest.mark.parametrize("n,f,skew,start", [
    (30_000, 5, None, 123), (30_000, 29, None, 7),
    (3_000_000, 28, "bin0_90", 0), (3_000_000, 28, "one_bin", 11),
    (100_000, 529, None, 5)])
def test_record_histogram_int_is_exact(dev, n, f, skew, start):
    """K1's integer variant against its plain version, exactly equal (int32
    sums do not depend on their order): uniform bins at F = 5 and 29
    (unaligned codes), skewed bins whose segments put more than 65,535 rows
    of one bin into a block (the packed counts flush on the way), and the
    EFB record width (529 columns in nine feature chunks)."""
    layout, work = _int_records(n, f, 256, dev, seed=n + f, skew=skew)
    scratch = work.flip(0).contiguous()
    seg = torch.tensor([start, n - 2 * start, 1], dtype=torch.int32,
                       device=dev)
    _kernels.reset_counts()
    kern = record_histogram(work, scratch, seg, layout, 256, quant=True)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["histogram"] == 1
    assert _kernels.MODE_LAUNCHES["histogram/quant"] == 1
    plain = record_histogram_plain(work, scratch, seg, layout, 256,
                                   quant=True)
    assert kern.dtype == torch.int32
    assert torch.equal(kern, plain)
    assert int(kern[0, :, 3].sum()) == n - 2 * start


@pytest.mark.parametrize("dual", [True, False])
@pytest.mark.parametrize("mode,start,count,side,f", [
    (1, 0, 30_000, 0, 28), (0, 0, 30_000, 0, 28), (0, 37, 22_190, 1, 29),
    (0, 96, 128, 0, 5), (0, 13, 29_000, 1, 529)])
def test_fused_split_quant(dev, mode, start, count, side, f, dual):
    """K2's quant mode against its plain version, dual and copy-back: the
    record arrays byte-equal, the int32 histogram exactly equal."""
    layout, parent = _int_records(30_000, f, 256, dev, seed=start + f)
    _, other = _int_records(30_000, f, 256, dev, seed=start + 1)
    feat, bin_ = 2, 100
    col = parent[start:start + count, feat].to(torch.int64)
    n_left = int((col <= bin_).sum())
    args = (mode, start, count, n_left, feat, bin_, 0, 0, 0, None, layout,
            256)
    kw = {"side": side, "dual": dual, "quant": True}
    arrays = (other, parent) if side and dual else (parent, other)
    _kernels.reset_counts()
    wk, sk, hk = fused_split(*(a.clone() for a in arrays), *args, **kw)
    wp, sp, hp = fused_split_plain(*(a.clone() for a in arrays), *args, **kw)
    torch.cuda.synchronize()
    assert _kernels.MODE_LAUNCHES["fused_split/quant"] == 1
    assert _kernels.MODE_LAUNCHES["histogram/quant"] == 1
    assert torch.equal(wk, wp) and torch.equal(sk, sp)
    assert hk.dtype == torch.int32 and torch.equal(hk, hp)


def test_quantized_train_on_card_matches_cpu(dev):
    """use_quantized_grad on the compact grower's int path, deterministic
    rounding: the card (K2 quant, K1's integer variant) grows the CPU's
    trees; no plain version runs on the card."""
    rng = np.random.RandomState(4)
    X = rng.randn(20_000, 6).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 3] + 0.3 * rng.randn(20_000) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
         "tpu_grower": "compact", "use_quantized_grad": True,
         "stochastic_rounding": False}
    _kernels.reset_counts()
    bg = lgt.train(dict(p, device_type="cuda"), lgt.Dataset(X, y), 3)
    launches = dict(_kernels.LAUNCHES)
    modes = dict(_kernels.MODE_LAUNCHES)
    plain = dict(_kernels.PLAIN_CALLS)
    bc = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y), 3)
    assert bg._gbdt._quant_int
    assert launches["fused_split"] == modes["fused_split/quant"] == 3 * 31
    assert launches["histogram"] == modes["histogram/quant"] == 3 * 31
    assert sum(plain.values()) == 0
    for a, b in zip(bg._gbdt.models, bc._gbdt.models):
        n = a.num_nodes
        assert b.num_nodes == n
        np.testing.assert_array_equal(a.split_feature[:n], b.split_feature[:n])
        np.testing.assert_array_equal(a.split_bin[:n], b.split_bin[:n])
    np.testing.assert_allclose(bg.predict(X), bc.predict(X), atol=1e-5)


def _rank_data(nq, seed):
    rng = np.random.RandomState(seed)
    sizes = rng.randint(20, 120, nq)
    n = int(sizes.sum())
    X = rng.randn(n, 8).astype(np.float32)
    rel = X[:, 0] - 0.5 * X[:, 1] + 0.6 * rng.randn(n)
    y = np.digitize(rel, np.quantile(rel, [0.5, 0.75, 0.9, 0.97]))
    return X, y.astype(np.float64), sizes


def test_lambdarank_tied_first_iteration_card_matches_cpu(dev):
    """The first iteration's scores all tie: the card's stable sort keeps
    document order as the CPU's does, so its lambdarank gradients equal
    the CPU's; three rounds on the compact grower (external gradients, K1
    and K2) grow the CPU's trees."""
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.io.dataset import Metadata
    from lightgbm_tpu_torch.objectives import create_objective
    X, y, sizes = _rank_data(300, seed=5)
    n = len(y)
    md = Metadata(n)
    md.set_label(y)
    md.set_group(sizes)
    cfg = Config({"objective": "lambdarank"})
    obj = create_objective("lambdarank", cfg)
    obj.init(md, n)
    gg, hg = obj.get_gradients(torch.zeros(n, device=dev))
    gc, hc = obj.get_gradients(torch.zeros(n))
    np.testing.assert_allclose(gg.cpu().numpy(), gc.numpy(), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(hg.cpu().numpy(), hc.numpy(), rtol=1e-6,
                               atol=1e-7)
    p = {"objective": "lambdarank", "num_leaves": 31, "verbosity": -1,
         "tpu_grower": "compact", "min_data_in_leaf": 50}
    _kernels.reset_counts()
    bg = lgt.train(dict(p, device_type="cuda"),
                   lgt.Dataset(X, y, group=sizes), 3)
    launches = dict(_kernels.LAUNCHES)
    plain = dict(_kernels.PLAIN_CALLS)
    bc = lgt.train(dict(p, device_type="cpu"),
                   lgt.Dataset(X, y, group=sizes), 3)
    assert bg._gbdt.use_compact and bg._gbdt._ext_grads
    assert launches["fused_split"] > 0 and launches["histogram"] > 0
    assert sum(plain.values()) == 0
    np.testing.assert_allclose(bg.predict(X), bc.predict(X), atol=1e-4)


@pytest.mark.parametrize("grower", ["compact", "masked"])
def test_renewal_card_matches_cpu(dev, grower):
    """renew_leaf_quantile on the card equals the CPU's (unit weights and
    weights on a 1/64 grid); quantile training on each grower grows the
    CPU's trees with the same renewed leaves."""
    from lightgbm_tpu_torch.ops.renew import renew_leaf_quantile
    rng = np.random.RandomState(6)
    n, L = 200_000, 255
    res = torch.from_numpy((rng.randint(-500, 500, n) / 16.0).astype(
        np.float32))
    leaf = torch.from_numpy(rng.randint(0, L - 5, n).astype(np.int32))
    for w in (torch.ones(n), torch.from_numpy(
            (rng.randint(0, 64, n) / 64.0).astype(np.float32))):
        got = renew_leaf_quantile(res.to(dev), w.to(dev), leaf.to(dev), L,
                                  0.9)
        want = renew_leaf_quantile(res, w, leaf, L, 0.9)
        assert torch.equal(got.cpu(), want)
    X = rng.randn(30_000, 6).astype(np.float32)
    y = 2.0 * X[:, 0] - X[:, 1] + rng.standard_t(3, 30_000)
    p = {"objective": "quantile", "alpha": 0.8, "num_leaves": 31,
         "verbosity": -1, "tpu_grower": grower}
    bg = lgt.train(dict(p, device_type="cuda"), lgt.Dataset(X, y), 3)
    bc = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y), 3)
    assert bg._gbdt.use_compact == (grower == "compact")
    for a, b in zip(bg._gbdt.models, bc._gbdt.models):
        n_ = a.num_nodes
        np.testing.assert_array_equal(a.split_feature[:n_],
                                      b.split_feature[:n_])
    np.testing.assert_allclose(bg.predict(X), bc.predict(X), atol=1e-4)


def _amp_records(n, f, b, dev, seed):
    """Records whose in-bag column is a GOSS-like weight: 0 out of bag, 1
    or an amplification (8) in bag, so the in-bag count channel (rows with
    a non-zero weight) differs from the raw count."""
    layout, work = _records(n, f, b, dev, seed)
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 1)
    u = torch.rand(n, generator=g, device=dev)
    w = torch.where(u < 0.3, 0.0, torch.where(u < 0.4, 8.0, 1.0))
    work[:, layout.cnt_off:layout.cnt_off + 4] = w.contiguous().view(
        torch.uint8).reshape(n, 4)
    return layout, work


@pytest.mark.parametrize("mode,start,count", [(1, 0, 300_000),
                                              (0, 0, 300_000),
                                              (0, 12_345, 100_001)])
def test_fused_split_on_bagged_records(dev, mode, start, count):
    """K2 and its K1 on records whose in-bag weights are 0, 1 and 8: the
    children byte-equal, the in-bag count exact and below the raw count."""
    n, f, b = 300_000, 28, 256
    layout, work = _amp_records(n, f, b, dev, 41)
    scratch = torch.zeros_like(work)
    col = work[start:start + count, 3]
    n_left = int((col <= 100).sum())
    args = (mode, start, count, n_left, 3, 100, 0, 0, 0, None, layout, b)
    wk, sk = work.clone(), scratch.clone()
    wp, sp = work.clone(), scratch.clone()
    _, _, hk = fused_split(wk, sk, *args)
    _, _, hp = fused_split_plain(wp, sp, *args)
    _, _, habs = fused_split_plain(_abs_grad(work, layout), scratch.clone(),
                                   *args)
    torch.cuda.synchronize()
    _close(hk, hp, habs)
    assert bool((hk[..., 2] <= hk[..., 3]).all())
    assert bool((hk[..., 2] < hk[..., 3]).any())
    if mode == 0:
        assert torch.equal(wk[start:start + n_left], wp[start:start + n_left])
        assert torch.equal(sk[start + n_left:start + count],
                           sp[start + n_left:start + count])
    seg = torch.tensor([start, count, 0], dtype=torch.int32, device=dev)
    rk = record_histogram(work, scratch, seg, layout, b)
    rp = record_histogram_plain(work, scratch, seg, layout, b)
    _close(rk, rp, record_histogram_plain(_abs_grad(work, layout), scratch,
                                          seg, layout, b))
    in_bag = work[start:start + count, layout.cnt_off:layout.cnt_off + 4] \
        .contiguous().view(torch.float32) != 0
    assert int(rk[0, :, 2].sum()) == int(in_bag.sum())
    assert int(rk[0, :, 3].sum()) == count


def _numpy_draws(gbdt):
    """The same draws on the card and the CPU (the seams)."""
    gbdt.sample_strategy.draws = lambda seed, size: torch.from_numpy(
        np.random.RandomState(seed).rand(size).astype(np.float32))
    gbdt.bynode_draws = lambda t, rows, feats: torch.from_numpy(
        np.random.RandomState(1000 + t).rand(rows, feats).astype(np.float32))


@pytest.mark.parametrize("case", ["bagging", "goss", "balanced",
                                  "balanced_sublane", "bynode_masked",
                                  "bynode_compact"])
def test_sampled_train_on_card_matches_cpu(dev, case, monkeypatch):
    """Sampled training on the card against the CPU with the same draws:
    the same trees, predictions within 1e-4."""
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    init = gbdt_mod.GBDT.__init__

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        _numpy_draws(self)
    monkeypatch.setattr(gbdt_mod.GBDT, "__init__", patched)
    rng = np.random.RandomState(8)
    X = rng.randn(80_000, 10).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 3] + 0.4 * rng.randn(80_000) > 0).astype(
        np.float64)
    extra = {"bagging": {"bagging_fraction": 0.7, "bagging_freq": 2},
             "goss": {"data_sample_strategy": "goss",
                      "learning_rate": 0.34},
             "balanced": {"bagging_fraction": 0.9, "bagging_freq": 1,
                          "pos_bagging_fraction": 0.5},
             # K3 on a bagged mask channel
             "balanced_sublane": {"bagging_fraction": 0.9, "bagging_freq": 1,
                                  "pos_bagging_fraction": 0.5,
                                  "max_bin": 63, "tpu_hist_layout": "sublane"},
             "bynode_masked": {"feature_fraction_bynode": 0.5,
                               "feature_fraction": 0.8,
                               "tpu_grower": "masked"},
             "bynode_compact": {"feature_fraction_bynode": 0.5,
                                "feature_fraction": 0.8}}[case]
    p = dict({"objective": "binary", "num_leaves": 31, "verbosity": -1},
             **extra)
    _kernels.reset_counts()
    bg = lgt.train(dict(p, device_type="cuda"), lgt.Dataset(X, y), 5)
    assert sum(_kernels.PLAIN_CALLS.values()) == 0
    if case == "balanced_sublane":
        assert _kernels.LAUNCHES["histogram_sublane"] > 0
        assert _kernels.LAUNCHES["histogram"] == 0
    bc = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y), 5)
    assert bg._gbdt.use_compact == (case not in ("balanced",
                                                 "balanced_sublane",
                                                 "bynode_masked"))
    for a, b in zip(bg._gbdt.models, bc._gbdt.models):
        n_ = a.num_nodes
        np.testing.assert_array_equal(a.split_feature[:n_],
                                      b.split_feature[:n_])
    np.testing.assert_allclose(bg.predict(X), bc.predict(X), atol=1e-4)


def test_goss_threshold_on_card_past_2_24(dev):
    """GOSS's threshold on more elements than torch.quantile takes, equal
    on the card and the CPU."""
    from lightgbm_tpu_torch.boosting.sample_strategy import linear_quantile
    x = torch.rand((1 << 24) + 1001, generator=torch.Generator().manual_seed(
        3))
    x[:1000] = x[0]
    for q in (0.0, 0.8, 0.999999, 1.0):
        assert float(linear_quantile(x.to(dev), q)) \
            == float(linear_quantile(x, q))


def _random_walk_state(L, F, seed, dev):
    """A random valid tree of L leaves grown split by split (each split
    takes a random leaf; random features, thresholds and categorical
    flags; random directions), its leaf table's gains and bounds, and the
    walk's inputs for its last split: (node_i, leaf_f, mono, eff, parent,
    feature, threshold, lw, rw, node)."""
    from lightgbm_tpu_torch.ops import monotone as mono_mod
    rng = np.random.RandomState(seed)
    node_i = np.full((max(L - 1, 1), mono_mod._NODE_I), -1, np.int64)
    leaf_parent = np.full(L, -1, np.int64)
    leaf_side = np.zeros(L, np.int64)
    for k in range(L - 1):
        best = rng.randint(0, k + 1)
        p = leaf_parent[best]
        if p >= 0:
            node_i[p, 3 + leaf_side[best]] = k
        node_i[k, :5] = [rng.randint(0, F), rng.randint(0, 32), 0,
                         -(best + 1), -(k + 2)]
        node_i[k, mono_mod._NPAR] = p
        node_i[k, mono_mod._NCAT] = int(rng.rand() < 0.1)
        leaf_parent[best] = leaf_parent[k + 1] = k
        leaf_side[best], leaf_side[k + 1] = 0, 1
    leaf_f = np.zeros((L, 10), np.float32)
    leaf_f[:, 3] = np.where(rng.rand(L) < 0.2, -1e30, rng.randn(L))
    leaf_f[:, 8] = np.where(rng.rand(L) < 0.5, -3.4e38, -rng.rand(L))
    leaf_f[:, 9] = np.where(rng.rand(L) < 0.5, 3.4e38, rng.rand(L))
    mono = rng.randint(-1, 2, F).astype(np.int64)
    k = max(L - 2, 0)
    t = lambda a, dt=torch.int64: torch.as_tensor(a, dtype=dt, device=dev)
    return (t(node_i), t(leaf_f, torch.float32), t(mono),
            t([L > 1], torch.bool), t([node_i[k, mono_mod._NPAR]]),
            t([node_i[k, 0]]), t([node_i[k, 1]]),
            t(rng.randn() * 0.3, torch.float32),
            t(rng.randn() * 0.3, torch.float32), k)


@pytest.mark.parametrize("L,F", [(2, 3), (7, 2), (31, 4), (255, 28),
                                 (1024, 8)])
def test_monotone_walk_kernel_matches_plain(dev, L, F):
    """The walk kernel against its plain version on random valid trees
    with monotone ancestors (and the degenerate two-leaf tree, whose root
    split has no ancestor): flags and tightened bounds equal."""
    from lightgbm_tpu_torch.ops import monotone as mono_mod
    moved = 0
    for seed in range(20):
        st = _random_walk_state(L, F, seed, dev)
        node_i, leaf_f = st[0], st[1]
        lk, lp = leaf_f.clone(), leaf_f.cpu()
        _kernels.reset_counts()
        fk = mono_mod.monotone_walk(node_i, lk, *st[2:])
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["monotone_walk"] == 1
        fp = mono_mod.monotone_walk_plain(
            node_i.cpu(), lp, *[x.cpu() if torch.is_tensor(x) else x
                                for x in st[2:]])
        assert torch.equal(fk.cpu(), fp)
        assert torch.equal(lk.cpu(), lp)
        moved += int(fp.sum())
    assert moved > 0 or L == 2


def _dyadic_binary(monkeypatch):
    """Binary gradients on a 1/64 grid: every histogram sum exact on the
    card and the CPU alike."""
    from lightgbm_tpu_torch import objectives
    own = objectives.BinaryLogloss.get_gradients

    def rounded(self, score, label, weight=None):
        g, h = own(self, score, label, weight)
        return (torch.round(g * 64) / 64,
                torch.clamp(torch.round(h * 64), min=1) / 64)
    monkeypatch.setattr(objectives.BinaryLogloss, "get_gradients", rounded)


@pytest.mark.parametrize("grower", ["compact", "masked"])
def test_constrained_train_on_card_matches_cpu(dev, grower, monkeypatch):
    """Monotone (intermediate on the compact grower, basic on the masked
    one) and interaction constraints with path smoothing, extra trees (the
    same words on both, through ``GBDT.extra_draws``), ``feature_contri``
    and CEGB: the card grows the CPU's trees (0 differing splits), the
    walk kernel once a split on the compact grower, no plain version on
    the card."""
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    _dyadic_binary(monkeypatch)
    init = gbdt_mod.GBDT.__init__

    def words(t, leaves, feats, intermediate):
        rs = np.random.RandomState(30_000 + t)
        shapes = [(2 * leaves - 1,)] * 2 + (
            [(leaves - 1, leaves)] * 2 if intermediate else [])
        return tuple(torch.from_numpy(rs.randint(
            0, 1 << 32, size=(*sh, feats, 2), dtype=np.int64))
            for sh in shapes)

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        self.extra_draws = words
    monkeypatch.setattr(gbdt_mod.GBDT, "__init__", patched)
    rng = np.random.RandomState(12)
    n = 80_000 if grower == "compact" else 20_000
    X = rng.randn(n, 8).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 3] + 0.4 * rng.randn(n) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
         "tpu_grower": grower, "monotone_constraints": [1, 0, 0, -1, 0, 1,
                                                        0, 0],
         "monotone_constraints_method": "intermediate",
         "interaction_constraints": [[0, 1, 2, 3], [3, 4, 5, 6, 7]],
         "path_smooth": 1.0, "cegb_penalty_split": 1e-4,
         "extra_trees": True, "feature_contri": [1.0, 0.5] * 4}
    if grower == "masked":
        p["cegb_penalty_feature_lazy"] = [0.01] * 8
    _kernels.reset_counts()
    bg = lgt.train(dict(p, device_type="cuda"), lgt.Dataset(X, y), 3)
    launches = dict(_kernels.LAUNCHES)
    assert sum(_kernels.PLAIN_CALLS.values()) == 0
    bc = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y), 3)
    assert bg._gbdt.use_compact == (grower == "compact")
    assert launches["monotone_walk"] == (3 * 30 if grower == "compact"
                                         else 0)
    for a, b in zip(bg._gbdt.models, bc._gbdt.models):
        n_ = a.num_nodes
        assert b.num_nodes == n_
        np.testing.assert_array_equal(a.split_feature[:n_],
                                      b.split_feature[:n_])
        np.testing.assert_array_equal(a.split_bin[:n_], b.split_bin[:n_])
    np.testing.assert_allclose(bg.predict(X), bc.predict(X), atol=1e-5)


@pytest.mark.parametrize("case", ["dart_compact", "dart_masked",
                                  "rf_masked"])
def test_boosting_modes_on_card_match_cpu(dev, case, monkeypatch):
    """DART (the same drops on both: numpy's drop_seed stream) and random
    forest (the same bags on both, through ``sample_strategy.draws``): the
    card grows the CPU's trees on dyadic gradients, no plain version on
    the card, and DART's drops route on the card."""
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    _dyadic_binary(monkeypatch)
    init = gbdt_mod.GBDT.__init__

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        _numpy_draws(self)
    monkeypatch.setattr(gbdt_mod.GBDT, "__init__", patched)
    rng = np.random.RandomState(14)
    n = 80_000 if case == "dart_compact" else 20_000
    X = rng.randn(n, 8).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 3] + 0.4 * rng.randn(n) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
    if case.startswith("dart"):
        p.update(boosting="dart", drop_rate=0.5, skip_drop=0.0,
                 tpu_grower=case.split("_")[1])
    else:
        p.update(boosting="rf", bagging_fraction=0.632, bagging_freq=1,
                 feature_fraction=0.8)
    _kernels.reset_counts()
    bg = lgt.train(dict(p, device_type="cuda"), lgt.Dataset(X, y), 4)
    assert sum(_kernels.PLAIN_CALLS.values()) == 0
    assert _kernels.LAUNCHES["histogram"] > 0
    bc = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y), 4)
    assert bg._gbdt.use_compact == (case == "dart_compact")
    if case.startswith("dart"):
        assert bg._gbdt.tree_weight == bc._gbdt.tree_weight
        assert any(m.shrinkage < 0.1 for m in bg._gbdt.models)
    for a, b in zip(bg._gbdt.models, bc._gbdt.models):
        n_ = a.num_nodes
        assert b.num_nodes == n_
        np.testing.assert_array_equal(a.split_feature[:n_],
                                      b.split_feature[:n_])
        np.testing.assert_array_equal(a.split_bin[:n_], b.split_bin[:n_])
    np.testing.assert_allclose(bg.predict(X), bc.predict(X), atol=1e-5)


def test_linear_tree_on_card_matches_cpu(dev, monkeypatch):
    """Linear leaves on a regression (a label linear in two columns, a
    tenth of them NaN, plus a step and noise) with its weighted gradients
    and hessians on a 1/64 grid, so every histogram sum is exact: the card
    grows the CPU's trees, fits the same leaves and predicts within
    1e-5, with no plain version on the card."""
    from lightgbm_tpu_torch import objectives
    own = objectives.RegressionL2.get_gradients

    def rounded(self, score, label, weight=None):
        g, h = own(self, score, label, weight)
        return (torch.round(g * 64) / 64,
                torch.clamp(torch.round(h * 64), min=1) / 64)
    monkeypatch.setattr(objectives.RegressionL2, "get_gradients", rounded)
    rng = np.random.RandomState(15)
    n = 20_000
    X = rng.randn(n, 8)
    y = (1.5 * X[:, 0] - X[:, 2] + np.where(X[:, 5] > 0, 0.75, -0.75)
         + 0.3 * rng.randn(n))
    for j in (0, 2):
        X[rng.rand(n) < 0.1, j] = np.nan
    w = rng.uniform(0.5, 1.5, n)
    p = {"objective": "regression", "num_leaves": 31, "linear_tree": True,
         "linear_lambda": 0.1, "verbosity": -1}

    def ds():
        return lgt.Dataset(X, y, weight=w, params={"linear_tree": True})
    _kernels.reset_counts()
    bg = lgt.train(dict(p, device_type="cuda"), ds(), 4)
    assert sum(_kernels.PLAIN_CALLS.values()) == 0
    assert _kernels.LAUNCHES["histogram"] > 0
    bc = lgt.train(dict(p, device_type="cpu"), ds(), 4)
    assert not bg._gbdt.use_compact
    assert any(m.is_linear and any(m.leaf_features)
               for m in bg._gbdt.models)
    for a, b in zip(bg._gbdt.models, bc._gbdt.models):
        n_ = a.num_nodes
        assert b.num_nodes == n_
        np.testing.assert_array_equal(a.split_feature[:n_],
                                      b.split_feature[:n_])
        np.testing.assert_array_equal(a.split_bin[:n_], b.split_bin[:n_])
    np.testing.assert_allclose(bg.predict(X), bc.predict(X), atol=1e-5)


def _shap_close(kern, plain, paths, rel=1e-12):
    """Within ``rel`` of each cell's |value| plus a bound on the sum of its
    |addends| (each leaf adds at most its |value| to a cell, each tree its
    |expected value| to the bias): the kernel and the plain version add
    the same float64 terms, in another order."""
    scale = float(paths.leaf_value.abs().sum() + paths.ev.abs().sum())
    err = (kern - plain).abs()
    assert bool((err <= rel * (plain.abs() + scale)).all()), \
        float(err.max())


@pytest.mark.parametrize("case", ["numerical", "categorical", "multiclass",
                                  "chunked"])
def test_treeshap_kernel_matches_plain(dev, case, monkeypatch):
    """The TreeSHAP kernel against its plain version on random trees: a
    constant tree, features repeated along paths, a 39-step path, NaN bins
    with both default directions, categorical bitsets of two words (bins
    past them go right), K = 3 classes; and with the rows launched in
    chunks of 1,024, as when their scratch would pass its cap."""
    from lightgbm_tpu_torch.ops import treeshap_device
    from torch_shap_trees import random_forest, random_rows
    cat = (1, 3) if case == "categorical" else ()
    nb = 40 if cat else 16
    models = random_forest(21, 5, nb, cat=cat, words=2 if cat else 1)
    k = 3 if case == "multiclass" else 1
    is_cat = np.isin(np.arange(5), cat)
    paths = build_shap_paths(models, np.full(5, nb - 1), is_cat, dev)
    assert int(paths.path_len.max()) > 32
    if case == "chunked":
        words = -(-paths.split_feature.shape[1] // 32)
        monkeypatch.setattr(treeshap_device, "_SCRATCH_BYTES", 1024 * (
            9 * paths.zfrac.shape[2] + 4 * words))
    b = torch.from_numpy(random_rows(22, 3000, 5, nb)).to(dev)
    _kernels.reset_counts()
    kern = tree_shap(b, paths, k)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["treeshap"] == (3 if case == "chunked" else 1)
    assert _kernels.PLAIN_CALLS["treeshap"] == 0
    assert kern.shape == (3000, k, 6)
    _shap_close(kern, tree_shap_plain(b, paths, k), paths)


def _cpu_twin(bst):
    """A prediction-only CPU Booster with ``bst``'s trees and mappers."""
    from lightgbm_tpu_torch.basic import Booster
    from lightgbm_tpu_torch.boosting.gbdt import GBDT
    from lightgbm_tpu_torch.config import Config
    g = bst._gbdt
    params = dict(bst.params, device_type="cpu")
    return Booster._from_gbdt(GBDT.for_prediction(
        Config(params), g.models, g.mappers, g.objective,
        torch.device("cpu"), g.feature_names), params)


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_predict_api_on_card_matches_cpu(dev, objective):
    """A model trained on the card: pred_contrib (the kernel, no plain
    version) against the same trees' contributions on the CPU, pred_leaf
    and early stopped predictions equal, refit's leaves within 1e-6."""
    rng = np.random.RandomState(31)
    n = 3000
    X = rng.randn(n, 6)
    X[:, 3] = rng.randint(0, 12, n)
    X[rng.rand(n) < 0.1, 1] = np.nan
    z = X[:, 0] + np.isin(X[:, 3], [2, 5, 7]) + 0.3 * rng.randn(n)
    p = {"objective": objective, "num_leaves": 31, "min_data_in_leaf": 10,
         "verbosity": -1, "device_type": "cuda"}
    if objective == "multiclass":
        p["num_class"] = 3
        y = np.digitize(z, [-0.5, 0.8]).astype(float)
    else:
        y = (z > 0.5).astype(float)
    bst = lgt.train(p, lgt.Dataset(X, y, categorical_feature=[3]), 6)
    cpu = _cpu_twin(bst)
    _kernels.reset_counts()
    phi = bst.predict(X, pred_contrib=True)
    assert _kernels.LAUNCHES["treeshap"] == 1
    assert _kernels.PLAIN_CALLS["treeshap"] == 0
    g = bst._gbdt
    paths = build_shap_paths(g.models, g._pred_nan_arr.cpu().numpy(),
                             g.feature_is_categorical(), "cpu")
    _shap_close(torch.from_numpy(phi), torch.from_numpy(
        cpu.predict(X, pred_contrib=True)), paths)
    k = g.num_class
    raw = bst.predict(X, raw_score=True).reshape(n, k)
    np.testing.assert_allclose(phi.reshape(n, k, -1).sum(-1), raw,
                               atol=1e-5)
    np.testing.assert_array_equal(bst.predict(X, pred_leaf=True),
                                  cpu.predict(X, pred_leaf=True))
    stop = dict(pred_early_stop=True, pred_early_stop_margin=1.0,
                pred_early_stop_freq=2)
    np.testing.assert_allclose(bst.predict(X, **stop),
                               cpu.predict(X, **stop), atol=1e-6)
    a = bst.refit(X[:1000], y[:1000], decay_rate=0.9)._gbdt.models
    b = cpu.refit(X[:1000], y[:1000], decay_rate=0.9)._gbdt.models
    for ta, tb in zip(a, b):
        np.testing.assert_allclose(ta.leaf_value, tb.leaf_value, rtol=1e-6,
                                   atol=1e-9)


# ---- int8, narrowed, packed4, and the compact path without K2's histogram --

def _codes(n, f, b, dev, seed, qmax=5, skew=None):
    """Bins and the quantized channel quad (grad codes in [-qmax, qmax],
    the first half of the rows at -qmax, hess codes in [0, qmax], in-bag,
    raw), int8 on the card."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    bins = torch.randint(0, b, (n, f), generator=g, device=dev,
                         dtype=torch.uint8)
    if skew == "one_bin":
        bins[:] = (torch.arange(f, device=dev) * 37 % b).to(torch.uint8)
    gc = torch.randint(-qmax, qmax + 1, (n,), generator=g, device=dev)
    gc[: n // 2] = -qmax
    ch = torch.stack([gc, torch.randint(0, qmax + 1, (n,), generator=g,
                                        device=dev),
                      (torch.rand(n, generator=g, device=dev) > 0.2).long(),
                      torch.ones(n, dtype=torch.long, device=dev)], 1)
    return bins, ch.to(torch.int8)


@pytest.mark.parametrize("n,f,b,dtype", [
    (30_000, 28, 256, torch.int8), (100_000, 5, 128, torch.int32),
    (30_000, 60, 256, torch.int8), (3_000_000, 28, 256, torch.int8)])
def test_dense_int8_histogram_is_exact(dev, n, f, b, dtype):
    """K1's dense integer variant against its plain version: int32 sums,
    exactly equal, at F = 60 in two feature chunks too."""
    bins, ch = _codes(n, f, b, dev, seed=n + f, qmax=127)
    _kernels.reset_counts()
    kern = pallas_histogram(bins, ch.to(dtype), b, mode="int8")
    torch.cuda.synchronize()
    assert _kernels.MODE_LAUNCHES["histogram/int8"] == 1
    plain = pallas_histogram_plain(bins, ch, b, mode="int8")
    assert kern.dtype == torch.int32 and torch.equal(kern, plain)


@pytest.mark.parametrize("n,f,b", [(20_000, 28, 64), (400_000, 28, 63),
                                   (300_000, 5, 16)])
def test_sublane_int8_histogram_is_exact(dev, n, f, b):
    """K3's int32 accumulator on both of its paths (the small-data path up
    to 262,144 rows, the tile path above), exactly equal."""
    bins, ch = _codes(n, f, b, dev, seed=n, qmax=127)
    bt = bins.T.contiguous()
    _kernels.reset_counts()
    kern = pallas_histogram_sublane(bt, ch, b, mode="int8")
    torch.cuda.synchronize()
    assert _kernels.MODE_LAUNCHES["histogram_sublane/int8"] == 1
    plain = pallas_histogram_sublane_plain(bt, ch, b, mode="int8")
    assert kern.dtype == torch.int32 and torch.equal(kern, plain)


@pytest.mark.parametrize("n,f,qmax,skew", [
    (30_000, 28, 5, None), (3_000_000, 28, 5, "one_bin"),
    (500_000, 7, 31, None), (1_000_000, 28, 15, "one_bin")])
def test_narrow_histogram_is_exact(dev, n, f, qmax, skew):
    """K1 narrowed against its plain version and the 32-bit engine, bit for
    bit: negative grad sums, and skewed bins whose cells would carry
    without the flushes (every 32,767 / qmax rows of a block; one row a
    thread a tile at qmax 31)."""
    from lightgbm_tpu_torch.ops.pallas_histogram import (
        pallas_histogram_narrow, pallas_histogram_narrow_plain)
    bins, ch = _codes(n, f, 256, dev, seed=n + qmax, qmax=qmax, skew=skew)
    _kernels.reset_counts()
    kern = pallas_histogram_narrow(bins, ch, 256, qmax)
    torch.cuda.synchronize()
    assert _kernels.MODE_LAUNCHES["histogram/narrow"] == 1
    plain = pallas_histogram_narrow_plain(bins, ch, 256, qmax)
    assert torch.equal(kern, plain)
    assert torch.equal(kern, pallas_histogram_plain(bins, ch, 256, "int8"))


def _packed_records(n, f, b, dev, seed, packed4, quant):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    layout = RowLayout(num_features=f, num_extra=2, packed4=packed4)
    if quant:
        gr = torch.randint(-5, 6, (n,), generator=g, device=dev).float()
        hs = torch.randint(0, 6, (n,), generator=g, device=dev).float()
    else:
        gr = torch.randint(-64, 65, (n,), generator=g, device=dev) / 64.0
        hs = torch.randint(1, 65, (n,), generator=g, device=dev) / 64.0
    work = pack_rows(
        torch.randint(0, b, (n, f), generator=g, device=dev,
                      dtype=torch.uint8), gr, hs,
        (torch.rand(n, generator=g, device=dev) > 0.2).float(),
        torch.randn(2, n, generator=g, device=dev), layout)
    return layout, work


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8, torch.int32])
@pytest.mark.parametrize("packed4", [False, True])
def test_segment_gather_matches_plain(dev, dtype, packed4):
    from lightgbm_tpu_torch.ops.pallas_histogram import (
        segment_gather, segment_gather_plain)
    layout, work = _packed_records(50_000, 29, 16, dev, 3, packed4,
                                   dtype != torch.float32)
    scratch = work.flip(0).contiguous()
    for seg in ([123, 40_000, 1], [49_990, 500, 0], [0, 0, 0]):
        s = torch.tensor(seg, dtype=torch.int32, device=dev)
        _kernels.reset_counts()
        ch, bt = segment_gather(work, scratch, s, layout, dtype, True)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["segment_gather"] == 1
        pch, pbt = segment_gather_plain(work, scratch, s, layout, dtype, True)
        c = min(seg[1], 50_000 - seg[0])
        assert torch.equal(ch[:c], pch[:c])
        assert torch.equal(bt[:, :c], pbt[:, :c])


@pytest.mark.parametrize("layout_name,quant,narrow,packed4", [
    ("lane", False, 0, False), ("lane", True, 0, False),
    ("lane", True, 5, False), ("lane", True, 5, True),
    ("sublane", False, 0, True), ("sublane", True, 0, False)])
def test_unfused_histogram_matches_plain(dev, layout_name, quant, narrow,
                                         packed4):
    """The unfused path's histogram of a segment on the device (the gather,
    then K1 dense or K3 bounded by the device count) against the plain
    segment histogram: int32 exact, f32 exact on 1/64-grid channels; the
    narrowed mode takes the 16-bit engine for the small segment only."""
    from lightgbm_tpu_torch.ops.compact import segment_histogram
    from lightgbm_tpu_torch.ops.pallas_histogram import unfused_histogram
    b = 16 if packed4 else 63
    layout, work = _packed_records(300_000, 28, b, dev, 5, packed4, quant)
    scratch = work.flip(0).contiguous()
    tally = torch.zeros(1, dtype=torch.int32, device=dev)
    for seg in ([1_000, 290_000, 0], [77, 5_000, 1], [3, 0, 0]):
        s = torch.tensor(seg, dtype=torch.int32, device=dev)
        tally.zero_()
        _kernels.reset_counts()
        kern = unfused_histogram(work, scratch, s, layout, b, quant, narrow,
                                 layout_name, tally)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES["segment_gather"] == 1
        name = "histogram" if layout_name == "lane" else "histogram_sublane"
        assert _kernels.LAUNCHES[name] == 1
        assert sum(_kernels.PLAIN_CALLS.values()) == 0
        plain = segment_histogram(scratch if seg[2] else work, seg[0],
                                  seg[1], layout, b, quant)
        assert kern.dtype == plain.dtype and torch.equal(kern, plain)
        small = 0 < seg[1] * 5 < (1 << 15) or seg[1] == 0
        assert int(tally) == (1 if narrow and small else 0)


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("dual", [True, False])
@pytest.mark.parametrize("mode,start,count,side,f", [
    (1, 0, 300_000, 0, 28), (0, 0, 300_000, 0, 28),
    (0, 37, 220_190, 1, 29), (0, 96, 128, 0, 7), (0, 13, 290_000, 1, 529)])
def test_fused_split_packed4(dev, mode, start, count, side, f, dual, quant):
    """K2 on nibble-packed records (the routing reads a nibble, K1's record
    loader unpacks two features a byte; odd F leaves a padding nibble)
    against its plain version: the records byte-equal, the histogram exact
    (int32, or f32 on 1/64-grid gradients)."""
    layout, parent = _packed_records(300_000, f, 16, dev, start + f, True,
                                     quant)
    _, other = _packed_records(300_000, f, 16, dev, start + 1, True, quant)
    feat, bin_ = f - 1, 9
    col = parent[start:start + count, feat >> 1].to(torch.int64)
    col = (col >> (4 * (feat & 1))) & 0xF
    n_left = int((col <= bin_).sum())
    args = (mode, start, count, n_left, feat, bin_, 0, 0, 0, None, layout,
            16)
    kw = {"side": side, "dual": dual, "quant": quant}
    arrays = (other, parent) if side and dual else (parent, other)
    _kernels.reset_counts()
    wk, sk, hk = fused_split(*(a.clone() for a in arrays), *args, **kw)
    wp, sp, hp = fused_split_plain(*(a.clone() for a in arrays), *args, **kw)
    torch.cuda.synchronize()
    assert _kernels.MODE_LAUNCHES["fused_split/packed4"] == 1
    assert _kernels.MODE_LAUNCHES["histogram/packed4"] == 1
    assert torch.equal(wk, wp) and torch.equal(sk, sp)
    assert hk.dtype == hp.dtype and torch.equal(hk, hp)
    # the same rows, in the same order, as on u8 records
    u8 = RowLayout(num_features=f, num_extra=2)
    assert layout.moved_cols <= u8.moved_cols


def test_fused_split_partition_alone(dev):
    """``hist=False``: K2's prep and partition (and the copy-back) only, the
    records as the full split leaves them, the histogram's segment on the
    device."""
    layout, parent = _packed_records(300_000, 28, 63, dev, 9, False, True)
    col = parent[1000:251_000, 3].to(torch.int64)
    n_left = int((col <= 30).sum())
    args = (0, 1000, 250_000, n_left, 3, 30, 0, 0, 0, None, layout, 63)
    kw = {"side": 0, "dual": False, "quant": True}
    _kernels.reset_counts()
    wk, sk, seg = fused_split(parent.clone(), torch.zeros_like(parent), *args,
                              hist=False, **kw)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["histogram"] == 0
    assert _kernels.MODE_LAUNCHES["fused_split/partition"] == 1
    wp, sp, pseg = fused_split_plain(parent.clone(), torch.zeros_like(parent),
                                     *args, hist=False, **kw)
    assert torch.equal(wk, wp)
    assert seg.tolist() == pseg.tolist()


def _count_tree_syncs(monkeypatch):
    """Host syncs inside every compact tree after the first (torch's sync
    debug mode), into the returned list."""
    from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
    import warnings
    real = gbdt_mod.grow_tree_compact
    counts = []

    def counted(*a, **kw):
        if not counts and not getattr(counted, "warm", False):
            counted.warm = True
            return real(*a, **kw)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = real(*a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.append(sum("called a synchronizing" in str(w.message)
                          for w in caught))
        return out
    monkeypatch.setattr(gbdt_mod, "grow_tree_compact", counted)
    return counts


@pytest.mark.parametrize("case", ["f32", "quant", "narrow", "sublane",
                                  "pack4", "pack4_unfused"])
def test_unfused_and_packed_train_on_card_matches_cpu(dev, case,
                                                      monkeypatch):
    """The compact grower without the fused kernel (K2's partition alone,
    the gather, K1 dense or K3) and on packed records, card against CPU:
    quantized runs grow equal trees, f32 runs predict within 1e-4; an
    unfused tree makes no host sync; no plain version runs on the card."""
    rng = np.random.RandomState(4)
    X = rng.randn(20_000, 7).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 3] + 0.3 * rng.randn(20_000) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
         "tpu_grower": "compact", "tpu_fused": "off"}
    quant = {"use_quantized_grad": True, "stochastic_rounding": False}
    p.update({"f32": {}, "quant": quant,
              "narrow": dict(quant, tpu_quant_hist_bits=16),
              "sublane": dict(quant, tpu_hist_layout="sublane", max_bin=63),
              "pack4": dict(quant, tpu_fused="auto", tpu_bin_pack4=True,
                            max_bin=15),
              "pack4_unfused": dict(tpu_bin_pack4=True, max_bin=15)}[case])
    syncs = _count_tree_syncs(monkeypatch)
    _kernels.reset_counts()
    bg = lgt.train(dict(p, device_type="cuda"), lgt.Dataset(X, y), 3)
    launches = dict(_kernels.LAUNCHES)
    modes = dict(_kernels.MODE_LAUNCHES)
    plain = dict(_kernels.PLAIN_CALLS)
    card_syncs = list(syncs)
    monkeypatch.undo()
    bc = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y), 3)
    assert sum(plain.values()) == 0
    assert card_syncs == [0, 0]
    gp = bg._gbdt.grower_params
    assert gp.fused == (case == "pack4")
    assert bg._gbdt.layout.packed4 == case.startswith("pack4")
    if gp.fused:
        assert launches["fused_split"] == modes["fused_split/packed4"] \
            == 3 * 31
    else:
        assert launches["fused_split"] == modes["fused_split/partition"] \
            == 3 * 30
        assert launches["segment_gather"] == 3 * 31
        hist = "histogram_sublane" if case == "sublane" else "histogram"
        assert launches[hist] == 3 * 31
    if case == "narrow":
        assert modes["histogram/narrow"] == 3 * 31
        # the last tree: the kernel's own choice equals the CPU's
        narrowed = [int(b._gbdt.tree_stats["narrowed_leaves"])
                    for b in (bg, bc)]
        assert 0 < narrowed[0] == narrowed[1] < 31
    if case == "f32" or case == "pack4_unfused":
        np.testing.assert_allclose(bg.predict(X), bc.predict(X), atol=1e-4)
        return
    for a, b in zip(bg._gbdt.models, bc._gbdt.models):
        n = a.num_nodes
        assert b.num_nodes == n
        np.testing.assert_array_equal(a.split_feature[:n], b.split_feature[:n])
        np.testing.assert_array_equal(a.split_bin[:n], b.split_bin[:n])
    np.testing.assert_allclose(bg.predict(X), bc.predict(X), atol=1e-5)


# ---- 16-bit bins (max_bin > 255): K1's wide-bin kernel, TreeSHAP on
# uint16 rows ----
@pytest.mark.parametrize("n,f,b,k,mode", [
    (300_000, 28, 1024, 3, "f32"), (50_000, 7, 4096, 3, "f32"),
    (40_000, 3, 40_000, 2, "f32"), (20_000, 2, 65_536, 1, "f32"),
    (5_000, 70, 300, 8, "bf16")])
def test_dense_histogram_u16(dev, n, f, b, k, mode):
    """K1's wide-bin kernel against its plain version, bit-equal on 1/64-
    grid channels: feature chunks, channel chunks and bin ranges over the
    grid, bins from 32,768 up (negative in the int16 view), a bin holding a
    tenth of the rows, bins >= B dropped, rows with zero channels."""
    from lightgbm_tpu_torch.ops.packed import bins_to_device
    rng = np.random.RandomState(n)
    bins = rng.randint(0, min(b + 50, 65_536), (n, f)).astype(np.uint16)
    bins[:n // 10, 0] = min(b - 1, 40_000)
    ch = np.round(rng.randn(n, k) * 64) / 64
    ch[rng.rand(n) < 0.3] = 0.0
    tb = bins_to_device(bins, dev)
    tc = torch.from_numpy(ch.astype(np.float32)).to(dev)
    _kernels.reset_counts()
    kern = pallas_histogram(tb, tc, b, mode=mode)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["histogram"] == 1
    assert _kernels.MODE_LAUNCHES["histogram/u16"] == 1
    assert _kernels.PLAIN_CALLS["histogram"] == 0
    plain = pallas_histogram_plain(tb, tc, b, mode)
    assert torch.equal(kern, plain)
    if b > 32_768:
        assert float(kern[0, min(b - 1, 40_000)].abs().sum()) > 0


def test_wide_bins_train_on_card_matches_cpu(dev):
    """max_bin=1023 on the card: the masked grower, K1's wide-bin kernel
    once for the root and once a split (no other kernel), predictions
    within 1e-4 of the CPU's, leaf indices equal, contributions through the
    16-bit TreeSHAP kernel against the same trees on the CPU."""
    rng = np.random.RandomState(8)
    n = 20_000
    X = rng.randn(n, 6).astype(np.float32)
    X[rng.rand(n, 6) < 0.05] = np.nan
    Z = np.nan_to_num(X)
    y = (Z[:, 0] - 0.5 * Z[:, 2] + 0.3 * rng.randn(n) > 0).astype(float)
    w = 1.0 + rng.rand(n)
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 1023,
         "verbosity": -1}
    _kernels.reset_counts()
    bg = lgt.train(dict(p, device_type="cuda"), lgt.Dataset(X, y, weight=w),
                   3)
    launches = dict(_kernels.LAUNCHES)
    modes = dict(_kernels.MODE_LAUNCHES)
    plain = dict(_kernels.PLAIN_CALLS)
    bc = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y, weight=w),
                   3)
    assert not bg._gbdt.use_compact and bg._gbdt.binned.dtype == torch.int16
    assert launches == {"histogram": 3 * 31, "fused_split": 0,
                        "histogram_sublane": 0, "monotone_walk": 0,
                        "treeshap": 0, "segment_gather": 0}
    assert modes["histogram/u16"] == 3 * 31
    assert sum(plain.values()) == 0
    np.testing.assert_allclose(bg.predict(X), bc.predict(X), atol=1e-4)
    np.testing.assert_array_equal(bg.predict(X, pred_leaf=True),
                                  _cpu_twin(bg).predict(X, pred_leaf=True))
    _kernels.reset_counts()
    phi = bg.predict(X[:3000], pred_contrib=True)
    assert _kernels.LAUNCHES["treeshap"] == 1
    assert _kernels.MODE_LAUNCHES["treeshap/u16"] == 1
    assert _kernels.PLAIN_CALLS["treeshap"] == 0
    g = bg._gbdt
    paths = build_shap_paths(g.models, g._pred_nan_arr.cpu().numpy(),
                             g.feature_is_categorical(), "cpu")
    _shap_close(torch.from_numpy(phi), torch.from_numpy(
        _cpu_twin(bg).predict(X[:3000], pred_contrib=True)), paths)


@pytest.mark.parametrize("nb", [300, 40_000])
def test_treeshap_kernel_u16_matches_plain(dev, nb):
    """The TreeSHAP kernel on uint16 rows (their int16 view) against its
    plain version, thresholds and bins past 32,768 included."""
    from lightgbm_tpu_torch.ops.packed import bins_to_device
    from torch_shap_trees import random_forest, random_rows
    models = random_forest(23, 5, nb)
    paths = build_shap_paths(models, np.full(5, nb - 1), np.zeros(5, bool),
                             dev)
    b = bins_to_device(random_rows(24, 3000, 5, nb), dev)
    assert b.dtype == torch.int16
    _kernels.reset_counts()
    kern = tree_shap(b, paths, 1)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["treeshap"] == 1
    assert _kernels.MODE_LAUNCHES["treeshap/u16"] == 1
    _shap_close(kern, tree_shap_plain(b, paths, 1), paths)

