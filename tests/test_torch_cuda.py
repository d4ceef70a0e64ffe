"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a CUDA device every test skips. On a machine with
one (which need not have JAX), run

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Kernel and plain version get the same inputs on the card. The record arrays
must be byte-equal; histogram counts are exact and grad/hess agree within
1e-5 * sum |addends| per cell (f32 atomics add in another order).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.ops.compact import RowLayout, pack_rows
from lightgbm_tpu_torch.ops.fused_split import fused_split, fused_split_plain
from lightgbm_tpu_torch.ops.pallas_histogram import (pallas_histogram,
                                                     pallas_histogram_plain,
                                                     record_histogram,
                                                     record_histogram_plain)

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


@pytest.mark.parametrize("f", [5, 28])
def test_record_histogram(dev, f):
    layout, work = _records(30_000, f, 256, dev, seed=f)
    scratch = torch.zeros_like(work)
    seg = torch.tensor([123, 25_000, 0], dtype=torch.int32, device=dev)
    kern = record_histogram(work, scratch, seg, layout, 256)
    _close(kern, record_histogram_plain(work, scratch, seg, layout, 256),
           record_histogram_plain(_abs_grad(work, layout), scratch, seg,
                                  layout, 256))


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


@pytest.mark.parametrize("mode,start,count,side,smaller", [
    (0, 0, 30_000, 0, None), (0, 37, 22_190, 1, None), (0, 96, 128, 0, 1),
    (0, 500, 1, 1, None), (0, 200, 0, 0, None), (0, 11, 20_000, 0, 0),
    (1, 41, 23_000, 1, None)])
def test_fused_split(dev, mode, start, count, side, smaller):
    layout, parent = _records(30_000, 5, 256, dev, seed=start)
    _, other = _records(30_000, 5, 256, dev, seed=start + 1)
    feat, bin_ = 2, 100
    col = parent[start:start + count, feat].to(torch.int64)
    n_left = int((col <= bin_).sum())
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


def test_train_on_card_matches_cpu(dev):
    rng = np.random.RandomState(0)
    X = rng.randn(20_000, 6).astype(np.float32)
    X[rng.rand(*X.shape) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) - 0.5 * np.nan_to_num(X[:, 3])
         + 0.3 * rng.randn(20_000) > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
    _kernels.reset_counts()
    bg = lgt.train(dict(p, device_type="cuda"), lgt.Dataset(X, y), 3)
    launches = dict(_kernels.LAUNCHES)
    plain = dict(_kernels.PLAIN_CALLS)
    bc = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y), 3)
    assert launches["fused_split"] == 3 * 31
    assert launches["histogram"] == 3 * 31
    assert sum(plain.values()) == 0
    np.testing.assert_allclose(bg.predict(X), bc.predict(X), atol=1e-4)
