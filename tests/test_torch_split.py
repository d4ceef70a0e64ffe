"""The port's split scan (lightgbm_tpu_torch.ops.split) against the JAX
package's numerical path of ``best_split`` on identical ``[F, B, 4]``
histograms with NaN bins, L1/L2 and ``max_delta_step``.

The winning feature, threshold bin and missing direction must be the same;
the gain and the left sums agree within rtol 1e-5 (the same f32 formula,
cumulative sums taken in another order). The histograms are random, so no
two candidates tie to that precision.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch.ops import split as tsplit

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

F, B = 6, 64


def _hist(seed, n=2000):
    """The histogram of n random rows, so every feature sees the same
    totals. NaN-missing features keep NaN in their last bin and send a
    share of the rows there; the others name a bin as their NaN bin
    (MissingType::None/Zero). The gradient depends on one feature's bins
    and on another's missingness, so both directions win somewhere."""
    rng = np.random.RandomState(seed)
    k = seed % F
    num_bins = rng.randint(8, B + 1, size=F)
    has_nan = rng.rand(F) < 0.6
    has_nan[k] = True
    nan_bin = np.where(has_nan, num_bins - 1,
                       rng.randint(0, num_bins)).astype(np.int32)
    bins = (rng.rand(n, F) * (num_bins - has_nan)).astype(np.int64)
    miss = has_nan & (rng.rand(n, F) < 0.15)
    bins = np.where(miss, num_bins - 1, bins)
    # odd seeds: feature k's missing rows belong with its low bins (missing
    # left wins); even seeds: another feature's missingness is the signal
    m = (k + 1) % F if seed % 2 == 0 else k
    sign = -1.0 if seed % 2 == 0 else 1.0
    g = (0.5 * rng.randn(n) + (bins[:, k] < num_bins[k] // 3)
         + sign * 1.2 * miss[:, m]).astype(np.float32)
    h = (0.1 + 0.15 * rng.rand(n)).astype(np.float32)
    inbag = (rng.rand(n) > 0.1).astype(np.float32)
    ch = np.stack([g * inbag, h * inbag, inbag, np.ones(n, np.float32)], 1)
    hist = np.zeros((F, B, 4), np.float64)
    for f in range(F):
        np.add.at(hist[f], bins[:, f], ch)
    return (hist.astype(np.float32), num_bins.astype(np.int32), nan_bin,
            has_nan)


PARAMS = [
    {},
    {"lambda_l1": 0.5},
    {"lambda_l2": 2.0},
    {"lambda_l1": 0.2, "lambda_l2": 1.0, "max_delta_step": 0.3},
    {"min_data_in_leaf": 60.0, "min_sum_hessian_in_leaf": 5.0},
    {"min_gain_to_split": 1.0, "max_delta_step": 0.05},
]


def _run(hist, num_bins, nan_bin, has_nan, feat_mask, kw):
    tot = hist[0].sum(axis=0)
    jp = jsplit.SplitParams(enable_sorted_cat=False, **kw)
    j = jsplit.best_split(
        jnp.asarray(hist), jnp.asarray(tot[0]), jnp.asarray(tot[1]),
        jnp.asarray(tot[2]), jnp.asarray(num_bins), jnp.asarray(nan_bin),
        jnp.asarray(has_nan), jnp.zeros(F, bool), jnp.asarray(feat_mask),
        jp)
    tp = tsplit.SplitParams(**kw)
    t = tsplit.best_split(
        torch.from_numpy(hist), torch.tensor(tot[0]), torch.tensor(tot[1]),
        torch.tensor(tot[2]), torch.from_numpy(num_bins),
        torch.from_numpy(nan_bin), torch.from_numpy(has_nan),
        torch.from_numpy(feat_mask), tp)
    return j, t


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("kw", PARAMS)
def test_best_split_matches(kw, seed):
    hist, num_bins, nan_bin, has_nan = _hist(seed)
    feat_mask = np.ones(F, bool)
    feat_mask[(seed + 3) % F] = False
    j, t = _run(hist, num_bins, nan_bin, has_nan, feat_mask, kw)
    if float(j.gain) <= 0.0:
        assert float(t.gain) <= 0.0
        return
    assert int(t.feature) == int(j.feature)
    assert int(t.bin) == int(j.bin)
    assert bool(t.default_left) == bool(j.default_left)
    np.testing.assert_allclose(float(t.gain), float(j.gain), rtol=1e-5)
    for name in ("left_grad", "left_hess", "left_count", "left_rows"):
        np.testing.assert_allclose(float(getattr(t, name)),
                                   float(getattr(j, name)), rtol=1e-5,
                                   atol=1e-4)


def test_batched_scan_equals_single_scans():
    """The port scans both children of a split in one call."""
    hs = [_hist(s) for s in (3, 4)]
    num_bins, nan_bin, has_nan = hs[0][1:]
    stack = np.stack([h[0] for h in hs])
    tots = stack[:, 0].sum(axis=1)
    p = tsplit.SplitParams(lambda_l2=1.0)
    args = (torch.from_numpy(num_bins), torch.from_numpy(nan_bin),
            torch.from_numpy(has_nan), torch.ones(F, dtype=torch.bool), p)
    both = tsplit.best_split(torch.from_numpy(stack),
                             torch.from_numpy(tots[:, 0]),
                             torch.from_numpy(tots[:, 1]),
                             torch.from_numpy(tots[:, 2]), *args)
    for i in range(2):
        one = tsplit.best_split(torch.from_numpy(stack[i]),
                                torch.tensor(tots[i, 0]),
                                torch.tensor(tots[i, 1]),
                                torch.tensor(tots[i, 2]), *args)
        for a, b in zip(both, one):
            assert torch.equal(a[i], b)


@pytest.mark.parametrize("kw", PARAMS)
def test_leaf_output_and_gain(kw):
    rng = np.random.RandomState(5)
    g = (rng.randn(50) * 10).astype(np.float32)
    h = (rng.rand(50) * 20).astype(np.float32)
    jp, tp = jsplit.SplitParams(**kw), tsplit.SplitParams(**kw)
    for jf, tf in ((jsplit.leaf_output, tsplit.leaf_output),
                   (jsplit.leaf_gain, tsplit.leaf_gain)):
        np.testing.assert_allclose(
            tf(torch.from_numpy(g), torch.from_numpy(h), tp).numpy(),
            np.asarray(jf(jnp.asarray(g), jnp.asarray(h), jp)), rtol=1e-6,
            atol=1e-7)
    np.testing.assert_allclose(
        tsplit.child_output(torch.from_numpy(g), torch.from_numpy(h),
                            torch.ones(50), tp).numpy(),
        np.asarray(jsplit.child_output(jnp.asarray(g), jnp.asarray(h),
                                       jnp.ones(50), jp)), rtol=1e-6,
        atol=1e-7)


def test_depth_gate_and_routing():
    gain = torch.tensor([1.0, 2.0])
    np.testing.assert_array_equal(
        tsplit.depth_gate(gain, torch.tensor([2, 3]), 3).numpy(),
        np.asarray(jsplit.depth_gate(jnp.asarray([1.0, 2.0]),
                                     jnp.asarray([2, 3]), 3)))
    assert torch.equal(tsplit.depth_gate(gain, torch.tensor(9), -1), gain)
    col = np.arange(256, dtype=np.int32)
    bits = np.zeros(8, np.uint32)
    bits[[0, 3, 7]] = [0x80000001, 0x00F00000, 0xFFFFFFFF]
    for args in ((40, True, 255, False), (40, False, 255, False),
                 (0, False, 0, True)):
        b, dl, nb, cat = args
        ref = np.asarray(jsplit.go_left_pred(
            jnp.asarray(col), jnp.asarray(b), jnp.asarray(dl),
            jnp.asarray(nb), jnp.asarray(cat), jnp.asarray(bits)))
        got = tsplit.go_left_pred(torch.from_numpy(col), b, dl, nb, cat,
                                  torch.from_numpy(bits.view(np.int32)))
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_left_rows_of_split(seed):
    hist, num_bins, nan_bin, has_nan = _hist(seed)
    for f in range(F):
        for dl in (False, True):
            b = int(num_bins[f]) // 2
            ref = jsplit.left_rows_of_split(
                jnp.asarray(hist), f, b, dl, int(nan_bin[f]), False,
                jnp.zeros(8, jnp.uint32))
            got = tsplit.left_rows_of_split(torch.from_numpy(hist), f, b, dl,
                                            int(nan_bin[f]))
            assert int(got) == int(ref)
