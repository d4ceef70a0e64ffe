"""Binning of the PyTorch port (lightgbm_tpu_torch.io) against the JAX
package's (lightgbm_tpu.io): bin bounds, NaN bins, missing types and the
uint8 bin matrix must be EXACTLY equal, since both run the same numpy
algorithm on the same input."""
import os

import numpy as np
import pytest

from lightgbm_tpu.io import dataset as jds
from lightgbm_tpu_torch.io import dataset as tds

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "binary_nan.npz")


def _data(n=3000, f=5, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[:, 1] = np.round(X[:, 1] * 3)            # few distinct values
    X[rng.rand(n) < 0.3, 2] = 0.0              # many zeros
    X[rng.rand(n) < 0.1, 3] = np.nan           # NaNs
    X[:, 4] = 1.5                              # constant column
    return X


def _both(X, **kw):
    a = jds.BinnedDataset.construct(X, enable_bundle=False, **kw)
    b = tds.BinnedDataset.construct(X, **kw)
    return a, b


def _assert_same(a, b):
    assert a.max_num_bins == b.max_num_bins
    assert a.used_features == b.used_features
    assert len(a.mappers) == len(b.mappers)
    for ma, mb in zip(a.mappers, b.mappers):
        assert ma.num_bins == mb.num_bins
        assert ma.missing_type == mb.missing_type
        assert ma.nan_bin == mb.nan_bin
        assert ma.default_bin == mb.default_bin
        np.testing.assert_array_equal(ma.bin_upper_bounds,
                                      mb.bin_upper_bounds)
    np.testing.assert_array_equal(a.binned, b.binned)
    assert b.binned.dtype == np.uint8
    np.testing.assert_array_equal(a.feature_num_bins(), b.feature_num_bins())
    np.testing.assert_array_equal(a.feature_nan_bins(), b.feature_nan_bins())


@pytest.mark.parametrize("max_bin", [15, 63, 255])
def test_random_data_with_nans_and_zeros(max_bin):
    a, b = _both(_data(), max_bin=max_bin)
    _assert_same(a, b)


@pytest.mark.parametrize("kw", [{"zero_as_missing": True},
                                {"use_missing": False},
                                {"min_data_in_bin": 20},
                                {"bin_construct_sample_cnt": 500}])
def test_binning_options(kw):
    a, b = _both(_data(n=2000, seed=1), max_bin=63, **kw)
    _assert_same(a, b)


def test_float32_input():
    X = _data(seed=2).astype(np.float32)
    a, b = _both(X, max_bin=255)
    _assert_same(a, b)


def test_golden_binary_nan():
    X = np.load(GOLDEN)["X"]
    a, b = _both(X, max_bin=255)
    _assert_same(a, b)


def test_validation_set_uses_reference_mappers():
    X = _data(seed=3)
    a, b = _both(X[:2000], max_bin=63)
    va = jds.BinnedDataset.construct(X[2000:], reference=a,
                                     enable_bundle=False)
    vb = tds.BinnedDataset.construct(X[2000:], reference=b)
    assert vb.mappers is b.mappers
    np.testing.assert_array_equal(va.binned, vb.binned)
