"""Forced bin bounds (``forcedbins_filename``) in the port against the JAX
package, on the CPU.

The file is a JSON list of ``{"feature": i, "bin_upper_bound": [...]}``
(LightGBM's DatasetLoader::GetForcedBins); a forced feature's greedy fit
runs with the budget its forced bounds leave, and its bounds outside them
are thinned at evenly spaced positions (``io/binning.py``
``_find_bin_with_forced``). Bounds, bin matrices and trees equal the JAX
package's, after ``tests/test_engine.py::test_forced_bins_and_max_bin_by_
feature``; a feature with more bounds forced than ``max_bin`` allows keeps
the lowest ``max_bin - 1``; forced bounds mix with 16-bit bins.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.io.dataset import BinnedDataset as JaxBinned
from lightgbm_tpu.objectives import BinaryLogloss as JaxBinary
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.objectives import BinaryLogloss

from test_torch_categorical import assert_same_trees

# one intra-op thread (see test_torch_multiclass.py)
torch.set_num_threads(1)

CPU = {"device_type": "cpu"}


def _forced(tmp_path, entries):
    path = tmp_path / "forced.json"
    path.write_text(json.dumps(entries))
    return str(path)


@pytest.fixture
def dyadic(monkeypatch):
    """Binary gradients and hessians on a 1/64 grid in both packages."""
    jg, tg = JaxBinary.get_gradients, BinaryLogloss.get_gradients

    def jround(self, score):
        g, h = jg(self, score)
        return jnp.round(g * 64) / 64, jnp.maximum(jnp.round(h * 64), 1) / 64

    def tround(self, score, label, weight=None):
        g, h = tg(self, score, label, weight)
        return (torch.round(g * 64) / 64,
                torch.clamp(torch.round(h * 64), min=1) / 64)
    monkeypatch.setattr(JaxBinary, "get_gradients", jround)
    monkeypatch.setattr(BinaryLogloss, "get_gradients", tround)


def _data(n=2000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 4) * 10
    X[rng.rand(n) < 0.05, 2] = np.nan
    y = ((X[:, 0] > 3.3333) ^ (np.nan_to_num(X[:, 2]) > 7.25)).astype(float)
    return X, y


@pytest.mark.parametrize("entries,kw", [
    ([{"feature": 0, "bin_upper_bound": [3.3333]}], {}),
    ([{"feature": 0, "bin_upper_bound": [1.5, 3.3333, 8.0]},
      {"feature": 2, "bin_upper_bound": [7.25, 2.0]}], {"max_bin": 15}),
    # more bounds forced than max_bin allows: the lowest max_bin - 1 stay
    ([{"feature": 1, "bin_upper_bound": [float(v) for v in range(1, 10)]}],
     {"max_bin": 6}),
    ([{"feature": 3, "bin_upper_bound": [0.5, 5.0]}], {"max_bin": 1023}),
], ids=["one", "two_features", "over_budget", "wide"])
def test_forced_bounds_equal_jax(tmp_path, entries, kw):
    X, _ = _data()
    path = _forced(tmp_path, entries)
    ours = BinnedDataset.construct(X, forcedbins_filename=path, **kw)
    theirs = JaxBinned.construct(X, forcedbins_filename=path, **kw)
    assert ours.binned.dtype == theirs.binned.dtype
    np.testing.assert_array_equal(ours.binned, theirs.binned)
    for a, b in zip(ours.mappers, theirs.mappers):
        assert (a.num_bins, a.missing_type, a.default_bin) \
            == (b.num_bins, b.missing_type, b.default_bin)
        np.testing.assert_array_equal(a.bin_upper_bounds, b.bin_upper_bounds)
    for e in entries:
        bounds = ours.mappers[e["feature"]].bin_upper_bounds
        forced = sorted(e["bin_upper_bound"])[:kw.get("max_bin", 255) - 1]
        assert np.isin(forced, bounds).all()


def test_forced_bins_and_max_bin_by_feature(tmp_path, dyadic):
    """``tests/test_engine.py``'s case in both packages: the forced bound
    is a bin bound, the second feature keeps at most 5 bins, the trees are
    the JAX package's and classify the rows."""
    rng = np.random.RandomState(0)
    X = rng.rand(500, 2) * 10
    y = (X[:, 0] > 3.3333).astype(float)
    path = _forced(tmp_path, [{"feature": 0, "bin_upper_bound": [3.3333]}])
    dparams = {"forcedbins_filename": path, "max_bin_by_feature": [16, 4]}
    p = {"objective": "binary", "verbosity": -1, "num_leaves": 4,
         "min_data_in_leaf": 5, "forcedbins_filename": path}
    jds = lgb.Dataset(X, label=y, params=dparams)
    bj = lgb.train(p, jds, 5)
    tds = lgt.Dataset(X, y, params=dict(dparams, **CPU))
    bt = lgt.train(dict(p, **CPU), tds, 5)
    m0, m1 = tds._inner.mappers
    assert np.any(np.isclose(m0.bin_upper_bounds, 3.3333))
    assert m1.num_bins <= 5
    np.testing.assert_array_equal(tds._inner.binned, jds._inner.binned)
    assert_same_trees(bj._gbdt.models, bt._gbdt.models, tds._inner,
                      leaf_atol=0)
    assert ((bt.predict(X) > 0.5) == y).mean() > 0.99
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)


@pytest.mark.parametrize("max_bin", [63, 1023])
def test_forced_bins_train_equal_jax(tmp_path, dyadic, max_bin):
    """Trees on forced bounds equal the JAX package's, on byte and 16-bit
    bins; the model text holds the forced bound as a threshold."""
    X, y = _data()
    path = _forced(tmp_path, [{"feature": 0, "bin_upper_bound": [3.3333]},
                              {"feature": 2, "bin_upper_bound": [7.25]}])
    p = {"objective": "binary", "verbosity": -1, "num_leaves": 15,
         "max_bin": max_bin, "min_data_in_leaf": 20,
         "forcedbins_filename": path}
    bj = lgb.train(p, lgb.Dataset(X, label=y), 3)
    tds = lgt.Dataset(X, y)
    bt = lgt.train(dict(p, **CPU), tds, 3)
    assert tds._inner.binned.dtype == (np.uint8 if max_bin < 256
                                       else np.uint16)
    assert_same_trees(bj._gbdt.models, bt._gbdt.models, tds._inner,
                      leaf_atol=0)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)
    text = bt.model_to_string()
    assert text.split("end of trees")[0] \
        == bj.model_to_string().split("end of trees")[0]
    first = lgt.Booster(model_str=text)._gbdt.models[0]
    assert np.isclose(first.threshold, 7.25).any()
