"""``max_bin`` above 255 in the port against the JAX package, on the CPU.

Past 256 bins the JAX package stores bins as ``uint16``, skips EFB,
refuses the compact grower and trains on the masked grower, whose
histogram (``_hist_kernel``) sums any integer bins. The port keeps the
host matrix ``uint16`` and puts it on the device as an int16 view of the
same bytes (``ops/packed.py``); on a card K1's wide-bin kernel and the
16-bit TreeSHAP kernel read it, here their plain versions do:

* bin bounds and ``uint16`` matrices equal the JAX package's at
  ``max_bin`` 511 and 1023 and with ``max_bin_by_feature`` mixing narrow
  and wide features;
* K1's plain version on 16-bit bins equals the JAX kernel in interpret
  mode at B = 1024 (one row block), and numpy's ``add.at`` at B = 40,000
  and 65,536 with bins at and above 32,768, where the int16 view is
  negative;
* masked trees equal the JAX package's split for split, binary (1/64-grid
  gradients) and multiclass with categorical features, at
  ``max_bin=1023``; predictions, ``pred_leaf``, ``pred_contrib``, early
  stopping, ``refit`` and model text equal within the usual tolerances;
* ``tpu_grower=compact`` warns and trains masked;
* a booster trained on bins from 32,768 up routes rows as its reloaded
  text does on raw values.
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.io.dataset import BinnedDataset as JaxBinned
from lightgbm_tpu.objectives import BinaryLogloss as JaxBinary
from lightgbm_tpu.ops.pallas_histogram import \
    pallas_histogram as jax_pallas_histogram
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.io.dataset import BinnedDataset
from lightgbm_tpu_torch.objectives import BinaryLogloss
from lightgbm_tpu_torch.ops.packed import bin_values, bins_to_device, \
    gather_bin
from lightgbm_tpu_torch.ops.pallas_histogram import pallas_histogram
from lightgbm_tpu_torch.ops.split import go_left_pred

from test_torch_categorical import assert_same_trees

# one intra-op thread: the suite runs several workers on the machine's
# cores (see test_torch_multiclass.py)
torch.set_num_threads(1)

CPU = {"device_type": "cpu"}
BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 1023,
        "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1}


def _data(n=3000, f=6, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    X[rng.rand(n, f) < 0.03] = np.nan
    Z = np.nan_to_num(X)
    y = (Z[:, 0] - 0.5 * Z[:, 2] + 0.4 * Z[:, 4] * Z[:, 1]
         + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


@pytest.fixture
def dyadic(monkeypatch):
    """Binary gradients and hessians on a 1/64 grid in both packages: every
    histogram sum is exact in f32, so the trees cannot part on an order of
    summation."""
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


@pytest.mark.parametrize("kw", [
    {"max_bin": 511}, {"max_bin": 1023, "min_data_in_bin": 1},
    {"max_bin": 1023, "max_bin_by_feature": [1023, 15, 255, 511, 300, 2]}],
    ids=["511", "1023", "by_feature"])
def test_bins_equal_jax(kw):
    X, _ = _data()
    ours = BinnedDataset.construct(X, **kw)
    theirs = JaxBinned.construct(X, **kw)
    assert ours.max_num_bins == theirs.max_num_bins > 256
    assert ours.binned.dtype == theirs.binned.dtype == np.uint16
    np.testing.assert_array_equal(ours.binned, theirs.binned)
    assert int(ours.binned.max()) > 255
    assert ours.bundle_info is None
    for a, b in zip(ours.mappers, theirs.mappers):
        assert (a.num_bins, a.missing_type, a.default_bin) \
            == (b.num_bins, b.missing_type, b.default_bin)
        np.testing.assert_array_equal(a.bin_upper_bounds, b.bin_upper_bounds)


def test_a_wide_feature_past_max_bin_gives_16_bit_bins():
    """A ``max_bin_by_feature`` entry above ``max_bin`` widens the bin axis
    and the matrix to 16 bits; the JAX package keeps ``max_bin + 1`` and
    fails to bin that feature into its uint8 matrix."""
    X, y = _data()
    by = [511, 15, 255, 255, 255, 255]
    ds = BinnedDataset.construct(X, max_bin=255, max_bin_by_feature=by)
    assert ds.max_num_bins == 512 and ds.binned.dtype == np.uint16
    assert ds.binned[:, 0].max() > 255
    with pytest.raises(OverflowError):
        JaxBinned.construct(X, max_bin=255, max_bin_by_feature=by)
    bst = lgt.train(dict(BASE, max_bin=255, max_bin_by_feature=by, **CPU),
                    lgt.Dataset(X, y), 2)
    assert not bst._gbdt.use_compact and bst._gbdt.binned.dtype == torch.int16
    loaded = lgt.Booster(model_str=bst.model_to_string())
    np.testing.assert_allclose(bst.predict(X), loaded.predict(X), atol=1e-6)


def test_plain_histogram_matches_jax_interpret():
    """K1's plain version on 16-bit bins (their int16 view) against the JAX
    kernel in interpret mode at B = 1024, one row block; bins >= B drop."""
    rng = np.random.RandomState(0)
    n, f, b = 2048, 4, 1024
    bins = rng.randint(0, b + 40, (n, f)).astype(np.uint16)
    ch = (np.round(rng.randn(n, 3) * 64) / 64).astype(np.float32)
    theirs = np.asarray(jax_pallas_histogram(
        jnp.asarray(bins.astype(np.int32)), jnp.asarray(ch), b, mode="f32",
        interpret=True, row_block=n))
    _kernels.reset_counts()
    ours = pallas_histogram(bins_to_device(bins, "cpu"), torch.from_numpy(ch),
                            b, mode="f32")
    assert _kernels.PLAIN_CALLS["histogram"] == 1
    assert sum(_kernels.LAUNCHES.values()) == 0
    np.testing.assert_array_equal(ours.numpy(), theirs)


@pytest.mark.parametrize("b", [40_000, 65_536])
def test_plain_histogram_on_bins_past_32768(b):
    """Bins at and above 32,768 (negative in the int16 view) land in their
    own cells; bins >= B drop."""
    rng = np.random.RandomState(1)
    n, f = 5000, 3
    bins = rng.randint(0, 65_536, (n, f)).astype(np.uint16)
    bins[:100] = 32_768
    bins[100:200] = 65_535
    ch = (np.round(rng.randn(n, 2) * 64) / 64).astype(np.float32)
    want = np.zeros((f, b, 2), np.float64)
    for j in range(f):
        keep = bins[:, j] < b
        np.add.at(want[j], bins[keep, j].astype(np.int64), ch[keep])
    got = pallas_histogram(bins_to_device(bins, "cpu"), torch.from_numpy(ch),
                           b, mode="f32")
    assert got.shape == (f, b, 2)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    assert got[:, 32_768].abs().sum() > 0


def test_routing_reads_bins_past_32768():
    """The partition's predicate and prediction's gather widen the int16
    view without a sign error."""
    bins = np.array([[0, 32_767], [32_768, 40_000], [65_535, 1]], np.uint16)
    t = bins_to_device(bins, "cpu")
    assert t.dtype == torch.int16
    np.testing.assert_array_equal(bin_values(t).numpy(), bins)
    rows = torch.arange(3)[None, :]
    col = torch.tensor([[1, 1, 1]])
    np.testing.assert_array_equal(gather_bin(t, rows, col, False).numpy(),
                                  bins[:, 1][None])
    left = go_left_pred(t[:, 0], torch.tensor(32_768), torch.tensor(False),
                        torch.tensor(0), False, torch.zeros(1, dtype=torch.int32))
    np.testing.assert_array_equal(left.numpy(), [True, True, False])


def _assert_texts_equal(bj, bt):
    ours, theirs = bt.model_to_string(), bj.model_to_string()
    assert ours.split("end of trees")[0] == theirs.split("end of trees")[0]


def test_binary_masked_trees_equal_jax(dyadic):
    X, y = _data()
    Xv, _ = _data(600, seed=9)
    p = dict(BASE)
    bj = lgb.train(p, lgb.Dataset(X, label=y), 3)
    _kernels.reset_counts()
    tds = lgt.Dataset(X, y)
    bt = lgt.train(dict(p, **CPU), tds, 3)
    g = bt._gbdt
    assert not g.use_compact and g.grower_params.num_bins == 1024
    assert g.binned.dtype == torch.int16
    assert sum(_kernels.LAUNCHES.values()) == 0
    assert _kernels.PLAIN_CALLS["histogram"] == 3 * 15
    assert_same_trees(bj._gbdt.models, g.models, tds._inner, leaf_atol=0)
    assert max(int(m.split_bin[:m.num_nodes].max()) for m in g.models) > 255
    np.testing.assert_allclose(bt.predict(Xv), bj.predict(Xv), atol=1e-6)
    np.testing.assert_array_equal(bt.predict(Xv, pred_leaf=True),
                                  bj.predict(Xv, pred_leaf=True))
    np.testing.assert_allclose(bt.predict(Xv, pred_contrib=True),
                               bj.predict(Xv, pred_contrib=True), atol=1e-6)
    assert _kernels.PLAIN_CALLS["treeshap"] >= 1
    _assert_texts_equal(bj, bt)
    loaded = lgt.Booster(model_str=bt.model_to_string())
    np.testing.assert_allclose(loaded.predict(Xv), bt.predict(Xv), atol=1e-6)
    stop = {"pred_early_stop": True, "pred_early_stop_margin": 0.5,
            "pred_early_stop_freq": 1}
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True, **stop),
                               bj.predict(Xv, raw_score=True, **stop),
                               atol=1e-6)
    rt = bt.refit(Xv[:400], _data(600, seed=9)[1][:400])
    rj = bj.refit(Xv[:400], _data(600, seed=9)[1][:400])
    np.testing.assert_allclose(rt.predict(Xv), rj.predict(Xv), atol=1e-6)


def test_multiclass_masked_trees_equal_jax():
    rng = np.random.RandomState(5)
    n = 2400
    X = rng.randn(n, 5)
    X[:, 3] = rng.randint(0, 12, n)
    s = X[:, 0] - 0.5 * X[:, 1] + np.isin(X[:, 3], [1, 4, 8]) \
        + 0.3 * rng.randn(n)
    y = np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(np.float64)
    p = dict(BASE, objective="multiclass", num_class=3,
             min_data_per_group=20, cat_smooth=2.0)
    bj = lgb.train(p, lgb.Dataset(X, label=y, categorical_feature=[3]), 3)
    tds = lgt.Dataset(X, y, categorical_feature=[3])
    bt = lgt.train(dict(p, **CPU), tds, 3)
    assert not bt._gbdt.use_compact
    assert tds._inner.binned.dtype == np.uint16
    assert_same_trees(bj._gbdt.models, bt._gbdt.models, tds._inner)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)
    np.testing.assert_array_equal(bt.predict(X, pred_leaf=True),
                                  bj.predict(X, pred_leaf=True))
    # contributions against the reloaded text's host recursion on raw
    # values: the JAX package's may part where assert_same_trees allows a
    # sorted categorical split's mirror, which sends the categories absent
    # at its node the other way
    loaded = lgt.Booster(model_str=bt.model_to_string())
    np.testing.assert_allclose(bt.predict(X[:300], pred_contrib=True),
                               loaded.predict(X[:300], pred_contrib=True),
                               atol=1e-9)


def test_compact_request_warns_and_goes_masked(caplog):
    X, y = _data(1500)
    with caplog.at_level(logging.WARNING):
        bst = lgt.train(dict(BASE, tpu_grower="compact", verbosity=0, **CPU),
                        lgt.Dataset(X, y), 1)
    assert not bst._gbdt.use_compact
    assert any("tpu_grower=compact" in r.getMessage()
               and "masked grower" in r.getMessage() for r in caplog.records)


def test_bins_past_32768_route_as_raw_values():
    """A booster whose splits sit at bins from 32,768 up: its leaf indices
    and predictions by the depth-batched walk on the int16 view equal those
    of its reloaded text, routed on raw float64 values; its contributions
    add up to its raw scores."""
    rng = np.random.RandomState(2)
    n = 36_000
    X = rng.randn(n, 2).astype(np.float32)
    y = (X[:, 0] + 0.1 * rng.randn(n) > 1.6).astype(np.float64)
    p = dict(BASE, max_bin=36_000, min_data_in_bin=1, num_leaves=7)
    bst = lgt.train(dict(p, **CPU), lgt.Dataset(X, y), 2)
    g = bst._gbdt
    assert g.grower_params.num_bins == 36_001
    assert max(int(m.split_bin[:m.num_nodes].max()) for m in g.models) \
        >= 32_768
    Xq = X[:3000]
    loaded = lgt.Booster(model_str=bst.model_to_string())
    np.testing.assert_array_equal(bst.predict(Xq, pred_leaf=True),
                                  loaded.predict(Xq, pred_leaf=True))
    np.testing.assert_allclose(bst.predict(Xq), loaded.predict(Xq),
                               atol=1e-6)
    contrib = bst.predict(Xq[:500], pred_contrib=True)
    np.testing.assert_allclose(contrib.sum(1),
                               bst.predict(Xq[:500], raw_score=True),
                               atol=1e-5)


def test_treeshap_plain_on_16_bit_rows():
    """TreeSHAP's plain version reads the int16 view as the bins' values:
    thresholds and bins past 32,768 give the contributions of the same
    rows as int64 bins."""
    from lightgbm_tpu_torch.ops.treeshap_device import (build_shap_paths,
                                                        tree_shap)
    from torch_shap_trees import random_forest, random_rows
    nb = 40_000
    paths = build_shap_paths(random_forest(23, 5, nb), np.full(5, nb - 1),
                             np.zeros(5, bool), "cpu")
    rows = random_rows(24, 500, 5, nb)
    assert rows.dtype == np.uint16 and rows.max() >= 32_768
    wide = tree_shap(bins_to_device(rows, "cpu"), paths, 1)
    ref = tree_shap(torch.from_numpy(rows.astype(np.int64)), paths, 1)
    assert torch.equal(wide, ref)


def test_loaded_dump_equals_jax_and_the_trained_dump():
    """``dump_model`` of a 16-bit model read back from its text equals the
    JAX package's ``loaded_dump`` of that text, and the trained booster's
    dump in every field a loaded model holds (no internal weights or
    counts, no feature infos)."""
    from lightgbm_tpu.model_io import LoadedGBDT as JaxLoaded
    from lightgbm_tpu.model_io import loaded_dump as jax_loaded_dump
    X, y = _data(1500)
    bst = lgt.train(dict(BASE, **CPU), lgt.Dataset(X, y), 2)
    text = bst.model_to_string()
    loaded = lgt.Booster(model_str=text).dump_model()
    assert loaded == jax_loaded_dump(JaxLoaded(text))

    def agrees(a, b):
        if isinstance(a, dict):
            return all(k in b and agrees(v, b[k]) for k, v in a.items())
        if isinstance(a, list):
            return len(a) == len(b) and all(map(agrees, a, b))
        return a == b
    trained = bst.dump_model()
    assert agrees(loaded, trained)
    assert "internal_count" in trained["tree_info"][0]["tree_structure"]
