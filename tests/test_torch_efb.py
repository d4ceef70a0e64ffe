"""Exclusive Feature Bundling in the port (``lightgbm_tpu_torch.io.efb``,
the bundle-space scan and routing of the compact grower, K2's copy-back
variant) on the CPU against the JAX package.

The data are one-hot blocks (the generator of ``tests/test_efb.py``): 40
groups of 8 exclusive columns plus dense columns, 3,000 rows (1,500 in the
training cases). 40 groups, not fewer: the planner bundles only when at
least 256 features would share columns (``plan_bundles``' ``min_features``),
as in the JAX package.

* planning, the bundled matrix and ``unbundle`` are equal to the JAX
  package's, field for field and byte for byte;
* ``extend_hist_efb`` and ``apply_efb_bitset`` equal the JAX functions on
  random histograms (virtual rows within 1e-6 of the leaf totals' scale:
  the default bin is the total minus the range sum, summed in another
  order; bitsets equal);
* ``train`` with default parameters (bundling on) against both oracles, the
  JAX compact path without the fused kernel (``tpu_fused=off``: trees equal
  split for split in original feature ids and bins, predictions within
  1e-5) and the fused kernel in interpret mode, which the JAX package runs
  in its copy-back variant on bundled data (``tpu_fused=on``,
  ``tpu_fused_interpret=True``, one row block a contraction,
  ``tpu_hist_mbatch=1``, which keeps its interpret-mode program small: its
  hi/lo-bf16 histogram moves a gain in the fifth digit, so predictions
  within 1e-4), for binary, multiclass, a categorical passthrough column and
  a NaN-bearing dense column, two rounds;
* bundled against ``enable_bundle=False`` on the port, model text against
  the JAX package's, validation sets, and the unbundling fallbacks
  (``tpu_grower=masked``, and from the compact grower's row bound on, C1).
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.io import efb as jax_efb
from lightgbm_tpu.ops import split as jax_split
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
from lightgbm_tpu_torch.convert import booster_from_arrays, dataset_from_arrays
from lightgbm_tpu_torch.io import efb
from lightgbm_tpu_torch.ops.split import (SplitResult, apply_efb_bitset,
                                          extend_hist_efb)

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
        "verbosity": -1}


def _onehot_data(n=3000, groups=40, card=8, dense=4, seed=0, nan_col=False,
                 cat_col=False):
    """One-hot blocks plus ``dense`` Gaussian columns (``tests/test_efb.py``
    ``_onehot_data``); optionally NaNs in the first dense column and a
    categorical column of 6 codes appended last."""
    rng = np.random.RandomState(seed)
    cats = rng.randint(0, card, size=(n, groups))
    X = np.zeros((n, groups * card), np.float32)
    for g in range(groups):
        X[np.arange(n), g * card + cats[:, g]] = 1.0
    X = np.concatenate([X, rng.randn(n, dense).astype(np.float32)], axis=1)
    w = rng.randn(X.shape[1]) * 0.5
    score = X @ w + 0.4 * rng.randn(n)
    if cat_col:
        code = rng.randint(0, 6, n)
        score += np.array([0.8, -0.6, 0.1, 1.2, -1.0, 0.3])[code]
        X = np.concatenate([X, code[:, None].astype(np.float32)], axis=1)
    if nan_col:
        X[rng.rand(n) < 0.1, groups * card] = np.nan
    y = (score > 0).astype(np.float64)
    return X, y, score


def _assert_same_trees(tj, tt, leaf_rtol=2e-4, cat_feature=None):
    """Split for split in original feature ids and bins, leaf values within
    ``leaf_rtol`` (and 1e-5 absolute): a small leaf's sums are its parent's
    minus its sibling's, and a virtual feature's default bin is the leaf
    total minus its range, so f32 sums in another order cancel to a few
    1e-5 relative. With ``cat_feature``, a tree that splits on it may hold
    the exact mirror tie of the sorted categorical scan (its complement
    bitset with the children swapped, ``tests/test_torch_categorical.py``
    ``assert_same_trees``): then the same splits with the same gains (the
    callers hold the predictions)."""
    assert len(tj) == len(tt)
    for a, b in zip(tj, tt):
        n = a.num_nodes
        assert b.num_nodes == n and b.num_leaves == a.num_leaves
        fields = ("split_feature", "split_bin", "default_left", "left_child",
                  "right_child")
        if cat_feature is not None and (a.split_feature[:n]
                                        == cat_feature).any() and not all(
                np.array_equal(getattr(b, k)[:n], getattr(a, k)[:n])
                for k in fields):
            np.testing.assert_array_equal(np.sort(b.split_feature[:n]),
                                          np.sort(a.split_feature[:n]))
            np.testing.assert_allclose(np.sort(b.split_gain[:n]),
                                       np.sort(a.split_gain[:n]), rtol=1e-3)
            continue
        for name in fields:
            np.testing.assert_array_equal(getattr(b, name)[:n],
                                          getattr(a, name)[:n], err_msg=name)
        np.testing.assert_allclose(b.leaf_value[:n + 1], a.leaf_value[:n + 1],
                                   rtol=leaf_rtol, atol=1e-5)


# ---- planning and the bundled matrix --------------------------------------

def _conflicted_bins(n=20000, groups=40, card=8, seed=0):
    """``tests/test_efb.py:122``'s one-hot bins with a few rows a block
    holding a second hot feature."""
    rng = np.random.RandomState(seed)
    cats = rng.randint(0, card, size=(n, groups))
    X = np.zeros((n, groups * card), np.uint8)
    for g in range(groups):
        X[np.arange(n), g * card + cats[:, g]] = 1
    for g in range(groups):
        rows = rng.choice(n, size=n // 15000, replace=False)
        X[rows, g * card + rng.randint(0, card)] = 1
    return X


@pytest.mark.parametrize("case,rate", [("exclusive", 1e-4),
                                       ("conflicted", 0.0),
                                       ("conflicted", 1e-4)])
def test_plan_bundle_unbundle_match_reference(case, rate):
    if case == "exclusive":
        X, _, _ = _onehot_data()
        sb = (X[:, :320] > 0).astype(np.uint8)
    else:
        sb = _conflicted_bins()
    f = sb.shape[1]
    nbins = np.full(f, 2, np.int32)
    dbins = np.zeros(f, np.int32)
    ok = np.ones(f, bool)
    kw = dict(max_conflict_rate=rate, min_features=8)
    ours = efb.plan_bundles(sb, nbins, dbins, ok, **kw)
    theirs = jax_efb.plan_bundles(sb, nbins, dbins, ok, **kw)
    assert ours == theirs
    if case == "conflicted":
        # the bounded-conflict planner packs more than the exact one
        # (tests/test_efb.py:122)
        exact = efb.plan_bundles(sb, nbins, dbins, ok, max_conflict_rate=0.0,
                                 min_features=8)
        n_exact = sum(map(len, exact)) if exact else 0
        assert rate == 0.0 or sum(map(len, ours)) > n_exact
    if not ours:
        return
    info = efb.build_bundle_info(ours, nbins, f)
    jinfo = jax_efb.build_bundle_info(theirs, nbins, f)
    for name in info._fields:
        np.testing.assert_array_equal(np.asarray(getattr(info, name)),
                                      np.asarray(getattr(jinfo, name)),
                                      err_msg=name)
    out = efb.bundle_matrix(sb, info, dbins, rate)
    jout = jax_efb.bundle_matrix(sb, jinfo, dbins, rate)
    assert (out is None) == (jout is None)
    if out is None:
        return
    np.testing.assert_array_equal(out, jout)
    back = efb.unbundle(out, info, dbins, nbins)
    np.testing.assert_array_equal(back, jax_efb.unbundle(jout, jinfo, dbins,
                                                         nbins))
    if case == "exclusive":
        np.testing.assert_array_equal(back, sb)
    assert efb.conflict_allowance(info, len(sb), rate) == \
        jax_efb.conflict_allowance(jinfo, len(sb), rate)


def test_construct_matches_reference():
    """Dataset construction bundles as the JAX package does; a valid set
    built with ``reference=`` takes the training set's layout; the
    per-feature arrays stay per original feature."""
    X, y, _ = _onehot_data(nan_col=True)
    jds = lgb.Dataset(X[:2500], label=y[:2500])
    jdv = jds.create_valid(X[2500:], label=y[2500:])
    jds.construct()
    jdv.construct()
    tds = lgt.Dataset(X[:2500], y[:2500], params={"device_type": "cpu"})
    tdv = tds.create_valid(X[2500:], y[2500:])
    tds.construct()
    tdv.construct()
    for ours, theirs in ((tds._inner, jds._inner), (tdv._inner, jdv._inner)):
        assert ours.bundle_info is not None
        for name in ours.bundle_info._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(ours.bundle_info, name)),
                np.asarray(getattr(theirs.bundle_info, name)), err_msg=name)
        np.testing.assert_array_equal(ours.binned, np.asarray(theirs.binned))
        np.testing.assert_array_equal(ours.feature_num_bins(),
                                      theirs.feature_num_bins())
    assert tds._inner.binned.shape[1] == tds._inner.bundle_info.n_columns < 60
    assert len(tds._inner.feature_num_bins()) == X.shape[1]
    off = lgt.Dataset(X, y, params={"device_type": "cpu",
                                    "enable_bundle": False}).construct()
    assert off._inner.bundle_info is None
    assert off._inner.binned.shape == X.shape


# ---- the bundle-space scan --------------------------------------------------

def _efb_tuple(info, nbins, dbins):
    """The six scan-space arrays of both packages' ``_setup_efb`` (the
    port's ``EfbLayout``) for a layout of numerical features."""
    c = info.n_columns
    bundled = np.nonzero(info.offset_of >= 0)[0]
    return (np.concatenate([np.arange(c), info.col_of[bundled]]),
            np.concatenate([np.zeros(c, bool), np.ones(len(bundled), bool)]),
            np.concatenate([np.full(c, -1), info.offset_of[bundled]]),
            np.concatenate([np.zeros(c), nbins[bundled]]),
            np.concatenate([np.zeros(c), dbins[bundled]]),
            np.concatenate([np.full(c, -1), bundled]))


@pytest.mark.parametrize("seed,batch", [(0, ()), (1, (2,)), (2, (2,)),
                                        (3, (1,))])
def test_extend_hist_and_bitset_match_reference(seed, batch):
    rng = np.random.RandomState(seed)
    f = 300
    nbins = rng.randint(2, 6, f).astype(np.int32)
    dbins = np.array([rng.randint(0, k) for k in nbins], np.int32)
    bundles = [list(range(i, min(i + 30, f))) for i in range(0, 290, 30)]
    info = efb.build_bundle_info(bundles, nbins, f)
    ext = _efb_tuple(info, nbins, dbins)
    c, b, fb = info.n_columns, 256, len(np.nonzero(info.offset_of >= 0)[0])
    bmax = int(nbins[info.offset_of >= 0].max())
    hist = rng.randn(*batch, c, b, 4).astype(np.float32)
    hist[..., 2:] = rng.randint(0, 50, (*batch, c, b, 2))
    text = efb.EfbLayout(*(torch.from_numpy(a) if a.dtype == bool
                           else torch.from_numpy(a.astype(np.int64))
                           for a in ext))
    ours = extend_hist_efb(torch.from_numpy(hist), text, fb, bmax)
    jext = tuple(jnp.asarray(a.astype(np.int32) if a.dtype != bool else a)
                 for a in ext)
    hs = hist.reshape(-1, c, b, 4)
    theirs = np.stack([np.asarray(jax_split.extend_hist_efb(
        jnp.asarray(h), jext, fb, bmax)) for h in hs]).reshape(
        *batch, c + fb, b, 4)
    assert ours.shape == theirs.shape
    np.testing.assert_array_equal(ours[..., :c, :, :].numpy(),
                                  theirs[..., :c, :, :])
    # counts are exact; grad/hess of a default bin cancel a leaf total
    np.testing.assert_array_equal(ours[..., 2:].numpy(), theirs[..., 2:])
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=1e-3)

    # a winner on every kind of feature: stored columns keep their bitset,
    # bundled ones get their column's range bitset
    feats = np.array([0, c - 1, c, c + 7, c + fb - 1])
    bins = np.array([0, 3, 0, 1, 2])
    feats, bins = np.broadcast_to(feats, (*batch, 5)), \
        np.broadcast_to(bins, (*batch, 5))
    old = rng.randint(-2**31, 2**31 - 1, (*batch, 5, 8)).astype(np.int32)
    zeros = torch.zeros(feats.shape)
    sp = SplitResult(zeros, torch.from_numpy(feats.astype(np.int64)),
                     torch.from_numpy(bins.astype(np.int64)), zeros != 0,
                     zeros, zeros, zeros, zeros, torch.from_numpy(old),
                     zeros != 0)
    got = apply_efb_bitset(sp, text, c, b).cat_bitset
    for idx in np.ndindex(*feats.shape):
        jsp = jax_split.SplitResult(
            jnp.float32(0), jnp.int32(feats[idx]), jnp.int32(bins[idx]),
            jnp.bool_(False), *([jnp.float32(0)] * 4),
            jnp.asarray(old[idx].view(np.uint32)), jnp.bool_(False))
        want = np.asarray(jax_split.apply_efb_bitset(jsp, jext, c, b)
                          .cat_bitset).view(np.int32)
        np.testing.assert_array_equal(got[idx].numpy(), want)


# ---- training ---------------------------------------------------------------

_CASES = {
    "binary": (dict(), dict()),
    "multiclass": (dict(objective="multiclass", num_class=3), dict()),
    "categorical": (dict(), dict(cat_col=True)),
    "nan": (dict(), dict(nan_col=True)),
}
_ORACLES = {
    "xla": ({"tpu_fused": "off"}, 1e-5),
    "fused_copyback": ({"tpu_fused": "on", "tpu_fused_interpret": True,
                        "tpu_fused_block": 128, "tpu_hist_mbatch": 1}, 1e-4),
}


def _case_data(case):
    params, data_kw = _CASES[case]
    X, y, score = _onehot_data(n=1500, seed=3, **data_kw)
    if case == "multiclass":
        y = np.digitize(score, np.quantile(score, [1 / 3, 2 / 3])).astype(
            np.float64)
    cat = [X.shape[1] - 1] if data_kw.get("cat_col") else "auto"
    return dict(BASE, **params), X, y, cat


@pytest.mark.parametrize("oracle", sorted(_ORACLES))
@pytest.mark.parametrize("case", sorted(_CASES))
def test_train_matches_reference(case, oracle):
    """Default parameters: both packages bundle the one-hot columns and
    grow the same trees on the compact grower (the port: K2's copy-back
    variant; its plain version on the CPU)."""
    p, X, y, cat = _case_data(case)
    extra, tol = _ORACLES[oracle]
    rounds = 2
    jds = lgb.Dataset(X, label=y, categorical_feature=cat)
    bj = lgb.train(dict(p, **extra), jds, rounds)
    _kernels.reset_counts()
    tds = lgt.Dataset(X, y, categorical_feature=cat)
    bt = lgt.train(dict(p, device_type="cpu"), tds, rounds)
    gb = bt._gbdt
    assert tds._inner.bundle_info is not None
    assert jds._inner.bundle_info is not None
    assert gb.use_compact and gb._efb is not None
    assert not gb.grower_params.fused_dual
    assert gb.layout.num_features == tds._inner.bundle_info.n_columns
    if oracle == "fused_copyback":
        assert not bj._gbdt.grower_params.fused_dual
    k = 3 if case == "multiclass" else 1
    # a root histogram and one split a leaf, every tree
    assert _kernels.PLAIN_CALLS["fused_split"] == \
        rounds * k * p["num_leaves"]
    assert sum(_kernels.LAUNCHES.values()) == 0
    tt = gb.models
    # bundled splits happened, and are numerical on the original feature
    bundled = tds._inner.bundle_info.offset_of >= 0
    used = np.concatenate([t.split_feature[:t.num_nodes] for t in tt])
    assert bundled[used].any()
    cat_feature = X.shape[1] - 1 if case == "categorical" else None
    _assert_same_trees(bj._gbdt.models, tt, cat_feature=cat_feature)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=tol)
    if case == "categorical":
        assert (used == cat_feature).any()


def test_bundled_matches_unbundled_port():
    """Bundling is lossless on exclusive data: the port trains the same
    trees from the bundled and the dense matrix (the JAX package's
    ``test_lossless_vs_dense``, which compares mean predictions, held here
    split for split)."""
    X, y, _ = _onehot_data(seed=5)
    p = dict(BASE, device_type="cpu", tpu_grower="compact")
    on = lgt.train(p, lgt.Dataset(X, y), 4)
    off = lgt.train(dict(p, enable_bundle=False), lgt.Dataset(X, y), 4)
    assert on._gbdt._efb is not None and off._gbdt._efb is None
    assert off._gbdt.grower_params.fused_dual
    # the dense run sums a one-hot feature's bins directly, the bundled one
    # takes its default bin as the leaf total minus the range: f32
    # cancellation of a few 1e-4 relative in a small leaf
    _assert_same_trees(off._gbdt.models, on._gbdt.models, leaf_rtol=1e-3)
    np.testing.assert_allclose(on.predict(X), off.predict(X), atol=1e-4)
    np.testing.assert_array_equal(on._gbdt.feature_importance(),
                                  off._gbdt.feature_importance())


def test_model_text_matches_reference(tmp_path):
    """A bundled split is written as a numerical split on the original
    feature at its own bin's threshold: the JAX package's trees (bitsets on
    bundle columns included) carried across give its text line for line;
    the port's own model has the JAX model's tree structure and reloads
    within 1e-6."""
    X, y, _ = _onehot_data(seed=7, nan_col=True)
    p = dict(BASE, device_type="cpu")
    jds = lgb.Dataset(X, label=y)
    bj = lgb.train(dict(p, tpu_fused="off"), jds, 3)
    fields = ("split_feature", "split_bin", "default_left", "left_child",
              "right_child", "leaf_value", "leaf_depth", "split_gain",
              "leaf_weight", "leaf_count", "internal_value",
              "internal_weight", "internal_count", "cat_bitset")
    jtrees = bj._gbdt.models
    assert any(np.asarray(t.cat_bitset).any() for t in jtrees)
    trees = [dict({k: np.asarray(getattr(t, k)) for k in fields},
                  num_leaves=t.num_leaves, num_nodes=t.num_nodes,
                  shrinkage=t.shrinkage) for t in jtrees]
    ms = jds._inner.mappers
    carried = booster_from_arrays(
        trees, [m.bin_upper_bounds for m in ms], [m.nan_bin for m in ms],
        [m.missing_type for m in ms], [m.num_bins for m in ms],
        params=bj.params, value_ranges=[(m.min_value, m.max_value)
                                        for m in ms],
        feature_names=jds._inner.feature_names)
    theirs = bj.model_to_string()
    assert carried.model_to_string() == theirs
    assert "num_cat=0" in theirs and "cat_threshold" not in theirs
    np.testing.assert_allclose(carried.predict(X), bj.predict(X), atol=1e-6)

    bt = lgt.train(p, lgt.Dataset(X, y), 3)
    ours = bt.model_to_string()
    keys = ("num_leaves=", "num_cat=", "split_feature=", "threshold=",
            "decision_type=", "left_child=", "right_child=")
    lines = [(a, b) for a, b in zip(ours.split("\n"), theirs.split("\n"))
             if a.startswith(keys)]
    assert len(lines) == 3 * len(keys)
    for a, b in lines:
        assert a == b
    path = tmp_path / "m.txt"
    bt.save_model(str(path))
    back = lgt.Booster(model_file=str(path))
    np.testing.assert_allclose(back.predict(X), bt.predict(X), atol=1e-6)
    imp = bt._gbdt.feature_importance()
    assert imp.shape == (X.shape[1],) and imp.sum() == 3 * 14


def test_valid_sets_route_in_bundle_space():
    """Validation sets are stored in the bundle layout and routed through
    ``col_of`` with each node's bitset: their metrics equal the JAX
    package's and the scores equal predictions on the raw rows."""
    X, y, _ = _onehot_data(seed=9)
    Xv, yv = X[2400:], y[2400:]
    X, y = X[:2400], y[:2400]
    p = dict(BASE, metric="binary_logloss,auc")
    jev, tev = {}, {}
    jds = lgb.Dataset(X, label=y)
    bj = lgb.train(dict(p, tpu_fused="off"), jds, 4,
                   valid_sets=[jds.create_valid(Xv, label=yv)],
                   callbacks=[lgb.record_evaluation(jev)])
    tds = lgt.Dataset(X, y)
    tdv = tds.create_valid(Xv, yv)
    bt = lgt.train(dict(p, device_type="cpu"), tds, 4, valid_sets=[tdv],
                   callbacks=[lgt.record_evaluation(tev)])
    assert tdv._inner.bundle_info is tds._inner.bundle_info
    assert tdv._inner.binned.shape[1] == tds._inner.bundle_info.n_columns
    for metric in ("binary_logloss", "auc"):
        np.testing.assert_allclose(tev["valid_0"][metric],
                                   jev["valid_0"][metric], rtol=1e-5)
    vs = bt._gbdt.valid_sets[0]
    np.testing.assert_allclose(vs.score[0].numpy(),
                               bt.predict(Xv, raw_score=True), atol=1e-5)


def test_valid_set_outside_the_layout_raises():
    """A valid set whose rows break the bundles (two hot features of a
    group) stays dense, and adding it raises, as in the JAX package."""
    X, y, _ = _onehot_data(seed=11)
    Xv = X[:200].copy()
    Xv[:, :320] = 1.0
    yv = y[:200]
    jds = lgb.Dataset(X, label=y)
    jdv = jds.create_valid(Xv, label=yv)
    with pytest.raises(ValueError, match="bundle layout"):
        lgb.train(dict(BASE, tpu_fused="off"), jds, 1, valid_sets=[jdv])
    tds = lgt.Dataset(X, y, params={"device_type": "cpu"})
    tdv = tds.create_valid(Xv, yv)
    tdv.construct()
    assert tdv._inner.bundle_info is None
    with pytest.raises(ValueError, match="bundle layout"):
        lgt.train(dict(BASE, device_type="cpu"), tds, 1, valid_sets=[tdv])


def _masked_reference(X, y, rounds=2):
    p = dict(BASE, num_leaves=7, tpu_grower="masked")
    return lgb.train(p, lgb.Dataset(X, label=y), rounds)


def test_masked_grower_unbundles_with_a_warning(caplog):
    """``tpu_grower=masked`` cannot run bundles: the port unbundles the
    training and validation data with a warning and grows the JAX package's
    masked trees."""
    X, y, _ = _onehot_data(seed=13)
    tds = lgt.Dataset(X[:2500], y[:2500], params={"device_type": "cpu"})
    tdv = tds.create_valid(X[2500:], y[2500:])
    # built before training, the valid set takes the bundle layout
    tdv.construct()
    assert tdv._inner.bundle_info is not None
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        bt = lgt.train(dict(BASE, num_leaves=7, tpu_grower="masked",
                            device_type="cpu", verbosity=0), tds, 2,
                       valid_sets=[tdv])
    text = caplog.text
    assert "unbundling" in text and "validation set" in text
    assert not bt._gbdt.use_compact and bt._gbdt._efb is None
    assert tds._inner.bundle_info is None and tdv._inner.bundle_info is None
    assert tds._inner.binned.shape == (2500, X.shape[1])
    bj = _masked_reference(X[:2500], y[:2500])
    _assert_same_trees(bj._gbdt.models, bt._gbdt.models)


@pytest.mark.parametrize("grower", ["auto", "compact"])
def test_row_bound_takes_the_masked_grower(grower, monkeypatch, caplog):
    """C1: from the compact grower's row bound on (2^24, lowered here to
    2,000 rows) ``auto`` and ``compact`` train on the masked grower instead
    of raising; ``compact`` warns; bundled data is unbundled first; the
    trees equal the JAX package's masked trees on the same data."""
    monkeypatch.setattr(gbdt_mod, "_COMPACT_MAX_ROWS", 2000)
    X, y, _ = _onehot_data(seed=15)
    tds = lgt.Dataset(X, y)
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        bt = lgt.train(dict(BASE, num_leaves=7, tpu_grower=grower,
                            device_type="cpu", verbosity=0), tds, 2)
    assert not bt._gbdt.use_compact
    assert tds._inner.bundle_info is None
    assert "unbundling" in caplog.text
    assert ("fewer than 2000 rows" in caplog.text) == (grower == "compact")
    bj = _masked_reference(X, y)
    _assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    # below the bound the same data stays bundled on the compact grower
    monkeypatch.setattr(gbdt_mod, "_COMPACT_MAX_ROWS", 1 << 24)
    b2 = lgt.train(dict(BASE, num_leaves=7, tpu_grower=grower,
                        device_type="cpu"), lgt.Dataset(X, y), 1)
    assert b2._gbdt.use_compact and b2._gbdt._efb is not None


def test_dataset_from_arrays_takes_the_bundle_layout():
    """The JAX package's bundled dataset handed to the port unchanged
    (bundled matrix and layout) trains the JAX package's trees."""
    X, y, _ = _onehot_data(seed=17)
    p = dict(BASE, tpu_fused="off")
    jds = lgb.Dataset(X, label=y)
    bj = lgb.train(p, jds, 3)
    inner = jds._inner
    info = inner.bundle_info
    ms = inner.mappers
    ds = dataset_from_arrays(
        np.asarray(inner.binned), [m.bin_upper_bounds for m in ms],
        [m.nan_bin for m in ms], [m.missing_type for m in ms],
        [m.num_bins for m in ms], y, col_of=info.col_of,
        offset_of=info.offset_of, num_column_bins=info.num_column_bins)
    assert ds.num_total_features == X.shape[1]
    assert ds.bundle_info.n_columns == inner.binned.shape[1]
    from lightgbm_tpu_torch.boosting import create_boosting
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.objectives import BinaryLogloss
    cfg = Config(dict(BASE, device_type="cpu"))
    gbdt = create_boosting(cfg, ds, BinaryLogloss(cfg), torch.device("cpu"))
    assert gbdt.use_compact and gbdt._efb is not None
    for _ in range(3):
        gbdt.train_one_iter()
    _assert_same_trees(bj._gbdt.models, gbdt.models)
    with pytest.raises(ValueError, match="columns"):
        dataset_from_arrays(
            np.asarray(inner.binned)[:, 1:], [m.bin_upper_bounds for m in ms],
            [m.nan_bin for m in ms], [m.missing_type for m in ms],
            [m.num_bins for m in ms], y, col_of=info.col_of,
            offset_of=info.offset_of, num_column_bins=info.num_column_bins)
