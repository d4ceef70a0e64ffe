"""The port's serving engines on the CPU, held against the port's own
plain paths and the JAX package's engines on the same inputs.

* device binning (``ops/device_bin.py``) equals the host's ``bin_matrix``
  and the JAX package's ``bin_rows_device`` exactly: NaN, +-0, zeros as
  missing, categorical codes out of range, 16-bit and 4-bit bins;
* the level engine equals the port's walk exactly, in leaves and in raw
  scores (it adds the walk's leaves in the walk's order), and its leaves
  equal the JAX package's ``predict_leaf_level``;
* ``quantize_leaves``' slabs and scales equal the JAX package's, and
  quantized scores lie within the recorded bound of the f32 scores;
* the tabled TreeSHAP's plain version lies within 1e-12 of a cell's scale
  of ``tree_shap_plain`` and within 1e-5 of the JAX package's
  ``shap_batched_tables`` (float32 there);
* the ladder helpers and the featurizer's state equal the JAX package's.

The trees are the port's, trained on the CPU (3 to 9 trees, at most 15
leaves): NaN defaults, zeros as missing, a categorical feature of 70
codes (three-word bitsets), EFB, K = 3 classes and 4-bit bins. The JAX
package's functions take them as they are (its ``stack_trees``,
``build_shap_paths`` and ``export_featurize_state`` read the same fields),
so both sides route the same trees.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lgt
from lightgbm_tpu.boosting.gbdt import stack_trees as jax_stack_trees
from lightgbm_tpu.io import binning as jax_binning
from lightgbm_tpu.ops import device_bin as jax_device_bin
from lightgbm_tpu.ops import predict as jax_predict
from lightgbm_tpu.ops import treeshap_device as jax_shap
from lightgbm_tpu_torch.boosting.gbdt import stack_trees
from lightgbm_tpu_torch.io import binning
from lightgbm_tpu_torch.io.dataset import pack4_matrix
from lightgbm_tpu_torch.ops import predict
from lightgbm_tpu_torch.ops.device_bin import (bin_rows_device,
                                               device_bin_state)
from lightgbm_tpu_torch.ops.treeshap_device import (
    build_shap_paths, build_shap_tables, shap_table_bytes,
    shap_table_bytes_read, tree_shap_plain, tree_shap_tables_plain)

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

CASES = ["nan", "zero", "categorical", "efb", "multiclass", "pack4"]
_MODELS = {}


def case_model(case):
    """``(booster, X)`` of a case, trained once a module."""
    if case in _MODELS:
        return _MODELS[case]
    rng = np.random.RandomState(11)
    n, f = 2000, 6
    X = rng.randn(n, f)
    z = X[:, 0] - 0.5 * X[:, 2] + 0.4 * X[:, 3] + 0.3 * rng.randn(n)
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 10,
         "verbosity": -1, "device_type": "cpu"}
    kw, rounds = {}, 5
    if case in ("nan", "zero", "pack4"):
        X[rng.rand(n) < 0.15, 1] = np.nan
        X[rng.rand(n) < 0.15, 3] = np.nan
        X[rng.rand(n) < 0.2, 4] = 0.0
    if case == "zero":
        p["zero_as_missing"] = True
    if case == "pack4":
        p.update(max_bin=15, tpu_bin_pack4=True)
    if case == "categorical":
        X[:, 5] = rng.randint(0, 70, n)
        X[:, 4] = rng.randint(0, 3, n)
        z = z + np.isin(X[:, 5], [1, 4, 9, 33, 40, 65]) \
            - 0.8 * np.isin(X[:, 5], [2, 50, 61])
        kw = {"categorical_feature": [4, 5]}
        p.update(max_cat_threshold=64, cat_smooth=1.0, min_data_per_group=5)
    if case == "efb":
        groups, card = 36, 8
        cats = rng.randint(0, card, size=(n, groups))
        X = np.zeros((n, groups * card))
        for g in range(groups):
            X[np.arange(n), g * card + cats[:, g]] = 1.0
        X = np.concatenate([X, rng.randn(n, 3)], axis=1)
        z = X @ (rng.randn(X.shape[1]) * 0.5) + 0.4 * rng.randn(n)
        p["num_leaves"] = 7
        rounds = 4
    y = (z > 0).astype(np.float64)
    if case == "multiclass":
        y = np.digitize(z, [-0.6, 0.6]).astype(np.float64)
        p.update(objective="multiclass", num_class=3)
        rounds = 3
    bst = lgt.train(p, lgt.Dataset(X, y, **kw), rounds)
    if case == "efb":
        assert bst._gbdt._efb is not None
    if case == "categorical":
        assert max(m.cat_bitset.shape[1] for m in bst._gbdt.models) >= 3
    _MODELS[case] = (bst, X)
    return bst, X


def edge_rows(bst, X, n=300, seed=3):
    """float32 rows: the case's own, then NaN, +0, -0, huge and infinite
    values, and categorical codes out of range, negative or fractional."""
    rng = np.random.RandomState(seed)
    rows = X[rng.randint(0, len(X), n)].astype(np.float32)
    f = rows.shape[1]
    specials = np.array([np.nan, 0.0, -0.0, 1e38, -1e38, np.inf, -np.inf,
                         2.0 ** 31, -(2.0 ** 31) - 1e3, 69.0, 70.0, 1e10,
                         -1.0, -0.5, 2.5, 3.0], np.float32)
    for j in range(f):
        rows[j::f + 1, j] = specials[rng.randint(0, len(specials),
                                                 len(rows[j::f + 1]))]
    return rows


@pytest.mark.parametrize("case", CASES)
def test_device_binning_matches_bin_matrix_and_jax(case):
    bst, X = case_model(case)
    g = bst._gbdt
    rows = edge_rows(bst, X)
    n, rung = len(rows), 512
    host = g.bin_matrix(rows)
    padded = np.zeros((rung, host.shape[1]), host.dtype)
    padded[:n] = host
    if g._pred_pack4:
        padded = pack4_matrix(padded)
    raw = np.zeros((rung, rows.shape[1]), np.float32)
    raw[:n] = rows
    raw[n:] = 7.0                   # padding rows' bins come out 0
    state = binning.export_featurize_state(g.mappers)
    ours = bin_rows_device(torch.from_numpy(raw),
                           device_bin_state(state, "cpu"), n,
                           packed=g._pred_pack4).numpy()
    np.testing.assert_array_equal(ours, padded)
    # the GBDT's featurizer pads to the auto ladder's first rung, 1,024
    full = g.featurize_rung(rows).numpy()
    assert full.shape[0] == 1024
    np.testing.assert_array_equal(full[:rung], padded)
    assert not full[rung:].any()
    jstate = jax_device_bin.device_bin_state(
        jax_binning.export_featurize_state(g.mappers))
    theirs = np.asarray(jax_device_bin.bin_rows_device(
        jnp.asarray(raw), jstate, np.int32(n), out_dtype="uint8",
        packed=g._pred_pack4))
    np.testing.assert_array_equal(ours, theirs)


def test_featurizer_state_and_16_bit_bins_match_jax():
    """The exported state equals the JAX package's; ``round_down_f32``
    keeps every float32 comparison of a float64 bound; 16-bit bins come
    out as the int16 view of the host's uint16 bins."""
    rng = np.random.RandomState(5)
    b = np.concatenate([rng.randn(500) * 10 ** rng.uniform(-30, 30, 500),
                        [np.inf, -np.inf, 1e300, -1e300, 0.0]])
    np.testing.assert_array_equal(binning.round_down_f32(b),
                                  jax_binning.round_down_f32(b))
    t = binning.round_down_f32(b).astype(np.float64)
    v = rng.randn(2000).astype(np.float32) * 1e3
    assert np.array_equal(v[:, None] > b[None, :500],
                          v[:, None].astype(np.float64) > t[None, :500])
    for case in ("nan", "categorical"):
        g = case_model(case)[0]._gbdt
        ours = binning.export_featurize_state(g.mappers)
        theirs = jax_binning.export_featurize_state(g.mappers)
        for name in ("bounds32", "nan_bins", "is_cat", "cat_keys",
                     "cat_vals"):
            np.testing.assert_array_equal(getattr(ours, name),
                                          getattr(theirs, name))
    X = rng.randn(3000, 3)
    wide = lgt.train({"objective": "regression", "max_bin": 1000,
                      "verbosity": -1, "device_type": "cpu",
                      "num_leaves": 4}, lgt.Dataset(X, X[:, 0]), 1)
    g = wide._gbdt
    rows = X[:200].astype(np.float32)
    host = g.bin_matrix(rows)
    assert host.dtype == np.uint16 and host.max() > 255
    dev = bin_rows_device(torch.from_numpy(rows), device_bin_state(
        binning.export_featurize_state(g.mappers), "cpu"), 200, wide=True)
    assert dev.dtype == torch.int16
    np.testing.assert_array_equal(dev.numpy().view(np.uint16), host)


def _window(g, case):
    """The case's trees, a window of them for the binary case."""
    models = g._model_window(3, 1) if case == "nan" else list(g.models)
    return models


@pytest.mark.parametrize("case", CASES)
def test_level_engine_equals_walk(case):
    """Leaves equal the walk's; raw scores equal bit for bit, with early
    stopping too; and through the booster (``tpu_predict_engine=level``
    against ``batched``), prediction windows included."""
    bst, X = case_model(case)
    g = bst._gbdt
    rows = edge_rows(bst, X)
    b = g._pred_bins(g.bin_matrix(rows))
    packed = g._pred_pack4
    models = _window(g, case)
    trees = stack_trees(models, "cpu", g.feature_is_categorical())
    depth = max(m.max_depth for m in models)
    level = predict.build_level_layout(trees, g._pred_nan_arr, depth)
    walk_leaves = predict.predict_leaf_batched(b, trees, g._pred_nan_arr,
                                               depth, packed)
    assert torch.equal(predict.predict_leaf_level(b, level, 4, packed),
                       walk_leaves)
    k = g.num_class
    for stop in ({}, {"early_stop_margin": 0.3, "early_stop_freq": 1}):
        walk = predict.predict_raw_batched(b, trees, g._pred_nan_arr, depth,
                                           tbatch=4, num_class=k,
                                           packed=packed, **stop)
        lvl = predict.predict_raw_level(b, level, trees.leaf_value,
                                        tbatch=4, num_class=k,
                                        packed=packed, **stop)
        assert torch.equal(walk, lvl)
    window = dict(start_iteration=1, num_iteration=2)
    want = [bst.predict(rows, raw_score=True, **window),
            bst.predict(rows, pred_leaf=True, **window)]
    bst.reset_parameter({"tpu_predict_engine": "level"})
    try:
        got = [bst.predict(rows, raw_score=True, **window),
               bst.predict(rows, pred_leaf=True, **window)]
        assert g._serving_engine("level", g._device_trees_entry(
            2, 1)["depth"]) == "level"
    finally:
        bst.reset_parameter({"tpu_predict_engine": "batched"})
    for a, c in zip(want, got):
        np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("case", ["nan", "categorical", "efb", "pack4"])
def test_level_leaves_match_jax(case):
    """The port's level engine and the JAX package's ``predict_leaf_level``
    on the same trees and bins give the same leaves."""
    bst, X = case_model(case)
    g = bst._gbdt
    rows = edge_rows(bst, X)
    host = g.bin_matrix(rows)
    b = g._pred_bins(host)
    models = list(g.models)
    t = len(models)
    max_lv = max(len(m.leaf_value) for m in models)
    depth = max(m.max_depth for m in models)
    ours = g._level_state(g._device_trees_entry())
    leaves = predict.predict_leaf_level(b, ours, 4, g._pred_pack4)
    tb = 4
    jst = jax_stack_trees(models, max_lv - 1, max_lv,
                          pad_to=predict.tree_bucket(t, tb))
    nan = jnp.asarray(g._pred_nan_arr.numpy().astype(np.int32))
    cat = jnp.asarray(g.feature_is_categorical())
    jlevel = jax_predict.build_level_layout(jst, nan, cat, depth)
    jb = jnp.asarray(pack4_matrix(host) if g._pred_pack4 else host)
    theirs = np.asarray(jax_predict.predict_leaf_level(
        jb, jlevel, depth=depth, tbatch=tb,
        any_cat=bool(g.feature_is_categorical().any()),
        packed=g._pred_pack4))[:t]
    np.testing.assert_array_equal(leaves.numpy(), theirs)


@pytest.mark.parametrize("mode", ["int8", "f16"])
def test_quantize_leaves_matches_jax_and_keeps_its_bound(mode):
    bst, X = case_model("multiclass")
    g = bst._gbdt
    c = g._device_trees_entry()
    t, k = c["t_real"], g.num_class
    lv = c["st"].leaf_value[:t]
    cids = torch.arange(t) % k
    slab, scale, bound = predict.quantize_leaves(lv, cids, mode, k)
    jslab, jscale, jbound = jax_predict.quantize_leaves(
        jnp.asarray(lv.numpy()), jnp.asarray(cids.numpy().astype(np.int32)),
        mode, num_class=k)
    np.testing.assert_array_equal(slab.numpy(), np.asarray(jslab))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    np.testing.assert_allclose(bound, float(jbound), rtol=1e-6)
    assert bound > 0
    rows = edge_rows(bst, X)
    f32 = bst.predict(rows, raw_score=True)
    bst.reset_parameter({"tpu_leaf_quant": mode})
    try:
        assert g.leaf_quant_bound() == bound
        q = bst.predict(rows, raw_score=True)
        served, n = bst.predict_serving(rows, raw_score=True)
    finally:
        bst.reset_parameter({"tpu_leaf_quant": "off"})
    np.testing.assert_array_equal(served[:n], q)
    # f32 sums round at each of the t adds on both sides
    slack = t * np.finfo(np.float32).eps * (np.abs(f32).max() + bound)
    assert 0 < np.abs(q - f32).max() <= bound + slack
    assert g.leaf_quant_bound() is None


@pytest.mark.parametrize("case", CASES)
def test_tabled_treeshap_matches_plain(case):
    """The tables' plain version against the loop's plain version: within
    1e-12 of each cell's |value| plus its bound on the |addends|; the
    budget counts 8 bytes a weight."""
    bst, X = case_model(case)
    g = bst._gbdt
    rows = edge_rows(bst, X, n=120)
    b = torch.from_numpy(g.bin_matrix(rows))
    paths = build_shap_paths(g.models, g._pred_nan_arr.numpy(),
                             g.feature_is_categorical(), "cpu")
    tables = build_shap_tables(paths, chunk_elems=1 << 10)
    u = paths.ulen.numpy()
    assert tables.table.numel() * 8 == shap_table_bytes(u)
    assert tables.mask_bits == int(u.max())
    k = g.num_class
    tabled = tree_shap_tables_plain(b, paths, tables, k)
    plain = tree_shap_plain(b, paths, k)
    scale = float(paths.leaf_value.abs().sum() + paths.ev.abs().sum())
    err = (tabled - plain).abs()
    assert bool((err <= 1e-12 * (plain.abs() + scale)).all()), \
        float(err.max())


def test_table_bytes_read_counts_the_masks_the_rows_form():
    """``shap_table_bytes_read`` against a count in numpy: ``u`` float64
    weights for each distinct (tree, leaf, mask) of the rows, a slot
    agreeing where every step of the path at it goes the row's way (bin
    at most the threshold, or the NaN bin with the default left)."""
    bst, X = case_model("nan")
    g = bst._gbdt
    rows = edge_rows(bst, X, n=200)
    bins = g.bin_matrix(rows)
    paths = build_shap_paths(g.models, g._pred_nan_arr.numpy(),
                             g.feature_is_categorical(), "cpu")
    nan_bin = g._pred_nan_arr.numpy()
    b64 = bins.astype(np.int64)
    want = 0
    for t, m in enumerate(g.models):
        _, nl, _, d_max = paths.host_shape[t]
        for leaf in range(nl):
            u = int(paths.ulen[t, leaf])
            if u == 0:
                continue
            mask = np.full(len(b64), (1 << u) - 1, np.int64)
            for d in range(d_max):
                node = int(paths.step_node[t, leaf, d])
                if node < 0:
                    continue
                f = int(m.split_feature[node])
                v = b64[:, f]
                left = (v <= m.split_bin[node]) | (
                    bool(m.default_left[node]) & (v == nan_bin[f]))
                off = left != bool(paths.step_left[t, leaf, d])
                mask[off] &= ~(1 << (int(paths.step_slot[t, leaf, d]) - 1))
            want += len(np.unique(mask)) * u * 8
    got = shap_table_bytes_read(torch.from_numpy(bins), paths)
    assert got == want
    assert 0 < got < shap_table_bytes(paths.ulen.numpy())


@pytest.mark.parametrize("case", ["nan", "multiclass"])
def test_tabled_treeshap_matches_jax(case):
    """Against the JAX package's ``shap_batched_tables`` (float32) on the
    same trees and bins: within 1e-5."""
    bst, X = case_model(case)
    g = bst._gbdt
    rows = edge_rows(bst, X, n=120)
    host = g.bin_matrix(rows)
    k, f = g.num_class, host.shape[1]
    paths = build_shap_paths(g.models, g._pred_nan_arr.numpy(),
                             g.feature_is_categorical(), "cpu")
    ours = tree_shap_tables_plain(torch.from_numpy(host), paths,
                                  build_shap_tables(paths), k).numpy()
    models = list(g.models)
    t = len(models)
    max_lv = max(len(m.leaf_value) for m in models)
    d_bkt = predict.depth_bucket(max(m.max_depth for m in models))
    t_pad = predict.tree_bucket(t, 4)
    jst = jax_stack_trees(models, max_lv - 1, max_lv, pad_to=t_pad)
    jpaths = jax_shap.build_shap_paths(models, max_lv, d_bkt, pad_to=t_pad)
    jtab = jax_shap.build_shap_tables(
        jpaths, jst.leaf_value, mask_bits=int(np.max(paths.ulen.numpy())),
        depth=d_bkt)
    theirs = np.asarray(jax_shap.shap_batched_tables(
        jnp.asarray(host), jst, jtab,
        jnp.asarray(g._pred_nan_arr.numpy().astype(np.int32)),
        jnp.asarray(g.feature_is_categorical()), np.int32(k), num_class=k,
        depth=d_bkt, tbatch=4, any_cat=False, num_features=f))
    np.testing.assert_allclose(ours, theirs.transpose(1, 0, 2), rtol=1e-5,
                               atol=1e-5)


def test_ladder_helpers_match_jax():
    for spec in ("auto", "", "256,1024,4096", "3000, 7,7,1e3", [5, 1, 9],
                 None):
        assert predict.parse_bucket_ladder(spec) \
            == jax_predict.parse_bucket_ladder(spec)
    with pytest.raises(ValueError):
        predict.parse_bucket_ladder("0,-3")
    for ladder in (predict.parse_bucket_ladder("auto"), (256, 1024, 4096),
                   (7,)):
        for n in (0, 1, 6, 7, 8, 255, 256, 257, 1024, 4096, 4097, 1 << 20,
                  (1 << 20) + 1):
            assert predict.bucket_rows(n, ladder) \
                == jax_predict.bucket_rows(n, ladder)
        for cap in (None, 0, -1, 1, 300, 5000, 1 << 21):
            assert predict.warmup_rungs(ladder, cap) \
                == jax_predict.warmup_rungs(ladder, cap)
    for t in (0, 1, 15, 16, 17, 100, 1000):
        for tb in (1, 4, 16, 0):
            assert predict.tree_bucket(t, tb) == jax_predict.tree_bucket(t,
                                                                         tb)
    for d in (0, 1, 4, 5, 9, 17, 64):
        assert predict.depth_bucket(d) == jax_predict.depth_bucket(d)
