"""4-bit packed bins (``tpu_bin_pack4``) in the port, on the CPU, held
against the JAX package on the same numpy inputs.

* ``pack4_matrix``/``unpack4_matrix``, the eligibility checks, ``unpack4``
  and ``gather_bin`` against the JAX package's, with an odd F;
* the packed ``RowLayout``, ``pack_rows`` byte for byte, and
  ``partition_segment(packed4=)``;
* K2's plain ``packed4`` version against ``fused_split(..., interpret=True)``
  on a packed layout: the same rows in the same order, exact ``quant``
  histograms (f32 ones on a 1/64 grid), dual and copy-back;
* training end to end: packed runs against the JAX package's packed runs
  (``tpu_fused=off`` and the fused kernel in interpret mode), f32 and
  quantized, with and without the fused kernel, and EFB-bundled data;
  trees equal split for split (f32 runs on 1/64-grid gradients, exact in
  any summation order); and each packed run exactly equal to the port's u8
  run on the same binning. The fallback at ``max_bin=31``, dense
  and bundled, warns and keeps u8 columns, as there;
* prediction on packed bins: the walk, ``predict``, ``pred_leaf``, and the
  packed booster's model text loaded by the JAX package.

One torch thread, small sizes, one row block a contraction in the
interpret-mode oracles, deterministic rounding, as the other port test
modules.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
from lightgbm_tpu.io import dataset as jds
from lightgbm_tpu.ops import compact as jcompact
from lightgbm_tpu.ops import packed as jpacked
from lightgbm_tpu.ops.fused_split import fused_split as jax_fused_split

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.io import dataset as tds
from lightgbm_tpu_torch.ops import packed as tpacked
from lightgbm_tpu_torch.ops.compact import (RowLayout, pack_rows,
                                            partition_segment, unpack_rows)
from lightgbm_tpu_torch.ops.fused_split import fused_split_plain
from lightgbm_tpu_torch.ops.predict import predict_leaf_batched

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

I32 = jnp.int32
PAD = 256
BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 15,
        "learning_rate": 0.1, "min_data_in_leaf": 20, "verbosity": -1,
        "tpu_grower": "compact"}
QUANT = {"use_quantized_grad": True, "stochastic_rounding": False}
# the JAX oracles: its XLA compact path, and its fused kernel in interpret
# mode with one row block a contraction
ORACLES = {"xla": {"tpu_fused": "off"},
           "fused_interpret": {"tpu_fused": "on", "tpu_fused_interpret": True,
                               "tpu_fused_block": 128, "tpu_hist_mbatch": 1}}


# ---- the host and device helpers -------------------------------------------

@pytest.mark.parametrize("f", [1, 6, 9])
def test_pack4_helpers_match_reference(f):
    rng = np.random.RandomState(f)
    binned = rng.randint(0, 16, (333, f)).astype(np.uint8)
    packed = tds.pack4_matrix(binned)
    np.testing.assert_array_equal(packed, jds.pack4_matrix(binned))
    assert packed.shape == (333, (f + 1) // 2)
    np.testing.assert_array_equal(tds.unpack4_matrix(packed, f), binned)
    np.testing.assert_array_equal(jds.unpack4_matrix(packed, f), binned)
    np.testing.assert_array_equal(
        tpacked.unpack4(torch.from_numpy(packed), f).numpy(),
        np.asarray(jpacked.unpack4(jnp.asarray(packed), f)))
    rows = rng.randint(0, 333, (4, 50))
    cols = rng.randint(0, f, (4, 50))
    for p, mat in ((True, packed), (False, binned)):
        ref = np.asarray(jpacked.gather_bin(
            jnp.asarray(mat), jnp.asarray(rows), jnp.asarray(cols), p))
        port = tpacked.gather_bin(torch.from_numpy(mat),
                                  torch.from_numpy(rows),
                                  torch.from_numpy(cols), p)
        np.testing.assert_array_equal(port.numpy(), ref)
        np.testing.assert_array_equal(port.numpy(), binned[rows, cols])
    with pytest.raises(ValueError):
        tds.pack4_matrix(binned.astype(np.int32))


def test_pack4_eligibility_matches_reference():
    for nb, hist in (([16, 3, 9], 16), ([17, 3], 16), ([4, 4], 32), ([], 16),
                     ([16], 17)):
        assert tds.pack4_train_eligible(nb, hist) \
            == jds.pack4_train_eligible(nb, hist)
    X = np.random.RandomState(0).randn(500, 4)
    for max_bin in (15, 31):
        p = {"max_bin": max_bin, "verbosity": -1, "device_type": "cpu"}
        tm = lgt.Dataset(X, params=p).construct()._inner.mappers
        jm = lgb.Dataset(X, params=p).construct()._inner.mappers
        assert tds.pack4_eligible(tm) == jds.pack4_eligible(jm) \
            == (max_bin == 15)


# ---- packed records --------------------------------------------------------

def _rows(n, f, seed, quant=True):
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, 16, (n, f)).astype(np.uint8)
    if quant:
        g = rng.randint(-2, 3, n).astype(np.float32)
        h = rng.randint(0, 5, n).astype(np.float32)
    else:
        g = (rng.randint(-64, 65, n) / 64.0).astype(np.float32)
        h = (rng.randint(1, 65, n) / 64.0).astype(np.float32)
    cnt = (rng.rand(n) > 0.2).astype(np.float32)
    return binned, g, h, cnt, rng.randn(3, n).astype(np.float32)


@pytest.mark.parametrize("f", [7, 28, 33])
def test_packed_layout_and_records_match_reference(f):
    arrays = _rows(700, f, seed=f)
    jl = jcompact.RowLayout(num_features=f, num_extra=3, packed4=True)
    tl = RowLayout(num_features=f, num_extra=3, packed4=True)
    for name in ("feat_cols", "grad_off", "hess_off", "cnt_off", "extra_off",
                 "num_real_cols", "num_cols"):
        assert getattr(tl, name) == getattr(jl, name), name
    u8 = RowLayout(num_features=f, num_extra=3)
    assert tl.feat_cols == (f + 1) // 2 and tl.moved_cols <= u8.moved_cols
    jw = np.asarray(jax.jit(jcompact.pack_rows,
                            static_argnames=("layout", "pad_rows"))(
        *(jnp.asarray(a) for a in arrays), jl, PAD))
    tw = pack_rows(*(torch.from_numpy(a) for a in arrays), tl)
    np.testing.assert_array_equal(tw.numpy(), jw[:700])
    back = unpack_rows(tw, 700, tl)
    np.testing.assert_array_equal(back[0].numpy(), arrays[0])
    for a, b in zip(back[1:4], arrays[1:4]):
        np.testing.assert_array_equal(a.numpy(), b)
    # an odd F pads a zero high nibble that no reader sees
    if f % 2:
        assert not (tw[:, tl.feat_cols - 1] >> 4).any()


@pytest.mark.parametrize("feat", [0, 5, 6])
def test_partition_segment_packed4_matches_reference(feat):
    n, f = 1000, 7
    arrays = _rows(n, f, seed=feat)
    jl = jcompact.RowLayout(num_features=f, num_extra=3, packed4=True)
    tl = RowLayout(num_features=f, num_extra=3, packed4=True)
    jw = jax.jit(jcompact.pack_rows, static_argnames=("layout", "pad_rows"))(
        *(jnp.asarray(a) for a in arrays), jl, PAD)
    start, count, bin_ = 30, 900, 7
    n_left = int((arrays[0][start:start + count, feat] <= bin_).sum())
    rw, _ = jax.jit(jcompact.partition_segment,
                    static_argnames=("block_size", "packed4"))(
        jw, jnp.zeros_like(jw), jnp.asarray(start, I32),
        jnp.asarray(count, I32), jnp.asarray(n_left, I32),
        jnp.asarray(feat, I32), jnp.asarray(bin_, I32), jnp.asarray(0, I32),
        jnp.asarray(0, I32), jnp.asarray(False), jnp.zeros(8, jnp.uint32),
        128, packed4=True)
    tw = pack_rows(*(torch.from_numpy(a) for a in arrays), tl)
    tw, nl = partition_segment(tw, start, count, feat, bin_, False, 0, False,
                               torch.zeros(8, dtype=torch.int32), tl)
    assert nl == n_left
    np.testing.assert_array_equal(tw.numpy(), np.asarray(rw)[:n])


_K2_CASES = [
    # (mode, start, count, feature, bin, side)
    (1, 37, 2219, 0, 0, 1),
    (0, 0, 3000, 2, 9, 0),
    (0, 37, 2219, 5, 3, 1),
    (0, 96, 128, 4, 12, 0),
]


@pytest.mark.parametrize("quant", [True, False])
@pytest.mark.parametrize("dual", [True, False])
@pytest.mark.parametrize("case", _K2_CASES)
def test_k2_packed4_plain_matches_reference(case, dual, quant):
    """K2's plain version on nibble-packed records against the TPU kernel's
    ``packed4`` mode in interpret mode: the records byte-equal where the
    contract defines them, the histogram exactly equal (1/64-grid f32)."""
    mode, start, count, feat, bin_, side = case
    if not dual:
        side = 0
    n, f, b = 3000, 7, 16
    arrays = _rows(n, f, seed=start + count, quant=quant)
    jl = jcompact.RowLayout(num_features=f, num_extra=3, packed4=True)
    tl = RowLayout(num_features=f, num_extra=3, packed4=True)
    work0 = pack_rows(*(torch.from_numpy(a) for a in arrays), tl).numpy()
    # random bytes in the other array; zero for f32, where the oracle's
    # masked sums would turn a NaN pattern among them into a NaN
    other0 = np.random.RandomState(5).randint(
        0, 256, work0.shape).astype(np.uint8) * quant
    other0[:, tl.moved_cols:] = 0
    col = arrays[0][start:start + count, feat]
    n_left = count if mode == 1 else int((col <= bin_).sum())
    bits = np.zeros(1, np.uint32)
    pad = np.zeros((PAD, work0.shape[1]), np.uint8)
    jp, jo = np.concatenate([work0, pad]), np.concatenate([other0, pad])
    jw, js = (jo, jp) if side else (jp, jo)
    rw, rs, rh = jax_fused_split(
        jnp.asarray(jw), jnp.asarray(js), jnp.asarray(mode, I32),
        jnp.asarray(start, I32), jnp.asarray(count, I32),
        jnp.asarray(n_left, I32), jnp.asarray(feat, I32),
        jnp.asarray(bin_, I32), jnp.asarray(0, I32), jnp.asarray(0, I32),
        jnp.asarray(0, I32), jnp.asarray(bits), jl, b, 128, 1,
        interpret=True, side=jnp.asarray(side, I32), dual=dual, quant=quant)
    rw, rs, rh = np.asarray(rw)[:n], np.asarray(rs)[:n], np.asarray(rh)
    tp, to = torch.from_numpy(work0.copy()), torch.from_numpy(other0.copy())
    tw, ts = (to, tp) if side else (tp, to)
    _kernels.reset_counts()
    tw, ts, th = fused_split_plain(
        tw, ts, mode, start, count, n_left, feat, bin_, 0, 0, 0,
        torch.from_numpy(bits.view(np.int32)), tl, b, side=side, dual=dual,
        quant=quant)
    assert _kernels.PLAIN_CALLS["fused_split"] == 1
    np.testing.assert_array_equal(th.numpy(), rh)
    tw, ts = tw.numpy(), ts.numpy()
    if mode == 1 or not dual:
        np.testing.assert_array_equal(tw, rw)
        return
    par_t, oth_t = (ts, tw) if side else (tw, ts)
    par_j, oth_j = (rs, rw) if side else (rw, rs)
    s, c, nl = start, count, n_left
    np.testing.assert_array_equal(par_t[s:s + nl], par_j[s:s + nl])
    np.testing.assert_array_equal(oth_t[s + nl:s + c], oth_j[s + nl:s + c])
    outside = np.ones(n, bool)
    outside[s:s + c] = False
    np.testing.assert_array_equal(par_t[outside], par_j[outside])
    np.testing.assert_array_equal(oth_t[outside], oth_j[outside])


# ---- training end to end ---------------------------------------------------

@pytest.fixture
def dyadic(monkeypatch):
    """Binary gradients and hessians rounded to a 1/64 grid in both
    packages (``tests/test_torch_constraints.py``): the f32 histograms are
    exact in any summation order."""
    from lightgbm_tpu import objectives as jobj
    from lightgbm_tpu_torch import objectives as tobj
    jg, tg = jobj.BinaryLogloss.get_gradients, tobj.BinaryLogloss.get_gradients

    def jround(self, score):
        g, h = jg(self, score)
        return jnp.round(g * 64) / 64, jnp.maximum(jnp.round(h * 64), 1) / 64

    def tround(self, score, label, weight=None):
        g, h = tg(self, score, label, weight)
        return (torch.round(g * 64) / 64,
                torch.clamp(torch.round(h * 64), min=1) / 64)
    monkeypatch.setattr(jobj.BinaryLogloss, "get_gradients", jround)
    monkeypatch.setattr(tobj.BinaryLogloss, "get_gradients", tround)


def _higgs_like(n, f, seed=7, cat_col=None):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    if cat_col is not None:
        X[:, cat_col] = rng.randint(0, 6, n)
    y = (X[:, 0] - 0.4 * X[:, 2] + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def _assert_same_trees(tj, tt):
    assert len(tj) == len(tt)
    for a, b in zip(tj, tt):
        n = a.num_nodes
        assert b.num_nodes == n and b.num_leaves == a.num_leaves
        for name in ("split_feature", "split_bin", "default_left",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:n],
                                          getattr(a, name)[:n], err_msg=name)
        np.testing.assert_allclose(b.leaf_value[:n + 1], a.leaf_value[:n + 1],
                                   rtol=1e-5, atol=1e-6)


def _port(X, y, params, rounds=3, **kw):
    p = dict(BASE, device_type="cpu", **params)
    return lgt.train(p, lgt.Dataset(X, y, params=p, **kw), rounds)


def _jax(X, y, params, rounds=3, **kw):
    p = dict(BASE, **params)
    return lgb.train(p, lgb.Dataset(X, label=y, params=p, **kw), rounds)


@pytest.mark.parametrize("oracle", sorted(ORACLES))
@pytest.mark.parametrize("quant", [False, True])
def test_pack4_training_matches_reference(quant, oracle, dyadic):
    """A packed run against the JAX package's packed run (categorical
    column included), and exactly equal to the port's u8 run."""
    X, y = _higgs_like(1203, 6, seed=3, cat_col=3)
    params = dict(QUANT if quant else {}, tpu_bin_pack4=True)
    kw = {"categorical_feature": [3]}
    bj = _jax(X, y, dict(params, **ORACLES[oracle]), **kw)
    assert bj._gbdt._compact["layout"].packed4
    _kernels.reset_counts()
    bt = _port(X, y, params, **kw)
    gb = bt._gbdt
    assert gb.layout.packed4 and gb.grower_params.bin_pack4
    assert gb._pred_pack4 and gb._quant_int == quant
    _assert_same_trees(bj._gbdt.models, gb.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)
    u8 = _port(X, y, dict(QUANT if quant else {}), **kw)
    assert not u8._gbdt.layout.packed4
    np.testing.assert_array_equal(bt.predict(X), u8.predict(X))


@pytest.mark.parametrize("quant,bits", [(False, 0), (True, 32), (True, 16)])
def test_pack4_unfused_matches_reference(quant, bits, dyadic):
    """Packed records without the fused kernel: the partition routes by
    nibbles and the histograms unpack them, f32, quantized and narrowed."""
    X, y = _higgs_like(3003, 8, seed=11)
    params = dict(QUANT if quant else {}, tpu_bin_pack4=True,
                  tpu_fused="off", tpu_quant_hist_bits=bits)
    bj = _jax(X, y, params)
    bt = _port(X, y, params)
    gb = bt._gbdt
    assert gb.layout.packed4 and not gb.grower_params.fused
    assert gb.grower_params.quant_narrow == (bits == 16)
    _assert_same_trees(bj._gbdt.models, gb.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)
    u8 = _port(X, y, dict(params, tpu_bin_pack4=False))
    np.testing.assert_array_equal(bt.predict(X), u8.predict(X))


def test_wide_bins_fall_back_to_u8(caplog):
    X, y = _higgs_like(1500, 6)
    p = {"max_bin": 31, "tpu_bin_pack4": True, "verbosity": 0}
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        bt = _port(X, y, p, rounds=2)
    assert "keeps u8 bin columns" in caplog.text
    assert "predicting on the u8 matrix" in caplog.text
    assert not bt._gbdt.layout.packed4 and not bt._gbdt._pred_pack4
    bj = _jax(X, y, dict(p, tpu_fused="off"), rounds=2)
    assert not bj._gbdt._compact["layout"].packed4
    _assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)


def _onehot_wide(n=3000, groups=100, card=3, seed=0):
    """>= 256 sparse one-hot columns, so that EFB bundles them (the JAX
    package's ``tests/test_pack4_train.py``)."""
    rng = np.random.RandomState(seed)
    cats = rng.randint(0, card, size=(n, groups))
    X = np.zeros((n, groups * card), np.float32)
    for g in range(groups):
        X[np.arange(n), g * card + cats[:, g]] = 1.0
    w = rng.randn(X.shape[1]) * 0.5
    y = ((X @ w + 0.4 * rng.randn(n)) > 0).astype(np.float64)
    return X, y


@pytest.mark.parametrize("max_bin,packed", [(15, True), (31, False)])
def test_bundled_pack4(max_bin, packed, caplog):
    """EFB-bundled data packs where every bundle column has at most 16
    bins (K2's copy-back variant on nibbles; bundles are at most
    ``max_bin + 1`` wide), and warns and stays on u8 where the histogram is
    wider, as the JAX package decides; quantized, so the trees are exact on
    both sides."""
    X, y = _onehot_wide(n=1500, groups=100, card=3)
    params = dict(QUANT, tpu_bin_pack4=True, num_leaves=15, max_bin=max_bin,
                  min_data_in_leaf=10, verbosity=0)
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        bt = _port(X, y, params, rounds=2)
    gb = bt._gbdt
    assert gb._efb is not None and not gb.grower_params.fused_dual
    assert gb.layout.packed4 == packed
    assert ("keeps u8 bin columns" in caplog.text) != packed
    bj = _jax(X, y, dict(params, tpu_fused="off"), rounds=2)
    assert bj._gbdt._compact["layout"].packed4 == packed
    _assert_same_trees(bj._gbdt.models, gb.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)
    u8 = _port(X, y, dict(params, tpu_bin_pack4=False), rounds=2)
    np.testing.assert_array_equal(bt.predict(X), u8.predict(X))


def test_dart_routes_packed_records():
    """DART routes its dropped trees over the training records on the
    device (``GBDT._routing_binned``): packed records give the u8 run's
    model exactly."""
    X, y = _higgs_like(2000, 7, seed=9)
    params = {"boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0,
              "drop_seed": 4}
    p4 = _port(X, y, dict(params, tpu_bin_pack4=True), rounds=4)
    u8 = _port(X, y, params, rounds=4)
    assert p4._gbdt.layout.packed4 and p4._gbdt._routing_packed()
    assert len(p4._gbdt.last_drop) > 0
    np.testing.assert_array_equal(p4.predict(X), u8.predict(X))


# ---- prediction ------------------------------------------------------------

def test_packed_walk_equals_u8_walk():
    from lightgbm_tpu_torch.boosting.gbdt import stack_trees
    X, y = _higgs_like(2000, 7, seed=5)
    bt = _port(X, y, {"tpu_bin_pack4": True}, rounds=4)
    gb = bt._gbdt
    binned = gb.bin_matrix(X)
    trees = stack_trees(gb.models, gb.device, gb.feature_is_categorical())
    depth = max(m.max_depth for m in gb.models)
    u8 = predict_leaf_batched(torch.from_numpy(binned), trees,
                              gb._pred_nan_arr, depth)
    p4 = predict_leaf_batched(torch.from_numpy(tds.pack4_matrix(binned)),
                              trees, gb._pred_nan_arr, depth, packed=True)
    assert torch.equal(u8, p4)
    np.testing.assert_array_equal(
        bt.predict(X, pred_leaf=True), u8.T.numpy().astype(np.int32))


def test_packed_booster_text_loads_in_reference(tmp_path):
    X, y = _higgs_like(2000, 7, seed=6)
    bt = _port(X, y, dict(QUANT, tpu_bin_pack4=True), rounds=4)
    path = tmp_path / "pack4.txt"
    bt.save_model(str(path))
    ref = lgb.Booster(model_file=str(path))
    np.testing.assert_allclose(ref.predict(X), bt.predict(X), atol=1e-6)
    loaded = lgt.Booster(model_file=str(path))
    np.testing.assert_allclose(loaded.predict(X), bt.predict(X), atol=1e-6)
    u8 = _port(X, y, dict(QUANT), rounds=4)
    strip = [line for line in bt.model_to_string().splitlines()
             if "tpu_bin_pack4" not in line]
    assert strip == [line for line in u8.model_to_string().splitlines()
                     if "tpu_bin_pack4" not in line]
