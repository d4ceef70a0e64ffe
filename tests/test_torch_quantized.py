"""Quantized-gradient training in the port (``use_quantized_grad``) on the
CPU, held against the JAX package on the same numpy inputs.

* the gradient discretizer (``boosting/gbdt.py`` ``_discretize_gradients``)
  against the JAX package's: codes and scales equal, deterministic and
  stochastic rounding (the JAX package's uniform draws fed through the
  port's ``uniforms`` seam), constant and non-constant hessians; and each
  objective's ``is_constant_hessian`` flag against the JAX class's;
* integer histograms: the plain record histogram with ``quant=True``
  against ``_xla_histogram`` on int8 channels and against
  ``pallas_histogram(mode="int8", interpret=True)``, exactly equal; K2's
  plain ``quant`` version against ``fused_split(quant=True,
  interpret=True)`` in modes 0 and 1, dual and copy-back: records byte-equal,
  int32 histograms exactly equal;
* ``best_split(quant_scales=)`` against the JAX package's;
* training end to end with ``stochastic_rounding=False``: the compact
  grower's int32 path against both JAX oracles (its XLA compact path,
  ``tpu_fused=off``, and its fused kernel in interpret mode), the shim on
  the masked grower and for multiclass, and bundled (EFB) data: trees equal
  split for split, predictions within 1e-6 (the int32 histograms are exact
  on both sides; leaf sums are f32 prefix sums of the dequantized bins, as
  in ``tests/test_torch_train.py``);
* the gates: the int32 range (its constant lowered) and
  ``num_grad_quant_bins`` > 127 take the shim with a warning,
  ``tpu_quant_hist_bits=16`` warns and trains the 32-bit model; stochastic
  rounding repeats itself for one seed and differs for another.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.boosting import gbdt as jax_gbdt
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.objectives import create_objective as jax_objective
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu.ops.compact import RowLayout as JaxLayout
from lightgbm_tpu.ops.compact import pack_rows as jax_pack_rows
from lightgbm_tpu.ops.fused_split import fused_split as jax_fused_split
from lightgbm_tpu.ops.histogram import _xla_histogram as jax_xla_histogram
from lightgbm_tpu.ops.pallas_histogram import \
    pallas_histogram as jax_pallas_histogram
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.objectives import OBJECTIVES
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.compact import RowLayout, pack_rows
from lightgbm_tpu_torch.ops.fused_split import fused_split_plain
from lightgbm_tpu_torch.ops.histogram import _xla_histogram
from lightgbm_tpu_torch.ops.pallas_histogram import record_histogram

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

I32 = jnp.int32
PAD = 256
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
        "verbosity": -1, "use_quantized_grad": True,
        "stochastic_rounding": False}


# ---- the discretizer -------------------------------------------------------

def _grads(n, seed, const_hess):
    rng = np.random.RandomState(seed)
    g = (rng.randn(2, n) * 0.7).astype(np.float32)
    g[0, :5] = 0.0                      # sign 0 rounds to 0
    h = (np.ones((2, n)) if const_hess
         else 0.05 + rng.rand(2, n)).astype(np.float32)
    return g, h


@pytest.mark.parametrize("bins", [4, 16, 127])
@pytest.mark.parametrize("const_hess", [False, True])
@pytest.mark.parametrize("stochastic", [False, True])
def test_discretizer_matches_reference(stochastic, const_hess, bins):
    g, h = _grads(3000, bins, const_hess)
    key = jax.random.fold_in(jax.random.PRNGKey(1337), 3)
    jg, jh, jgs, jhs = jax_gbdt._discretize_gradients(
        jnp.asarray(g), jnp.asarray(h), key, bins, stochastic, const_hess)
    uniforms = None
    if stochastic:
        # the JAX package's own draws (gbdt.py:148-150), through the seam
        kg, kh = jax.random.split(key)
        uniforms = tuple(torch.from_numpy(np.array(jax.random.uniform(
            k, g.shape))) for k in (kg, kh))
    tg, th, tgs, ths = gbdt_mod._discretize_gradients(
        torch.from_numpy(g), torch.from_numpy(h), bins, stochastic,
        const_hess, uniforms=uniforms)
    assert tgs.dim() == 0 and ths.dim() == 0
    assert float(tgs) == float(jgs) and float(ths) == float(jhs)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert np.abs(tg.numpy()).max() <= bins // 2
    assert 0 <= th.numpy().min() and th.numpy().max() <= bins
    # the shim multiplies the codes back by their scales
    sg, sh = gbdt_mod._quantize_gradients(
        torch.from_numpy(g), torch.from_numpy(h), bins, stochastic,
        const_hess, uniforms=uniforms)
    np.testing.assert_array_equal(sg.numpy(), (tg * tgs).numpy())
    np.testing.assert_array_equal(sh.numpy(), (th * ths).numpy())


@pytest.mark.parametrize("name", sorted(OBJECTIVES))
def test_is_constant_hessian_matches_reference(name):
    params = {"objective": name}
    if name in ("multiclass", "multiclassova"):
        params["num_class"] = 3
    port = OBJECTIVES[name](Config(params))
    ref = jax_objective(name, JaxConfig(params))
    assert port.is_constant_hessian is bool(ref.is_constant_hessian)


# ---- integer histograms ----------------------------------------------------

def _int_rows(n, f, b, seed):
    """Rows with integer codes in the grad and hess columns (|qg| <= 2,
    0 <= qh <= 4, LightGBM's default 4 bins) and a mostly-in-bag column."""
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, b, size=(n, f)).astype(np.uint8)
    g = rng.randint(-2, 3, n).astype(np.float32)
    h = rng.randint(0, 5, n).astype(np.float32)
    cnt = (rng.rand(n) > 0.2).astype(np.float32)
    extras = rng.randn(1, n).astype(np.float32)
    return binned, g, h, cnt, extras


@pytest.mark.parametrize("n,f,b", [(3000, 5, 256), (1000, 29, 64),
                                   (257, 3, 17)])
def test_int_record_histogram_matches_reference(n, f, b):
    binned, g, h, cnt, extras = _int_rows(n, f, b, seed=n + f)
    layout = RowLayout(num_features=f, num_extra=1)
    work = pack_rows(*(torch.from_numpy(a) for a in
                       (binned, g, h, cnt, extras)), layout)
    seg = torch.tensor([0, n, 0], dtype=torch.int32)
    port = record_histogram(work, torch.zeros_like(work), seg, layout, b,
                            quant=True)
    assert port.dtype == torch.int32
    ch8 = np.stack([g, h, cnt != 0, np.ones(n)], 1).astype(np.int8)
    xla = np.asarray(jax_xla_histogram(jnp.asarray(binned),
                                       jnp.asarray(ch8), b))
    pal = np.asarray(jax_pallas_histogram(jnp.asarray(binned),
                                          jnp.asarray(ch8), b, mode="int8",
                                          interpret=True))
    assert xla.dtype == np.int32 and pal.dtype == np.int32
    np.testing.assert_array_equal(port.numpy(), xla)
    np.testing.assert_array_equal(port.numpy(), pal)
    # the plain dense histogram of integer channels is exact int32 too
    dense = _xla_histogram(torch.from_numpy(binned),
                           torch.from_numpy(ch8.astype(np.int32)), b)
    assert dense.dtype == torch.int32
    np.testing.assert_array_equal(dense.numpy(), xla)


def _records(n, f, b, seed):
    """The same integer-code rows packed by both packages (byte-equal; the
    JAX arrays carry PAD more rows)."""
    arrays = _int_rows(n, f, b, seed)
    jl = JaxLayout(num_features=f, num_extra=1)
    jw = np.asarray(jax.jit(jax_pack_rows,
                            static_argnames=("layout", "pad_rows"))(
        *(jnp.asarray(a) for a in arrays), jl, PAD))
    tl = RowLayout(num_features=f, num_extra=1)
    tw = pack_rows(*(torch.from_numpy(a) for a in arrays), tl).numpy()
    np.testing.assert_array_equal(tw, jw[:n])
    return jl, tl, tw


_K2_CASES = [
    # (mode, start, count, feature, bin, side)
    (1, 0, 3000, 0, 0, 0),
    (1, 37, 2219, 0, 0, 1),
    (0, 0, 3000, 2, 100, 0),
    (0, 37, 2219, 1, 200, 1),
    (0, 96, 128, 4, 40, 0),
]


@pytest.mark.parametrize("dual", [True, False])
@pytest.mark.parametrize("case", _K2_CASES)
def test_k2_quant_plain_matches_reference(case, dual):
    """K2's plain ``quant`` version against the TPU kernel's ``quant`` mode
    in interpret mode: the record arrays byte-equal where the contract
    defines them, the int32 histogram exactly equal."""
    mode, start, count, feat, bin_, side = case
    if not dual:
        side = 0                 # copy-back keeps every segment in work
    n, f, b = 3000, 5, 256
    jl, tl, work0 = _records(n, f, b, seed=start + count)
    other0 = np.random.RandomState(5).randint(
        0, 256, work0.shape).astype(np.uint8)
    other0[:, tl.moved_cols:] = 0
    col = work0[start:start + count, feat]
    n_left = count if mode == 1 else int((col <= bin_).sum())
    bits = np.zeros(8, np.uint32)
    pad = np.zeros((PAD, work0.shape[1]), np.uint8)
    jp, jo = np.concatenate([work0, pad]), np.concatenate([other0, pad])
    jw, js = (jo, jp) if side else (jp, jo)
    rw, rs, rh = jax_fused_split(
        jnp.asarray(jw), jnp.asarray(js), jnp.asarray(mode, I32),
        jnp.asarray(start, I32), jnp.asarray(count, I32),
        jnp.asarray(n_left, I32), jnp.asarray(feat, I32),
        jnp.asarray(bin_, I32), jnp.asarray(0, I32), jnp.asarray(0, I32),
        jnp.asarray(0, I32), jnp.asarray(bits), jl, b, 128, 8,
        interpret=True, side=jnp.asarray(side, I32), dual=dual, quant=True)
    rw, rs, rh = np.asarray(rw)[:n], np.asarray(rs)[:n], np.asarray(rh)
    tp, to = torch.from_numpy(work0.copy()), torch.from_numpy(other0.copy())
    tw, ts = (to, tp) if side else (tp, to)
    tw, ts, th = fused_split_plain(
        tw, ts, mode, start, count, n_left, feat, bin_, 0, 0, 0,
        torch.from_numpy(bits.view(np.int32)), tl, b, side=side, dual=dual,
        quant=True)
    assert rh.dtype == np.int32 and th.dtype == torch.int32
    np.testing.assert_array_equal(th.numpy(), rh)
    tw, ts = tw.numpy(), ts.numpy()
    if mode == 1:
        np.testing.assert_array_equal(tw, rw)
        return
    par_t, oth_t = (ts, tw) if side else (tw, ts)
    par_j, oth_j = (rs, rw) if side else (rw, rs)
    s, c, nl = start, count, n_left
    if not dual:
        # copy-back: every row of work is defined, scratch is dead
        np.testing.assert_array_equal(tw, rw)
        return
    # the left child in the parent's array, the right in the other one; the
    # other array's left range is dead, rows outside the segment unchanged
    np.testing.assert_array_equal(par_t[s:s + nl], par_j[s:s + nl])
    np.testing.assert_array_equal(oth_t[s + nl:s + c], oth_j[s + nl:s + c])
    outside = np.ones(n, bool)
    outside[s:s + c] = False
    np.testing.assert_array_equal(par_t[outside], par_j[outside])
    np.testing.assert_array_equal(oth_t[outside], oth_j[outside])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_best_split_dequantizes_as_reference(seed):
    rng = np.random.RandomState(seed)
    F, B, n = 6, 64, 4000
    bins = rng.randint(0, B, (n, F))
    qg = np.clip(np.round(rng.randn(n) * 1.5 + (bins[:, seed] < 20)), -2, 2)
    qh = rng.randint(1, 5, n)
    ch = np.stack([qg, qh, np.ones(n), np.ones(n)], 1).astype(np.int64)
    hist = np.zeros((F, B, 4), np.int64)
    for f in range(F):
        np.add.at(hist[f], bins[:, f], ch)
    hist = hist.astype(np.int32)
    gs, hs = np.float32(0.37), np.float32(0.061)
    tot = hist[0].sum(axis=0)
    pg, ph, pc = (np.float32(tot[0]) * gs, np.float32(tot[1]) * hs,
                  np.float32(tot[2]))
    num_bins = np.full(F, B, np.int32)
    nan_bin = np.zeros(F, np.int32)
    has_nan = np.zeros(F, bool)
    mask = np.ones(F, bool)
    j = jsplit.best_split(
        jnp.asarray(hist), jnp.asarray(pg), jnp.asarray(ph), jnp.asarray(pc),
        jnp.asarray(num_bins), jnp.asarray(nan_bin), jnp.asarray(has_nan),
        jnp.zeros(F, bool), jnp.asarray(mask),
        jsplit.SplitParams(enable_sorted_cat=False),
        quant_scales=(jnp.float32(gs), jnp.float32(hs)))
    t = tsplit.best_split(
        torch.from_numpy(hist), torch.tensor(pg), torch.tensor(ph),
        torch.tensor(pc), torch.from_numpy(num_bins),
        torch.from_numpy(nan_bin), torch.from_numpy(has_nan),
        torch.from_numpy(mask), tsplit.SplitParams(),
        quant_scales=(torch.tensor(gs), torch.tensor(hs)))
    assert float(j.gain) > 0.0
    assert int(t.feature) == int(j.feature) and int(t.bin) == int(j.bin)
    assert bool(t.default_left) == bool(j.default_left)
    np.testing.assert_allclose(float(t.gain), float(j.gain), rtol=1e-5)
    for name in ("left_grad", "left_hess", "left_count", "left_rows"):
        np.testing.assert_allclose(float(getattr(t, name)),
                                   float(getattr(j, name)), rtol=1e-6)


# ---- training end to end ---------------------------------------------------

def _higgs_like(n, f, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
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
                                   rtol=2e-5, atol=2e-6)


# the interpret-mode oracle contracts one row block at a time
# (tpu_hist_mbatch=1): the same int32 sums, a program a fraction the size
_ORACLES = {"xla": {"tpu_fused": "off"},
            "fused_interpret": {"tpu_fused": "on",
                                "tpu_fused_interpret": True,
                                "tpu_hist_mbatch": 1}}


def _train_both(X, y, params, jax_extra, rounds=3, jax_params=None):
    bj = lgb.train(dict(params, **(jax_params or {}), **jax_extra),
                   lgb.Dataset(X, label=y), rounds)
    _kernels.reset_counts()
    bt = lgt.train(dict(params, device_type="cpu"), lgt.Dataset(X, y),
                   rounds)
    return bj, bt


@pytest.mark.parametrize("oracle", sorted(_ORACLES))
@pytest.mark.parametrize("renew", [False, True])
@pytest.mark.parametrize("bins", [4, 16])
def test_compact_int_path_matches_reference(bins, renew, oracle):
    X, y = _higgs_like(4000, 8)
    p = dict(BASE, tpu_grower="compact", num_grad_quant_bins=bins,
             quant_train_renew_leaf=renew)
    bj, bt = _train_both(X, y, p, _ORACLES[oracle])
    gb = bt._gbdt
    assert gb.use_compact and gb._quant_int
    assert bj._gbdt._use_compact
    # K2 in its quant mode: a root histogram and one split a leaf
    assert _kernels.PLAIN_CALLS["fused_split"] == 3 * p["num_leaves"]
    assert sum(_kernels.LAUNCHES.values()) == 0
    _assert_same_trees(bj._gbdt.models, gb.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)


def test_compact_grower_histograms_are_int32(monkeypatch):
    """Every histogram of the int path is int32: the root's, the smaller
    child's and (through the scan) the cached leaf histograms."""
    from lightgbm_tpu_torch.ops import grower_compact
    seen = []
    real = grower_compact.fused_split

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append((kw.get("quant"), out[2].dtype))
        return out
    monkeypatch.setattr(grower_compact, "fused_split", spy)
    scans = []
    real_scan = grower_compact.best_split

    def scan_spy(hist, *a, **kw):
        scans.append(hist.dtype)
        return real_scan(hist, *a, **kw)
    monkeypatch.setattr(grower_compact, "best_split", scan_spy)
    X, y = _higgs_like(3000, 6)
    lgt.train(dict(BASE, tpu_grower="compact", device_type="cpu"),
              lgt.Dataset(X, y), 1)
    assert len(seen) == BASE["num_leaves"]
    assert all(q is True and dt == torch.int32 for q, dt in seen)
    assert scans and all(dt == torch.int32 for dt in scans)


@pytest.mark.parametrize("renew", [False, True])
def test_masked_grower_shim_matches_reference(renew):
    X, y = _higgs_like(3000, 8, seed=3)
    p = dict(BASE, tpu_grower="masked", quant_train_renew_leaf=renew)
    bj, bt = _train_both(X, y, p, {})
    assert not bt._gbdt.use_compact and not bt._gbdt._quant_int
    _assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)


def _weighted_multiclass(n=3000, seed=5):
    """Three classes from two features, with continuous row weights (as
    ``tests/test_torch_multiclass.py``): no two candidate splits tie in f32
    summation order."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    score = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.3 * rng.randn(n)
    y = np.digitize(score, np.quantile(score, [1 / 3, 2 / 3])).astype(float)
    w = (0.5 + rng.rand(n)).astype(np.float32)
    return X, y, w


@pytest.mark.parametrize("grower", ["compact", "masked"])
def test_multiclass_shim_matches_reference(grower):
    """Multiclass takes the shim on both growers: one scale over all K
    classes' gradients a round."""
    X, y, w = _weighted_multiclass()
    p = dict(BASE, objective="multiclass", num_class=3, tpu_grower=grower,
             num_leaves=7, quant_train_renew_leaf=grower == "masked")
    bj = lgb.train(dict(p, tpu_fused="off"), lgb.Dataset(X, label=y,
                                                         weight=w), 3)
    bt = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y, weight=w),
                   3)
    assert bt._gbdt.use_compact == (grower == "compact")
    assert not bt._gbdt._quant_int
    _assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)


def test_multiclass_compact_renewal_warns_and_skips(caplog):
    X, y, w = _weighted_multiclass()
    p = dict(BASE, objective="multiclass", num_class=3, num_leaves=7,
             tpu_grower="compact", quant_train_renew_leaf=True)
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        bt = lgt.train(dict(p, device_type="cpu", verbosity=0),
                       lgt.Dataset(X, y, weight=w), 2)
    assert "skipping renewal" in caplog.text
    assert not bt._gbdt._quant_renew
    plain = lgt.train(dict(p, device_type="cpu", quant_train_renew_leaf=False),
                      lgt.Dataset(X, y, weight=w), 2)
    np.testing.assert_array_equal(bt.predict(X), plain.predict(X))


def _onehot(n=3000, groups=40, card=8, dense=4, seed=3):
    """One-hot blocks plus dense columns (``tests/test_torch_efb.py``): the
    port and the JAX package bundle them."""
    rng = np.random.RandomState(seed)
    cats = rng.randint(0, card, size=(n, groups))
    X = np.zeros((n, groups * card), np.float32)
    for g in range(groups):
        X[np.arange(n), g * card + cats[:, g]] = 1.0
    X = np.concatenate([X, rng.randn(n, dense).astype(np.float32)], axis=1)
    y = (X @ (rng.randn(X.shape[1]) * 0.5) + 0.4 * rng.randn(n) > 0
         ).astype(np.float64)
    return X, y


@pytest.mark.parametrize("oracle", sorted(_ORACLES))
def test_bundled_int_path_matches_reference(oracle):
    """EFB-bundled data runs the int path too: the virtual features'
    histograms stay int32 (``extend_hist_efb``); 1,500 rows, 2 rounds."""
    X, y = _onehot(n=1500)
    p = dict(BASE, min_data_in_leaf=10)
    bj, bt = _train_both(X, y, p, _ORACLES[oracle], rounds=2)
    gb = bt._gbdt
    assert gb._efb is not None and gb._quant_int
    assert bj._gbdt._efb is not None
    _assert_same_trees(bj._gbdt.models, gb.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)


def test_extend_hist_efb_keeps_int32():
    """Bundled data's virtual histogram rows stay int32 and exact."""
    from lightgbm_tpu_torch.io.efb import EfbLayout
    rng = np.random.RandomState(0)
    hist = torch.from_numpy(rng.randint(-50, 50, (2, 3, 16, 4)).astype(
        np.int32))
    efb = EfbLayout(*(torch.tensor(a) for a in (
        [0, 1, 2, 2, 2], [False, False, False, True, True],
        [-1, -1, -1, 0, 5], [0, 0, 0, 5, 4], [0, 0, 0, 0, 0],
        [0, 1, -1, 7, 8])))
    out = tsplit.extend_hist_efb(hist, efb, 2, 5)
    assert out.dtype == torch.int32
    ref = tsplit.extend_hist_efb(hist.double(), efb, 2, 5)
    np.testing.assert_array_equal(out.numpy(), ref.numpy())
    # raw-count reads work on int32 histograms too
    args = (torch.tensor(1), torch.tensor(6), torch.tensor(True),
            torch.tensor(15))
    assert int(tsplit.left_rows_of_split(out[0], *args)) == int(
        tsplit.left_rows_of_split(ref[0], *args))


# ---- the gates -------------------------------------------------------------

def test_int_range_gate_takes_the_shim(monkeypatch, caplog):
    """Past the int32 range (``_QUANT_INT_LIMIT``, lowered here) the compact
    grower takes the shim with the reference's warning, and grows the int
    path's trees."""
    X, y = _higgs_like(3000, 8, seed=11)
    p = dict(BASE, tpu_grower="compact", device_type="cpu", verbosity=0)
    int_model = lgt.train(p, lgt.Dataset(X, y), 3)
    assert int_model._gbdt._quant_int
    monkeypatch.setattr(gbdt_mod, "_QUANT_INT_LIMIT", 3000 * 4)
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        shim = lgt.train(p, lgt.Dataset(X, y), 3)
    assert not shim._gbdt._quant_int and shim._gbdt.use_compact
    assert "exceeds the int32 histogram range" in caplog.text
    _assert_same_trees(int_model._gbdt.models, shim._gbdt.models)
    np.testing.assert_allclose(shim.predict(X), int_model.predict(X),
                               atol=1e-6)


def test_wide_code_range_takes_the_shim(caplog):
    """``num_grad_quant_bins`` above the int8 code range takes the shim,
    with a warning, and grows the JAX package's trees (which take its shim
    there too)."""
    X, y = _higgs_like(3000, 8, seed=12)
    p = dict(BASE, tpu_grower="compact", num_grad_quant_bins=200)
    bj = lgb.train(dict(p, tpu_fused="off"), lgb.Dataset(X, label=y), 3)
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        bt = lgt.train(dict(p, device_type="cpu", verbosity=0),
                       lgt.Dataset(X, y), 3)
    assert not bt._gbdt._quant_int
    assert "num_grad_quant_bins=200" in caplog.text
    _assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)


@pytest.mark.parametrize("bits,message", [
    (16, "keeping 32-bit accumulation"),
    (8, "is not one of 0 (auto) | 16 | 32")])
def test_quant_hist_bits(bits, message, caplog):
    X, y = _higgs_like(3000, 8, seed=13)
    p = dict(BASE, tpu_grower="compact", device_type="cpu", verbosity=0)
    ref = lgt.train(p, lgt.Dataset(X, y), 2)
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        bt = lgt.train(dict(p, tpu_quant_hist_bits=bits), lgt.Dataset(X, y),
                       2)
    assert message in caplog.text
    assert bt._gbdt._quant_int
    np.testing.assert_array_equal(bt.predict(X), ref.predict(X))


@pytest.mark.parametrize("grower", ["compact", "masked"])
def test_stochastic_rounding_repeats_for_a_seed(grower):
    X, y = _higgs_like(3000, 8, seed=14)
    p = dict(BASE, tpu_grower=grower, device_type="cpu",
             stochastic_rounding=True)

    def run(seed):
        return lgt.train(dict(p, seed=seed), lgt.Dataset(X, y),
                         3).predict(X)
    a, b, c = run(1), run(1), run(2)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-6
    # the draws differ from deterministic rounding's codes
    det = lgt.train(dict(p, stochastic_rounding=False), lgt.Dataset(X, y),
                    3).predict(X)
    assert np.abs(a - det).max() > 1e-6


def test_quantized_model_text_round_trip(tmp_path):
    X, y = _higgs_like(3000, 8, seed=15)
    bt = lgt.train(dict(BASE, tpu_grower="compact", device_type="cpu"),
                   lgt.Dataset(X, y), 3)
    path = tmp_path / "quant.txt"
    bt.save_model(str(path))
    loaded = lgt.Booster(model_file=str(path))
    np.testing.assert_allclose(loaded.predict(X), bt.predict(X), atol=1e-6)
