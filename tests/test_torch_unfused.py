"""The compact grower without the fused kernel (``tpu_fused=off``) and the
histogram modes it brings (K1's dense ``int8`` mode, K3's ``int8`` mode and
the narrowed 16-bit quantized engine), on the CPU, held against the JAX
package on the same numpy inputs.

* the ``int8`` plain versions against ``pallas_histogram(..., mode="int8",
  interpret=True)`` in the lane and the sublane layout, exactly equal;
* the narrowed engine's plain version (``_xla_histogram_narrow``) against
  the JAX package's and against the 32-bit engine, bit for bit, with
  negative grad sums and many chunks; ``hist_bits_in_leaf`` against the
  JAX function;
* ``segment_histogram`` with ``quant``, ``acc_bits`` and nibble-packed
  records against the JAX package's ``segment_histogram``;
* the segment gather's and ``unfused_histogram``'s plain versions, and
  K2's partition alone (``hist=False``);
* training end to end with ``tpu_fused=off`` on both sides: f32 at the lane
  and the sublane layout, quantized with 32-bit and narrowed 16-bit
  histograms, and EFB-bundled quantized data: trees equal split for split,
  predictions within 1e-6 (f32 sums in another order than the JAX XLA
  engine's, on data without near ties, as ``tests/test_torch_train.py``);
  the quantized runs exactly equal to the port's fused run.

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
from lightgbm_tpu.ops import compact as jcompact
from lightgbm_tpu.ops.histogram import _xla_histogram as jax_xla_histogram
from lightgbm_tpu.ops.histogram import \
    _xla_histogram_narrow as jax_xla_narrow
from lightgbm_tpu.ops.histogram import narrow_chunk_rows as jax_narrow_rows
from lightgbm_tpu.ops.pallas_histogram import \
    pallas_histogram as jax_pallas_histogram
from lightgbm_tpu.ops.renew import hist_bits_in_leaf as jax_hist_bits

import lightgbm_tpu_torch as lgt
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.ops.compact import (RowLayout, pack_rows,
                                            record_bins, record_channels,
                                            segment_histogram)
from lightgbm_tpu_torch.ops.fused_split import fused_split
from lightgbm_tpu_torch.ops.histogram import (_xla_histogram,
                                              _xla_histogram_narrow,
                                              histogram_block,
                                              narrow_chunk_rows)
from lightgbm_tpu_torch.ops.pallas_histogram import (
    pallas_histogram, pallas_histogram_narrow, pallas_histogram_sublane,
    segment_gather, unfused_histogram)
from lightgbm_tpu_torch.ops.renew import hist_bits_in_leaf

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

I32 = jnp.int32
PAD = 256
BASE = {"objective": "binary", "num_leaves": 15, "learning_rate": 0.1,
        "min_data_in_leaf": 20, "verbosity": -1, "tpu_grower": "compact"}
QUANT = {"use_quantized_grad": True, "stochastic_rounding": False}


def _codes(n, f, b, seed, qmax=5):
    """Bins and the quantized channel quad (grad codes in [-qmax, qmax],
    hess codes in [0, qmax], in-bag, raw), int8."""
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, b, (n, f)).astype(np.uint8)
    ch = np.stack([rng.randint(-qmax, qmax + 1, n),
                   rng.randint(0, qmax + 1, n), rng.rand(n) > 0.2,
                   np.ones(n)], 1).astype(np.int8)
    return binned, ch


# ---- the int8 modes --------------------------------------------------------

@pytest.mark.parametrize("layout,n,f,b", [
    ("lane", 900, 6, 256), ("lane", 700, 29, 128), ("sublane", 900, 6, 64),
    ("sublane", 513, 11, 16)])
def test_int8_plain_matches_pallas_interpret(layout, n, f, b):
    binned, ch = _codes(n, f, b, seed=n + f)
    ref = np.asarray(jax_pallas_histogram(
        jnp.asarray(binned), jnp.asarray(ch), b, mode="int8",
        interpret=True, row_block=256, hist_layout=layout))
    assert ref.dtype == np.int32
    tb, tc = torch.from_numpy(binned), torch.from_numpy(ch)
    port = pallas_histogram(tb, tc, b, mode="int8", hist_layout=layout)
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), ref)
    # int32 codes give the same sums; the block dispatch takes integer
    # channels to the int8 mode
    np.testing.assert_array_equal(
        histogram_block(tb, tc.to(torch.int32), b, layout).numpy(), ref)
    if layout == "sublane":
        np.testing.assert_array_equal(pallas_histogram_sublane(
            tb.T.contiguous(), tc, b, mode="int8").numpy(), ref)


# ---- the narrowed engine ---------------------------------------------------

@pytest.mark.parametrize("qmax,n", [(5, 300), (5, 5000), (17, 2000),
                                    (31, 1500)])
def test_narrow_plain_matches_reference(qmax, n):
    """Bit-equal to the JAX package's narrowed engine and to the 32-bit
    engine; a constant negative grad column drives negative sums across
    many radix chunks."""
    f, b = 5, 32
    binned, ch = _codes(n, f, b, seed=qmax, qmax=qmax)
    ch[: n // 2, 0] = -qmax
    assert narrow_chunk_rows(qmax) == jax_narrow_rows(qmax) > 0
    ref = np.asarray(jax_xla_narrow(jnp.asarray(binned), jnp.asarray(ch), b,
                                    qmax))
    wide = np.asarray(jax_xla_histogram(jnp.asarray(binned),
                                        jnp.asarray(ch), b))
    np.testing.assert_array_equal(ref, wide)
    tb, tc = torch.from_numpy(binned), torch.from_numpy(ch)
    port = _xla_histogram_narrow(tb, tc, b, qmax)
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), ref)
    np.testing.assert_array_equal(
        pallas_histogram_narrow(tb, tc, b, qmax).numpy(), ref)
    np.testing.assert_array_equal(
        histogram_block(tb, tc, b, acc_bits=16, quant_max=qmax).numpy(), ref)
    np.testing.assert_array_equal(
        _xla_histogram(tb, tc.to(torch.int32), b).numpy(), ref)


def test_narrow_refuses_wide_codes():
    binned, ch = _codes(100, 3, 16, seed=1)
    assert narrow_chunk_rows(40) == jax_narrow_rows(40) == 0
    with pytest.raises(ValueError):
        jax_xla_narrow(jnp.asarray(binned), jnp.asarray(ch), 16, 40)
    with pytest.raises(ValueError):
        _xla_histogram_narrow(torch.from_numpy(binned),
                              torch.from_numpy(ch), 16, 40)


@pytest.mark.parametrize("qmax", [3, 5, 31, 128])
def test_hist_bits_in_leaf_matches_reference(qmax):
    counts = np.array([0, 1, 100, 1023, 6553, 6554, 10922, 32767, 32768,
                       10_000_000])
    ref = np.asarray(jax_hist_bits(jnp.asarray(counts), qmax))
    np.testing.assert_array_equal(
        hist_bits_in_leaf(torch.from_numpy(counts), qmax).numpy(), ref)
    for c in counts[:4]:
        assert int(hist_bits_in_leaf(int(c), qmax)) == int(ref[
            list(counts).index(c)])


# ---- segment histograms ----------------------------------------------------

def _records(n, f, b, seed, packed4=False, quant=True):
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, b, (n, f)).astype(np.uint8)
    if quant:
        g = rng.randint(-2, 3, n).astype(np.float32)
        h = rng.randint(0, 5, n).astype(np.float32)
    else:
        g = (rng.randint(-64, 65, n) / 64.0).astype(np.float32)
        h = (rng.randint(1, 65, n) / 64.0).astype(np.float32)
    cnt = (rng.rand(n) > 0.2).astype(np.float32)
    extras = rng.randn(2, n).astype(np.float32)
    arrays = (binned, g, h, cnt, extras)
    jl = jcompact.RowLayout(num_features=f, num_extra=2, packed4=packed4)
    jw = np.asarray(jax.jit(jcompact.pack_rows,
                            static_argnames=("layout", "pad_rows"))(
        *(jnp.asarray(a) for a in arrays), jl, PAD))
    tl = RowLayout(num_features=f, num_extra=2, packed4=packed4)
    tw = pack_rows(*(torch.from_numpy(a) for a in arrays), tl)
    np.testing.assert_array_equal(tw.numpy(), jw[:n])
    return jl, tl, jw, tw


@pytest.mark.parametrize("quant,acc_bits,packed4,hist_layout", [
    (False, 32, False, "lane"), (True, 32, False, "lane"),
    (True, 16, False, "lane"), (True, 32, True, "sublane"),
    (True, 16, True, "lane"), (False, 32, True, "sublane")])
def test_segment_histogram_matches_reference(quant, acc_bits, packed4,
                                             hist_layout):
    n, f, b = 2600, 7, 16
    jl, tl, jw, tw = _records(n, f, b, seed=acc_bits + packed4, quant=quant,
                              packed4=packed4)
    start, count = 37, 2219
    ref = np.asarray(jax.jit(
        jcompact.segment_histogram,
        static_argnames=("layout", "num_bins", "block_size", "impl",
                         "quantized", "acc_bits", "quant_max"))(
        jnp.asarray(jw), jnp.asarray(start, I32), jnp.asarray(count, I32),
        jl, b, 256, impl="xla", quantized=quant, acc_bits=acc_bits,
        quant_max=5))
    port = segment_histogram(tw, start, count, tl, b, quant, acc_bits, 5,
                             hist_layout).numpy()
    if quant:
        assert port.dtype == np.int32
        np.testing.assert_array_equal(port, ref)
    else:
        # 1/64-grid gradients: exact f32 sums in any order
        np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("packed4", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int8, torch.int32])
def test_segment_gather_plain(dtype, packed4):
    n, f, b = 700, 9, 16
    _, tl, _, tw = _records(n, f, b, seed=3, packed4=packed4,
                            quant=dtype != torch.float32)
    seg = torch.tensor([101, 333, 0], dtype=torch.int32)
    _kernels.reset_counts()
    ch, bt = segment_gather(tw, torch.zeros_like(tw), seg, tl, dtype, True)
    assert _kernels.PLAIN_CALLS["segment_gather"] == 1
    rows = tw[101:434]
    assert ch.dtype == dtype and ch.shape == (n, 4)
    np.testing.assert_array_equal(
        ch[:333].numpy(),
        record_channels(rows, tl, dtype != torch.float32).to(dtype).numpy())
    assert not ch[333:].any()
    np.testing.assert_array_equal(bt[:, :333].numpy(),
                                  record_bins(rows, tl).T.numpy())
    # the segment is clamped to the arrays, as on the card
    ch2, bt2 = segment_gather(tw, torch.zeros_like(tw), torch.tensor(
        [650, 500, 0], dtype=torch.int32), tl, dtype, False)
    assert bt2 is None
    np.testing.assert_array_equal(
        ch2[:50].numpy(),
        record_channels(tw[650:], tl, dtype != torch.float32).to(dtype)
        .numpy())


@pytest.mark.parametrize("quant,narrow", [(False, 0), (True, 0), (True, 5)])
def test_unfused_histogram_plain(quant, narrow):
    n, f, b = 3000, 6, 64
    _, tl, _, tw = _records(n, f, b, seed=9, quant=quant)
    seg = torch.tensor([40, 2900, 0], dtype=torch.int32)
    want = segment_histogram(tw, 40, 2900, tl, b, quant)
    for hist_layout in ("lane", "sublane"):
        got = unfused_histogram(tw, torch.zeros_like(tw), seg, tl, b, quant,
                                narrow, hist_layout)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("dual", [True, False])
@pytest.mark.parametrize("smaller_left", [None, 0, 1])
def test_partition_alone_returns_the_histogram_segment(dual, smaller_left):
    """K2 with ``hist=False``: the same records as the full split, and in
    place of the histogram the (start, count, which) it would have read."""
    n, f, b = 1500, 5, 64
    _, tl, _, tw = _records(n, f, b, seed=4)
    col = tw[200:1300, 2].numpy()
    n_left = int((col <= 20).sum())
    args = (0, 200, 1100, n_left, 2, 20, 0, 0, 0, None, tl, b)
    kw = dict(smaller_left=smaller_left, side=0, dual=dual, quant=True)
    w1, s1, hist = fused_split(tw.clone(), torch.zeros_like(tw), *args, **kw)
    w2, s2, seg = fused_split(tw.clone(), torch.zeros_like(tw), *args,
                              hist=False, **kw)
    assert torch.equal(w1, w2) and torch.equal(s1, s2)
    assert seg.dtype == torch.int32 and seg.shape == (3,)
    start, count, which = seg.tolist()
    np.testing.assert_array_equal(
        hist.numpy(), segment_histogram(s2 if which else w2, start, count,
                                        tl, b, True).numpy())


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
                                   rtol=1e-5, atol=1e-6)


def _train_both(X, y, params, rounds=3):
    p = dict(BASE, tpu_fused="off", **params)
    bj = lgb.train(p, lgb.Dataset(X, label=y, params=p), rounds)
    _kernels.reset_counts()
    tp = dict(p, device_type="cpu")
    bt = lgt.train(tp, lgt.Dataset(X, y, params=tp), rounds)
    return bj, bt


@pytest.mark.parametrize("layout", ["lane", "sublane"])
def test_unfused_f32_matches_reference(layout):
    X, y = _higgs_like(1203, 6)
    params = {"tpu_hist_layout": layout}
    if layout == "sublane":
        params["max_bin"] = 63
    bj, bt = _train_both(X, y, params)
    gp = bt._gbdt.grower_params
    assert not gp.fused and not gp.fused_dual and gp.hist_layout == layout
    assert not bj._gbdt._compact["layout"].packed4
    _assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)
    # the partition alone a split, no fused histogram, no kernel launch
    assert _kernels.PLAIN_CALLS["fused_split"] == 3 * 14
    assert sum(_kernels.LAUNCHES.values()) == 0


@pytest.mark.parametrize("layout", ["lane", "sublane"])
@pytest.mark.parametrize("bits", [32, 16])
def test_unfused_quantized_matches_reference(bits, layout):
    X, y = _higgs_like(4000, 8)
    params = dict(QUANT, tpu_quant_hist_bits=bits, tpu_hist_layout=layout,
                  max_bin=63)
    bj, bt = _train_both(X, y, params)
    gb = bt._gbdt
    assert gb._quant_int and not gb.grower_params.fused
    assert gb.grower_params.quant_narrow == (bits == 16)
    assert gb.grower_params.quant_max == 5
    assert bool(bj._gbdt._quant_narrow_active) == (bits == 16)
    _assert_same_trees(bj._gbdt.models, gb.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)
    # the int32 histograms are exact: the port's fused run grows the same
    # model
    fused = lgt.train(dict(BASE, **params, device_type="cpu"),
                      lgt.Dataset(X, y), 3)
    assert fused._gbdt.grower_params.fused
    assert not fused._gbdt.grower_params.quant_narrow
    np.testing.assert_array_equal(fused.predict(X), bt.predict(X))


def test_narrowed_engine_takes_small_leaves(monkeypatch):
    """The narrowed run picks the 16-bit engine exactly for the leaves
    whose count x quant_max fits 2^15 (here every smaller child at 4,000
    rows and quant_max 5), and the 32-bit one otherwise."""
    from lightgbm_tpu_torch.ops import compact
    seen = []
    real = compact._xla_histogram_narrow

    def spy(*a, **kw):
        seen.append(a[0].shape[0])
        return real(*a, **kw)
    monkeypatch.setattr(compact, "_xla_histogram_narrow", spy)
    X, y = _higgs_like(8000, 6, seed=2)
    p = dict(BASE, **QUANT, tpu_fused="off", tpu_quant_hist_bits=16,
             device_type="cpu")
    bt = lgt.train(p, lgt.Dataset(X, y), 1)
    # the root (8,000 rows x 5 > 2^15) takes 32 bits, every split's
    # smaller child (at most 4,000 rows) 16, and the tree counts them
    assert len(seen) == 14 and max(seen) * 5 < (1 << 15)
    assert int(bt._gbdt.tree_stats["narrowed_leaves"]) == 14


def test_narrow_warns_with_the_fused_kernel(caplog):
    X, y = _higgs_like(3000, 6, seed=13)
    p = dict(BASE, **QUANT, tpu_quant_hist_bits=16, device_type="cpu",
             verbosity=0)
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        bt = lgt.train(p, lgt.Dataset(X, y), 1)
    assert "tpu_fused=off" in caplog.text
    assert not bt._gbdt.grower_params.quant_narrow
    with caplog.at_level(logging.WARNING, logger="lightgbm_tpu_torch"):
        wide = lgt.train(dict(p, tpu_fused="off", num_grad_quant_bins=60),
                         lgt.Dataset(X, y), 1)
    assert not wide._gbdt.grower_params.quant_narrow


def _onehot(n=1500, groups=40, card=8, dense=4, seed=3):
    """One-hot blocks plus dense columns (``tests/test_torch_efb.py``): both
    packages bundle them."""
    rng = np.random.RandomState(seed)
    cats = rng.randint(0, card, size=(n, groups))
    X = np.zeros((n, groups * card), np.float32)
    for g in range(groups):
        X[np.arange(n), g * card + cats[:, g]] = 1.0
    X = np.concatenate([X, rng.randn(n, dense).astype(np.float32)], axis=1)
    y = (X @ (rng.randn(X.shape[1]) * 0.5) + 0.4 * rng.randn(n) > 0
         ).astype(np.float64)
    return X, y


def test_unfused_bundled_quantized_matches_reference():
    """EFB-bundled data without the fused kernel: the copy-back partition
    on the bundle columns, int32 histograms of them."""
    X, y = _onehot()
    bj, bt = _train_both(X, y, dict(QUANT, min_data_in_leaf=10), rounds=2)
    gb = bt._gbdt
    assert gb._efb is not None and not gb.grower_params.fused
    assert bj._gbdt._efb is not None
    _assert_same_trees(bj._gbdt.models, gb.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)
