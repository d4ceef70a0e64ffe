"""The port's fused split (lightgbm_tpu_torch.ops.fused_split, plain version
on the CPU) against the JAX package's fused Pallas kernel in interpret mode,
with the cases of tests/test_fused.py.

The record arrays are compared byte for byte: the live ranges after the
merge of dual residency (left child in the parent's array, right child in
the other one), and every row outside the segment in both arrays. The
histogram's count channels are exact; grad/hess sit within 2^-16 * sum
|addends| per cell, the error bound of the TPU kernel's hi/lo-bf16 split
(the port accumulates in f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.compact import RowLayout as JaxLayout
from lightgbm_tpu.ops.compact import pack_rows as jax_pack_rows
from lightgbm_tpu.ops.compact import \
    segments_to_leaf_vectors as jax_leaf_vectors
from lightgbm_tpu.ops.compact import unpack_rows as jax_unpack_rows
from lightgbm_tpu.ops.fused_split import fused_split as jax_fused_split
from lightgbm_tpu_torch.ops.compact import (RowLayout, pack_rows,
                                            partition_segment,
                                            segment_histogram,
                                            segments_to_leaf_vectors,
                                            unpack_rows)
from lightgbm_tpu_torch.ops.fused_split import fused_split

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

I32 = jnp.int32
PAD = 256


def _inputs(n, f, b, seed):
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, b, size=(n, f)).astype(np.uint8)
    g = rng.randn(n).astype(np.float32)
    h = np.abs(rng.randn(n)).astype(np.float32)
    cnt = (rng.rand(n) > 0.25).astype(np.float32)
    extras = rng.randn(1, n).astype(np.float32)
    return binned, g, h, cnt, extras


def _records(n, f, b, seed=0):
    """The same rows packed by both packages; they must agree byte for
    byte (the JAX arrays carry PAD extra rows)."""
    binned, g, h, cnt, extras = _inputs(n, f, b, seed)
    jl = JaxLayout(num_features=f, num_extra=1)
    jw = np.asarray(jax.jit(jax_pack_rows,
                            static_argnames=("layout", "pad_rows"))(
        jnp.asarray(binned), jnp.asarray(g), jnp.asarray(h),
        jnp.asarray(cnt), jnp.asarray(extras), jl, PAD))
    tl = RowLayout(num_features=f, num_extra=1)
    tw = pack_rows(*(torch.from_numpy(a) for a in
                     (binned, g, h, cnt, extras)), tl).numpy()
    np.testing.assert_array_equal(tw, jw[:n])
    return jl, tl, tw


def _abs_grad(work, layout):
    out = work.copy()
    o = layout.grad_off
    g = np.ascontiguousarray(out[:, o:o + 4]).view(np.float32)
    out[:, o:o + 4] = np.abs(g).view(np.uint8)
    return out


def _run_both(work0, other0, jl, tl, b, mode, start, count, n_left, feat,
              bin_, dl=0, nan_bin=0, is_cat=0, bits=None, side=0,
              smaller_left=None):
    """Run both packages from the parent array ``work0`` (in ``side``) and
    the other array ``other0``; returns (jax arrays, port arrays) as
    (side array, other array, hist)."""
    n = work0.shape[0]
    bits = np.zeros(8, np.uint32) if bits is None else bits
    pad = np.zeros((PAD, work0.shape[1]), np.uint8)
    jp, jo = np.concatenate([work0, pad]), np.concatenate([other0, pad])
    jw, js = (jo, jp) if side else (jp, jo)
    kw = {"side": jnp.asarray(side, I32)}
    if smaller_left is not None:
        kw["smaller_left"] = jnp.asarray(smaller_left, I32)
    rw, rs, rh = jax_fused_split(
        jnp.asarray(jw), jnp.asarray(js), jnp.asarray(mode, I32),
        jnp.asarray(start, I32), jnp.asarray(count, I32),
        jnp.asarray(n_left, I32), jnp.asarray(feat, I32),
        jnp.asarray(bin_, I32), jnp.asarray(dl, I32),
        jnp.asarray(nan_bin, I32), jnp.asarray(is_cat, I32),
        jnp.asarray(bits), jl, b, 128, 8, interpret=True, **kw)
    rw, rs = np.asarray(rw)[:n], np.asarray(rs)[:n]
    tp, to = torch.from_numpy(work0.copy()), torch.from_numpy(other0.copy())
    tw, ts = (to, tp) if side else (tp, to)
    tw, ts, th = fused_split(
        tw, ts, mode, start, count, n_left, feat, bin_, dl, nan_bin, is_cat,
        torch.from_numpy(bits.view(np.int32)), tl, b,
        smaller_left=smaller_left, side=side)
    tw, ts = tw.numpy(), ts.numpy()
    jax_out = (rs, rw, np.asarray(rh)) if side else (rw, rs, np.asarray(rh))
    port_out = (ts, tw, th.numpy()) if side else (tw, ts, th.numpy())
    return jax_out, port_out


def _merged(side_arr, other_arr, start, count, n_left):
    out = side_arr.copy()
    out[start + n_left:start + count] = other_arr[start + n_left:
                                                  start + count]
    return out


def _check(jax_out, port_out, work0, other0, start, count, n_left, scale):
    (js, jo, jh), (ts, to, th) = jax_out, port_out
    np.testing.assert_array_equal(_merged(ts, to, start, count, n_left),
                                  _merged(js, jo, start, count, n_left))
    outside = np.ones(work0.shape[0], bool)
    outside[start:start + count] = False
    np.testing.assert_array_equal(ts[outside], work0[outside])
    np.testing.assert_array_equal(to[outside], other0[outside])
    np.testing.assert_array_equal(th[..., 2:], jh[..., 2:])
    err = np.abs(th[..., :2] - jh[..., :2])
    assert np.all(err <= 2.0 ** -16 * scale[..., :2] + 1e-30)


def _n_left(col, bin_, dl=False, nan_bin=0):
    return int(((col <= bin_) | (dl & (col == nan_bin))).sum())


def _child_range(start, count, n_left, smaller_left=None):
    """(start, count) of the child whose histogram the split returns."""
    if smaller_left is None:
        smaller_left = n_left <= count - n_left
    s, c = ((start, n_left) if smaller_left
            else (start + n_left, count - n_left))
    return s, c


@pytest.mark.parametrize("start,count", [(0, 3000), (37, 2219), (96, 128),
                                         (500, 1), (200, 0)])
def test_partition_and_hist_parity(start, count):
    n, f, b = 3000, 5, 256
    jl, tl, work0 = _records(n, f, b, seed=start + count)
    other0 = np.zeros_like(work0)
    feat, bin_ = 2, 100
    n_left = _n_left(work0[start:start + count, feat], bin_)
    jax_out, port_out = _run_both(work0, other0, jl, tl, b, 0, start, count,
                                  n_left, feat, bin_)
    # scale: the same split of |grad| records, plain version
    aw = torch.from_numpy(_abs_grad(work0, tl))
    aw, _ = partition_segment(aw, start, count, feat, bin_, False, 0, False,
                              torch.zeros(1, dtype=torch.int32))
    s, c = _child_range(start, count, n_left)
    scale = segment_histogram(aw, s, c, tl, b).numpy()
    _check(jax_out, port_out, work0, other0, start, count, n_left, scale)


def test_mode1_root_histogram():
    n, f, b = 2500, 5, 256
    jl, tl, work0 = _records(n, f, b, seed=9)
    start, count = 41, 2300
    jax_out, port_out = _run_both(work0, np.zeros_like(work0), jl, tl, b, 1,
                                  start, count, 0, 0, 0)
    np.testing.assert_array_equal(port_out[0], work0)
    np.testing.assert_array_equal(port_out[1], 0)
    scale = segment_histogram(torch.from_numpy(_abs_grad(work0, tl)), start,
                              count, tl, b).numpy()
    th, jh = port_out[2], jax_out[2]
    np.testing.assert_array_equal(th[..., 2:], jh[..., 2:])
    assert np.all(np.abs(th[..., :2] - jh[..., :2])
                  <= 2.0 ** -16 * scale[..., :2] + 1e-30)


def _full_split_case(n, f, b, seed, feat, bin_, dl=0, nan_bin=0, is_cat=0,
                     bits=None, side=0, smaller_left=None, start=0,
                     count=None):
    jl, tl, work0 = _records(n, f, b, seed=seed)
    count = n - start if count is None else count
    # the other array holds stale records, which must survive outside the
    # segment (finite floats, as in the grower: the TPU kernel's masked
    # histogram lanes would turn NaN bytes into NaN sums)
    other0 = pack_rows(*(torch.from_numpy(a) for a in
                         _inputs(n, f, b, seed + 1)), tl).numpy()
    col = work0[start:start + count, feat].astype(np.int64)
    if is_cat:
        gl = (bits[col // 32] >> (col % 32)) & 1
        n_left = int(gl.sum())
    else:
        n_left = _n_left(col, bin_, bool(dl), nan_bin)
    jax_out, port_out = _run_both(work0, other0, jl, tl, b, 0, start, count,
                                  n_left, feat, bin_, dl, nan_bin, is_cat,
                                  bits, side, smaller_left)
    aw = torch.from_numpy(_abs_grad(work0, tl))
    tbits = torch.from_numpy((np.zeros(8, np.uint32) if bits is None
                              else bits).view(np.int32))
    aw, _ = partition_segment(aw, start, count, feat, bin_, bool(dl),
                              nan_bin, bool(is_cat), tbits)
    s, c = _child_range(start, count, n_left, smaller_left)
    scale = segment_histogram(aw, s, c, tl, b).numpy()
    _check(jax_out, port_out, work0, other0, start, count, n_left, scale)
    return n_left


def test_nan_default_left():
    n_left = _full_split_case(2000, 4, 64, 11, feat=1, bin_=20, dl=1,
                              nan_bin=63)
    assert 0 < n_left < 2000


def test_categorical_bitset():
    bits = np.zeros(8, np.uint32)
    for cat in (3, 17, 100, 255):
        bits[cat // 32] |= np.uint32(1) << np.uint32(cat % 32)
    _full_split_case(1500, 4, 256, 12, feat=3, bin_=0, is_cat=1, bits=bits)


@pytest.mark.parametrize("start,count", [(0, None), (37, 1900)])
def test_parent_in_scratch(start, count):
    """side = 1: the parent lives in scratch; the left child stays there and
    the right child lands in work."""
    _full_split_case(2000, 5, 256, 13, feat=2, bin_=90, side=1, start=start,
                     count=count)


@pytest.mark.parametrize("smaller_left", [0, 1])
def test_forced_smaller_left(smaller_left):
    """The caller names the child to histogram (both ways, whichever is
    smaller)."""
    _full_split_case(2000, 5, 256, 14, feat=0, bin_=60,
                     smaller_left=smaller_left, start=64, count=1800)


@pytest.mark.parametrize("f,extra", [(7, 1), (28, 4), (5, 0)])
def test_pack_unpack_round_trip(f, extra):
    n = 500
    binned, g, h, cnt, _ = _inputs(n, f, 64, seed=21)
    extras = np.random.RandomState(22).randn(extra, n).astype(np.float32)
    tl = RowLayout(num_features=f, num_extra=extra)
    assert tl.num_cols % 128 == 0
    work = pack_rows(*(torch.from_numpy(a) for a in
                       (binned, g, h, cnt, extras)), tl)
    ref = jax_unpack_rows(jnp.asarray(work.numpy()), n,
                          JaxLayout(num_features=f, num_extra=extra))
    for got, want, orig in zip(unpack_rows(work, n, tl), ref,
                               (binned, g, h, cnt, extras)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy(), orig)


def test_segments_to_leaf_vectors():
    """Final leaf segments tile the rows, empty leaves included."""
    start = np.array([0, 120, 120, 300, 500], np.int32)
    rows = np.array([120, 0, 180, 200, 0], np.int32)
    value = np.array([0.5, 2.0, -1.0, 3.0, 7.0], np.float32)
    got = segments_to_leaf_vectors(*(torch.from_numpy(a) for a in
                                     (start, rows, value)), 500)
    want = jax_leaf_vectors(jnp.asarray(start), jnp.asarray(rows),
                            jnp.asarray(value), 500)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].tolist() == [0] * 120 + [2] * 180 + [3] * 200


@pytest.mark.parametrize("side,f,extra", [(0, 5, 1), (1, 29, 2), (0, 28, 3)])
def test_plain_split_moves_real_vectors_only(side, f, extra):
    """The kernel's write pattern, held by its plain version on the CPU: the
    left child in place in the parent's array, the right child in the
    other; only the first ``moved_cols`` bytes of a row move (the padding
    after them keeps whatever it held), the other array's left range and
    every row outside the segment keep theirs."""
    n, b, start, count = 1200, 256, 45, 1000
    rng = np.random.RandomState(f)
    tl = RowLayout(num_features=f, num_extra=extra)
    binned, g, h, cnt, _ = _inputs(n, f, b, seed=f)
    ex = rng.randn(extra, n).astype(np.float32)
    parent = pack_rows(*(torch.from_numpy(a) for a in
                         (binned, g, h, cnt, ex)), tl)
    mv = tl.moved_cols
    assert mv % 16 == 0 and tl.num_real_cols <= mv <= tl.num_cols
    parent[:, mv:] = torch.from_numpy(
        rng.randint(0, 256, (n, tl.num_cols - mv)).astype(np.uint8))
    other = torch.from_numpy(rng.randint(0, 256, parent.shape)
                             .astype(np.uint8))
    p0, o0 = parent.clone(), other.clone()
    feat, bin_ = 1, 120
    gl = p0[start:start + count, feat] <= bin_
    n_left = int(gl.sum())
    arrays = (other, parent) if side else (parent, other)
    fused_split(*arrays, 0, start, count, n_left, feat, bin_, 0, 0, 0, None,
                tl, b, side=side)
    seg = p0[start:start + count]
    assert torch.equal(parent[start:start + n_left, :mv], seg[gl][:, :mv])
    assert torch.equal(other[start + n_left:start + count, :mv],
                       seg[~gl][:, :mv])
    assert torch.equal(parent[:, mv:], p0[:, mv:])
    assert torch.equal(other[:, mv:], o0[:, mv:])
    assert torch.equal(other[start:start + n_left], o0[start:start + n_left])
    for arr, before in ((parent, p0), (other, o0)):
        assert torch.equal(arr[:start], before[:start])
        assert torch.equal(arr[start + count:], before[start + count:])


@pytest.mark.parametrize("start,count,smaller_left,f", [
    (0, 2000, None, 5), (37, 1900, None, 5), (64, 1800, 0, 5),
    (64, 1800, 1, 5), (500, 1, None, 5), (200, 0, None, 5),
    (41, 1500, None, 140)])
def test_copy_back_matches_dual_and_reference(start, count, smaller_left, f):
    """K2's copy-back variant (``dual=False``, the JAX package's choice on
    EFB-bundled data), plain version: ``work`` ends in the row order the
    dual variant leaves once its two arrays are merged, every row outside
    the segment keeps its bytes, the histogram is the dual variant's bit
    for bit, and ``work`` equals the JAX kernel's copy-back variant in
    interpret mode (f = 140: a record wider than 128 bytes; one row block
    a contraction, ``mbatch=1``: the same sums, a smaller program)."""
    n, b = 2000, 256
    jl, tl, work0 = _records(n, f, b, seed=start + count + f)
    other0 = pack_rows(*(torch.from_numpy(a) for a in
                         _inputs(n, f, b, start + 1)), tl).numpy()
    feat, bin_ = 2, 90
    n_left = _n_left(work0[start:start + count, feat], bin_)
    cb_w, cb_s, cb_h = fused_split(
        torch.from_numpy(work0.copy()), torch.from_numpy(other0.copy()), 0,
        start, count, n_left, feat, bin_, 0, 0, 0, None, tl, b,
        smaller_left=smaller_left, side=1, dual=False)
    du_w, du_s, du_h = fused_split(
        torch.from_numpy(work0.copy()), torch.from_numpy(other0.copy()), 0,
        start, count, n_left, feat, bin_, 0, 0, 0, None, tl, b,
        smaller_left=smaller_left, side=0)
    cb_w = cb_w.numpy()
    np.testing.assert_array_equal(
        cb_w, _merged(du_w.numpy(), du_s.numpy(), start, count, n_left))
    outside = np.ones(n, bool)
    outside[start:start + count] = False
    np.testing.assert_array_equal(cb_w[outside], work0[outside])
    np.testing.assert_array_equal(cb_s.numpy()[outside], other0[outside])
    np.testing.assert_array_equal(cb_h.numpy(), du_h.numpy())

    pad = np.zeros((PAD, work0.shape[1]), np.uint8)
    kw = {} if smaller_left is None else {
        "smaller_left": jnp.asarray(smaller_left, I32)}
    rw, _, rh = jax_fused_split(
        jnp.asarray(np.concatenate([work0, pad])),
        jnp.asarray(np.concatenate([other0, pad])), jnp.asarray(0, I32),
        *(jnp.asarray(v, I32) for v in (start, count, n_left, feat, bin_, 0,
                                        0, 0)),
        jnp.asarray(np.zeros(8, np.uint32)), jl, b, 128, 8, interpret=True,
        dual=False, mbatch=1, **kw)
    np.testing.assert_array_equal(cb_w, np.asarray(rw)[:n])
    aw = torch.from_numpy(_abs_grad(cb_w, tl))
    s, c = _child_range(start, count, n_left, smaller_left)
    scale = segment_histogram(aw, s, c, tl, b).numpy()
    rh = np.asarray(rh)
    np.testing.assert_array_equal(cb_h.numpy()[..., 2:], rh[..., 2:])
    assert np.all(np.abs(cb_h.numpy()[..., :2] - rh[..., :2])
                  <= 2.0 ** -16 * scale[..., :2] + 1e-30)
