"""The port's small-bin histogram (K3's wrappers in
``lightgbm_tpu_torch.ops.pallas_histogram``, plain on the CPU) against the
JAX package's ``_hist_kernel_sublane``, run in interpret mode on the CPU
(``pallas_histogram(..., hist_layout="sublane", interpret=True,
row_block=256)``, as ``tests/test_pack4_train.py`` runs it).

Tolerances, per (feature, bin) cell, relative to S = sum |addends|:

* count channels (in-bag indicator, raw count) are exact: both sum 0/1
  values in f32, exact below 2^24;
* against the ``f32`` mode, grad/hess within 1e-5 * S: the same f32
  addends summed in another order;
* against the default ``split`` mode, grad/hess within 2^-16 * S: the TPU
  kernel splits each channel into a hi and a lo bf16 part (at most 2^-17
  relative error an addend); the port accumulates in f32;
* against ``bf16``, within 1e-5 * S of the channels rounded to bf16 first,
  which both do.

Bins >= B are dropped by both, and B > 64 raises ``ValueError`` on both
sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.pallas_histogram import pallas_histogram as jax_pallas
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.ops.histogram import histogram, histogram_block
from lightgbm_tpu_torch.ops.pallas_histogram import (
    SMEM_PER_BLOCK, SUBLANE_COLUMNS, SUBLANE_ROWS_PER_LANE,
    SUBLANE_SMALL_ROWS, SUBLANE_SMALL_TILE, pallas_histogram,
    pallas_histogram_sublane, pallas_histogram_sublane_plain,
    sublane_active_lanes, sublane_geometry, sublane_small_geometry,
    sublane_tile_geometry)

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

N = 1000   # not a multiple of the 256-row block


def _inputs(n, f, b, k, seed, over=0):
    """Bins in [0, b + over) (``over`` > 0: some bins >= B, dropped) and
    channels (grad, hess, in-bag, raw count)[:k]."""
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, b + over, size=(n, f)).astype(np.uint8)
    ch = np.stack([rng.randn(n), np.abs(rng.randn(n)),
                   (rng.rand(n) > 0.2).astype(np.float64), np.ones(n)],
                  axis=1)[:, :k].astype(np.float32)
    return binned, ch


def _abs_sum(binned, ch, b):
    """float64 histogram of |channels| (the tolerance scale)."""
    out = np.zeros((binned.shape[1], b, ch.shape[1]))
    for f in range(binned.shape[1]):
        keep = binned[:, f] < b
        np.add.at(out[f], binned[keep, f], np.abs(ch[keep]).astype(np.float64))
    return out


def _assert_hist(port, ref, scale, rel):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_array_equal(port[..., 2:], ref[..., 2:])
    err = np.abs(port[..., :2] - ref[..., :2])
    worst = float((err / (rel * scale[..., :2] + 1e-30)).max())
    assert worst <= 1.0, worst


@pytest.mark.parametrize("b,f,k,mode,over", [
    (2, 1, 1, "split", 0), (2, 5, 4, "f32", 3), (17, 5, 3, "f32", 4),
    (17, 28, 1, "split", 0), (63, 28, 4, "split", 1), (63, 5, 3, "bf16", 0),
    (64, 28, 3, "f32", 0), (64, 1, 4, "split", 0)])
def test_sublane_vs_pallas_interpret(b, f, k, mode, over):
    binned, ch = _inputs(N, f, b, k, seed=b * 100 + f + k, over=over)
    ref = jax_pallas(jnp.asarray(binned), jnp.asarray(ch), b, mode=mode,
                     interpret=True, row_block=256, hist_layout="sublane")
    _kernels.reset_counts()
    port = pallas_histogram(torch.from_numpy(binned), torch.from_numpy(ch), b,
                            mode=mode, hist_layout="sublane")
    assert _kernels.PLAIN_CALLS["histogram_sublane"] == 1
    assert _kernels.PLAIN_CALLS["histogram"] == 0
    assert sum(_kernels.LAUNCHES.values()) == 0
    ch_ref = ch
    if mode == "bf16":
        ch_ref = np.asarray(jnp.asarray(ch).astype(jnp.bfloat16)
                            .astype(jnp.float32))
    rel = 2.0 ** -16 if mode == "split" else 1e-5
    _assert_hist(port.numpy(), ref, _abs_sum(binned, ch_ref, b), rel)
    if over:
        # rows whose bin is >= B are in no cell
        kept = (binned < b).sum(axis=0)
        if k == 4:
            np.testing.assert_array_equal(port[..., 3].sum(dim=1).numpy(),
                                          kept)


def test_feature_major_entries_agree():
    """The masked grower's entry (bins already ``[F, N]``) and
    ``histogram_block``/``histogram`` with ``layout="sublane"`` give the
    transposing wrapper's result bit for bit."""
    binned, ch = _inputs(N, 6, 64, 3, seed=4, over=2)
    tb, tc = torch.from_numpy(binned), torch.from_numpy(ch)
    want = pallas_histogram(tb, tc, 64, mode="f32", hist_layout="sublane")
    bt = tb.T.contiguous()
    for got in (pallas_histogram_sublane(bt, tc, 64, mode="f32"),
                pallas_histogram_sublane_plain(bt, tc, 64, mode="f32"),
                histogram_block(tb, tc, 64, layout="sublane"),
                histogram_block(tb, tc, 64, layout="sublane", binned_t=bt),
                histogram(tb, tc, 64, layout="sublane", binned_t=bt)):
        assert torch.equal(got, want)
    # the lane layout sums the same addends in the same order on the CPU
    assert torch.equal(histogram(tb, tc, 64, layout="lane"), want)


def test_wide_bins_and_bad_inputs_raise():
    binned, ch = _inputs(300, 2, 64, 4, seed=1)
    with pytest.raises(ValueError):
        jax_pallas(jnp.asarray(binned), jnp.asarray(ch), 65, interpret=True,
                   row_block=256, hist_layout="sublane")
    tb, tc = torch.from_numpy(binned), torch.from_numpy(ch)
    with pytest.raises(ValueError, match="64"):
        pallas_histogram(tb, tc, 65, hist_layout="sublane")
    with pytest.raises(ValueError, match="64"):
        pallas_histogram_sublane(tb.T.contiguous(), tc, 65)
    with pytest.raises(ValueError):
        pallas_histogram_sublane(tb, tc, 64)            # [N, F], not [F, N]
    with pytest.raises(ValueError):
        pallas_histogram(tb, tc, 64, hist_layout="diagonal")
    with pytest.raises(ValueError):
        histogram_block(tb, tc, 64, layout="diagonal")
    # int8 takes the quantized codes: float channels are refused, as the
    # JAX wrapper refuses them
    with pytest.raises(ValueError):
        pallas_histogram_sublane(tb.T.contiguous(), tc, 64, mode="int8")


# K3's mapping of (chunk, block, warp, item, lane, step) to (row, feature),
# replayed in numpy from its launch geometry.
def _small_coverage(geom, n, num_features, live):
    out = np.zeros((num_features, n), np.int64)
    rows_of_lane = (np.arange(32)[:, None] * 8 + np.arange(8)).ravel()
    for y in range(geom.chunks):
        f0 = y * geom.fc
        fcc = min(geom.fc, num_features - f0)
        n_groups = -(-fcc // geom.group)
        items = -(-n // SUBLANE_SMALL_TILE) * n_groups
        for item in range(items):       # every (block, warp) stride order
            rows = item // n_groups * SUBLANE_SMALL_TILE + rows_of_lane
            rows = rows[(rows < n)]
            rows = rows[live[rows]]
            g = item % n_groups
            for f in range(g * geom.group, min(fcc, (g + 1) * geom.group)):
                out[f0 + f, rows] += 1
    return out


def sublane_coverage(geom, n, num_features, live=None):
    """Replays K3's mapping of (chunk, block, warp, item, lane, step) to
    (row, feature) in numpy, with its pending tiles: an item whose live
    rows (``live [n]`` bool, default all) fill at most 3/4 of a tile moves
    them into the warp's pending tile, added when the next item would not
    fit and at the end. Returns the ``[num_features, n]`` count of adds
    each (feature, row) gets: 1 for every live row, 0 for the others, when
    the mapping is right. Raises AssertionError where two active lanes of a
    warp would write one histogram column at one step (a bank conflict,
    and a race in a private copy)."""
    live = np.ones(n, bool) if live is None else np.asarray(live, bool)
    if geom.small:
        return _small_coverage(geom, n, num_features, live)
    out = np.zeros((num_features, n), np.int64)
    rpl = SUBLANE_ROWS_PER_LANE
    for y in range(geom.chunks):
        f0 = y * geom.fc
        fcc = min(geom.fc, num_features - f0)
        na = sublane_active_lanes(fcc)
        cap = rpl * na
        rep, base = np.arange(na) // fcc, np.arange(na) % fcc
        n_groups = -(-fcc // geom.group)
        items = -(-n // cap) * n_groups

        def add(rows, j0, j1):
            """Steps [j0, j1) of a tile whose lane l holds rows[l]
            ([na, 4], -1 for none)."""
            for j in range(j0, j1):
                f = (base + j) % fcc
                cols = rep * fcc + f
                assert cols.max() < SUBLANE_COLUMNS \
                    and len(set(cols.tolist())) == na, (y, j)
                feats = np.broadcast_to((f0 + f)[:, None], rows.shape)
                keep = rows >= 0
                np.add.at(out, (feats[keep], rows[keep]), 1)

        for x in range(geom.grid_x):
            for w in range(geom.warps):
                pend = []
                for item in range(x * geom.warps + w, items,
                                  geom.grid_x * geom.warps):
                    rows = (item // n_groups * cap + rpl * np.arange(na)[
                        :, None] + np.arange(rpl))
                    rows = np.where(rows < n, rows, -1)
                    on = (rows >= 0) & live[np.maximum(rows, 0)]
                    cnt = int(on.sum())
                    if cnt == 0:
                        continue
                    if n_groups > 1 or 4 * cnt > 3 * cap:
                        g = item % n_groups
                        add(np.where(on, rows, -1), g * geom.group,
                            min(fcc, (g + 1) * geom.group))
                        continue
                    if len(pend) + cnt > cap:
                        tile = np.full(cap, -1)
                        tile[:len(pend)] = pend
                        add(tile.reshape(na, rpl), 0, fcc)
                        pend = []
                    pend += rows[on].tolist()   # lane-major, as the kernel
                if pend:
                    tile = np.full(cap, -1)
                    tile[:len(pend)] = pend
                    add(tile.reshape(na, rpl), 0, fcc)
    return out



# K3's launch geometry (computed on the host, passed to the kernel) and the
# kernel's mapping of (block, warp, lane, step) to (row, feature), replayed
# in numpy: every (row, feature) is added exactly once, and the active lanes
# of a warp write different histogram columns at every step. Both paths:
# the tile path (private copies, feature rotation) and the small-data path.
@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("b", [2, 17, 64])
@pytest.mark.parametrize("f", [1, 27, 28, 32, 33, 100])
def test_sublane_geometry_covers_each_row_feature_once(f, b, small):
    path = sublane_small_geometry if small else sublane_tile_geometry
    for n in (1, 7, 33, 2_049, 20_000):
        geom = path(n, f, b, 3, num_sms=132)
        assert geom.small == small
        assert geom.smem <= SMEM_PER_BLOCK
        assert geom.chunks * geom.fc >= f > (geom.chunks - 1) * geom.fc
        cover = sublane_coverage(geom, n, f)
        assert cover.shape == (f, n)
        assert (cover == 1).all(), (n, geom)


def test_sublane_geometry_picks_the_path_by_rows():
    """Up to SUBLANE_SMALL_ROWS rows the small-data path (its fixed costs a
    launch are lower), above it the tile path."""
    n = SUBLANE_SMALL_ROWS
    small = sublane_geometry(n, 28, 64, 3, num_sms=132)
    big = sublane_geometry(n + 1, 28, 64, 3, num_sms=132)
    assert small == sublane_small_geometry(n, 28, 64, 3, 132)
    assert big == sublane_tile_geometry(n + 1, 28, 64, 3, 132)
    assert small.small and small.warps == 8 and small.warp_bytes == 0
    assert not big.small and big.warps == 7
    assert big.smem == 7 * (64 * 3 * SUBLANE_COLUMNS * 4 + big.warp_bytes)
    with pytest.raises(ValueError):
        sublane_geometry(n, 28, 65, 3, num_sms=132)
    with pytest.raises(ValueError):
        sublane_geometry(n, 28, 64, 9, num_sms=132)


@pytest.mark.parametrize("live", ["one_in_eight", "ten_percent", "runs",
                                  "none"])
@pytest.mark.parametrize("f", [5, 28, 33])
def test_sublane_pending_tiles_cover_live_rows_once(f, live):
    """Sparse inputs (the masked grower's deep splits) on the tile path:
    items whose live rows fill at most 3/4 of a tile go through the warp's
    pending tile. Every live (row, feature) is added once, every other one
    never; the small path skips dead rows in place."""
    rng = np.random.RandomState(f)
    for n in (33, 2_049, 200_000):
        mask = {"one_in_eight": np.arange(n) % 8 == 0,
                "ten_percent": rng.rand(n) < 0.1,
                # long live runs beside sparse stretches: dense and
                # pending items in one warp
                "runs": (np.arange(n) // 3000) % 2 == 0,
                "none": np.zeros(n, bool)}[live]
        want = np.broadcast_to(mask.astype(np.int64), (f, n))
        for path in (sublane_tile_geometry, sublane_small_geometry):
            geom = path(n, f, 64, 3, num_sms=132)
            np.testing.assert_array_equal(
                sublane_coverage(geom, n, f, live=mask), want)


@pytest.mark.parametrize("k", [1, 2, 4, 6])
def test_sublane_geometry_warps_cover_once(k):
    """The tile path's block sizes that the channel count leaves at
    B = 64 (at F = 28: 8 warps at K = 1 and 2, 5 at K = 4, 3 at K = 6; a
    private copy each) cover every (row, feature) once."""
    want = {1: 8, 2: 8, 4: 5, 6: 3}[k]
    for n, f in ((20_000, 28), (2_049, 33), (777, 100)):
        geom = sublane_tile_geometry(n, f, 64, k, num_sms=132)
        assert not geom.small and (f != 28 or geom.warps == want)
        assert (sublane_coverage(geom, n, f) == 1).all()


@pytest.mark.parametrize("k", range(1, 9))
def test_sublane_geometry_fits_a_block(k):
    """Every channel count at every bin count fits one block's shared
    memory, on both paths, and the tile path's layout holds what its
    kernel addresses: the copies, then a warp's stage, pending tile and
    pending channels (the checks of the C entry)."""
    for b in (1, 2, 17, 63, 64):
        for f in (1, 28, 32, 33, 100):
            for n, path in ((20_000, sublane_small_geometry),
                            (20_000, sublane_tile_geometry),
                            (1_000_000, sublane_tile_geometry)):
                geom = path(n, f, b, k, num_sms=132)
                assert geom.smem <= SMEM_PER_BLOCK
                if geom.small:
                    assert geom.smem >= geom.fc * b * (k | 1) * 4
                else:
                    lanes = max(sublane_active_lanes(min(
                        geom.fc, f - y * geom.fc)) for y in range(
                            geom.chunks))
                    assert geom.warp_bytes % 16 == 0
                    assert geom.warp_bytes >= 2 * geom.fc * 128 \
                        + 16 * k * lanes
                    assert geom.smem == geom.warps * (
                        b * k * SUBLANE_COLUMNS * 4 + geom.warp_bytes)
                assert 1 <= geom.warps <= 8
                assert geom.blocks_per_sm >= 1 and geom.grid_x >= 1
                assert 1 <= geom.group <= geom.fc
                assert geom.fc <= (f if geom.small else min(f, 32))


def test_sublane_geometry_spreads_small_data():
    """On the tile path the masked path's 20k rows are 179 tiles: items
    take fewer rotation steps so that every SM gets a block; at 10.5M rows
    an item takes the whole chunk. A block holds 7 private copies at
    B = 64, K = 3."""
    small = sublane_tile_geometry(20_000, 28, 64, 3, num_sms=132)
    items = -(-20_000 // 112) * -(-small.fc // small.group)
    assert small.group < small.fc and small.grid_x <= 132
    assert items <= small.grid_x * small.warps < items + small.warps
    big = sublane_geometry(10_500_000, 28, 64, 3, num_sms=132)
    assert big.group == big.fc == 28 and big.grid_x == 132
    assert big.warps == 7
    assert sublane_active_lanes(28) == 28 and sublane_active_lanes(5) == 28
    assert sublane_active_lanes(1) == 32 and sublane_active_lanes(17) == 16
