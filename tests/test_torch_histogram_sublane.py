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
    pallas_histogram, pallas_histogram_sublane,
    pallas_histogram_sublane_plain)

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
    with pytest.raises(NotImplementedError):
        pallas_histogram_sublane(tb.T.contiguous(), tc, 64, mode="int8")
