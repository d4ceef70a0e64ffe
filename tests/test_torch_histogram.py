"""The port's histogram (lightgbm_tpu_torch.ops.pallas_histogram and
ops.histogram) against the JAX package's Pallas kernel, run in interpret
mode on the CPU, and its XLA histogram.

Tolerances, per (feature, bin) cell, relative to S = sum |addends|:

* count channels (in-bag indicator, raw count) are exact: both sum 0/1
  values in f32, exact below 2^24;
* against the Pallas ``split`` mode, grad/hess within 2^-16 * S: the TPU
  kernel splits each f32 channel into a hi and a lo bf16 part, which leaves
  at most 2^-17 relative error per addend; the port accumulates in f32;
* against ``f32``/``bf16`` modes and the XLA histogram, grad/hess within
  1e-6 * S: the same addends summed in another order in f32.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops.histogram import _xla_histogram as jax_xla_histogram
from lightgbm_tpu.ops.pallas_histogram import pallas_histogram as jax_pallas
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.ops.histogram import histogram_block
from lightgbm_tpu_torch.ops.pallas_histogram import (pallas_histogram,
                                                     record_histogram)
from lightgbm_tpu_torch.ops.compact import RowLayout, pack_rows

N, F = 3000, 5


def _inputs(b, k, seed=0, max_bin=None):
    rng = np.random.RandomState(seed)
    binned = rng.randint(0, max_bin or b, size=(N, F)).astype(np.uint8)
    ch = np.stack([rng.randn(N), np.abs(rng.randn(N)),
                   (rng.rand(N) > 0.2).astype(np.float64), np.ones(N)]
                  + [rng.randn(N) for _ in range(max(k - 4, 0))], axis=1)
    return binned, ch[:, :k].astype(np.float32)


def _abs_sum(binned, ch, b):
    return _xla_np(binned, np.abs(ch), b)


def _xla_np(binned, ch, b):
    """float64 numpy histogram (tolerance scale only)."""
    out = np.zeros((binned.shape[1], b, ch.shape[1]))
    for f in range(binned.shape[1]):
        keep = binned[:, f] < b
        np.add.at(out[f], binned[keep, f], ch[keep].astype(np.float64))
    return out


def _assert_hist(port, ref, scale, rel, counts_from=2):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    if ref.shape[-1] > counts_from:
        np.testing.assert_array_equal(port[..., counts_from:4],
                                      ref[..., counts_from:4])
    err = np.abs(port[..., :counts_from] - ref[..., :counts_from])
    assert np.all(err <= rel * scale[..., :counts_from] + 1e-30), \
        float((err / (scale[..., :counts_from] + 1e-30)).max())


@pytest.mark.parametrize("b", [64, 256])
def test_split_mode_vs_pallas_interpret(b):
    binned, ch = _inputs(b, 4, seed=b)
    ref = jax_pallas(jnp.asarray(binned), jnp.asarray(ch), b, mode="split",
                     interpret=True)
    port = pallas_histogram(torch.from_numpy(binned), torch.from_numpy(ch),
                            b, mode="split")
    _assert_hist(port.numpy(), ref, _abs_sum(binned, ch, b), 2.0 ** -16)


@pytest.mark.parametrize("mode,k", [("f32", 4), ("f32", 8), ("bf16", 3)])
@pytest.mark.parametrize("b", [64, 256])
def test_f32_bf16_modes_vs_pallas_interpret(mode, k, b):
    binned, ch = _inputs(b, k, seed=k + b)
    ref = jax_pallas(jnp.asarray(binned), jnp.asarray(ch), b, mode=mode,
                     interpret=True)
    port = pallas_histogram(torch.from_numpy(binned), torch.from_numpy(ch),
                            b, mode=mode)
    ch_ref = ch
    if mode == "bf16":
        # the same function as the TPU's: channels rounded to bf16 first
        ch_ref = np.asarray(jnp.asarray(ch).astype(jnp.bfloat16)
                            .astype(jnp.float32))
    # in bf16 mode the count channels are indicator values, exact in bf16
    _assert_hist(port.numpy(), ref, _abs_sum(binned, ch_ref, b), 1e-6,
                 counts_from=2 if k >= 3 else k)


@pytest.mark.parametrize("b,max_bin", [(64, None), (256, None), (64, 80)])
def test_plain_vs_xla_histogram(b, max_bin):
    """Bins >= num_bins are dropped by both (the one-hot has no column for
    them)."""
    binned, ch = _inputs(b, 4, seed=3, max_bin=max_bin)
    ref = jax_xla_histogram(jnp.asarray(binned), jnp.asarray(ch), b)
    port = histogram_block(torch.from_numpy(binned), torch.from_numpy(ch), b)
    _assert_hist(port.numpy(), ref, _abs_sum(binned, ch, b), 1e-6)


def test_record_histogram_matches_dense():
    """Record mode reads bins and channels from the packed rows, F = 5 so the
    grad column sits at an unaligned byte offset."""
    b = 64
    binned, ch = _inputs(b, 4, seed=5)
    layout = RowLayout(num_features=F, num_extra=2)
    assert layout.grad_off % 4 != 0
    extras = torch.zeros(2, N)
    work = pack_rows(torch.from_numpy(binned), torch.from_numpy(ch[:, 0]),
                     torch.from_numpy(ch[:, 1]), torch.from_numpy(ch[:, 2]),
                     extras, layout)
    seg = torch.tensor([100, 2500, 0], dtype=torch.int32)
    port = record_histogram(work, torch.zeros_like(work), seg, layout, b)
    ch_rec = ch.copy()
    ch_rec[:, 3] = 1.0
    ref = pallas_histogram(torch.from_numpy(binned[100:2600]),
                           torch.from_numpy(ch_rec[100:2600]), b, mode="f32")
    np.testing.assert_array_equal(port.numpy(), ref.numpy())


@pytest.mark.parametrize("seg,clamped", [
    ((N - 100, 1000, 0), (N - 100, 100)), ((-7, 50, 0), (0, 50)),
    ((N + 10, 5, 0), (N, 0)), ((20, -3, 1), (20, 0))])
def test_record_histogram_clamps_the_segment(seg, clamped):
    """A segment outside the arrays reads only the rows inside them, as the
    kernel's device-side clamp does."""
    b = 64
    binned, ch = _inputs(b, 4, seed=6)
    layout = RowLayout(num_features=F, num_extra=2)
    work = pack_rows(torch.from_numpy(binned), torch.from_numpy(ch[:, 0]),
                     torch.from_numpy(ch[:, 1]), torch.from_numpy(ch[:, 2]),
                     torch.zeros(2, N), layout)
    scratch = work.flip(0).contiguous()
    port = record_histogram(work, scratch, torch.tensor(seg, dtype=torch.int32),
                            layout, b)
    ref = record_histogram(work, scratch, torch.tensor(
        [clamped[0], clamped[1], seg[2]], dtype=torch.int32), layout, b)
    np.testing.assert_array_equal(port.numpy(), ref.numpy())
    assert float(port[..., 3].sum()) == clamped[1] * F


def test_modes_and_shapes_are_checked():
    binned, ch = _inputs(64, 4)
    tb, tc = torch.from_numpy(binned), torch.from_numpy(ch)
    with pytest.raises(NotImplementedError):
        pallas_histogram(tb, tc, 64, mode="int8")
    with pytest.raises(ValueError):
        pallas_histogram(tb, torch.zeros(N, 5), 64, mode="split")
    with pytest.raises(ValueError):
        pallas_histogram(tb, tc[:10], 64)


def test_cpu_tensors_take_the_plain_version():
    binned, ch = _inputs(64, 4)
    _kernels.reset_counts()
    pallas_histogram(torch.from_numpy(binned), torch.from_numpy(ch), 64)
    assert _kernels.LAUNCHES["histogram"] == 0
    assert _kernels.PLAIN_CALLS["histogram"] == 1
