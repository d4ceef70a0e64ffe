"""``lgt.Sequence`` streaming construction against in-memory construction
and the JAX package, on the CPU, after ``tests/test_streaming.py``.

A ``Sequence`` gives rows by index and by range and never the whole raw
matrix: the bin sample is read a row at a time (or in batches where it
takes a third of a sequence), then every batch is binned, and bundled
where EFB plans bundles, into the matrix
(``BinnedDataset.construct_from_sequences``). The matrix, mappers and
bundles equal those of the same rows in memory and of the JAX package's
streaming construction, for one and for several sequences, with a
validation set, on byte and 16-bit bins and on one-hot data that bundles.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt

# one intra-op thread (see test_torch_multiclass.py)
torch.set_num_threads(1)

CPU = {"device_type": "cpu"}


def _gen_seq(base):
    class GenSeq(base):
        """Rows served by index and by range from a private array made from
        a seed (one-hot blocks of ``onehot`` columns where given): the
        Dataset never receives the matrix."""
        batch_size = 1000

        def __init__(self, n, f, seed, onehot=0):
            rng = np.random.RandomState(seed)
            if onehot:
                self._x = np.zeros((n, f), np.float32)
                hot = rng.randint(0, onehot, (n, f // onehot))
                cols = np.arange(f // onehot) * onehot + hot
                self._x[np.arange(n)[:, None], cols] = 1.0
            else:
                self._x = rng.randn(n, f).astype(np.float32)

        def __getitem__(self, idx):
            return self._x[idx].copy()

        def __len__(self):
            return len(self._x)
    return GenSeq


TSeq, JSeq = _gen_seq(lgt.Sequence), _gen_seq(lgb.Sequence)


def _construct_both(jdata, tdata, y, params):
    """The JAX package's and the port's Datasets of the same sequences,
    constructed."""
    jds = lgb.Dataset(jdata, label=y, params=params)
    tds = lgt.Dataset(tdata, y, params=dict(params, **CPU))
    jds.construct()
    tds.construct()
    return jds, tds


@pytest.mark.parametrize("max_bin", [255, 1023])
def test_one_sequence_equals_in_memory_and_jax(max_bin):
    n, f = 5000, 12
    dense = np.asarray(TSeq(n, f, 7)[0:n])
    y = ((dense @ np.random.RandomState(0).randn(f)) > 0).astype(np.float64)
    params = {"objective": "binary", "verbosity": -1, "num_leaves": 15,
              "bin_construct_sample_cnt": 2000, "max_bin": max_bin}
    jds, tds = _construct_both(JSeq(n, f, 7), TSeq(n, f, 7), y, params)
    mem = lgt.Dataset(dense, y, params=dict(params, **CPU)).construct()
    for other in (mem._inner, jds._inner):
        assert tds._inner.binned.dtype == other.binned.dtype
        np.testing.assert_array_equal(tds._inner.binned, other.binned)
        for a, b in zip(tds._inner.mappers, other.mappers):
            np.testing.assert_array_equal(a.bin_upper_bounds,
                                          b.bin_upper_bounds)
    assert tds._inner.binned.dtype == (np.uint8 if max_bin == 255
                                       else np.uint16)
    assert tds.data is None
    bt = lgt.train(dict(params, **CPU), tds, 3)
    bm = lgt.train(dict(params, **CPU), mem, 3)
    assert bt.model_to_string() == bm.model_to_string()


def test_several_sequences_and_a_valid_set():
    n1, n2, f = 3000, 2000, 8
    parts = [TSeq(n1, f, 1), TSeq(n2, f, 500)]
    dense = np.concatenate([np.asarray(s[0:len(s)]) for s in parts])
    y = (dense[:, 0] + dense[:, 1] > 0).astype(np.float64)
    params = {"objective": "binary", "verbosity": -1, "num_leaves": 15,
              "metric": "auc", "bin_construct_sample_cnt": 1500}
    jds, tds = _construct_both([JSeq(n1, f, 1), JSeq(n2, f, 500)], parts, y,
                               params)
    np.testing.assert_array_equal(tds._inner.binned, jds._inner.binned)
    mem = lgt.Dataset(dense, y, params=dict(params, **CPU))
    evals = [{}, {}]
    bst = [lgt.train(dict(params, **CPU), d, 3, callbacks=[
        lgt.record_evaluation(ev)], valid_sets=[d.create_valid(
            dense[:500], y[:500])]) for d, ev in zip((tds, mem), evals)]
    np.testing.assert_array_equal(tds._inner.binned, mem._inner.binned)
    assert bst[0].model_to_string() == bst[1].model_to_string()
    assert evals[0] == evals[1]
    # a Sequence validation set takes the training mappers
    tv = tds.create_valid(TSeq(n1, f, 1), y[:n1]).construct()
    np.testing.assert_array_equal(tv._inner.binned, tds._inner.binned[:n1])


def test_sequences_bundle_as_in_memory():
    """One-hot blocks bundle (EFB) on the streaming path as in memory and
    as in the JAX package."""
    n, f = 4000, 320
    dense = np.asarray(TSeq(n, f, 3, onehot=8)[0:n])
    y = (dense[:, :40].argmax(1) % 3 == 0).astype(np.float64)
    params = {"objective": "binary", "verbosity": -1, "num_leaves": 7}
    jds = lgb.Dataset(JSeq(n, f, 3, onehot=8), label=y, params=params)
    tds = lgt.Dataset(TSeq(n, f, 3, onehot=8), y, params=dict(params, **CPU))
    mem = lgt.Dataset(dense, y, params=dict(params, **CPU))
    jds.construct(), tds.construct(), mem.construct()
    info = tds._inner.bundle_info
    assert info is not None and info.n_columns < f
    for other in (jds._inner, mem._inner):
        np.testing.assert_array_equal(tds._inner.binned, other.binned)
        np.testing.assert_array_equal(info.col_of, other.bundle_info.col_of)
        np.testing.assert_array_equal(info.offset_of,
                                      other.bundle_info.offset_of)


def test_a_short_batch_raises():
    class Short(TSeq):
        def __getitem__(self, idx):
            rows = super().__getitem__(idx)
            return rows[:-1] if isinstance(idx, slice) else rows
    # a small bin sample reads single rows; the batches then come short
    ds = lgt.Dataset(Short(3000, 4, 0), np.zeros(3000),
                     params=dict(CPU, bin_construct_sample_cnt=300))
    with pytest.raises(ValueError, match="rows for a"):
        ds.construct()
