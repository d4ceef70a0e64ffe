"""Row and feature sampling in the port on the CPU, held against the JAX
package on the same numpy inputs.

The JAX package draws with threefry keys, which torch cannot reproduce, so
the port takes the same draws through its seams: ``draws`` of
``boosting/sample_strategy.py`` (``jax.random.uniform(PRNGKey(seed),
(size,))``, the key the JAX strategy makes from the same seed) and
``GBDT.bynode_draws`` (row ``j`` of tree ``t`` is ``jax.random.uniform(
fold_in(fold_in(PRNGKey(feature_fraction_seed), t), j), (F,))``, the JAX
growers' by-node key). ``feature_fraction`` needs no seam: both packages
pick with ``numpy.random.RandomState(feature_fraction_seed)``.

* the bagging masks (uniform, balanced, by query; reused between fresh
  draws) and GOSS's mask and amplification, exactly equal, and GOSS's
  threshold against ``jnp.quantile`` with ties;
* training end to end: bagging on the compact grower (``bagging_freq`` 1
  and 3, so that a reused bag rides the permuted records; multiclass, whose
  later trees of an iteration read the stored bag) against both JAX oracles
  (its XLA compact path, ``tpu_fused=off``, and its fused kernel in
  interpret mode); balanced and by-query bagging on the masked grower; GOSS
  on both growers; ``feature_fraction`` on both growers and on EFB data;
  ``feature_fraction_bynode`` on both growers; bagging with quantized
  gradients and ``quant_train_renew_leaf`` on both growers. Trees equal
  split for split, predictions within 1e-5 (f32 sums in another order);
* the grower each sampling mode takes, equal to the JAX package's.

The JAX package's serial compact state pads its records with spare rows
after the ``num_data`` real ones, but its bag vector has ``num_data``
entries, one a record position, as the port's does: the same draws land
on the same positions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.boosting import sample_strategy as jss
from lightgbm_tpu.config import Config as JaxConfig
from lightgbm_tpu.io.dataset import Metadata as JaxMetadata
from lightgbm_tpu.ops.grower import GrowerParams as JaxGrowerParams
from lightgbm_tpu.ops.grower import node_feature_mask as jax_node_mask
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
from lightgbm_tpu_torch.boosting import sample_strategy as tss
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.io.dataset import Metadata
from lightgbm_tpu_torch.ops.grower import node_feature_mask

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

CPU = torch.device("cpu")
BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
        "verbosity": -1}
ORACLES = {"xla": {"tpu_fused": "off"},
           "fused_interpret": {"tpu_fused": "on",
                               "tpu_fused_interpret": True}}


def jax_uniform(seed, size):
    """The JAX strategies' draws for a seed (``PRNGKey(seed)``)."""
    return torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(seed), (size,))))


def jax_bynode(ff_seed):
    """The JAX growers' by-node draws of tree ``t``: row ``j`` from
    ``fold_in(fold_in(PRNGKey(ff_seed), t), j)``."""
    base = jax.random.PRNGKey(ff_seed)

    def draws(t, rows, feats):
        key = jax.random.fold_in(base, t)
        return torch.from_numpy(np.stack([np.array(jax.random.uniform(
            jax.random.fold_in(key, j), (feats,))) for j in range(rows)]))
    return draws


@pytest.fixture
def same_draws(monkeypatch):
    """Every port GBDT made in the test takes the JAX package's draws."""
    init = gbdt_mod.GBDT.__init__

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        self.sample_strategy.draws = jax_uniform
        self.bynode_draws = jax_bynode(self._bynode_seed)
    monkeypatch.setattr(gbdt_mod.GBDT, "__init__", patched)


def higgs_like(n, f, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] - 0.4 * X[:, 2] + 0.3 * rng.randn(n) > 0).astype(np.float64)
    return X, y


def onehot(n=1500, groups=40, card=8, dense=4, seed=3):
    """One-hot blocks plus dense columns: both packages bundle them."""
    rng = np.random.RandomState(seed)
    cats = rng.randint(0, card, size=(n, groups))
    X = np.zeros((n, groups * card), np.float32)
    for g in range(groups):
        X[np.arange(n), g * card + cats[:, g]] = 1.0
    X = np.concatenate([X, rng.randn(n, dense).astype(np.float32)], axis=1)
    y = (X @ (rng.randn(X.shape[1]) * 0.5) + 0.4 * rng.randn(n) > 0
         ).astype(np.float64)
    return X, y


def assert_same_trees(tj, tt):
    assert len(tj) == len(tt)
    for a, b in zip(tj, tt):
        n = a.num_nodes
        assert b.num_nodes == n and b.num_leaves == a.num_leaves
        for name in ("split_feature", "split_bin", "default_left",
                     "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(b, name)[:n],
                                          getattr(a, name)[:n], err_msg=name)
        # a small leaf's gradient sum is its parent's minus its sibling's,
        # and f32 cancellation there leaves errors of a few 1e-6 absolute
        np.testing.assert_allclose(b.leaf_value[:n + 1], a.leaf_value[:n + 1],
                                   rtol=0, atol=1e-5)


def train_both(X, y, params, rounds, jax_extra=None, **ds_kw):
    bj = lgb.train(dict(params, **(jax_extra or ORACLES["xla"])),
                   lgb.Dataset(X, label=y, **ds_kw), rounds)
    bt = lgt.train(dict(params, device_type="cpu"),
                   lgt.Dataset(X, y, **ds_kw), rounds)
    return bj, bt


def check_parity(bj, bt, X, compact):
    assert bt._gbdt.use_compact == bj._gbdt._use_compact == compact
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)


# ---- the strategies ---------------------------------------------------------

def _metadata(cls, y, group=None):
    md = cls(len(y))
    md.set_label(y)
    if group is not None:
        md.set_group(group)
    return md


@pytest.mark.parametrize("params", [
    {"bagging_fraction": 0.6, "bagging_freq": 3},
    {"bagging_fraction": 0.9, "bagging_freq": 1,
     "pos_bagging_fraction": 0.3, "neg_bagging_fraction": 0.7},
    {"bagging_fraction": 0.5, "bagging_freq": 2, "bagging_by_query": True},
], ids=["uniform", "balanced", "by_query"])
def test_bagging_masks_match_reference(params):
    n = 1000
    y = (np.arange(n) % 3 == 0).astype(np.float64)
    group = np.full(50, 20)
    md_t = _metadata(Metadata, y, group)
    md_j = _metadata(JaxMetadata, y, group)
    ts = tss.create_sample_strategy(Config(params), n, md_t, CPU)
    js = jss.create_sample_strategy(JaxConfig(params), n, md_j)
    ts.draws = jax_uniform
    assert ts.enabled and js.enabled
    freq = params["bagging_freq"]
    for it in range(7):
        mt = ts.bag_mask(it, None, None)
        mj = js.bag_mask(it, None, None)
        assert ts.last_fresh == js.last_fresh == (it % freq == 0)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    if params.get("bagging_by_query"):
        per_query = mt.numpy().reshape(50, 20)
        assert (per_query == per_query[:, :1]).all()


def test_bagging_off_gives_no_mask():
    """No draw without bagging_freq, nor with bagging_fraction 1 (the
    config then turns bagging_freq off, as the JAX package's does)."""
    for params in ({}, {"bagging_fraction": 0.5},
                   {"bagging_fraction": 1.0, "bagging_freq": 2}):
        ts = tss.create_sample_strategy(Config(params), 10, None, CPU)
        assert not ts.enabled and ts.bag_mask(0, None, None) is None
        assert not ts.last_fresh


@pytest.mark.parametrize("k", [1, 3])
def test_goss_mask_and_amplification_match_reference(k):
    n = 2000
    rng = np.random.RandomState(k)
    g = rng.randn(k, n).astype(np.float32)
    h = (0.1 + rng.rand(k, n)).astype(np.float32)
    g[:, :300] = 0.5                        # ties across the threshold
    h[:, :300] = 1.0
    params = {"data_sample_strategy": "goss", "learning_rate": 0.25,
              "top_rate": 0.15, "other_rate": 0.2}
    ts = tss.create_sample_strategy(Config(params), n, None, CPU)
    js = jss.create_sample_strategy(JaxConfig(params), n, None)
    ts.draws = jax_uniform
    for it in (0, 3, 4, 9):
        mt = ts.bag_mask(it, torch.from_numpy(g), torch.from_numpy(h))
        mj = js.bag_mask(it, jnp.asarray(g), jnp.asarray(h))
        assert ts.last_fresh == js.last_fresh == (it >= 4)
        if it < 4:                          # the warm-up: 1 / learning_rate
            assert mt is None and mj is None and ts.amplify is None
            continue
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        np.testing.assert_array_equal(ts.amplify.numpy(),
                                      np.asarray(js._amplify))
        sg, sh = ts.scale_grad_hess(mt, torch.from_numpy(g),
                                    torch.from_numpy(h))
        jg, jh = js.scale_grad_hess(mj, jnp.asarray(g), jnp.asarray(h))
        np.testing.assert_array_equal(sg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(sh.numpy(), np.asarray(jh))


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4097])
@pytest.mark.parametrize("q", [0.0, 0.2, 0.5, 0.8, 0.9, 1.0])
def test_goss_threshold_matches_jnp_quantile(n, q):
    rng = np.random.RandomState(n)
    x = rng.rand(n).astype(np.float32)
    x[: n // 3] = x[0]                      # ties
    want = np.asarray(jnp.quantile(jnp.asarray(x), 1.0 - q))
    got = tss.linear_quantile(torch.from_numpy(x), 1.0 - q)
    assert got.dim() == 0 and got.dtype == torch.float32
    assert float(got) == float(want)


def test_goss_threshold_of_nan_is_nan():
    x = torch.tensor([1.0, float("nan"), 2.0])
    assert torch.isnan(tss.linear_quantile(x, 0.5))


@pytest.mark.parametrize("frac", [0.3, 0.8])
def test_node_feature_mask_matches_reference(frac):
    rng = np.random.RandomState(0)
    fm = rng.rand(3, 40) < 0.7
    fm[2, :] = False
    fm[2, 5] = True                         # one feature: usually all drop
    u = rng.rand(3, 40).astype(np.float32)
    for i in range(3):
        # the JAX function's rule (grower.py:335-339) on these draws
        keep = u[i] < frac
        keep = keep if (keep & fm[i]).any() else np.ones_like(keep)
        want = fm[i] & keep
        got = node_feature_mask(torch.from_numpy(fm[i]),
                                torch.from_numpy(u[i]), frac)
        np.testing.assert_array_equal(got.numpy(), want)
    batched = node_feature_mask(torch.from_numpy(fm), torch.from_numpy(u),
                                frac)
    for i in range(3):
        np.testing.assert_array_equal(
            batched[i].numpy(),
            node_feature_mask(torch.from_numpy(fm[i]),
                              torch.from_numpy(u[i]), frac).numpy())


def test_node_feature_mask_on_jax_draws():
    """The JAX function on its own key against the port's rule on that
    key's draws."""
    fm = np.random.RandomState(1).rand(30) < 0.6
    key = jax.random.fold_in(jax.random.PRNGKey(2), 5)
    gp = JaxGrowerParams(bynode_fraction=0.4)
    want = np.asarray(jax_node_mask(jnp.asarray(fm), jnp.zeros(30, bool),
                                    None, key, gp))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (30,))))
    got = node_feature_mask(torch.from_numpy(fm), u, 0.4)
    np.testing.assert_array_equal(got.numpy(), want)


# ---- training ---------------------------------------------------------------

@pytest.mark.parametrize("freq", [1, 3])
def test_bagged_compact_training_matches_reference(same_draws, freq):
    X, y = higgs_like(3000, 8)
    p = dict(BASE, tpu_grower="compact", bagging_fraction=0.7,
             bagging_freq=freq)
    bj, bt = train_both(X, y, p, 7)
    check_parity(bj, bt, X, True)
    # the records' in-bag column holds the last fresh bag, moved with them
    gb = bt._gbdt
    last_fresh = (6 // freq) * freq
    bag = jax_uniform(3 + last_fresh // freq, 3000).numpy() < 0.7
    stored = gb._bag_col().numpy()
    assert set(np.unique(stored)) == {0.0, 1.0}
    assert stored.sum() == bag.sum()


def test_bagged_compact_training_matches_fused_interpret(same_draws):
    """The JAX package's fused kernel in interpret mode, as the card runs
    K2: a reused bag (bagging_freq 2) in its records."""
    X, y = higgs_like(2000, 6)
    p = dict(BASE, num_leaves=7, tpu_grower="compact", bagging_fraction=0.6,
             bagging_freq=2)
    bj, bt = train_both(X, y, p, 3, ORACLES["fused_interpret"])
    check_parity(bj, bt, X, True)


def _weighted_multiclass(n=2500, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    y = np.argmax(X[:, :3] + 0.5 * rng.randn(n, 3), axis=1).astype(
        np.float64)
    # continuous weights: no exact ties between equal-count categories
    w = (0.5 + rng.rand(n)).astype(np.float32)
    return X, y, w


@pytest.mark.parametrize("grower", ["compact", "masked"])
def test_bagged_multiclass_matches_reference(same_draws, grower):
    """The trees after the first of an iteration read the stored bag."""
    X, y, w = _weighted_multiclass()
    p = dict(BASE, objective="multiclass", num_class=3, num_leaves=7,
             tpu_grower=grower, bagging_fraction=0.6, bagging_freq=2)
    bj, bt = train_both(X, y, p, 4, weight=w)
    assert bt._gbdt.use_compact == bj._gbdt._use_compact \
        == (grower == "compact")
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)


@pytest.mark.parametrize("params", [
    {"bagging_fraction": 0.8, "bagging_freq": 1,
     "pos_bagging_fraction": 0.4, "neg_bagging_fraction": 0.9},
    {"bagging_fraction": 0.6, "bagging_freq": 2, "bagging_by_query": True},
], ids=["balanced", "by_query"])
def test_row_ordered_bagging_takes_the_masked_grower(same_draws, params):
    """Balanced and by-query bagging index rows in the dataset's order:
    the masked grower, even where tpu_grower=compact asks otherwise."""
    X, y = higgs_like(3000, 8)
    p = dict(BASE, tpu_grower="compact", **params)
    bj, bt = train_both(X, y, p, 5, group=np.full(150, 20))
    check_parity(bj, bt, X, False)


@pytest.mark.parametrize("grower", ["compact", "masked"])
def test_goss_training_matches_reference(same_draws, grower):
    """GOSS samples after its warm-up of 1 / learning_rate iterations; on
    the compact grower it ranks the gradients in the records' order and
    its amplification rides in the in-bag column."""
    X, y = higgs_like(3000, 8)
    p = dict(BASE, tpu_grower=grower, data_sample_strategy="goss",
             learning_rate=0.3, top_rate=0.25, other_rate=0.15)
    bj, bt = train_both(X, y, p, 6)
    check_parity(bj, bt, X, grower == "compact")
    if grower == "compact":
        stored = bt._gbdt._bag_col().numpy()
        amp = (1 - 0.25) / 0.15
        assert set(np.unique(stored)) == {0.0, 1.0, np.float32(amp)}


def test_boosting_goss_is_the_goss_strategy(same_draws):
    X, y = higgs_like(2000, 6)
    p = dict(BASE, boosting="goss", learning_rate=0.5, num_leaves=7)
    bj, bt = train_both(X, y, p, 4)
    assert isinstance(bt._gbdt.sample_strategy, tss.GOSSStrategy)
    check_parity(bj, bt, X, False)


@pytest.mark.parametrize("params,compact", [
    ({"bagging_fraction": 0.5, "bagging_freq": 1}, True),
    ({"data_sample_strategy": "goss"}, True),
    ({"pos_bagging_fraction": 0.5, "bagging_fraction": 0.8,
      "bagging_freq": 1}, False),
    ({"neg_bagging_fraction": 0.5}, False),
    ({"bagging_by_query": True}, False),
    ({"feature_fraction": 0.5, "feature_fraction_bynode": 0.5}, True),
])
def test_grower_choice_matches_reference(params, compact):
    """The grower each sampling mode takes at 65,536 rows under ``auto``
    (the JAX package's exclusions, ``boosting/gbdt.py:958-979``), and that
    GOSS closes the external-gradient route of a row-coupled objective."""
    n = 65_536
    X, y = higgs_like(n, 3)
    tb = lgt.Booster(dict(BASE, device_type="cpu", **params),
                     lgt.Dataset(X, y))
    jb = lgb.Booster(dict(BASE, **params), lgb.Dataset(X, label=y))
    assert tb._gbdt.use_compact == jb._gbdt._use_compact == compact
    rank = {"objective": "lambdarank", "tpu_grower": "compact",
            "verbosity": -1}
    for extra, ext in (({}, True), ({"data_sample_strategy": "goss"}, False)):
        Xr, yr = X[:2000], (y[:2000] * 2)
        group = np.full(100, 20)
        tr = lgt.Booster(dict(rank, device_type="cpu", **extra),
                         lgt.Dataset(Xr, yr, group=group))
        jr = lgb.Booster(dict(rank, **extra),
                         lgb.Dataset(Xr, label=yr, group=group))
        assert tr._gbdt._ext_grads == jr._gbdt._ext_grads == ext
        assert tr._gbdt.use_compact == jr._gbdt._use_compact == ext


@pytest.mark.parametrize("grower", ["compact", "masked"])
def test_feature_fraction_matches_reference(grower):
    """No seam: both packages pick with RandomState(feature_fraction_seed)."""
    X, y = higgs_like(3000, 10)
    p = dict(BASE, tpu_grower=grower, feature_fraction=0.6,
             feature_fraction_seed=11)
    bj, bt = train_both(X, y, p, 5)
    check_parity(bj, bt, X, grower == "compact")
    used = {int(f) for m in bt._gbdt.models
            for f in m.split_feature[:m.num_nodes]}
    assert len(used) > 6                    # different features a tree


def test_feature_fraction_on_bundled_data():
    """EFB: the picks are over the scan space (stored columns that are not
    bundles, then one virtual feature a bundled original), as the JAX
    package's ``base_feat_mask``; two rounds, two draws."""
    X, y = onehot()
    p = dict(BASE, min_data_in_leaf=10, feature_fraction=0.5)
    bj, bt = train_both(X, y, p, 2)
    assert bt._gbdt._efb is not None and bj._gbdt._efb is not None
    check_parity(bj, bt, X, True)


@pytest.mark.parametrize("grower", ["compact", "masked"])
def test_feature_fraction_bynode_matches_reference(same_draws, grower):
    X, y = higgs_like(3000, 10)
    p = dict(BASE, tpu_grower=grower, feature_fraction_bynode=0.5,
             feature_fraction=0.8)
    bj, bt = train_both(X, y, p, 4)
    check_parity(bj, bt, X, grower == "compact")


@pytest.mark.parametrize("grower", ["compact", "masked"])
def test_bagged_quantized_renewal_matches_reference(same_draws, grower):
    """``quant_train_renew_leaf`` refits the leaves from the in-bag true
    gradients: the bag multiplies them on both growers (the records'
    sample-weight column on the compact one). L2 gradients are plain f32
    arithmetic in both packages; the binary ones pass through two ``exp``
    implementations, whose ulps reach the renewed leaves and then the
    quantized histograms' exact ties."""
    X, _ = higgs_like(3000, 8)
    y = X[:, 0] - 0.5 * X[:, 2] + 0.3 * np.random.RandomState(3).randn(3000)
    p = dict(BASE, objective="regression", tpu_grower=grower,
             use_quantized_grad=True,
             stochastic_rounding=False, quant_train_renew_leaf=True,
             bagging_fraction=0.5, bagging_freq=2)
    bj, bt = train_both(X, y, p, 5)
    check_parity(bj, bt, X, grower == "compact")
    assert bt._gbdt._quant_int == (grower == "compact")


def test_goss_quantized_takes_the_f32_shim(same_draws):
    """GOSS amplifies its sampled rows by (1 - top_rate) / other_rate, here
    8/3, which integer gradient codes cannot carry: quantized GOSS on the
    compact grower keeps the dequantized-f32 histograms, as the reference
    does."""
    X, _ = higgs_like(3000, 8)
    y = X[:, 0] - 0.5 * X[:, 2] + 0.3 * np.random.RandomState(3).randn(3000)
    p = dict(BASE, objective="regression", tpu_grower="compact",
             use_quantized_grad=True, stochastic_rounding=False,
             data_sample_strategy="goss", learning_rate=0.5,
             top_rate=0.2, other_rate=0.3)
    bj, bt = train_both(X, y, p, 5)
    check_parity(bj, bt, X, True)
    assert not bt._gbdt._quant_int


def test_sampled_training_launches_no_kernel_on_the_cpu(same_draws):
    """On the CPU every kernel call is its plain version."""
    X, y = higgs_like(2000, 6)
    _kernels.reset_counts()
    lgt.train(dict(BASE, device_type="cpu", tpu_grower="compact",
                   bagging_fraction=0.5, bagging_freq=1,
                   feature_fraction_bynode=0.5), lgt.Dataset(X, y), 2)
    assert sum(_kernels.LAUNCHES.values()) == 0
    assert _kernels.PLAIN_CALLS["fused_split"] > 0
