"""Monotone and interaction constraints and the split scan's other options
(path smoothing, extra trees, ``feature_contri``, CEGB) in the port on the
CPU, held against the JAX package on the same numpy inputs.

* ``best_split`` with each option, on random histograms with categorical
  features (gradients on a 1/64 grid), against the JAX function: the same
  winner, gains within 1e-5 relative;
* ``extra_threshold`` against ``jax.random.randint`` on the same two random
  words; the interaction half of ``node_feature_mask`` against the JAX
  function;
* the intermediate method's walk (``ops/monotone.py``, plain version),
  split by split against the reference's flagged leaves and bounds (the
  JAX grower's walk results, taken with ``jax.debug.callback``);
* training: each option on each grower the reference runs it on, against
  the JAX package's XLA path (``tpu_fused=off``) and, on the compact grower,
  its fused kernel in interpret mode: trees equal split for split,
  predictions within 1e-5. Binary gradients are rounded to a 1/64 grid in
  both packages (``dyadic`` fixture), so every histogram sum is exact and
  no split is a near tie broken by f32 order (ROADMAP C, notes). Extra
  trees take the JAX package's random words through ``GBDT.extra_draws``;
  bagging takes its draws through ``sample_strategy.draws``;
* the fallbacks with their warnings: ``advanced`` runs intermediate,
  intermediate on the masked grower runs basic, lazy CEGB takes the masked
  grower, a constraint on EFB data unbundles (held against the port's own
  run on the dense matrix); parsing and its errors.

The data: 3,000 rows of 8 features, 15 leaves, 3 rounds.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu import objectives as jobj
from lightgbm_tpu.boosting import gbdt as jgbdt
from lightgbm_tpu.ops import grower as jgrower
from lightgbm_tpu.ops import grower_compact as jgc
from lightgbm_tpu.ops import split as jsplit
from lightgbm_tpu_torch import _kernels
from lightgbm_tpu_torch import objectives as tobj
from lightgbm_tpu_torch.boosting import gbdt as gbdt_mod
from lightgbm_tpu_torch.ops import grower_compact as tgc
from lightgbm_tpu_torch.ops import monotone as tmono
from lightgbm_tpu_torch.ops import split as tsplit
from lightgbm_tpu_torch.ops.grower import ExtraDraws, node_feature_mask
from test_torch_categorical import _hist
from test_torch_sampling import assert_same_trees, jax_uniform

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
        "verbosity": -1}
# the interpret-mode oracle contracts one row block at a time (a smaller
# program; 1/64-grid sums are exact either way)
ORACLES = {"xla": {"tpu_fused": "off"},
           "fused_interpret": {"tpu_fused": "on",
                               "tpu_fused_interpret": True,
                               "tpu_hist_mbatch": 1}}
MONO = [1, -1, 0, 1, 0, 0, -1, 0]
INTER = [[0, 1, 2], [2, 3, 4, 5], [6, 7]]


def _words(keys, f):
    """The two random 32-bit words ``jax.random.randint`` draws for each of
    ``f`` values from each key of ``keys [R, 2]``: ``[R, f, 2]`` int64."""
    def one(k):
        k1, k2 = jax.random.split(k)
        return jnp.stack([jax.random.bits(k1, (f,), jnp.uint32),
                          jax.random.bits(k2, (f,), jnp.uint32)], -1)
    return torch.from_numpy(np.asarray(jax.vmap(one)(keys)).astype(np.int64))


def jax_extra(seed):
    """The JAX growers' extra-trees words of tree ``t``: node row ``j`` from
    ``fold_in(fold_in(PRNGKey(extra_seed), t), j)``, its sorted prefix from
    that key folded with 1, the rescan of leaf ``i`` after split ``k`` from
    ``fold_in(fold_in(fold_in(key, 1 << 20), k), i)``."""
    base = jax.random.PRNGKey(seed)
    fold = jax.random.fold_in

    def draws(t, L, f, intermediate):
        key = fold(base, t)
        nk = jax.vmap(lambda j: fold(key, j))(jnp.arange(2 * L - 1))
        out = [_words(nk, f), _words(jax.vmap(lambda k: fold(k, 1))(nk), f)]
        if intermediate:
            rk = fold(key, jgrower._RESCAN_FOLD_STRIDE)
            kk = jax.vmap(lambda k: jax.vmap(lambda i: fold(fold(rk, k), i))(
                jnp.arange(L)))(jnp.arange(L - 1)).reshape(-1, 2)
            out += [_words(kk, f).reshape(L - 1, L, f, 2),
                    _words(jax.vmap(lambda k: fold(k, 1))(kk), f)
                    .reshape(L - 1, L, f, 2)]
        return ExtraDraws(*out)
    return draws


@pytest.fixture
def dyadic(monkeypatch):
    """Binary gradients and hessians rounded to a 1/64 grid in both
    packages."""
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


@pytest.fixture
def same_draws(monkeypatch):
    """Every port GBDT made in the test takes the JAX package's extra-trees
    words and bagging draws."""
    init = gbdt_mod.GBDT.__init__

    def patched(self, *a, **kw):
        init(self, *a, **kw)
        self.extra_draws = jax_extra(self._extra_seed)
        self.sample_strategy.draws = jax_uniform
    monkeypatch.setattr(gbdt_mod.GBDT, "__init__", patched)


def _data(n=3000, f=8, cat=False, seed=7):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X[:, 0] - 0.4 * X[:, 2] + 0.3 * X[:, 3] - 0.3 * X[:, 6]
         + 0.3 * rng.randn(n) > 0).astype(np.float64)
    kw = {}
    if cat:
        X[:, 5] = rng.randint(0, 12, n)
        X[:, 7] = rng.randint(0, 3, n)
        kw = {"categorical_feature": [5, 7]}
    return X, y, kw


def train_both(params, grower, oracle="xla", rounds=3, cat=False):
    X, y, kw = _data(cat=cat)
    p = dict(BASE, tpu_grower=grower, **params)
    bj = lgb.train(dict(p, **ORACLES[oracle]), lgb.Dataset(X, label=y, **kw),
                   rounds)
    _kernels.reset_counts()
    bt = lgt.train(dict(p, device_type="cpu"), lgt.Dataset(X, y, **kw),
                   rounds)
    return bj, bt, X


def check(bj, bt, X, compact):
    assert bt._gbdt.use_compact == bj._gbdt._use_compact == compact
    assert sum(_kernels.LAUNCHES.values()) == 0
    assert_same_trees(bj._gbdt.models, bt._gbdt.models)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-5)


# ---- the scan ---------------------------------------------------------------

SCAN_OPTS = {
    "monotone": dict(use_monotone=True),
    "penalty": dict(use_monotone=True, monotone_penalty=1.5),
    "penalty_small": dict(use_monotone=True, monotone_penalty=0.5),
    "smooth": dict(path_smooth=3.0),
    "smooth_monotone": dict(use_monotone=True, path_smooth=1.0,
                            lambda_l1=0.1),
    "cegb": dict(use_cegb=True, cegb_split_pen=1e-3),
    "contri": dict(),
    "extra": dict(extra_trees=True),
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("opt", sorted(SCAN_OPTS))
def test_best_split_options_match_jax(opt, seed):
    hist, nb, is_cat = _hist(seed * 5 + 1)
    F = len(nb)
    tot = hist[0].sum(0)
    rng = np.random.RandomState(seed)
    kw = dict(SCAN_OPTS[opt], min_data_per_group=20.0)
    mono = rng.randint(-1, 2, F).astype(np.int8)
    cmin, cmax = np.float32(-0.05), np.float32(0.04)
    pout = np.float32(0.01)
    depth = 2
    pen = (rng.rand(F) * 3).astype(np.float32)
    contri = (0.3 + rng.rand(F)).astype(np.float32) if opt == "contri" \
        else None
    key = jax.random.PRNGKey(seed)
    z = np.zeros(F, np.int32)
    j = jsplit.best_split(
        jnp.asarray(hist), jnp.float32(tot[0]), jnp.float32(tot[1]),
        jnp.float32(tot[2]), jnp.asarray(nb), jnp.asarray(z),
        jnp.zeros(F, bool), jnp.asarray(is_cat), jnp.ones(F, bool),
        jsplit.SplitParams(**kw), jnp.asarray(mono), jnp.float32(cmin),
        jnp.float32(cmax), jnp.float32(pout), jnp.int32(depth),
        jnp.asarray(pen), key,
        None if contri is None else jnp.asarray(contri))

    def one(x):
        return torch.tensor(x)[None]
    t = tsplit.best_split(
        torch.from_numpy(hist)[None], one(tot[0]), one(tot[1]),
        one(tot[2]), torch.from_numpy(nb), torch.from_numpy(z),
        torch.zeros(F, dtype=torch.bool), torch.ones(F, dtype=torch.bool),
        tsplit.SplitParams(**kw), torch.from_numpy(is_cat),
        mono_types=torch.from_numpy(mono.astype(np.int64)),
        cmin=one(cmin), cmax=one(cmax), parent_output=one(pout),
        depth=torch.tensor([depth]), cegb_pen=torch.from_numpy(pen)[None],
        extra_words=_words(key[None], F),
        extra_words_cat=_words(jax.random.fold_in(key, 1)[None], F),
        feature_contri=None if contri is None else torch.from_numpy(contri))
    for name in ("feature", "bin", "default_left", "is_cat_l2"):
        assert int(getattr(t, name)[0]) == int(getattr(j, name)), name
    np.testing.assert_array_equal(t.cat_bitset[0].numpy(),
                                  np.asarray(j.cat_bitset).view(np.int32))
    np.testing.assert_allclose(float(t.gain[0]), float(j.gain), rtol=1e-5)


def test_monotone_vetoes_and_outputs():
    """A split on a +1 feature whose left output would exceed its right is
    never chosen; children's outputs are smoothed, then clipped."""
    p = tsplit.SplitParams(use_monotone=True, path_smooth=2.0)
    g, h, c = torch.tensor([-3.0, 5.0]), torch.tensor([4.0, 4.0]), \
        torch.tensor([8.0, 8.0])
    w = tsplit.child_output(g, h, c, p, None, torch.tensor(0.5),
                            torch.tensor(-0.2), torch.tensor(0.6))
    raw = -g / h
    smooth = raw * 4.0 / 5.0 + 0.5 / 5.0
    np.testing.assert_allclose(w.numpy(), np.clip(smooth.numpy(), -0.2, 0.6))
    for d, pen in ((0, 0.5), (3, 0.5), (1, 1.5), (4, 3.0), (0, 2.0)):
        np.testing.assert_allclose(
            float(tsplit.monotone_penalty_factor(torch.tensor(d), pen)),
            float(jsplit.monotone_penalty_factor(jnp.int32(d), pen)),
            rtol=1e-6)


def test_extra_threshold_matches_jax_randint():
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        span = jnp.asarray([1, 2, 3, 7, 31, 63, 64, 255, 256, 0])
        want = np.asarray(jax.random.randint(key, (10,), 0,
                                             jnp.maximum(span, 1)))
        got = tsplit.extra_threshold(_words(key[None], 10)[0],
                                     torch.from_numpy(np.array(span)))
        np.testing.assert_array_equal(got.numpy(), want)


def test_interaction_mask_matches_jax():
    rng = np.random.RandomState(0)
    F = 12
    sets = rng.rand(4, F) < 0.4
    fm = rng.rand(F) < 0.9
    jp = jgrower.GrowerParams(use_interaction=True)
    for i in range(20):
        used = rng.rand(F) < (0.1 * (i % 4))
        want = np.asarray(jgrower.node_feature_mask(
            jnp.asarray(fm), jnp.asarray(used), jnp.asarray(sets),
            jax.random.PRNGKey(0), jp))
        got = node_feature_mask(torch.from_numpy(fm), None, 1.0,
                                torch.from_numpy(used),
                                torch.from_numpy(sets))
        np.testing.assert_array_equal(got.numpy(), want)
    # batched leaves, with a by-node draw after the interaction half
    used = rng.rand(3, F) < 0.2
    u = rng.rand(3, F).astype(np.float32)
    got = node_feature_mask(torch.from_numpy(fm), torch.from_numpy(u), 0.5,
                            torch.from_numpy(used), torch.from_numpy(sets))
    for i in range(3):
        one = node_feature_mask(torch.from_numpy(fm), torch.from_numpy(u[i]),
                                0.5, torch.from_numpy(used[i]),
                                torch.from_numpy(sets))
        assert torch.equal(got[i], one)


# ---- the intermediate method's walk ------------------------------------------

def test_walk_matches_reference_split_by_split(dyadic, monkeypatch):
    """The plain walk's flags and bounds after every split of every tree
    equal the reference's (the JAX grower's down-walk results, recorded
    with ``jax.debug.callback``), and some leaves were flagged."""
    ref = []
    real = jax.lax.fori_loop

    class Lax:
        def __getattr__(self, name):
            return getattr(jax.lax, name)

        @staticmethod
        def fori_loop(lo, hi, body, init):
            out = real(lo, hi, body, init)
            if getattr(body, "__name__", "") == "down_one":
                jax.debug.callback(
                    lambda a, b, c: ref.append((np.array(a), np.array(b),
                                                np.array(c))),
                    *out, ordered=True)
            return out
    monkeypatch.setattr(jgc, "lax", Lax())
    got = []
    walk = tmono.monotone_walk_plain

    def recording(node_i, leaf_f, *a):
        flags = walk(node_i, leaf_f, *a)
        got.append((leaf_f[:, tgc._CMIN].numpy().copy(),
                    leaf_f[:, tgc._CMAX].numpy().copy(), flags.numpy()))
        return flags
    monkeypatch.setattr(tmono, "monotone_walk_plain", recording)
    bj, bt, X = train_both({"monotone_constraints": MONO,
                            "monotone_constraints_method": "intermediate"},
                           "compact")
    check(bj, bt, X, True)
    # the JAX grower runs at its leaf rung (16 leaves: one more split a
    # tree, inert, and one more leaf, never flagged)
    L = BASE["num_leaves"]
    per_tree = jgrower.leaf_rung(L) - 1
    assert len(got) == 3 * (L - 1) and len(ref) == 3 * per_tree
    ref = [r for i, r in enumerate(ref) if i % per_tree < L - 1]
    for (a0, a1, a2), (b0, b1, b2) in zip(ref, got):
        assert not a2[L:].any()
        np.testing.assert_array_equal(b2, a2[:L])
        np.testing.assert_array_equal(b0, a0[:L])
        np.testing.assert_array_equal(b1, a1[:L])
    assert sum(int(f.sum()) for _, _, f in got) > 0


def test_walk_of_a_leaf_without_monotone_ancestors():
    """The degenerate walks: a split not under a monotone one (``eff``
    off), and a root split (no ancestor to climb): nothing moves."""
    L = 4
    node_i = torch.full((L - 1, tmono._NODE_I), -1, dtype=torch.int64)
    node_i[0] = torch.tensor([0, 3, 0, -1, -2, -1, 0])
    leaf_f = torch.zeros((L, 10))
    leaf_f[:, tgc._CMIN] = -3.4e38
    leaf_f[:, tgc._CMAX] = 3.4e38
    before = leaf_f.clone()
    for eff in (False, True):
        flags = tmono.monotone_walk(
            node_i, leaf_f, torch.tensor([1, 0]), torch.tensor([eff]),
            torch.tensor([-1]), torch.tensor([0]), torch.tensor([3]),
            torch.tensor(0.1), torch.tensor(-0.1), 0)
        assert flags.shape == (L,) and not flags.any()
        assert torch.equal(leaf_f, before)


# ---- training on both growers --------------------------------------------------

# each option alone or beside the ones it meets in the scan (smoothing
# before the monotone clip, interaction masks before both); the cases keep
# the JAX programs few, since compiling them is most of this file's time
TRAIN = {
    "monotone": {"monotone_constraints": MONO},
    "penalty": {"monotone_constraints": MONO, "monotone_penalty": 1.5},
    "mono_inter_smooth": {"monotone_constraints": MONO,
                          "interaction_constraints": INTER,
                          "path_smooth": 1.0},
    "extra_contri": {"extra_trees": True, "extra_seed": 11,
                     "feature_contri": [1.0, 0.5, 0.8, 1.0, 0.2, 1.0, 1.0,
                                        0.9]},
    "cegb": {"cegb_penalty_split": 1e-3,
             "cegb_penalty_feature_coupled": "0.5,0.5,0.5,2,0.5,0.5,0.5,0.5",
             "cegb_tradeoff": 2.0},
    "mono_bagging": {"monotone_constraints": MONO, "bagging_fraction": 0.7,
                     "bagging_freq": 1},
}
INTERMEDIATE = {"monotone_constraints": MONO,
                "monotone_constraints_method": "intermediate"}


@pytest.mark.parametrize("case", sorted(TRAIN))
def test_masked_matches_reference(case, dyadic, same_draws):
    bj, bt, X = train_both(TRAIN[case], "masked")
    check(bj, bt, X, False)


@pytest.mark.parametrize("case", sorted(TRAIN) + ["intermediate",
                                                  "quantized"])
def test_compact_matches_reference(case, dyadic, same_draws):
    params = {
        "intermediate": INTERMEDIATE,
        "quantized": dict(INTERMEDIATE, use_quantized_grad=True,
                          stochastic_rounding=False),
    }.get(case) or TRAIN[case]
    bj, bt, X = train_both(params, "compact")
    check(bj, bt, X, True)
    if case == "quantized":
        assert bt._gbdt._quant_int and bj._gbdt._use_quant


def test_compact_matches_fused_kernel_interpret(dyadic, same_draws):
    """Every option of the compact grower at once, the intermediate method
    with extra trees' rescan words among them, two rounds against the
    fused kernel in interpret mode."""
    params = dict(INTERMEDIATE, extra_trees=True, path_smooth=1.0,
                  interaction_constraints=INTER, cegb_penalty_split=1e-3,
                  cegb_penalty_feature_coupled=[0.5] * 8,
                  feature_contri=[1.0] * 7 + [0.5])
    bj, bt, X = train_both(params, "compact", "fused_interpret", rounds=2)
    check(bj, bt, X, True)


def test_categorical_options_on_compact(dyadic, same_draws):
    """One-hot and sorted categorical splits with the intermediate method,
    extra trees (their sorted-prefix words) and ``feature_contri``."""
    bj, bt, X = train_both({"monotone_constraints": MONO,
                            "extra_trees": True,
                            "monotone_constraints_method": "intermediate",
                            "feature_contri": [1.0] * 7 + [0.5]},
                           "compact", cat=True)
    check(bj, bt, X, True)


def test_categorical_options_on_masked(dyadic, same_draws):
    bj, bt, X = train_both({"monotone_constraints": MONO,
                            "extra_trees": True, "path_smooth": 1.0},
                           "masked", cat=True)
    check(bj, bt, X, False)


def test_lazy_cegb_takes_the_masked_grower(dyadic, same_draws):
    """Lazy costs keep a charged bitmap in the dataset's row order: the
    masked grower, under ``auto`` and ``compact`` alike; the bitmap
    persists across trees, charged for in-bag rows only."""
    params = {"cegb_penalty_feature_lazy": [0.02] * 8,
              "cegb_penalty_feature_coupled": [0.1] * 8,
              "bagging_fraction": 0.8, "bagging_freq": 1}
    bj, bt, X = train_both(params, "compact")
    check(bj, bt, X, False)
    charged = bt._gbdt._cegb_charged
    assert charged.shape == (8, len(X)) and charged.any()
    np.testing.assert_array_equal(
        charged.numpy(), np.asarray(bj._gbdt._cegb_charged))
    np.testing.assert_array_equal(bt._gbdt._cegb_used.numpy(),
                                  np.asarray(bj._gbdt._cegb_used))


def test_model_text_matches_reference(dyadic, tmp_path):
    """Path smoothing and monotone clipping fix the leaf outputs at split
    time: the trees' values in the model text equal the reference's, the
    parameters block carries the new parameters, and the JAX package loads
    the port's text."""
    bj, bt, X = train_both(TRAIN["mono_inter_smooth"], "compact")
    tj = bj.model_to_string().split("end of trees")[0]
    tt = bt.model_to_string().split("end of trees")[0]
    for key in ("split_feature", "threshold", "decision_type",
                "left_child", "right_child"):
        assert [ln for ln in tt.splitlines() if ln.startswith(key + "=")] \
            == [ln for ln in tj.splitlines() if ln.startswith(key + "=")]
    for key in ("leaf_value", "internal_value"):
        lt = [np.array(ln.split("=")[1].split(), float)
              for ln in tt.splitlines() if ln.startswith(key + "=")]
        lj = [np.array(ln.split("=")[1].split(), float)
              for ln in tj.splitlines() if ln.startswith(key + "=")]
        for a, b in zip(lj, lt):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-7)
    text = bt.model_to_string()
    for frag in ("[path_smooth: 1.0]",
                 "[monotone_constraints: [1, -1, 0, 1, 0, 0, -1, 0]]",
                 "[interaction_constraints: [[0, 1, 2], [2, 3, 4, 5], "
                 "[6, 7]]]"):
        assert frag in text
    path = tmp_path / "m.txt"
    bt.save_model(str(path))
    np.testing.assert_allclose(lgb.Booster(model_file=str(path)).predict(X),
                               bt.predict(X), atol=1e-6)


# ---- fallbacks, parsing, errors ------------------------------------------------

@pytest.mark.parametrize("method,grower,want", [
    ("advanced", "compact", True), ("intermediate", "masked", False),
    ("basic", "compact", False)])
def test_method_fallbacks_warn(method, grower, want, caplog, dyadic):
    """The method each package runs, with their warnings (the JAX runs
    are the training cases' programs: ``monotone`` and ``intermediate``)."""
    X, y, _ = _data()
    p = dict(BASE, monotone_constraints=MONO, tpu_grower=grower,
             monotone_constraints_method=method)
    with caplog.at_level(logging.WARNING):
        bt = lgt.train(dict(p, device_type="cpu", verbosity=1),
                       lgt.Dataset(X, y), 1)
        bj = lgb.train(dict(p, verbosity=1, **ORACLES["xla"]),
                       lgb.Dataset(X, label=y), 1)
    assert bt._gbdt.grower_params.mono_intermediate == want \
        == bj._gbdt.grower_params.mono_intermediate
    if method != "basic":
        for logger in ("lightgbm_tpu_torch", "lightgbm_tpu"):
            assert any(r.name == logger and method in r.getMessage()
                       for r in caplog.records), logger


def test_constraint_on_bundled_data_unbundles(dyadic, caplog):
    """One-hot data that bundles: with a monotone constraint the port
    unbundles first, with a warning (the JAX package's ``_efb_precheck``
    list), and grows the trees of the same run on ``enable_bundle=false``
    data."""
    rng = np.random.RandomState(3)
    n, groups, card = 1000, 32, 8
    cats = rng.randint(0, card, size=(n, groups))
    X = np.zeros((n, groups * card), np.float32)
    for g in range(groups):
        X[np.arange(n), g * card + cats[:, g]] = 1.0
    X = np.concatenate([X, rng.randn(n, 2).astype(np.float32)], axis=1)
    y = (X @ (rng.randn(X.shape[1]) * 0.5) > 0).astype(np.float64)
    mono = [0] * X.shape[1]
    mono[-1] = 1
    p = dict(BASE, monotone_constraints=mono, tpu_grower="compact",
             device_type="cpu")
    assert lgt.Dataset(X, y, params=p).construct()._inner.bundle_info \
        is not None
    with caplog.at_level(logging.WARNING):
        tds = lgt.Dataset(X, y)
        bt = lgt.train(dict(p, verbosity=1), tds, 2)
    assert tds._inner.bundle_info is None and bt._gbdt._efb is None
    assert any("unbundling" in r.getMessage() and "monotone_constraints"
               in r.getMessage() for r in caplog.records)
    dense = lgt.train(dict(p, enable_bundle=False), lgt.Dataset(X, y), 2)
    assert_same_trees(dense._gbdt.models, bt._gbdt.models)
    np.testing.assert_array_equal(bt.predict(X), dense.predict(X))


def test_parsing_matches_reference():
    names = [f"f{i}" for i in range(4)]
    for v in ([1, 0, -1, 0], "1,0,-1,0", "(1,0,-1,0)",
              {"f0": 1, "f2": -1}):
        np.testing.assert_array_equal(
            gbdt_mod._parse_monotone(v, 4, names),
            jgbdt._parse_monotone(v, 4, names))
    assert gbdt_mod._parse_monotone([0, 0, 0, 0], 4, names) is None
    with pytest.raises(ValueError, match="3 entries for 4"):
        gbdt_mod._parse_monotone([1, 0, 0], 4, names)
    for v in ([[0, 1], [2, 3]], "[0,1],[2,3]", [[1, 3]]):
        np.testing.assert_array_equal(
            gbdt_mod._parse_interactions(v, 4),
            jgbdt._parse_interactions(v, 4))
    assert gbdt_mod._parse_interactions([], 4) is None


@pytest.mark.parametrize("params,match", [
    ({"cegb_penalty_feature_coupled": [1.0, 2.0]}, "one entry per feature"),
    ({"feature_contri": [1.0]}, "one entry per feature"),
    ({"cegb_penalty_feature_lazy": "1,2"}, "one entry per feature"),
    ({"monotone_constraints": [1]}, "entries for"),
])
def test_bad_option_vectors_raise(params, match):
    X, y, _ = _data(n=300)
    with pytest.raises(ValueError, match=match):
        lgt.train(dict(BASE, device_type="cpu", **params), lgt.Dataset(X, y),
                  1)


def test_lazy_bitmap_size_gate(monkeypatch):
    X, y, _ = _data(n=300)
    monkeypatch.setattr(gbdt_mod, "_LAZY_CEGB_LIMIT", 8 * 299)
    with pytest.raises(ValueError, match="2\\^30"):
        lgt.train(dict(BASE, device_type="cpu",
                       cegb_penalty_feature_lazy=[1.0] * 8),
                  lgt.Dataset(X, y), 1)


def test_own_draws_are_seeded_and_valid():
    """Without the seam the port draws its own words: the same
    ``extra_seed`` gives the same model, another seed another; the rescan
    words are drawn only with the intermediate method."""
    X, y, _ = _data(n=1200)
    p = dict(BASE, extra_trees=True, device_type="cpu",
             monotone_constraints=MONO, tpu_grower="compact",
             monotone_constraints_method="intermediate")
    a = lgt.train(p, lgt.Dataset(X, y), 2)
    b = lgt.train(p, lgt.Dataset(X, y), 2)
    c = lgt.train(dict(p, extra_seed=99), lgt.Dataset(X, y), 2)
    assert a.model_to_string() == b.model_to_string()
    assert a.model_to_string() != c.model_to_string()
    ex = a._gbdt._extra_words(0, 8)
    L = BASE["num_leaves"]
    assert ex.node.shape == (2 * L - 1, 8, 2) and ex.rescan.shape == (
        L - 1, L, 8, 2)
    assert int(ex.node.min()) >= 0 and int(ex.node.max()) < 1 << 32
