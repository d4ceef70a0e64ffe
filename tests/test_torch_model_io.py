"""The port's model text (``lightgbm_tpu_torch.model_io``) against the JAX
package and stock LightGBM, on the CPU.

* the same trees (trained by the JAX package, carried across by
  ``convert.py``) give the same text, line for line, and the same
  ``dump_model``;
* ``tests/golden/{binary_nan,multiclass,categorical,regression}.model.txt``,
  saved by stock LightGBM, load and predict the golden predictions within
  ``rtol=1e-5, atol=2e-6`` (the tolerance of ``tests/test_interop.py``);
* a JAX multiclass model with categorical splits, carried across, gives
  the JAX package's text line for line (category-value bitsets included);
* text written by the port, trained on each golden's data with its
  parameters (masked grower, ``max_bin=63``), loads into the JAX package's
  ``LoadedGBDT`` and predicts what the port predicts within 1e-6;
* save -> load -> predict round-trips within 1e-6 (the loaded model routes
  raw float64 values on the host, the trained one bins on the device);
* stock LightGBM's ranking golden, a quantile text and a text with a
  linear tree load and predict as the JAX package's loader does;
* ``dump_model`` of a loaded model equals the JAX package's
  ``loaded_dump`` of the same text (its loaded Booster's own
  ``dump_model`` raises ``AttributeError``).
"""
import os

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.model_io import LoadedGBDT as JaxLoaded
from lightgbm_tpu.model_io import booster_to_dict as jax_booster_to_dict
from lightgbm_tpu.model_io import loaded_dump as jax_loaded_dump
from lightgbm_tpu_torch.convert import booster_from_arrays

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# the golden case's parameters (tests/golden/binary_nan.model.txt)
GOLDEN_PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
                 "min_data_in_leaf": 5, "learning_rate": 0.1,
                 "deterministic": True, "verbosity": -1}


def _golden(name="binary_nan"):
    data = np.load(os.path.join(GOLDEN, f"{name}.npz"))
    with open(os.path.join(GOLDEN, f"{name}.model.txt")) as fh:
        return data["X"], data["y"], data["pred"], fh.read()


def _carry(bj, X):
    """The JAX booster's trees, mappers and feature names as a port
    Booster (no init-score split: the first tree keeps it folded in)."""
    fields = ("split_feature", "split_bin", "default_left", "left_child",
              "right_child", "leaf_value", "leaf_depth", "split_gain",
              "leaf_weight", "leaf_count", "internal_value",
              "internal_weight", "internal_count")
    trees = [dict({k: np.asarray(getattr(t, k)) for k in fields},
                  num_leaves=t.num_leaves, num_nodes=t.num_nodes,
                  shrinkage=t.shrinkage) for t in bj._gbdt.models]
    ds = bj._gbdt.train_set
    ms = ds.mappers
    return booster_from_arrays(
        trees, [m.bin_upper_bounds for m in ms], [m.nan_bin for m in ms],
        [m.missing_type for m in ms], [m.num_bins for m in ms],
        params=bj.params, value_ranges=[(m.min_value, m.max_value)
                                        for m in ms],
        feature_names=ds.feature_names)


@pytest.fixture(scope="module")
def jax_and_carried():
    X, y, _, _ = _golden()
    p = dict(GOLDEN_PARAMS, device_type="cpu")
    bj = lgb.train(p, lgb.Dataset(X, label=y), 6)
    return X, bj, _carry(bj, X)


def test_model_text_equals_jax(jax_and_carried):
    X, bj, bt = jax_and_carried
    ours = bt.model_to_string().split("\n")
    theirs = bj.model_to_string().split("\n")
    assert len(ours) == len(theirs)
    for i, (a, b) in enumerate(zip(ours, theirs)):
        assert a == b, f"line {i}: {a!r} != {b!r}"
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)
    # a cut model: the JAX package's text, but for the importances, which
    # count the first num_iteration iterations (LightGBM's
    # SaveModelToString calls FeatureImportance(num_iteration), so a
    # snapshot's text is model_to_string(num_iteration=i)); the JAX
    # package's count every tree of the booster
    cut = bt.model_to_string(num_iteration=2).split("\n")
    ref = bj.model_to_string(num_iteration=2).split("\n")
    at = ref.index("feature_importances:") + 1
    end = ref.index("", at)
    imp = bj.feature_importance("split", iteration=2)
    names = bj.feature_name()
    lines = [f"{names[j]}={int(imp[j])}"
             for j in np.argsort(-imp, kind="stable") if imp[j] > 0]
    assert cut == ref[:at] + lines + ref[end:]


def test_dump_model_equals_jax(jax_and_carried):
    """The JAX package spells the NaN missing type "Nan"; stock LightGBM
    and the port write "NaN"."""
    _, bj, bt = jax_and_carried

    def norm(node):
        if isinstance(node, dict):
            return {k: ("NaN" if k == "missing_type" and v == "Nan"
                        else norm(v)) for k, v in node.items()}
        if isinstance(node, list):
            return [norm(v) for v in node]
        return node
    assert bt.dump_model() == norm(jax_booster_to_dict(bj))


def test_stock_lightgbm_model_loads_and_predicts():
    X, _, pred, text = _golden()
    bst = lgt.Booster(model_str=text)
    assert bst.num_trees() == 12 and bst.num_feature() == 6
    np.testing.assert_allclose(np.asarray(bst.predict(X), np.float64), pred,
                               rtol=1e-5, atol=2e-6)
    ref = lgb.Booster(model_str=text)
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True), atol=1e-7)
    np.testing.assert_allclose(bst.predict(X, num_iteration=5),
                               ref.predict(X, num_iteration=5), atol=1e-7)


# each golden case's parameters (scripts/gen_interop_goldens.py)
CASES = {
    "multiclass": ({"objective": "multiclass", "num_class": 3}, "auto"),
    "categorical": ({"objective": "regression", "min_data_per_group": 10,
                     "cat_smooth": 2.0}, [0]),
    "regression": ({"objective": "regression"}, "auto"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_stock_lightgbm_golden_loads_and_predicts(name):
    X, _, pred, text = _golden(name)
    bst = lgt.Booster(model_str=text)
    k = CASES[name][0].get("num_class", 1)
    assert bst.num_trees() == 12 * k and bst.current_iteration() == 12
    got = np.asarray(bst.predict(X), np.float64)
    assert got.shape == pred.shape
    np.testing.assert_allclose(got, pred, rtol=1e-5, atol=2e-6)
    ref = lgb.Booster(model_str=text)
    np.testing.assert_allclose(bst.predict(X, raw_score=True),
                               ref.predict(X, raw_score=True), atol=1e-7)
    np.testing.assert_allclose(bst.predict(X, num_iteration=5),
                               ref.predict(X, num_iteration=5), atol=1e-7)


@pytest.mark.parametrize("name", list(CASES))
def test_port_golden_case_text_loads_in_jax(name, tmp_path):
    X, y, _, _ = _golden(name)
    extra, cat = CASES[name]
    bt = lgt.train(dict(GOLDEN_PARAMS, **extra, device_type="cpu"),
                   lgt.Dataset(X, y, categorical_feature=cat), 12)
    p = bt.predict(X)
    text = bt.model_to_string()
    if cat != "auto":
        assert "num_cat=1" in text and "cat_threshold=" in text
    path = tmp_path / "model.txt"
    bt.save_model(str(path))
    back = lgt.Booster(model_file=str(path))
    np.testing.assert_allclose(back.predict(X), p, atol=1e-6)
    jax_loaded = lgb.Booster(model_str=text)
    np.testing.assert_allclose(jax_loaded.predict(X), p, atol=1e-6)
    # unseen categories and NaN route alike in both loaders
    Xn = X[:200].copy()
    Xn[::3, 0] = 25.0
    Xn[::5, 0] = np.nan
    np.testing.assert_allclose(back.predict(Xn, raw_score=True),
                               jax_loaded.predict(Xn, raw_score=True),
                               atol=1e-6)


def test_multiclass_categorical_text_equals_jax():
    """The JAX package's multiclass model with categorical splits, carried
    across as arrays, gives the JAX package's text and dump."""
    rng = np.random.RandomState(4)
    X = rng.randn(900, 4)
    X[:, 1] = rng.randint(0, 9, 900)
    y = ((X[:, 0] > 0) + np.isin(X[:, 1], [2, 3, 7])).astype(float)
    p = dict(GOLDEN_PARAMS, objective="multiclass", num_class=3,
             min_data_per_group=10, cat_smooth=2.0, device_type="cpu")
    bj = lgb.train(p, lgb.Dataset(X, label=y, categorical_feature=[1]), 4)
    fields = ("split_feature", "split_bin", "default_left", "left_child",
              "right_child", "leaf_value", "leaf_depth", "split_gain",
              "leaf_weight", "leaf_count", "internal_value",
              "internal_weight", "internal_count", "cat_bitset")
    trees = [dict({k: np.asarray(getattr(t, k)) for k in fields},
                  num_leaves=t.num_leaves, num_nodes=t.num_nodes,
                  shrinkage=t.shrinkage) for t in bj._gbdt.models]
    ds = bj._gbdt.train_set
    ms = ds.mappers
    bt = booster_from_arrays(
        trees, [m.bin_upper_bounds for m in ms], [m.nan_bin for m in ms],
        [m.missing_type for m in ms], [m.num_bins for m in ms],
        params=bj.params, value_ranges=[(m.min_value, m.max_value)
                                        for m in ms],
        feature_names=ds.feature_names,
        bin_to_cats=[m.bin_to_cat if m.is_categorical else None
                     for m in ms])
    ours, theirs = bt.model_to_string(), bj.model_to_string()
    assert "cat_threshold=" in ours
    for i, (a, b) in enumerate(zip(ours.split("\n"), theirs.split("\n"))):
        assert a == b, f"line {i}: {a!r} != {b!r}"
    assert len(ours) == len(theirs)
    assert bt.dump_model() == jax_booster_to_dict(bj)
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)


def test_port_text_loads_in_jax_and_round_trips(tmp_path):
    X, y, _, _ = _golden()
    bt = lgt.train(dict(GOLDEN_PARAMS, device_type="cpu"),
                   lgt.Dataset(X, y), 12)
    assert not bt._gbdt.use_compact
    p = bt.predict(X)
    path = tmp_path / "model.txt"
    bt.save_model(str(path))
    text = path.read_text()
    assert text == bt.model_to_string()
    back = lgt.Booster(model_file=str(path))
    assert back.num_trees() == bt.num_trees() == 12
    np.testing.assert_allclose(back.predict(X), p, atol=1e-6)
    np.testing.assert_allclose(back.predict(X, raw_score=True),
                               bt.predict(X, raw_score=True), atol=1e-6)
    # a loaded model saves the text it was given
    assert back.model_to_string() == text
    jax_loaded = lgb.Booster(model_str=text)
    np.testing.assert_allclose(jax_loaded.predict(X), p, atol=1e-6)
    np.testing.assert_allclose(jax_loaded.predict(X), back.predict(X),
                               atol=1e-7)


@pytest.mark.parametrize("case", ["ranking", "quantile"])
def test_ranking_and_quantile_texts_load_and_predict(case):
    """Stock LightGBM's ranking golden predicts its golden predictions; the
    binary golden turned into a quantile model predicts its raw scores.
    Both predict what the JAX package's loader predicts."""
    if case == "ranking":
        X, _, pred, text = _golden("ranking")
    else:
        X, _, _, text = _golden()
        pred = lgb.Booster(model_str=text).predict(X, raw_score=True)
        text = text.replace("objective=binary sigmoid:1",
                            "objective=quantile alpha:0.7")
    bst = lgt.Booster(model_str=text)
    assert bst._gbdt.objective.name == ("lambdarank" if case == "ranking"
                                        else "quantile")
    assert bst.num_trees() == 12
    got = np.asarray(bst.predict(X), np.float64)
    np.testing.assert_allclose(got, pred, rtol=1e-5, atol=2e-6)
    np.testing.assert_allclose(bst.predict(X),
                               lgb.Booster(model_str=text).predict(X),
                               atol=1e-7)
    if case == "quantile":
        assert bst._gbdt.objective.alpha == 0.7


@pytest.mark.parametrize("case,item", [("linear", "A9")])
def test_texts_outside_the_slice_raise(case, item):
    """The binary golden turned into a model whose first tree is linear
    (one coefficient a leaf, on feature 0 or 1; the golden's NaNs fall back
    to the constant leaf value): it loads and predicts what the JAX
    package's loader predicts; ``dump_model`` of the loaded model (ROADMAP
    ``item``, once refused) equals the JAX package's ``loaded_dump`` of the
    text."""
    X, _, _, text = _golden()
    block = text.split("Tree=1")[0].split("Tree=0")[1]
    nl = int(block.split("num_leaves=")[1].split()[0])
    linear = "\n".join([
        "is_linear=1",
        "leaf_const=" + " ".join(f"{0.01 * i:g}" for i in range(nl)),
        "num_features=" + " ".join("1" for _ in range(nl)),
        "leaf_features=" + " ".join(str(i % 2) for i in range(nl)),
        "leaf_coeff=" + " ".join(f"{0.05 * (i + 1):g}" for i in range(nl))])
    text = text.replace("is_linear=0", linear, 1)
    assert np.isnan(X[:, :2]).any()
    bst = lgt.Booster(model_str=text)
    assert bst._gbdt.models[0].is_linear
    np.testing.assert_allclose(bst.predict(X),
                               lgb.Booster(model_str=text).predict(X),
                               atol=1e-7)
    assert item == "A9"
    assert bst.dump_model() == jax_loaded_dump(JaxLoaded(text))


def test_bad_model_inputs_raise(jax_and_carried):
    with pytest.raises(ValueError, match="tree"):
        lgt.Booster(model_str="not a model")
    with pytest.raises(ValueError):
        lgt.Booster()
    _, _, bt = jax_and_carried
    loaded = lgt.Booster(model_str=bt.model_to_string())
    with pytest.raises(ValueError, match="features"):
        loaded.predict(np.zeros((3, 4)))
    # a model loaded from text has no training state (the JAX package's
    # loaded Booster has no train_one_iter either)
    jloaded = lgb.Booster(model_str=bt.model_to_string())
    for b in (loaded, jloaded):
        with pytest.raises(AttributeError, match="train_one_iter"):
            b.update()
    # dump_model of a loaded model: the JAX package's loaded_dump
    assert loaded.dump_model() == jax_loaded_dump(
        JaxLoaded(bt.model_to_string()))
