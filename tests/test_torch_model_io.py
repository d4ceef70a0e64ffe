"""The port's model text (``lightgbm_tpu_torch.model_io``) against the JAX
package and stock LightGBM, on the CPU.

* the same trees (trained by the JAX package, carried across by
  ``convert.py``) give the same text, line for line, and the same
  ``dump_model``;
* ``tests/golden/binary_nan.model.txt``, saved by stock LightGBM, loads and
  predicts the golden predictions within ``rtol=1e-5, atol=2e-6`` (the
  tolerance of ``tests/test_interop.py``);
* text written by the port, trained on the golden data with the golden
  parameters (masked grower, ``max_bin=63``), loads into the JAX package's
  ``LoadedGBDT`` and predicts what the port predicts;
* save -> load -> predict round-trips within 1e-6 (the loaded model routes
  raw float64 values on the host, the trained one bins on the device);
* categorical, multiclass and non-binary texts raise, naming their ROADMAP
  item.
"""
import os

import numpy as np
import pytest

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.model_io import booster_to_dict as jax_booster_to_dict
from lightgbm_tpu_torch.convert import booster_from_arrays

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
# the golden case's parameters (tests/golden/binary_nan.model.txt), without
# deterministic=True: the port's kernels add f32 atomics in no fixed order
# and still reject it (ROADMAP B1/B2); on the CPU the plain histogram is
# sequential anyway
GOLDEN_PARAMS = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
                 "min_data_in_leaf": 5, "learning_rate": 0.1,
                 "verbosity": -1}


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
    cut = bt.model_to_string(num_iteration=2)
    assert cut == bj.model_to_string(num_iteration=2)


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


@pytest.mark.parametrize("name,item", [("categorical", "A12"),
                                       ("multiclass", "A12"),
                                       ("regression", "A12")])
def test_texts_outside_the_slice_raise(name, item):
    _, _, _, text = _golden(name)
    with pytest.raises(NotImplementedError, match=item):
        lgt.Booster(model_str=text)


def test_bad_model_inputs_raise(jax_and_carried):
    with pytest.raises(ValueError, match="tree"):
        lgt.Booster(model_str="not a model")
    with pytest.raises(ValueError):
        lgt.Booster()
    _, _, bt = jax_and_carried
    loaded = lgt.Booster(model_str=bt.model_to_string())
    with pytest.raises(ValueError, match="features"):
        loaded.predict(np.zeros((3, 4)))
    with pytest.raises(NotImplementedError, match="A8"):
        loaded.update()
    with pytest.raises(NotImplementedError, match="A9"):
        loaded.dump_model()
