"""The Dataset and Booster methods of the user surface, held against the
JAX package on the CPU on the same numpy inputs: Dataset fields set
before and after ``construct``, ``subset`` (the parent's bins, and trees
trained on it), the binary dataset file in both directions across the
packages, ``get_feature_name`` and ``create_valid(params=)``; Booster
``feature_name``, ``num_model_per_iteration``, ``lower_bound`` and
``upper_bound``, model text and dumps over an iteration window and with
``importance_type``, ``feature_importance(iteration=)`` and
``predict(validate_features=True)``.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lgt
from lightgbm_tpu.model_io import LoadedGBDT as JaxLoaded

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)

BASE = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 10,
        "verbosity": -1}
JAX = {"tpu_fused": "off"}
CPU = {"device_type": "cpu"}

_rng = np.random.RandomState(7)
X = _rng.randn(2000, 8).astype(np.float32)
X[_rng.rand(2000) < 0.05, 1] = np.nan
X[:, 5] = _rng.randint(0, 6, 2000)
Y = (X[:, 0] - 0.4 * X[:, 2] + 0.3 * _rng.randn(2000) > 0).astype(float)
NAMES = [f"f{j}" for j in range(8)]
CAT = [5]


def datasets(**kw):
    """The same Dataset in both packages: ``(jax, port)``."""
    return (lgb.Dataset(X, label=Y, feature_name=NAMES,
                        categorical_feature=CAT, **kw),
            lgt.Dataset(X, Y, feature_name=NAMES, categorical_feature=CAT,
                        params=CPU, **kw))


@pytest.fixture(scope="module")
def boosters():
    """Four rounds in each package on the same Dataset."""
    dj, dt = datasets()
    return (lgb.train(dict(BASE, **JAX), dj, 4),
            lgt.train(dict(BASE, **CPU), dt, 4))


def assert_same_inner(a, b):
    """Two constructed datasets with equal bins, mappers and metadata."""
    np.testing.assert_array_equal(b.binned, a.binned)
    assert b.feature_names == a.feature_names
    assert b.used_features == a.used_features
    assert b.categorical_features == a.categorical_features
    assert b.max_num_bins == a.max_num_bins
    for ma, mb in zip(a.mappers, b.mappers):
        assert mb.num_bins == ma.num_bins
        assert mb.missing_type == ma.missing_type
        assert mb.cat_to_bin == ma.cat_to_bin
        np.testing.assert_array_equal(mb.bin_upper_bounds,
                                      ma.bin_upper_bounds)
    for name in ("label", "weight", "init_score", "group", "position"):
        va, vb = getattr(a.metadata, name), getattr(b.metadata, name)
        assert (va is None) == (vb is None), name
        if va is not None:
            np.testing.assert_array_equal(np.asarray(vb).reshape(-1),
                                          np.asarray(va).reshape(-1), name)


FIELDS = {"label": Y[::-1].copy(), "weight": np.linspace(0.5, 1.5, 2000),
          "init_score": np.linspace(-0.2, 0.2, 2000),
          "group": np.full(100, 20)}


@pytest.mark.parametrize("when", ["before", "after"])
def test_fields_set_before_and_after_construct(when):
    dj, dt = datasets()
    if when == "after":
        dj.construct()
        dt.construct()
    for name, value in FIELDS.items():
        dj.set_field(name, value)
        dt.set_field(name, value)
    dj.set_position(np.arange(2000) % 20)
    dt.set_position(np.arange(2000) % 20)
    dj.construct()
    dt.construct()
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(dt.get_field(name)),
                                      np.asarray(dj.get_field(name)), name)
    np.testing.assert_array_equal(dt.get_init_score(), dj.get_init_score())
    assert_same_inner(dj._inner, dt._inner)
    with pytest.raises(KeyError):
        dt.get_field("position")
    with pytest.raises(KeyError):
        dt.set_field("nothing", 1)


def test_subset_shares_the_parents_bins_and_trains_as_jax():
    rows = np.random.RandomState(3).choice(2000, 1200, replace=False)
    dj, dt = datasets(free_raw_data=False, weight=FIELDS["weight"])
    sj, st = dj.subset(rows), dt.subset(rows)
    assert st.num_data() == 1200
    np.testing.assert_array_equal(st.used_indices, np.sort(rows))
    assert st._inner.mappers is dt._inner.mappers
    assert_same_inner(sj._inner, st._inner)
    bj = lgb.train(dict(BASE, **JAX), sj, 3)
    bt = lgt.train(dict(BASE, **CPU), st, 3)
    for a, b in zip(bj._gbdt.models, bt._gbdt.models):
        n = a.num_nodes
        for name in ("split_feature", "split_bin", "left_child"):
            np.testing.assert_array_equal(getattr(b, name)[:n],
                                          np.asarray(getattr(a, name))[:n])
    np.testing.assert_allclose(bt.predict(X), bj.predict(X), atol=1e-6)
    # ranking data: whole queries only
    dg = lgt.Dataset(X, Y, group=np.full(100, 20), params=CPU)
    np.testing.assert_array_equal(dg.subset(np.arange(40, 100)).get_group(),
                                  [20, 20, 20])
    with pytest.raises(ValueError, match="query groups"):
        dg.subset(np.arange(30))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_binary_file_loads_in_the_other_package(writer, tmp_path):
    path = str(tmp_path / "train.bin")
    dj, dt = datasets(init_score=FIELDS["init_score"],
                      weight=FIELDS["weight"])
    dj.construct()
    dt.construct()
    (dj if writer == "jax" else dt).save_binary(path)
    if writer == "jax":
        back = lgt.Dataset(path, params=CPU).construct()
        assert_same_inner(dj._inner, back._inner)
    else:
        back = lgb.Dataset(path).construct()
        assert_same_inner(dt._inner, back._inner)
    # a label given beside the file replaces the saved one
    relabel = lgt.Dataset(path, label=1 - Y, params=CPU).construct()
    np.testing.assert_array_equal(relabel.get_label(), 1 - Y)
    # the loaded bins train
    bst = lgt.train(dict(BASE, **CPU), lgt.Dataset(path, params=CPU), 2)
    assert bst.num_trees() == 2


def test_feature_names_and_create_valid_params():
    dj, dt = datasets()
    assert dt.get_feature_name() == dj.get_feature_name() == NAMES
    dv = dt.create_valid(X[:100], Y[:100], params={"verbosity": -1,
                                                   "device_type": "cpu"})
    assert dv.params == {"verbosity": -1, "device_type": "cpu"}
    assert dv.reference is dt
    assert dt.create_valid(X[:100], Y[:100]).params == dt.params


def test_booster_introspection(boosters):
    bj, bt = boosters
    assert bt.feature_name() == bj.feature_name() == NAMES
    assert bt.num_model_per_iteration() == bj.num_model_per_iteration() == 1
    assert bt.lower_bound() == pytest.approx(bj.lower_bound(), abs=1e-6)
    assert bt.upper_bound() == pytest.approx(bj.upper_bound(), abs=1e-6)
    assert bt.lower_bound() < 0 < bt.upper_bound()
    for kind in ("split", "gain"):
        for it in (None, 2):
            np.testing.assert_allclose(
                bt.feature_importance(kind, iteration=it),
                bj.feature_importance(kind, iteration=it), rtol=1e-5,
                err_msg=f"{kind} {it}")
    assert (bt.feature_importance(iteration=2).sum()
            < bt.feature_importance().sum())
    loaded = lgt.Booster(model_str=bt.model_to_string())
    assert loaded.feature_name() == NAMES
    np.testing.assert_array_equal(loaded.feature_importance(iteration=2),
                                  bt.feature_importance(iteration=2))


def tree_blocks(text):
    """A model text's tree blocks, ``Tree=`` lines dropped."""
    body = text.split("end of trees")[0]
    return [b.split("\n", 1)[1].strip() for b in body.split("Tree=")[1:]]


def assert_same_text(tt, tj):
    """Two model texts line for line; numbers within f32 summation noise
    (each package sums gradients in its own order); ``tree_sizes`` (the
    blocks' lengths in characters) and the parameters (each package's
    own) left out."""
    def lines(text):
        head, _, tail = text.partition("parameters:")
        return [ln for ln in head.split("\n")
                if not ln.startswith("tree_sizes=")] \
            + tail.partition("end of parameters")[2].split("\n")
    a, b = lines(tt), lines(tj)
    assert len(a) == len(b)
    for la, lb in zip(a, b):
        if la == lb:
            continue
        key, _, va = la.partition("=")
        assert lb.startswith(key + "="), (la, lb)
        np.testing.assert_allclose(
            np.array(va.split(), float),
            np.array(lb.partition("=")[2].split(), float), rtol=1e-5,
            atol=1e-6, err_msg=key)


def assert_same_dump(a, b, path="dump"):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for key in a:
            assert_same_dump(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_dump(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-5, abs=1e-6), path
    else:
        assert a == b, path


def importance_section(text):
    """A model text's ``feature_importances:`` lines."""
    return text.split("feature_importances:\n")[1].split("\n\n")[0]


def without_importances(text):
    head, _, rest = text.partition("feature_importances:\n")
    return head + rest.partition("\n\n")[2]


def importance_lines(imp, names=NAMES):
    """LightGBM's importance lines: each value truncated to an integer,
    largest first, zeros left out."""
    return [f"{names[j]}={int(imp[j])}"
            for j in np.argsort(-np.floor(imp), kind="stable")
            if int(imp[j]) > 0]


@pytest.mark.parametrize("kind", ["split", "gain"])
@pytest.mark.parametrize("start,num", [(0, None), (0, 2), (1, 2), (2, 1),
                                       (2, None)])
def test_model_text_over_a_window(boosters, start, num, kind):
    """The window's trees, numbered from 0, under the JAX package's header
    and footer, and the window's predictions. The importances are those
    of iterations [0, num) whatever ``start`` is (all with no ``num``), as
    LightGBM's SaveModelToString counts them with FeatureImportance(
    num_iteration): the JAX booster's ``feature_importance(iteration=
    num)`` (its own text counts every tree, whatever the window)."""
    bj, bt = boosters
    window = bt.model_to_string(num_iteration=num, start_iteration=start,
                                importance_type=kind)
    full = bj.model_to_string()
    assert_same_text(window.split("Tree=0")[0], full.split("Tree=0")[0])
    assert_same_text(without_importances(window).split("end of trees")[1],
                     without_importances(full).split("end of trees")[1])
    blocks = tree_blocks(full)[start:None if num is None else start + num]
    assert window.count("Tree=") == len(blocks) and "Tree=0" in window
    for a, b in zip(tree_blocks(window), blocks, strict=True):
        assert_same_text(a, b)
    assert importance_section(window).split("\n") == importance_lines(
        bj.feature_importance(kind, iteration=num))
    np.testing.assert_allclose(
        lgt.Booster(model_str=window).predict(X, raw_score=True),
        bt.predict(X, raw_score=True, start_iteration=start,
                   num_iteration=num), atol=1e-6)


def test_save_model_and_a_snapshot_of_the_text(boosters, tmp_path):
    bj, bt = boosters
    assert_same_text(bt.model_to_string(), bj.model_to_string())
    path = str(tmp_path / "m.txt")
    bt.save_model(path, num_iteration=2, start_iteration=1,
                  importance_type="gain")
    with open(path) as fh:
        assert fh.read() == bt.model_to_string(2, 1, "gain")
    with pytest.raises(ValueError, match="importance_type"):
        bt.model_to_string(importance_type="cover")


def test_dump_over_a_window(boosters):
    bj, bt = boosters
    assert_same_dump(bt.dump_model(), bj.dump_model())
    assert_same_dump(bt.dump_model(num_iteration=2),
                     bj.dump_model(num_iteration=2))
    window = bt.dump_model(num_iteration=2, start_iteration=1,
                           importance_type="gain")
    assert_same_dump(window["tree_info"], bj.dump_model()["tree_info"][1:3])
    # a loaded model's window: the JAX package's parse of the same text
    loaded = lgt.Booster(model_str=bt.model_to_string())
    ref = lgb.model_io.loaded_dump(JaxLoaded(bt.model_to_string()))
    assert (loaded.dump_model(num_iteration=2, start_iteration=1)
            ["tree_info"] == ref["tree_info"][1:3])


def test_continued_booster_window(boosters):
    """A window over a continued booster's loaded trees and its own."""
    _, bt = boosters
    cont = lgt.train(dict(BASE, **CPU), lgt.Dataset(X, Y, params=CPU,
                                                    free_raw_data=False),
                     2, init_model=bt)
    text = cont.model_to_string(start_iteration=3, num_iteration=2)
    whole = cont.model_to_string()
    assert tree_blocks(text) == tree_blocks(whole)[3:5]
    # the importances of the first two iterations, the loaded model's
    assert importance_section(text).split("\n") == importance_lines(
        bt.feature_importance(iteration=2), cont.feature_name())
    np.testing.assert_allclose(
        lgt.Booster(model_str=text).predict(X, raw_score=True),
        cont.predict(X, raw_score=True, start_iteration=3, num_iteration=2),
        atol=1e-6)
    np.testing.assert_array_equal(
        cont.feature_importance(iteration=4),
        lgt.Booster(model_str=cont.model_to_string(num_iteration=4))
        .feature_importance())


def test_validate_features(boosters):
    """Accepted as the JAX package accepts it: the same predictions; rows
    of another width raise in both packages."""
    bj, bt = boosters
    np.testing.assert_allclose(bt.predict(X, validate_features=True),
                               bj.predict(X, validate_features=True),
                               atol=1e-6)
    for bst in boosters:
        with pytest.raises(Exception):
            bst.predict(X[:, :5], validate_features=True)
    with pytest.raises(TypeError, match="unexpected"):
        bt.predict(X, no_such_argument=1)
