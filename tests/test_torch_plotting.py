"""Plotting of the port, held against the JAX package's on one model text
loaded by both packages (matplotlib's Agg backend): ``plot_importance``'s
bars and labels, ``plot_metric``'s lines, ``plot_split_value_histogram``'s
bars and ``create_tree_digraph``'s graphviz source are equal. The JAX
package's loaded Booster has no ``dump_model``; its dump comes from its
``model_io.loaded_dump``.
"""
import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
pytest.importorskip("graphviz")
matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lgt  # noqa: E402
from lightgbm_tpu import model_io as jmodel_io  # noqa: E402

# one intra-op thread: the suite runs several workers on the machine's
# cores, and each worker's spin-waiting OpenMP threads would slow the CPU
# paths' many small ops a hundredfold
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def loaded():
    """``(jax, port)`` Boosters of one model text (the port trains it) and
    the evaluation record of its run."""
    rng = np.random.RandomState(7)
    X = rng.randn(1500, 6).astype(np.float32)
    y = (X[:, 0] - 0.4 * X[:, 2] + 0.3 * rng.randn(1500) > 0).astype(float)
    ds = lgt.Dataset(X, y, feature_name=[f"f{j}" for j in range(6)])
    record = {}
    bst = lgt.train({"objective": "binary", "num_leaves": 7,
                     "metric": ["auc", "binary_logloss"], "verbosity": -1,
                     "device_type": "cpu"}, ds, 4,
                    valid_sets=[ds, ds.create_valid(X[:300], y[:300])],
                    valid_names=["train", "valid"],
                    callbacks=[lgt.record_evaluation(record)])
    text = bst.model_to_string()
    bj = lgb.Booster(model_str=text)
    bj.dump_model = lambda: jmodel_io.loaded_dump(bj._gbdt)
    yield bj, lgt.Booster(model_str=text), record
    plt.close("all")


def bars(ax):
    return [(p.get_x(), p.get_y(), p.get_width(), p.get_height())
            for p in ax.patches]


@pytest.mark.parametrize("kind", ["split", "gain"])
def test_plot_importance(loaded, kind):
    bj, bt, _ = loaded
    aj = lgb.plot_importance(bj, importance_type=kind, max_num_features=5)
    at = lgt.plot_importance(bt, importance_type=kind, max_num_features=5)
    assert bars(at) == bars(aj) and len(bars(at)) > 0
    assert ([t.get_text() for t in at.get_yticklabels()]
            == [t.get_text() for t in aj.get_yticklabels()])
    assert [t.get_text() for t in at.texts] == [t.get_text()
                                                for t in aj.texts]


def test_plot_metric(loaded):
    _, _, record = loaded
    aj = lgb.plot_metric(record, metric="binary_logloss")
    at = lgt.plot_metric(record, metric="binary_logloss")
    lines_t, lines_j = at.get_lines(), aj.get_lines()
    assert len(lines_t) == len(lines_j) == 2
    for a, b in zip(lines_t, lines_j):
        np.testing.assert_array_equal(a.get_xydata(), b.get_xydata())
        assert a.get_label() == b.get_label()
    assert at.get_ylabel() == aj.get_ylabel() == "binary_logloss"


def test_plot_split_value_histogram(loaded):
    bj, bt, _ = loaded
    aj = lgb.plot_split_value_histogram(bj, "f0", bins=5)
    at = lgt.plot_split_value_histogram(bt, "f0", bins=5)
    assert bars(at) == bars(aj) and sum(b[3] for b in bars(at)) > 0
    assert at.get_title() == aj.get_title()
    with pytest.raises(ValueError, match="not used"):
        lgt.plot_split_value_histogram(bt, 99)


@pytest.mark.parametrize("tree", [0, 3])
def test_create_tree_digraph(loaded, tree):
    bj, bt, _ = loaded
    info = ["split_gain", "internal_value", "leaf_count"]
    gj = lgb.create_tree_digraph(bj, tree_index=tree, show_info=info)
    gt = lgt.create_tree_digraph(bt, tree_index=tree, show_info=info)
    assert gt.source == gj.source and "leaf" in gt.source
    with pytest.raises(IndexError):
        lgt.create_tree_digraph(bt, tree_index=4)
