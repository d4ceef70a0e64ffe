"""Plotting: ``plot_importance``, ``plot_metric``,
``plot_split_value_histogram``, ``create_tree_digraph`` and ``plot_tree``.

Copy of ``lightgbm_tpu/plotting.py`` for the port (reference:
python-package/lightgbm/plotting.py). The plots read a Booster's
``feature_importance``, ``feature_name`` and ``dump_model`` (a trained or
a loaded model), or the dict ``record_evaluation`` fills. matplotlib, and
graphviz for the trees, are imported inside the calls only.
"""
from __future__ import annotations

import io

import numpy as np


def _pyplot():
    try:
        import matplotlib.pyplot as plt
    except ImportError as err:
        raise ImportError("plotting requires matplotlib") from err
    return plt


def _new_axes(ax, figsize, dpi):
    if ax is None:
        _, ax = _pyplot().subplots(1, 1, figsize=figsize, dpi=dpi)
    return ax


def _finish(ax, xlim, ylim, title, xlabel, ylabel, grid):
    if xlim is not None:
        ax.set_xlim(xlim)
    if ylim is not None:
        ax.set_ylim(ylim)
    ax.set_title(title)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_importance(booster, ax=None, height: float = 0.2, xlim=None,
                    ylim=None, title="Feature importance",
                    xlabel="Feature importance", ylabel="Features",
                    importance_type="split", max_num_features=None,
                    ignore_zero=True, figsize=None, dpi=None, grid=True,
                    precision=3, **kwargs):
    """Horizontal bars of each feature's importance, smallest at the
    bottom (reference: plotting.py plot_importance)."""
    _pyplot()
    imp = booster.feature_importance(importance_type)
    pairs = sorted(((n, v) for n, v in zip(booster.feature_name(), imp)
                    if not (ignore_zero and v == 0)), key=lambda t: t[1])
    if max_num_features is not None and max_num_features > 0:
        pairs = pairs[-max_num_features:]
    ax = _new_axes(ax, figsize, dpi)
    labels, values = zip(*pairs) if pairs else ((), ())
    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for y, v in zip(ylocs, values):
        ax.text(v + 1, y, f"{v:.{precision}f}" if importance_type == "gain"
                else str(int(v)), va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    return _finish(ax, xlim, ylim, title, xlabel, ylabel, grid)


def plot_metric(booster_or_record, metric=None, dataset_names=None, ax=None,
                xlim=None, ylim=None, title="Metric during training",
                xlabel="Iterations", ylabel="@metric@", figsize=None,
                dpi=None, grid=True):
    """One line a dataset of a metric over the iterations, from the dict
    ``record_evaluation`` filled or an estimator's ``evals_result_``
    (reference: plotting.py plot_metric)."""
    _pyplot()
    record = getattr(booster_or_record, "evals_result_", booster_or_record)
    if not isinstance(record, dict):
        raise TypeError("plot_metric expects the dict filled by "
                        "record_evaluation() or a fitted estimator")
    ax = _new_axes(ax, figsize, dpi)
    for name in dataset_names or list(record):
        metrics = record[name]
        if metric is None:
            metric = next(iter(metrics))
        values = metrics[metric]
        ax.plot(range(len(values)), values, label=name)
    ax.legend(loc="best")
    return _finish(ax, xlim, ylim, title, xlabel,
                   ylabel.replace("@metric@", str(metric)), grid)


def plot_split_value_histogram(booster, feature, bins=None, ax=None,
                               width_coef=0.8, xlim=None, ylim=None,
                               title="Split value histogram for feature "
                                     "with @index/name@ @feature@",
                               xlabel="Feature split value", ylabel="Count",
                               figsize=None, dpi=None, grid=True):
    """A histogram of a feature's numerical split thresholds over all trees
    (reference: plotting.py plot_split_value_histogram)."""
    _pyplot()
    dump = booster.dump_model()
    fidx = (dump["feature_names"].index(feature) if isinstance(feature, str)
            else int(feature))
    values = []

    def walk(node):
        if "split_feature" in node:
            if node["split_feature"] == fidx \
                    and not isinstance(node["threshold"], str):
                values.append(float(node["threshold"]))
            walk(node["left_child"])
            walk(node["right_child"])
    for tree in dump["tree_info"]:
        walk(tree["tree_structure"])
    if not values:
        raise ValueError(f"feature {feature} was not used in splitting of "
                         "trees")
    ax = _new_axes(ax, figsize, dpi)
    hist, edges = np.histogram(values, bins=bins or "auto")
    ax.bar((edges[:-1] + edges[1:]) / 2, hist,
           width=width_coef * (edges[1] - edges[0]))
    tag = "name" if isinstance(feature, str) else "index"
    return _finish(ax, xlim, ylim, title.replace("@index/name@", tag)
                   .replace("@feature@", str(feature)), xlabel, ylabel,
                   grid)


def create_tree_digraph(booster, tree_index: int = 0, show_info=None,
                        precision: int = 3, orientation: str = "horizontal",
                        **kwargs):
    """A ``graphviz.Digraph`` of one tree: splits as ``feature op
    threshold`` boxes with yes/no edges, leaves with their values rounded
    to ``precision`` (reference: plotting.py create_tree_digraph)."""
    try:
        import graphviz
    except ImportError as err:
        raise ImportError("create_tree_digraph requires graphviz") from err
    dump = booster.dump_model()
    if tree_index >= len(dump["tree_info"]):
        raise IndexError(f"tree_index {tree_index} out of range")
    names = dump["feature_names"]
    graph = graphviz.Digraph(**kwargs)
    graph.attr(rankdir="LR" if orientation == "horizontal" else "TB")
    show_info = show_info or []

    def node_id(node):
        return (f"split{node['split_index']}" if "split_index" in node
                else f"leaf{node['leaf_index']}")

    def walk(node):
        nid = node_id(node)
        if "split_index" in node:
            label = (f"{names[node['split_feature']]} "
                     f"{node['decision_type']} {node['threshold']}")
            for info in show_info:
                if info in node:
                    label += f"\\n{info}: {node[info]}"
            graph.node(nid, label=label, shape="rectangle")
            for child, edge in ((node["left_child"], "yes"),
                                (node["right_child"], "no")):
                walk(child)
                graph.edge(nid, node_id(child), label=edge)
        else:
            label = (f"leaf {node['leaf_index']}: "
                     f"{round(node['leaf_value'], precision)}")
            if "leaf_count" in show_info and "leaf_count" in node:
                label += f"\\ncount: {node['leaf_count']}"
            graph.node(nid, label=label)

    walk(dump["tree_info"][tree_index]["tree_structure"])
    return graph


def plot_tree(booster, tree_index: int = 0, ax=None, figsize=None, dpi=None,
              show_info=None, precision: int = 3,
              orientation: str = "horizontal", **kwargs):
    """``create_tree_digraph`` rendered by graphviz's binaries into a
    matplotlib image (reference: plotting.py plot_tree)."""
    _pyplot()
    graph = create_tree_digraph(booster, tree_index, show_info, precision,
                                orientation, **kwargs)
    ax = _new_axes(ax, figsize, dpi)
    try:
        image = graph.pipe(format="png")
    except Exception as err:      # the graphviz binaries are missing
        raise RuntimeError("plot_tree needs the graphviz system binaries"
                           ) from err
    import matplotlib.image as mpimg
    ax.imshow(mpimg.imread(io.BytesIO(image)))
    ax.axis("off")
    return ax
