"""Model text: save, JSON dump and load, in LightGBM's v4 text format.

Copy of ``lightgbm_tpu/model_io.py`` for the port's models (the port
imports nothing of the JAX package; reference:
src/boosting/gbdt_model_text.cpp — SaveModelToString, DumpModel,
LoadModelFromString — and src/io/tree.cpp — Tree::ToString, Tree::ToJSON,
Tree::Tree(const char*)). The text is the reference's ``v4`` format
(``tree`` header, ``Tree=<i>`` blocks, decision_type bits
kCategoricalMask=1, kDefaultLeftMask=2 and missing_type << 2), so a model
saved here loads in stock LightGBM and in the JAX package, and theirs load
here. A model of K classes holds K trees an iteration, in class order.

A categorical split's text holds a bitset of category VALUES
(``cat_boundaries``/``cat_threshold``), while training routes by a bitset of
bins: writing maps each set bin through the mapper's bin-to-category table
(``_bitset_cats``). A loaded model predicts on the host in float64 numpy
(``LoadedGBDT.predict_raw_matrix``), as the JAX package's loaded models do:
the text holds raw-value thresholds and category values, not bins; its
leaf indices and TreeSHAP contributions (``ops/treeshap.py``) route the
same way, and ``to_string`` writes its (refit) leaf values back. A
continued model's text is the loaded model's tree blocks, then the new
ones, under the new model's header and footer (``merge_model_texts``).
Linear trees carry their block (``is_linear=1``, ``leaf_const``,
``num_features``, ``leaf_features``, ``leaf_coeff``; reference: Tree::
ToString, src/io/tree.cpp) and predict from raw values; a random forest's
header says ``average_output``, and its predictions are the mean of its
iterations. ``dump_model`` of a loaded model (and of a continued one,
through its merged text) dumps the parsed trees (``loaded_dump``).
``save_model``, ``model_to_string`` and ``dump_model`` take an iteration
window (``start_iteration``, ``num_iteration``; the text numbers its trees
from 0, as LightGBM's SaveModelToString does) and the text's
``feature_importances`` lines take ``importance_type`` (gains truncated to
integers, as LightGBM writes them). ``LoadedGBDT.to_if_else`` is the CLI's
``convert_model``: C++ if-else code of the whole model.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from .boosting.linear import linear_leaf_outputs
from .config import Config
from .io.binning import MISSING_NAN
from .objectives import create_objective
from .utils import log

_MISSING_NAMES = {0: "None", 1: "Zero", 2: "NaN"}


def _fmt(x: float) -> str:
    return f"{float(x):.17g}"


def _objective_string(gbdt) -> str:
    obj = gbdt.objective
    if obj is None:
        return "custom"
    parts = [obj.name]
    if obj.name in ("multiclass", "multiclassova"):
        parts.append(f"num_class:{obj.num_class}")
    if hasattr(obj, "sigmoid"):
        parts.append(f"sigmoid:{obj.sigmoid:g}")
    if obj.name == "tweedie":
        parts.append(f"tweedie_variance_power:{obj.rho:g}")
    if obj.name in ("quantile", "huber"):
        parts.append(f"alpha:{obj.alpha:g}")
    return " ".join(parts)


def _bitset_cats(host, node: int, mapper) -> List[int]:
    """Category values whose bins are set in a node's bin bitset."""
    words = host.cat_bitset[node]
    return sorted(int(cat) for b, cat in enumerate(mapper.bin_to_cat)
                  if b // 32 < len(words)
                  and (int(words[b // 32]) >> (b % 32)) & 1)


def _tree_to_text(host, tree_idx: int, mappers) -> str:
    """One ``Tree=i`` block (reference: Tree::ToString, src/io/tree.cpp)."""
    nl, nn = host.num_leaves, host.num_nodes
    thresholds, decision_types = [], []
    cat_boundaries, cat_words = [0], []
    for i in range(nn):
        m = mappers[int(host.split_feature[i])]
        if m.is_categorical:
            # bin bitset -> category-value bitset (reference:
            # Common::ConstructBitset over SplitInfo::cat_threshold)
            cats = _bitset_cats(host, i, m)
            words = [0] * ((max(cats) // 32 + 1) if cats else 1)
            for cat in cats:
                words[cat // 32] |= 1 << (cat % 32)
            thresholds.append(str(len(cat_boundaries) - 1))
            cat_words.extend(words)
            cat_boundaries.append(len(cat_words))
            decision_types.append("1")                  # kCategoricalMask
            continue
        dt = 2 if bool(host.default_left[i]) else 0      # kDefaultLeftMask
        dt |= (2 if m.missing_type == MISSING_NAN else 0) << 2
        thresholds.append(_fmt(m.bin_to_threshold(int(host.split_bin[i]))))
        decision_types.append(str(dt))

    def join(vals):
        return " ".join(str(v) for v in vals)

    def counts(arr, k):
        return join(int(round(float(arr[i]))) for i in range(k))

    num_cat = len(cat_boundaries) - 1
    cat_lines = ([f"cat_boundaries={join(cat_boundaries)}",
                  f"cat_threshold={join(cat_words)}"] if num_cat else [])
    if host.is_linear:
        # (reference: Tree::ToString's linear block, src/io/tree.cpp:377-399)
        linear_lines = [
            "is_linear=1",
            "leaf_const=" + join(_fmt(v) for v in host.leaf_const[:nl]),
            "num_features=" + join(len(host.leaf_features[i])
                                   for i in range(nl)),
            "leaf_features=" + join(f for i in range(nl)
                                    for f in host.leaf_features[i]),
            "leaf_coeff=" + join(_fmt(c) for i in range(nl)
                                 for c in host.leaf_coeff[i])]
    else:
        linear_lines = ["is_linear=0"]
    return "\n".join([
        f"Tree={tree_idx}",
        f"num_leaves={nl}",
        f"num_cat={num_cat}",
        "split_feature=" + join(int(host.split_feature[i]) for i in range(nn)),
        "split_gain=" + join(_fmt(host.split_gain[i]) for i in range(nn)),
        "threshold=" + join(thresholds),
        "decision_type=" + join(decision_types),
        "left_child=" + join(int(host.left_child[i]) for i in range(nn)),
        "right_child=" + join(int(host.right_child[i]) for i in range(nn)),
        "leaf_value=" + join(_fmt(host.leaf_value[i]) for i in range(nl)),
        "leaf_weight=" + join(_fmt(host.leaf_weight[i]) for i in range(nl)),
        "leaf_count=" + counts(host.leaf_count, nl),
        "internal_value=" + join(_fmt(host.internal_value[i])
                                 for i in range(nn)),
        "internal_weight=" + join(_fmt(host.internal_weight[i])
                                  for i in range(nn)),
        "internal_count=" + counts(host.internal_count, nn),
        *cat_lines,
        *linear_lines,
        f"shrinkage={host.shrinkage:g}",
        "",
    ])


def _importance_lines(imp: np.ndarray, names: List[str]) -> List[str]:
    """The ``feature_importances:`` lines: each feature's importance
    truncated to an integer, largest first, zeros left out (reference:
    GBDT::SaveModelToString, gbdt_model_text.cpp)."""
    imp = np.floor(np.asarray(imp, np.float64))
    return [f"{names[j] if j < len(names) else f'Column_{j}'}={int(imp[j])}"
            for j in np.argsort(-imp, kind="stable") if imp[j] > 0]


def check_importance_type(importance_type: str) -> None:
    if importance_type not in ("split", "gain"):
        raise ValueError(f"importance_type={importance_type!r}: 'split' or "
                         "'gain'")


def _window(models: list, k: int, num_iteration: Optional[int],
            start_iteration: int = 0) -> list:
    """The trees of an iteration window: from ``start_iteration``,
    ``num_iteration`` iterations of K trees (None: to the end; 0 here:
    none, a continued model's cut that ends inside its loaded trees)."""
    models = models[max(start_iteration, 0) * k:]
    if num_iteration is not None and num_iteration >= 0:
        models = models[:num_iteration * k]
    return models


def booster_to_string(booster, num_iteration: Optional[int] = None,
                      start_iteration: int = 0,
                      importance_type: str = "split") -> str:
    """(reference: GBDT::SaveModelToString, gbdt_model_text.cpp) The
    window's trees, numbered from 0, and the importances of the first
    ``num_iteration`` iterations whatever ``start_iteration`` is (None: of
    every tree), as LightGBM's FeatureImportance(num_iteration) counts
    them (the JAX package's text counts every tree whatever the window),
    so a snapshot's text is ``model_to_string(num_iteration=i)``."""
    check_importance_type(importance_type)
    gbdt = booster._gbdt
    if isinstance(gbdt, LoadedGBDT):
        if (num_iteration is None and start_iteration <= 0
                and importance_type == "split"):
            return gbdt.original_text
        # the window in the layout booster_to_string writes (a blank line
        # before "end of trees"): a snapshot's text is then the loaded
        # final model's window
        take = gbdt._model_window(num_iteration, start_iteration)
        first = max(start_iteration, 0) * gbdt.num_class
        return _emit_loaded(gbdt._header_lines,
                            gbdt._tree_chunks[first:first + len(take)], take,
                            [""] + gbdt._footer_lines, gbdt.feature_names,
                            importance=_tree_importance(
                                gbdt._model_window(num_iteration),
                                importance_type))
    mappers = gbdt.mappers
    feature_infos = [
        "none" if m.is_trivial
        else ":".join(str(int(c)) for c in m.bin_to_cat[1:])
        if m.is_categorical else f"[{m.min_value:g}:{m.max_value:g}]"
        for m in mappers]
    k = gbdt.num_class
    models = _window(gbdt.models, k, num_iteration, start_iteration)
    blocks = [_tree_to_text(m, i, mappers) for i, m in enumerate(models)]
    header = [
        "tree",
        "version=v4",
        f"num_class={k}",
        f"num_tree_per_iteration={k}",
        "label_index=0",
        f"max_feature_idx={len(mappers) - 1}",
        f"objective={_objective_string(gbdt)}",
        *(["average_output"] if gbdt.average_output else []),
        "feature_names=" + " ".join(gbdt.feature_names),
        "feature_infos=" + " ".join(feature_infos),
        "tree_sizes=" + " ".join(str(len(b) + 1) for b in blocks),
        "",
    ]
    footer = ["", "end of trees", "", "feature_importances:"]
    footer += _importance_lines(
        _tree_importance(_window(gbdt.models, k, num_iteration),
                         importance_type, len(mappers)),
        gbdt.feature_names)
    footer += ["", "parameters:"]
    footer += [f"[{key}: {value}]"
               for key, value in sorted(booster.params.items())]
    footer += ["end of parameters", "", "pandas_categorical:null"]
    return "\n".join(header) + "\n" + "\n".join(blocks) \
        + "\n".join(footer) + "\n"


def _node_to_json(host, mappers, node: int) -> Dict[str, Any]:
    """(reference: Tree::ToJSON / NodeToJSON, src/io/tree.cpp)"""
    if node < 0:
        leaf = -(node + 1)
        return {
            "leaf_index": int(leaf),
            "leaf_value": float(host.leaf_value[leaf]),
            "leaf_weight": float(host.leaf_weight[leaf]),
            "leaf_count": int(round(float(host.leaf_count[leaf]))),
        }
    f = int(host.split_feature[node])
    m = mappers[f]
    out = {
        "split_index": int(node),
        "split_feature": f,
        "split_gain": float(host.split_gain[node]),
        "internal_value": float(host.internal_value[node]),
        "internal_weight": float(host.internal_weight[node]),
        "internal_count": int(round(float(host.internal_count[node]))),
    }
    if m.is_categorical:
        out.update(decision_type="==", threshold="||".join(
            str(c) for c in _bitset_cats(host, node, m)),
            default_left=False, missing_type="None")
    else:
        out.update(
            decision_type="<=",
            threshold=float(m.bin_to_threshold(int(host.split_bin[node]))),
            default_left=bool(host.default_left[node]),
            missing_type=_MISSING_NAMES.get(m.missing_type, "None"))
    out["left_child"] = _node_to_json(host, mappers,
                                      int(host.left_child[node]))
    out["right_child"] = _node_to_json(host, mappers,
                                       int(host.right_child[node]))
    return out


def _loaded_node_json(t: "LoadedTree", node: int) -> Dict[str, Any]:
    """A parsed tree's node as JSON (reference: ``_loaded_node_json``,
    ``lightgbm_tpu/model_io.py:731-771``): its threshold and category
    values as the text holds them."""
    if node < 0:
        leaf = -(node + 1)
        return {
            "leaf_index": int(leaf),
            "leaf_value": float(t.leaf_value[leaf]),
            "leaf_weight": float(t.leaf_weight[leaf])
            if len(t.leaf_weight) > leaf else 0.0,
            "leaf_count": int(t.leaf_count[leaf])
            if len(t.leaf_count) > leaf else 0,
        }
    dt = int(t.decision_type[node])
    out = {
        "split_index": int(node),
        "split_feature": int(t.split_feature[node]),
        "split_gain": float(t.split_gain[node]),
        "internal_value": float(t.internal_value[node])
        if len(t.internal_value) > node else 0.0,
    }
    if dt & 1:
        ci = int(t.threshold[node])
        lo, hi = int(t.cat_boundaries[ci]), int(t.cat_boundaries[ci + 1])
        cats = [(wi - lo) * 32 + bit for wi in range(lo, hi)
                for bit in range(32) if (int(t.cat_threshold[wi]) >> bit) & 1]
        out.update(decision_type="==",
                   threshold="||".join(str(c) for c in cats),
                   default_left=False, missing_type="None")
    else:
        out.update(decision_type="<=", threshold=float(t.threshold[node]),
                   default_left=bool(dt & 2),
                   missing_type=_MISSING_NAMES.get((dt >> 2) & 3, "None"))
    out["left_child"] = _loaded_node_json(t, int(t.left_child[node]))
    out["right_child"] = _loaded_node_json(t, int(t.right_child[node]))
    return out


def loaded_dump(loaded: "LoadedGBDT", num_iteration: Optional[int] = None,
                start_iteration: int = 0) -> Dict[str, Any]:
    """JSON dump of a parsed model (reference: ``loaded_dump``,
    ``lightgbm_tpu/model_io.py:774-797``; GBDT::DumpModel), the trees of
    an iteration window where given, each with its index in the model."""
    first = max(start_iteration, 0) * loaded.num_class
    trees = [{
        "tree_index": first + i,
        "num_leaves": int(t.num_leaves),
        "num_cat": int(t.num_cat),
        "shrinkage": float(t.shrinkage),
        "tree_structure": _loaded_node_json(t, 0 if t.num_nodes > 0
                                            else -1),
    } for i, t in enumerate(loaded._model_window(num_iteration,
                                                 start_iteration))]
    return {
        "name": "tree",
        "version": "v4",
        "num_class": loaded.header_num_class,
        "num_tree_per_iteration": loaded.num_class,
        "label_index": 0,
        "max_feature_idx": loaded.max_feature_idx,
        "objective": loaded.objective_str,
        "average_output": loaded.average_output,
        "feature_names": loaded.feature_names,
        "tree_info": trees,
    }


def booster_to_dict(booster, num_iteration: Optional[int] = None,
                    start_iteration: int = 0) -> Dict[str, Any]:
    """(reference: GBDT::DumpModel, gbdt_model_text.cpp) The trees of an
    iteration window, each with its index in the model."""
    gbdt = booster._gbdt
    if isinstance(gbdt, LoadedGBDT):
        return loaded_dump(gbdt, num_iteration, start_iteration)
    k = gbdt.num_class
    models = _window(gbdt.models, k, num_iteration if num_iteration
                     and num_iteration > 0 else None, start_iteration)
    first = max(start_iteration, 0) * k
    trees = [{
        "tree_index": first + i,
        "num_leaves": host.num_leaves,
        "num_cat": 0,
        "shrinkage": host.shrinkage,
        "tree_structure": _node_to_json(
            host, gbdt.mappers, 0 if host.num_nodes > 0 else -1),
    } for i, host in enumerate(models)]
    return {
        "name": "tree",
        "version": "v4",
        "num_class": k,
        "num_tree_per_iteration": k,
        "label_index": 0,
        "max_feature_idx": len(gbdt.mappers) - 1,
        "objective": _objective_string(gbdt),
        "average_output": gbdt.average_output,
        "feature_names": list(gbdt.feature_names),
        "monotone_constraints": [],
        "feature_infos": {},
        "tree_info": trees,
    }


# ---------------------------------------------------------------------------
# Loading (reference: GBDT::LoadModelFromString, gbdt_model_text.cpp; per-tree
# parser Tree::Tree(const char*), src/io/tree.cpp)
# ---------------------------------------------------------------------------
class LoadedTree:
    __slots__ = ("num_leaves", "num_nodes", "num_cat", "split_feature",
                 "split_gain", "threshold", "decision_type", "left_child",
                 "right_child", "leaf_value", "leaf_weight", "leaf_count",
                 "internal_value", "internal_count", "shrinkage",
                 "cat_boundaries", "cat_threshold",
                 "is_linear", "leaf_const", "leaf_features", "leaf_coeff")

    def _node_go_left(self, k: int, v: np.ndarray) -> np.ndarray:
        """Node ``k``'s decision for raw float64 values ``v`` of its feature
        (reference semantics: Tree::NumericalDecision, tree.h:334-351, and
        Tree::CategoricalDecision: a value's integer part goes left when its
        bit is set; NaN and negative values go right)."""
        dt = int(self.decision_type[k])
        if dt & 1:
            ci = int(self.threshold[k])
            words = self.cat_threshold[self.cat_boundaries[ci]:
                                       self.cat_boundaries[ci + 1]]
            iv = np.where(np.isfinite(v), v, -1).astype(np.int64)
            ok = (iv >= 0) & (iv < 32 * len(words))
            go_left = np.zeros(len(iv), bool)
            idx = iv[ok]
            go_left[ok] = (words[idx // 32] >> (idx % 32)) & 1 > 0
            return go_left
        missing_type = (dt >> 2) & 3
        isnan = np.isnan(v)
        if missing_type != 2:
            v = np.where(isnan, 0.0, v)
        if missing_type == 1:
            miss = np.abs(v) <= 1e-35
        elif missing_type == 2:
            miss = isnan
        else:
            miss = np.zeros(len(v), bool)
        return np.where(miss, bool(dt & 2), v <= self.threshold[k])

    def go_left(self, x: np.ndarray) -> np.ndarray:
        """``[N, num_nodes]`` bool: every node's decision for every row of
        raw float64 values (TreeSHAP follows each row's path and prices
        the other branches)."""
        out = np.zeros((x.shape[0], self.num_nodes), bool)
        for k in range(self.num_nodes):
            out[:, k] = self._node_go_left(k, x[:, self.split_feature[k]])
        return out

    def route(self, x: np.ndarray) -> np.ndarray:
        """Leaf index per row of raw float64 values, node by node."""
        n = x.shape[0]
        cur = np.zeros(n, np.int64)
        if self.num_nodes == 0:
            return cur
        for k in range(self.num_nodes):
            at = cur == k
            if not at.any():
                continue
            go_left = self._node_go_left(k, x[at, self.split_feature[k]])
            cur[at] = np.where(go_left, self.left_child[k],
                               self.right_child[k])
        return -(cur + 1)


def _parse_block(lines: List[str]) -> Dict[str, str]:
    out = {}
    for line in lines:
        if "=" in line:
            key, _, value = line.partition("=")
            out[key.strip()] = value.strip()
        elif line.strip():
            out[line.strip()] = ""
    return out


def _arr(d: Dict[str, str], key: str, dtype, n: int) -> np.ndarray:
    s = d.get(key, "")
    return np.array(s.split(), dtype=dtype) if s else np.zeros(n, dtype)


class LoadedGBDT:
    """Prediction-only model built from model text."""

    def __init__(self, model_str: str):
        if not model_str.lstrip().startswith("tree"):
            raise ValueError("Model string is not a LightGBM model (missing "
                             "'tree' header)")
        self.original_text = model_str
        header: List[str] = []
        chunks: List[List[str]] = []
        lines = model_str.split("\n")
        footer: List[str] = []
        for i, line in enumerate(lines):
            if line.strip() == "end of trees":
                footer = lines[i:]
                break
            if line.startswith("Tree="):
                chunks.append([line])
            elif chunks:
                chunks[-1].append(line)
            else:
                header.append(line)
        # the pieces a continued model's text re-emits (merge_model_texts)
        self._header_lines = [ln for ln in header
                              if not ln.startswith("tree_sizes=")]
        while self._header_lines and not self._header_lines[-1].strip():
            self._header_lines.pop()
        self._tree_chunks = chunks
        self._footer_lines = footer
        hdr = _parse_block(header)
        self.num_class = int(hdr.get(
            "num_tree_per_iteration", hdr.get("num_class", 1)))
        # the header's own values, which dump_model reports
        self.header_num_class = int(hdr.get("num_class", 1))
        self.objective_str = hdr.get("objective", "custom")
        self.max_feature_idx = int(hdr.get("max_feature_idx", 0))
        self.feature_names = hdr.get("feature_names", "").split()
        self.average_output = "average_output" in hdr
        self.objective = _objective_from_string(hdr.get("objective",
                                                        "custom"))
        self.models: List[LoadedTree] = []
        for chunk in chunks:
            d = _parse_block(chunk)
            t = LoadedTree()
            t.num_leaves = int(d.get("num_leaves", 1))
            t.num_nodes = nn = max(t.num_leaves - 1, 0)
            t.decision_type = _arr(d, "decision_type", np.int32, nn)
            t.num_cat = num_cat = int(d.get("num_cat", 0))
            t.cat_boundaries = _arr(d, "cat_boundaries", np.int64,
                                    num_cat + 1)
            t.cat_threshold = (_arr(d, "cat_threshold", np.uint32, 0)
                               if num_cat else np.zeros(0, np.uint32))
            t.is_linear = bool(int(d.get("is_linear", "0") or 0))
            if t.is_linear:
                t.leaf_const = _arr(d, "leaf_const", np.float64,
                                    t.num_leaves)
                counts = _arr(d, "num_features", np.int64, t.num_leaves)
                ends = np.cumsum(counts)
                feats = _arr(d, "leaf_features", np.int64, 0)
                coeffs = _arr(d, "leaf_coeff", np.float64, 0)
                t.leaf_features = [feats[e - c:e].tolist()
                                   for c, e in zip(counts, ends)]
                t.leaf_coeff = [coeffs[e - c:e].tolist()
                                for c, e in zip(counts, ends)]
            t.split_feature = _arr(d, "split_feature", np.int32, nn)
            t.split_gain = _arr(d, "split_gain", np.float64, nn)
            t.threshold = _arr(d, "threshold", np.float64, nn)
            t.left_child = _arr(d, "left_child", np.int32, nn)
            t.right_child = _arr(d, "right_child", np.int32, nn)
            t.leaf_value = _arr(d, "leaf_value", np.float64, t.num_leaves)
            # dump_model's weights and values, TreeSHAP's covers and
            # refit's shrinkage
            t.leaf_weight = _arr(d, "leaf_weight", np.float64, t.num_leaves)
            t.leaf_count = _arr(d, "leaf_count", np.float64, t.num_leaves)
            t.internal_value = _arr(d, "internal_value", np.float64, nn)
            t.internal_count = _arr(d, "internal_count", np.float64, nn)
            t.shrinkage = float(d.get("shrinkage", 1.0))
            self.models.append(t)

    def current_iteration(self) -> int:
        return len(self.models) // self.num_class

    def num_features(self) -> int:
        return self.max_feature_idx + 1

    def _checked_rows(self, arr) -> np.ndarray:
        arr = np.asarray(arr, np.float64)
        if arr.ndim == 1:
            arr = arr.reshape(1, -1)
        if arr.shape[1] != self.num_features():
            raise ValueError(f"input has {arr.shape[1]} features, model "
                             f"expects {self.num_features()}")
        return arr

    def _model_window(self, num_iteration: Optional[int] = None,
                     start_iteration: int = 0) -> List[LoadedTree]:
        """The trees of an iteration window (None or <= 0: to the end)."""
        return _window(self.models, self.num_class,
                       num_iteration if num_iteration and num_iteration > 0
                       else None, start_iteration)

    def predict_raw_matrix(self, arr: np.ndarray,
                           num_iteration: Optional[int] = None,
                           start_iteration: int = 0,
                           early_stop=None) -> np.ndarray:
        """Raw scores ``[K, N]`` (float32) of raw feature rows: tree ``i``
        adds to class ``i % K``. ``early_stop`` is ignored with a warning,
        as the reference does on its host path (``lightgbm_tpu/
        model_io.py:574-580``)."""
        if early_stop is not None:
            log.warning("pred_early_stop is ignored for models loaded from "
                        "file (host prediction path)")
        arr = self._checked_rows(arr)
        k = self.num_class
        models = self._model_window(num_iteration, start_iteration)
        out = np.zeros((k, arr.shape[0]), np.float64)
        for i, t in enumerate(models):
            leaf = t.route(arr)
            out[i % k] += (linear_leaf_outputs(t, arr, leaf) if t.is_linear
                           else t.leaf_value[leaf])
        if self.average_output:
            out /= max(len(models) // k, 1)
        return out.astype(np.float32)

    def predict_leaf_matrix(self, arr: np.ndarray,
                            num_iteration: Optional[int] = None,
                            start_iteration: int = 0) -> np.ndarray:
        """Leaf indices ``[N, T]`` int32 of the window's trees (reference:
        ``lightgbm_tpu/model_io.py:602-611``)."""
        arr = self._checked_rows(arr)
        models = self._model_window(num_iteration, start_iteration)
        out = np.zeros((arr.shape[0], len(models)), np.int32)
        for i, t in enumerate(models):
            out[:, i] = t.route(arr)
        return out

    def predict_contrib_matrix(self, arr: np.ndarray,
                               num_iteration: Optional[int] = None,
                               start_iteration: int = 0) -> np.ndarray:
        """TreeSHAP contributions ``[N, K*(F+1)]`` float64 on the host
        (``ops/treeshap.py``), routed on raw values."""
        from .ops.treeshap import loaded_booster_contrib
        return loaded_booster_contrib(
            self._model_window(num_iteration, start_iteration),
            self._checked_rows(arr), self.num_class, self.num_features())

    def to_string(self) -> str:
        """The model's text with its current leaf values (a refit writes
        its new ones here; reference: ``loaded_to_string``)."""
        return _emit_loaded(self._header_lines, self._tree_chunks,
                            self.models, self._footer_lines,
                            self.feature_names)

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """Splits (or summed gains) per feature over the loaded trees of
        the first ``iteration`` iterations (None or <= 0: all)."""
        check_importance_type(importance_type)
        return _tree_importance(self._model_window(iteration),
                                importance_type, self.num_features())

    def to_if_else(self) -> str:
        """C++ if-else prediction code of the whole model (reference:
        ``LoadedGBDT.to_if_else``, ``lightgbm_tpu/model_io.py:475-572``;
        LightGBM's Tree::ToIfElse behind ``task=convert_model``): one
        function a tree over ``const double* x`` with the text's raw
        thresholds and category bitsets, and ``Predict`` summing tree
        ``i`` into class ``i % K``. Leaf values carry their shrinkage, so
        the sum is the raw score. The text equals the JAX package's."""
        out = [
            "// generated by lightgbm_tpu task=convert_model",
            "#include <cmath>",
            "#include <cstdint>",
            "#include <limits>",
            "",
            "namespace lightgbm_tpu_model {",
            "",
            "static inline bool CatInSet(const uint32_t* w, int n, "
            "double v) {",
            "  if (std::isnan(v) || v < 0) return false;",
            "  int iv = static_cast<int>(v);",
            "  if (iv >= 32 * n) return false;",
            "  return (w[iv / 32] >> (iv % 32)) & 1u;",
            "}",
            "",
        ]

        def cpp_double(x) -> str:
            # non-finite values as C++ expressions: bare inf or nan tokens
            # do not compile
            x = float(x)
            if x != x:
                return "std::numeric_limits<double>::quiet_NaN()"
            if x in (float("inf"), float("-inf")):
                return ("-" if x < 0 else "") \
                    + "std::numeric_limits<double>::infinity()"
            return repr(x)

        def emit_node(t, node, depth, lines):
            ind = "  " * (depth + 1)
            if node < 0:
                lines.append(f"{ind}return "
                             f"{cpp_double(t.leaf_value[-(node + 1)])};")
                return
            f = int(t.split_feature[node])
            dt = int(t.decision_type[node])
            if dt & 1:
                ci = int(t.threshold[node])
                lo = int(t.cat_boundaries[ci])
                hi = int(t.cat_boundaries[ci + 1])
                words = ", ".join(f"{int(w)}u"
                                  for w in t.cat_threshold[lo:hi])
                lines.append(f"{ind}static const uint32_t cats_{node}[] = "
                             f"{{{words}}};")
                cond = f"CatInSet(cats_{node}, {hi - lo}, x[{f}])"
            else:
                default_left = "true" if dt & 2 else "false"
                missing_type = (dt >> 2) & 3
                thr = cpp_double(t.threshold[node])
                if missing_type == 2:      # NaN
                    cond = (f"(std::isnan(x[{f}]) ? {default_left} : "
                            f"(x[{f}] <= {thr}))")
                elif missing_type == 1:    # zero as missing
                    cond = (f"((std::isnan(x[{f}]) || std::fabs(x[{f}]) "
                            f"<= 1e-35) ? {default_left} : "
                            f"(x[{f}] <= {thr}))")
                else:
                    cond = (f"((std::isnan(x[{f}]) ? 0.0 : x[{f}]) "
                            f"<= {thr})")
            lines.append(f"{ind}if ({cond}) {{")
            emit_node(t, int(t.left_child[node]), depth + 1, lines)
            lines.append(f"{ind}}} else {{")
            emit_node(t, int(t.right_child[node]), depth + 1, lines)
            lines.append(f"{ind}}}")

        for i, t in enumerate(self.models):
            out.append(f"double PredictTree{i}(const double* x) {{")
            if t.num_nodes == 0:
                out.append(f"  return {cpp_double(t.leaf_value[0])};")
            else:
                emit_node(t, 0, 0, out)
            out += ["}", ""]
        k = max(self.num_class, 1)
        out += [f"const int kNumClass = {k};",
                f"const int kNumTrees = {len(self.models)};", "",
                "void Predict(const double* x, double* output) {",
                "  for (int c = 0; c < kNumClass; ++c) output[c] = 0.0;"]
        out += [f"  output[{i % k}] += PredictTree{i}(x);"
                for i in range(len(self.models))]
        if self.average_output:
            out.append(f"  for (int c = 0; c < kNumClass; ++c) "
                       f"output[c] /= {max(len(self.models) // k, 1)};")
        out += ["}", "", "}  // namespace lightgbm_tpu_model"]
        return "\n".join(out) + "\n"


def _tree_importance(models, importance_type: str,
                     width: int = 0) -> np.ndarray:
    """Splits (or summed gains) per feature over parsed trees, at least
    ``width`` features long."""
    out = np.zeros(width, np.float64)
    for t in models:
        if not t.num_nodes:
            continue
        f = t.split_feature[:t.num_nodes]
        if f.max() >= len(out):
            out = np.pad(out, (0, int(f.max()) + 1 - len(out)))
        np.add.at(out, f, 1.0 if importance_type == "split"
                  else t.split_gain[:t.num_nodes])
    return out


def _emit_loaded(header_lines, chunks, models, footer_lines,
                 feature_names, importance_type: str = "split",
                 importance: Optional[np.ndarray] = None) -> str:
    """A parsed model's text again: its header with new ``tree_sizes``, the
    tree blocks renumbered (leaf values written from ``models``), and its
    footer with ``importance`` (default: recomputed over ``models``;
    reference: ``_emit_loaded``, ``lightgbm_tpu/model_io.py:643-687``)."""
    blocks = []
    for i, (chunk, t) in enumerate(zip(chunks, models)):
        out = []
        for line in chunk:
            if line.startswith("Tree="):
                out.append(f"Tree={i}")
            elif line.startswith("leaf_value="):
                out.append("leaf_value=" + " ".join(
                    _fmt(v) for v in t.leaf_value))
            else:
                out.append(line)
        while out and not out[-1].strip():
            out.pop()
        blocks.append("\n".join(out) + "\n")
    header = list(header_lines)
    header.append("tree_sizes=" + " ".join(str(len(b) + 1) for b in blocks))
    header.append("")
    imp = (_tree_importance(models, importance_type) if importance is None
           else importance)
    footer = []
    in_imp = False
    for line in footer_lines:
        if line.strip() == "feature_importances:":
            in_imp = True
            footer.append(line)
            footer += _importance_lines(imp, feature_names)
            continue
        if in_imp:
            if "=" in line and not line.startswith("["):
                continue                  # the old importance lines
            in_imp = False
        footer.append(line)
    return "\n".join(header) + "\n" + "\n".join(blocks) \
        + "\n".join(footer)


def merge_model_texts(pre, new_text: str,
                      pre_num_iteration: Optional[int] = None,
                      pre_start_iteration: int = 0,
                      importance_type: str = "split",
                      importance: Optional[np.ndarray] = None) -> str:
    """A continued model's text: the loaded model's tree blocks (
    ``pre_num_iteration`` iterations of them from ``pre_start_iteration``,
    None: to the end), then those of ``new_text``, under ``new_text``'s
    header and footer, so that stock LightGBM and the JAX package load it
    (reference: ``merge_model_texts``, ``lightgbm_tpu/model_io.py:
    697-712``). ``pre``: a ``LoadedGBDT`` or model text; ``importance``:
    the footer's importances (default: those of the trees written)."""
    if not isinstance(pre, LoadedGBDT):
        pre = LoadedGBDT(pre)
    new = LoadedGBDT(new_text)
    first = max(pre_start_iteration, 0) * pre.num_class
    take = len(_window(pre.models, pre.num_class, pre_num_iteration,
                       pre_start_iteration))
    return _emit_loaded(new._header_lines,
                        pre._tree_chunks[first:first + take]
                        + new._tree_chunks,
                        pre.models[first:first + take] + new.models,
                        new._footer_lines, new.feature_names,
                        importance_type, importance)


def _objective_from_string(obj_str: str):
    """The objective of an ``objective=`` header line, or None for
    ``custom``."""
    parts = obj_str.split()
    if not parts or parts[0] == "custom":
        return None
    params: Dict[str, Any] = {"objective": parts[0]}
    for p in parts[1:]:
        key, sep, value = p.partition(":")
        if sep:
            params[key] = value
    cfg = Config(params)
    return create_objective(cfg.objective, cfg)


def load_booster(booster, model_str: str) -> None:
    """Make ``booster`` a prediction-only handle of ``model_str``."""
    booster._gbdt = LoadedGBDT(model_str)
    booster.train_set = None
