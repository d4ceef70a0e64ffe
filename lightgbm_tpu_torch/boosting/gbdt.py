"""Gradient Boosted Decision Trees over the masked and compact growers.

Counterpart of ``lightgbm_tpu/boosting/gbdt.py`` for the serial learner
(reference: class GBDT, src/boosting/gbdt.cpp): grower selection
(``tpu_grower``: ``auto`` is the masked grower below 65,536 rows and the
compact grower at and above, as at ``boosting/gbdt.py:964-995`` there;
EFB-bundled data takes the compact grower at any row count, and from 2^24
rows on every run takes the masked grower), the two training steps,
boost-from-average, validation-set score updates and ``HostTree``.

EFB (``_setup_efb``, reference ``_setup_efb``, ``boosting/gbdt.py:
2131-2245``): on a bundled dataset the compact grower scans the stored
columns plus one virtual feature per bundled original and routes bundled
winners by bitsets on their bundle columns through K2's copy-back variant;
the trees record original feature ids and bins, so prediction and model
text work in the original feature space, while validation sets, stored in
bundle space, are routed through ``col_of``. Where the compact grower cannot
run (``tpu_grower=masked``, 2^24 rows or more) the dataset is unbundled
first, with a warning.

An iteration grows K = ``num_model_per_iteration`` trees, one a class in
class order (K > 1 for the multiclass objectives); the train and
validation scores are ``[K, N]``. As in the reference (``GBDT::Boosting``
before the class loop, gbdt.cpp:220), the K classes' gradients are computed
once an iteration from the iteration-start scores.

* Masked step (``_build_step_fn``'s ``step`` there): gradients in the
  original row order, the iteration's in-bag mask (``sample_strategy.py``;
  ones without sampling) multiplied into the gradient, hessian and count
  channels, ``grow_tree`` over the bin matrix (kept on the device row-major
  for K1 and feature-major for the partition and K3; more than 256 bins are
  16-bit, an int16 view of the host's uint16 matrix, ``ops/packed.py``,
  and take this step only, as the reference's compact grower refuses them,
  ``boosting/gbdt.py:969``), and ``train_score[k] += leaf_value[row_leaf]``.
* Compact step (``_build_compact_step_fn`` there, ``boosting/gbdt.py:
  1561-1800``): the packed row-record state of ``_setup_compact_state``,
  built before the first compact tree (gradients in the current row order
  -> record columns -> grow -> ``segments_to_leaf_vectors``). The compact
  grower permutes the rows of the record arrays every tree, so the K
  train-score rows live in that permuted order (written into the record's K
  score columns before each tree) and a carried original-row-id column maps
  them back for metrics. With K > 1 the tree of class 0 also writes all K
  classes' gradients and hessians into 2K carried columns, which the trees
  of classes 1..K-1 read in their permuted order. Each tree writes
  ``g * w``, ``h * w`` and ``w`` into the record, ``w`` the in-bag weight: a
  fresh bag applied by position in the records' current order (the draws
  are i.i.d.), else the stored sample-weight column, which rode the
  partitions (a reused bag, and every tree after the first of an
  iteration).

Sampling (reference: ``boosting/gbdt.py:2253-2303``, ``:1935-1998``):
bagging and GOSS draw their mask on the device; GOSS ranks the gradients
(in the records' order on the compact grower) and its amplification
multiplies into the compact grower's ``w``. Balanced and by-query bagging
index rows in the dataset's order and take the masked grower.
``feature_fraction`` draws each iteration's features on the host with a
``numpy.random.RandomState(feature_fraction_seed)``, the JAX package's
picks exactly; ``feature_fraction_bynode`` draws a ``[2L-1, F]`` uniform
tensor on the device before each tree (``ops/grower.py``
``node_feature_mask``). ``sample_strategy.draws`` and ``bynode_draws`` take
the draws from outside (the tests feed the JAX package's).

Quantized gradients (``use_quantized_grad``; reference:
``_discretize_gradients``, ``boosting/gbdt.py:128-174``, after
GradientDiscretizer, gradient_discretizer.cpp): each round the gradients
become integer codes on the device with per-round scales (0-d device
tensors, never read by the host). One tree a round on the compact grower
(``num_grad_quant_bins`` <= 127 and ``num_data * bins`` below
``_QUANT_INT_LIMIT``) writes the codes into the records and grows on int32
histograms (K2's ``quant`` mode) that the scan dequantizes; every other
case (multiclass, the masked grower, the gates failed) takes the shim that
multiplies the codes back by their scales. ``quant_train_renew_leaf``
refits the leaf outputs from the true gradients. Stochastic rounding draws
from a ``torch.Generator`` on the run's device, seeded from ``seed + 1337``
and the iteration.

Ranking (reference: ``_ext_grads`` and ``_rank_grads_fn``, ``boosting/
gbdt.py:950-979``, ``:1512-1540``): a row-coupled objective (lambdarank)
takes the compact grower only with one tree a round, no quantized
gradients and no stochastic objective; its gradients are computed at
k = 0 in the dataset's row order (the carried score column scattered back
by the carried row id) and gathered into the records' current order. Every
other ranking configuration (``rank_xendcg``, quantized gradients, below
65,536 rows under ``auto``) takes the masked grower, whose rows keep the
dataset's order. Ranking data is never bundled.

Leaf renewal (``regression_l1``, ``quantile``, ``mape``; reference:
``boosting/gbdt.py:1130-1137`` masked, ``:1791-1800`` compact): after a
tree grows, each live leaf's output becomes the weighted alpha-quantile of
its rows' residuals (``ops/renew.py``), label minus the pre-tree score,
weighed by the metadata weight times the in-bag mask: in the dataset order
after the masked grower, from the carried label, weight, in-bag and
pre-tree score columns in the post-tree order after the compact grower.

Caller-supplied gradients (``train_one_iter(gradients, hessians)``, a custom
objective, reference: ``boosting/gbdt.py:2264-2293``) arrive in the
dataset's row order: before the first compact tree they move the run to the
masked grower, after it they raise. ``rollback_one_iter`` subtracts the
last iteration's trees from the train and validation scores, routing the
records' own bins on the compact grower. A loaded model's raw predictions
can seed the scores before the first tree (continued training).

Either way a tree grows with no device-to-host read; after it, its arrays
come to the host in ONE copy (the iteration's stop check and the model list
need them), and validation scores are routed on the device with the device
copy of the tree. A no-split tree is zeroed before shrinkage, and the init
score is folded into the first tree's leaves.

Constraints and the scan's other options (reference: ``boosting/gbdt.py:
94-124``, ``:720-843``, ``:901-909``): ``monotone_constraints`` (with
``monotone_constraints_method`` and ``monotone_penalty``),
``interaction_constraints``, ``path_smooth``, ``extra_trees``,
``feature_contri`` and CEGB reach the growers as a ``TreeOptions``. The
intermediate monotone method runs on the compact grower only (the masked
grower warns and runs the basic one; ``advanced`` warns and runs
intermediate); lazy CEGB costs take the masked grower, whose rows keep the
dataset's order for the ``[F, N]`` charged bitmap. Coupled CEGB costs are
paid once a model: the features the trees split on persist across trees
(``_cegb_used``), as does the charged bitmap. Each tree draws its
extra-trees words on the device from a ``torch.Generator`` seeded from
``extra_seed`` and the tree's index (the JAX key's ``fold_in(extra_key,
num_total_trees)``); ``extra_draws`` takes them from outside (the tests
feed the JAX package's). EFB data with monotone or interaction
constraints, CEGB or ``feature_contri`` is unbundled first, with a warning.

Boosting modes and tree options (reference: ``boosting/gbdt.py:800-834``,
``:983-987``): ``boosting=dart`` (``dart.py``) and ``boosting=rf``
(``rf.py``) subclass GBDT; RF, forced splits (``forcedsplits_filename``, a
host schedule of (leaf, feature, bin) that the masked grower applies first)
and linear leaves (``linear_tree``, ``linear.py``: a per-leaf ridge fit on
the host from one copy of the tree's row leaves and gradients) run on the
masked grower, whose rows keep the dataset's order. ``apply_tree_to_scores``
adds a multiple of a host tree to the train scores, the validation scores or
both (rollback, DART's drops); a model with ``average_output`` (RF) predicts
the mean of its iterations.

Checkpoints and the JAX package's compile ladder are ROADMAP A16 (the ladder
has no counterpart in eager PyTorch).
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import resolve_fused, resolve_hist_layout
from ..io.dataset import (BinnedDataset, bin_dtype, pack4_eligible,
                          pack4_matrix, pack4_train_eligible)
from ..io.efb import EfbLayout, unbundle
from ..metrics import Metric
from ..ops.compact import RowLayout, _u8_to_f32, pack_rows
from ..ops.grower import (ExtraDraws, GrowerParams, TreeArrays, TreeOptions,
                          grow_tree)
from ..ops.grower_compact import grow_tree_compact
from ..ops.histogram import narrow_chunk_rows
from ..ops.packed import bins_to_device
from ..ops.predict import StackedTrees, predict_leaf_batched, \
    predict_raw_batched
from ..ops.renew import renew_leaf_quantile
from ..ops.split import leaf_output
from ..utils import log
from .linear import add_bias_linear, fit_linear_leaves, linear_leaf_outputs
from .sample_strategy import GOSSStrategy, create_sample_strategy

# tpu_grower=auto takes the compact grower from this many rows on
# (reference: boosting/gbdt.py:988-995)
_COMPACT_MIN_ROWS = 65536
# from this many rows on, every run takes the masked grower: f32 counts are
# exact only below 2^24, and the compact grower's partition offsets and row
# ids need them exact; the masked grower routes each row by its own bin and
# leaves only its min_data gates inexact there (reference:
# boosting/gbdt.py:970)
_COMPACT_MAX_ROWS = 1 << 24
# quantized training's int32 histograms need num_data * num_grad_quant_bins
# below this: a near-constant feature's root bin sums up to that many code
# units (reference: boosting/gbdt.py:1642-1652)
_QUANT_INT_LIMIT = 1 << 31

# lazy CEGB keeps an [F, N] charged bitmap: at most this many elements
# (reference: boosting/gbdt.py:770-778)
_LAZY_CEGB_LIMIT = 1 << 30

_INT_FIELDS = ("split_feature", "split_bin", "default_left", "left_child",
               "right_child", "leaf_parent", "leaf_depth", "cat_bitset")
_FLOAT_FIELDS = ("split_gain", "leaf_value", "leaf_weight", "leaf_count",
                 "internal_value", "internal_weight", "internal_count")


class HostTree:
    """Host-side copy of one grown tree (numpy struct-of-arrays), the
    fields of the JAX package's HostTree."""

    __slots__ = ("split_feature", "split_bin", "cat_bitset", "split_gain",
                 "default_left", "left_child", "right_child", "leaf_value",
                 "leaf_weight", "leaf_count", "leaf_parent", "leaf_depth",
                 "internal_value", "internal_weight", "internal_count",
                 "num_leaves", "num_nodes", "shrinkage",
                 # linear leaves (linear.py)
                 "is_linear", "leaf_const", "leaf_features", "leaf_coeff")

    def __init__(self, fields: dict, shrinkage: float = 1.0):
        for name in self.__slots__:
            if name in fields:
                setattr(self, name, fields[name])
        self.num_leaves = int(fields["num_leaves"])
        self.num_nodes = int(fields["num_nodes"])
        if "cat_bitset" not in fields:
            self.cat_bitset = np.zeros((len(self.split_feature), 1),
                                       np.uint32)
        self.shrinkage = shrinkage
        self.is_linear = False

    def scale(self, factor: float) -> None:
        """Scale the tree's outputs (reference: ``HostTree.scale``,
        ``lightgbm_tpu/boosting/gbdt.py:321-325``, Tree::Shrinkage)."""
        self.leaf_value = self.leaf_value * factor
        self.internal_value = self.internal_value * factor
        self.shrinkage *= factor

    @classmethod
    def from_device(cls, tree: TreeArrays, shrinkage: float) -> "HostTree":
        """The tree's arrays in one device-to-host copy."""
        ints = [getattr(tree, k).to(torch.int64).reshape(-1)
                for k in _INT_FIELDS]
        ints += [tree.num_leaves.reshape(1), tree.num_nodes.reshape(1)]
        floats = [getattr(tree, k).reshape(-1) for k in _FLOAT_FIELDS]
        sizes = [t.numel() for t in ints + floats]
        # every int (the int32 bit patterns of the bitsets too) is exact in
        # float64
        blob = torch.cat([t.to(torch.float64) for t in ints + floats]).cpu()
        parts = np.split(blob.numpy(), np.cumsum(sizes)[:-1])
        fields = {}
        for name, arr in zip(_INT_FIELDS + ("num_leaves", "num_nodes"),
                             parts):
            fields[name] = arr.astype(np.int32)
        fields["default_left"] = fields["default_left"].astype(bool)
        fields["cat_bitset"] = fields["cat_bitset"].astype(np.uint32) \
            .reshape(tree.cat_bitset.shape)
        for name, arr in zip(_FLOAT_FIELDS, parts[len(_INT_FIELDS) + 2:]):
            fields[name] = arr.astype(np.float32)
        fields["num_leaves"] = int(fields["num_leaves"][0])
        fields["num_nodes"] = int(fields["num_nodes"][0])
        return cls(fields, shrinkage)

    @property
    def max_depth(self) -> int:
        return int(np.max(self.leaf_depth[:self.num_leaves], initial=0))


def stack_trees(models: Sequence[HostTree], device: torch.device,
                is_cat_feature: Optional[np.ndarray] = None
                ) -> StackedTrees:
    """Stack host trees into padded device arrays for prediction;
    ``is_cat_feature [F]`` marks the categorical features (None: none)."""
    t = len(models)
    max_leaves = max((len(m.leaf_value) for m in models), default=2)
    max_nodes = max(max_leaves - 1, 1)

    def pad(getter, fill, dtype, width):
        out = np.full((t, width), fill, dtype=dtype)
        for i, m in enumerate(models):
            a = getter(m)
            out[i, :len(a)] = a
        return torch.from_numpy(out).to(device)

    cat = {}
    if is_cat_feature is not None and np.any(is_cat_feature):
        w = max(m.cat_bitset.shape[1] for m in models)
        bits = np.zeros((t, max_nodes, w), np.uint32)
        for i, m in enumerate(models):
            bits[i, :m.cat_bitset.shape[0], :m.cat_bitset.shape[1]] = \
                m.cat_bitset
        cat = dict(
            is_cat=pad(lambda m: is_cat_feature[np.maximum(m.split_feature,
                                                           0)],
                       False, bool, max_nodes),
            cat_bitset=torch.from_numpy(bits.view(np.int32)).to(device))
    return StackedTrees(
        split_feature=pad(lambda m: m.split_feature, -1, np.int64, max_nodes),
        split_bin=pad(lambda m: m.split_bin, 0, np.int64, max_nodes),
        default_left=pad(lambda m: m.default_left, False, bool, max_nodes),
        left_child=pad(lambda m: m.left_child, -1, np.int64, max_nodes),
        right_child=pad(lambda m: m.right_child, -1, np.int64, max_nodes),
        leaf_value=pad(lambda m: m.leaf_value, 0.0, np.float32, max_leaves),
        num_nodes=torch.tensor([m.num_nodes for m in models],
                               dtype=torch.int64).to(device),
        **cat)


def _parse_monotone(value, num_features: int, feature_names
                    ) -> Optional[np.ndarray]:
    """``monotone_constraints`` as ``[F]`` int8 (a list, a comma string or
    a dict of feature names), None when every entry is 0 (reference:
    ``_parse_monotone``, ``lightgbm_tpu/boosting/gbdt.py:94-110``)."""
    if value is None:
        return None
    if isinstance(value, str):
        value = [int(v) for v in value.replace("(", "").replace(")", "")
                 .split(",") if v.strip()]
    if isinstance(value, dict):
        out = np.zeros(num_features, np.int8)
        for name, v in value.items():
            out[list(feature_names).index(name)] = int(v)
        return out if out.any() else None
    arr = np.asarray(list(value), np.int8)
    if arr.size != num_features:
        raise ValueError(
            f"monotone_constraints has {arr.size} entries for "
            f"{num_features} features")
    return arr if arr.any() else None


def _parse_interactions(value, num_features: int) -> Optional[np.ndarray]:
    """``interaction_constraints`` as ``[S, F]`` bool sets (lists of feature
    indices, or the ``"[0,1],[2,3]"`` string form; reference:
    ``_parse_interactions``, ``lightgbm_tpu/boosting/gbdt.py:113-124``)."""
    if value in (None, "", []):
        return None
    if isinstance(value, str):
        import json
        value = json.loads("[" + value + "]")
    sets = np.zeros((len(value), num_features), bool)
    for i, group in enumerate(value):
        sets[i, np.asarray(list(group), np.int64)] = True
    return sets


def _feature_vector(value, name: str, num_features: int) -> np.ndarray:
    """A per-feature float parameter (a list, or a comma string as config
    files give it) as ``[F]`` f32, checked for length."""
    if isinstance(value, str):
        value = [float(t) for t in value.split(",") if t.strip()]
    arr = np.asarray(list(value), np.float32)
    if arr.size != num_features:
        raise ValueError(f"{name} must have one entry per feature "
                         f"({num_features}), got {arr.size}")
    return arr


def _forced_split_schedule(path: str, mappers, num_leaves: int,
                           device: torch.device):
    """The forced-splits JSON as ``(leaf, feature, bin)`` int64 tensors of
    the first splits, or None when it forces none (reference:
    ``_forced_split_schedule``, ``lightgbm_tpu/boosting/gbdt.py:181-216``,
    after SerialTreeLearner::ForceSplits): breadth first, leaf ids in the
    growers' creation order (the left child keeps its parent's id, the right
    child becomes leaf ``k + 1`` after split ``k``), thresholds through the
    bin mapper."""
    import json
    from collections import deque
    with open(path) as fh:
        root = json.load(fh)
    leaves, feats, bins = [], [], []
    queue = deque([(root, 0)])
    k = 0
    while queue and k < num_leaves - 1:
        node, leaf = queue.popleft()
        if node is None or "feature" not in node:
            continue
        f = int(node["feature"])
        m = mappers[f]
        if m.is_categorical:
            raise ValueError(
                "forced splits on categorical features are not supported")
        leaves.append(leaf)
        feats.append(f)
        bins.append(int(m.value_to_bin(np.array([float(node["threshold"])]))
                        [0]))
        k += 1
        if node.get("left"):
            queue.append((node["left"], leaf))
        if node.get("right"):
            queue.append((node["right"], k))
    if not leaves:
        return None
    return tuple(torch.tensor(a, dtype=torch.int64, device=device)
                 for a in (leaves, feats, bins))


def _discretize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                          num_bins: int, stochastic: bool, const_hess: bool,
                          generator: Optional[torch.Generator] = None,
                          uniforms=None):
    """Gradient discretization (reference: ``_discretize_gradients``,
    ``lightgbm_tpu/boosting/gbdt.py:128-159``): codes on ``num_bins``
    levels, ``|qg| <= bins / 2`` and ``0 <= qh <= bins`` (exact integers in
    f32), with the scales ``max|g| / (bins // 2)`` and ``max h`` (constant
    hessian) or ``max h / bins``, as 0-d tensors. Stochastic rounding
    truncates ``x + sign(x) u`` with ``u`` uniform in [0, 1), drawn from
    ``generator``; ``uniforms = (ug, uh)`` passes the draws in instead (the
    tests feed the JAX package's). Returns ``(qg, qh, g_scale, h_scale)``."""
    g_scale = torch.clamp(torch.max(torch.abs(grad)) / (num_bins // 2),
                          min=1e-30)
    hmax = torch.max(torch.abs(hess))
    h_scale = torch.clamp(hmax if const_hess else hmax / num_bins,
                          min=1e-30)
    if stochastic:
        if uniforms is None:
            uniforms = (torch.rand(grad.shape, generator=generator,
                                   device=grad.device),
                        torch.rand(hess.shape, generator=generator,
                                   device=hess.device))
        ug, uh = uniforms
        qg = torch.trunc(grad / g_scale + torch.sign(grad) * ug)
        qh = torch.trunc(hess / h_scale + uh)
    else:
        qg = torch.trunc(grad / g_scale + torch.sign(grad) * 0.5)
        qh = torch.trunc(hess / h_scale + 0.5)
    return qg, qh, g_scale, h_scale


def _quantize_gradients(grad: torch.Tensor, hess: torch.Tensor,
                        num_bins: int, stochastic: bool, const_hess: bool,
                        generator: Optional[torch.Generator] = None,
                        uniforms=None):
    """The dequantized-f32 shim (reference: ``_quantize_gradients``,
    ``lightgbm_tpu/boosting/gbdt.py:162-174``): the codes times their
    scales, exact integer multiples, for the paths that keep f32
    histograms."""
    qg, qh, g_scale, h_scale = _discretize_gradients(
        grad, hess, num_bins, stochastic, const_hess, generator, uniforms)
    return qg * g_scale, qh * h_scale


def _initial_scores(md, k: int, n: int) -> np.ndarray:
    """``[K, N]`` f32 zeros plus the dataset's init score (class-major
    when K > 1, as LightGBM stores it)."""
    score0 = np.zeros((k, n), np.float32)
    if md is not None and md.init_score is not None:
        score0 += np.asarray(md.init_score, np.float32).reshape(k, n)
    return score0


def _dense_bins(ds: BinnedDataset) -> np.ndarray:
    """``ds``'s bin matrix with one column a feature (bundles undone)."""
    if ds.bundle_info is None:
        return ds.binned
    dbins = np.array([m.default_bin for m in ds.mappers], np.int32)
    return unbundle(np.asarray(ds.binned), ds.bundle_info, dbins,
                    ds.feature_num_bins())


def _unbundle(ds: BinnedDataset, why: str) -> None:
    """Undo ``ds``'s EFB bundles in place, with a warning (reference:
    ``_efb_precheck`` and ``_setup_efb``'s fallback, ``boosting/gbdt.py:
    2081-2184``)."""
    log.warning(why)
    ds.binned = _dense_bins(ds)
    ds.bundle_info = None


class _ValidSet:
    """Cached raw scores of one validation set (reference: ScoreUpdater)."""

    def __init__(self, dataset: BinnedDataset, name: str, k: int,
                 device: torch.device):
        self.dataset = dataset
        self.name = name
        self.n_real = dataset.num_data
        self.binned = bins_to_device(dataset.binned, device)
        self.score = torch.from_numpy(_initial_scores(
            dataset.metadata, k, self.n_real)).to(device)
        self.metrics: List[Metric] = []


class GBDT:
    """Gradient Boosted Decision Trees (reference: class GBDT, gbdt.h)."""

    boosting_type = "gbdt"
    # RF averages its iterations' outputs instead of summing them
    average_output = False
    # lazy CEGB costs (RF declines them, reference: gbdt.py:475, :756-760)
    _supports_lazy_cegb = True
    # RF grows every tree on the masked grower
    _masked_only = False

    def __init__(self, config, train_set: BinnedDataset, objective,
                 device: torch.device):
        """``objective`` None: a custom objective, whose gradients every
        ``train_one_iter`` call supplies."""
        self.config = config
        self.objective = objective
        self.train_set = train_set
        self.device = device
        self.models: List[HostTree] = []
        self.iter_ = 0
        self.learning_rate = float(config.get("learning_rate", 0.1))
        self.shrinkage_rate = self.learning_rate
        self.num_class = (objective.num_model_per_iteration
                          if objective is not None
                          else int(config.get("num_class", 1)))
        self._init_scores = [0.0] * self.num_class
        self.valid_sets: List[_ValidSet] = []
        self.train_metrics: List[Metric] = []
        self.mappers = train_set.mappers
        self.feature_names = list(train_set.feature_names)
        # prediction bins rows in the training matrix's type
        self._bin_dtype = train_set.binned.dtype
        self._setup_train(train_set)

    @classmethod
    def for_prediction(cls, config, models: Sequence[HostTree], mappers,
                       objective, device: torch.device,
                       feature_names: Optional[Sequence[str]] = None
                       ) -> "GBDT":
        """A model that only predicts: trees, bin mappers, objective."""
        self = cls.__new__(cls)
        self.config = config
        self.objective = objective
        self.train_set = None
        self.device = device
        self.models = list(models)
        self.num_class = (objective.num_model_per_iteration
                          if objective is not None else 1)
        self.iter_ = len(self.models) // self.num_class
        self.mappers = list(mappers)
        self._bin_dtype = bin_dtype(max([m.num_bins for m in self.mappers]
                                        + [1]))
        self.feature_names = (list(feature_names) if feature_names is not None
                              else [f"Column_{i}"
                                    for i in range(len(self.mappers))])
        self.valid_sets = []
        self.train_metrics = []
        self.nan_bin_arr = torch.tensor(
            [m.nan_bin if not m.is_trivial else 0 for m in self.mappers],
            dtype=torch.int64).to(device)
        self._pred_nan_arr = self.nan_bin_arr
        self._pred_pack4 = False
        self._efb = None
        self._linear = False
        return self

    def feature_is_categorical(self) -> np.ndarray:
        return np.array([m.is_categorical for m in self.mappers], bool)

    # -- training setup ------------------------------------------------------
    def _setup_train(self, train_set: BinnedDataset) -> None:
        cfg = self.config
        dev = self.device
        n = train_set.num_data
        self.num_data = n
        self._n_real = n
        grower = str(cfg.get("tpu_grower", "auto")).lower()
        obj = self.objective
        goss = str(cfg.get("data_sample_strategy", "bagging")) == "goss"
        # a row-coupled objective (lambdarank) runs on the compact grower
        # with its gradients computed outside the step (reference: gbdt.py:
        # 950-979). Decided before the objective's init, as the reference
        # does: lambdarank's position biases (found at init) make it
        # stochastic but do not close this route
        self._ext_grads = (obj is not None and not obj.row_elementwise
                           and self.num_class == 1 and not goss
                           and not bool(cfg.get("use_quantized_grad",
                                                False)))
        obj_ok = (obj is not None
                  and (obj.row_elementwise or self._ext_grads)
                  and not obj.is_stochastic)
        # balanced and by-query bagging index rows in the dataset's order
        # (reference: gbdt.py:970-974)
        rows_ok = (float(cfg.get("pos_bagging_fraction", 1.0)) >= 1.0
                   and float(cfg.get("neg_bagging_fraction", 1.0)) >= 1.0
                   and not bool(cfg.get("bagging_by_query", False)))
        self._parse_options(train_set)
        # lazy CEGB costs track charged rows in the dataset's order, which
        # the compact grower permutes (reference: gbdt.py:975-978)
        rows_ok = rows_ok and self._cegb_lazy_np is None
        # RF, linear leaves (fit on raw rows in the dataset's order) and
        # forced splits run on the masked grower (reference: gbdt.py:983-987)
        modes_ok = not (self._masked_only or self._linear
                        or self._forced is not None)
        # more than 256 bins: 16-bit bins, which the records' byte columns
        # cannot hold (reference: boosting/gbdt.py:969)
        bins_ok = int(train_set.max_num_bins) <= 256
        can_compact = (n < _COMPACT_MAX_ROWS and obj_ok and rows_ok
                       and modes_ok and bins_ok)
        if grower == "compact" and not bins_ok:
            log.warning(f"tpu_grower=compact stores bins in bytes and "
                        f"supports at most 256 bins (this dataset has "
                        f"{train_set.max_num_bins}: max_bin > 255); using "
                        "the masked grower")
        elif grower == "compact" and not modes_ok:
            log.warning(f"tpu_grower=compact does not run "
                        f"boosting={self.boosting_type}, linear_tree or "
                        "forced splits; using the masked grower")
        elif grower == "compact" and not (obj_ok and rows_ok):
            log.warning("tpu_grower=compact requires a row-elementwise "
                        "objective, or a row-coupled one with one tree a "
                        "round, no quantized gradients, no GOSS and no "
                        "random draws, neither balanced nor by-query "
                        "bagging, and no lazy CEGB costs; using the masked "
                        "grower")
        elif grower == "compact" and not can_compact:
            log.warning(f"tpu_grower=compact supports fewer than "
                        f"{_COMPACT_MAX_ROWS} rows (f32 counts); using the "
                        "masked grower")
        self._efb_precheck(train_set, grower, can_compact)
        bundled = train_set.bundle_info is not None
        # bundled data takes the compact grower at any row count: the
        # bundle-space scan and routing live there
        self.use_compact = can_compact and (grower == "compact" or (
            grower == "auto" and (n >= _COMPACT_MIN_ROWS or bundled)))
        if self._mono_intermediate and not self.use_compact:
            log.warning("monotone_constraints_method='intermediate' runs on "
                        "the compact grower only; this configuration uses "
                        "the masked grower with the 'basic' method")
            self._mono_intermediate = False
        mappers = train_set.mappers
        # prediction packs its bins two a byte where every original feature
        # has at most 16 bins (reference: boosting/gbdt.py:713-717)
        want_pack4 = bool(cfg.get("tpu_bin_pack4", False))
        self._pred_pack4 = want_pack4 and pack4_eligible(mappers)
        if want_pack4 and not self._pred_pack4:
            log.warning("tpu_bin_pack4=true needs every feature to have "
                        "<= 16 bins (max_bin <= 15); predicting on the u8 "
                        "matrix")
        # prediction and model text work per original feature
        self._pred_nan_arr = torch.from_numpy(
            train_set.feature_nan_bins().astype(np.int64)).to(dev)
        self.num_bins_arr = torch.from_numpy(
            train_set.feature_num_bins().astype(np.int64)).to(dev)
        self.nan_bin_arr = self._pred_nan_arr
        self.has_nan_arr = torch.from_numpy(train_set.feature_has_nan()).to(
            dev)
        self._base_feat_mask = np.array([not m.is_trivial for m in mappers],
                                        bool)
        is_cat = train_set.feature_is_categorical()
        self.grower_params = GrowerParams(
            num_leaves=int(cfg.get("num_leaves", 31)),
            max_depth=int(cfg.get("max_depth", -1)),
            num_bins=int(train_set.max_num_bins),
            lambda_l1=float(cfg.get("lambda_l1", 0.0)),
            lambda_l2=float(cfg.get("lambda_l2", 0.0)),
            min_data_in_leaf=float(cfg.get("min_data_in_leaf", 20)),
            min_sum_hessian_in_leaf=float(
                cfg.get("min_sum_hessian_in_leaf", 1e-3)),
            min_gain_to_split=float(cfg.get("min_gain_to_split", 0.0)),
            max_delta_step=float(cfg.get("max_delta_step", 0.0)),
            max_cat_threshold=int(cfg.get("max_cat_threshold", 32)),
            cat_l2=float(cfg.get("cat_l2", 10.0)),
            cat_smooth=float(cfg.get("cat_smooth", 10.0)),
            max_cat_to_onehot=int(cfg.get("max_cat_to_onehot", 4)),
            min_data_per_group=float(cfg.get("min_data_per_group", 100)),
            hist_layout=resolve_hist_layout(cfg,
                                            int(train_set.max_num_bins)),
            # without the fused kernel the partition is K2's copy-back
            fused=resolve_fused(cfg),
            fused_dual=resolve_fused(cfg),
            bynode_fraction=float(cfg.get("feature_fraction_bynode", 1.0)),
            use_monotone=self._mono_np is not None,
            monotone_penalty=float(cfg.get("monotone_penalty", 0.0)),
            mono_intermediate=self._mono_intermediate,
            path_smooth=float(cfg.get("path_smooth", 0.0)),
            use_interaction=self._inter_np is not None,
            use_cegb=self._use_cegb,
            cegb_split_pen=self._cegb_split_pen,
            extra_trees=bool(cfg.get("extra_trees", False)),
        )
        self._setup_options_state()
        self._efb = None
        if train_set.bundle_info is not None:
            is_cat = self._setup_efb(train_set)
        # scan space: the features a tree may split on
        self.feat_mask = torch.from_numpy(self._base_feat_mask).to(dev)
        # None keeps the categorical scan out of numerical runs
        self.is_cat_arr = (torch.from_numpy(is_cat).to(dev) if is_cat.any()
                           else None)
        md = train_set.metadata
        if self.objective is not None:
            self.objective.init(md, n)
        self._has_init_score = md.init_score is not None
        self.train_score = torch.from_numpy(_initial_scores(
            md, self.num_class, n)).to(dev)
        self.sample_strategy = create_sample_strategy(cfg, n, md, dev)
        self.feature_fraction = float(cfg.get("feature_fraction", 1.0))
        self._feat_rng = np.random.RandomState(
            int(cfg.get("feature_fraction_seed", 2)))
        self._bynode_seed = int(cfg.get("feature_fraction_seed", 2))
        self._bynode_gen = None
        # the by-node draws' seam: (tree index, rows, features) -> [rows,
        # features] uniforms; None draws from a torch.Generator
        self.bynode_draws = None
        self._setup_quant()
        # the compact records are packed before the first compact tree
        # (_begin_compact_iter), so that scores seeded before it (a
        # continued model) ride in them, and a custom objective's first
        # call can still move the run to the masked grower
        self._compact_ready = False
        # seconds of the linear leaves' host fits, over the run
        self.linear_fit_s = 0.0
        if not self.use_compact:
            self._setup_masked_state(train_set)

    def _parse_options(self, train_set: BinnedDataset) -> None:
        """The constraint and option parameters on the host (reference:
        ``boosting/gbdt.py:720-843``): monotone directions, interaction
        sets, CEGB's scaled costs, ``feature_contri``."""
        cfg = self.config
        nf = len(train_set.mappers)
        self._mono_np = _parse_monotone(cfg.get("monotone_constraints"), nf,
                                        train_set.feature_names)
        self._inter_np = _parse_interactions(
            cfg.get("interaction_constraints"), nf)
        method = str(cfg.get("monotone_constraints_method", "basic")).lower()
        self._mono_intermediate = (self._mono_np is not None
                                   and method in ("intermediate", "advanced"))
        if self._mono_np is not None and method == "advanced":
            log.warning("monotone_constraints_method='advanced' is not "
                        "implemented; using the 'intermediate' method")
        tradeoff = float(cfg.get("cegb_tradeoff", 1.0))
        split_pen = float(cfg.get("cegb_penalty_split", 0.0))
        coupled = cfg.get("cegb_penalty_feature_coupled")
        lazy = cfg.get("cegb_penalty_feature_lazy")
        if lazy is not None and not self._supports_lazy_cegb:
            log.warning("cegb_penalty_feature_lazy is not supported with "
                        f"boosting={self.boosting_type}; the lazy penalty "
                        "is ignored")
            lazy = None
        self._cegb_coupled_np = None if coupled is None else tradeoff * \
            _feature_vector(coupled, "cegb_penalty_feature_coupled", nf)
        self._cegb_lazy_np = None
        if lazy is not None:
            lz = _feature_vector(lazy, "cegb_penalty_feature_lazy", nf)
            if nf * train_set.num_data > _LAZY_CEGB_LIMIT:
                raise ValueError(
                    "cegb_penalty_feature_lazy needs an [F, N] charged-rows "
                    f"bitmap; {nf}x{train_set.num_data} exceeds the "
                    f"supported size (2^30 elements)")
            self._cegb_lazy_np = tradeoff * lz
        self._cegb_split_pen = tradeoff * split_pen
        self._use_cegb = (split_pen > 0.0 or coupled is not None
                          or lazy is not None)
        fc = cfg.get("feature_contri")
        self._contri_np = None if fc is None else _feature_vector(
            fc, "feature_contri", nf)
        fs_path = str(cfg.get("forcedsplits_filename", "") or "")
        self._forced = (_forced_split_schedule(
            fs_path, train_set.mappers, int(cfg.get("num_leaves", 31)),
            self.device) if fs_path else None)
        linear = bool(cfg.get("linear_tree", False))
        # (reference: gbdt.py:800-813)
        self._linear = linear and self.boosting_type == "gbdt"
        if linear and not self._linear:
            log.warning(f"linear_tree is not supported with "
                        f"boosting={self.boosting_type}; training constant "
                        "leaves")
        if self._linear and train_set.raw_data is None:
            raise ValueError(
                "linear_tree=true needs raw feature values; construct the "
                "Dataset with the linear_tree parameter set (or "
                "free_raw_data=False) so they are retained")

    def _setup_options_state(self) -> None:
        """The options' device tensors and the model-level CEGB state."""
        dev = self.device

        def t(a, dtype):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a)).to(dev, dtype)
        self._opts = TreeOptions(
            mono_types=t(self._mono_np, torch.int64),
            inter_sets=t(self._inter_np, torch.bool),
            cegb_coupled=t(self._cegb_coupled_np, torch.float32),
            cegb_lazy=t(self._cegb_lazy_np, torch.float32),
            feature_contri=t(self._contri_np, torch.float32))
        # CEGB: the features any tree split on, the (feature, row) pairs
        # charged (made at the first tree)
        self._cegb_used = None
        self._cegb_charged = None
        self._extra_seed = int(self.config.get("extra_seed", 6))
        self._extra_gen = None
        # the extra-trees draws' seam: (tree index, leaves, features,
        # intermediate) -> ExtraDraws; None draws from a torch.Generator
        self.extra_draws = None
        # the last compact tree's counters (ops/grower_compact.py stats)
        self.tree_stats = {}

    def _tree_options(self, tree_index: int, n_scan: int) -> TreeOptions:
        """The options of tree ``tree_index`` over ``n_scan`` scan-space
        features: the model-level CEGB state and the tree's extra-trees
        draws."""
        gp = self.grower_params
        opts = self._opts
        if gp.use_cegb:
            if self._cegb_used is None:
                self._cegb_used = torch.zeros(n_scan, dtype=torch.bool,
                                              device=self.device)
            if opts.cegb_lazy is not None and self._cegb_charged is None:
                self._cegb_charged = torch.zeros(
                    (n_scan, self.num_data), dtype=torch.bool,
                    device=self.device)
            opts = opts._replace(cegb_used=self._cegb_used,
                                 cegb_charged=self._cegb_charged)
        if gp.extra_trees:
            opts = opts._replace(extra=self._extra_words(tree_index, n_scan))
        return opts

    def _extra_words(self, tree_index: int, f: int) -> ExtraDraws:
        """Tree ``tree_index``'s extra-trees words (the JAX package's
        ``fold_in(extra_key, num_total_trees)``): two random 32-bit words
        for each (node row, feature), for the thresholds, the sorted
        categorical prefixes and, with the intermediate method, the
        rescans."""
        gp = self.grower_params
        L = gp.num_leaves
        if self.extra_draws is not None:
            ex = self.extra_draws(tree_index, L, f, gp.mono_intermediate)
            return ExtraDraws(*(None if a is None else a.to(
                self.device, torch.int64) for a in ex))
        if self._extra_gen is None:
            self._extra_gen = torch.Generator(device=self.device)
        # within 32 bits: the CPU generator keeps only the low 32 of a seed
        self._extra_gen.manual_seed(
            (self._extra_seed * 1_000_003 + tree_index) & 0xFFFF_FFFF)

        def words(*shape):
            return torch.randint(0, 1 << 32, (*shape, f, 2),
                                 generator=self._extra_gen,
                                 device=self.device, dtype=torch.int64)
        node = words(2 * L - 1)
        cat = words(2 * L - 1) if self.is_cat_arr is not None else node
        if not gp.mono_intermediate:
            return ExtraDraws(node, cat)
        rescan = words(L - 1, L)
        return ExtraDraws(node, cat, rescan, words(L - 1, L)
                          if self.is_cat_arr is not None else rescan)

    def _note_used_features(self, tree: TreeArrays) -> None:
        """OR the tree's split features into the model-level CEGB set
        (reference: ``_tree_used_features``, ``boosting/gbdt.py:175-178``)."""
        if self._cegb_used is None:
            return
        nf = self._cegb_used.shape[0]
        sf = tree.split_feature
        hit = torch.zeros(nf + 1, dtype=torch.bool, device=self.device)
        hit[torch.where(sf >= 0, sf, nf)] = True
        self._cegb_used |= hit[:nf]

    def _setup_quant(self) -> None:
        """Quantized training's parameters and the choice between the int32
        histogram path and the shim (reference: ``boosting/gbdt.py:815-824``
        and ``:1618-1676``)."""
        cfg = self.config
        self._use_quant = bool(cfg.get("use_quantized_grad", False))
        self._quant_bins = int(cfg.get("num_grad_quant_bins", 4))
        self._quant_renew = self._use_quant and bool(
            cfg.get("quant_train_renew_leaf", False))
        self._quant_stochastic = bool(cfg.get("stochastic_rounding", True))
        self._quant_seed = int(cfg.get("seed", 0) or 0) + 1337
        self._quant_gen = None
        self._quant_int = False
        if not self._use_quant or not self.use_compact:
            return
        k, n, bins = self.num_class, self.num_data, self._quant_bins
        if k > 1:
            if self._quant_renew:
                # the iteration-start gradients are not carried past the
                # permutation; the masked grower renews multiclass leaves
                log.warning("quant_train_renew_leaf with num_class>1 is "
                            "only supported by tpu_grower=masked; skipping "
                            "renewal")
                self._quant_renew = False
            return
        if isinstance(self.sample_strategy, GOSSStrategy):
            # GOSS amplifies sampled rows by a non-integer factor, which
            # integer codes cannot carry: the dequantized-f32 shim
            return
        fits = n * bins < _QUANT_INT_LIMIT
        if bins > 127:
            log.warning(f"use_quantized_grad: num_grad_quant_bins={bins} "
                        "exceeds the int8 code range (127); using the "
                        "dequantized-f32 histogram path")
        elif not fits:
            log.warning(
                f"use_quantized_grad: num_data*num_grad_quant_bins = "
                f"{n}*{bins} exceeds the int32 histogram range; using the "
                "dequantized-f32 histogram path")
        self._quant_int = bins <= 127 and fits
        if not self._quant_int:
            return
        gp = self.grower_params._replace(quant_max=bins + 1)
        # the narrowed 16-bit histogram, chosen a leaf at a time without the
        # fused kernel (reference: boosting/gbdt.py:1655-1685); auto (0)
        # keeps 32 bits, as there
        bits = int(cfg.get("tpu_quant_hist_bits", 0) or 0)
        if bits not in (0, 16, 32):
            log.warning(f"tpu_quant_hist_bits={bits} is not one of 0 (auto) "
                        "| 16 | 32; using 32-bit accumulation")
            bits = 32
        narrow_able = narrow_chunk_rows(bins + 1) > 0 and not gp.fused
        if bits == 16 and not narrow_able:
            log.warning("tpu_quant_hist_bits=16 needs the compact grower "
                        "without the fused kernel (tpu_fused=off) and a "
                        "num_grad_quant_bins small enough for the packing "
                        "radix; keeping 32-bit accumulation")
        self.grower_params = gp._replace(
            quant_narrow=bits == 16 and narrow_able)

    def _quant_generator(self) -> torch.Generator:
        """The stochastic-rounding draws of this iteration: a generator on
        the run's device seeded from ``seed + 1337`` and the iteration (the
        JAX key's ``fold_in(key, iter_)``)."""
        if self._quant_gen is None:
            self._quant_gen = torch.Generator(device=self.device)
        # within 32 bits: the CPU generator keeps only the low 32 of a seed
        self._quant_gen.manual_seed(
            (self._quant_seed * 1_000_003 + self.iter_) & 0xFFFF_FFFF)
        return self._quant_gen

    def _quant_args(self):
        return (self._quant_bins, self._quant_stochastic,
                bool(getattr(self.objective, "is_constant_hessian", False)),
                self._quant_generator() if self._quant_stochastic else None)

    def _renewed(self, tree: TreeArrays, sums_g: torch.Tensor,
                 sums_h: torch.Tensor) -> TreeArrays:
        """The tree with its live leaves refit from true gradient sums
        (reference: RenewIntGradTreeOutput, ``boosting/gbdt.py:1118-1130``
        and ``:1802-1823``)."""
        live = torch.arange(sums_g.shape[0], device=sums_g.device) \
            < tree.num_leaves
        out = leaf_output(sums_g, sums_h, self.grower_params.split_params())
        return tree._replace(leaf_value=torch.where(live, out,
                                                    tree.leaf_value))

    def _renew_quantile(self, tree: TreeArrays, residual: torch.Tensor,
                        weight: torch.Tensor, row_leaf: torch.Tensor
                        ) -> TreeArrays:
        """The tree with each live leaf's output renewed to its rows'
        weighted ``renew_alpha``-quantile of ``residual`` (reference:
        ``boosting/gbdt.py:1130-1137``, ``:1791-1800``)."""
        L = tree.leaf_value.shape[0]
        renewed = renew_leaf_quantile(residual, weight, row_leaf, L,
                                      float(self.objective.renew_alpha))
        live = torch.arange(L, device=renewed.device) < tree.num_leaves
        return tree._replace(leaf_value=torch.where(live, renewed,
                                                    tree.leaf_value))

    def _efb_precheck(self, train_set: BinnedDataset, grower: str,
                      can_compact: bool) -> None:
        """Unbundle an EFB dataset, with a warning, before the grower is
        chosen, where the run cannot take the compact grower with a
        row-elementwise objective (``tpu_grower=masked``, 2^24 rows or
        more, a row-coupled, stochastic or custom objective, query groups,
        balanced or by-query bagging, lazy CEGB costs), or where the run
        has monotone or interaction constraints, CEGB or ``feature_contri``
        (reference: ``_efb_precheck``, ``boosting/gbdt.py:2081-2129``,
        whose other conditions are parameters the port raises on)."""
        obj = self.objective
        if train_set.bundle_info is None:
            return
        cfg = self.config
        knobs = [name for name in (
            "monotone_constraints", "interaction_constraints",
            "feature_contri", "cegb_penalty_feature_coupled",
            "cegb_penalty_feature_lazy") if cfg.get(name) is not None]
        if float(cfg.get("cegb_penalty_split", 0.0) or 0.0) != 0.0:
            knobs.append("cegb_penalty_split")
        if knobs:
            _unbundle(train_set, "EFB bundles are not supported with "
                      f"{', '.join(knobs)}; unbundling the dataset (set "
                      "enable_bundle=false to skip bundling entirely)")
        elif (grower not in ("compact", "auto") or not can_compact
                or not obj.row_elementwise
                or train_set.metadata.query_boundaries is not None):
            _unbundle(train_set, "EFB bundles need the compact grower and "
                      "a row-elementwise objective without query groups or "
                      "balanced or by-query bagging; unbundling the "
                      "dataset (set enable_bundle=false to skip bundling "
                      "entirely)")

    def _setup_efb(self, train_set: BinnedDataset) -> np.ndarray:
        """Wire an EFB-bundled dataset into the compact grower (reference:
        ``_setup_efb``, ``boosting/gbdt.py:2131-2245``). Scan space: the C
        stored columns plus one virtual feature per bundled original (its
        histogram is made from its bundle column's bin range,
        ``extend_hist_efb``); routing space: the stored columns (a bundled
        winner carries a ready bitset). Bundle columns never win a split.
        Sets the scan-space arrays, ``self._efb`` (an ``EfbLayout``) and
        the arrays that route validation rows in bundle space; returns
        the scan-space categorical flags. K2 runs its copy-back variant
        here, as the reference does (``boosting/gbdt.py:1424-1438``)."""
        dev = self.device
        binfo = train_set.bundle_info
        c = binfo.n_columns
        mappers = train_set.mappers
        orig_nb = train_set.feature_num_bins()
        orig_nan = train_set.feature_nan_bins()
        orig_cat = train_set.feature_is_categorical()
        orig_has_nan = train_set.feature_has_nan()
        orig_dbin = np.array([m.default_bin for m in mappers], np.int64)
        nontrivial = np.array([not m.is_trivial for m in mappers], bool)
        bundled = np.nonzero(binfo.offset_of >= 0)[0]
        passthrough = np.nonzero(binfo.offset_of < 0)[0]
        fb = len(bundled)

        def colv(vals, fill):
            """Per-feature values on the stored columns (passthrough
            features' own columns; ``fill`` on bundle columns)."""
            vals = np.asarray(vals)
            v = np.full(c, fill, vals.dtype)
            v[binfo.col_of[passthrough]] = vals[passthrough]
            return v

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        i64 = np.int64
        self.num_bins_arr = t(np.concatenate(
            [binfo.num_column_bins, orig_nb[bundled]]).astype(i64))
        self.nan_bin_arr = t(np.concatenate(
            [colv(orig_nan, 0), orig_nan[bundled]]).astype(i64))
        self.has_nan_arr = t(np.concatenate(
            [colv(orig_has_nan, False), np.zeros(fb, bool)]))
        self._base_feat_mask = np.concatenate(
            [colv(nontrivial, False), np.ones(fb, bool)])
        orig_of_col = np.full(c, -1, i64)
        orig_of_col[binfo.col_of[passthrough]] = passthrough
        self._efb = EfbLayout(*(t(a) for a in (
            np.concatenate([np.arange(c), binfo.col_of[bundled]]).astype(i64),
            np.concatenate([colv(orig_cat, False), np.ones(fb, bool)]),
            np.concatenate([np.full(c, -1), binfo.offset_of[bundled]]
                           ).astype(i64),
            np.concatenate([np.zeros(c), orig_nb[bundled]]).astype(i64),
            np.concatenate([np.zeros(c), orig_dbin[bundled]]).astype(i64),
            np.concatenate([orig_of_col, bundled]).astype(i64))))
        # validation rows are stored in bundle space: a node on original
        # feature j reads column col_of[j], by its bitset when j is bundled
        self._route_col = t(binfo.col_of.astype(i64))
        self._route_cat = t(orig_cat | (binfo.offset_of >= 0))
        self._route_nan = t(colv(orig_nan, 0).astype(i64))
        self.grower_params = self.grower_params._replace(
            efb_virtual=fb, efb_bmax=int(orig_nb[bundled].max()),
            fused_dual=False)
        log.info("EFB-bundled dataset: the compact grower scans "
                 f"{c} stored columns and {fb} bundled features, K2 in its "
                 "copy-back variant")
        return np.concatenate([colv(orig_cat, False), np.zeros(fb, bool)])

    def _setup_masked_state(self, train_set: BinnedDataset) -> None:
        """The masked grower's inputs, made once: the bin matrix row-major
        (K1) and feature-major (the partition's feature rows and K3), label,
        weight and the all-ones row mask (the in-bag mask of an iteration
        that samples no rows)."""
        dev = self.device
        md = train_set.metadata
        binned = np.ascontiguousarray(train_set.binned)
        self.binned = bins_to_device(binned, dev)
        # feature rows padded to a multiple of 16 entries: K3 loads its
        # (uint8) tiles in 16-byte pieces
        n, f = binned.shape
        binned_t = np.zeros((f, -(-n // 16) * 16), binned.dtype)
        binned_t[:, :n] = binned.T
        self.binned_t = bins_to_device(binned_t, dev)[:, :n]
        self.label = torch.from_numpy(np.asarray(md.label, np.float32)).to(
            dev)
        self.weight = (None if md.weight is None else torch.from_numpy(
            np.asarray(md.weight, np.float32)).to(dev))
        # the gradients' weight: the objective's own (MAPE folds its label
        # weight into it; the JAX package's masked step reads it there)
        ow = (self.objective.weight if self.objective is not None
              else md.weight)
        self.grad_weight = (self.weight if ow is md.weight else
                            torch.from_numpy(np.asarray(ow, np.float32))
                            .to(dev))
        self.row_mask = torch.ones(self.num_data, dtype=torch.float32,
                                   device=dev)

    def _setup_compact_state(self, train_set: BinnedDataset) -> None:
        """The packed row records (ops/compact.py), with the current train
        scores. Extras carried through every partition: [scores (K), class
        gradients and hessians (2K, when K > 1), label, weight?, original
        row id]. The weight column is the objective's (MAPE's holds its
        label weight, reference: boosting/gbdt.py:1375, :1471): the compact
        step's gradients and its leaf renewal read it."""
        dev = self.device
        n = self.num_data
        k = self.num_class
        md = train_set.metadata
        obj_w = self.objective.weight
        has_w = obj_w is not None
        gcols = 2 * k if k > 1 else 0
        e = k + gcols + 2 + (1 if has_w else 0)
        # 4-bit packed bin columns where every stored column (a bundle
        # column under EFB) and the histogram width fit a nibble (reference:
        # boosting/gbdt.py:1384-1411)
        pack4 = False
        if bool(self.config.get("tpu_bin_pack4", False)):
            nb = self.num_bins_arr.cpu().numpy()
            hist_bins = int(self.grower_params.num_bins)
            pack4 = pack4_train_eligible(nb, hist_bins)
            if not pack4:
                log.warning(
                    "tpu_bin_pack4=true: training keeps u8 bin columns; "
                    "nibble packing needs every stored column to realize "
                    f"<= 16 bins and max_bin <= 15 (histogram width "
                    f"{hist_bins}, widest column {int(nb.max())})")
        self.grower_params = self.grower_params._replace(bin_pack4=pack4)
        self.layout = RowLayout(num_features=int(train_set.binned.shape[1]),
                                num_extra=e, packed4=pack4)
        self._cx_grads = k if k > 1 else None
        self._cx_label = k + gcols
        self._cx_weight = k + gcols + 1 if has_w else None
        self._cx_rowid = e - 1
        binned = torch.from_numpy(np.ascontiguousarray(
            train_set.binned)).to(dev)
        parts = [*self.train_score]
        if gcols:
            parts.append(torch.zeros((gcols, n), dtype=torch.float32,
                                     device=dev))
        parts.append(
            torch.from_numpy(np.asarray(md.label, np.float32)).to(dev))
        if has_w:
            parts.append(torch.from_numpy(
                np.asarray(obj_w, np.float32)).to(dev))
        parts.append(torch.arange(n, dtype=torch.float32, device=dev))
        zeros = torch.zeros(n, dtype=torch.float32, device=dev)
        self.work = pack_rows(binned, zeros, zeros, zeros + 1.0,
                              torch.cat([p.reshape(-1, n) for p in parts]),
                              self.layout)
        self.scratch = torch.zeros_like(self.work)
        del binned
        self._compact_ready = True

    def _col(self, i: int) -> torch.Tensor:
        """Carried extra column ``i`` in the current row order."""
        off = self.layout.extra_off + 4 * i
        return _u8_to_f32(self.work[:, off:off + 4])

    def _bag_col(self) -> torch.Tensor:
        """The records' sample-weight (in-bag) column, current row order."""
        off = self.layout.cnt_off
        return _u8_to_f32(self.work[:, off:off + 4])

    def _score_cols(self) -> torch.Tensor:
        """The K carried score columns ``[K, N]`` in the current row
        order."""
        k = self.num_class
        off = self.layout.extra_off
        raw = self.work[:, off:off + 4 * k]
        return _u8_to_f32(raw.reshape(-1, k, 4)).T.contiguous()

    # -- one boosting iteration ----------------------------------------------
    def _boost_from_average(self) -> None:
        """(reference: GBDT::BoostFromAverage, gbdt.cpp:319)"""
        if self.num_total_trees == 0 and not self._has_init_score \
                and self.objective is not None \
                and bool(self.config.get("boost_from_average", True)):
            for k in range(self.num_class):
                init = self.objective.boost_from_score(k)
                if abs(init) > 1e-10:
                    self._init_scores[k] = init
                    self.train_score[k] += init
                    for vs in self.valid_sets:
                        vs.score[k] += init
                    log.info(f"Start training from score {init:.6f}")

    def _gradients(self, score: torch.Tensor, label, weight):
        """``[K, N]`` gradients and hessians of the ``[K, N]`` scores; a
        row-coupled objective takes scores in the dataset's row order and
        uses its own label and weight."""
        if not self.objective.row_elementwise:
            g, h = self.objective.get_gradients(score[0])
            return g[None], h[None]
        if self.num_class > 1:
            return self.objective.get_gradients(score, label, weight)
        g, h = self.objective.get_gradients(score[0], label, weight)
        return g[None], h[None]

    def _feature_mask(self) -> torch.Tensor:
        """The iteration's features (reference: ``_feature_mask``,
        ``boosting/gbdt.py:2253-2262``, after ColSampler): with
        ``feature_fraction`` < 1, ``ceil(fraction * used)`` of the usable
        features, drawn without replacement by the run's RandomState."""
        if self.feature_fraction >= 1.0:
            return self.feat_mask
        used = np.where(self._base_feat_mask)[0]
        keep = max(1, int(np.ceil(len(used) * self.feature_fraction)))
        chosen = self._feat_rng.choice(used, size=keep, replace=False)
        mask = np.zeros_like(self._base_feat_mask)
        mask[chosen] = True
        return torch.from_numpy(mask).to(self.device)

    def _bynode_uniforms(self, tree_index: int) -> Optional[torch.Tensor]:
        """The ``[2L-1, F]`` by-node draws of tree ``tree_index`` (the JAX
        package's ``fold_in(bynode_key, num_total_trees)``), or None
        without by-node sampling."""
        gp = self.grower_params
        if gp.bynode_fraction >= 1.0:
            return None
        rows, f = 2 * gp.num_leaves - 1, int(self.feat_mask.shape[0])
        if self.bynode_draws is not None:
            return self.bynode_draws(tree_index, rows, f).to(
                self.device, torch.float32)
        if self._bynode_gen is None:
            self._bynode_gen = torch.Generator(device=self.device)
        # within 32 bits: the CPU generator keeps only the low 32 of a seed
        self._bynode_gen.manual_seed(
            (self._bynode_seed * 1_000_003 + tree_index) & 0xFFFF_FFFF)
        return torch.rand((rows, f), generator=self._bynode_gen,
                          device=self.device)

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration, K trees; True when no further split was
        possible (reference: GBDT::TrainOneIter, gbdt.cpp:375).
        ``gradients``/``hessians``: ``[K, N]`` (or flat) caller-supplied
        values in the dataset's row order, from a custom objective."""
        k_total = self.num_class
        external = gradients is not None or hessians is not None
        if external:
            if gradients is None or hessians is None:
                raise ValueError("pass both gradients and hessians")
            if self.use_compact:
                self._leave_compact()
        elif self.objective is None:
            raise ValueError("a custom objective supplies the gradients: "
                             "call update(fobj=...)")
        else:
            self._boost_from_average()
        if self.use_compact:
            begin = self._begin_compact_iter()
        else:
            begin = self._begin_masked_iter(gradients, hessians)
        feat_mask = self._feature_mask()
        first_iter = self.num_total_trees < k_total
        shrink = self.shrinkage_rate
        hosts = []
        for k in range(k_total):
            bynode_u = self._bynode_uniforms(len(self.models) + k)
            opts = self._tree_options(len(self.models) + k,
                                      int(self.feat_mask.shape[0]))
            if self.use_compact:
                tree, row_leaf = self._grow_compact(k, begin, feat_mask,
                                                    bynode_u, opts)
            else:
                tree, row_leaf = self._grow_masked(k, begin, feat_mask,
                                                   bynode_u, opts)
            self._note_used_features(tree)
            # a no-split tree contributes nothing (reference: gbdt.cpp:433)
            lv = torch.where(tree.num_nodes > 0, tree.leaf_value,
                             torch.zeros_like(tree.leaf_value)) * shrink
            tree = tree._replace(leaf_value=lv,
                                 internal_value=tree.internal_value * shrink)
            host = HostTree.from_device(tree, shrink)
            if self._linear:
                self._linear_tree_iter(host, row_leaf, begin, k)
            else:
                self.train_score[k] += lv[row_leaf]
                self._update_valid_scores(tree, host.max_depth, k)
            if first_iter and abs(self._init_scores[k]) > 1e-10:
                host.leaf_value = host.leaf_value + np.float32(
                    self._init_scores[k])
                if host.is_linear:
                    add_bias_linear(host, self._init_scores[k])
            hosts.append(host)
        self.iter_ += 1
        self.models.extend(hosts)
        if all(host.num_nodes == 0 for host in hosts):
            # (reference: gbdt.cpp:440-450) a no-split iteration's trees are
            # popped unless they are the very first, which stay constant
            if len(self.models) > k_total:
                del self.models[-k_total:]
            self.iter_ -= 1
            log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            return True
        return False

    def _linear_tree_iter(self, host: HostTree, row_leaf: torch.Tensor,
                          it: dict, k: int) -> None:
        """Fit tree ``k``'s linear leaves on the host and add their outputs
        to the train and validation scores (reference:
        ``_linear_tree_iter``, ``lightgbm_tpu/boosting/gbdt.py:2413-2450``):
        the tree's row leaves and in-bag true gradients come to the host in
        one copy (the masked grower: the dataset's row order)."""
        if host.num_nodes == 0:
            host.num_leaves = 1
        mask = it["mask"]
        blob = torch.stack([row_leaf.to(torch.float32),
                            it["true_g"][k] * mask,
                            it["true_h"][k] * mask]).cpu().numpy()
        leaf_np = blob[0].astype(np.int64)
        raw = self.train_set.raw_data
        t0 = time.perf_counter()
        fit_linear_leaves(host, raw, leaf_np, blob[1], blob[2],
                          self.feature_is_categorical(),
                          float(self.config.get("linear_lambda", 0.0)),
                          shrinkage=self.shrinkage_rate)
        self.linear_fit_s += time.perf_counter() - t0
        self.train_score[k] += torch.from_numpy(linear_leaf_outputs(
            host, raw, leaf_np).astype(np.float32)).to(self.device)
        self.apply_tree_to_scores(host, k, 1.0, train=False)

    def _leave_compact(self) -> None:
        """Caller-supplied gradients come in the dataset's row order: move a
        run that has grown no compact tree to the masked grower (reference:
        ``boosting/gbdt.py:2270-2278``)."""
        if self._compact_ready:
            raise RuntimeError(
                "cannot switch to caller-supplied gradients after compact "
                "training started; set tpu_grower=masked")
        if self._efb is not None:
            raise ValueError(
                "caller-supplied gradients need the masked grower, which "
                "does not take EFB-bundled data; construct the Dataset "
                "with enable_bundle=false")
        log.info("caller-supplied gradients: using the masked grower")
        self.use_compact = False
        self._setup_quant()
        self._setup_masked_state(self.train_set)

    def _begin_masked_iter(self, gradients, hessians) -> dict:
        """The masked iteration's gradients (the objective's, or the
        caller's), in-bag mask and GOSS amplification, and the quantized
        gradients (reference: ``boosting/gbdt.py:2294-2318``)."""
        k, n = self.num_class, self.num_data
        if gradients is None:
            g, h = self._gradients(self.train_score, self.label,
                                   self.grad_weight)
        else:
            g, h = (torch.as_tensor(np.asarray(a, np.float32).reshape(k, n))
                    .to(self.device) for a in (gradients, hessians))
        strat = self.sample_strategy
        mask = strat.bag_mask(self.iter_, g, h)
        g, h = strat.scale_grad_hess(mask, g, h)
        if mask is None:
            mask = self.row_mask
        true_g, true_h = g, h
        if self._use_quant:
            # one scale over all K classes (reference: boosting/gbdt.py:
            # 2311-2318)
            g, h = _quantize_gradients(g, h, *self._quant_args())
        return {"g": g, "h": h, "true_g": true_g, "true_h": true_h,
                "mask": mask}

    def _grow_masked(self, k: int, it: dict, feat_mask, bynode_u, opts):
        """Tree ``k`` of an iteration on the masked grower: ``(tree,
        row_leaf)`` with the rows in the dataset's order."""
        mask = it["mask"]
        tree, row_leaf = grow_tree(
            self.binned, it["g"][k] * mask, it["h"][k] * mask, mask,
            self.num_bins_arr, self.nan_bin_arr, self.has_nan_arr, feat_mask,
            self.grower_params, self.binned_t, self.is_cat_arr, bynode_u,
            opts, self._forced)
        if self._quant_renew:
            # in-bag true gradient sums a leaf, by each row's leaf
            L = tree.leaf_value.shape[0]
            sums = torch.zeros((2, L), dtype=torch.float32,
                               device=self.device)
            sums.index_add_(1, row_leaf, torch.stack(
                [it["true_g"][k] * mask, it["true_h"][k] * mask]))
            tree = self._renewed(tree, sums[0], sums[1])
        if self.objective is not None and self.objective.renew_leaves:
            w = mask if self.weight is None else mask * self.weight
            tree = self._renew_quantile(
                tree, self.objective._target(self.label)
                - self.train_score[k], w, row_leaf)
        return tree, row_leaf

    def _begin_compact_iter(self) -> dict:
        """The compact iteration's gradients in the records' current order,
        and its in-bag weights: ``bag`` None when it samples no rows, else
        the iteration's bag (times GOSS's amplification), which its first
        tree writes when ``fresh`` (reference:
        ``_train_one_iter_compact``, ``boosting/gbdt.py:1935-1998``)."""
        if not self._compact_ready:
            self._setup_compact_state(self.train_set)
        quant_scales = None
        if self._ext_grads:
            # the gradients of a row-coupled objective in the dataset's row
            # order: the score column scattered back by the carried row id,
            # the gradients gathered into the current order (reference:
            # _rank_grads_fn, boosting/gbdt.py:1512-1540)
            rid = self._col(self._cx_rowid).to(torch.int64)
            s_orig = torch.empty_like(self.train_score[0])
            s_orig[rid] = self.train_score[0]
            g, h = self.objective.get_gradients(s_orig)
            g, h = g[rid][None], h[rid][None]
        else:
            label = self._col(self._cx_label)
            weight = (self._col(self._cx_weight)
                      if self._cx_weight is not None else None)
            g, h = self._gradients(self.train_score, label, weight)
        strat = self.sample_strategy
        # GOSS ranks the rows by their gradients in the current order
        mask = strat.bag_mask(self.iter_, g, h)
        if mask is not None and strat.amplify is not None:
            mask = mask * strat.amplify
        if not self._ext_grads:
            if self._quant_int:
                # the records carry the codes (exact small integers in the
                # f32 lanes); the scales go to the scan
                g, h, g_s, h_s = _discretize_gradients(
                    g, h, *self._quant_args())
                quant_scales = (g_s, h_s)
            elif self._use_quant:
                g, h = _quantize_gradients(g, h, *self._quant_args())
        return {"g": g, "h": h, "quant_scales": quant_scales,
                "bag": mask, "fresh": strat.last_fresh}

    def _grow_compact(self, k: int, it: dict, feat_mask, bynode_u, opts):
        """Tree ``k`` of an iteration on the compact grower: ``(tree,
        row_leaf)`` with the rows in the post-tree record order, where
        ``train_score`` then lies too."""
        lay = self.layout
        k_total = self.num_class
        extra = [self.train_score]
        if k == 0:
            g_k, h_k = it["g"][0], it["h"][0]
            if k_total > 1:
                # every class's gradients from the iteration-start scores,
                # carried through this iteration's later partitions
                extra += [it["g"], it["h"]]
        else:
            g_k = self._col(self._cx_grads + k)
            h_k = self._col(self._cx_grads + k_total + k)
        # the in-bag weight w: none sampled (the stored column is all ones
        # then); a fresh bag by position in the current order at the
        # iteration's first tree; else the stored column, which rode the
        # partitions (a reused bag, the later trees of an iteration)
        if it["bag"] is None:
            w = None
        elif k == 0 and it["fresh"]:
            w = it["bag"]
        else:
            w = self._bag_col()
        if w is None:
            cols = [g_k, h_k, torch.ones_like(g_k)]
        else:
            cols = [g_k * w, h_k * w, w]
        # grad, hess, in-bag weight and the K score columns (at k = 0 the
        # class gradients after them) are contiguous: one copy
        cols = torch.cat([torch.stack(cols)] + extra)   # [R, N] -> [N, 4R]
        self.work[:, lay.grad_off:lay.grad_off + 4 * cols.shape[0]] = \
            cols.T.reshape(-1).view(torch.uint8).reshape(self.num_data, -1)

        (tree, row_leaf, self.work, self.scratch, leaf_start,
         leaf_nrows) = grow_tree_compact(
            self.work, self.scratch, self.num_bins_arr, self.nan_bin_arr,
            self.has_nan_arr, feat_mask, lay, self.grower_params,
            self.num_data, self.is_cat_arr, self._efb, it["quant_scales"],
            bynode_u, opts, self.tree_stats)
        # the score columns moved with the rows
        self.train_score = self._score_cols()
        if self.objective.renew_leaves:
            # the carried label, weight, in-bag and pre-tree score columns,
            # in the post-tree order (K == 1 here)
            w = (self._bag_col() != 0).to(torch.float32)
            if self._cx_weight is not None:
                w = w * self._col(self._cx_weight)
            tree = self._renew_quantile(
                tree, self.objective._target(self._col(self._cx_label))
                - self.train_score[k], w, row_leaf)
        if self._quant_renew:
            # in-bag true gradients from the carried label, weight, in-bag
            # and (pre-tree) score columns, summed a leaf segment by
            # prefix-sum differences (K == 1 here; reference:
            # boosting/gbdt.py:1802-1823)
            n = self.num_data
            weight = (self._col(self._cx_weight)
                      if self._cx_weight is not None else None)
            tg, th = self._gradients(self.train_score,
                                     self._col(self._cx_label), weight)
            cs = torch.cumsum(torch.cat([tg, th]) * self._bag_col(), dim=1)
            cs = torch.cat([torch.zeros_like(cs[:, :1]), cs], dim=1)
            ends = torch.clamp(leaf_start + leaf_nrows, max=n)
            starts = torch.clamp(leaf_start, max=n)
            sums = cs[:, ends] - cs[:, starts]
            tree = self._renewed(tree, sums[0], sums[1])
        return tree, row_leaf

    def _routed_leaves(self, tree, binned: torch.Tensor, depth: int,
                       packed: bool = False) -> torch.Tensor:
        """Each row's leaf in one tree (a ``TreeArrays`` on the device), for
        rows of the training data's column space (bundle space when EFB
        bundled; reference: ``_route_args``, ``boosting/gbdt.py:
        2247-2251``); ``packed``: the bins are nibble-packed."""
        sf = tree.split_feature
        cat, nan_arr = {}, self.nan_bin_arr
        if self._efb is not None:
            # a node on original feature j reads column col_of[j], by its
            # bitset where j is bundled
            safe = torch.clamp(sf, min=0)
            sf = torch.where(sf >= 0, self._route_col[safe], sf)
            cat = dict(is_cat=self._route_cat[safe][None],
                       cat_bitset=tree.cat_bitset[None])
            nan_arr = self._route_nan
        elif self.is_cat_arr is not None:
            cat = dict(is_cat=self.is_cat_arr[
                torch.clamp(sf, min=0)][None],
                cat_bitset=tree.cat_bitset[None])
        one = StackedTrees(
            split_feature=sf[None],
            split_bin=tree.split_bin[None],
            default_left=tree.default_left[None],
            left_child=tree.left_child[None],
            right_child=tree.right_child[None],
            leaf_value=tree.leaf_value[None],
            num_nodes=tree.num_nodes.reshape(1), **cat)
        return predict_leaf_batched(binned, one, nan_arr, depth,
                                    packed=packed)[0]

    def _update_valid_scores(self, tree: TreeArrays, depth: int,
                             k: int) -> None:
        for vs in self.valid_sets:
            vs.score[k] += tree.leaf_value[
                self._routed_leaves(tree, vs.binned, depth)]

    def _routing_binned(self) -> torch.Tensor:
        """The training rows' bins in the order of ``train_score`` (the
        compact grower's records are permuted; reference:
        ``_routing_binned``, ``boosting/gbdt.py:2734-2741``), nibble-packed
        where ``_routing_packed``."""
        if self.use_compact and self._compact_ready:
            return self.work[:, :self.layout.feat_cols]
        return self.binned

    def _routing_packed(self) -> bool:
        """Whether ``_routing_binned`` holds two features a byte."""
        return self.use_compact and self._compact_ready \
            and self.layout.packed4

    def host_tree_arrays(self, host: HostTree) -> TreeArrays:
        """A host tree's routing arrays on the device in one upload (every
        int, the bitsets' int32 bit patterns too, is exact in float64), its
        leaf values in float64 (``apply_tree_to_scores`` scales them; the
        fields routing does not read are None)."""
        bits = np.ascontiguousarray(host.cat_bitset).view(np.int32)
        parts = [np.asarray(a, np.float64).reshape(-1) for a in (
            host.split_feature, host.split_bin, bits, host.default_left,
            host.left_child, host.right_child, host.leaf_value,
            [host.num_nodes])]
        blob = torch.from_numpy(np.concatenate(parts)).to(self.device)
        sf, sb, cb, dl, lc, rc, lv, nn = torch.split(
            blob, [len(a) for a in parts])
        return TreeArrays(
            split_feature=sf.to(torch.int64), split_bin=sb.to(torch.int64),
            cat_bitset=cb.to(torch.int32).reshape(bits.shape),
            split_gain=None, default_left=dl.to(torch.bool),
            left_child=lc.to(torch.int64), right_child=rc.to(torch.int64),
            leaf_value=lv,
            leaf_weight=None, leaf_count=None, leaf_parent=None,
            leaf_depth=None, internal_value=None, internal_weight=None,
            internal_count=None, num_leaves=None,
            num_nodes=nn.reshape(()).to(torch.int64))

    def apply_tree_to_scores(self, host: HostTree, k: int, factor: float,
                             train: bool = True, valid: bool = True,
                             tree: Optional[TreeArrays] = None) -> None:
        """Add ``factor`` times a tree's output to the train scores, the
        validation scores or both, of class ``k``, routing on the device
        (reference: ``apply_tree_to_scores``, ``boosting/gbdt.py:
        2541-2588``); a linear tree's outputs come from the raw rows on the
        host, as they were added. ``tree`` is ``host_tree_arrays(host)``
        where a caller routes one tree more than once (DART), so that it
        is uploaded once."""
        if tree is None:
            tree = self.host_tree_arrays(host)
        # the host's float32 product leaf_value * float32(factor): the
        # float64 product of a float32 leaf and factor is exact
        tree = tree._replace(leaf_value=(
            tree.leaf_value * float(np.float32(factor))).to(torch.float32))
        depth = host.max_depth
        if host.is_linear:
            def add(score, binned, raw):
                leaf = self._routed_leaves(tree, binned, depth).cpu().numpy()
                score += torch.from_numpy((linear_leaf_outputs(
                    host, raw, leaf) * factor).astype(np.float32)).to(
                        self.device)
            if train:
                add(self.train_score[k], self._routing_binned(),
                    self.train_set.raw_data)
            for vs in self.valid_sets if valid else ():
                add(vs.score[k], vs.binned, vs.dataset.raw_data)
            return
        if train:
            self.train_score[k] += tree.leaf_value[self._routed_leaves(
                tree, self._routing_binned(), depth, self._routing_packed())]
        if valid:
            self._update_valid_scores(tree, depth, k)

    def rollback_one_iter(self) -> None:
        """Remove the last iteration's trees and their output from the
        scores (reference: GBDT::RollbackOneIter, gbdt.cpp:454)."""
        if self.iter_ <= 0:
            return
        k = self.num_class
        for c in range(k):
            self.apply_tree_to_scores(self.models[len(self.models) - k + c],
                                      c, -1.0)
        del self.models[len(self.models) - k:]
        self.iter_ -= 1

    def reset_config(self, config) -> None:
        """Take the learning rate, the tree's size and regularization and
        ``feature_fraction`` from ``config`` for the next trees (reference:
        the JAX Booster's ``reset_parameter``, ``basic.py:649-721``); the
        growers rebuild their per-tree buffers from ``grower_params`` at
        every tree."""
        self.config = config
        self.learning_rate = float(config.learning_rate)
        self.shrinkage_rate = self.learning_rate
        self.feature_fraction = float(config.feature_fraction)
        self.grower_params = self.grower_params._replace(
            num_leaves=int(config.num_leaves),
            max_depth=int(config.max_depth),
            lambda_l1=float(config.lambda_l1),
            lambda_l2=float(config.lambda_l2),
            min_data_in_leaf=float(config.min_data_in_leaf),
            min_sum_hessian_in_leaf=float(config.min_sum_hessian_in_leaf),
            min_gain_to_split=float(config.min_gain_to_split),
            max_delta_step=float(config.max_delta_step))

    def add_init_scores(self, raw: np.ndarray) -> None:
        """Add a loaded model's ``[K, N]`` raw predictions of the training
        rows to the train scores before the first tree, and turn
        boost-from-average off (reference: ``_attach_pre_model``,
        ``basic.py:504-518``)."""
        if self.num_total_trees or (self.use_compact and self._compact_ready):
            raise RuntimeError("a model's scores seed a run before its "
                               "first tree")
        k, n = raw.shape
        if k != self.num_class:
            raise ValueError(f"init_model has {k} trees an iteration, the "
                             f"training configuration {self.num_class}")
        self.train_score[:, :n] += torch.from_numpy(
            np.asarray(raw, np.float32)).to(self.device)
        self._has_init_score = True

    @property
    def num_total_trees(self) -> int:
        return len(self.models)

    def current_iteration(self) -> int:
        return self.iter_

    def num_features(self) -> int:
        return len(self.mappers)

    def feature_importance(self, importance_type: str = "split"
                           ) -> np.ndarray:
        """Splits per feature over all trees, or with ``importance_type=
        "gain"`` their summed gains (reference: GBDT::FeatureImportance)."""
        if importance_type not in ("split", "gain"):
            raise ValueError(f"importance_type={importance_type!r}: "
                             "'split' or 'gain'")
        out = np.zeros(len(self.mappers), np.float64)
        for m in self.models:
            np.add.at(out, m.split_feature[:m.num_nodes],
                      1.0 if importance_type == "split"
                      else m.split_gain[:m.num_nodes].astype(np.float64))
        return out

    # -- validation and metrics ----------------------------------------------
    def add_valid(self, valid_set: BinnedDataset, name: str,
                  metrics: Sequence[Metric]) -> None:
        if valid_set.mappers is not self.mappers:
            raise ValueError(f"validation set '{name}' must be binned with "
                             "the training set's mappers")
        # the valid matrix must be in the column space the trees route in
        # (reference: add_valid, boosting/gbdt.py:2001-2023)
        vb = valid_set.bundle_info
        if self._efb is not None:
            if vb is None or valid_set.binned.shape[1] \
                    != self.train_set.binned.shape[1]:
                raise ValueError(
                    f"validation set '{name}' is not in the training data's "
                    "EFB bundle layout (a feature conflict outside the "
                    "training rows?); rebuild both with enable_bundle=false")
        elif vb is not None:
            _unbundle(valid_set, f"validation set '{name}': unbundling to "
                      "match the unbundled training layout")
        if self._linear and valid_set.raw_data is None:
            raise ValueError(
                "linear_tree validation sets need raw data; create them "
                "from the training Dataset (create_valid) with "
                "free_raw_data=False or the linear_tree param set")
        vs = _ValidSet(valid_set, name, self.num_class, self.device)
        if self.models:
            vs.score += torch.from_numpy(
                self.predict_raw_matrix(valid_set.raw_data) if self._linear
                else self.predict_raw_binned(_dense_bins(valid_set))).to(
                    self.device)
        for m in metrics:
            m.init(valid_set.metadata, valid_set.num_data)
        vs.metrics = list(metrics)
        self.valid_sets.append(vs)

    def set_train_metrics(self, metrics: Sequence[Metric]) -> None:
        for m in metrics:
            m.init(self.train_set.metadata, self._n_real)
        self.train_metrics = list(metrics)

    def train_score_original_order(self) -> np.ndarray:
        """Train raw scores [K, N] in the dataset's row order."""
        if not (self.use_compact and self._compact_ready):
            return self.train_score.cpu().numpy()
        perm = self._col(self._cx_rowid).to(torch.int64)
        out = torch.empty_like(self.train_score)
        out[:, perm] = self.train_score
        return out.cpu().numpy()

    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        if not self.train_metrics:
            return []
        return self._eval("training", self.train_score_original_order(),
                          self.train_metrics)

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        out = []
        for vs in self.valid_sets:
            out.extend(self._eval(vs.name, vs.score.cpu().numpy(),
                                  vs.metrics))
        return out

    def _eval(self, name, raw, metrics):
        """Metrics of ``[K, N]`` raw scores (``[N]`` when K = 1)."""
        if self.num_class == 1:
            raw = raw[0]
        convert = (self.objective.convert_output
                   if self.objective is not None else None)
        out = []
        for m in metrics:
            if hasattr(m, "eval_all"):
                # one value an eval_at position, named ndcg@k (reference:
                # boosting/gbdt.py:2774-2776)
                out.extend((name, f"{m.name}@{k}", v, m.higher_better)
                           for k, v in zip(m.eval_at, m.eval_all(raw)))
            else:
                out.append((name, m.name, m.eval(raw, convert),
                            m.higher_better))
        return out

    # -- prediction ----------------------------------------------------------
    def _model_window(self, num_iteration: Optional[int],
                      start_iteration: int) -> List[HostTree]:
        k = self.num_class
        models = self.models[max(start_iteration, 0) * k:]
        if num_iteration is not None and num_iteration > 0:
            models = models[:num_iteration * k]
        return models

    def bin_matrix(self, arr: np.ndarray) -> np.ndarray:
        """Bin raw feature rows with the training mappers (host side)."""
        from ..io.binning import bin_columns
        arr = np.asarray(arr)
        if arr.dtype != np.float32:
            arr = arr.astype(np.float64, copy=False)
        if arr.ndim == 1:
            arr = arr.reshape(1, -1)
        if arr.shape[1] != len(self.mappers):
            raise ValueError(f"input has {arr.shape[1]} features, model "
                             f"expects {len(self.mappers)}")
        return bin_columns(self.mappers, arr, self._bin_dtype)

    def _average_divisor(self, models: Sequence[HostTree]) -> int:
        """The iterations in a prediction window, by which a model with
        ``average_output`` divides its sum (reference: ``_average_divisor``,
        ``boosting/gbdt.py:3183-3193``)."""
        return max(len(models) // max(self.num_class, 1), 1)

    def _stacked_window(self, num_iteration: Optional[int],
                        start_iteration: int):
        """``(models, trees, depth)``: the window's host trees, stacked on
        the device, and their deepest leaf (``trees`` None and ``depth`` 0
        for an empty window)."""
        models = self._model_window(num_iteration, start_iteration)
        if not models:
            return models, None, 0
        trees = stack_trees(models, self.device,
                            self.feature_is_categorical())
        return models, trees, max(m.max_depth for m in models)

    def _pred_bins(self, binned: np.ndarray) -> torch.Tensor:
        """Binned rows on the device, nibble-packed on the host first with
        ``tpu_bin_pack4`` (reference: ``_pad_request_to_bucket``,
        ``boosting/gbdt.py:3065-3077``): half the bytes uploaded and held."""
        if self._pred_pack4:
            binned = pack4_matrix(binned.astype(np.uint8, copy=False))
        return bins_to_device(binned, self.device)

    def predict_raw_binned(self, binned: np.ndarray,
                           num_iteration: Optional[int] = None,
                           start_iteration: int = 0,
                           early_stop=None) -> np.ndarray:
        """Raw scores [K, N] for already-binned rows. ``early_stop`` is an
        optional ``(margin, freq)`` pair (reference:
        ``lightgbm_tpu/boosting/gbdt.py:3195-3232``): a model with
        ``average_output`` checks the margin on its sums before dividing,
        as the reference does."""
        models, trees, depth = self._stacked_window(num_iteration,
                                                    start_iteration)
        if not models:
            return np.zeros((self.num_class, binned.shape[0]), np.float32)
        margin, freq = early_stop if early_stop else (0.0, 0)
        b = self._pred_bins(binned)
        raw = predict_raw_batched(
            b, trees, self._pred_nan_arr, depth, num_class=self.num_class,
            early_stop_margin=float(margin), early_stop_freq=int(freq),
            packed=self._pred_pack4).cpu().numpy()
        if self.average_output:
            raw = raw / self._average_divisor(models)
        return raw

    def predict_raw_matrix(self, arr: np.ndarray,
                           num_iteration: Optional[int] = None,
                           start_iteration: int = 0,
                           early_stop=None) -> np.ndarray:
        if not self._linear:
            return self.predict_raw_binned(self.bin_matrix(arr),
                                           num_iteration, start_iteration,
                                           early_stop)
        # linear leaves: each row's leaf by the walk, then leaf_const +
        # x . coeff on its raw values (reference: boosting/gbdt.py:3529-3549)
        if early_stop is not None:
            log.warning("pred_early_stop is ignored with linear_tree models")
        arr = np.asarray(arr, np.float64)
        if arr.ndim == 1:
            arr = arr.reshape(1, -1)
        models = self._model_window(num_iteration, start_iteration)
        k = self.num_class
        out = np.zeros((k, arr.shape[0]), np.float64)
        if not models:
            return out.astype(np.float32)
        leaves = self.predict_leaf_matrix(arr, num_iteration,
                                          start_iteration)
        for i, m in enumerate(models):
            out[i % k] += linear_leaf_outputs(m, arr, leaves[:, i])
        return out.astype(np.float32)

    def predict_leaf_matrix(self, arr: np.ndarray,
                            num_iteration: Optional[int] = None,
                            start_iteration: int = 0) -> np.ndarray:
        """Leaf indices ``[N, T]`` int32 of the window's trees, by the
        depth-batched walk (reference: ``lightgbm_tpu/boosting/gbdt.py:
        3552-3589``)."""
        binned = self.bin_matrix(arr)
        models, trees, depth = self._stacked_window(num_iteration,
                                                    start_iteration)
        if not models:
            return np.zeros((binned.shape[0], 0), np.int32)
        leaves = predict_leaf_batched(self._pred_bins(binned), trees,
                                      self._pred_nan_arr, depth,
                                      packed=self._pred_pack4)
        return leaves.to(torch.int32).T.cpu().numpy()

    def predict_contrib_matrix(self, arr: np.ndarray,
                               num_iteration: Optional[int] = None,
                               start_iteration: int = 0) -> np.ndarray:
        """Exact TreeSHAP contributions ``[N, K*(F+1)]`` float64, each
        class's bias last (reference: ``_predict_contrib``,
        ``lightgbm_tpu/basic.py:1225-1276``): rows binned with the training
        mappers and routed per original feature (under EFB too), the
        window's paths built once on the host, then the TreeSHAP op on the
        device (``ops/treeshap_device.py``; the kernel on a card). Linear
        trees attribute their constant leaf values, as the reference does;
        a model with ``average_output`` is not divided, as there."""
        from ..ops.treeshap_device import build_shap_paths, tree_shap
        binned = self.bin_matrix(arr)
        n, f = binned.shape
        k = self.num_class
        models = self._model_window(num_iteration, start_iteration)
        if not models:
            return np.zeros((n, k * (f + 1)), np.float64)
        paths = build_shap_paths(models, self._pred_nan_arr.cpu().numpy(),
                                 self.feature_is_categorical(), self.device)
        b = bins_to_device(binned, self.device)
        return tree_shap(b, paths, k).reshape(n, k * (f + 1)).cpu().numpy()
