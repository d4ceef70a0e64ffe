"""Random trees for the TreeSHAP tests, as the port's ``HostTree``s.

Leaf-wise growth from a seed: each split takes a leaf (any leaf, or, with
``chain``, always the newest, for one path as deep as the tree) and gives
it a feature from ``features`` (few features: they repeat along a path), a
bin threshold, a default direction and, on the features in ``cat``, a
random bin bitset. Leaf counts are random and each node's count is the sum
of its leaves'. Imports no JAX: ``tests/test_torch_cuda.py`` runs on a
machine without it.
"""
import numpy as np

from lightgbm_tpu_torch.boosting.gbdt import HostTree


def random_tree(rng, num_leaves, features, num_bins=16, chain=False,
                cat=(), words=1):
    nodes = num_leaves - 1
    left = np.zeros(max(nodes, 1), np.int32)
    right = np.zeros(max(nodes, 1), np.int32)
    # where each leaf hangs: (parent node, 0 left / 1 right), None at root
    hang = {0: None}
    for i in range(nodes):
        leaf = i if chain else int(rng.randint(i + 1))
        left[i], right[i] = ~leaf, ~(i + 1)
        if hang[leaf] is not None:
            p, side = hang[leaf]
            (left if side == 0 else right)[p] = i
        hang[leaf], hang[i + 1] = (i, 0), (i, 1)
    leaf_count = rng.randint(1, 50, num_leaves).astype(np.float32)
    internal_count = np.zeros(max(nodes, 1), np.float32)

    def count(nd):
        if nd < 0:
            return float(leaf_count[~nd])
        c = count(int(left[nd])) + count(int(right[nd]))
        internal_count[nd] = c
        return c
    if nodes:
        count(0)
    feats = np.asarray(features)[rng.randint(len(features), size=max(nodes,
                                                                     1))]
    bits = np.zeros((max(nodes, 1), words), np.uint32)
    for i in range(nodes):
        if int(feats[i]) in cat:
            bits[i] = rng.randint(0, 2 ** 32, size=words, dtype=np.uint64)
    leaf_value = (rng.randn(num_leaves) * 0.5).astype(np.float32)
    return HostTree({
        "split_feature": feats.astype(np.int32),
        "split_bin": rng.randint(0, num_bins, max(nodes, 1)).astype(np.int32),
        "default_left": rng.rand(max(nodes, 1)) < 0.5,
        "left_child": left, "right_child": right,
        "leaf_value": leaf_value, "leaf_count": leaf_count,
        "internal_count": internal_count, "cat_bitset": bits,
        "leaf_depth": np.zeros(num_leaves, np.int32),
        "num_leaves": num_leaves, "num_nodes": nodes})


def random_forest(seed, num_features=5, num_bins=16, cat=(), words=1):
    """A window of trees that covers the kernel's cases: constant trees, a
    path deeper than 32 steps, features repeating along paths, and
    categorical nodes when ``cat`` names features."""
    rng = np.random.RandomState(seed)
    feats = list(range(num_features))
    trees = [random_tree(rng, 1, feats, num_bins)]
    for leaves in (2, 7, 31, 15):
        trees.append(random_tree(rng, leaves, feats, num_bins, cat=cat,
                                 words=words))
    trees.append(random_tree(rng, 40, feats[:3], num_bins, chain=True,
                             cat=cat, words=words))
    trees.append(random_tree(rng, 1, feats, num_bins))
    trees.append(random_tree(rng, 63, feats, num_bins, cat=cat,
                             words=words))
    return trees


def random_rows(seed, n, num_features, num_bins):
    """Bin rows ``[n, F]`` that hit every bin, the NaN bin (the last)
    included: uint8, or uint16 past 256 bins."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, num_bins, size=(n, num_features)).astype(
        np.uint8 if num_bins <= 256 else np.uint16)
