"""TreeSHAP feature contributions.

Reference: Tree::PredictContrib / TreeSHAP recursion in src/io/tree.cpp
(Lundberg & Lee Algorithm 2 over internal_value/weight/count fields), exposed
through LGBM_BoosterPredict* with C_API_PREDICT_CONTRIB.

Host-side numpy implementation (prediction-time tooling, not a training hot
path).  Copy of lightgbm_tpu/models/shap.py (numpy only), so both packages
give the same contributions for the same trees.
"""

from __future__ import annotations

from typing import List

import numpy as np


class _PathElement:
    __slots__ = ("feature_index", "zero_fraction", "one_fraction", "pweight")

    def __init__(self, feature_index=-1, zero_fraction=0.0, one_fraction=0.0, pweight=0.0):
        self.feature_index = feature_index
        self.zero_fraction = zero_fraction
        self.one_fraction = one_fraction
        self.pweight = pweight


def _extend_path(path: List[_PathElement], unique_depth, zero_fraction, one_fraction, feature_index):
    path.append(_PathElement(feature_index, zero_fraction, one_fraction,
                             1.0 if unique_depth == 0 else 0.0))
    for i in range(unique_depth - 1, -1, -1):
        path[i + 1].pweight += one_fraction * path[i].pweight * (i + 1) / (unique_depth + 1)
        path[i].pweight = zero_fraction * path[i].pweight * (unique_depth - i) / (unique_depth + 1)


def _unwind_path(path: List[_PathElement], unique_depth, path_index):
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[unique_depth].pweight
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = path[i].pweight
            path[i].pweight = next_one_portion * (unique_depth + 1) / ((i + 1) * one_fraction)
            next_one_portion = tmp - path[i].pweight * zero_fraction * (unique_depth - i) / (unique_depth + 1)
        else:
            path[i].pweight = path[i].pweight * (unique_depth + 1) / (zero_fraction * (unique_depth - i))
    for i in range(path_index, unique_depth):
        path[i].feature_index = path[i + 1].feature_index
        path[i].zero_fraction = path[i + 1].zero_fraction
        path[i].one_fraction = path[i + 1].one_fraction
    path.pop()


def _unwound_path_sum(path: List[_PathElement], unique_depth, path_index):
    one_fraction = path[path_index].one_fraction
    zero_fraction = path[path_index].zero_fraction
    next_one_portion = path[unique_depth].pweight
    total = 0.0
    for i in range(unique_depth - 1, -1, -1):
        if one_fraction != 0:
            tmp = next_one_portion * (unique_depth + 1) / ((i + 1) * one_fraction)
            total += tmp
            next_one_portion = path[i].pweight - tmp * zero_fraction * ((unique_depth - i) / (unique_depth + 1))
        else:
            total += path[i].pweight / (zero_fraction * ((unique_depth - i) / (unique_depth + 1)))
    return total


def tree_shap_one(tree, x: np.ndarray, phi: np.ndarray) -> None:
    """SHAP contributions of one tree for one row, accumulated into phi
    (length n_features + 1; last slot = expected value/bias)."""
    if tree.num_leaves <= 1:
        phi[-1] += tree.leaf_value[0]
        return

    dl = tree.default_left()
    # node "cover" = internal_count, leaf cover = leaf_count
    def node_count(node):
        return tree.internal_count[node] if node >= 0 else tree.leaf_count[-node - 1]

    def node_value(node):
        return tree.internal_value[node] if node >= 0 else tree.leaf_value[-node - 1]

    phi[-1] += _expected_value(tree)

    is_cat = tree.is_categorical_node()
    missing_type = (tree.decision_type.astype(np.int32) >> 2) & 3

    def decision(node):
        """Same semantics as Tree.predict (incl. missing_type Zero routing)."""
        f = tree.split_feature[node]
        v = x[f]
        if is_cat[node]:
            left = tree.cat_decision_left(node, v)
        else:
            mt = missing_type[node]
            if np.isnan(v) and mt == 2:
                left = dl[node]
            elif mt == 1 and (np.isnan(v) or abs(v) <= 1e-35):
                left = dl[node]
            else:
                left = (0.0 if np.isnan(v) else v) <= tree.threshold[node]
        return tree.left_child[node] if left else tree.right_child[node]

    def recurse(node, path: List[_PathElement], parent_zero, parent_one, parent_idx):
        unique_depth = len(path)
        path = [
            _PathElement(p.feature_index, p.zero_fraction, p.one_fraction, p.pweight) for p in path
        ]
        _extend_path(path, unique_depth, parent_zero, parent_one, parent_idx)
        if node < 0:  # leaf
            leaf = -node - 1
            for i in range(1, unique_depth + 1):
                w = _unwound_path_sum(path, unique_depth, i)
                el = path[i]
                phi[el.feature_index] += w * (el.one_fraction - el.zero_fraction) * tree.leaf_value[leaf]
            return
        hot = decision(node)
        cold = tree.right_child[node] if hot == tree.left_child[node] else tree.left_child[node]
        hot_frac = node_count(hot) / max(node_count(node), 1)
        cold_frac = node_count(cold) / max(node_count(node), 1)
        incoming_zero, incoming_one = 1.0, 1.0
        path_index = -1
        f = tree.split_feature[node]
        for i in range(1, unique_depth + 1):
            if path[i].feature_index == f:
                path_index = i
                break
        if path_index >= 0:
            incoming_zero = path[path_index].zero_fraction
            incoming_one = path[path_index].one_fraction
            _unwind_path(path, unique_depth, path_index)
            unique_depth -= 1
        recurse(hot, path, hot_frac * incoming_zero, incoming_one, f)
        recurse(cold, path, cold_frac * incoming_zero, 0.0, f)

    recurse(0, [], 1.0, 1.0, -1)


def _expected_value(tree) -> float:
    """Weighted average of leaf values (the bias term)."""
    counts = tree.leaf_count[: tree.num_leaves].astype(np.float64)
    total = counts.sum()
    if total <= 0:
        return float(np.mean(tree.leaf_value[: tree.num_leaves]))
    return float(np.sum(tree.leaf_value[: tree.num_leaves] * counts) / total)


def tree_shap_ensemble(trees, X: np.ndarray, num_class: int = 1) -> np.ndarray:
    """Contributions (N, (F+1)) or (N, K*(F+1)) for multiclass, matching the
    reference's pred_contrib output layout."""
    n, f = X.shape
    if num_class <= 1:
        out = np.zeros((n, f + 1), dtype=np.float64)
        for t in trees:
            for i in range(n):
                tree_shap_one(t, X[i], out[i])
        return out
    out = np.zeros((n, num_class, f + 1), dtype=np.float64)
    for ti, t in enumerate(trees):
        c = ti % num_class
        for i in range(n):
            tree_shap_one(t, X[i], out[i, c])
    return out.reshape(n, num_class * (f + 1))
