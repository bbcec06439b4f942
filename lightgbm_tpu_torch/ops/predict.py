"""Tree-ensemble prediction on raw feature values.

Counterpart of lightgbm_tpu/ops/predict.py::predict_raw_values and
predict_raw_multiclass.  All rows of all trees advance one level per step through the
stacked structure-of-arrays trees; decisions are made in f32 against
thresholds rounded up to f32 (models/gbdt.py::_f32_threshold_upper), as in
the JAX package, and the per-tree values are summed in tree order.
"""

from __future__ import annotations

import torch

_K_ZERO = 1e-35  # reference: kZeroThreshold


def _per_tree_values(
    x: torch.Tensor,  # (N, F) raw features (NaN = missing)
    split_feature: torch.Tensor,  # (T, M) i32
    threshold: torch.Tensor,  # (T, M) f32 — `value <= threshold` -> left
    default_left: torch.Tensor,  # (T, M) bool
    missing_type: torch.Tensor,  # (T, M) i32: 0=None, 1=Zero, 2=NaN
    left_child: torch.Tensor,  # (T, M) i32, negative = ~leaf
    right_child: torch.Tensor,  # (T, M) i32
    num_leaves: torch.Tensor,  # (T,) i32
    leaf_value: torch.Tensor,  # (T, L) f32
) -> torch.Tensor:
    """(T, N) f32: each tree's leaf value for each row (reference:
    Tree::NumericalDecision semantics per node missing type: NaN ->
    default; Zero: NaN or |v| <= kZero -> default; None: NaN treated as
    0.0)."""
    x = x.to(torch.float32)
    n = x.shape[0]
    t, m = split_feature.shape
    miss_all = torch.isnan(x)
    vals = torch.where(miss_all, 0.0, x)
    tt = torch.arange(t, device=x.device)[:, None]  # (T, 1)
    rows = torch.arange(n, device=x.device)[None, :]  # (1, N)
    # single-leaf trees start at a leaf (~0)
    node = torch.where(num_leaves > 1, 0, -1).long()[:, None].expand(t, n)
    sf, lc, rc = split_feature.long(), left_child.long(), right_child.long()
    for _ in range(max(m, 1)):
        nd = node.clamp_min(0)
        f = sf[tt, nd]  # (T, N)
        v = vals[rows, f]
        miss = miss_all[rows, f]
        mt = missing_type[tt, nd]
        use_default = torch.where(
            mt == 2, miss, torch.where(mt == 1, miss | (v.abs() <= _K_ZERO),
                                       False))
        go_left = torch.where(use_default, default_left[tt, nd],
                              v <= threshold[tt, nd])
        node = torch.where(node >= 0,
                           torch.where(go_left, lc[tt, nd], rc[tt, nd]), node)
    return leaf_value[tt, -node - 1]


def _tree_sum(per_tree: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (tree) axis, one tree after another."""
    out = torch.zeros(per_tree.shape[1:], dtype=torch.float32,
                      device=per_tree.device)
    for i in range(per_tree.shape[0]):
        out = out + per_tree[i]
    return out


def predict_raw_values(x, split_feature, threshold, default_left,
                       missing_type, left_child, right_child, num_leaves,
                       leaf_value) -> torch.Tensor:
    """Raw ensemble margin per row: (N,) f32, the sum over trees of the
    leaf values, in tree order."""
    return _tree_sum(_per_tree_values(
        x, split_feature, threshold, default_left, missing_type, left_child,
        right_child, num_leaves, leaf_value))


def predict_raw_multiclass(x, split_feature, threshold, default_left,
                           missing_type, left_child, right_child, num_leaves,
                           leaf_value, *, k: int) -> torch.Tensor:
    """Multiclass raw margins, (N, k) f32.  Tree i belongs to class i % k
    (iteration-major, class-minor), and each class sums its own trees in
    iteration order, the JAX package's per-row order."""
    per_tree = _per_tree_values(
        x, split_feature, threshold, default_left, missing_type, left_child,
        right_child, num_leaves, leaf_value)  # (T, N)
    t, n = per_tree.shape
    return _tree_sum(per_tree.reshape(t // k, k, n)).T
