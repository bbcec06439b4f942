"""Tree-ensemble prediction on raw feature values, and leaf ids on bins.

Counterpart of lightgbm_tpu/ops/predict.py: predict_raw_values,
predict_raw_multiclass, predict_raw_window (the early-stop chunks),
predict_leaf_values (pred_leaf) and predict_leaf_binned (a host tree on a
dataset's device bins, the JAX package's Dataset.predict_leaf_binned_tree
traversal).  All rows of all trees advance one level per step through the
stacked structure-of-arrays trees; decisions are made in f32 against
thresholds rounded up to f32 (models/gbdt.py::_f32_threshold_upper), as in
the JAX package, and the per-tree values are summed in tree order.  A walk
takes as many steps as its deepest tree (``depth``, counted on the host
from the trees' children), or num_leaves - 1 when it is not given.
Categorical nodes (``cat``: per node a flag, a word base and a word count
into one flat array of the trees' bitset words) send a value left when
its C-cast integer is in the node's bitset; NaN, negative and
out-of-range values go right (reference: Tree::CategoricalDecision).
Nothing here reads the device back.
"""

from __future__ import annotations

from typing import Optional

import torch

_K_ZERO = 1e-35  # reference: kZeroThreshold


def _leaf_index(
    x: torch.Tensor,  # (N, F) raw features (NaN = missing)
    split_feature: torch.Tensor,  # (T, M) i32
    threshold: torch.Tensor,  # (T, M) f32 — `value <= threshold` -> left
    default_left: torch.Tensor,  # (T, M) bool
    missing_type: torch.Tensor,  # (T, M) i32: 0=None, 1=Zero, 2=NaN
    left_child: torch.Tensor,  # (T, M) i32, negative = ~leaf
    right_child: torch.Tensor,  # (T, M) i32
    num_leaves: torch.Tensor,  # (T,) i32
    depth: Optional[int] = None,
    cat: Optional[tuple] = None,  # (is_cat, cat_base, cat_nwords) (T, M), words (W,)
) -> torch.Tensor:
    """(T, N) i64: each tree's leaf index for each row (reference:
    Tree::NumericalDecision semantics per node missing type: NaN ->
    default; Zero: NaN or |v| <= kZero -> default; None: NaN treated as
    0.0; categorical nodes as the module docstring says)."""
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
    steps = max(m, 1) if depth is None else max(min(depth, m), 1)
    for _ in range(steps):
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
        if cat is not None:
            go_left = torch.where(cat[0][tt, nd], _in_bitset(v, miss, nd, tt, cat),
                                  go_left)
        node = torch.where(node >= 0,
                           torch.where(go_left, lc[tt, nd], rc[tt, nd]), node)
    return -node - 1


def _in_bitset(v, miss, nd, tt, cat) -> torch.Tensor:
    """Whether each (tree, row) value's C-cast integer is in its node's
    bitset (words of 32 bits, low bit first)."""
    _, base, nwords, words = cat
    iv = v.to(torch.int32)  # truncation, as the reference's static_cast<int>
    w = iv >> 5
    in_range = ~miss & (iv >= 0) & (w < nwords[tt, nd])
    widx = (base[tt, nd] + w).clamp(0, words.shape[0] - 1)
    bit = (words[widx.long()] >> (iv & 31).long()) & 1
    return in_range & (bit == 1)


def _per_tree_values(x, split_feature, threshold, default_left, missing_type,
                     left_child, right_child, num_leaves, leaf_value,
                     depth=None, cat=None) -> torch.Tensor:
    """(T, N) f32: each tree's leaf value for each row."""
    leaf = _leaf_index(x, split_feature, threshold, default_left, missing_type,
                       left_child, right_child, num_leaves, depth, cat)
    tt = torch.arange(leaf.shape[0], device=x.device)[:, None]
    return leaf_value[tt, leaf]


def _tree_sum(per_tree: torch.Tensor,
              base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum over the leading (tree) axis, one tree after another, onto
    ``base`` (zeros when not given)."""
    out = (torch.zeros(per_tree.shape[1:], dtype=torch.float32,
                       device=per_tree.device) if base is None else base)
    for i in range(per_tree.shape[0]):
        out = out + per_tree[i]
    return out


def predict_raw_values(x, split_feature, threshold, default_left,
                       missing_type, left_child, right_child, num_leaves,
                       leaf_value, depth=None, cat=None) -> torch.Tensor:
    """Raw ensemble margin per row: (N,) f32, the sum over trees of the
    leaf values, in tree order."""
    return _tree_sum(_per_tree_values(
        x, split_feature, threshold, default_left, missing_type, left_child,
        right_child, num_leaves, leaf_value, depth, cat))


def predict_raw_multiclass(x, split_feature, threshold, default_left,
                           missing_type, left_child, right_child, num_leaves,
                           leaf_value, depth=None, cat=None, *, k: int) -> torch.Tensor:
    """Multiclass raw margins, (N, k) f32.  Tree i belongs to class i % k
    (iteration-major, class-minor), and each class sums its own trees in
    iteration order, the JAX package's per-row order."""
    per_tree = _per_tree_values(
        x, split_feature, threshold, default_left, missing_type, left_child,
        right_child, num_leaves, leaf_value, depth, cat)  # (T, N)
    t, n = per_tree.shape
    return _tree_sum(per_tree.reshape(t // k, k, n)).T


def predict_raw_window(x, tree_lo: int, split_feature, threshold, default_left,
                       missing_type, left_child, right_child, num_leaves,
                       leaf_value, depth=None, cat=None, *, k: int, window: int,
                       base: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """The margins after ``window`` more trees, starting at tree
    ``tree_lo``: ``base`` ((N,) or (N, k) f32, the margins so far) plus the
    window's trees, added one after another in the full prediction's order,
    so a row that runs every window ends bitwise at predict_raw_values /
    predict_raw_multiclass.  Rows where ``active`` (N,) is false keep
    ``base`` (prediction early stopping)."""
    sl = slice(tree_lo, tree_lo + window)
    if cat is not None:
        cat = (cat[0][sl], cat[1][sl], cat[2][sl], cat[3])
    per_tree = _per_tree_values(
        x, split_feature[sl], threshold[sl], default_left[sl], missing_type[sl],
        left_child[sl], right_child[sl], num_leaves[sl], leaf_value[sl], depth,
        cat)
    n = per_tree.shape[1]
    if k == 1:
        return torch.where(active, _tree_sum(per_tree, base), base)
    out = _tree_sum(per_tree.reshape(window // k, k, n), base.T).T
    return torch.where(active[:, None], out, base)


def predict_leaf_values(x, split_feature, threshold, default_left,
                        missing_type, left_child, right_child, num_leaves,
                        depth=None, cat=None) -> torch.Tensor:
    """Leaf index per (row, tree) on raw values: (N, T) i32, the traversal
    of the value path (reference: the Predictor's leaf-index mode)."""
    return _leaf_index(x, split_feature, threshold, default_left, missing_type,
                       left_child, right_child, num_leaves, depth,
                       cat).T.to(torch.int32)


def predict_leaf_binned(bins: torch.Tensor,  # (N, F) int
                        missing_bin_per_feature: torch.Tensor,  # (F,) i32
                        split_feature: torch.Tensor,  # (M,) i64
                        threshold_bin: torch.Tensor,  # (M,) i32
                        default_left: torch.Tensor,  # (M,) bool
                        left_child: torch.Tensor,  # (M,) i64
                        right_child: torch.Tensor,  # (M,) i64
                        depth: int,
                        cat: Optional[tuple] = None,  # is_cat (M,), masks (M, B)
                        ) -> torch.Tensor:
    """Leaf index per row of one tree (M >= 1 internal nodes, ``depth``
    levels) on binned rows: (N,) i32.  In bin space the missing bin is
    exact, so every node sends it to its default side; a categorical node
    sends the bins of its bin-space mask left."""
    node = torch.zeros(bins.shape[0], dtype=torch.int64, device=bins.device)
    for _ in range(max(depth, 1)):
        nd = node.clamp_min(0)
        f = split_feature[nd]
        col = bins.gather(1, f[:, None])[:, 0].to(torch.int32)
        miss = col == missing_bin_per_feature[f]
        go_left = torch.where(miss, default_left[nd], col <= threshold_bin[nd])
        if cat is not None:
            go_left = torch.where(cat[0][nd], cat[1][nd, col.long()], go_left)
        node = torch.where(node >= 0,
                           torch.where(go_left, left_child[nd], right_child[nd]), node)
    return (-node - 1).to(torch.int32)
