"""Leaf-wise tree growth: the strict grower, and what the round-batched
growers share (tree arrays, admission and the node bookkeeping of a round).

Counterpart of lightgbm_tpu/ops/treegrow.py (reference:
src/treelearner/serial_tree_learner.cpp, class Tree in
include/LightGBM/tree.h).  ``grow_tree`` is the exact-order best-first
grower, the JAX package's default off the accelerator: L - 1 steps, each
splitting the leaf with the best gain.  A step is a fixed sequence of
device work, as the JAX package's fori_loop body is: the best leaf, the
number of leaves and "no splittable leaf" stay on the device, and a step
after the last useful split is a masked no-op, so a tree makes no host
read.  Categorical splits route a row left when its bin is in the
winning subset (``cat_mask``), so missing and unseen categories go right.
The round-batched growers live in ops/treegrow_fast.py and
ops/treegrow_windowed.py.

A round is a fixed sequence of device work: its splits are masked by
``accept`` over the leaves, and writes of the leaves or ranks it does not
admit land in a spare slot (``_put``), so no host read sizes anything.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import sanitizer as _san
from .hist_cuda import fixed_shift_tensor
from .histogram import histogram_multi
from .round_cuda import split_window
from .split import (KMIN_SCORE, BestSplit, SplitParams, find_best_split,
                    leaf_output, leaf_output_smoothed)

# options of the JAX package's growers that this package does not carry yet
# (ROADMAP queue A11b; data/feature/voting modes A13): passing one raises
UNPORTED = ("monotone_constraints", "interaction_sets", "rng_key",
            "cegb_feature_penalty", "forced_leaf",
            "cegb_lazy_penalty", "track_path", "axis_name")


def reject_unported(who: str, options: dict) -> None:
    """Raise for any option of UNPORTED given a value, and for any other
    unknown option."""
    for name in UNPORTED:
        v = options.pop(name, None)
        if v is not None and v is not False:
            raise ValueError(f"{who}: {name} is not ported to "
                             "lightgbm_tpu_torch yet (ROADMAP queue A11b/A13)")
    if options:
        raise TypeError(f"unexpected options: {sorted(options)}")


class TreeArrays(NamedTuple):
    """Structure-of-arrays tree.  Internal node slots 0..num_leaves-2 (slot
    t = t-th split); children encode leaves as ~leaf_index (negative)."""

    num_leaves: torch.Tensor  # i32 scalar — actual leaf count
    split_feature: torch.Tensor  # (L-1,) i32
    threshold_bin: torch.Tensor  # (L-1,) i32
    default_left: torch.Tensor  # (L-1,) bool
    split_gain: torch.Tensor  # (L-1,) f32
    left_child: torch.Tensor  # (L-1,) i32
    right_child: torch.Tensor  # (L-1,) i32
    internal_value: torch.Tensor  # (L-1,) f32
    internal_weight: torch.Tensor  # (L-1,) f32 — sum hessian
    internal_count: torch.Tensor  # (L-1,) f32
    leaf_value: torch.Tensor  # (L,) f32
    leaf_weight: torch.Tensor  # (L,) f32 — sum hessian
    leaf_count: torch.Tensor  # (L,) f32
    leaf_sum_g: torch.Tensor  # (L,) f32
    leaf_depth: torch.Tensor  # (L,) i32
    is_cat: torch.Tensor  # (L-1,) bool
    cat_mask: torch.Tensor  # (L-1, B) bool
    path_features: Optional[torch.Tensor] = None  # linear trees (not ported)

    def to_numpy(self) -> "TreeArrays":
        return TreeArrays(*[None if a is None else a.cpu().numpy()
                            for a in self])


def _empty_best(num_leaves: int, num_bins: int, device) -> BestSplit:
    def z(dtype):
        return torch.zeros((num_leaves,), dtype=dtype, device=device)

    return BestSplit(
        gain=torch.full((num_leaves,), KMIN_SCORE, dtype=torch.float32,
                        device=device),
        feature=z(torch.int32),
        threshold_bin=z(torch.int32),
        default_left=z(torch.bool),
        is_cat=z(torch.bool),
        cat_mask=torch.zeros((num_leaves, num_bins), dtype=torch.bool,
                             device=device),
        left_sum_g=z(torch.float32),
        left_sum_h=z(torch.float32),
        left_count=z(torch.float32),
        right_sum_g=z(torch.float32),
        right_sum_h=z(torch.float32),
        right_count=z(torch.float32),
    )


def _set_best(best: BestSplit, idx: torch.Tensor, s: BestSplit) -> None:
    """best[idx] = s for every field, in place."""
    for arr, v in zip(best, s):
        arr[idx] = v


def _put(arr: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """``arr.at[idx].set(val, mode="drop")``: a new array with arr[idx] =
    val where 0 <= idx < len(arr); idx = -1 drops the write (it lands in a
    spare slot past the end); any other index raises.  Two device kernels:
    a round is hundreds of such small updates, so their count is most of
    its device time."""
    n = arr.shape[0]
    ext = torch.cat([arr, arr[:1]])
    if not torch.is_tensor(val):  # a host scalar would be a blocking copy
        val = torch.full((), val, device=arr.device)
    ext[idx.long()] = val.to(arr.dtype)
    return ext[:n]


def go_left_of(col, missing_bin, default_left, threshold_bin, is_cat=None,
               cat_mask=None):
    """Each row's direction at its split: a numerical split sends bin <=
    threshold left and the missing bin its default way; a categorical one
    (``is_cat``) sends the bins of its ``cat_mask`` left (reference:
    Tree::CategoricalDecision; missing and unseen categories go right).
    ``cat_mask`` is the row's mask row, or a gather of it; col (N,) i32."""
    gl = torch.where(col == missing_bin, default_left, col <= threshold_bin)
    if is_cat is None:
        return gl
    return torch.where(is_cat, cat_mask, gl)


def _splittable(gain, leaf_depth, max_depth: int) -> torch.Tensor:
    can = gain > KMIN_SCORE / 2
    if max_depth > 0:
        can = can & (leaf_depth < max_depth)
    return can


def admit(gain, leaf_depth, num_leaves_cur, *, num_leaves: int,
          leaf_tile: int, max_depth: int):
    """This round's splits, best gain first within the budget and at most
    ``leaf_tile``: (accept (L,) bool, rank of each leaf, leaf of each rank).
    The admitted leaves are a prefix of the stable sort order."""
    L = num_leaves
    can = _splittable(gain, leaf_depth, max_depth)
    srt = torch.argsort(torch.where(can, -gain, float("inf")), stable=True)
    order_rank = torch.empty_like(srt)
    order_rank[srt] = torch.arange(L, dtype=srt.dtype, device=srt.device)
    accept = can & (order_rank < (L - num_leaves_cur).clamp_max(leaf_tile))
    return accept, order_rank, srt


def admits_next(gain, leaf_depth, num_leaves_cur, *, num_leaves: int,
                leaf_tile: int, max_depth: int) -> torch.Tensor:
    """How many splits the next round admits from this state (0-d)."""
    budget = (num_leaves - num_leaves_cur).clamp(0, leaf_tile)
    return torch.minimum(_splittable(gain, leaf_depth, max_depth).sum(), budget)


def empty_tree(num_leaves: int, num_bins: int, device) -> TreeArrays:
    """A one-leaf tree: node arrays (L-1,), leaf arrays (L,), all zero."""
    L, m = num_leaves, num_leaves - 1

    def zeros(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return TreeArrays(
        num_leaves=torch.ones((), dtype=torch.int32, device=device),
        split_feature=zeros(m, torch.int32), threshold_bin=zeros(m, torch.int32),
        default_left=zeros(m, torch.bool), split_gain=zeros(m),
        left_child=zeros(m, torch.int32), right_child=zeros(m, torch.int32),
        internal_value=zeros(m), internal_weight=zeros(m), internal_count=zeros(m),
        leaf_value=zeros(L), leaf_weight=zeros(L), leaf_count=zeros(L),
        leaf_sum_g=zeros(L), leaf_depth=zeros(L, torch.int32),
        is_cat=zeros(m, torch.bool), cat_mask=zeros((m, num_bins), torch.bool))


def book_tree(t: TreeArrays, accept, node_of, right_of, leaf_parent, leaf_side,
              s: BestSplit, leaf_out, leaf_sum_h, leaf_count,
              categorical: bool = False) -> TreeArrays:
    """The node arrays after the admitted splits: each admitted leaf's node
    (slot node_of) takes its split and the leaf's output and sums, its
    children are ~leaf (the left keeps the id) and ~right_of, and the
    parent's child slot is re-pointed from ~leaf to the node.
    ``categorical``: book is_cat and cat_mask too (they stay False
    otherwise)."""
    L = accept.shape[0]
    drop = -1  # _put's index of the spare slot
    idx = torch.arange(L, dtype=torch.int64, device=accept.device)
    repoint_l = accept & (leaf_parent >= 0) & (leaf_side == 0)
    repoint_r = accept & (leaf_parent >= 0) & (leaf_side == 1)
    safe_node = node_of.clamp(0, L - 2)
    lc_t = _put(t.left_child, torch.where(repoint_l, leaf_parent, drop), safe_node)
    rc_t = _put(t.right_child, torch.where(repoint_r, leaf_parent, drop), safe_node)
    node_pos = torch.where(accept, node_of, drop)
    if categorical:
        t = t._replace(is_cat=_put(t.is_cat, node_pos, s.is_cat),
                       cat_mask=_put(t.cat_mask, node_pos, s.cat_mask))
    return t._replace(
        split_feature=_put(t.split_feature, node_pos, s.feature),
        threshold_bin=_put(t.threshold_bin, node_pos, s.threshold_bin),
        default_left=_put(t.default_left, node_pos, s.default_left),
        split_gain=_put(t.split_gain, node_pos, s.gain),
        left_child=_put(lc_t, node_pos, -idx - 1),
        right_child=_put(rc_t, node_pos, -right_of - 1),
        internal_value=_put(t.internal_value, node_pos, leaf_out),
        internal_weight=_put(t.internal_weight, node_pos, leaf_sum_h),
        internal_count=_put(t.internal_count, node_pos, leaf_count),
    )


def quantize_gradients(grad, hess, row_mask, quantize_bins: int,
                       stochastic_rounding: bool,
                       generator: Optional[torch.Generator]):
    """Discretize to int8: grad in [-half, half], hess in [0, quantize_bins]
    (reference: GradientDiscretizer::DiscretizeGradients); stochastic
    rounding draws from ``generator``.  Returns (gq, hq, the dequantized
    grad and hess that split evaluation sees, quant_scale (3,))."""
    dev = grad.device
    half = max(quantize_bins // 2, 1)
    inbag = row_mask.float()
    g_scale = torch.clamp_min(torch.max(torch.abs(grad) * inbag) / half, 1e-30)
    h_scale = torch.clamp_min(torch.max(hess * inbag) / quantize_bins, 1e-30)
    gs = grad / g_scale
    hs = hess / h_scale
    if stochastic_rounding:
        u = torch.rand((2, grad.shape[0]), generator=generator, device=dev)
        gq = torch.floor(gs + u[0])
        hq = torch.floor(hs + u[1])
    else:
        gq = torch.round(gs)
        hq = torch.round(hs)
    gq = gq.clamp(-127, 127).to(torch.int8)
    hq = hq.clamp(0, 127).to(torch.int8)
    quant_scale = torch.stack([g_scale, h_scale, torch.ones((), device=dev)])
    return gq, hq, gq.float() * g_scale, hq.float() * h_scale, quant_scale


def finish_tree(t: TreeArrays, num_leaves_cur, leaf_value, leaf_sum_g,
                leaf_sum_h, leaf_count, leaf_depth) -> TreeArrays:
    """The tree with its leaf arrays; leaves past the last are zero."""
    L = leaf_value.shape[0]
    active = torch.arange(L, device=leaf_value.device) < num_leaves_cur
    return t._replace(
        num_leaves=num_leaves_cur.to(torch.int32),
        leaf_value=torch.where(active, leaf_value, 0.0),
        leaf_weight=torch.where(active, leaf_sum_h, 0.0),
        leaf_count=torch.where(active, leaf_count, 0.0),
        leaf_sum_g=torch.where(active, leaf_sum_g, 0.0),
        leaf_depth=leaf_depth.to(torch.int32))


def grow_tree(
    bins: torch.Tensor,  # (N, F) int16
    grad: torch.Tensor,  # (N,) f32
    hess: torch.Tensor,
    row_mask: torch.Tensor,  # (N,) bool
    sample_weight: torch.Tensor,  # (N,) f32
    feature_mask: Optional[torch.Tensor],  # (F,) bool
    num_bins_per_feature: torch.Tensor,  # (F,) i32
    missing_bin_per_feature: torch.Tensor,  # (F,) i32
    *,
    num_leaves: int,
    num_bins: int,
    max_depth: int = -1,
    params: SplitParams = SplitParams(),
    stats: Optional[dict] = None,
    categorical_mask: Optional[torch.Tensor] = None,  # (F,) bool
    feature_contri: Optional[torch.Tensor] = None,  # (F,) f32
    **options,
) -> tuple[TreeArrays, torch.Tensor]:
    """Grow one tree best-first, one split a step; returns (tree, final
    leaf_id per row).

    Each step: the leaf with the best gain (the first on ties), an
    elementwise leaf_id update from its split's column, the histogram of
    the smaller child (one histogram_multi call at tile 1 over the rows of
    that child), the sibling as parent minus child, and both children's
    best splits.  Every histogram of the tree shares one fixed-point
    exponent pair (hist_cuda.fixed_shift_tensor of the tree's gradients,
    computed on the device), so the subtraction is exact.  ``stats``
    receives the utils/sanitizer.py counts of the tree (a step counts as a
    round), in the round drivers' layout (no retries, no windows)."""
    reject_unported("grow_tree", options)
    with _san.DispatchCounter() as counter:
        try:
            return _grow(bins, grad, hess, row_mask, sample_weight, feature_mask,
                         num_bins_per_feature, missing_bin_per_feature,
                         num_leaves, num_bins, max_depth, params,
                         categorical_mask, feature_contri)
        finally:
            if stats is not None:
                stats.update(counter.stats(), retries=0, windows=[])


def _grow(bins, grad, hess, row_mask, sample_weight, feature_mask, nbpf, mbpf,
          L, num_bins, max_depth, params, cmask, contri):
    dev = bins.device
    n, f = bins.shape
    grad = grad.float() * sample_weight
    hess = hess.float() * sample_weight
    shift = fixed_shift_tensor(grad, hess)
    slot = torch.zeros(n, dtype=torch.int32, device=dev)
    idx = torch.arange(L, dtype=torch.int64, device=dev)
    drop = -1  # _put's index of the spare slot

    def leaf_hist(mask):
        return histogram_multi(bins, grad, hess, mask, slot, 0, 1, num_bins,
                               shift=shift)

    def best_for(hist, g, h, c, depth, parent_out) -> BestSplit:
        s = find_best_split(hist, g, h, c, nbpf, mbpf, params,
                            feature_mask=feature_mask, parent_output=parent_out,
                            categorical_mask=cmask, feature_contri=contri)
        if max_depth > 0:  # reference: the max_depth check of BeforeFindBestSplit
            s = s._replace(gain=torch.where(depth >= max_depth, KMIN_SCORE, s.gain))
        return s

    def first(v):
        out = torch.zeros(L, dtype=v.dtype, device=dev)
        out[0] = v
        return out

    # ---- the root: every in-bag row ----
    hist = torch.zeros((L + 1, 3, f, num_bins), dtype=torch.float32, device=dev)
    hist0 = leaf_hist(row_mask)  # (1, 3, F, B)
    hist[0] = hist0[0]
    g0, h0, c0 = torch.sum(hist0[0, :, 0, :], dim=1)  # totals from feature 0
    leaf_out = first(leaf_output(g0, h0, params))
    best = _empty_best(L, num_bins, dev)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    _set_best(best, zero, best_for(hist0, g0[None], h0[None], c0[None], zero,
                                   leaf_out[:1]))
    leaf_id = torch.zeros(n, dtype=torch.int32, device=dev)
    leaf_sum_g, leaf_sum_h, leaf_count = first(g0), first(h0), first(c0)
    leaf_depth = torch.zeros(L, dtype=torch.int64, device=dev)
    leaf_parent = torch.full((L,), -1, dtype=torch.int64, device=dev)
    leaf_side = torch.zeros(L, dtype=torch.int64, device=dev)
    nlc = torch.ones((), dtype=torch.int64, device=dev)
    tree = empty_tree(L, num_bins, dev)
    sides = torch.arange(2, dtype=torch.int64, device=dev)

    for _ in range(L - 1):
        _san.record_dispatch()
        can = best.gain.max() > KMIN_SCORE / 2
        best_leaf = torch.argmax(best.gain)
        bl = best_leaf.reshape(1)  # (index_select: no host read of the index)
        s = BestSplit(*[a.index_select(0, bl)[0] for a in best])
        node, new_leaf = nlc - 1, nlc
        pair = torch.stack([best_leaf, new_leaf])
        pos = torch.where(can, pair, drop)  # where the two children write

        # ---- partition: an elementwise leaf_id update ----
        feat = s.feature.long()
        fcol = bins.index_select(1, feat.reshape(1))[:, 0].to(torch.int32)
        go_left = go_left_of(
            fcol, mbpf.index_select(0, feat.reshape(1)), s.default_left,
            s.threshold_bin, *((s.is_cat, s.cat_mask[fcol.long()])
                               if cmask is not None else ()))
        moves = can & (leaf_id == best_leaf) & ~go_left
        leaf_id = torch.where(moves, new_leaf.to(torch.int32), leaf_id)

        # ---- the smaller child's histogram, the sibling by subtraction ----
        left_smaller = s.left_count <= s.right_count
        small_leaf = torch.where(left_smaller, best_leaf, new_leaf)
        fresh = leaf_hist(can & row_mask & (leaf_id == small_leaf))
        left_h, right_h = split_window(hist.index_select(0, bl), fresh,
                                       left_smaller.reshape(1))
        children = torch.cat([left_h, right_h])
        hist.index_copy_(0, torch.where(can, pair, L), children)

        # ---- the node (reference: Tree::Split) and the leaf aggregates ----
        accept = can & (idx == best_leaf)
        tree = book_tree(tree, accept, node.expand(L), new_leaf.expand(L),
                         leaf_parent, leaf_side, best, leaf_out, leaf_sum_h,
                         leaf_count, categorical=cmask is not None)
        parent_out = leaf_out.index_select(0, bl)[0]
        out_l = leaf_output_smoothed(s.left_sum_g, s.left_sum_h, s.left_count,
                                     parent_out, params)
        out_r = leaf_output_smoothed(s.right_sum_g, s.right_sum_h, s.right_count,
                                     parent_out, params)
        depth_child = leaf_depth.index_select(0, bl)[0] + 1
        g2 = torch.stack([s.left_sum_g, s.right_sum_g])
        h2 = torch.stack([s.left_sum_h, s.right_sum_h])
        c2 = torch.stack([s.left_count, s.right_count])
        out2 = torch.stack([out_l, out_r])
        d2 = depth_child.expand(2)
        leaf_sum_g = _put(leaf_sum_g, pos, g2)
        leaf_sum_h = _put(leaf_sum_h, pos, h2)
        leaf_count = _put(leaf_count, pos, c2)
        leaf_depth = _put(leaf_depth, pos, d2)
        leaf_parent = _put(leaf_parent, pos, node.expand(2))
        leaf_side = _put(leaf_side, pos, sides)
        leaf_out = _put(leaf_out, pos, out2)

        # ---- the two fresh leaves' best splits ----
        bb = best_for(children, g2, h2, c2, d2, out2)
        best = BestSplit(*[_put(o, pos, nw) for o, nw in zip(best, bb)])
        nlc = nlc + can.long()

    leaf_value = (leaf_out if params.path_smooth > 0  # smoothed at creation
                  else leaf_output(leaf_sum_g, leaf_sum_h, params))
    return finish_tree(tree, nlc, leaf_value, leaf_sum_g, leaf_sum_h,
                       leaf_count, leaf_depth), leaf_id
