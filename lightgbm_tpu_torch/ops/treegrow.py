"""What the round-batched growers share: tree arrays, admission and the
node bookkeeping of a round.

Counterpart of the structure-of-arrays part of lightgbm_tpu/ops/treegrow.py
(reference: class Tree in include/LightGBM/tree.h) and of the admission and
bookkeeping that the JAX package's rounds grower (treegrow_fast.py) and
windowed grower (treegrow_windowed.py) both carry.  The strict best-first
grower (grow_tree) is not ported yet (ROADMAP queue A7); the round-batched
growers live in ops/treegrow_fast.py and ops/treegrow_windowed.py.

A round is a fixed sequence of device work: its splits are masked by
``accept`` over the leaves, and writes of the leaves or ranks it does not
admit land in a spare slot (``_put``), so no host read sizes anything.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .split import KMIN_SCORE, BestSplit


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
              s: BestSplit, leaf_out, leaf_sum_h, leaf_count) -> TreeArrays:
    """The node arrays after the admitted splits: each admitted leaf's node
    (slot node_of) takes its split and the leaf's output and sums, its
    children are ~leaf (the left keeps the id) and ~right_of, and the
    parent's child slot is re-pointed from ~leaf to the node."""
    L = accept.shape[0]
    drop = -1  # _put's index of the spare slot
    idx = torch.arange(L, dtype=torch.int64, device=accept.device)
    repoint_l = accept & (leaf_parent >= 0) & (leaf_side == 0)
    repoint_r = accept & (leaf_parent >= 0) & (leaf_side == 1)
    safe_node = node_of.clamp(0, L - 2)
    lc_t = _put(t.left_child, torch.where(repoint_l, leaf_parent, drop), safe_node)
    rc_t = _put(t.right_child, torch.where(repoint_r, leaf_parent, drop), safe_node)
    node_pos = torch.where(accept, node_of, drop)
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
