"""Tree arrays shared by the growers.

Counterpart of the structure-of-arrays part of lightgbm_tpu/ops/treegrow.py
(reference: class Tree in include/LightGBM/tree.h).  The strict best-first
grower (grow_tree) is not ported yet (ROADMAP queue A7); the round-batched
grower lives in ops/treegrow_fast.py.
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
