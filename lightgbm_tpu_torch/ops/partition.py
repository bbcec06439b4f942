"""Leaf-ordered row partition maintenance.

Counterpart of lightgbm_tpu/ops/partition.py (reference: DataPartition in
src/treelearner/data_partition.hpp): the windowed grower keeps rows
physically grouped by leaf, and each round applies its splits as one stable
partition of the split leaves' position ranges (segments).

:func:`stable_partition_ranges` is the plain version: an O(N)
permutation.  The dispatcher is ops/partition_cuda.py::partition_segments:
a CUDA tensor goes to the segment-partition kernel (csrc/partition.cu),
which reads each position once and writes it once; a CPU tensor goes to
the plain version.
Both return identical results.
"""

from __future__ import annotations

import torch


def segment_ids(seg_start: torch.Tensor, seg_len: torch.Tensor,
                n: int) -> torch.Tensor:
    """(N,) i32 segment id per position, -1 outside every segment
    (segments are disjoint)."""
    pos = torch.arange(n, dtype=torch.int64, device=seg_start.device)
    st = seg_start.to(torch.int64)[:, None]
    in_seg = (pos[None, :] >= st) & (pos[None, :] < st + seg_len.to(torch.int64)[:, None])
    sid = torch.arange(1, seg_start.shape[0] + 1, dtype=torch.int32,
                       device=seg_start.device)
    return (in_seg.to(torch.int32) * sid[:, None]).sum(0, dtype=torch.int32) - 1


def stable_partition_ranges(order, seg_id, seg_start, seg_len, go_left):
    """Stably partition every segment of ``order`` by ``go_left`` (per
    position) in one shot: segment-relative ranks from cumulative sums and
    one permutation scatter.  Returns (new_order, left_counts (S,) i32);
    positions outside all segments are untouched."""
    n = order.shape[0]
    dev = order.device
    if n == 0 or seg_start.shape[0] == 0:
        return order.clone(), torch.zeros_like(seg_len, dtype=torch.int32)
    in_seg = seg_id >= 0
    sid = seg_id.clamp_min(0).long()
    cl = torch.cumsum((in_seg & go_left).long(), 0)
    cr = torch.cumsum((in_seg & ~go_left).long(), 0)
    start = seg_start.long()
    start_pos = start[sid]
    prev = (start_pos - 1).clamp(0, n - 1)
    rank_l = cl - torch.where(start_pos > 0, cl[prev], 0)
    rank_r = cr - torch.where(start_pos > 0, cr[prev], 0)
    seg_end = (start + (seg_len.long() - 1).clamp_min(0)).clamp(0, n - 1)
    cl0_seg = torch.where(start > 0, cl[(start - 1).clamp(0, n - 1)], 0)
    n_left = torch.where(seg_len > 0, cl[seg_end] - cl0_seg, 0)
    dest = torch.where(go_left, start_pos + rank_l - 1,
                       start_pos + n_left[sid] + rank_r - 1)
    dest = torch.where(in_seg, dest, torch.arange(n, device=dev))
    new_order = torch.empty_like(order)
    new_order[dest] = order
    return new_order, n_left.to(torch.int32)

