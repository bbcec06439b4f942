"""2-D (feature x row) sharded windowed rounds: the wide-F regime.

Counterpart of lightgbm_tpu/parallel/feature2d.py (reference:
src/treelearner/feature_parallel_tree_learner.cpp, each machine owning a
feature subset, composed with the data-parallel row split).  The world is
a (data, feature) grid (parallel/mesh.py::make_mesh_2d): the rank at (i,
j) holds row block i and feature block j, an F/d_f x N/d_r tile of the bin
matrix, so

* a window histogram is complete for the rank's feature block by layout:
  the merge is B1's carried accumulators summed over the data axis alone
  (the exact merge of the data-parallel learner, ops/histogram.py::
  merge_carry), with no collective over the feature axis;
* the split search runs over the block and the winner is elected over the
  feature axis (the scatter merge's owned-feature election,
  ops/treegrow.py::elect_best);
* each position's go-left decision, which only the block owning its
  segment's split feature can compute, is one masked psum over the feature
  axis (ops/treegrow_windowed.py::round_geometry): the round's only
  feature-axis data.

Padded features (F up to a multiple of d_f) have one bin, no missing bin
and are masked, so they never split.  Every histogram a rank holds is its
block of the serial one bit for bit, so the 2-D tree is the serial
windowed tree bit for bit, float and int8.  The megakernel stays off here,
as in the JAX package (the three-pass round).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.split import SplitParams
from ..ops.treegrow_windowed import Sharding, feature_block_tables, grow_tree_windowed
from . import collectives as C
from .mesh import DATA_AXIS, FEATURE_AXIS, GridMesh, RowShard, feature2d_axis_sizes


class Sharded2DData:
    """This rank's tile of the bin matrix: ``bins`` (n, k) int16, the rows
    of its row block (all of which the rank was given) and the columns of
    its feature block [f0, f0 + k), pads reading bin 0; the global
    per-feature tables; ``shard`` places the rows in the whole over the
    data axis (one all_gather of the row blocks' counts)."""

    def __init__(self, mesh: GridMesh, bins, num_bins_pf, missing_bin_pf, device=None):
        self.mesh = mesh
        d_r, d_f = feature2d_axis_sizes(mesh)
        bins = torch.as_tensor(np.asarray(bins) if not torch.is_tensor(bins) else bins)
        dev = torch.device(device) if device is not None else bins.device
        n, f = bins.shape
        k = -(-f // d_f)
        self.n_row_shards, self.n_feature_shards = d_r, d_f
        self.num_features, self.f_pad, self.k = f, k * d_f, k
        self.f0 = mesh.coords[1] * k
        tile = torch.zeros((n, k), dtype=torch.int16, device=dev)
        hi = min(self.f0 + k, f)
        if hi > self.f0:
            tile[:, :hi - self.f0] = bins[:, self.f0:hi].to(device=dev,
                                                            dtype=torch.int16)
        self.bins = tile
        self.num_bins_pf = torch.as_tensor(num_bins_pf, dtype=torch.int32, device=dev)
        self.missing_bin_pf = torch.as_tensor(missing_bin_pf, dtype=torch.int32,
                                              device=dev)
        row = mesh.axes[DATA_AXIS]
        lens = C.all_gather(torch.tensor([n], dtype=torch.int64, device=dev), row)
        lens = [int(v) for v in lens.cpu()]
        self.shard = RowShard(row, sum(lens[:row.rank]), sum(lens))


def grow_tree_windowed_feature2d(
        sharded: Sharded2DData, grad, hess, row_mask, sample_weight, feature_mask,
        categorical_mask=None, generator: Optional[torch.Generator] = None,
        feature_contri=None, *, num_leaves: int, num_bins: int, max_depth: int = -1,
        params: SplitParams = SplitParams(), leaf_tile: int = 16,
        hist_precision: str = "f32", quantize_bins: int = 0,
        stochastic_rounding: bool = True, quant_renew: bool = False,
        stats: Optional[dict] = None, guard_label: str = ""):
    """The windowed rounds over the 2-D mesh (module docstring): (tree,
    this rank's leaf ids).  ``feature_mask``, ``categorical_mask`` and
    ``feature_contri`` are over all F features; ``generator`` is the
    serial run's stochastic-rounding generator.  Per-node feature sampling
    is refused: each feature block searches only its own features."""
    if params.feature_fraction_bynode < 1.0 or params.extra_trees:
        raise ValueError(
            "tree_learner=feature2d (owned-feature split search) is incompatible "
            "with per-node feature sampling (feature_fraction_bynode/extra_trees): "
            "each feature block searches only its owned features; use "
            "tree_learner=data")
    sd = sharded
    feature = sd.mesh.axes[FEATURE_AXIS]
    if feature_mask is None:
        feature_mask = torch.ones(sd.num_bins_pf.shape[0], dtype=torch.bool, device=sd.bins.device)
    tables = feature_block_tables(sd.f0, sd.k, sd.f_pad, sd.num_bins_pf,
                                  sd.missing_bin_pf, feature_mask, categorical_mask,
                                  feature_contri)
    sh = Sharding(sd.shard, "psum", sd.f0, tables, own_mesh=feature,
                  feature_mesh=feature)
    return grow_tree_windowed(
        sd.bins, grad, hess, row_mask, sample_weight, feature_mask, sd.num_bins_pf,
        sd.missing_bin_pf, num_leaves=num_leaves, num_bins=num_bins,
        max_depth=max_depth, params=params, leaf_tile=leaf_tile,
        quantize_bins=quantize_bins, stochastic_rounding=stochastic_rounding,
        quant_renew=quant_renew, generator=generator, stats=stats,
        guard_label=guard_label, megakernel_opt="0", hist_precision=hist_precision,
        categorical_mask=categorical_mask, feature_contri=feature_contri,
        sharding=sh)
