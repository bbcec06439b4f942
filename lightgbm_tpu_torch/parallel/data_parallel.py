"""Data-parallel tree learning over torch.distributed ranks.

Counterpart of lightgbm_tpu/parallel/data_parallel.py (reference:
src/treelearner/data_parallel_tree_learner.cpp and
voting_parallel_tree_learner.cpp).  Under the JAX package a rank is a mesh
device inside shard_map; here a rank is a process.  Each rank holds its
rows (``ShardedData``), each function below runs the rank's part of the
tree, and the collective stands where the JAX package's psum stands
(parallel/collectives.py).  Every rank returns the same tree and its own
rows' leaf ids.

The merge is exact (ops/histogram.py::merge_carry): histograms are the
64-bit fixed-point sums of every rank's rows with the tree's global
exponents, so R ranks grow the serial tree bit for bit, where the JAX
package sums f32 histograms and holds its trees to a tolerance.  The cost
is bytes: a merge moves T x F x B x 20 bytes (int64 grad and hess, int32
count) where f32 would move 12.

No padding: a rank is a process and its arrays have its own length, so
``row_valid`` is all True and the global row count is the sum of the
ranks' counts (one all_gather at set-up).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.split import SplitParams
from ..ops.treegrow import grow_tree
from ..ops.treegrow_fast import grow_tree_fast
from ..ops.treegrow_windowed import grow_tree_windowed
from . import collectives as C
from .mesh import Mesh, RowShard


class ShardedData:
    """This rank's training rows: ``bins`` (n, F) int16 on the rank's
    device and the per-feature tables, with the rows' place in the whole
    (``shard``: the first global row and the global count, from one
    all_gather of the ranks' counts; ranks hold consecutive row blocks in
    rank order, as parallel/launcher.py shards them)."""

    def __init__(self, mesh: Mesh, bins, num_bins_pf, missing_bin_pf, device=None):
        self.mesh = mesh
        bins = torch.as_tensor(np.asarray(bins) if not torch.is_tensor(bins) else bins)
        dev = torch.device(device) if device is not None else bins.device
        self.bins = bins.to(device=dev, dtype=torch.int16).contiguous()
        n = self.bins.shape[0]
        self.num_bins_pf = torch.as_tensor(num_bins_pf, dtype=torch.int32, device=dev)
        self.missing_bin_pf = torch.as_tensor(missing_bin_pf, dtype=torch.int32,
                                              device=dev)
        lens = C.all_gather(torch.tensor([n], dtype=torch.int64, device=dev), mesh)
        lens = [int(v) for v in lens.cpu()]
        self.num_data = n
        self.shard = RowShard(mesh, sum(lens[:mesh.rank]), sum(lens))
        self.row_valid = torch.ones(n, dtype=torch.bool, device=dev)


def grow_tree_data_parallel(sharded: ShardedData, grad, hess, row_mask,
                            sample_weight, feature_mask, categorical_mask=None,
                            monotone_constraints=None, interaction_sets=None,
                            rng_key=None, feature_contri=None, *, num_leaves: int,
                            num_bins: int, max_depth: int = -1,
                            params: SplitParams = SplitParams(),
                            parallel_mode: str = "data", top_k: int = 20,
                            monotone_method: str = "basic", stats=None,
                            cegb_feature_penalty=None, track_path: bool = False):
    """The strict grower over the ranks (reference:
    DataParallelTreeLearner::Train, or PV-Tree with parallel_mode="voting"):
    (tree, this rank's leaf ids)."""
    return grow_tree(
        sharded.bins, grad, hess, row_mask, sample_weight, feature_mask,
        sharded.num_bins_pf, sharded.missing_bin_pf, num_leaves=num_leaves,
        num_bins=num_bins, max_depth=max_depth, params=params, stats=stats,
        categorical_mask=categorical_mask, feature_contri=feature_contri,
        monotone_constraints=monotone_constraints, interaction_sets=interaction_sets,
        rng_key=rng_key, cegb_feature_penalty=cegb_feature_penalty,
        track_path=track_path, monotone_method=monotone_method,
        axis_name=sharded.shard, parallel_mode=parallel_mode, top_k=top_k)[:2]


def grow_tree_fast_data_parallel(sharded: ShardedData, grad, hess, row_mask,
                                 sample_weight, feature_mask, categorical_mask=None,
                                 monotone_constraints=None, interaction_sets=None,
                                 rng_key=None, generator=None,
                                 cegb_feature_penalty=None, feature_contri=None, *,
                                 num_leaves: int, num_bins: int, max_depth: int = -1,
                                 params: SplitParams = SplitParams(),
                                 leaf_tile: int = 8, hist_precision: str = "f32",
                                 quantize_bins: int = 0,
                                 stochastic_rounding: bool = True,
                                 quant_renew: bool = False, track_path: bool = False,
                                 monotone_method: str = "basic", stats=None,
                                 guard_label: str = ""):
    """The rounds grower over the ranks: each round's (tile, 3, F, B) block
    merged exactly, every rank applying the same splits.  ``generator``:
    the serial run's stochastic-rounding generator (every rank draws all N
    and keeps its rows')."""
    return grow_tree_fast(
        sharded.bins, grad, hess, row_mask, sample_weight, feature_mask,
        sharded.num_bins_pf, sharded.missing_bin_pf, num_leaves=num_leaves,
        num_bins=num_bins, max_depth=max_depth, params=params, leaf_tile=leaf_tile,
        quantize_bins=quantize_bins, stochastic_rounding=stochastic_rounding,
        quant_renew=quant_renew, generator=generator, stats=stats,
        guard_label=guard_label, hist_precision=hist_precision,
        categorical_mask=categorical_mask, feature_contri=feature_contri,
        monotone_constraints=monotone_constraints, interaction_sets=interaction_sets,
        rng_key=rng_key, cegb_feature_penalty=cegb_feature_penalty,
        track_path=track_path, monotone_method=monotone_method,
        axis_name=sharded.shard)[:2]


def grow_tree_windowed_data_parallel(sharded: ShardedData, grad, hess, row_mask,
                                     sample_weight, feature_mask,
                                     categorical_mask=None, rng_key=None,
                                     generator=None, feature_contri=None, *,
                                     num_leaves: int, num_bins: int,
                                     max_depth: int = -1,
                                     params: SplitParams = SplitParams(),
                                     leaf_tile: int = 16, hist_precision: str = "f32",
                                     quantize_bins: int = 0,
                                     stochastic_rounding: bool = True,
                                     quant_renew: bool = False, merge: str = "psum",
                                     stats: Optional[dict] = None,
                                     guard_label: str = "",
                                     megakernel_opt: Optional[str] = None):
    """The sharded windowed round (the JAX package's sharded fused round):
    B3 unfused (or the three-pass round) on each rank's window, one exact
    merge a round (``merge="psum"``: all_reduce, or ``"scatter"``:
    reduce_scatter over the features and the owned-feature election), then
    the subtraction and the split search.  ``merge="scatter"`` refuses
    per-node feature sampling (ops/treegrow_windowed.py::_sharding)."""
    return grow_tree_windowed(
        sharded.bins, grad, hess, row_mask, sample_weight, feature_mask,
        sharded.num_bins_pf, sharded.missing_bin_pf, num_leaves=num_leaves,
        num_bins=num_bins, max_depth=max_depth, params=params, leaf_tile=leaf_tile,
        quantize_bins=quantize_bins, stochastic_rounding=stochastic_rounding,
        quant_renew=quant_renew, generator=generator, stats=stats,
        guard_label=guard_label, megakernel_opt=megakernel_opt,
        hist_precision=hist_precision, categorical_mask=categorical_mask,
        feature_contri=feature_contri, rng_key=rng_key, axis_name=sharded.shard,
        merge=merge)


def distributed_metric_sums(mesh: Mesh, local_loss_sum, local_weight_sum):
    """A metric's sums over every rank's rows (reference:
    Network::GlobalSyncUpBySum in Metric::Eval): (loss, weight), f64."""
    t = torch.tensor([float(local_loss_sum), float(local_weight_sum)],
                     dtype=torch.float64)
    if mesh.backend == "nccl":
        t = t.cuda()
    t = C.psum(t, mesh).cpu()
    return float(t[0]), float(t[1])
