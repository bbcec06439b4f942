"""Multi-slice scale-out: the hierarchical two-level merge.

Counterpart of lightgbm_tpu/parallel/hierarchy.py (reference: the
voting-parallel route, src/treelearner/voting_parallel_tree_learner.cpp:
a local top-k feature election, a global vote, and a histogram exchange of
only the elected features).  The world is a nested (dcn, ici) mesh
(parallel/mesh.py::make_mesh_hierarchical): slices of consecutive ranks.

* Inside a slice the windowed round keeps its exact merge (all_reduce, or
  reduce_scatter with the owned-feature election) over the ``ici`` axis.
  Below the exhaustive top-k the merged histograms stay in B1's fixed
  point: they are the slice's sums (``WState.hist`` holds slice-domain
  int64 sums, the sibling subtraction is integer), never a full-F
  histogram of the whole.
* Between slices only top-k-shaped traffic crosses the ``dcn`` axis
  (``dcn_topk_best``): each slice's best gain of each feature a candidate
  (slice-local f32), its top ``top_k_features`` gains and feature ids
  all-gathered, a deterministic vote (the sum of the valid gains a
  feature; ties to the lower id; the elected ids sorted ascending), then
  only the elected features' fixed-point columns summed over dcn, as
  integers (``dcn_merge``), and converted to f32 once: the global
  histograms of those features, from which the split is chosen with the
  global parent sums.
* The window child, the info vector and every row-domain sum (window
  counts, totals, exponents, quantization scales) are merged over the
  whole world.

With ``top_k_features`` >= the features a rank searches (F under the
all_reduce, its block under reduce_scatter) the vote's outcome is known
before it runs: every feature, in ascending order.  Running it would
all-gather the gains and ids and then send over dcn every feature's
columns of both children of each split, twice the bytes of the window
sums alone.  So that k skips the vote: the window sums themselves are
summed over dcn after the slice's merge, as integers, and converted once
(the flat merge in two levels), and the state is the flat round's (f32
histograms, the siblings by f32 subtraction of the parents, as the serial
round makes them).  The tree is then the flat sharded tree, the serial one,
bit for bit.  The vote forced at that k (``dcn_exhaustive`` off in the
``Sharding``) grows the flat tree's splits, thresholds and leaf counts; its
exact integer siblings part from the serial f32 ones in the last bits of
the leaf values (ROADMAP C19).  A smaller k is the PV-Tree approximation,
whose slice-domain sums no flat round holds.  The megakernel stays off
here, as in the JAX package (the three-pass round: B2 and B1's carried
mode).  The vote and the dcn merge live in ops/ (ops/treegrow.py::
dcn_topk_best, ops/histogram.py::dcn_merge), beside the voting learner's.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.histogram import owned_features
from ..ops.split import SplitParams
from ..ops.treegrow_windowed import Sharding, feature_block_tables, grow_tree_windowed
from .data_parallel import ShardedData
from .mesh import DCN_AXIS, ICI_AXIS, WORLD_AXIS, GridMesh, slice_axis_sizes


class SlicedData:
    """This rank's rows over the nested (dcn, ici) mesh (the JAX package's
    SlicedData): consecutive row blocks in rank order, slice-major (a
    slice's ranks hold consecutive blocks), with the per-feature tables;
    ``shard`` places them in the whole over the world axis."""

    def __init__(self, mesh: GridMesh, bins, num_bins_pf, missing_bin_pf, device=None):
        self._init(mesh, ShardedData(mesh.axes[WORLD_AXIS], bins, num_bins_pf,
                                     missing_bin_pf, device))

    @classmethod
    def from_sharded(cls, mesh: GridMesh, sharded: ShardedData) -> "SlicedData":
        """Over a flat ShardedData's tensors (no copy of the bins): the nested
        layout places the same row blocks on the same ranks."""
        self = cls.__new__(cls)
        self._init(mesh, sharded)
        return self

    def _init(self, mesh: GridMesh, sd: ShardedData) -> None:
        if sd.mesh.size != mesh.size:
            raise ValueError(f"the rows are sharded over {sd.mesh.size} ranks, the "
                             f"hierarchical mesh has {mesh.size}")
        self.mesh = mesh
        self.num_slices, self.ranks_per_slice = slice_axis_sizes(mesh)
        self.bins, self.num_bins_pf, self.missing_bin_pf = (
            sd.bins, sd.num_bins_pf, sd.missing_bin_pf)
        self.shard = sd.shard._replace(mesh=mesh.axes[WORLD_AXIS])


def hierarchical_sharding(sliced: SlicedData, merge: str, top_k: int, feature_mask,
                          categorical_mask=None, feature_contri=None) -> Sharding:
    """The windowed round's context over the nested mesh: ``merge`` inside
    slices (under "scatter" this rank's owned feature block and its
    tables), the dcn axis and ``top_k``; the top-k exchange searches below
    the exhaustive k only (module docstring)."""
    mesh = sliced.mesh
    ici, dcn = mesh.axes[ICI_AXIS], mesh.axes[DCN_AXIS]
    nbpf, mbpf = sliced.num_bins_pf, sliced.missing_bin_pf
    if merge == "scatter":
        f0, k, fp = owned_features(nbpf.shape[0], ici)
        tables = feature_block_tables(f0, k, fp, nbpf, mbpf, feature_mask,
                                      categorical_mask, feature_contri)
        kw = dict(f0=f0, tables=tables, own_mesh=ici)
    else:
        k, kw = nbpf.shape[0], {}
    return Sharding(sliced.shard, merge, hist_mesh=ici, dcn_mesh=dcn, top_k=top_k,
                    dcn_exhaustive=top_k >= k, **kw)


def grow_tree_windowed_hierarchical(
        sliced: SlicedData, grad, hess, row_mask, sample_weight, feature_mask,
        categorical_mask=None, generator: Optional[torch.Generator] = None,
        feature_contri=None, *, num_leaves: int, num_bins: int, max_depth: int = -1,
        params: SplitParams = SplitParams(), leaf_tile: int = 16,
        hist_precision: str = "f32", quantize_bins: int = 0,
        stochastic_rounding: bool = True, quant_renew: bool = False,
        merge: str = "psum", top_k_features: int = 32, stats: Optional[dict] = None,
        guard_label: str = ""):
    """The windowed rounds over the nested (dcn, ici) mesh: the exact merge
    ``merge`` ("psum" | "scatter") inside each slice, the top-k exchange
    between slices (module docstring).  (tree, this rank's leaf ids).
    Per-node feature sampling is refused for both merges: the slice-local
    vote must be the same on every slice."""
    if merge not in ("psum", "scatter"):
        raise ValueError(f"merge must be 'psum' or 'scatter', got {merge!r}")
    if params.feature_fraction_bynode < 1.0 or params.extra_trees:
        raise ValueError(
            "the hierarchical two-level merge is incompatible with per-node feature "
            "sampling (feature_fraction_bynode/extra_trees): the slice-local top-k "
            "vote must be deterministic and slice-consistent")
    if int(top_k_features) < 1:
        raise ValueError(f"top_k_features must be >= 1, got {top_k_features}")
    nbpf, mbpf = sliced.num_bins_pf, sliced.missing_bin_pf
    if feature_mask is None:
        feature_mask = torch.ones(nbpf.shape[0], dtype=torch.bool, device=sliced.bins.device)
    sh = hierarchical_sharding(sliced, merge, int(top_k_features), feature_mask,
                               categorical_mask, feature_contri)
    return grow_tree_windowed(
        sliced.bins, grad, hess, row_mask, sample_weight, feature_mask, nbpf, mbpf,
        num_leaves=num_leaves, num_bins=num_bins, max_depth=max_depth, params=params,
        leaf_tile=leaf_tile, quantize_bins=quantize_bins,
        stochastic_rounding=stochastic_rounding, quant_renew=quant_renew,
        generator=generator, stats=stats, guard_label=guard_label,
        megakernel_opt="0", hist_precision=hist_precision,
        categorical_mask=categorical_mask, feature_contri=feature_contri,
        sharding=sh)
