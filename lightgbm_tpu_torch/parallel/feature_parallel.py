"""Feature-parallel tree learning over torch.distributed ranks.

Counterpart of lightgbm_tpu/parallel/feature_parallel.py (reference:
src/treelearner/feature_parallel_tree_learner.cpp): every rank holds all
rows, the features are split into R blocks (padded to a multiple of R with
one-bin columns that can never split), each rank finds the best split of
its block, the winner is elected (max gain, then the lowest rank) and
broadcast, and the owner's go-left bits are broadcast (ops/treegrow.py,
parallel_mode="feature").  A rank's histograms of its features are the
serial ones (same rows, same exponents), and the election keeps the
serial argmax's first maximum, so the tree is the serial tree bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.split import SplitParams
from ..ops.treegrow import grow_tree
from .mesh import Mesh, RowShard


class FeatureShardedData:
    """All rows, this rank's block of feature columns: bins (N, k) int16,
    global features f0 .. f0 + k - 1, the tables of the block."""

    def __init__(self, mesh: Mesh, bins, num_bins_pf, missing_bin_pf, device=None):
        self.mesh = mesh
        bins = bins if torch.is_tensor(bins) else torch.as_tensor(np.asarray(bins))
        dev = torch.device(device) if device is not None else bins.device
        n, f = bins.shape
        self.num_feature = f
        self.k = -(-f // mesh.size)
        self.padded_f = self.k * mesh.size
        self.f0 = mesh.rank * self.k
        cols = [c for c in range(self.f0, self.f0 + self.k)]
        real = [c for c in cols if c < f]
        blk = torch.zeros((n, self.k), dtype=torch.int16, device=dev)
        if real:
            blk[:, :len(real)] = bins[:, real[0]:real[-1] + 1].to(device=dev,
                                                                   dtype=torch.int16)
        self.bins = blk.contiguous()
        self.num_bins_pf = self.pad_features(num_bins_pf, 1, dev, torch.int32)
        self.missing_bin_pf = self.pad_features(missing_bin_pf, -1, dev, torch.int32)
        self.shard = RowShard(mesh, 0, n, f)

    def pad_features(self, arr, fill, device=None, dtype=None):
        """This rank's block of a per-feature table (pads take ``fill``)."""
        if arr is None:
            return None
        t = arr if torch.is_tensor(arr) else torch.as_tensor(np.asarray(arr))
        t = t.to(device=device if device is not None else self.bins.device,
                 dtype=dtype if dtype is not None else t.dtype)
        pad = self.padded_f - self.num_feature
        if pad:
            t = torch.cat([t, torch.full((pad,) + tuple(t.shape[1:]), fill,
                                         dtype=t.dtype, device=t.device)])
        return t[self.f0:self.f0 + self.k].contiguous()

    def pad_last(self, arr, fill):
        """This rank's block of a table whose LAST dim is the features
        (interaction sets (S, F), node uniforms (2L-1, 2, F))."""
        if arr is None:
            return None
        return self.pad_features(arr.movedim(-1, 0), fill).movedim(0, -1).contiguous()


def grow_tree_feature_parallel(fsd: FeatureShardedData, grad, hess, row_mask,
                               sample_weight, feature_mask, categorical_mask=None,
                               monotone_constraints=None, interaction_sets=None,
                               rng_key=None, feature_contri=None, *,
                               num_leaves: int, num_bins: int, max_depth: int = -1,
                               params: SplitParams = SplitParams(),
                               monotone_method: str = "basic", stats=None,
                               cegb_feature_penalty=None, track_path: bool = False):
    """Feature-parallel growth: the same tree on every rank, leaf ids of
    all rows.  The per-feature tables are full width here and cut to this
    rank's block; split_feature comes out global."""
    dev = fsd.bins.device
    return grow_tree(
        fsd.bins, grad, hess, row_mask, sample_weight,
        fsd.pad_features(feature_mask, False, dev, torch.bool),
        fsd.num_bins_pf, fsd.missing_bin_pf, num_leaves=num_leaves,
        num_bins=num_bins, max_depth=max_depth, params=params, stats=stats,
        categorical_mask=fsd.pad_features(categorical_mask, False, dev),
        feature_contri=fsd.pad_features(feature_contri, 1.0, dev),
        monotone_constraints=fsd.pad_features(monotone_constraints, 0, dev),
        interaction_sets=fsd.pad_last(interaction_sets, False),
        rng_key=fsd.pad_last(rng_key, 1.0),
        cegb_feature_penalty=fsd.pad_features(cegb_feature_penalty, 0.0, dev),
        track_path=track_path, monotone_method=monotone_method,
        axis_name=fsd.shard, parallel_mode="feature")[:2]
