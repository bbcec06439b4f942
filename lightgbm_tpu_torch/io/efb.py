"""Exclusive Feature Bundling (EFB).

Copy of lightgbm_tpu/io/efb.py (numpy only): both packages must find the
same bundles and write the same bundled matrix, or their histogram passes
and leaf tiles part.  Reference: src/io/dataset_loader.cpp ->
DatasetLoader::FindGroups / FastFeatureBundling and the NeurIPS'17 LightGBM
paper, section 4.  Sparse, mutually exclusive features (one-hot blocks, for
example) are merged into single "bundle" columns so the histogram pass
scans F_b << F columns.

Bundling is host-side preprocessing that emits
  * a bundled bin matrix (N, F_b) whose bundle width is capped at the
    max_bin budget, so the histogram kernel keeps its shape (fewer
    columns, the same bins), and
  * gather/default tables that UNBUNDLE a bundle histogram back into
    per-original-feature histograms on the device
    (ops/histogram.py::unbundle_hists), so split search, tree structure,
    partitioning and prediction all stay in original-feature space
    (mirroring the reference, whose trees never reference bundles).

Bundle bin layout (zero-conflict, like the reference's exclusive bundles):
bin 0 = every member at its default (most frequent) bin; member j with nb_j
bins contributes nb_j - 1 slots at offset off_j, one per non-default bin in
ascending order.  A feature's default-bin histogram row is recovered as
leaf_total - sum(its non-default slots) -- the reference's most-freq-bin
subtraction trick.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np


class FeatureBundles(NamedTuple):
    bundles: List[List[int]]  # member original-feature ids per bundle
    bundled_bins: Optional[np.ndarray]  # (N, F_b) int32
    bundled_num_bins: np.ndarray  # (F_b,) int32
    gather_idx: np.ndarray  # (F, B) int32 into flat (F_b*B,) (+1 zero pad at F_b*B)
    default_mask: np.ndarray  # (F, B) bool — the default slot per feature
    num_bundled: int  # F_b
    default_bin: np.ndarray  # (F,) int32 — most frequent bin per feature

    @property
    def is_useful(self) -> bool:
        return self.num_bundled < len(self.gather_idx)


def apply_bundles(efb: "FeatureBundles", bins: np.ndarray,
                  num_bins_pf: np.ndarray) -> np.ndarray:
    """Re-bundle a (same-binner) bin matrix with an existing bundle plan —
    used when a dataset is constructed with reference= another dataset."""
    n = bins.shape[0]
    out = np.zeros((n, efb.num_bundled), np.int32)
    for g, members in enumerate(efb.bundles):
        if len(members) == 1:
            out[:, g] = bins[:, members[0]]
            continue
        off = 1
        col = np.zeros(n, np.int32)
        for j in members:
            nb = int(num_bins_pf[j])
            d = int(efb.default_bin[j])
            v = bins[:, j]
            nd = v != d
            col = np.where(nd, off + (v - (v > d)), col)
            off += nb - 1
        out[:, g] = col
    return out


def find_bundles(
    bins: np.ndarray,  # (N, F) int
    num_bins_pf: np.ndarray,  # (F,)
    max_total_bins: int,  # B — bundle capacity (kernel lane budget)
    categorical_mask: Optional[np.ndarray] = None,
    sample_cnt: int = 200_000,
    max_conflict_rate: float = 0.0,
    min_sparse_rate: float = 0.8,
    seed: int = 0,
) -> Optional[FeatureBundles]:
    """Greedy conflict-free bundling (reference: FindGroups' greedy graph
    coloring over the feature-conflict graph, conflict counts estimated on a
    row sample).  Returns None when bundling would not reduce the column
    count (dense data)."""
    n, f = bins.shape
    if f < 3:
        return None
    rng = np.random.RandomState(seed)
    if n > sample_cnt:
        rows = rng.choice(n, size=sample_cnt, replace=False)
        sample = bins[rows]
    else:
        sample = bins
    ns = sample.shape[0]

    # default (most frequent) bin per feature, estimated on the sample
    default_bin = np.zeros(f, np.int32)
    nondefault_cnt = np.zeros(f, np.int64)
    for j in range(f):
        bc = np.bincount(sample[:, j], minlength=int(num_bins_pf[j]))
        default_bin[j] = int(bc.argmax())
        nondefault_cnt[j] = ns - bc.max()

    sparse = nondefault_cnt <= ns * (1.0 - min_sparse_rate)
    if categorical_mask is not None:
        sparse &= ~np.asarray(categorical_mask, bool)
    if sparse.sum() < 2:
        return None

    # packed non-default masks for fast conflict counting
    nd_bits = {}
    for j in np.flatnonzero(sparse):
        nd_bits[j] = np.packbits(sample[:, j] != default_bin[j])

    max_conflicts = int(max_conflict_rate * ns)
    order = sorted(nd_bits, key=lambda j: -nondefault_cnt[j])
    bundle_members: List[List[int]] = []
    bundle_bits: List[np.ndarray] = []
    bundle_width: List[int] = []  # used slots incl. slot 0
    for j in order:
        w = int(num_bins_pf[j]) - 1  # non-default slots
        placed = False
        for g in range(len(bundle_members)):
            if bundle_width[g] + w > max_total_bins:
                continue
            conflicts = int(
                np.unpackbits(bundle_bits[g] & nd_bits[j])[:ns].sum()
            )
            if conflicts <= max_conflicts:
                bundle_members[g].append(j)
                bundle_bits[g] = bundle_bits[g] | nd_bits[j]
                bundle_width[g] += w
                placed = True
                break
        if not placed:
            bundle_members.append([j])
            bundle_bits.append(nd_bits[j].copy())
            bundle_width.append(1 + w)

    multi = [m for m in bundle_members if len(m) > 1]
    if not multi:
        return None

    # final bundle list: multi-member bundles first, then singletons for every
    # remaining feature (dense, categorical, or unplaced)
    in_multi = {j for m in multi for j in m}
    singles = [[j] for j in range(f) if j not in in_multi]
    bundles = multi + singles
    fb = len(bundles)
    # gather/table stride = the widest ACTUAL column (bundle or single
    # feature), not the packing capacity — capacity may be the full max_bin
    # budget while e.g. one-hot bundles pack far narrower, and this stride
    # becomes the dataset's histogram width
    B = max(
        max(
            (1 + sum(int(num_bins_pf[j]) - 1 for j in m)) if len(m) > 1
            else int(num_bins_pf[m[0]])
            for m in bundles
        ),
        1,
    )

    bundled_num_bins = np.zeros(fb, np.int32)
    gather_idx = np.full((f, B), fb * B, np.int64)  # default -> zero pad slot
    default_mask = np.zeros((f, B), bool)
    for g, members in enumerate(bundles):
        if len(members) == 1:
            j = members[0]
            nb = int(num_bins_pf[j])
            bundled_num_bins[g] = nb
            gather_idx[j, :nb] = g * B + np.arange(nb)
            continue
        off = 1
        for j in members:
            nb = int(num_bins_pf[j])
            d = int(default_bin[j])
            nd_bins = np.setdiff1d(np.arange(nb), [d])
            gather_idx[j, nd_bins] = g * B + off + np.arange(nb - 1)
            default_mask[j, d] = True
            off += nb - 1
        bundled_num_bins[g] = off

    plan = FeatureBundles(
        bundles=bundles,
        bundled_bins=None,
        bundled_num_bins=bundled_num_bins,
        gather_idx=gather_idx.astype(np.int32),
        default_mask=default_mask,
        num_bundled=fb,
        default_bin=default_bin,
    )
    # the bundled matrix is produced by the ONE shared encoder so plan
    # construction and reference-dataset re-bundling cannot drift
    return plan._replace(bundled_bins=apply_bundles(plan, bins, num_bins_pf))
