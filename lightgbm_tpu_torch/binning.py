"""Host-side feature binning.

Copy of lightgbm_tpu/binning.py (numpy only): the two packages must bin the
same data to bitwise-equal matrices, dense or sparse (CSC: ``fit_sparse``,
``transform_sparse``).

Re-design of the reference's binning layer
(reference: src/io/bin.cpp -> BinMapper::FindBin, GreedyFindBin;
include/LightGBM/bin.h -> MissingType).  Binning runs once on the host in
numpy; training then operates purely on the device-resident binned matrix
(uint8/int16), which is the TPU-first analogue of DenseBin.

Semantics preserved from the reference:
  * distinct-value fast path: if #distinct <= max_bin, one bin per value with
    boundaries at midpoints;
  * otherwise greedy equal-count binning honoring min_data_in_bin;
  * MissingType {None, Zero, NaN}: NaN values get their own bin placed LAST;
  * a dedicated zero bin when zero_as_missing=False but zeros dominate is not
    modelled separately (the quantile path handles it);
  * categorical: categories ordered by frequency, rare categories folded into
    bin 0 (reference: BinMapper categorical value->bin map).
  * real-valued split thresholds are reconstructed from bin upper bounds
    exactly as the reference does (Tree stores bin uppers so that the decision
    `value <= threshold` reproduces the binned decision `bin <= thr_bin`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

MISSING_NONE = 0
MISSING_ZERO = 1
MISSING_NAN = 2

_KZERO_THRESHOLD = 1e-35  # reference: bin.cpp kZeroThreshold


@dataclass
class BinMapper:
    """Per-feature value->bin mapping (reference: BinMapper in bin.cpp)."""

    upper_bounds: np.ndarray  # (num_non_missing_bins,) float64; last == +inf
    missing_type: int = MISSING_NONE
    is_categorical: bool = False
    categories: Optional[np.ndarray] = None  # category value per bin (categorical only)
    min_value: float = 0.0
    max_value: float = 0.0

    @property
    def num_bins(self) -> int:
        """Total bins including the trailing missing bin if present."""
        n = len(self.upper_bounds) if not self.is_categorical else len(self.categories)
        if self.missing_type != MISSING_NONE:
            n += 1
        return n

    @property
    def missing_bin(self) -> int:
        """Index of the missing bin (NaN bin, or the zero/NaN bin when
        zero_as_missing), or -1 when the feature has no missing stream."""
        if self.missing_type != MISSING_NONE:
            return self.num_bins - 1
        return -1

    @property
    def is_trivial(self) -> bool:
        return self.num_bins <= 1

    def transform(self, values: np.ndarray) -> np.ndarray:
        """Map raw values -> bin indices (vectorized)."""
        values = np.asarray(values, dtype=np.float64)
        if self.is_categorical:
            # categories[b] is the raw value for bin b: look each value up
            # among the sorted categories; NaN is looked up as -1.0, and a
            # value that is not a category (unseen, non-integer) takes bin 0
            cats = np.asarray(self.categories, dtype=np.float64)
            out = np.zeros(values.shape, dtype=np.int32)
            if len(cats):
                order = np.argsort(cats, kind="stable")
                key = np.where(np.isnan(values), -1.0, values)
                pos = np.minimum(np.searchsorted(cats[order], key), len(cats) - 1)
                out = np.where(cats[order][pos] == key, order[pos], 0).astype(np.int32)
            if self.missing_type == MISSING_NAN:
                out[np.isnan(values)] = self.missing_bin
            return out
        # bin = first index with value <= upper_bounds[bin]
        bins = np.searchsorted(self.upper_bounds, values, side="left").astype(np.int32)
        np.clip(bins, 0, len(self.upper_bounds) - 1, out=bins)
        if self.missing_type == MISSING_NAN:
            bins[np.isnan(values)] = self.missing_bin
        elif self.missing_type == MISSING_ZERO:
            # zero_as_missing: zeros AND NaNs share the missing bin (reference:
            # MissingType::Zero routes both to the default bin)
            bins[np.isnan(values) | (np.abs(values) <= _KZERO_THRESHOLD)] = self.missing_bin
        return bins

    def bin_to_threshold(self, bin_idx: int) -> float:
        """Real-valued threshold for `bin <= bin_idx -> left` (reference:
        BinMapper::BinToValue used by Tree::Split when recording thresholds)."""
        ub = float(self.upper_bounds[bin_idx])
        if np.isinf(ub):
            ub = float(np.finfo(np.float64).max)
        return ub


def _greedy_equal_count_bounds(
    sorted_values: np.ndarray, counts: np.ndarray, max_bin: int, min_data_in_bin: int, total_cnt: int
) -> np.ndarray:
    """Greedy equal-frequency boundaries over (distinct value, count) pairs
    (reference: bin.cpp GreedyFindBin).  Returns upper bounds (last = +inf)."""
    num_distinct = len(sorted_values)
    if num_distinct <= max_bin:
        # one bin per distinct value; but respect min_data_in_bin by merging
        bounds = []
        cur = 0
        cum = np.cumsum(counts)
        for i in range(num_distinct - 1):
            cur += counts[i]
            rest = total_cnt - cum[i]
            # close the bin only when it is full enough AND the remainder can
            # still fill a bin of its own (otherwise fold the tail in)
            if cur >= min_data_in_bin and rest >= min_data_in_bin:
                bounds.append((sorted_values[i] + sorted_values[i + 1]) / 2.0)
                cur = 0
        bounds.append(np.inf)
        return np.asarray(bounds, dtype=np.float64)
    # too many distinct values: equal-count greedy
    max_bin = max(1, max_bin)
    mean_bin_size = max(total_cnt / max_bin, float(min_data_in_bin))
    # values with huge count get their own bin
    is_big = counts >= mean_bin_size
    rest_cnt = total_cnt - counts[is_big].sum()
    rest_bins = max_bin - int(is_big.sum())
    if rest_bins > 0:
        mean_bin_size = max(rest_cnt / rest_bins, float(min_data_in_bin))
    bounds = []
    cur = 0.0
    for i in range(num_distinct - 1):
        cur += counts[i]
        if is_big[i] or cur >= mean_bin_size or (i + 1 < num_distinct and is_big[i + 1] and cur > 0):
            bounds.append((sorted_values[i] + sorted_values[i + 1]) / 2.0)
            cur = 0.0
            if len(bounds) >= max_bin - 1:
                break
    bounds.append(np.inf)
    return np.unique(np.asarray(bounds, dtype=np.float64))


def find_bin(
    values: np.ndarray,
    max_bin: int = 255,
    min_data_in_bin: int = 3,
    use_missing: bool = True,
    zero_as_missing: bool = False,
    is_categorical: bool = False,
    min_data_per_group: int = 100,
    forced_bounds: Sequence[float] = (),
    num_implicit_zeros: int = 0,
) -> BinMapper:
    """Construct a BinMapper from (a sample of) one feature's values
    (reference: BinMapper::FindBin in src/io/bin.cpp).

    num_implicit_zeros: count of exact-0.0 values NOT present in `values` —
    the sparse-ingestion path passes only a column's stored (nonzero) entries
    plus this count, mirroring the reference's FindBin(total_sample_cnt >
    len(values)) contract for SparseBin construction."""
    values = np.asarray(values, dtype=np.float64).ravel()
    nan_mask = np.isnan(values)
    has_nan = bool(nan_mask.any())

    if is_categorical:
        clean = values[~nan_mask].astype(np.int64)
        cats, counts = np.unique(clean, return_counts=True)
        if num_implicit_zeros > 0:
            zi = np.searchsorted(cats, 0)
            if zi < len(cats) and cats[zi] == 0:
                counts = counts.copy()
                counts[zi] += num_implicit_zeros
            else:
                cats = np.insert(cats, zi, 0)
                counts = np.insert(counts, zi, num_implicit_zeros)
        order = np.argsort(-counts, kind="stable")
        cats, counts = cats[order], counts[order]
        # cap category count at max_bin (rare cats fold to the most frequent bin 0)
        cats = cats[:max_bin]
        missing_type = MISSING_NAN if (use_missing and has_nan) else MISSING_NONE
        return BinMapper(
            upper_bounds=np.asarray([np.inf]),
            missing_type=missing_type,
            is_categorical=True,
            categories=cats.astype(np.float64),
            min_value=float(cats.min()) if len(cats) else 0.0,
            max_value=float(cats.max()) if len(cats) else 0.0,
        )

    if zero_as_missing and use_missing:
        # zeros (and NaN) both become the missing value stream — implicit
        # (sparse-stored) zeros join it too
        zero_mask = np.abs(values) <= _KZERO_THRESHOLD
        nan_mask = nan_mask | zero_mask
        has_nan = bool(nan_mask.any()) or num_implicit_zeros > 0
        missing_type = MISSING_ZERO if has_nan else MISSING_NONE
        num_implicit_zeros = 0
    else:
        missing_type = MISSING_NAN if (use_missing and has_nan) else MISSING_NONE

    clean = values[~nan_mask]
    if len(clean) == 0 and num_implicit_zeros == 0:
        return BinMapper(upper_bounds=np.asarray([np.inf]), missing_type=missing_type)

    sorted_vals, counts = np.unique(clean, return_counts=True)
    if num_implicit_zeros > 0:
        zi = np.searchsorted(sorted_vals, 0.0)
        if zi < len(sorted_vals) and sorted_vals[zi] == 0.0:
            counts = counts.copy()
            counts[zi] += num_implicit_zeros
        else:
            sorted_vals = np.insert(sorted_vals, zi, 0.0)
            counts = np.insert(counts, zi, num_implicit_zeros)
    n_avail = max_bin - (1 if missing_type != MISSING_NONE else 0)
    n_avail = max(n_avail, 1)
    if len(forced_bounds):
        # forced bin boundaries from forcedbins_filename (reference:
        # bin.cpp BinMapper::FindBin forced_upper_bounds / DatasetLoader's
        # forced-bins JSON): the listed bounds become boundaries verbatim
        # and the remaining budget is filled greedily.
        forced = np.unique(np.asarray(forced_bounds, dtype=np.float64))
        forced = forced[: n_avail - 1]
        rest = max(n_avail - len(forced), 1)
        greedy = _greedy_equal_count_bounds(
            sorted_vals, counts, rest, min_data_in_bin, total_cnt=int(counts.sum())
        )
        bounds = np.unique(np.concatenate([forced, greedy]))
        if len(bounds) > n_avail:
            # keep all forced bounds + the largest greedy ones (incl. +inf)
            extra = np.setdiff1d(bounds, forced)[-(n_avail - len(forced)):]
            bounds = np.unique(np.concatenate([forced, extra]))
        if not np.isinf(bounds[-1]):
            bounds = np.append(bounds, np.inf)
    else:
        bounds = _greedy_equal_count_bounds(
            sorted_vals, counts, n_avail, min_data_in_bin, total_cnt=int(counts.sum())
        )
    mapper = BinMapper(
        upper_bounds=bounds,
        missing_type=MISSING_NAN if missing_type == MISSING_NAN else missing_type,
        min_value=float(sorted_vals[0]),
        max_value=float(sorted_vals[-1]),
    )
    return mapper


@dataclass
class DatasetBinner:
    """All-features binner; produces the device-ready binned matrix.

    TPU-first layout decision: the binned matrix is a dense (N, F) int array
    padded to a uniform per-dataset max bin count, which keeps histogram
    scatter indices affine (f * B + bin) — the analogue of the reference's
    FeatureGroup bin offsets (src/io/feature_group.h) without ragged groups.
    """

    mappers: List[BinMapper] = field(default_factory=list)

    @property
    def num_features(self) -> int:
        return len(self.mappers)

    @property
    def max_num_bins(self) -> int:
        return max((m.num_bins for m in self.mappers), default=1)

    @property
    def num_bins_per_feature(self) -> np.ndarray:
        return np.asarray([m.num_bins for m in self.mappers], dtype=np.int32)

    @property
    def missing_bin_per_feature(self) -> np.ndarray:
        return np.asarray([m.missing_bin for m in self.mappers], dtype=np.int32)

    @property
    def categorical_mask(self) -> np.ndarray:
        return np.asarray([m.is_categorical for m in self.mappers], dtype=bool)

    @classmethod
    def fit(
        cls,
        data: np.ndarray,
        max_bin: int = 255,
        min_data_in_bin: int = 3,
        sample_cnt: int = 200000,
        use_missing: bool = True,
        zero_as_missing: bool = False,
        categorical_features: Sequence[int] = (),
        max_bin_by_feature: Sequence[int] = (),
        seed: int = 1,
        forced_bins: Optional[dict] = None,
    ) -> "DatasetBinner":
        data = np.asarray(data, dtype=np.float64)
        n, f = data.shape
        if n > sample_cnt:
            rng = np.random.RandomState(seed)
            idx = rng.choice(n, size=sample_cnt, replace=False)
            sample = data[idx]
        else:
            sample = data
        cats = set(int(c) for c in categorical_features)
        forced_bins = forced_bins or {}
        mappers = []
        for j in range(f):
            mb = int(max_bin_by_feature[j]) if len(max_bin_by_feature) == f else max_bin
            mappers.append(
                find_bin(
                    sample[:, j],
                    max_bin=mb,
                    min_data_in_bin=min_data_in_bin,
                    use_missing=use_missing,
                    zero_as_missing=zero_as_missing,
                    is_categorical=j in cats,
                    forced_bounds=forced_bins.get(j, ()),
                )
            )
        return cls(mappers=mappers)

    def transform(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, dtype=np.float64)
        n, f = data.shape
        assert f == self.num_features, (f, self.num_features)
        dtype = np.uint8 if self.max_num_bins <= 256 else np.int32
        out = np.empty((n, f), dtype=dtype)
        for j, m in enumerate(self.mappers):
            out[:, j] = m.transform(data[:, j]).astype(dtype)
        return out

    @classmethod
    def fit_sparse(
        cls,
        csc,  # scipy.sparse CSC matrix
        max_bin: int = 255,
        min_data_in_bin: int = 3,
        sample_cnt: int = 200000,
        use_missing: bool = True,
        zero_as_missing: bool = False,
        categorical_features: Sequence[int] = (),
        max_bin_by_feature: Sequence[int] = (),
        seed: int = 1,
        forced_bins: Optional[dict] = None,
    ) -> "DatasetBinner":
        """Fit bin mappers from a CSC matrix WITHOUT densifying (reference:
        DatasetLoader::ConstructBinMappersFromSampleData over SparseBin
        columns — stored nonzeros plus an implicit-zero count per feature)."""
        n, f = csc.shape
        if n > sample_cnt:
            rng = np.random.RandomState(seed)
            idx = np.sort(rng.choice(n, size=sample_cnt, replace=False))
            csc = csc[idx]
            n = sample_cnt
        cats = set(int(c) for c in categorical_features)
        forced_bins = forced_bins or {}
        indptr, data = csc.indptr, csc.data
        mappers = []
        for j in range(f):
            vals = np.asarray(data[indptr[j]:indptr[j + 1]], np.float64)
            mb = int(max_bin_by_feature[j]) if len(max_bin_by_feature) == f else max_bin
            mappers.append(
                find_bin(
                    vals,
                    max_bin=mb,
                    min_data_in_bin=min_data_in_bin,
                    use_missing=use_missing,
                    zero_as_missing=zero_as_missing,
                    is_categorical=j in cats,
                    forced_bounds=forced_bins.get(j, ()),
                    num_implicit_zeros=int(n - len(vals)),
                )
            )
        return cls(mappers=mappers)

    def transform_sparse(self, csc) -> np.ndarray:
        """CSC matrix -> dense BINNED (N, F) uint8/int32 — the raw float
        matrix is never materialized (the binned matrix is 8x smaller than
        a float64 densify and is the layout training uses anyway)."""
        n, f = csc.shape
        assert f == self.num_features, (f, self.num_features)
        dtype = np.uint8 if self.max_num_bins <= 256 else np.int32
        out = np.empty((n, f), dtype=dtype)
        indptr, indices, data = csc.indptr, csc.indices, csc.data
        for j, m in enumerate(self.mappers):
            zero_bin = int(m.transform(np.zeros(1))[0])
            out[:, j] = zero_bin
            lo, hi = indptr[j], indptr[j + 1]
            if hi > lo:
                out[indices[lo:hi], j] = m.transform(
                    np.asarray(data[lo:hi], np.float64)
                ).astype(dtype)
        return out
