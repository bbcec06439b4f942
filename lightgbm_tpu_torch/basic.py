"""Dataset and Booster.

Counterpart of lightgbm_tpu/basic.py (reference:
python-package/lightgbm/basic.py).  A Dataset is binned on the host
(binning.py, bitwise the JAX package's bins) and shipped to the device as an
(N, F) int16 matrix; a Booster wraps models/gbdt.py.

Data arrives as numpy arrays, nested lists, pandas frames (category columns
as their codes), pyarrow tables (dictionary columns as their codes), scipy
sparse matrices (binned straight from CSC, never densified), Sequence_
sources, or a file path: CSV, TSV or LibSVM text (io/parser.py: one round
through the native loader, or ``two_round`` streaming that never holds the
raw floats), or a save_binary bin cache (io/stream.py, the JAX package's
format).  ``forcedbins_filename`` forces bin bounds.

Exclusive Feature Bundling (``enable_bundle``, on by default as in the JAX
package; io/efb.py) plans bundles on the binned matrix; the growers'
histogram passes then read the bundled (N, F_b) matrix
(``efb_device_tables``) and everything else stays in feature space.

``out_of_core`` streams the binned matrix in row chunks (from a
save_binary cache without ever holding it on the host, or from the binned
array): with ``max_rows_in_hbm`` at or above the rows (or 0) the chunks
assemble the device matrix and every grower runs on it unchanged (the
resident regime); below, the matrix never lies on the device and training
takes the chunk-streamed spill grower (ops/treegrow_ooc.py).  EFB is not
planned out of core (its passes scan the whole host matrix).

Distributed runs (tree_learner=data or voting over several ranks,
``pre_partition``): each rank's Dataset holds its rows, and the bin
boundaries come from the serial run's sample of the whole
(``_sync_binning_sample``), so every rank bins as the serial run does;
``bin_cache_shard=(lo, hi)`` reads rows [lo, hi) of a shared save_binary
cache.  ``Booster.set_network`` / ``free_network`` bring the process group
up and down (parallel/distributed.py).  ``predict(mesh=)`` scores the
rows over several devices of this process (parallel/mesh.py::
make_device_mesh) or over the ranks of a process group, bitwise
``predict``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

import torch.distributed as dist

from .binning import BinMapper, DatasetBinner
from .config import Config
from .io.efb import apply_bundles, find_bundles
from .io.parser import load_data_file, load_data_file_two_round
from .io.stream import (DEFAULT_CHUNK_ROWS, array_chunks, create_bin_cache,
                        is_bin_cache, prefetch_device, read_bin_cache, read_cache_meta,
                        read_cache_shard)
from .models.gbdt import GBDT, _pre_filter, create_boosting, tree_depth
from .models.tree import Tree
from .obs import trace as _trace
from .ops import predict as predict_ops
from .utils import checkpoint as _checkpoint


class LightGBMError(Exception):
    """reference: LightGBMError in python-package/lightgbm/basic.py."""


class CorruptModelError(LightGBMError):
    """A model or snapshot file failed integrity verification (torn write,
    truncation, bit rot).  engine.train catches it to fall back to the
    newest valid older snapshot (utils/checkpoint.py)."""


def _is_scipy_sparse(data) -> bool:
    return hasattr(data, "tocsr") and hasattr(data, "toarray")


def _to_2d_float(data, keep_f32: bool = False) -> np.ndarray:
    """numpy arrays, nested lists, pandas frames (categorical columns as
    their codes), pyarrow tables, scipy sparse matrices and Sequence_
    sources -> (N, F) float64 (the JAX package's _to_2d_float).
    ``keep_f32``: a float32 numpy array is returned as it is (its float64
    values are the same; the binner converts what it reads)."""
    if keep_f32 and isinstance(data, np.ndarray) and data.dtype == np.float32:
        return data.reshape(-1, 1) if data.ndim == 1 else data
    if isinstance(data, (str, os.PathLike)):
        raise TypeError(f"{os.fspath(data)!r}: a file is read by Dataset, not "
                        "passed as rows")
    if isinstance(data, Sequence_):
        data = _from_sequences([data])
    elif isinstance(data, list) and data and isinstance(data[0], Sequence_):
        data = _from_sequences(data)
    if hasattr(data, "dtypes") and hasattr(data, "columns"):  # pandas frame
        import pandas as pd  # local: pandas is optional

        cols = []
        for c in data.columns:
            col = data[c]
            if isinstance(col.dtype, pd.CategoricalDtype):
                codes = col.cat.codes.to_numpy().astype(np.float64)
                codes[codes < 0] = np.nan  # NA category -> missing
                cols.append(codes)
            else:
                cols.append(col.to_numpy(dtype=np.float64, na_value=np.nan))
        return np.stack(cols, axis=1)
    if hasattr(data, "schema") and hasattr(data, "column"):  # pyarrow
        return _arrow_to_2d(data)
    if hasattr(data, "values"):  # pandas series
        data = data.values
    if _is_scipy_sparse(data):
        data = data.toarray()
    arr = np.asarray(data, dtype=np.float64)
    return arr.reshape(-1, 1) if arr.ndim == 1 else arr


def _arrow_to_2d(data) -> np.ndarray:
    """pyarrow Table or RecordBatch -> (N, F) float64, a column at a time
    (reference: include/LightGBM/arrow.h): nulls become NaN, booleans 0/1,
    dictionary columns their integer codes (after unifying the chunks'
    dictionaries)."""
    import pyarrow as pa  # local: pyarrow is optional

    def chunk_values(chunk) -> np.ndarray:
        t = chunk.type
        if isinstance(t, pa.DictionaryType):
            return chunk.indices.cast(pa.float64()).to_numpy(zero_copy_only=False)
        if pa.types.is_boolean(t) or chunk.null_count:
            return chunk.cast(pa.float64()).to_numpy(zero_copy_only=False)
        return np.asarray(chunk, dtype=np.float64)

    cols = []
    for i in range(data.num_columns):
        col = data.column(i)
        if isinstance(col.type, pa.DictionaryType) and getattr(col, "num_chunks", 1) > 1:
            col = col.unify_dictionaries()
        chunks = col.chunks if hasattr(col, "chunks") else [col]
        cols.append(np.concatenate([chunk_values(c) for c in chunks]) if chunks
                    else np.zeros(0, np.float64))
    return np.stack(cols, axis=1) if cols else np.zeros((data.num_rows, 0))


class Sequence_:
    """A source of rows read in batches (reference: lightgbm.Sequence):
    subclass with __len__ and __getitem__ (a row slice -> array);
    ``batch_size`` rows are read at a time."""

    batch_size = 65536

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, idx):  # pragma: no cover - abstract
        raise NotImplementedError


def _from_sequences(seqs) -> np.ndarray:
    chunks = []
    for seq in seqs:
        n = len(seq)
        bs = max(int(getattr(seq, "batch_size", 65536)), 1)
        for lo in range(0, n, bs):
            chunk = np.asarray(seq[slice(lo, min(lo + bs, n))], np.float64)
            # a 1-D slice is a batch of one-feature rows
            chunks.append(chunk.reshape(-1, 1) if chunk.ndim == 1 else chunk)
    return np.concatenate(chunks, axis=0)


def _feature_names_of(data, num_features: int) -> List[str]:
    if hasattr(data, "schema") and hasattr(data, "column"):  # pyarrow
        return [str(n) for n in data.schema.names]
    if hasattr(data, "columns"):
        return [str(c) for c in data.columns]
    return [f"Column_{i}" for i in range(num_features)]


def _forced_bins(cfg: Config) -> Optional[Dict[int, List[float]]]:
    """forcedbins_filename's JSON, [{"feature": i, "bin_upper_bound":
    [...]}], as {feature: bounds} (reference: DatasetLoader)."""
    if not cfg.forcedbins_filename:
        return None
    with open(cfg.forcedbins_filename) as fh:
        return {int(e["feature"]): [float(v) for v in e["bin_upper_bound"]]
                for e in json.load(fh)}


def _check_finite(name: str, v) -> None:
    if v is not None and not np.all(np.isfinite(v)):
        raise ValueError(f"{name} contains non-finite values")


def _pre_partition_mesh(cfg):
    """The mesh over whose ranks this rank's Dataset holds its row block of
    a distributed training (pre_partition over more than one rank), or
    None: the world under data and voting; under feature2d the data axis
    of the 2-D mesh (the ranks of one row block hold the same rows), or
    the world where num_feature_shards does not divide it
    (models/gbdt.py::_set_learner makes the same choice)."""
    if not (bool(cfg.pre_partition) and dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return None
    from .parallel.mesh import DATA_AXIS, make_mesh, make_mesh_2d

    world = dist.get_world_size()
    d_f = max(int(cfg.num_feature_shards), 1)
    if cfg.tree_learner == "feature2d" and d_f > 1 and world % d_f == 0:
        return make_mesh_2d(world // d_f, d_f).axes[DATA_AXIS]
    if cfg.tree_learner in ("data", "voting", "feature2d"):
        return make_mesh()
    return None


def _rank_gather(rows: np.ndarray, device, mesh) -> np.ndarray:
    """Every rank's rows of ``mesh`` (float64), concatenated in rank order."""
    from .parallel import collectives as C

    t = torch.as_tensor(np.ascontiguousarray(rows, np.float64), device=device)
    return C.all_gather_ragged(t, mesh).cpu().numpy()


def _sync_binning_sample(local: np.ndarray, target_cnt: int, seed: int,
                         device, mesh=None) -> np.ndarray:
    """A pre-partitioned rank's sample for the bin boundaries (reference:
    DatasetLoader's distributed bin sync; the JAX package's
    _sync_binning_sample): the serial run's sample of the whole, the rows
    DatasetBinner.fit would draw from all N (ranks hold consecutive row
    blocks in rank order), each rank contributing its part of it.  Every
    rank fits the serial binner.  ``mesh``: the ranks holding the blocks
    (the default world by default)."""
    from .parallel import collectives as C
    from .parallel.mesh import make_mesh

    mesh = make_mesh() if mesh is None else mesh
    n = local.shape[0]
    lens = C.all_gather(torch.tensor([n], dtype=torch.int64, device=device), mesh)
    lens = [int(v) for v in lens.cpu()]
    total, off = sum(lens), sum(lens[:mesh.rank])
    if total > target_cnt:
        idx = np.random.RandomState(seed).choice(total, size=target_cnt, replace=False)
        mine = np.sort(idx[(idx >= off) & (idx < off + n)]) - off
    else:
        mine = np.arange(n)
    rows = local[mine]
    if hasattr(rows, "toarray"):  # sparse: the sampled rows only, densified
        rows = rows.toarray()
    return _rank_gather(np.asarray(rows, np.float64), device, mesh)


class Dataset:
    """reference: class Dataset in python-package/lightgbm/basic.py.
    Lazily constructed: raw data is held until `construct()`, which the
    training entry calls."""

    # out-of-core residency (construct): streamed, spilled, rows a chunk
    ooc = False
    ooc_spill = False
    ooc_chunk_rows = 0
    _ooc_stream = None
    _staging = None

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List[int]] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True, position=None):
        self.data = data
        self.label = None if label is None else np.asarray(label, dtype=np.float64).ravel()
        self.reference = reference
        self.weight = None if weight is None else np.asarray(weight, dtype=np.float64).ravel()
        # query sizes in row order (ranking objectives and metrics)
        self.group = None if group is None else np.asarray(group, dtype=np.int64).ravel()
        # each row's display position (LambdaRank position bias)
        self.position = (None if position is None
                         else np.asarray(position, dtype=np.int64).ravel())
        # (N,) or, for K trees an iteration, (N, K) or N * K row-major
        self.init_score = None if init_score is None else np.asarray(init_score, dtype=np.float64)
        self.params = dict(params or {})
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.free_raw_data = free_raw_data
        self._constructed = False
        self.binner: Optional[DatasetBinner] = None
        self.bins: Optional[np.ndarray] = None
        self.feature_names: List[str] = []
        self.efb = None  # the EFB plan (io/efb.py::FeatureBundles), if any
        self._efb_device = None
        # (N, F) f32 raw values on the device, kept for linear trees
        self.raw_device: Optional[torch.Tensor] = None

    def construct(self, reference: Optional["Dataset"] = None,
                  device: Optional[torch.device] = None) -> "Dataset":
        """Bin on the host and upload the (N, F) int16 matrix to ``device``
        (default: the one the parameters' device_type names); plan the EFB
        bundles (the train set; a reference= set takes its reference's)."""
        if self._constructed:
            return self
        from .models.gbdt import resolve_device

        ref = reference if reference is not None else self.reference
        cfg = Config.from_dict(self.params)
        device = device if device is not None else resolve_device(cfg)
        if ref is not None:
            ref.construct(device=device)
        pre_binner = pre_bins = None
        if isinstance(self.data, (str, os.PathLike)):
            pre_binner, pre_bins = self._load_file(os.fspath(self.data), cfg, ref)
        for name in ("label", "weight", "init_score"):
            _check_finite(name, getattr(self, name))
        # sparse input is binned straight from CSC (stored nonzeros plus an
        # implicit-zero count), never as dense raw floats
        csc = raw = None
        stream = self._ooc_stream
        if stream is not None:
            f = stream.shape[1]
        elif pre_bins is not None:
            f = pre_bins.shape[1]
        elif _is_scipy_sparse(self.data) and cfg.is_enable_sparse:
            csc = self.data.tocsc()
            f = csc.shape[1]
        else:
            raw = _to_2d_float(self.data, keep_f32=True)
            f = raw.shape[1]
        self.feature_names = (list(self.feature_name)
                              if isinstance(self.feature_name, (list, tuple))
                              else _feature_names_of(self.data, f))
        if pre_binner is not None:
            self.binner = pre_binner
        elif ref is not None:
            self.binner = ref.binner  # bin alignment with the reference set
        else:
            fit = dict(max_bin=cfg.max_bin, min_data_in_bin=cfg.min_data_in_bin,
                       sample_cnt=cfg.bin_construct_sample_cnt,
                       use_missing=cfg.use_missing, zero_as_missing=cfg.zero_as_missing,
                       categorical_features=self._categorical_indices(self.feature_names),
                       max_bin_by_feature=cfg.max_bin_by_feature,
                       seed=cfg.data_random_seed, forced_bins=_forced_bins(cfg))
            mesh = _pre_partition_mesh(cfg)
            if mesh is not None:
                # this rank's rows only: the serial run's sample of the whole
                sample = _sync_binning_sample(csc.tocsr() if csc is not None else raw,
                                              cfg.bin_construct_sample_cnt,
                                              cfg.data_random_seed, device, mesh)
                self.binner = DatasetBinner.fit(sample, **dict(
                    fit, sample_cnt=max(len(sample), 1)))
            else:
                self.binner = (DatasetBinner.fit_sparse(csc, **fit) if csc is not None
                               else DatasetBinner.fit(raw, **fit))
        if stream is not None:
            bins = None  # streamed from the cache, never held on the host
        elif pre_bins is not None:
            bins = pre_bins
        elif csc is not None:
            bins = self.binner.transform_sparse(csc)
        else:
            # on the card when the Dataset's device is (A25: set-up time)
            bins = self.binner.transform(raw, device=device)
        n = stream.shape[0] if stream is not None else bins.shape[0]
        if self.group is not None and int(self.group.sum()) != n:
            raise ValueError(f"group sizes sum to {int(self.group.sum())}, "
                             f"but the data has {n} rows")
        # EFB (reference: DatasetLoader::FindGroups / FastFeatureBundling):
        # a reference= set keeps its reference's plan (its bundled matrix is
        # encoded only if a grower asks for it)
        self.efb = None
        if ref is not None:
            if ref.efb is not None:
                self.efb = ref.efb._replace(bundled_bins=None)
        elif cfg.enable_bundle and not cfg.out_of_core:
            # (out of core: the bundling passes would scan the whole host
            # matrix, which the streamed path never holds)
            # the capacity is the whole max_bin budget, so one-hot blocks of
            # 2-bin features pack up to max_bin members a bundle
            self.efb = find_bundles(
                bins, self.binner.num_bins_per_feature,
                max(self.binner.max_num_bins, int(cfg.max_bin) + 1),
                categorical_mask=np.asarray(self.binner.categorical_mask),
                seed=cfg.data_random_seed)
        self.ooc = bool(cfg.out_of_core)
        if self.ooc:
            self.ooc_chunk_rows = int(cfg.out_of_core_chunk_rows) or min(
                DEFAULT_CHUNK_ROWS, n)
            self.ooc_spill = 0 < int(cfg.max_rows_in_hbm) < n
        self._set_bins(bins, device)
        self._num_data, self._num_feature = n, f
        if cfg.linear_tree or (ref is not None and ref.raw_device is not None):
            # linear trees fit and score on raw values (reference:
            # linear_tree_learner.cpp keeps a raw-data view)
            if raw is None:
                raise LightGBMError(
                    "linear_tree requires dense raw feature values; pass "
                    "is_enable_sparse=False (sparse input) or disable "
                    "two_round (file streaming) to materialize them")
            self.raw_device = torch.as_tensor(raw.astype(np.float32), device=device)
        if self.free_raw_data:
            self.data = None
        self._constructed = True
        return self

    def _categorical_indices(self, names: List[str]) -> List[int]:
        if not isinstance(self.categorical_feature, (list, tuple)):
            return []
        return [names.index(c) if isinstance(c, str) else int(c)
                for c in self.categorical_feature]

    def _load_file(self, path: str, cfg: Config, ref: Optional["Dataset"]):
        """A file path's rows: a save_binary cache (binner and bins), a
        two-round text load (binner and bins, the raw floats never held)
        or a one-round text load (the raw floats, into ``self.data``).  Its
        label, weight, group, init_score, position and feature names fill
        what the caller did not give.  Returns (binner, bins) or (None,
        None)."""
        binner = bins = None
        cols = dict(header=bool(cfg.header), label_column=cfg.label_column,
                    weight_column=cfg.weight_column, group_column=cfg.group_column,
                    ignore_column=cfg.ignore_column)
        shard = self.params.get("bin_cache_shard")
        if shard is not None:
            if not is_bin_cache(path) or cfg.out_of_core:
                raise ValueError("bin_cache_shard reads rows of a save_binary cache "
                                 "into memory (not out_of_core)")
            lo, hi = int(shard[0]), int(shard[1])
            if len(shard) > 2 and int(shard[2]) not in (0, hi - lo):
                raise ValueError("bin_cache_shard takes no padding: a rank holds "
                                 "exactly its rows")
            meta = read_cache_meta(path)
            if meta.get("group") is not None:
                raise ValueError("bin_cache_shard does not take grouped (ranking) "
                                 "caches: shard boundaries would cut queries")
            binner = DatasetBinner(mappers=[BinMapper(**m) for m in meta["mappers"]])
            bins = read_cache_shard(path, lo, hi)
            loaded = {k: (None if v is None else np.asarray(v)[lo:hi])
                      for k, v in meta.items()
                      if k in ("label", "weight", "init_score", "position")}
            loaded["feature_names"] = meta["feature_names"]
        elif is_bin_cache(path) and cfg.out_of_core:
            loaded = read_cache_meta(path)  # the matrix streams (construct)
            binner = DatasetBinner(mappers=[BinMapper(**m) for m in loaded["mappers"]])
            self._ooc_stream = loaded["stream"]
        elif is_bin_cache(path):
            loaded = read_bin_cache(path)
            binner = DatasetBinner(mappers=[BinMapper(**m) for m in loaded["mappers"]])
            bins = loaded["bins"]
        elif cfg.two_round:
            if ref is not None:
                def factory(sample, names):
                    return ref.binner
            else:
                def factory(sample, names):
                    mesh = _pre_partition_mesh(cfg)
                    if mesh is not None:
                        # every rank's reservoir sample of its rows (the JAX
                        # package's), so every rank fits the same boundaries
                        per = max(cfg.bin_construct_sample_cnt // mesh.size, 1)
                        sample = _rank_gather(np.asarray(sample, np.float64)[:per],
                                              resolve_device(cfg), mesh)
                    return DatasetBinner.fit(
                        sample, max_bin=cfg.max_bin, min_data_in_bin=cfg.min_data_in_bin,
                        sample_cnt=len(sample), use_missing=cfg.use_missing,
                        zero_as_missing=cfg.zero_as_missing,
                        categorical_features=self._categorical_indices(names),
                        max_bin_by_feature=cfg.max_bin_by_feature,
                        seed=cfg.data_random_seed, forced_bins=_forced_bins(cfg))
            loaded = load_data_file_two_round(
                path, factory, sample_cnt=cfg.bin_construct_sample_cnt,
                seed=cfg.data_random_seed, sample_needed=ref is None, **cols)
            binner, bins = loaded["binner"], loaded["bins"]
        else:
            loaded = load_data_file(path, **cols)
            self.data = loaded["data"]
        for name, dtype in (("label", np.float64), ("weight", np.float64),
                            ("group", np.int64), ("position", np.int64)):
            if getattr(self, name) is None and loaded.get(name) is not None:
                setattr(self, name, np.asarray(loaded[name], dtype).ravel())
        if self.init_score is None and loaded.get("init_score") is not None:
            self.init_score = np.asarray(loaded["init_score"], np.float64)
        if self.feature_name == "auto":
            self.feature_name = list(loaded["feature_names"])
        return binner, bins

    def _set_bins(self, bins: Optional[np.ndarray], device) -> None:
        """The host bins and their device copies (the matrix and the
        per-feature bin tables).  With an EFB plan the histogram width is
        its widest bundle where that is wider (the gather tables' stride);
        the bundled matrix goes to the device when a grower asks.  Out of
        core the matrix is assembled on the device from the streamed
        chunks (resident), or stays off it (spill)."""
        self.bins = bins
        if self.ooc_spill:
            self.bins_device = None
        elif self._ooc_stream is not None:
            n, f = self._ooc_stream.shape
            self.bins_device = torch.empty((n, f), dtype=torch.int16, device=device)
            for lo, m, chunk in prefetch_device(self._ooc_stream.chunks(
                    self.ooc_chunk_rows), device, staging=self.staging()):
                self.bins_device[lo:lo + m].copy_(chunk)
        else:
            self.bins_device = torch.as_tensor(bins.astype(np.int16), device=device)
        self.num_bins_pf_device = torch.as_tensor(
            self.binner.num_bins_per_feature, dtype=torch.int32, device=device)
        self.missing_bin_pf_device = torch.as_tensor(
            self.binner.missing_bin_per_feature, dtype=torch.int32, device=device)
        self.max_num_bins = int(self.binner.max_num_bins)
        self._efb_device = None
        self._pre_filter_masks: Dict[int, np.ndarray] = {}
        if self.efb is not None:
            self.max_num_bins = max(self.max_num_bins,
                                    int(self.efb.gather_idx.shape[1]))

    def pre_filter_mask(self, min_data_in_leaf: int) -> np.ndarray:
        """feature_pre_filter's allowed features on these bins
        (models/gbdt.py::_pre_filter), computed once for each
        min_data_in_leaf: a column pass over the host bins that every
        training on this set would otherwise repeat."""
        if min_data_in_leaf not in self._pre_filter_masks:
            counts = None
            if self.bins is None:  # streamed: each feature's bin counts
                nbpf = np.asarray(self.binner.num_bins_per_feature)
                counts = [np.zeros(max(int(b), 1), np.int64) for b in nbpf]
                for _lo, view in self.ooc_chunk_iter():
                    for j, c in enumerate(counts):
                        c += np.bincount(view[:, j].astype(np.int64),
                                         minlength=len(c))[:len(c)]
            self._pre_filter_masks[min_data_in_leaf] = _pre_filter(
                self.bins, self.binner, min_data_in_leaf, counts=counts,
                n_rows=self.num_data())
        return self._pre_filter_masks[min_data_in_leaf]

    # -- out of core --------------------------------------------------------
    def _host_bins(self, what: str) -> np.ndarray:
        """The host bin matrix for a whole-matrix operation: the matrix, or
        one copy from the device matrix a cache streamed into (resident
        regime); a spill dataset has no whole matrix anywhere."""
        if self.bins is not None:
            return self.bins
        if self.bins_device is None:
            raise LightGBMError(f"{what} needs the whole bin matrix, which an "
                                "out_of_core dataset in the spill regime never holds")
        return self.bins_device.cpu().numpy()

    def staging(self):
        """The dataset's reused upload buffers (io/stream.py prefetch_device)."""
        if self._staging is None:
            from .io.stream import _Staging

            self._staging = _Staging()
        return self._staging

    def ooc_chunk_iter(self):
        """A fresh sweep of (row_lo, host chunk view) over the binned
        matrix: the cache's stream, or the host array's chunks."""
        if self._ooc_stream is not None:
            return self._ooc_stream.chunks(self.ooc_chunk_rows)
        return array_chunks(self.bins, self.ooc_chunk_rows or DEFAULT_CHUNK_ROWS)

    def device_chunks(self):
        """A sweep of (row_lo, rows, chunk on the device): the one-deep
        upload pipeline over ooc_chunk_iter."""
        return prefetch_device(self.ooc_chunk_iter(), self.num_bins_pf_device.device,
                               staging=self.staging())

    def over_rows(self, fn) -> torch.Tensor:
        """``fn(bins)`` of a row-wise function of the device bins: on the
        whole matrix, or, where it is not on the device (the spill
        regime), chunk by chunk, the results concatenated."""
        if self.bins_device is not None:
            return fn(self.bins_device)
        return torch.cat([fn(chunk) for _lo, _m, chunk in self.device_chunks()])

    def efb_device_tables(self) -> Optional[tuple]:
        """The EFB tables the growers' histogram passes take, on the bins'
        device, or None without a plan: (bundled (N, F_b) int16 matrix,
        gather (F * B,) int64, default (F, B) bool).  The bundled matrix is
        encoded here if the plan does not hold this dataset's (a reference=
        set, a subset)."""
        if self.efb is None:
            return None
        if self._efb_device is None:
            if self.efb.bundled_bins is None:
                self.efb = self.efb._replace(bundled_bins=apply_bundles(
                    self.efb, self.bins, self.binner.num_bins_per_feature))
            dev = self.bins_device.device
            self._efb_device = (
                torch.as_tensor(self.efb.bundled_bins.astype(np.int16), device=dev),
                torch.as_tensor(self.efb.gather_idx.reshape(-1), dtype=torch.int64,
                                device=dev),
                torch.as_tensor(self.efb.default_mask, device=dev))
        return self._efb_device

    def num_data(self) -> int:
        if self._constructed:
            return self._num_data
        return _to_2d_float(self.data).shape[0]

    def num_feature(self) -> int:
        if self._constructed:
            return self._num_feature
        return _to_2d_float(self.data).shape[1]

    @property
    def query_boundaries(self) -> Optional[np.ndarray]:
        """(Q + 1,) row offsets of the queries, or None without groups."""
        if self.group is None:
            return None
        return np.concatenate([[0], np.cumsum(self.group)]).astype(np.int64)

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, params=None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params)

    # -- fields (reference: Dataset.set_field / get_field) ---------------
    def set_field(self, field_name: str, data) -> "Dataset":
        if field_name in ("label", "weight"):
            v = None if data is None else np.asarray(data, np.float64).ravel()
            _check_finite(field_name, v)
            setattr(self, field_name, v)
        elif field_name in ("group", "query", "position"):
            v = None if data is None else np.asarray(data, np.int64).ravel()
            setattr(self, "group" if field_name == "query" else field_name, v)
        elif field_name == "init_score":
            self.init_score = None if data is None else np.asarray(data, np.float64)
            _check_finite("init_score", self.init_score)
        else:
            raise LightGBMError(f"Unknown field: {field_name}")
        return self

    def get_field(self, field_name: str):
        return {"label": self.label, "weight": self.weight, "group": self.group,
                "query": self.group, "init_score": self.init_score,
                "position": self.position}.get(field_name)

    def set_label(self, label) -> "Dataset":
        return self.set_field("label", label)

    def set_weight(self, weight) -> "Dataset":
        return self.set_field("weight", weight)

    def set_group(self, group) -> "Dataset":
        return self.set_field("group", group)

    def set_init_score(self, init_score) -> "Dataset":
        return self.set_field("init_score", init_score)

    def set_position(self, position) -> "Dataset":
        return self.set_field("position", position)

    def get_label(self):
        return self.label

    def get_weight(self):
        return self.weight

    def get_group(self):
        return self.group

    def get_init_score(self):
        return self.init_score

    def get_position(self):
        return self.position

    def get_data(self):
        """The raw data (None once freed)."""
        return self.data

    def get_feature_name(self) -> List[str]:
        self.construct()
        return list(self.feature_names)

    def set_feature_name(self, feature_name) -> "Dataset":
        if feature_name is not None and feature_name != "auto":
            names = list(feature_name)
            if self._constructed and len(names) != self.num_feature():
                raise LightGBMError(
                    f"Length of feature names {len(names)} does not equal "
                    f"number of features {self.num_feature()}")
            self.feature_name = names
            if self._constructed:
                self.feature_names = names
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """reference: Dataset.set_categorical_feature; before construction
        only (the bin mappers depend on it)."""
        if self.categorical_feature == categorical_feature:
            return self
        if self._constructed:
            raise LightGBMError(
                "Cannot set categorical feature after freed raw data, "
                "set free_raw_data=False when construct Dataset to avoid this.")
        self.categorical_feature = categorical_feature
        return self

    def set_reference(self, reference: "Dataset") -> "Dataset":
        """Align this dataset's bins to ``reference``'s (before construction)."""
        if self._constructed:
            if self.reference is reference:
                return self
            raise LightGBMError("Cannot set reference after Dataset was constructed.")
        self.reference = reference
        return self

    def get_ref_chain(self, ref_limit: int = 100) -> set:
        """The datasets along the reference= chain, this one first."""
        head, chain = self, set()
        while len(chain) < ref_limit and isinstance(head, Dataset):
            chain.add(head)
            if head.reference is None or head.reference in chain:
                break
            head = head.reference
        return chain

    def feature_num_bin(self, feature: Union[int, str]) -> int:
        self.construct()
        if isinstance(feature, str):
            feature = self.feature_names.index(feature)
        return int(self.binner.mappers[feature].num_bins)

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Column-concatenate another dataset of the same rows (reference:
        Dataset::AddFeaturesFrom)."""
        self.construct()
        other.construct(device=self.num_bins_pf_device.device)
        if self.num_data() != other.num_data():
            raise LightGBMError("Cannot add features from Dataset with a "
                                "different number of rows")
        host = self._host_bins("add_features_from")
        self.binner = DatasetBinner(mappers=list(self.binner.mappers)
                                    + list(other.binner.mappers))
        self.efb = None  # the bundle plan is stale once columns are added
        bins = np.concatenate([host, other.bins], axis=1)
        self._ooc_stream, self.ooc_spill = None, False
        self._set_bins(bins, self.num_bins_pf_device.device)
        self.feature_names = list(self.feature_names) + list(other.feature_names)
        self._num_feature = len(self.feature_names)
        if self.data is not None and other.data is not None:
            self.data = np.column_stack([_to_2d_float(self.data),
                                         _to_2d_float(other.data)])
        return self

    def subset(self, used_indices, params=None) -> "Dataset":
        """The rows ``used_indices``, sharing this dataset's bin mappers
        (reference: Dataset.subset / CopySubrow)."""
        self.construct()
        idx = np.asarray(used_indices, dtype=np.int64)
        sub = Dataset.__new__(Dataset)
        sub.__dict__.update(self.__dict__)
        if self.efb is not None:  # the plan, its bundled matrix encoded anew
            sub.efb = self.efb._replace(bundled_bins=None)
        sub._ooc_stream, sub.ooc_spill = None, False
        sub._set_bins(self._host_bins("subset")[idx], self.num_bins_pf_device.device)
        if self.raw_device is not None:
            sub.raw_device = self.raw_device[torch.as_tensor(
                idx, device=self.raw_device.device)]
        for name in ("label", "weight", "init_score", "position"):
            v = getattr(self, name)
            setattr(sub, name, None if v is None else v[idx])
        if self.group is not None:
            # group sizes from the selected rows' query ids
            qid = np.repeat(np.arange(len(self.group)), self.group)[idx]
            change = np.nonzero(np.diff(qid) != 0)[0] + 1
            sub.group = np.diff(np.concatenate([[0], change, [len(qid)]])).astype(np.int64)
        if _is_scipy_sparse(self.data):  # the rows, still sparse
            sub.data = self.data.tocsr()[idx]
        elif self.data is not None and not isinstance(self.data, (str, os.PathLike)):
            sub.data = _to_2d_float(self.data)[idx]
        if params is not None:
            sub.params = dict(params)
        sub._num_data = len(idx)
        sub._used_indices = idx
        return sub

    def save_binary(self, filename: str) -> "Dataset":
        """Write the binned dataset to ``filename`` (reference:
        Dataset::SaveBinaryFile), atomically, in the JAX package's npz
        cache format (io/stream.py); Dataset(filename) loads it back
        without parsing or binning."""
        self.construct()
        create_bin_cache(os.fspath(filename), self._host_bins("save_binary"),
                         self.binner.mappers,
                         label=self.label, weight=self.weight, group=self.group,
                         init_score=self.init_score, position=self.position,
                         feature_names=self.feature_names)
        return self

    # -- a host tree on the device bins -----------------------------------
    def predict_leaf_binned_tree(self, tree: Tree) -> torch.Tensor:
        """(N,) i32 leaf id of each row for one host tree, on the device
        bins (the JAX package's Dataset.predict_leaf_binned_tree): torch
        ops, no host read."""
        dev = self.num_bins_pf_device.device
        if tree.num_internal == 0:
            return torch.zeros(self.num_data(), dtype=torch.int32, device=dev)
        self._tree_threshold_bin(tree)

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        cat = None
        if tree.num_cat > 0:  # bin-space masks of the categorical nodes
            cat = (t(tree.is_categorical_node(), torch.bool),
                   t(tree._bin_masks(self.binner), torch.bool))
        nodes = (t(tree.split_feature, torch.int64), t(tree.threshold_bin, torch.int32),
                 t(tree.default_left(), torch.bool), t(tree.left_child, torch.int64),
                 t(tree.right_child, torch.int64), tree_depth(tree), cat)
        return self.over_rows(lambda bins: predict_ops.predict_leaf_binned(
            bins, self.missing_bin_pf_device, *nodes))

    def _tree_threshold_bin(self, tree: Tree) -> None:
        """Bin-space thresholds of a tree read from model text (exact: the
        text stores this binner's bin uppers)."""
        if tree.threshold_bin is not None:
            return
        tree.threshold_bin = np.asarray(
            [int(self.binner.mappers[int(f)].transform(np.asarray([thr]))[0])
             for f, thr in zip(tree.split_feature, tree.threshold)], np.int32)


class Booster:
    """reference: class Booster in python-package/lightgbm/basic.py."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params or {})
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_set = train_set
        if model_file is not None:
            model_str = _read_model_file(model_file)
        if model_str is not None:
            cfg = Config.from_dict(self.params)
            self._gbdt = GBDT.load_model_from_string(model_str, cfg.device_type)
            self.cfg = self._gbdt.cfg
            if cfg.is_set("trace_file"):  # a loaded model's predicts trace too
                self.cfg.update({"trace_file": cfg.trace_file})
        elif train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance")
            merged = dict(train_set.params or {})
            merged.update(self.params)
            train_set.params = merged
            self.cfg = Config.from_dict(self.params)
            self._gbdt = create_boosting(self.cfg, train_set)
        else:
            raise LightGBMError("need either params+train_set or a model")

    # -- training -------------------------------------------------------
    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting iteration; True if training should stop.  ``fobj``
        (score, train Dataset) -> (grad, hess) gives the gradients."""
        if train_set is not None and train_set is not self._train_set:
            self._train_set = train_set
            self._gbdt.reset_training_data(train_set)
        if fobj is not None:
            score = self._gbdt._score.cpu().numpy()
            grad, hess = fobj(score, self._gbdt.train_set)
            return self._gbdt.train_one_iter(np.asarray(grad), np.asarray(hess))
        return self._gbdt.train_one_iter()

    def rollback_one_iter(self) -> "Booster":
        self._gbdt.rollback_one_iter()
        return self

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        self._gbdt.add_valid(data, name)
        return self

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Runtime-resettable params (learning_rate etc.; reference:
        Booster.reset_parameter)."""
        self.params.update(params)
        self._gbdt.cfg.update(params)
        self._gbdt.reset_split_params()
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        """The name the training set's evaluations carry."""
        self._gbdt.train_name = name
        return self

    def shuffle_models(self, start_iteration: int = 0,
                       end_iteration: int = -1) -> "Booster":
        """Shuffle the trees in [start, end) (reference: GBDT ShuffleModels),
        with numpy's global generator, as the JAX package does."""
        models = self._gbdt.models
        end = len(models) if end_iteration < 0 else min(end_iteration, len(models))
        seg = models[start_iteration:end]
        np.random.shuffle(seg)
        models[start_iteration:end] = seg
        self._gbdt._invalidate_pred_cache("shuffle_models")
        return self

    def _init_score_offset(self) -> float:
        scores = self._gbdt.init_scores or [0.0]
        return float(scores[0]) if len(scores) == 1 else 0.0

    def lower_bound(self) -> float:
        """Smallest possible raw output: the trees' smallest leaves summed
        (reference: GBDT::GetLowerBoundValue)."""
        return float(sum(float(np.min(t.leaf_value[: t.num_leaves]))
                         for t in self._gbdt.models) + self._init_score_offset())

    def upper_bound(self) -> float:
        return float(sum(float(np.max(t.leaf_value[: t.num_leaves]))
                         for t in self._gbdt.models) + self._init_score_offset())

    def trees_to_dataframe(self):
        """One pandas row per node and leaf (reference:
        Booster.trees_to_dataframe)."""
        import pandas as pd  # local: pandas is optional

        def node_rows(tree_idx, struct, parent, depth, rows):
            internal = "split_index" in struct
            idx = (f"{tree_idx}-S{struct['split_index']}" if internal
                   else f"{tree_idx}-L{struct['leaf_index']}")
            rows.append({
                "tree_index": tree_idx, "node_depth": depth, "node_index": idx,
                "left_child": None, "right_child": None, "parent_index": parent,
                "split_feature": struct["split_feature"] if internal else None,
                "split_gain": struct["split_gain"] if internal else None,
                "threshold": struct["threshold"] if internal else None,
                "decision_type": struct["decision_type"] if internal else None,
                "missing_direction": (("left" if struct["default_left"] else "right")
                                      if internal else None),
                "missing_type": struct["missing_type"] if internal else None,
                "value": struct["internal_value"] if internal else struct["leaf_value"],
                "weight": (struct["internal_weight"] if internal
                           else struct.get("leaf_weight")),
                "count": (struct["internal_count"] if internal
                          else struct.get("leaf_count")),
            })
            if internal:
                me = len(rows) - 1
                rows[me]["left_child"] = node_rows(
                    tree_idx, struct["left_child"], idx, depth + 1, rows)
                rows[me]["right_child"] = node_rows(
                    tree_idx, struct["right_child"], idx, depth + 1, rows)
            return idx

        model = self.dump_model()
        names = model["feature_names"]
        rows: List[Dict[str, Any]] = []
        for t in model["tree_info"]:
            node_rows(t["tree_index"], t["tree_structure"], None, 1, rows)
        df = pd.DataFrame(rows)
        df["split_feature"] = df["split_feature"].map(
            lambda v: names[int(v)] if v is not None and not pd.isna(v) else None)
        return df

    def current_iteration(self) -> int:
        return self._gbdt.iter_

    def num_trees(self) -> int:
        return self._gbdt._num_trees()

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_tree_per_iteration

    def num_feature(self) -> int:
        return len(self._gbdt.feature_names)

    def feature_name(self) -> List[str]:
        return list(self._gbdt.feature_names)

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        return self._gbdt.feature_importance(importance_type, iteration)

    def get_split_value_histogram(self, feature, bins=None, xgboost_style: bool = False):
        """Histogram of a feature's split thresholds across the model
        (reference: Booster.get_split_value_histogram)."""
        if isinstance(feature, str):
            if feature not in self.feature_name():
                raise ValueError(f"Unknown feature name {feature!r}")
            feature = self.feature_name().index(feature)
        values = np.array([float(t.threshold[i]) for t in self._gbdt.models
                           for i in range(t.num_internal)
                           if int(t.split_feature[i]) == feature
                           and not t.is_categorical_node()[i]], dtype=np.float64)
        if bins is None or (isinstance(bins, int) and bins > len(values)):
            bins = max(len(values), 1)
        hist, bin_edges = np.histogram(values, bins=bins)
        if xgboost_style:
            ret = np.column_stack((bin_edges[1:], hist))
            ret = ret[ret[:, 1] > 0]
            try:
                import pandas as pd
            except ImportError:
                return ret
            return pd.DataFrame(ret, columns=["SplitValue", "Count"])
        return hist, bin_edges

    def set_network(self, machines, local_listen_port: int = 12400,
                    listen_time_out: int = 120, num_machines: int = 1) -> "Booster":
        """Bring up this process's rank of a distributed training
        (reference: LGBM_NetworkInit; parallel/distributed.py)."""
        from .parallel.distributed import init_distributed

        if isinstance(machines, (list, tuple, set)):
            machines = ",".join(machines)
        net = dict(machines=machines, local_listen_port=local_listen_port,
                   time_out=listen_time_out, num_machines=num_machines)
        self.params.update(net)
        init_distributed(Config.from_dict(dict(self.params, **net)))
        return self

    def free_network(self) -> "Booster":
        """Tear the process group down (reference: LGBM_NetworkFree)."""
        from .parallel.distributed import free_network

        free_network()
        return self

    def free_dataset(self) -> "Booster":
        self._train_set = None
        return self

    def set_leaf_output(self, tree_id: int, leaf_id: int, value: float) -> "Booster":
        self._gbdt.models[tree_id].leaf_value[leaf_id] = value
        self._gbdt._invalidate_pred_cache("set_leaf_output")
        return self

    def get_leaf_output(self, tree_id: int, leaf_id: int) -> float:
        return float(self._gbdt.models[tree_id].leaf_value[leaf_id])

    # -- eval -------------------------------------------------------------
    def eval_train(self, feval=None):
        return self._eval(0, self._gbdt.train_name, feval)

    def eval_valid(self, feval=None):
        out = []
        for i, name in enumerate(self._gbdt.valid_names):
            out.extend(self._eval(i + 1, name, feval))
        return out

    def eval(self, data: Dataset, name: str, feval=None):
        """Evaluate ``data`` (added as a validation set when it is not one)."""
        for i, vs in enumerate(self._gbdt.valid_sets):
            if vs is data:
                return self._eval(i + 1, name, feval)
        self.add_valid(data, name)
        return self._eval(len(self._gbdt.valid_sets), name, feval)

    def _eval(self, data_idx: int, name: str, feval=None):
        g = self._gbdt
        res = [(name, mname, val, hib) for (_n, mname, val, hib) in g.eval_at(data_idx)]
        if feval is not None:
            ds = g.train_set if data_idx == 0 else g.valid_sets[data_idx - 1]
            score = g._score if data_idx == 0 else g._valid_scores[data_idx - 1]
            for r in _call_feval(feval, score.cpu().numpy(), ds):
                res.append((name, r[0], r[1], r[2]))
        return res

    # -- prediction -------------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                **kwargs) -> np.ndarray:
        """Margins or probabilities; ``pred_leaf`` (N, T) leaf ids;
        ``pred_contrib`` (N, (F + 1) * K) SHAP values; pred_early_stop,
        pred_early_stop_freq and pred_early_stop_margin in ``kwargs`` set
        prediction early stopping for this call.  ``mesh`` in ``kwargs``
        (a device mesh, or a process group's mesh) splits the rows over its
        devices or ranks (models/gbdt.py::GBDT.predict_raw_sharded), bitwise
        the single-device result; early stopping, pred_leaf and
        pred_contrib keep the single-device path."""
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 else -1
        if _is_scipy_sparse(data):
            # sparse rows are densified a chunk at a time (about 512 MB of
            # float64 each), never all at once
            chunk = max(1, int(512e6 // (max(data.shape[1], 1) * 8)))
            if data.shape[0] > chunk:
                csr = data.tocsr()
                return np.concatenate([
                    self.predict(csr[lo:lo + chunk], start_iteration, num_iteration,
                                 raw_score, pred_leaf, pred_contrib, **kwargs)
                    for lo in range(0, csr.shape[0], chunk)], axis=0)
        mesh = kwargs.get("mesh")
        # the call's span opens before the rows are read: their conversion
        # to float64 is host work the card waits on
        with self._gbdt.predict_span(raw_score, mesh, pred_leaf, pred_contrib) as call:
            with _trace.span("predict.rows"):
                X = _to_2d_float(data)
            n_feat = self.num_feature()
            if (n_feat and X.shape[1] != n_feat
                    and not kwargs.get("predict_disable_shape_check", False)):
                raise LightGBMError(
                    f"The number of features in data ({X.shape[1]}) is not the same "
                    f"as it was in training data ({n_feat}). You can set "
                    f"predict_disable_shape_check=true to discard this error.")
            early_stop = {k: kwargs[k] for k in ("pred_early_stop", "pred_early_stop_freq",
                                                 "pred_early_stop_margin") if k in kwargs}
            return self._gbdt.predict(X, raw_score=raw_score,
                                      start_iteration=start_iteration,
                                      num_iteration=num_iteration, pred_leaf=pred_leaf,
                                      pred_contrib=pred_contrib, early_stop=early_stop,
                                      mesh=mesh, call=call)

    def predict_sharded(self, data, mesh, **kwargs) -> np.ndarray:
        """``predict`` with its rows split over ``mesh`` (the JAX package's
        giant-batch entry): bitwise ``predict``."""
        return self.predict(data, mesh=mesh, **kwargs)

    def refit(self, data, label, decay_rate: float = 0.9, weight=None,
              **kwargs) -> "Booster":
        """A new booster whose leaf values are refitted on ``data``
        (reference: GBDT::RefitTree): new = decay * old + (1 - decay) *
        the leaf's Newton value from the port's objective, with the trees
        walked in training order and tree t of a multiclass model renewed
        against class t % K.  The gradients run on this booster's device;
        leaf ids, sums and scores on the host in f64, as in the JAX
        package."""
        X = _to_2d_float(data)
        label = np.asarray(label, dtype=np.float64).ravel()
        new_booster = Booster(params={"device_type": self.cfg.device_type},
                              model_str=self.model_to_string())
        new_booster._gbdt.cfg = self.cfg
        gbdt = new_booster._gbdt
        dev = gbdt.device
        k = gbdt.num_tree_per_iteration
        score = np.zeros((len(label), k) if k > 1 else len(label), dtype=np.float64)
        w_dev = None
        if weight is not None:
            weight = np.asarray(weight, dtype=np.float64).ravel()
            if len(weight) != len(label):
                raise LightGBMError(f"refit: {len(label)} labels but {len(weight)} weights")
            w_dev = torch.as_tensor(weight, dtype=torch.float32, device=dev)
        from .objectives import create_objective

        obj = create_objective(self.cfg)
        label_dev = torch.as_tensor(label, dtype=torch.float32, device=dev)
        for t_i, tree in enumerate(gbdt.models):
            leaf = tree.predict_leaf_batch(X)
            g, h = obj.get_gradients(torch.as_tensor(score, dtype=torch.float32,
                                                     device=dev), label_dev, w_dev)
            g, h = g.cpu().numpy().astype(np.float64), h.cpu().numpy().astype(np.float64)
            if k > 1:
                g, h = g[:, t_i % k], h[:, t_i % k]
            sum_g = np.bincount(leaf, weights=g, minlength=tree.num_leaves)
            sum_h = np.bincount(leaf, weights=h, minlength=tree.num_leaves)
            new_vals = -sum_g / (sum_h + self.cfg.lambda_l2 + 1e-15) * tree.shrinkage
            tree.leaf_value = (decay_rate * tree.leaf_value + (1.0 - decay_rate)
                               * np.where(sum_h > 0, new_vals, tree.leaf_value))
            if k > 1:
                score[:, t_i % k] += tree.leaf_value[leaf]
            else:
                score += tree.leaf_value[leaf]
        gbdt._invalidate_pred_cache("refit")  # leaf values renewed in place
        return new_booster

    # -- serialization ----------------------------------------------------
    def model_to_string(self, num_iteration: int = -1, start_iteration: int = 0,
                        importance_type: Optional[str] = None,
                        raw_deltas: bool = False) -> str:
        """The model text; ``raw_deltas`` gives the snapshot form (pure-delta
        trees and an init_scores header line: GBDT.save_model_to_string)."""
        return self._gbdt.save_model_to_string(num_iteration, start_iteration,
                                               importance_type, raw_deltas=raw_deltas)

    def save_model(self, filename, num_iteration: int = -1,
                   start_iteration: int = 0,
                   importance_type: Optional[str] = None) -> "Booster":
        # atomic (a same-directory temp file, fsync, os.replace): a crash
        # mid-write leaves the previous file, never a torn one
        _checkpoint.atomic_write_text(os.fspath(filename), self.model_to_string(
            num_iteration, start_iteration, importance_type))
        return self

    @classmethod
    def model_from_string(cls, model_str: str,
                          params: Optional[Dict[str, Any]] = None) -> "Booster":
        return cls(params=params, model_str=model_str)

    def dump_model(self, num_iteration: int = -1, start_iteration: int = 0) -> Dict[str, Any]:
        """JSON model dump (reference: GBDT::DumpModel)."""
        g = self._gbdt
        k = g.num_tree_per_iteration
        models = g.models
        lo = start_iteration * k
        hi = len(models) if num_iteration < 0 else min((start_iteration + num_iteration) * k,
                                                        len(models))
        trees = [{"tree_index": i, "num_leaves": t.num_leaves, "num_cat": t.num_cat,
                  "shrinkage": t.shrinkage,
                  "tree_structure": _dump_node(t, 0 if t.num_internal else -1)}
                 for i, t in enumerate(models[lo:hi])]
        return {"name": "tree", "version": "v4", "num_class": self.cfg.num_class,
                "num_tree_per_iteration": k, "label_index": 0,
                "max_feature_idx": len(g.feature_names) - 1,
                "objective": g._objective_string(), "average_output": g.average_output,
                "feature_names": list(g.feature_names), "monotone_constraints": [],
                "feature_infos": {}, "tree_info": trees}

    def to_if_else(self) -> str:
        """The model as standalone C++ (task=convert_model)."""
        return self._gbdt.to_if_else()


def _read_model_file(model_file) -> str:
    """A model file's text, its integrity trailer (utils/checkpoint.py)
    verified and stripped.  A trailer that does not verify, a snapshot
    without one (it was cut before its last line) or bytes that are not
    UTF-8 raise CorruptModelError; a plain model file without a trailer
    loads as it is."""
    try:
        text = Path(model_file).read_text(encoding="utf-8")
    except UnicodeDecodeError as e:
        raise CorruptModelError(f"{model_file} is not valid UTF-8 ({e}); the file "
                                "is corrupted") from None
    model_str, ok = _checkpoint.verify_text(text)
    if ok is False or (ok is None and _checkpoint.is_snapshot_path(os.fspath(model_file))):
        raise CorruptModelError(
            f"{model_file} failed integrity verification (torn or truncated "
            "checkpoint); resume from an older snapshot: "
            "utils/checkpoint.py latest_valid_snapshot scans the family, and "
            "engine.train falls back to it")
    return model_str


def _dump_node(tree: Tree, node: int) -> Dict[str, Any]:
    if node < 0 or tree.num_internal == 0:
        leaf = -node - 1 if node < 0 else 0
        return {
            "leaf_index": leaf,
            "leaf_value": float(tree.leaf_value[leaf]),
            "leaf_weight": (float(tree.leaf_weight[leaf])
                            if len(tree.leaf_weight) > leaf else 0.0),
            "leaf_count": (int(tree.leaf_count[leaf])
                           if len(tree.leaf_count) > leaf else 0),
        }
    return {
        "split_index": node,
        "split_feature": int(tree.split_feature[node]),
        "split_gain": float(tree.split_gain[node]),
        "threshold": float(tree.threshold[node]),
        "decision_type": "<=",
        "default_left": bool(tree.default_left()[node]),
        "missing_type": ["None", "Zero", "NaN"][(int(tree.decision_type[node]) >> 2) & 3],
        "internal_value": float(tree.internal_value[node]),
        "internal_weight": float(tree.internal_weight[node]),
        "internal_count": int(tree.internal_count[node]),
        "left_child": _dump_node(tree, tree.left_child[node]),
        "right_child": _dump_node(tree, tree.right_child[node]),
    }


def _call_feval(feval, score: np.ndarray, ds: Dataset) -> list:
    """feval(score, dataset) -> one (name, value, higher_better) or a list."""
    ret = feval(score, ds)
    if ret is None:
        return []
    return ret if isinstance(ret, list) else [ret]
